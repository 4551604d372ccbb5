"""The port's npz checkpoints against the JAX package's.

Across the two packages, for all five families: the reference trains 3
epochs and saves, the port restores; the port trains 3 epochs and saves,
the reference restores through its own ``restore_checkpoint`` (its
trainer's ``restore``). Every named leaf (``jax.tree_util.keystr``
names), Adam's ``m``, ``v`` and ``step`` included, must be bitwise equal,
and each side's eval logits at those parameters within 1e-3 of the
other's. A port re-save of the reference's state writes the reference's
manifest (structure strings, digests, shapes, dtypes).

Then the port alone: 6 straight epochs equal 3 + restore + 3 bitwise with
dropout on, and the storage rules of ``utils/checkpoint.py`` (retention,
quarantine, fallback, interrupted saves, the legacy layout, shape checks)
with the verdicts of the port's ``verify_checkpoint`` against the
reference tool's. The JAX runs are cached at module scope.
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.graph.storage import load_edges as j_load_edges
from neutronstarlite_tpu.models.commnet import CommNetTrainer as JCommNet
from neutronstarlite_tpu.models.gat import GATTrainer as JGAT
from neutronstarlite_tpu.models.gcn import GCNTrainer as JGCN
from neutronstarlite_tpu.models.ggcn import GGCNTrainer as JGGCN
from neutronstarlite_tpu.models.gin import GINTrainer as JGIN
from neutronstarlite_tpu.tools.verify_checkpoint import main as j_verify_main
from neutronstarlite_tpu.utils import checkpoint as j_ckpt
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.models.commnet import CommNetTrainer
from neutronstarlite_torch.models.gat import GATTrainer
from neutronstarlite_torch.models.gcn import GCNTrainer
from neutronstarlite_torch.models.ggcn import GGCNTrainer
from neutronstarlite_torch.models.gin import GINTrainer
from neutronstarlite_torch.tools.verify_checkpoint import main as t_verify_main
from neutronstarlite_torch.utils import checkpoint as t_ckpt
from neutronstarlite_torch.utils import tree as t_tree
from neutronstarlite_torch.utils.config import InputInfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "cora")
EDGES = os.path.join(FIX, "cora.2708.edge.self")
V, F, H, C = 2708, 32, 16, 7

FAMILIES = {
    "GCNCPU": (JGCN, GCNTrainer),
    "GATCPU": (JGAT, GATTrainer),
    "GINCPU": (JGIN, GINTrainer),
    "COMMNETCPU": (JCommNet, CommNetTrainer),
    "GGCNCPU": (JGGCN, GGCNTrainer),
}


def _cfg(cls, algorithm, epochs=3, **kw):
    cfg = cls()
    cfg.algorithm = algorithm
    cfg.vertices = V
    cfg.layer_string = f"{F}-{H}-{C}"
    cfg.epochs = epochs
    cfg.decay_epoch = 2  # the stepped decay fires before the save
    cfg.drop_rate = 0.5
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _data(cls):
    return cls.read_feature_label_mask(
        "", os.path.join(FIX, "cora.labeltable"), os.path.join(FIX, "cora.mask"),
        V, F, seed=0,
    )


def _np(leaf):
    return leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)


def _port_named(tr):
    """The port's checkpoint leaves by name: ``params[0]['W']``, ``opt.m[..]``."""
    return {name + path: _np(leaf) for name, tree in tr.checkpoint_state().items()
            for path, leaf in t_tree.flatten_with_path(tree)}


def _jax_named(state):
    return {name + jax.tree_util.keystr(path): np.asarray(leaf)
            for name, tree in state.items()
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_leaves(got, want):
    assert list(got) == list(want)  # names, in the reference's leaf order
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        assert np.array_equal(got[name], want[name]), name


@pytest.fixture(scope="module")
def edges():
    return j_load_edges(EDGES)


@pytest.fixture(scope="module")
def host_graphs(edges):
    src, dst = edges
    return {
        w: (j_build_graph(src, dst, V, weight=w, use_native=False), build_graph(src, dst, V, w))
        for w in ("gcn_norm", "ones")
    }


def _port(algorithm, host_graphs, edges, **kw):
    cls = FAMILIES[algorithm][1]
    src, dst = edges
    return cls.from_arrays(_cfg(InputInfo, algorithm, **kw), src, dst, _data(GNNDatum),
                           device="cpu", host_graph=host_graphs[cls.weight_mode][1])


def _jax_logits(tr):
    return np.asarray(tr._eval_logits(tr.params, tr.compute_graph, tr.feature,
                                      jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_trained(edges, host_graphs, tmp_path_factory):
    """Per family, a JAX trainer after 3 epochs with CHECKPOINT_DIR: the
    trainer, its checkpoint directory, its named leaves and eval logits."""
    cache = {}

    def get(algorithm):
        if algorithm not in cache:
            jcls = FAMILIES[algorithm][0]
            ck = str(tmp_path_factory.mktemp(f"jax-{algorithm}"))
            src, dst = edges
            tr = jcls.from_arrays(_cfg(JInfo, algorithm, checkpoint_dir=ck), src, dst,
                                  _data(JDatum), host_graph=host_graphs[jcls.weight_mode][0])
            tr.run()
            cache[algorithm] = (tr, ck, _jax_named(tr.checkpoint_state()), _jax_logits(tr))
        return cache[algorithm]

    return get


@pytest.mark.parametrize("algorithm", list(FAMILIES))
def test_reference_checkpoint_restores_in_port(jax_trained, host_graphs, edges, tmp_path,
                                               algorithm):
    jtr, ck, j_named, j_logits = jax_trained(algorithm)
    tr = _port(algorithm, host_graphs, edges)
    assert tr.restore(ck) == 3
    _assert_same_leaves(_port_named(tr), j_named)
    assert tr.opt_state.step == 3
    np.testing.assert_allclose(tr.eval_logits().numpy(), j_logits, rtol=0, atol=1e-3)
    # a port save of the same state writes the reference's manifest
    tr.save(str(tmp_path), 3)
    (_, j_dir), = j_ckpt.list_steps(ck)
    (_, t_dir), = t_ckpt.list_steps(str(tmp_path))
    assert os.path.basename(t_dir) == os.path.basename(j_dir)
    with open(os.path.join(j_dir, "manifest.json")) as a, \
            open(os.path.join(t_dir, "manifest.json")) as b:
        assert json.load(b) == json.load(a)


@pytest.mark.parametrize("algorithm", list(FAMILIES))
def test_port_checkpoint_restores_in_reference(jax_trained, host_graphs, edges, tmp_path,
                                               algorithm):
    jtr = jax_trained(algorithm)[0]
    ck = str(tmp_path / "ck")
    tr = _port(algorithm, host_graphs, edges, checkpoint_dir=ck)
    tr.run()
    assert jtr.restore(ck) == 3  # the reference's restore_checkpoint
    _assert_same_leaves(_jax_named(jtr.checkpoint_state()), _port_named(tr))
    np.testing.assert_allclose(_jax_logits(jtr), tr.eval_logits().numpy(), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("algorithm,route", [
    ("GCNCPU", "scatter"), ("GCNCPU", "ell"), ("GCNCPU", "bsp"), ("GATCPU", "scatter"),
    ("GINCPU", "scatter"), ("COMMNETCPU", "scatter"), ("GGCNCPU", "scatter"),
])
def test_port_resume_is_bitwise(host_graphs, edges, tmp_path, algorithm, route):
    """6 straight epochs against 3 + save + a new trainer restored + 3,
    dropout 0.5: each epoch's dropout generator is seeded from (seed,
    epoch), so the losses and every leaf (parameters, Adam m, v, step) are
    bitwise equal. One intra-op thread, as the reference's resume test
    pins XLA's CPU runtime to one: under several, GGCN's edge chain is not
    bitwise repeatable on the CPU (two straight runs differ by ~2e-7),
    because the backward of its [E, f'] row gathers ``hs[csc_src]`` and
    ``hd[csc_dst]`` (an accumulating index_put) adds in a varying order;
    the other families are repeatable."""
    kw = dict(optim_kernel=route != "scatter", pallas_kernel=route == "bsp")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        straight = _port(algorithm, host_graphs, edges, epochs=6, **kw)
        straight.run()
        ck = str(tmp_path / "ck")
        first = _port(algorithm, host_graphs, edges, checkpoint_dir=ck, **kw)
        first.run()
        second = _port(algorithm, host_graphs, edges, epochs=6, checkpoint_dir=ck, **kw)
        second.run()
    finally:
        torch.set_num_threads(threads)
    assert len(second.loss_history) == 3
    assert first.loss_history + second.loss_history == straight.loss_history
    _assert_same_leaves(_port_named(second), _port_named(straight))
    assert second.opt_state.step == 6


def test_resume_at_the_end_trains_nothing(host_graphs, edges, tmp_path):
    ck = str(tmp_path / "ck")
    _port("GCNCPU", host_graphs, edges, checkpoint_dir=ck).run()
    again = _port("GCNCPU", host_graphs, edges, checkpoint_dir=ck)
    result = again.run()
    assert again.epoch_times == [] and np.isnan(result["loss"])
    assert result["acc"]["train"] > 0


# ---- storage ------------------------------------------------------------------

def _state(scale=1.0):
    return {"params": [{"W": torch.arange(6.0).reshape(2, 3) * scale}],
            "opt": {"m": np.zeros((2, 3), np.float32), "step": np.int32(5)}}


def test_save_restore_roundtrip(tmp_path):
    t_ckpt.save_checkpoint(str(tmp_path), _state(), step=7)
    got, step = t_ckpt.restore_checkpoint(str(tmp_path), _state())
    assert step == 7
    np.testing.assert_array_equal(got["params"][0]["W"], np.arange(6.0).reshape(2, 3))
    assert got["params"][0]["W"].dtype == np.float32
    assert int(got["opt"]["step"]) == 5 and got["opt"]["step"].dtype == np.int32
    assert t_ckpt.restore_checkpoint(str(tmp_path / "none"), _state()) is None


def test_vertex_array_dump_restore(tmp_path):
    arr = np.random.default_rng(0).standard_normal((10, 3)).astype(np.float32)
    t_ckpt.dump_vertex_array(str(tmp_path), "emb", torch.from_numpy(arr))
    np.testing.assert_array_equal(t_ckpt.restore_vertex_array(str(tmp_path), "emb"), arr)
    assert t_ckpt.restore_vertex_array(str(tmp_path), "nope") is None


def test_keep_last_k_retention(tmp_path, monkeypatch):
    for step in range(1, 6):
        t_ckpt.save_checkpoint(str(tmp_path), _state(), step=step)
    assert [s for s, _ in t_ckpt.list_steps(str(tmp_path))] == [4, 5]
    monkeypatch.setenv("NTS_CKPT_KEEP", "3")
    for step in range(6, 9):
        t_ckpt.save_checkpoint(str(tmp_path), _state(), step=step)
    assert [s for s, _ in t_ckpt.list_steps(str(tmp_path))] == [6, 7, 8]


def _corrupt(path, how):
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        if how == "truncate":
            fh.truncate(size // 2)
        else:  # flip a window in the middle
            fh.seek(size // 2)
            window = fh.read(64)
            fh.seek(size // 2)
            fh.write(bytes(b ^ 0xFF for b in window))


@pytest.mark.parametrize("how", ["truncate", "bitflip"])
def test_corrupt_checkpoint_quarantined_and_fallback(tmp_path, how):
    from neutronstarlite_torch.resilience import events

    records = []

    class Sink:
        def event(self, event_kind, **fields):
            records.append((event_kind, fields.get("kind") or fields.get("action")))

    t_ckpt.save_checkpoint(str(tmp_path), _state(), step=1)
    t_ckpt.save_checkpoint(str(tmp_path), _state(10.0), step=2)
    steps = dict(t_ckpt.list_steps(str(tmp_path)))
    _corrupt(os.path.join(steps[2], t_ckpt.ARRAYS), how)
    events.set_sink(Sink())
    try:
        got, step = t_ckpt.restore_checkpoint(str(tmp_path), _state())
    finally:
        events.set_sink(None)
    assert step == 1
    np.testing.assert_array_equal(got["params"][0]["W"], np.arange(6.0).reshape(2, 3))
    assert any(n.endswith(".corrupt") for n in os.listdir(tmp_path))
    assert [s for s, _ in t_ckpt.list_steps(str(tmp_path))] == [1]
    assert records == [("fault", "ckpt_corrupt"), ("recovery", "ckpt_fallback")]


def test_all_checkpoints_corrupt_restores_none(tmp_path):
    t_ckpt.save_checkpoint(str(tmp_path), _state(), step=1)
    (_, d), = t_ckpt.list_steps(str(tmp_path))
    _corrupt(os.path.join(d, t_ckpt.ARRAYS), "truncate")
    assert t_ckpt.have_checkpoint(str(tmp_path))  # by its files
    assert t_ckpt.restore_checkpoint(str(tmp_path), _state()) is None
    assert not t_ckpt.have_checkpoint(str(tmp_path))


def test_interrupted_save_is_invisible(tmp_path):
    t_ckpt.save_checkpoint(str(tmp_path), _state(), step=1)
    torn = tmp_path / ".tmp-step-00000009-12345"
    torn.mkdir()
    (torn / t_ckpt.ARRAYS).write_bytes(b"partial")
    # a step directory without its manifest (the commit marker)
    (tmp_path / "step-00000010").mkdir()
    (tmp_path / "step-00000010" / t_ckpt.ARRAYS).write_bytes(b"partial")
    got, step = t_ckpt.restore_checkpoint(str(tmp_path), _state())
    assert step == 1
    t_ckpt.save_checkpoint(str(tmp_path), _state(), step=2)
    assert not any(n.startswith(".tmp-") for n in os.listdir(tmp_path))


def test_transient_read_error_is_retried(tmp_path, monkeypatch):
    t_ckpt.save_checkpoint(str(tmp_path), _state(), step=1)
    monkeypatch.setenv("NTS_CKPT_RETRY_BASE_S", "0")
    real, calls = t_ckpt._read_arrays, []

    def flaky(path):
        calls.append(path)
        if len(calls) == 1:
            raise OSError(5, "Input/output error")
        return real(path)

    monkeypatch.setattr(t_ckpt, "_read_arrays", flaky)
    got, step = t_ckpt.restore_checkpoint(str(tmp_path), _state())
    assert step == 1 and len(calls) == 2
    assert not any(n.endswith(".corrupt") for n in os.listdir(tmp_path))


def test_shape_mismatch_restore_names_keys(host_graphs, edges, tmp_path):
    ck = str(tmp_path / "ck")
    _port("GCNCPU", host_graphs, edges, epochs=1, checkpoint_dir=ck).run()
    wider = _port("GCNCPU", host_graphs, edges, checkpoint_dir=ck, layer_string=f"{F}-8-{C}")
    with pytest.raises(ValueError, match=r"HIDDEN.*params\[0\]\['W'\]: checkpoint "
                                         r"\(32, 16\) vs model \(32, 8\)"):
        wider.run()


def test_legacy_layout(tmp_path):
    """The pre-digest flat layout, as the reference wrote it: it restores;
    torn, it is quarantined and restores as None."""
    state = {"params": [{"W": np.arange(4.0, dtype=np.float32)}]}
    leaves, treedef = jax.tree.flatten(state["params"])
    np.savez(os.path.join(tmp_path, t_ckpt.ARRAYS), **{"params.0": leaves[0]})
    with open(os.path.join(tmp_path, t_ckpt.MANIFEST), "w") as fh:
        json.dump({"step": 3, "trees": {"params": {"treedef": str(treedef),
                                                    "n_leaves": 1}}}, fh)
    got, step = t_ckpt.restore_checkpoint(str(tmp_path), state)
    assert step == 3
    np.testing.assert_array_equal(got["params"][0]["W"], np.arange(4.0))
    assert t_verify_main([str(tmp_path)]) == j_verify_main([str(tmp_path)]) == 0
    _corrupt(os.path.join(tmp_path, t_ckpt.ARRAYS), "truncate")
    assert t_ckpt.restore_checkpoint(str(tmp_path), state) is None
    assert any(n.endswith(".corrupt") for n in os.listdir(tmp_path))


def _verdicts(main, path, capsys):
    rc = main([path, "--quiet"])
    out = capsys.readouterr().out
    return rc, sorted(line.split(":")[-1].split(" step=")[0].strip()
                      for line in out.splitlines() if "step-" in line and line[0] != " ")


def test_verify_checkpoint_matches_the_reference_tool(host_graphs, edges, jax_trained,
                                                       tmp_path, capsys):
    """Both tools on a port checkpoint and a JAX one: intact, a value
    tampered behind a valid zip (only the digest catches it), a torn file,
    a quarantined step, a missing directory and an empty one; the same
    exit codes and verdict lines."""
    port_ck = str(tmp_path / "port")
    _port("GCNCPU", host_graphs, edges, checkpoint_dir=port_ck, checkpoint_every=1).run()
    jax_ck = str(tmp_path / "jax")
    shutil.copytree(jax_trained("GCNCPU")[1], jax_ck)
    for ck in (port_ck, jax_ck):
        for main in (t_verify_main, j_verify_main):
            assert main([ck]) == 0
            out = capsys.readouterr().out
            assert "params.0" in out and "sha256=" in out and ": OK step=" in out
    assert _verdicts(t_verify_main, port_ck, capsys) == \
        _verdicts(j_verify_main, port_ck, capsys) == (0, ["OK", "OK"])

    steps = [d for _, d in t_ckpt.list_steps(port_ck)]
    with np.load(os.path.join(steps[-1], t_ckpt.ARRAYS)) as data:
        tampered = {k: data[k] for k in data.files}
    tampered["params.0"] = tampered["params.0"] + 1.0
    np.savez(os.path.join(steps[-1], t_ckpt.ARRAYS), **tampered)
    _corrupt(os.path.join(steps[0], t_ckpt.ARRAYS), "truncate")
    for ck in (port_ck, jax_ck):
        assert _verdicts(t_verify_main, ck, capsys) == _verdicts(j_verify_main, ck, capsys)
    assert _verdicts(t_verify_main, port_ck, capsys) == (1, ["CORRUPT", "CORRUPT"])
    t_verify_main([port_ck])
    out = capsys.readouterr().out
    assert "digest mismatch" in out and "unreadable" in out
    assert t_ckpt.restore_checkpoint(port_ck, {"params": [0]}) is None  # quarantines both
    assert t_verify_main([port_ck]) == j_verify_main([port_ck]) == 2
    assert "quarantined (skipped)" in capsys.readouterr().out
    missing = str(tmp_path / "nothing_here")
    assert t_verify_main([missing]) == j_verify_main([missing]) == 1
    empty = tmp_path / "empty"
    empty.mkdir()
    assert t_verify_main([str(empty)]) == j_verify_main([str(empty)]) == 2


# ---- cfg keys -------------------------------------------------------------------

def test_checkpoint_keys_parse(tmp_path, monkeypatch):
    p = tmp_path / "x.cfg"
    p.write_text("ALGORITHM:GCNCPU\nVERTICES:10\nLAYERS:4-2\nCHECKPOINT_DIR:/tmp/ck\n"
                 "CHECKPOINT_EVERY:2\nCKPT_BACKEND:npz\n")
    cfg = InputInfo.read_from_cfg_file(str(p))
    ref = JInfo.read_from_cfg_file(str(p))
    for field in ("checkpoint_dir", "checkpoint_every", "ckpt_backend"):
        assert getattr(cfg, field) == getattr(ref, field), field
    p.write_text("ALGORITHM:GCNCPU\nCKPT_BACKEND:zarr\n")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        InputInfo.read_from_cfg_file(str(p))


def test_orbax_from_the_environment_is_refused(host_graphs, edges, tmp_path, monkeypatch):
    """``NTS_CKPT_BACKEND=orbax`` (refused before the sharded backend came):
    now a round trip. 3 epochs write sharded steps under ``orbax/``, and a
    new trainer resumes to 6, bitwise the straight 6-epoch run (dropout
    0.5: the epoch's masks are a function of the seed and the epoch)."""
    monkeypatch.setenv("NTS_CKPT_BACKEND", "orbax")
    straight = _port("GCNCPU", host_graphs, edges, epochs=6)
    straight.run()
    ck = str(tmp_path / "ck")
    first = _port("GCNCPU", host_graphs, edges, epochs=3, checkpoint_dir=ck,
                  checkpoint_every=1)
    first.run()
    assert sorted(os.listdir(os.path.join(ck, t_ckpt.ORBAX_SUBDIR))) == ["2", "3"]
    assert t_ckpt.list_steps(ck) == []  # no npz step
    second = _port("GCNCPU", host_graphs, edges, epochs=6, checkpoint_dir=ck,
                   checkpoint_every=1)
    second.run()
    assert second._first_epoch_trained == 3
    assert first.loss_history + second.loss_history == straight.loss_history
    for a, b in zip(second.flat_params, straight.flat_params):
        assert torch.equal(a, b)


# ---- the sharded backend (JAX test_checkpoint.py:308, :343) --------------------------

def test_orbax_roundtrip_and_trainer_resume(host_graphs, edges, tmp_path):
    """``test_checkpoint.py:308``: the sharded backend's round trip keeps
    values and dtypes, and the trainer's resume keeps the npz path's epoch
    accounting."""
    t_ckpt.save_checkpoint(str(tmp_path / "a"), _state(), step=4, backend="orbax")
    t_ckpt.finalize_checkpoints()
    got, step = t_ckpt.restore_checkpoint(str(tmp_path / "a"), _state(), backend="orbax")
    assert step == 4
    np.testing.assert_array_equal(got["params"][0]["W"], np.arange(6.0).reshape(2, 3))
    assert got["params"][0]["W"].dtype == np.float32
    assert int(got["opt"]["step"]) == 5 and got["opt"]["step"].dtype == np.int32
    assert t_ckpt.have_checkpoint(str(tmp_path / "a"), backend="orbax")
    assert not t_ckpt.have_checkpoint(str(tmp_path / "a"), backend="npz")
    ck = str(tmp_path / "ck")
    _port("GCNCPU", host_graphs, edges, epochs=4, checkpoint_dir=ck,
          ckpt_backend="orbax").run()
    tr = _port("GCNCPU", host_graphs, edges, epochs=6, checkpoint_dir=ck,
               ckpt_backend="orbax")
    tr.run()
    assert len(tr.epoch_times) == 2 and tr._first_epoch_trained == 4


def test_orbax_latest_step_empty_dir_is_none(tmp_path):
    """``test_checkpoint.py:343``: no subdirectory, an empty one, or a step
    whose metadata was never written is no step; a completed save is."""
    path = str(tmp_path / "a")
    assert t_ckpt.orbax_latest_step(path) is None
    os.makedirs(os.path.join(path, t_ckpt.ORBAX_SUBDIR, "9"))  # an unfinished save
    assert t_ckpt.orbax_latest_step(path) is None
    assert not t_ckpt.have_checkpoint(path, backend="orbax")
    assert t_ckpt.restore_checkpoint(path, _state(), backend="orbax") is None
    t_ckpt.save_checkpoint(path, _state(), step=7, backend="orbax")
    assert t_ckpt.orbax_latest_step(path) == 7  # waits for the save in flight


def test_orbax_keeps_two_steps_and_unknown_backend_refuses(tmp_path):
    for step in range(1, 5):
        t_ckpt.save_checkpoint(str(tmp_path), _state(step), step=step, backend="orbax")
    t_ckpt.finalize_checkpoints()
    assert sorted(os.listdir(tmp_path / t_ckpt.ORBAX_SUBDIR)) == ["3", "4"]
    got, step = t_ckpt.restore_checkpoint(str(tmp_path), _state(), backend="orbax")
    assert step == 4 and got["params"][0]["W"][0, 1] == 4.0
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        t_ckpt.resolve_backend("zarr")
    assert t_ckpt.resolve_backend("") == "npz"
