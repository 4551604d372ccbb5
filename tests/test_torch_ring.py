"""The port's pipelined ring, 2D mesh and split mirror against the JAX package's.

- Tables, bitwise: the ring's step tables (P 2 and 4, both directions,
  level by level against the live part of JAX's stacked ``[p]`` slice,
  JAX's extra rows and levels all padding), the static skip schedule (a
  block-banded graph), ``SplitMirror`` and ``estimate_mb_remote``.
- Exchanges: the ring twin (f32 and bf16 wire) and the split mirror twin,
  forward and backward, against JAX's twins (``jax.vjp``), f32, rtol 1e-5
  and atol 1e-6 (the sums add in other orders).
- Helpers: the partitioner's helpers and refusals, the ring schedule's,
  ``wire_accounting``'s row formulas and ``predict_mesh``, equal to JAX's.
- Trainers: 20-epoch f32 loss curves (drop 0) from JAX's initial
  parameters within 1e-4 of JAX's: ``GCNDIST`` on ``ring_blocked_sim``,
  ``MESH:2,2`` and ``MESH:1,2`` (widths 63-31-7, so both the input and the
  hidden width pad), ``COMM_LAYER:mirror`` and ``auto`` (which picks the
  mirror on Cora, against JAX's run of the same cfg on its 8-device CPU
  mesh), ``GCNEAGERDIST`` and ``GINDIST`` (seed 1, see
  ``test_torch_dist.py``) on ``ring_blocked_sim``; ``MESH:2,1`` bitwise the
  1D ring at P=2; the wire gauges equal JAX's.
- Records: the ``ring_step`` records and ``wire.*``, ``ring.*`` and
  ``mesh.*`` gauges of ``configs/gcn_dist_ring_smoke.cfg`` and
  ``configs/gcn_dist_mesh_smoke.cfg`` through both CLIs (the twin) equal.
- Checkpoints: a 2D checkpoint restores into the 1D layout and back, and
  JAX's 2D npz loads into the port.
- Ranks: one spawn of 4 gloo ranks (``tools/dist_parity``): the ring
  exchange bitwise the twin, forward, backward and with the bf16 wire;
  the ``ring_blocked``, ``MESH:2,2`` and ``mirror`` trainers (and
  ``GINDIST`` and ``GCNEAGERDIST`` on ``MESH:2,2``) within 1e-5 of the
  twin, with dropout 0.5 and padded widths.

The JAX runs are cached at module scope; torch runs on one thread.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.graph.storage import load_edges as j_load_edges
from neutronstarlite_tpu.models.base import get_algorithm as j_get_algorithm
from neutronstarlite_tpu.parallel import dist_edge_ops as j_edge
from neutronstarlite_tpu.parallel import dist_ring_blocked as j_ring
from neutronstarlite_tpu.parallel import partitioner as j_part
from neutronstarlite_tpu.parallel import ring_schedule as j_sched
from neutronstarlite_tpu.parallel.dist_graph import DistGraph as JDistGraph
from neutronstarlite_tpu.parallel.mirror import SplitMirror as JSplitMirror
from neutronstarlite_tpu.tools import wire_accounting as j_wire
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph, load_edges
from neutronstarlite_torch.models import get_algorithm
from neutronstarlite_torch.parallel import dist_ring_blocked as t_ring
from neutronstarlite_torch.parallel import partitioner as t_part
from neutronstarlite_torch.parallel import ring_schedule as t_sched
from neutronstarlite_torch.parallel.dist_edge_ops import SplitMirrorExchange
from neutronstarlite_torch.parallel.dist_graph import DistGraph
from neutronstarlite_torch.parallel.dist_ops import dist_gather_dst_from_src
from neutronstarlite_torch.parallel.mirror import SplitMirror
from neutronstarlite_torch.tools import wire_accounting as t_wire
from neutronstarlite_torch.utils.config import InputInfo
from neutronstarlite_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "cora")
EDGES = os.path.join(FIX, "cora.2708.edge.self")
V, F, H, C = 2708, 64, 32, 7
EPOCHS = 20
SIM_TOL = dict(rtol=1e-5, atol=1e-6)
CURVE_TOL = 1e-4
WIRE = ("wire.comm_layer", "wire.rows_per_layer", "wire.bytes_per_epoch_fwd",
        "wire.peak_resident_rows", "dist.active_partitions", "ring.transfers",
        "ring.skipped_steps", "wire.peak_resident_feature_bytes", "mesh.shape", "mesh.pv",
        "mesh.pf", "mesh.devices", "mesh.slab_cols")
ENV = ("NTS_PALLAS_RESIDENT", "NTS_DEBUGINFO", "NTS_NUMERICS", "NTS_ELASTIC", "NTS_WIRE_DTYPE",
       "NTS_MESH", "NTS_METRICS_DIR", "NTS_LEDGER_DIR", "NTS_QUANT_PROBE", "NTS_OVERLAP_PROBE",
       "NTS_ELL_LEVELS", "NTS_DIST_SIMULATE", "NTS_TUNE")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RING_SMOKE = os.path.join(REPO, "configs", "gcn_dist_ring_smoke.cfg")
# the gloo leg: GCNDIST on the new routes, and the 2x2 mesh's other layer
# forms (GIN's replicated W2 and batch norm, the eager order's gather)
GLOO_ROUTES = ("ring_blocked", "mesh2x2", "mirror", "mesh2x2:GINDIST", "mesh2x2:GCNEAGERDIST")
_JAX_CLI = ("from neutronstarlite_tpu.utils.platform import honor_platform_env; "
            "honor_platform_env(); from neutronstarlite_tpu.run import main; "
            "raise SystemExit(main([{!r}]))")


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The two legs that run in other processes, started before the first
    test so that they run beside the in-process ones: the 4 gloo ranks
    (``tools/dist_parity``; the exchange, then the ``GLOO_ROUTES`` trainers
    with dropout 0.5 and widths 31-15-7, so the 2x2 mesh pads) and JAX's CLI on the ring smoke cfg on its 8-device CPU
    mesh (its metrics stream in ``jax_metrics``)."""
    d = tmp_path_factory.mktemp("bg")
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env.update(PYTHONPATH=REPO, NTS_NO_NATIVE="1", NTS_PROGRAM_COST="0")
    out = {"jax_metrics": str(d / "jax")}
    out["gloo"] = subprocess.Popen(
        [sys.executable, "-m", "neutronstarlite_torch.tools.dist_parity", "--partitions",
         "4", "--device", "cpu", "--routes", ",".join(GLOO_ROUTES), "--vertices",
         "400", "--edges", "4000", "--layers", "31-15-7", "--epochs", "3", "--atol", "1e-5",
         "--exchange-check", "--timeout", "55"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out["jax_smoke"] = subprocess.Popen(
        [sys.executable, "-c", _JAX_CLI.format(RING_SMOKE)], cwd=REPO,
        env=dict(env, NTS_METRICS_DIR=out["jax_metrics"], NTS_FINAL_EVAL="0"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield out
    for proc in (out["gloo"], out["jax_smoke"]):
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def _env(monkeypatch, background):
    """JAX's NumPy table fills; every switch of these paths unset."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("NTS_NO_NATIVE", "1")
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)


def _graph(src, dst, v_num):
    return j_build_graph(src, dst, v_num, use_native=False), build_graph(src, dst, v_num, use_native=False)


@pytest.fixture(scope="module")
def tiny():
    """A random multigraph with a hub and self loops."""
    rng = np.random.default_rng(3)
    v_num = 300
    src = rng.integers(0, v_num, size=2400, dtype=np.uint32)
    dst = rng.integers(0, v_num, size=2400, dtype=np.uint32)
    many = rng.integers(0, v_num, size=200, dtype=np.uint32)
    loops = np.arange(v_num, dtype=np.uint32)
    src = np.concatenate([src, many, np.full(200, 5, np.uint32), loops])
    dst = np.concatenate([dst, np.full(200, 5, np.uint32), many, loops])
    return _graph(src, dst, v_num)


@pytest.fixture(scope="module")
def cora():
    src, dst = j_load_edges(EDGES)
    return (src, dst) + _graph(src, dst, V)


def _banded(v_num=64, P=4):
    """Edges only from partition p + h (h in 0, 1) into partition p."""
    per = v_num // P
    src = np.concatenate([((p + h) % P) * per + np.arange(per) for p in range(P)
                          for h in (0, 1)]).astype(np.uint32)
    dst = np.concatenate([p * per + np.arange(per) for p in range(P)
                          for h in (0, 1)]).astype(np.uint32)
    return _graph(src, dst, v_num)


# ---- tables, bitwise ------------------------------------------------------------


def _assert_step_tables_equal(jt, tt, vp):
    """Port ``RingBlockedEll`` against JAX's, level by level per rank."""
    P = jt.partitions
    assert (tt.partitions, tt.vp, tt.vt, tt.n_tiles, tt.direction) == \
        (P, jt.vp, jt.vt, jt.n_tiles, jt.direction)
    assert tt.work_steps() == jt.work_steps()
    assert tt.skipped_steps() == jt.skipped_steps()
    assert tt.n_transfers() == jt.n_transfers()
    for s in range(P):
        j_by_k = {int(n.shape[-1]): i for i, n in enumerate(jt.nbr[s])}
        jn_s, jw_s, jd_s = ([np.asarray(a) for a in t[s]] for t in (jt.nbr, jt.wgt, jt.dst_row))
        for p in range(P):
            mine = tt.tables[p][s]
            if s in jt.skipped_steps():
                assert mine is None
                continue
            seen = set()
            for n, w, d in zip(mine.nbr, mine.wgt, mine.dst_row):
                i = j_by_k[n.shape[-1]]
                seen.add(i)
                rows = n.shape[1]
                jn, jw, jd = jn_s[i][p], jw_s[i][p], jd_s[i][p]
                assert np.array_equal(n.numpy(), jn[:, :rows])
                assert np.array_equal(w.numpy(), jw[:, :rows])
                assert np.array_equal(d.numpy(), jd[:, :rows])
                assert (jd[:, rows:] == vp).all() and not jw[:, rows:].any()
            for i in set(j_by_k.values()) - seen:  # a level this rank has no row of
                assert (jd_s[i][p] == vp).all() and not jw_s[i][p].any()


@pytest.mark.parametrize("P", [2, 4])
def test_ring_step_tables_are_bitwise_jax(tiny, P):
    jg, tg = tiny
    jd, td = JDistGraph.build(jg, P), DistGraph.build(tg, P)
    jp = j_ring.RingBlockedPair.build(jd, vt=48)
    tp = t_ring.RingBlockedPair.build(td, 48, range(P))
    for direction in ("fwd", "bwd"):
        _assert_step_tables_equal(getattr(jp, direction), getattr(tp, direction), jd.vp)


def test_skip_schedule_is_jax_s(monkeypatch):
    jg, tg = _banded()
    jp = j_ring.RingBlockedPair.build(JDistGraph.build(jg, 4), vt=8)
    td = DistGraph.build(tg, 4)
    tp = t_ring.RingBlockedPair.build(td, 8, range(4))
    for direction in ("fwd", "bwd"):
        t = getattr(tp, direction)
        assert t.work_steps() == [0, 1] and t.skipped_steps() == [2, 3]
        assert t.n_transfers() == 1
        _assert_step_tables_equal(getattr(jp, direction), t, td.vp)
    plan = t_ring.ring_wire_plan(tp.fwd, [5, 3], 4, pf=2)
    assert plan == j_ring.ring_wire_plan(jp.fwd, [5, 3], 4, pf=2)
    assert [s["step"] for s in plan["steps"]] == [1]


@pytest.mark.parametrize("P", [2, 4])
def test_split_mirror_is_bitwise_jax(tiny, cora, P):
    for jg, tg in (tiny, cora[2:]):
        assert SplitMirror.estimate_mb_remote(tg, P) == JSplitMirror.estimate_mb_remote(jg, P)
        j, t = JSplitMirror.build(jg, P), SplitMirror.build(tg, P)
        assert (t.partitions, t.vp, t.mb, t.e_num, t.v_num, t.er, t.el) == \
            (j.partitions, j.vp, j.mb, j.e_num, j.v_num, j.er, j.el)
        for name in ("offsets", "need_ids", "r_src_slot", "r_dst", "r_weight", "r_mask",
                     "l_src", "l_dst", "l_weight", "l_mask"):
            a, b = getattr(t, name), getattr(j, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


# ---- the exchanges against JAX's twins ------------------------------------------


def _vjp(fn, x):
    @jax.jit
    def both(a):
        y, vjp = jax.vjp(fn, a)
        return y, vjp(a)[0]

    return [np.asarray(t) for t in both(jnp.asarray(x))]


def _port(ex, x):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = dist_gather_dst_from_src(ex, xt)
    y.backward(torch.from_numpy(x))
    return y.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("P,wire", [(4, None), (2, "bf16")])
def test_ring_twin_matches_jax(tiny, P, wire):
    jg, tg = tiny
    jd, td = JDistGraph.build(jg, P), DistGraph.build(tg, P)
    jp = j_ring.RingBlockedPair.build(jd, vt=128)
    tp = t_ring.RingBlockedPair.build(td, 128, range(P))
    jw = jnp.bfloat16 if wire else None
    tw = torch.bfloat16 if wire else None
    x = np.random.default_rng(P).standard_normal((P * td.vp, 13)).astype(np.float32)
    want = _vjp(lambda a: j_ring.dist_ring_blocked_gather_simulated(jp, a, jw), x)
    got = _port(t_ring.RingBlockedExchange(tp, None, tw), x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **SIM_TOL)
    if wire:  # the narrow wire is real, and within JAX's bf16 bound of the f32 wire
        f32 = t_ring.ring_apply_simulated(tp.fwd, torch.from_numpy(x)).numpy()
        assert not np.array_equal(got[0], f32)
        assert np.abs(got[0] - f32).max() <= 0.02 * np.abs(f32).max()


@pytest.mark.parametrize("P", [2, 4])
def test_split_mirror_twin_matches_jax(tiny, P):
    jg, tg = tiny
    jm, tm = JSplitMirror.build(jg, P), SplitMirror.build(tg, P)
    x = np.random.default_rng(P + 7).standard_normal((P * tm.vp, 11)).astype(np.float32)
    want = _vjp(lambda a: j_edge.dist_gather_dst_from_src_mirror_split_sim(jm, a), x)
    got = _port(SplitMirrorExchange(tm, None), x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **SIM_TOL)


# ---- helpers --------------------------------------------------------------------


def test_partitioner_helpers_match_jax():
    for w, pf in ((1433, 2), (16, 2), (7, 3), (41, 1), (602, 4), (1, 2)):
        assert t_part.slab_width(w, pf) == j_part.slab_width(w, pf)
        assert t_part.padded_width(w, pf) == j_part.padded_width(w, pf)
    for v in ("", "auto", "2,2", "2x2", " 4 X 1 ", "1,2"):
        assert t_part.normalize_mesh_value(v) == j_part.normalize_mesh_value(v)
    for v in ("2;2", "0,2", "2", "a,b"):
        with pytest.raises(ValueError):
            j_part.normalize_mesh_value(v)
        with pytest.raises(ValueError):
            t_part.normalize_mesh_value(v)
    spec, jspec = t_part.MeshSpec.parse("3x2"), j_part.MeshSpec.parse("3x2")
    assert (spec.pv, spec.pf, spec.devices, spec.label(), spec.cfg_value()) == \
        (jspec.pv, jspec.pf, jspec.devices, jspec.label(), jspec.cfg_value())
    a = np.arange(21, dtype=np.float32).reshape(3, 7)
    assert np.array_equal(t_part.pad_feature_cols(a, 2), j_part.pad_feature_cols(a, 2))
    rng = np.random.default_rng(0)
    params = [{"W": rng.standard_normal((7, 4)).astype(np.float32),
               "bn": {"gamma": np.ones(7, np.float32), "beta": np.zeros(7, np.float32)}},
              {"W": rng.standard_normal((4, 7)).astype(np.float32)}]
    tp = t_part.pad_params_feature_dim(params, ("W", "bn"), 7, 2)
    jp = j_part.pad_params_feature_dim(params, ("W", "bn"), 7, 2)
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    back = t_part.unpad_params_feature_dim(tp, ("W", "bn"), 7, 2)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(a, b)
    twin = t_part.Partitioner(spec)
    x, w = rng.standard_normal((5, 7)).astype(np.float32), rng.standard_normal((7, 3))
    got = twin.contract(torch.from_numpy(x), torch.from_numpy(w.astype(np.float32)))
    want = j_part.Partitioner(jspec).contract(jnp.asarray(x), jnp.asarray(w, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw,match", [
    (dict(mesh="2,2", dist_path="all_gather"), "ring-pipelined layout"),
    (dict(mesh="2,2", optim_kernel=True), "OPTIM_KERNEL"),
    (dict(mesh="2,2", comm_layer="mirror"), "ring-only"),
    (dict(mesh="2,2", partitions=8), "PARTITIONS:8 disagrees"),
])
def test_check_mesh_cfg_refuses_as_jax(kw, match):
    for cls, check in ((InputInfo, t_part.check_mesh_cfg), (JInfo, j_part.check_mesh_cfg)):
        cfg = cls()
        for k, v in kw.items():
            setattr(cfg, k, v)
        with pytest.raises(ValueError, match=match):
            check(cfg)


def test_mesh_and_wire_auto_and_env_overrides(monkeypatch, tmp_path):
    """MESH:auto and WIRE_DTYPE:auto (cfg and env) parse and are left to
    the autotuner, which refuses them while it is off; NTS_MESH and
    NTS_WIRE_DTYPE win over the cfg, as in JAX."""
    for line, field in (("MESH:auto", "mesh"), ("WIRE_DTYPE:auto", "wire_dtype")):
        p = tmp_path / "x.cfg"
        p.write_text(f"ALGORITHM:GCNDIST\nPARTITIONS:4\n{line}\n")
        cfg = InputInfo.read_from_cfg_file(str(p))
        assert getattr(cfg, field) == "auto"
        with pytest.raises(ValueError, match="NTS_TUNE"):
            get_algorithm("GCNDIST").check_cfg(cfg)
    p.write_text("ALGORITHM:GCNDIST\nPARTITIONS:4\nMESH:2x2\nWIRE_DTYPE:BF16\n"
                 "DIST_PATH:ring_blocked_sim\nCOMM_LAYER:mirror\n")
    cfg = InputInfo.read_from_cfg_file(str(p))
    assert (cfg.mesh, cfg.wire_dtype, cfg.dist_path, cfg.comm_layer) == \
        ("2,2", "bf16", "ring_blocked_sim", "mirror")
    for value, want in (("", None), ("f32", None), ("bf16", torch.bfloat16)):
        assert t_sched.resolve_wire_dtype(value) == want
        assert (j_sched.resolve_wire_dtype(value) is None) == (want is None)
    with pytest.raises(ValueError, match="WIRE_DTYPE"):
        t_sched.resolve_wire_dtype("fp8")
    monkeypatch.setenv("NTS_WIRE_DTYPE", "bf16")
    assert t_sched.resolve_wire_dtype("f32") == torch.bfloat16
    monkeypatch.setenv("NTS_MESH", "4x1")
    cfg = InputInfo()
    t_part.fold_mesh_env(cfg)
    assert cfg.mesh == "4,1"
    monkeypatch.setenv("NTS_MESH", "auto")
    cfg = InputInfo()
    t_part.fold_mesh_env(cfg)
    assert cfg.mesh == "auto"
    with pytest.raises(ValueError, match="unresolved"):
        t_part.mesh_spec_of(cfg)


def test_ring_schedule_and_wire_formulas_match_jax(cora):
    for P in (1, 2, 4, 5):
        for d in (1, -1):
            assert t_sched.ring_perm(P, d) == j_sched.ring_perm(P, d)
            assert [t_sched.ring_source(p, s, P, d) for p in range(P) for s in range(P)] == \
                [j_sched.ring_source(p, s, P, d) for p in range(P) for s in range(P)]
        for kind in ("ring", "ring_blocked", "ell", "mirror"):
            for f in (t_wire.exchange_rows_per_device, t_wire.peak_resident_rows):
                assert f(kind, P, 688, 384) == getattr(j_wire, f.__name__)(kind, P, 688, 384)
    for work in ([], [0], [0, 1], [0, 2, 3]):
        assert t_sched.trim_transfers(work) == j_sched.trim_transfers(work)
    _, _, jg, tg = cora
    for pv, pf in ((2, 2), (4, 1), (1, 4), (3, 2)):
        for widths, outs in (([1433, 16], None), ([64, 32], [32, 7])):
            assert t_wire.predict_mesh(tg, pv, pf, widths, 4, outs) == \
                j_wire.predict_mesh(jg, pv, pf, widths, 4, outs)


# ---- the trainers against JAX -----------------------------------------------------


def _cfg(cls, algorithm, P=4, **kw):
    cfg = cls()
    cfg.algorithm = algorithm
    cfg.vertices = V
    cfg.layer_string = f"{F}-{H}-{C}"
    cfg.epochs = EPOCHS
    cfg.decay_epoch = 10
    cfg.drop_rate = 0.0
    cfg.partitions = P
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _data(cls, f=F):
    return cls.read_feature_label_mask(
        "", os.path.join(FIX, "cora.labeltable"), os.path.join(FIX, "cora.mask"), V, f,
        seed=0)


# (algorithm, JAX seed, cfg fields): the curves held against JAX
# one source tile per shard (KERNEL_TILE >= vp) keeps JAX's compile of its
# unrolled twin short; the table and exchange tests above cut several tiles
# (P = 4 is held by the tables, the exchanges, the ring smoke cfg and the ranks)
RING = dict(dist_path="ring_blocked_sim", kernel_tile=2048, partitions=2)
MESH = dict(RING, mesh="2,2", partitions=4, layer_string="63-31-7")
RUNS = {
    "ring_blocked": ("GCNDIST", 0, RING),
    "mesh2x2": ("GCNDIST", 0, MESH),
    "mesh1x2": ("GCNDIST", 0, dict(MESH, mesh="1,2", partitions=2)),
    "auto": ("GCNDIST", 0, {}),
    "eager_ring": ("GCNEAGERDIST", 0, RING),
    "gin_ring": ("GINDIST", 1, RING),
}


@pytest.fixture(scope="module")
def jax_runs(cora, tmp_path_factory):
    """JAX's trainer from its own init: (initial params, losses, gauges,
    final params). ``auto`` runs on JAX's 8-device CPU mesh (the mirror
    needs a mesh); ``mesh2x2`` saves its final checkpoint in ``ckpt_dir``."""
    cache = {}
    ckpt_dir = str(tmp_path_factory.mktemp("jck"))

    def get(name):
        if name not in cache:
            algorithm, seed, kw = RUNS[name]
            if name == "mesh2x2":
                kw = dict(kw, checkpoint_dir=ckpt_dir)
            src, dst, jg, _ = cora
            cfg = _cfg(JInfo, algorithm, **kw)
            tr = j_get_algorithm(algorithm).from_arrays(
                cfg, src, dst, _data(JDatum, cfg.layer_sizes()[0]), host_graph=jg, seed=seed)
            p0 = jax.tree.map(np.asarray, tr.params)
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("NTS_FINAL_EVAL", "0")  # no second compile for the accuracy
                tr.run()
            cache[name] = (p0, np.asarray(tr.loss_history),
                           {k: tr.metrics._gauges.get(k) for k in WIRE}, tr.params)
        return cache[name]

    get.ckpt_dir = ckpt_dir
    return get


def _port_trainer(cora, algorithm, p0=None, **kw):
    src, dst, _, tg = cora
    cfg = _cfg(InputInfo, algorithm, **kw)
    tr = get_algorithm(algorithm).from_arrays(cfg, src, dst,
                                              _data(GNNDatum, cfg.layer_sizes()[0]),
                                              device="cpu", host_graph=tg)
    if p0 is not None:
        params_from_jax(p0, tr)
    return tr


@pytest.mark.parametrize("name", list(RUNS) + ["mirror"])
def test_sim_trainer_curve_matches_jax(cora, jax_runs, name, monkeypatch):
    """Each route from JAX's initial parameters; ``mirror`` (the explicit
    COMM_LAYER) is held against JAX's ``auto`` run, which picks it."""
    algorithm, _, kw = RUNS["auto" if name == "mirror" else name]
    p0, j_losses, j_gauges, _ = jax_runs("auto" if name == "mirror" else name)
    if name == "mirror":
        kw = dict(comm_layer="mirror")
    if not kw.get("dist_path"):
        monkeypatch.setenv("NTS_DIST_SIMULATE", "1")
    tr = _port_trainer(cora, algorithm, p0, **kw)
    assert tr.group is None
    tr.run()
    losses = np.asarray(tr.loss_history)
    assert losses.shape == (EPOCHS,) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=CURVE_TOL)
    assert {k: tr.metrics._gauges.get(k) for k in WIRE} == j_gauges
    assert tr.comm_layer == j_gauges["wire.comm_layer"]
    if name == "auto":
        assert tr.comm_layer == "mirror"


def test_mesh_2x1_is_bitwise_the_ring(cora):
    runs = []
    for kw in (dict(dist_path="ring_blocked_sim", partitions=2),
               dict(dist_path="ring_blocked_sim", mesh="2,1", partitions=0)):
        tr = _port_trainer(cora, "GCNDIST", epochs=6, **kw)
        tr.run()
        runs.append(tr.loss_history)
    assert runs[0] == runs[1]


def _stream(d):
    recs = [json.loads(line) for f in sorted(glob.glob(os.path.join(d, "*.jsonl")))
            for line in open(f) if line.strip()]
    hops = [{k: r[k] for k in ("epoch", "step", "bytes", "skipped", "seconds", "slab_cols")}
            for r in recs if r["event"] == "ring_step"]
    summary = [r for r in recs if r["event"] == "run_summary"][-1]
    gauges = {k: summary["gauges"].get(k) for k in WIRE}
    return hops, gauges, summary["counters"].get("wire.bytes_fwd")


def test_ring_smoke_cfg_records_equal_jax(tmp_path, monkeypatch, background):
    """configs/gcn_dist_ring_smoke.cfg unchanged through both CLIs (JAX on
    its 8-device CPU mesh, the port's twin): the ring_step records, the
    wire and ring gauges and the live wire counter equal."""
    from neutronstarlite_torch.run import main as t_main

    monkeypatch.setenv("NTS_PROGRAM_COST", "0")
    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path))
    monkeypatch.setenv("NTS_DIST_SIMULATE", "1")
    assert t_main([RING_SMOKE, "--device", "cpu"]) == 0
    jax_side = background["jax_smoke"]
    _, err = jax_side.communicate(timeout=120)
    assert jax_side.returncode == 0, err[-3000:]
    assert _stream(str(tmp_path)) == _stream(background["jax_metrics"])
    hops, gauges, counter = _stream(str(tmp_path))
    vp = gauges["wire.rows_per_layer"] // 3
    assert len(hops) == 2 * 3 and not any(h["skipped"] for h in hops)
    assert counter == sum(h["bytes"] for h in hops) == 2 * 3 * vp * (1433 + 16) * 4
    assert gauges["wire.peak_resident_rows"] == 2 * vp


def test_mesh_smoke_cfg_through_the_cli(tmp_path, monkeypatch, cora):
    """configs/gcn_dist_mesh_smoke.cfg unchanged through the port's CLI: the
    2x2 gauges, 725-column slabs (1433 pads to 1434) and the live wire
    counter equal to predict_mesh's pricing."""
    from neutronstarlite_torch.run import main as t_main

    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path))
    monkeypatch.setenv("NTS_PROGRAM_COST", "0")
    assert t_main([os.path.join(REPO, "configs", "gcn_dist_mesh_smoke.cfg"), "--device",
                   "cpu"]) == 0
    hops, gauges, counter = _stream(str(tmp_path))
    assert (gauges["mesh.shape"], gauges["mesh.pv"], gauges["mesh.pf"],
            gauges["mesh.devices"], gauges["mesh.slab_cols"]) == ("2x2", 2, 2, 4, 725)
    assert all(h["slab_cols"] == 725 for h in hops) and len(hops) == 2
    pred = t_wire.predict_mesh(cora[3], 2, 2, [1433, 16])
    assert counter == 2 * pred["bytes_per_epoch"]
    assert gauges["wire.peak_resident_feature_bytes"] == pred["peak_resident_feature_bytes"]


# ---- checkpoints -------------------------------------------------------------------


def _leaves(tr):
    return [t.detach().numpy().copy() for t in tr.flat_params]


def _named(params):
    """{layer/name[/sub]: array} of a parameter list (either package's)."""
    out = {}
    for i, layer in enumerate(params):
        for k, v in layer.items():
            for n, a in (v.items() if isinstance(v, dict) else [("", v)]):
                out[f"{i}/{k}/{n}"] = np.asarray(a.detach() if torch.is_tensor(a) else a)
    return out


def test_2d_checkpoint_restores_across_layouts(cora, tmp_path):
    ck = str(tmp_path / "ck")
    kw = dict(layer_string="63-31-7", checkpoint_dir=ck, checkpoint_every=1)
    a = _port_trainer(cora, "GCNDIST", epochs=2, mesh="2,2", dist_path="ring_blocked_sim",
                      **kw)
    a.run()
    assert a.flat_params[0].shape[0] == 64  # 63 padded to a multiple of Pf
    saved = [p[:63] if p.shape[0] == 64 else p for p in _leaves(a)]
    b = _port_trainer(cora, "GCNDIST", epochs=3, dist_path="ring_blocked_sim", partitions=2,
                      **kw)
    assert b.restore(ck) == 2
    assert all(np.array_equal(x, y) for x, y in zip(_leaves(b), saved))
    b.run()  # resumes at epoch 2 in the 1D layout
    assert len(b.loss_history) == 1
    c = _port_trainer(cora, "GCNDIST", epochs=4, mesh="1,2", dist_path="ring_blocked_sim",
                      partitions=2, **kw)
    c.run()
    assert len(c.loss_history) == 1 and np.isfinite(c.loss_history).all()
    assert not c.flat_params[0].detach()[63:].any()  # the padding rows stay zero


def test_jax_2d_checkpoint_loads(cora, jax_runs):
    """JAX's 2x2 run's final checkpoint (unpadded, 63 rows) restores into the
    port's 2x2 trainer, padded, bitwise JAX's final parameters."""
    want = _named(jax_runs("mesh2x2")[3])
    t = _port_trainer(cora, "GCNDIST", **MESH)
    assert t.restore(jax_runs.ckpt_dir) == EPOCHS
    got = _named(t.params)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k


# ---- gloo: four ranks against the twin ----------------------------------------------


def test_four_gloo_ranks_match_the_twin(background):
    """tools/dist_parity at P=4 over gloo on 127.0.0.1 (started by
    ``background``, limit 60 s): the exchange bitwise the twin, the
    trainers within 1e-5."""
    proc = background["gloo"]
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, (out[-2000:], err[-3000:])
    report = json.loads(out.strip().splitlines()[-1])
    assert report["ok"] and report["partitions"] == 4
    for k in ("fwd", "bwd", "fwd_bf16"):
        assert report["exchange"][k]["bitwise"], (k, report["exchange"][k])
    for route in GLOO_ROUTES:
        r = report["routes"][route]
        assert r["max_loss_gap"] <= 1e-5, (route, r["max_loss_gap"])
        assert r["rank0"]["rows"] == r["twin"]["vp"] and len(r["rank0"]["losses"]) == 3
        assert r["twin"]["losses"][-1] < r["twin"]["losses"][0]
