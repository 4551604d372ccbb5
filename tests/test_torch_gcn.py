"""Full-batch GCN in the torch port against the JAX trainer, plus the
port's optimizer, layers, CLI and import hygiene.

Parity starts both sides from the JAX trainer's initial parameters
(``gcn_params_from_jax``) with ``drop_rate=0``: torch cannot reproduce
JAX's random draws. The port's kernel routes run their plain versions here
(CPU tensors); the JAX side runs its default scatter route (its own tests
pin bsp == ell == scatter).
"""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.graph.storage import load_edges as j_load_edges
from neutronstarlite_tpu.models.gcn import GCNEagerTrainer as JEager
from neutronstarlite_tpu.models.gcn import GCNTrainer as JGCN
from neutronstarlite_tpu.nn import layers as j_layers
from neutronstarlite_tpu.nn import param as j_param
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import load_edges
from neutronstarlite_torch.models import get_algorithm
from neutronstarlite_torch.models.base import resolve_device
from neutronstarlite_torch.models.gcn import GCNEagerTrainer, GCNTrainer
from neutronstarlite_torch.nn import layers as t_layers
from neutronstarlite_torch.nn import param as t_param
from neutronstarlite_torch.utils.config import InputInfo
from neutronstarlite_torch.utils.convert import gcn_params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "cora")
V, F, H, C = 2708, 64, 32, 7
EPOCHS = 30


def _cfg(cls, **kw):
    cfg = cls()
    cfg.algorithm = kw.pop("algorithm", "GCNCPU")
    cfg.vertices = V
    cfg.layer_string = f"{F}-{H}-{C}"
    cfg.epochs = kw.pop("epochs", EPOCHS)
    cfg.decay_epoch = 10  # the stepped decay fires twice in 30 epochs
    cfg.drop_rate = 0.0
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _data(cls):
    return cls.read_feature_label_mask(
        "", os.path.join(FIX, "cora.labeltable"), os.path.join(FIX, "cora.mask"),
        V, F, seed=0,
    )


EDGES = os.path.join(FIX, "cora.2708.edge.self")


@pytest.fixture(scope="module")
def jax_runs():
    """JAX GCN trained from its own init: (initial params, losses, trained
    params, eval logits) per (order, precision)."""
    cache = {}

    def get(eager: bool, precision: str = "float32", epochs: int = EPOCHS):
        key = (eager, precision, epochs)
        if key not in cache:
            src, dst = j_load_edges(EDGES)
            cfg = _cfg(JInfo, precision=precision, epochs=epochs)
            tr = (JEager if eager else JGCN).from_arrays(cfg, src, dst, _data(JDatum))
            p0 = jax.tree.map(np.asarray, tr.params)
            tr.run()
            logits = np.asarray(tr._eval_logits(
                tr.params, tr.compute_graph, tr.feature, jax.random.PRNGKey(0)
            ))
            cache[key] = (
                p0, np.asarray(tr.loss_history),
                jax.tree.map(np.asarray, tr.params), logits,
            )
        return cache[key]

    return get


def _port(eager, p0, route, precision="float32", epochs=EPOCHS, monkeypatch=None,
          **cfg_kw):
    src, dst = load_edges(EDGES)
    kw = dict(precision=precision, epochs=epochs, **cfg_kw)
    if route in ("bsp", "ell"):
        kw.update(optim_kernel=True, pallas_kernel=True)
        if route == "bsp":
            kw["kernel_tile"] = 512  # several source tiles on Cora
    if monkeypatch is not None:
        monkeypatch.setenv("NTS_PALLAS_RESIDENT", "1" if route == "ell" else "0")
    cls = GCNEagerTrainer if eager else GCNTrainer
    tr = cls.from_arrays(_cfg(InputInfo, **kw), src, dst, _data(GNNDatum), device="cpu")
    if p0 is not None:
        gcn_params_from_jax(p0, tr)
    return tr


@pytest.mark.parametrize("eager", [False, True], ids=["standard", "eager"])
@pytest.mark.parametrize("route", ["scatter", "bsp", "ell"])
def test_trainer_f32_loss_curve_matches_jax(jax_runs, monkeypatch, eager, route):
    """Per-epoch loss within 1e-4 of JAX for 30 epochs. The final logits:
    the port's eval forward at JAX's trained parameters within 1e-3 of
    JAX's, and both trained models predict the same class almost
    everywhere. (The two trained models' logits are not compared at 1e-3:
    a pre-activation within f32 rounding of a ReLU kink can take either
    side in two BLAS libraries, Adam turns that one-vertex gradient change
    into a full-size step on the unit, and 30 epochs of it moved the logits
    by up to 0.04 while the loss curves stayed within 5e-5.)"""
    p0, j_losses, j_params, j_logits = jax_runs(eager)
    tr = _port(eager, p0, route, monkeypatch=monkeypatch)
    out = tr.run()
    losses = np.asarray(tr.loss_history)
    assert losses.shape == (EPOCHS,)
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0]
    ours = tr.eval_logits().numpy()
    agree = (ours.argmax(1) == j_logits.argmax(1)).mean()
    assert agree >= 0.98, agree
    gcn_params_from_jax(j_params, tr)
    np.testing.assert_allclose(tr.eval_logits().numpy(), j_logits, rtol=0, atol=1e-3)
    assert set(out["acc"]) == {"train", "eval", "test"}


@pytest.mark.parametrize("route", ["scatter", "bsp"])
def test_trainer_bf16_loss_curve_tracks_jax(jax_runs, monkeypatch, route):
    p0, j_losses, _, _ = jax_runs(False, "bfloat16", 5)
    tr = _port(False, p0, route, precision="bfloat16", epochs=5, monkeypatch=monkeypatch)
    tr.run()
    np.testing.assert_allclose(np.asarray(tr.loss_history), j_losses, rtol=5e-2)


def test_sublinear_recomputation_is_exact(monkeypatch):
    """SUBLINEAR recomputes layers in the backward; with dropout on, the
    masks must be reused, so the curve is identical."""
    curves = []
    for sub in (False, True):
        tr = _port(False, None, "bsp", epochs=3, monkeypatch=monkeypatch,
                   sublinear=sub, drop_rate=0.5)
        tr.run()
        curves.append(tr.loss_history)
    assert curves[0] == curves[1]


def test_adam_update_matches_jax_across_decay():
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (3,), (4, 2)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    cfg_j = j_param.AdamConfig(alpha=0.05, weight_decay=0.01, decay_rate=0.5, decay_epoch=2)
    cfg_t = t_param.AdamConfig(alpha=0.05, weight_decay=0.01, decay_rate=0.5, decay_epoch=2)
    pj = [jnp.asarray(p) for p in ps]
    sj = j_param.adam_init(pj)
    pt = [torch.from_numpy(p.copy()) for p in ps]
    st = t_param.adam_init(pt)
    for step in range(5):  # steps 2 and 4 cross decay_epoch
        gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        pj, sj = j_param.adam_update(pj, [jnp.asarray(g) for g in gs], sj, cfg_j)
        t_param.adam_update(pt, [torch.from_numpy(g) for g in gs], st, cfg_t)
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert st.step == int(sj.step) == 5
    assert t_param.adam_lr(4, cfg_t) < t_param.adam_lr(3, cfg_t) * 0.6  # decay fired


def test_batch_norm_uses_population_variance():
    x = np.random.default_rng(1).standard_normal((7, 5)).astype(np.float32)
    p = {"gamma": np.linspace(0.5, 2, 5, dtype=np.float32),
         "beta": np.linspace(-1, 1, 5, dtype=np.float32)}
    want = np.asarray(j_layers.batch_norm_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)
    ))
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    got = t_layers.batch_norm_apply(pt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the trap: torch's default (unbiased) variance is visibly different
    xt = torch.from_numpy(x)
    wrong = (xt - xt.mean(0)) / torch.sqrt(xt.var(0) + 1e-5) * pt["gamma"] + pt["beta"]
    assert not np.allclose(wrong.numpy(), want, rtol=1e-3, atol=1e-3)


def test_dropout_statistics():
    rate, shape = 0.3, (400, 250)
    gen = torch.Generator().manual_seed(11)
    mask = t_layers.dropout_mask(shape, rate, gen)
    y = t_layers.dropout(torch.ones(shape), mask, rate)
    keep = 1.0 - rate
    n = shape[0] * shape[1]
    frac = float(mask.float().mean())
    assert abs(frac - keep) <= 4 * np.sqrt(keep * (1 - keep) / n)
    kept = y[mask]
    assert torch.all(kept == torch.tensor(1.0 / keep))
    assert torch.all(y[~mask] == 0)
    again = t_layers.dropout_mask(shape, rate, torch.Generator().manual_seed(11))
    assert torch.equal(mask, again)
    assert t_layers.dropout_mask(shape, 0.0, gen) is None


def test_cli_smoke_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "neutronstarlite_torch.run",
         "configs/gcn_cora_smoke.cfg", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    for line in ("loaded graph |V|=2708 |E|=13566", "Epoch 1 loss", "Train Acc:",
                 "Eval Acc:", "Test Acc:", "--avg epoch time"):
        assert line in proc.stdout, line


_NO_JAX = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None
sys.modules["neutronstarlite_tpu"] = None
import neutronstarlite_torch
for m in pkgutil.walk_packages(neutronstarlite_torch.__path__, "neutronstarlite_torch."):
    importlib.import_module(m.name)
import chip_smoke
from neutronstarlite_torch.run import main
assert main(["configs/gcn_cora_smoke.cfg", "--device", "cpu"]) == 0
assert main(["configs/gat_cora_fused_smoke.cfg", "--device", "cpu"]) == 0
with open("configs/gcn_cora_smoke.cfg") as fh:
    blocked = fh.read() + "OPTIM_KERNEL:1\nKERNEL_TILE:512\n"
with open(sys.argv[1], "w") as fh:
    fh.write(blocked.replace("../tests", os.getcwd() + "/tests"))
assert main([sys.argv[1], "--device", "cpu"]) == 0
with open(sys.argv[3], "w") as fh:
    fh.write(blocked.replace("../tests", os.getcwd() + "/tests").replace(
        "KERNEL_TILE:512", "PARTITIONS:4").replace("ALGORITHM:GCNCPU", "ALGORITHM:GCNDIST"))
os.environ["NTS_DIST_SIMULATE"] = "1"
assert main([sys.argv[3], "--device", "cpu"]) == 0
del os.environ["NTS_DIST_SIMULATE"]
from neutronstarlite_torch.serve.server import main as serve_main
with open("configs/serve_cora_smoke.cfg") as fh:
    serve = fh.read().replace("../tests", os.getcwd() + "/tests")
with open(sys.argv[2], "w") as fh:
    fh.write(serve + "CHECKPOINT_DIR:" + sys.argv[2] + ".ck\n")
os.environ["NTS_SAMPLE_WORKERS"] = "0"
assert main([sys.argv[2], "--device", "cpu"]) == 0
sys.exit(serve_main([sys.argv[2], "--device", "cpu"]))
"""


def test_port_runs_with_jax_poisoned(tmp_path):
    """The port's module tree, chip_smoke.py and the CLI on the default,
    fused (KERNEL:fused_edge) and blocked (OPTIM_KERNEL:1 KERNEL_TILE)
    routes and a distributed cfg (GCNDIST, PARTITIONS:4, the sim twin),
    then the sampled serve smoke trained through the CLI and served by the
    serve CLI, with jax and the JAX package made unimportable."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(tmp_path / "blocked.cfg"),
         str(tmp_path / "serve.cfg"), str(tmp_path / "dist.cfg")], cwd=REPO,
        capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("Epoch 1 loss") == 5
    for line in ("KERNEL:fused_edge", "OPTIM_KERNEL: blocked ELL aggregation",
                 "OPTIM_KERNEL: dist all_gather aggregation (ELL kernel per shard",
                 "served 50 requests (shed 0, errors 0)"):
        assert line in proc.stdout, line


def test_no_file_of_the_port_imports_jax():
    files = glob.glob(os.path.join(REPO, "neutronstarlite_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 10
    banned = ("jax", "neutronstarlite_tpu")
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def test_no_device_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    from neutronstarlite_torch import run

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main([os.path.join(REPO, "configs", "gcn_cora_smoke.cfg")])
    src, dst = load_edges(EDGES)
    with pytest.raises(RuntimeError):
        GCNTrainer.from_arrays(_cfg(InputInfo), src, dst, _data(GNNDatum))
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_algorithm_registry():
    assert get_algorithm("gcncpu") is GCNTrainer
    assert get_algorithm("GCN_CPU_EAGER") is GCNEagerTrainer
    from neutronstarlite_torch.models.gat_dist import DistGATTrainer
    from neutronstarlite_torch.models.test_getdep import GetDepNbrCheck

    assert get_algorithm("test_getdep") is GetDepNbrCheck
    assert get_algorithm("GATDIST") is DistGATTrainer
    with pytest.raises(ValueError, match="not ported"):
        get_algorithm("NO_SUCH_ALGORITHM")
