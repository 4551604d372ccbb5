"""GAT, GIN, CommNet and GGCN in the torch port against the JAX trainers,
plus their hooks, refusals and CLI.

Parity starts both sides from the JAX trainer's initial parameters
(``params_from_jax``) with ``drop_rate=0``: torch cannot reproduce JAX's
random draws. One host graph per edge-weight mode (NumPy build, so both
sides see the same edge order) is shared by every trainer. The JAX runs
are cached at module scope. The port's kernel routes run their plain
versions here (CPU tensors); on the JAX side GIN and CommNet run the
default scatter route (its own tests pin bsp == ell == scatter), GAT runs
the route under test (the edge chain, or the ELL attention under
OPTIM_KERNEL:1), GGCN its edge chain.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.graph.storage import load_edges as j_load_edges
from neutronstarlite_tpu.models.commnet import CommNetTrainer as JCommNet
from neutronstarlite_tpu.models.gat import GATTrainer as JGAT
from neutronstarlite_tpu.models.ggcn import GGCNTrainer as JGGCN
from neutronstarlite_tpu.models.gin import GINTrainer as JGIN
from neutronstarlite_tpu.utils.config import InputInfo as JInfo

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import build_graph, load_edges
from neutronstarlite_torch.models import get_algorithm
from neutronstarlite_torch.models.commnet import CommNetTrainer
from neutronstarlite_torch.models.fullbatch import param_leaves
from neutronstarlite_torch.models.gat import GATTrainer
from neutronstarlite_torch.models.ggcn import GGCNTrainer
from neutronstarlite_torch.models.gin import GINTrainer
from neutronstarlite_torch.ops.aggregate import ScatterGraph
from neutronstarlite_torch.ops.bsp_ell import BspEllPair
from neutronstarlite_torch.ops.ell import EllPair
from neutronstarlite_torch.ops.ell_gat import GatEllPair
from neutronstarlite_torch.utils import config as t_config
from neutronstarlite_torch.utils.config import InputInfo
from neutronstarlite_torch.utils.convert import gcn_params_from_jax, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "cora")
EDGES = os.path.join(FIX, "cora.2708.edge.self")
V, F, H, C = 2708, 64, 32, 7
EPOCHS = 20

FAMILIES = {
    "GAT": (JGAT, GATTrainer),
    "GIN": (JGIN, GINTrainer),
    "COMMNET": (JCommNet, CommNetTrainer),
    "GGCN": (JGGCN, GGCNTrainer),
}


def _cfg(cls, algorithm, route="scatter", **kw):
    cfg = cls()
    cfg.algorithm = algorithm
    cfg.vertices = V
    cfg.layer_string = f"{F}-{H}-{C}"
    cfg.epochs = EPOCHS
    cfg.decay_epoch = 10  # the stepped decay fires in 20 epochs
    cfg.drop_rate = 0.0
    cfg.optim_kernel = route in ("ell", "bsp")
    cfg.pallas_kernel = route == "bsp"
    if route == "bsp":
        cfg.kernel_tile = 512  # several source tiles on Cora
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _data(cls):
    return cls.read_feature_label_mask(
        "", os.path.join(FIX, "cora.labeltable"), os.path.join(FIX, "cora.mask"),
        V, F, seed=0,
    )


@pytest.fixture(scope="module")
def edges():
    return j_load_edges(EDGES)


@pytest.fixture(scope="module")
def host_graphs(edges):
    """One NumPy host build per edge-weight mode for each side (the two
    builds are bitwise equal; tests/test_torch_graph.py pins it)."""
    src, dst = edges
    return {
        w: (j_build_graph(src, dst, V, weight=w, use_native=False), build_graph(src, dst, V, w))
        for w in ("gcn_norm", "ones")
    }


@pytest.fixture(scope="module")
def jax_runs(edges, host_graphs):
    """JAX trainer from its own init: (initial params, losses, trained
    params, eval logits) per (family, route)."""
    cache = {}

    def get(family: str, route: str):
        jroute = "ell" if (family, route) == ("GAT", "ell") else "scatter"
        key = (family, jroute)
        if key not in cache:
            jcls = FAMILIES[family][0]
            src, dst = edges
            tr = jcls.from_arrays(
                _cfg(JInfo, family, jroute), src, dst,
                _data(JDatum), host_graph=host_graphs[jcls.weight_mode][0],
            )
            p0 = jax.tree.map(np.asarray, tr.params)
            tr.run()
            logits = np.asarray(tr._eval_logits(
                tr.params, tr.compute_graph, tr.feature, jax.random.PRNGKey(0)
            ))
            cache[key] = (p0, np.asarray(tr.loss_history),
                          jax.tree.map(np.asarray, tr.params), logits)
        return cache[key]

    return get


def _port(family, route, host_graphs, p0=None, monkeypatch=None, **cfg_kw):
    cls = FAMILIES[family][1]
    if monkeypatch is not None:
        monkeypatch.setenv("NTS_PALLAS_RESIDENT", "0")
    src, dst = load_edges(EDGES)
    tr = cls.from_arrays(_cfg(InputInfo, family, route, **cfg_kw), src, dst,
                         _data(GNNDatum), device="cpu",
                         host_graph=host_graphs[cls.weight_mode][1])
    if p0 is not None:
        params_from_jax(p0, tr)
    return tr


# the route's compute graph on the port's side
ROUTE_GRAPH = {
    ("GAT", "chain"): ScatterGraph, ("GAT", "ell"): GatEllPair,
    ("GIN", "scatter"): ScatterGraph, ("GIN", "ell"): EllPair, ("GIN", "bsp"): BspEllPair,
    ("COMMNET", "scatter"): ScatterGraph, ("COMMNET", "ell"): EllPair,
    ("COMMNET", "bsp"): BspEllPair, ("GGCN", "chain"): ScatterGraph,
}


@pytest.mark.parametrize("family,route", list(ROUTE_GRAPH),
                         ids=[f"{f}-{r}" for f, r in ROUTE_GRAPH])
def test_trainer_f32_loss_curve_matches_jax(jax_runs, host_graphs, monkeypatch, family,
                                            route):
    """Per-epoch loss within 1e-4 of JAX for 20 epochs; the port's eval
    forward at JAX's trained parameters within 1e-3 of JAX's; both trained
    models predict the same class almost everywhere (a pre-activation at a
    ReLU kink can take either side in two BLAS libraries, and Adam turns
    that into a full-size step, so the two trained models' logits are not
    compared at 1e-3; see tests/test_torch_gcn.py)."""
    p0, j_losses, j_params, j_logits = jax_runs(family, route)
    tr = _port(family, route, host_graphs, p0, monkeypatch)
    assert isinstance(tr.compute_graph, ROUTE_GRAPH[(family, route)])
    out = tr.run()
    losses = np.asarray(tr.loss_history)
    assert losses.shape == (EPOCHS,)
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0]
    agree = (tr.eval_logits().numpy().argmax(1) == j_logits.argmax(1)).mean()
    assert agree >= 0.98, agree
    params_from_jax(j_params, tr)
    np.testing.assert_allclose(tr.eval_logits().numpy(), j_logits, rtol=0, atol=1e-3)
    assert set(out["acc"]) == {"train", "eval", "test"}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_params_round_trip_by_name(host_graphs, family):
    """Every family's parameters flatten by name and load back; the JAX
    layout (names, shapes) is the port's."""
    tr = _port(family, "scatter" if family in ("GIN", "COMMNET") else "chain", host_graphs)
    names = {k for layer in tr.params for k in layer}
    want = {"GAT": {"W", "a"}, "GIN": {"W1", "W2", "bn"}, "COMMNET": {"C", "H"},
            "GGCN": {"W", "Ws", "Wd"}}[family]
    assert names == want
    leaves = [p.detach().clone() for p in param_leaves(tr.params)]
    doubled = [{k: ({n: 2 * t for n, t in v.items()} if isinstance(v, dict) else 2 * v)
                for k, v in layer.items()} for layer in tr.params]
    tr.load_params(doubled)
    for a, b in zip(param_leaves(tr.params), leaves):
        assert torch.equal(a.detach(), 2 * b)
    assert gcn_params_from_jax is params_from_jax
    with pytest.raises(ValueError, match="unknown parameter"):
        param_leaves([{"Q": torch.zeros(1)}])


def test_bf16_warns_and_runs_f32(host_graphs, caplog):
    """PRECISION:bfloat16 on a non-GCN trainer logs the JAX warning and
    trains exactly as f32."""
    curves = []
    for precision in ("float32", "bfloat16"):
        lg = logging.getLogger("nts_torch")
        lg.addHandler(caplog.handler)
        try:
            with caplog.at_level(logging.WARNING, logger="nts_torch"):
                tr = _port("GIN", "scatter", host_graphs, precision=precision, epochs=3)
        finally:
            lg.removeHandler(caplog.handler)
        tr.run()
        curves.append(tr.loss_history)
        warned = "PRECISION:bfloat16 is not implemented" in caplog.text
        assert warned == (precision == "bfloat16")
        assert all(p.dtype == torch.float32 for p in tr.flat_params)
    assert curves[0] == curves[1]


@pytest.mark.parametrize("resident", ["0", "1"])
def test_gat_refuses_pallas(host_graphs, monkeypatch, resident):
    monkeypatch.setenv("NTS_PALLAS_RESIDENT", resident)
    src, dst = load_edges(EDGES)
    cfg = _cfg(InputInfo, "GATCPU", "bsp", kernel_tile=0)
    with pytest.raises(ValueError, match="PALLAS"):
        GATTrainer.from_arrays(cfg, src, dst, _data(GNNDatum), device="cpu",
                               host_graph=host_graphs["ones"][1])


def test_ggcn_runs_its_edge_chain_under_optim_kernel(host_graphs):
    tr = _port("GGCN", "ell", host_graphs, epochs=1)
    assert isinstance(tr.compute_graph, ScatterGraph)
    tr.run()


def test_kernel_fused_edge_is_refused(tmp_path, host_graphs):
    """KERNEL:auto (the autotuner's choice) is refused; KERNEL:fused_edge
    is refused on a family without the fused op (GCN) and beside
    OPTIM_KERNEL, as in JAX, and accepted on GAT and GGCN."""
    p = tmp_path / "gat.cfg"
    p.write_text("ALGORITHM:GATCPU\nVERTICES:10\nLAYERS:4-2\nKERNEL:auto\n")
    with pytest.raises(ValueError, match="autotuner"):
        InputInfo.read_from_cfg_file(str(p))
    p.write_text("ALGORITHM:GATCPU\nVERTICES:10\nLAYERS:4-2\nKERNEL:\n")
    assert InputInfo.read_from_cfg_file(str(p)).kernel == ""
    p.write_text("ALGORITHM:GATCPU\nVERTICES:10\nLAYERS:4-2\nKERNEL:fused_edge\n")
    assert InputInfo.read_from_cfg_file(str(p)).kernel == "fused_edge"
    with pytest.raises(ValueError, match="autotuner"):
        t_config.check_supported(InputInfo(algorithm="GAT", kernel="auto"), False, True)
    with pytest.raises(ValueError, match="not available"):
        t_config.check_supported(InputInfo(algorithm="GCN", kernel="fused_edge"), False)
    src, dst = load_edges(EDGES)
    cfg = _cfg(InputInfo, "GCNCPU", kernel="fused_edge")
    with pytest.raises(ValueError, match="not available"):
        get_algorithm("GCNCPU").from_arrays(cfg, src, dst, _data(GNNDatum), device="cpu",
                                             host_graph=host_graphs["gcn_norm"][1])
    for family in ("GAT", "GGCN"):
        cfg = _cfg(InputInfo, family, "ell", kernel="fused_edge")
        with pytest.raises(ValueError, match="choose one"):
            FAMILIES[family][1].from_arrays(cfg, src, dst, _data(GNNDatum), device="cpu",
                                            host_graph=host_graphs["ones"][1])
        t_config.check_supported(_cfg(InputInfo, family, kernel="fused_edge"), False, True)


FAMILY_CFGS = ("gat_cora.cfg", "gat_cora_optim.cfg", "gat_cora_fused_smoke.cfg",
               "gin_cora.cfg", "commnet_cora.cfg", "ggcn_cora.cfg")


@pytest.mark.parametrize("name", FAMILY_CFGS)
def test_family_cfgs_parse_as_jax_or_refuse(name):
    """The repo's cfgs of the four families: the port reads what JAX reads
    (KERNEL:fused_edge and, since the uniform mirror family is ported, the
    dist GAT algorithm included), or refuses (KERNEL:auto) with a
    ValueError."""
    path = os.path.join(REPO, "configs", name)
    ref = JInfo.read_from_cfg_file(path)
    if (ref.algorithm.upper() not in t_config.SUPPORTED_ALGORITHMS
            or ref.kernel not in ("", "fused_edge")):
        with pytest.raises(ValueError):
            InputInfo.read_from_cfg_file(path)
        return
    got = InputInfo.read_from_cfg_file(path)
    for field in ("algorithm", "vertices", "epochs", "layer_string", "learn_rate",
                  "weight_decay", "decay_rate", "decay_epoch", "drop_rate",
                  "optim_kernel", "pallas_kernel", "edge_file", "label_file",
                  "kernel", "kernel_tile", "ell_levels"):
        assert getattr(got, field) == getattr(ref, field), field
    from neutronstarlite_torch.models.gat_dist import DistGATTrainer

    assert get_algorithm(got.algorithm) is {
        "GATCPU": GATTrainer, "GINGPU": GINTrainer, "COMMNETGPU": CommNetTrainer,
        "GGCNCPU": GGCNTrainer, "GATGPUDIST": DistGATTrainer,
    }[got.algorithm.upper()]


def test_algorithm_names_register_every_family():
    for names, cls in ((t_config.GAT_ALGORITHMS, GATTrainer),
                       (t_config.GIN_ALGORITHMS, GINTrainer),
                       (t_config.COMMNET_ALGORITHMS, CommNetTrainer),
                       (t_config.GGCN_ALGORITHMS, GGCNTrainer)):
        for name in names:
            assert get_algorithm(name.lower()) is cls
            assert name in t_config.SUPPORTED_ALGORITHMS
    assert GATTrainer.weight_mode == GGCNTrainer.weight_mode == "ones"
    assert GINTrainer.weight_mode == CommNetTrainer.weight_mode == "gcn_norm"
    assert GATTrainer.supports_optim_kernel and GINTrainer.supports_optim_kernel
    assert CommNetTrainer.supports_optim_kernel and not GGCNTrainer.supports_optim_kernel
    assert GATTrainer.supports_fused_edge and GGCNTrainer.supports_fused_edge
    assert not (GINTrainer.supports_fused_edge or CommNetTrainer.supports_fused_edge)


def _gat_cfg(path):
    path.write_text(
        "ALGORITHM:GATCPU\nVERTICES:2708\nLAYERS:1433-16-7\nEPOCHS:3\n"
        f"EDGE_FILE:{EDGES}\nLABEL_FILE:{FIX}/cora.labeltable\nMASK_FILE:{FIX}/cora.mask\n"
        "LEARN_RATE:0.01\nWEIGHT_DECAY:0.0001\nDECAY_EPOCH:-1\nDROP_RATE:0.5\n"
        "OPTIM_KERNEL:1\n"
    )
    return str(path)


def test_gat_cli_runs_on_cpu(tmp_path):
    cfg = _gat_cfg(tmp_path / "gat.cfg")
    proc = subprocess.run(
        [sys.executable, "-m", "neutronstarlite_torch.run", cfg, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    for line in ("loaded graph |V|=2708 |E|=13566", "ELL-level aggregation kernel",
                 "Epoch 2 loss", "Train Acc:", "Test Acc:", "--avg epoch time"):
        assert line in proc.stdout, line


def test_gat_cli_without_device_and_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from neutronstarlite_torch import run

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main([_gat_cfg(tmp_path / "gat.cfg")])
