"""The torch port's host side against the JAX package: cfg parsing, graph
build, datum fallback, and the ELL / block-sparse tables, bitwise."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.graph import dataset as jax_dataset
from neutronstarlite_tpu.graph import storage as jax_storage
from neutronstarlite_tpu.graph import synthetic as jax_synthetic
from neutronstarlite_tpu.ops import bsp_ell as jax_bsp
from neutronstarlite_tpu.ops import ell as jax_ell
from neutronstarlite_tpu.utils import config as jax_config

from neutronstarlite_torch.graph import dataset as t_dataset
from neutronstarlite_torch.graph import storage as t_storage
from neutronstarlite_torch.graph import synthetic as t_synthetic
from neutronstarlite_torch.ops import bsp_ell as t_bsp
from neutronstarlite_torch.ops import ell as t_ell
from neutronstarlite_torch.utils import config as t_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "cora")
HONOURED = (
    "algorithm", "vertices", "epochs", "layer_string", "edge_file", "feature_file",
    "label_file", "mask_file", "learn_rate", "weight_decay", "decay_rate",
    "decay_epoch", "drop_rate", "optim_kernel", "pallas_kernel", "kernel_tile",
    "precision", "sublinear", "with_cuda", "lock_free", "batch_size", "fanout_string",
    "sample_pipeline",
)


@pytest.fixture
def no_native(monkeypatch):
    """The JAX package's NumPy build paths (its native fill is disabled)."""
    monkeypatch.setenv("NTS_NO_NATIVE", "1")
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)


def _random_graph(seed, v_num, e_num, hub=None, self_loops=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v_num, size=e_num, dtype=np.uint32)
    dst = rng.integers(0, v_num, size=e_num, dtype=np.uint32)
    if hub is not None:  # one vertex with `hub` in-edges and out-edges
        many = rng.integers(0, v_num, size=hub, dtype=np.uint32)
        src = np.concatenate([src, many, np.full(hub, 3, np.uint32)])
        dst = np.concatenate([dst, np.full(hub, 3, np.uint32), many])
    if self_loops:
        loops = np.arange(v_num, dtype=np.uint32)
        src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    return src, dst


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "gcn_*.cfg"))))
def test_cfg_parse_agrees_or_refuses(path):
    ref = jax_config.InputInfo.read_from_cfg_file(path)
    keys = set()
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#") and ":" in line:
                keys.add(line.partition(":")[0].strip().upper())
    unsupported = keys - {
        "ALGORITHM", "VERTICES", "EPOCHS", "LAYERS", "EDGE_FILE", "FEATURE_FILE",
        "LABEL_FILE", "MASK_FILE", "LEARN_RATE", "WEIGHT_DECAY", "DECAY_RATE",
        "DECAY_EPOCH", "DROP_RATE", "OPTIM_KERNEL", "PALLAS", "KERNEL_TILE",
        "PRECISION", "SUBLINEAR", "PROC_CUDA", "LOCK_FREE", "PROC_OVERLAP",
        "PROC_LOCAL", "PROC_REP", "PARTITIONS", "BATCH_SIZE", "FANOUT", "SAMPLE_PIPELINE",
        "COMM_LAYER", "DIST_PATH", "MESH", "WIRE_DTYPE", "CHECKPOINT_DIR", "CHECKPOINT_EVERY",
        "KERNEL", "ELL_LEVELS",
    }
    sampled = ref.algorithm.upper() not in t_config.SUPPORTED_ALGORITHMS
    if unsupported or sampled:
        with pytest.raises(ValueError):
            t_config.InputInfo.read_from_cfg_file(path)
        return
    got = t_config.InputInfo.read_from_cfg_file(path)
    for field in HONOURED + ("partitions", "comm_layer", "dist_path", "mesh", "wire_dtype",
                             "checkpoint_dir", "checkpoint_every", "kernel", "ell_levels"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.layer_sizes() == ref.layer_sizes()
    assert got.fanouts() == ref.fanouts()
    base = os.path.dirname(path)
    assert got.resolve_path(got.edge_file, base) == ref.resolve_path(ref.edge_file, base)


@pytest.mark.parametrize("line", [
    "PARTITIONS:4", "KERNEL:auto", "ELL_LEVELS:auto", "SAMPLE_PIPELINE:auto",
    "CKPT_BACKEND:orbax", "PROC_REP:1", "DIST_PATH:ring",
    "DIST_PATH:ring_blocked", "COMM_LAYER:mirror", "WIRE_DTYPE:bf16", "MESH:2,2",
    "PRECISION:bf16", "NO_SUCH_KEY:1",
])
def test_cfg_refuses_unported_keys(tmp_path, line):
    """Refused at the parse, or (the autotuner's auto axes, while it is
    off) at the trainer's funnel. ``CKPT_BACKEND:orbax`` (the sharded
    backend, since the elastic slice) parses as JAX's and passes the
    funnel with a CHECKPOINT_DIR."""
    from neutronstarlite_torch.models import get_algorithm

    p = tmp_path / "x.cfg"
    p.write_text("ALGORITHM:GCNCPU\nVERTICES:10\nLAYERS:4-2\n" + line + "\n")
    if line == "CKPT_BACKEND:orbax":
        p.write_text(p.read_text() + f"CHECKPOINT_DIR:{tmp_path}\n")
        cfg = t_config.InputInfo.read_from_cfg_file(str(p))
        ref = jax_config.InputInfo.read_from_cfg_file(str(p))
        assert cfg.ckpt_backend == ref.ckpt_backend == "orbax"
        get_algorithm(cfg.algorithm).check_cfg(cfg)
        return
    with pytest.raises(ValueError):
        cfg = t_config.InputInfo.read_from_cfg_file(str(p))
        get_algorithm(cfg.algorithm).check_cfg(cfg)


@pytest.mark.parametrize("line,field,value", [
    ("SAMPLE_PIPELINE:pipelined", "sample_pipeline", "pipelined"),
    ("ALGORITHM:GCNSAMPLESINGLE", "algorithm", "GCNSAMPLESINGLE"),
    ("FANOUT:5-5", "fanout_string", "5-5"),
])
def test_cfg_parses_the_sampled_keys(tmp_path, line, field, value):
    """The three lines earlier slices refused, now that sampling is ported."""
    p = tmp_path / "x.cfg"
    p.write_text("ALGORITHM:GCNCPU\nVERTICES:10\nLAYERS:4-2\n" + line + "\n")
    got = t_config.InputInfo.read_from_cfg_file(str(p))
    ref = jax_config.InputInfo.read_from_cfg_file(str(p))
    assert getattr(got, field) == getattr(ref, field) == value


@pytest.mark.parametrize("line,field,value", [
    ("ALGORITHM:GATDIST", "algorithm", "GATDIST"),
])
def test_cfg_parses_the_mirror_family(tmp_path, line, field, value):
    """The line earlier slices refused, now that the distributed edge
    family is ported."""
    p = tmp_path / "x.cfg"
    p.write_text("ALGORITHM:GCNCPU\nVERTICES:10\nLAYERS:4-2\n" + line + "\n")
    got = t_config.InputInfo.read_from_cfg_file(str(p))
    ref = jax_config.InputInfo.read_from_cfg_file(str(p))
    assert getattr(got, field) == getattr(ref, field) == value


def test_cfg_cross_key_refusals():
    cfg = t_config.InputInfo(algorithm="GCNCPU", pallas_kernel=True)
    with pytest.raises(ValueError, match="OPTIM_KERNEL"):
        t_config.check_supported(cfg, resident=False)
    # KERNEL_TILE without PALLAS: the blocked ELL route (under OPTIM_KERNEL)
    cfg = t_config.InputInfo(algorithm="GCNCPU", kernel_tile=64)
    t_config.check_supported(cfg, resident=False)
    cfg = t_config.InputInfo(algorithm="GCNCPU", optim_kernel=True, kernel_tile=64)
    t_config.check_supported(cfg, resident=False)
    cfg = t_config.InputInfo(
        algorithm="GCNCPU", optim_kernel=True, pallas_kernel=True, kernel_tile=64
    )
    t_config.check_supported(cfg, resident=False)
    with pytest.raises(ValueError, match="no tile"):
        t_config.check_supported(cfg, resident=True)


def _assert_graph_equal(a, b):
    for field in (
        "column_offset", "row_indices", "dst_of_edge", "edge_weight_forward",
        "row_offset", "column_indices", "src_of_edge", "edge_weight_backward",
        "out_degree", "in_degree",
    ):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert (a.v_num, a.e_num) == (b.v_num, b.e_num)


@pytest.mark.parametrize("weight", ["gcn_norm", "ones"])
def test_build_graph_bitwise(weight):
    src, dst = _random_graph(3, 211, 1900, hub=300)
    _assert_graph_equal(
        t_storage.build_graph(src, dst, 211, weight=weight, use_native=False),
        jax_storage.build_graph(src, dst, 211, weight=weight, use_native=False),
    )


def test_cora_fixture_load_and_build_bitwise():
    path = os.path.join(FIX, "cora.2708.edge.self")
    s1, d1 = t_storage.load_edges(path)
    s2, d2 = jax_storage.load_edges(path)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(d1, d2)
    _assert_graph_equal(
        t_storage.build_graph(s1, d1, 2708, use_native=False),
        jax_storage.build_graph(s2, d2, 2708, use_native=False),
    )
    np.testing.assert_array_equal(
        t_storage.gcn_norm_weights(s1, d1, np.bincount(s1, minlength=2708),
                                   np.bincount(d1, minlength=2708)),
        jax_storage.gcn_norm_weights(s2, d2, np.bincount(s2, minlength=2708),
                                     np.bincount(d2, minlength=2708)),
    )


@pytest.mark.parametrize("files", ["none", "labels_and_mask"])
def test_datum_fallback_bitwise(files):
    lab = os.path.join(FIX, "cora.labeltable") if files != "none" else ""
    mask = os.path.join(FIX, "cora.mask") if files != "none" else ""
    a = t_dataset.GNNDatum.read_feature_label_mask("", lab, mask, 2708, 64, seed=7)
    b = jax_dataset.GNNDatum.read_feature_label_mask("", lab, mask, 2708, 64, seed=7)
    for field in ("feature", "label", "mask"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y, err_msg=field)


def test_synthetic_power_law_bitwise():
    a = t_synthetic.synthetic_power_law_graph(500, 9000, seed=4)
    b = jax_synthetic.synthetic_power_law_graph(500, 9000, seed=4)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert t_synthetic.reddit_scaled(0.1) == (23296, 11461589)


def _ell_cases():
    yield "hub", _random_graph(5, 300, 2000, hub=1500)  # K=2048 levels
    yield "isolated", _random_graph(6, 120, 200, self_loops=False)  # K=0 level
    yield "edgeless", (np.zeros(0, np.uint32), np.zeros(0, np.uint32))


@pytest.mark.parametrize("case", ["hub", "isolated", "edgeless"])
def test_ell_tables_bitwise(case, no_native):
    src, dst = dict(_ell_cases())[case]
    v = {"hub": 300, "isolated": 120, "edgeless": 17}[case]
    g = t_storage.build_graph(src, dst, v, use_native=False)
    ours = t_ell.EllPair.from_host(g)
    ref = jax_ell.EllPair.from_host(jax_storage.build_graph(src, dst, v, use_native=False))
    for side in ("fwd", "bwd"):
        a, b = getattr(ours, side), getattr(ref, side)
        assert len(a.nbr) == len(b.nbr)
        for n1, n2, w1, w2 in zip(a.nbr, b.nbr, a.wgt, b.wgt):
            np.testing.assert_array_equal(n1.numpy(), np.asarray(n2))
            np.testing.assert_array_equal(w1.numpy(), np.asarray(w2))
        np.testing.assert_array_equal(a.inv_perm.numpy(), np.asarray(b.inv_perm))
        # rows_vertex is the inverse of inv_perm, level by level
        rows = np.concatenate([r.numpy() for r in a.rows_vertex])
        np.testing.assert_array_equal(a.inv_perm.numpy()[rows], np.arange(v))
    if case == "hub":
        assert max(n.shape[1] for n in ours.fwd.nbr) > 1024
    if case != "hub":
        assert ours.fwd.nbr[0].shape[1] == 0


@pytest.mark.parametrize("geom", [(8, 16, 4, 8), (16, 8, 8, 16), (512, 4096, 8, 128)])
def test_bsp_tables_bitwise(geom, no_native):
    dt, vt, K, R = geom
    src, dst = _random_graph(9, 173, 1400, hub=90)
    g = t_storage.build_graph(src, dst, 173, use_native=False)
    ours = t_bsp.BspEllPair.from_host(g, dt=dt, vt=vt, k_slots=K, r_rows=R)
    ref = jax_bsp.BspEllPair.from_host(
        jax_storage.build_graph(src, dst, 173, use_native=False),
        dt=dt, vt=vt, k_slots=K, r_rows=R,
    )
    for side in ("fwd", "bwd"):
        a, b = getattr(ours, side), getattr(ref, side)
        assert b.n_seg == 1
        for name in ("nbr", "wgt", "ldst", "blk_key"):
            np.testing.assert_array_equal(
                getattr(a, name).numpy(), np.asarray(getattr(b, name)), err_msg=name
            )
        # tile_ptr ranges hold exactly each dst tile's data blocks
        key = a.blk_key.numpy()
        ptr = a.tile_ptr.numpy()
        assert ptr[0] == 0 and np.all(np.diff(ptr) >= 0)
        for d in range(a.t_dst):
            assert np.all(key[ptr[d]:ptr[d + 1]] // a.t_src == d)


def test_bsp_tables_edgeless(no_native):
    empty = np.zeros(0, np.uint32)
    g = t_storage.build_graph(empty, empty, 13, weight="ones", use_native=False)
    ours = t_bsp.BspEll.build(13, g.column_offset, g.row_indices,
                              g.edge_weight_forward, dt=4, vt=4, k_slots=4, r_rows=8)
    ref = jax_bsp.BspEll.build(13, g.column_offset, g.row_indices,
                               g.edge_weight_forward, dt=4, vt=4, k_slots=4, r_rows=8)
    np.testing.assert_array_equal(ours.blk_key.numpy(), np.asarray(ref.blk_key))
    np.testing.assert_array_equal(ours.tile_ptr.numpy(), np.zeros(5, np.int32))
