"""The port's native host runtime (``neutronstarlite_torch/native``) on the
CPU, against the JAX package's native runtime and the port's NumPy paths.

- The C++ source is JAX's, byte for byte, at version 6.
- ``build_adjacency``: canonicalised per destination, the structure and the
  weights are bitwise JAX's native output for the same edge list; the graph
  equals the port's NumPy build by ``graph_digest``; every build, in any
  process and at any thread count, gives the same arrays.
- The ELL, blocked and bsp tables, native against NumPy from one host
  graph: bitwise.
- ``sample_hop`` and whole sampled batches are bitwise JAX's native sampler
  on the same host graph and seed; ``dedup_remap`` is ``np.unique`` with
  ``np.searchsorted``.
- JAX's two refusals in ``Sampler``; a failing build raises with the
  compiler's output; ``NTS_NO_NATIVE=1`` and a missing compiler select
  NumPy; two processes building at once both load; the sampling pool with
  the native sampler runs threads and finishes within its own time limit.

Tests that need the host compiler skip where ``available()`` is False (the
decision is made in the fixture, not at import).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.graph.storage import build_graph as j_build_graph
from neutronstarlite_tpu.sample import sampler as j_sampler

from neutronstarlite_torch import native
from neutronstarlite_torch.graph.digest import graph_digest
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.graph.synthetic import synthetic_power_law_graph
from neutronstarlite_torch.ops.blocked_ell import BlockedEll
from neutronstarlite_torch.ops.bsp_ell import BspEll
from neutronstarlite_torch.ops.ell import EllBuckets
from neutronstarlite_torch.sample import sampler as t_sampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def rt(monkeypatch):
    """The port's native runtime, or a skip where it is unavailable."""
    monkeypatch.delenv("NTS_NO_NATIVE", raising=False)
    if not native.available():
        pytest.skip("native runtime unavailable (no host compiler)")
    return native


@pytest.fixture
def jrt(rt):
    if not jax_native.available():
        pytest.skip("the JAX package's native runtime is unavailable")
    return jax_native


def _edges(seed, v, e, hubs=True):
    if hubs:
        return synthetic_power_law_graph(v, e, seed=seed)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, e, dtype=np.uint32), rng.integers(0, v, e, dtype=np.uint32))


def _canon(offsets, nbr, w):
    """Each segment's (neighbour, weight) pairs sorted: the order a native
    build leaves is unspecified within a segment."""
    seg = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    order = np.lexsort((w.view(np.uint32), nbr, seg))
    return nbr[order], w[order]


# ---- the source -------------------------------------------------------------

def test_cpp_copy_equals_the_original():
    with open(os.path.join(REPO, "neutronstarlite_torch", "native", "graph_native.cpp"),
              "rb") as fh:
        mine = fh.read()
    with open(os.path.join(REPO, "neutronstarlite_tpu", "native", "graph_native.cpp"),
              "rb") as fh:
        assert mine == fh.read()


def test_version_and_build_directory(rt):
    assert rt.get_lib().nts_native_version() == rt.VERSION == 6
    assert os.path.dirname(rt.SO) == os.path.join(REPO, "neutronstarlite_torch", "_build")
    assert not os.path.exists(os.path.join(REPO, "neutronstarlite_torch", "native",
                                           "libnts_native.so"))


# ---- the adjacency build -------------------------------------------------------

@pytest.mark.parametrize("weight", ["gcn_norm", "ones"])
@pytest.mark.parametrize("seed,v,e,hubs", [(0, 211, 3000, True), (1, 97, 900, False),
                                           (2, 1500, 60000, True)])
def test_build_adjacency_bitwise_jax_native(rt, jrt, weight, seed, v, e, hubs):
    src, dst = _edges(seed, v, e, hubs)
    mode = 0 if weight == "gcn_norm" else 1
    got, want = rt.build_adjacency(src, dst, v, mode), jrt.build_adjacency(src, dst, v, mode)
    for i in (0, 4, 8, 9):  # offsets and degrees
        np.testing.assert_array_equal(got[i], want[i])
    for off, nbr, w in ((0, 1, 3), (4, 6, 7)):  # CSC by source, CSR by destination
        a, b = _canon(got[off], got[nbr], got[w]), _canon(want[off], want[nbr], want[w])
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1].tobytes() == b[1].tobytes()
    g = build_graph(src, dst, v, weight=weight)
    gp = build_graph(src, dst, v, weight=weight, use_native=False)
    assert graph_digest(g) == graph_digest(gp)
    # grouped by destination / source, as the segment ops promise
    assert np.all(np.diff(g.dst_of_edge) >= 0) and np.all(np.diff(g.src_of_edge) >= 0)
    # the native weights are float32 arithmetic, bitwise 1 / sqrt(f32 d_out *
    # f32 d_in); the NumPy build rounds the float64 value once: at most 3 ulp
    if weight == "gcn_norm":
        f32 = np.float32(1.0) / np.sqrt(
            np.maximum(g.out_degree[g.row_indices], 1).astype(np.float32)
            * np.maximum(g.in_degree[g.dst_of_edge], 1).astype(np.float32))
        assert f32.tobytes() == g.edge_weight_forward.tobytes()
    a = _canon(g.column_offset, g.row_indices, g.edge_weight_forward)[1]
    b = _canon(gp.column_offset, gp.row_indices, gp.edge_weight_forward)[1]
    assert np.all(np.abs(a - b) <= 3 * np.spacing(np.maximum(np.abs(a), np.abs(b))))


_ONE_BUILD = """
import hashlib, sys
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.graph.synthetic import synthetic_power_law_graph
g = build_graph(*synthetic_power_law_graph(1500, 60000, seed=2), 1500)
print(hashlib.sha1(b"".join(getattr(g, f).tobytes() for f in sys.argv[1:])).hexdigest())
"""
_ARRAYS = ("row_indices", "edge_weight_forward", "column_indices", "edge_weight_backward")


def test_native_build_is_one_order_in_every_process(rt):
    """The atomic cursors order a segment by thread timing (JAX's native
    build differs between two builds of this graph on a multi-core host);
    the port sorts each segment by neighbour id, so two builds here and one
    in a process of one OpenMP thread give the same arrays."""
    import hashlib

    src, dst = synthetic_power_law_graph(1500, 60000, seed=2)
    builds = [build_graph(src, dst, 1500) for _ in range(2)]
    for f in _ARRAYS:
        assert getattr(builds[0], f).tobytes() == getattr(builds[1], f).tobytes()
    g = builds[0]
    for off, nbr in ((g.column_offset, g.row_indices), (g.row_offset, g.column_indices)):
        seg = np.repeat(np.arange(len(off) - 1), np.diff(off))
        assert np.all((np.diff(seg) > 0) | (np.diff(nbr) >= 0))  # sorted within each
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("NTS_NO_NATIVE", None)
    out = subprocess.run([sys.executable, "-c", _ONE_BUILD, *_ARRAYS], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    here = hashlib.sha1(b"".join(getattr(g, f).tobytes() for f in _ARRAYS)).hexdigest()
    assert out.stdout.split()[-1] == here


def test_use_native_true_raises_when_switched_off(monkeypatch):
    monkeypatch.setenv("NTS_NO_NATIVE", "1")
    src, dst = _edges(0, 50, 300, False)
    with pytest.raises(RuntimeError, match="unavailable"):
        build_graph(src, dst, 50, use_native=True)


# ---- the tables ------------------------------------------------------------------

def _both(monkeypatch, make):
    """``make()`` with the native runtime, then with NTS_NO_NATIVE=1."""
    a = make()
    monkeypatch.setenv("NTS_NO_NATIVE", "1")
    b = make()
    monkeypatch.delenv("NTS_NO_NATIVE")
    return a, b


def _assert_tensors_equal(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope="module")
def host_graphs():
    out = {}
    for name, (seed, v, e, hubs) in {"power": (3, 2000, 80000, True),
                                     "uniform": (4, 300, 2000, False)}.items():
        src, dst = _edges(seed, v, e, hubs)
        if name == "uniform":  # leave some vertices without edges
            keep = (dst % 7 != 0)
            src, dst = src[keep], dst[keep]
        out[name] = build_graph(src, dst, v, use_native=False)
    return out


@pytest.mark.parametrize("name", ["power", "uniform"])
def test_ell_tables_native_bitwise_numpy(rt, monkeypatch, host_graphs, name):
    g = host_graphs[name]
    for off, adj, w in ((g.column_offset, g.row_indices, g.edge_weight_forward),
                        (g.row_offset, g.column_indices, g.edge_weight_backward)):
        a, b = _both(monkeypatch, lambda: EllBuckets.build(g.v_num, off, adj, w))
        _assert_tensors_equal(a.nbr + a.wgt + a.rows_vertex + a.deg + [a.inv_perm],
                              b.nbr + b.wgt + b.rows_vertex + b.deg + [b.inv_perm])


@pytest.mark.parametrize("levels", ["pow2", "binned"])
@pytest.mark.parametrize("name,vt,src_num", [("power", 256, 0), ("uniform", 64, 0),
                                             ("power", 512, 2400)])
def test_blocked_tables_native_bitwise_numpy(rt, monkeypatch, host_graphs, name, vt,
                                            src_num, levels):
    g = host_graphs[name]
    a, b = _both(monkeypatch, lambda: BlockedEll.build(
        g.v_num, g.column_offset, g.row_indices, g.edge_weight_forward, vt, levels=levels,
        src_num=src_num))
    _assert_tensors_equal(a.nbr + a.wgt + a.dst_row, b.nbr + b.wgt + b.dst_row)
    assert all(np.array_equal(x, y) for x, y in zip(a.n_rows, b.n_rows))


@pytest.mark.parametrize("name,dt,vt,src_num", [("power", 128, 512, 0), ("power", 256, 2048, 0),
                                                ("uniform", 64, 64, 0), ("power", 128, 512, 2600)])
def test_bsp_tables_native_bitwise_numpy(rt, monkeypatch, host_graphs, name, dt, vt, src_num):
    g = host_graphs[name]
    a, b = _both(monkeypatch, lambda: BspEll.build(
        g.v_num, g.column_offset, g.row_indices, g.edge_weight_forward, dt=dt, vt=vt,
        src_num=src_num))
    _assert_tensors_equal([a.nbr, a.wgt, a.ldst, a.blk_key, a.tile_ptr],
                          [b.nbr, b.wgt, b.ldst, b.blk_key, b.tile_ptr])


# ---- the sampler ------------------------------------------------------------------

@pytest.mark.parametrize("fanout", [3, 25, 300])
def test_sample_hop_bitwise_jax_native(rt, jrt, host_graphs, fanout):
    """Reservoir, Floyd (degree > 8 x fanout) and take-all destinations."""
    g = host_graphs["power"]
    dsts = np.arange(0, g.v_num, 3, dtype=np.int64)
    for seed in (1, 2, 99):
        got = rt.sample_hop(g.column_offset, g.row_indices, dsts, fanout, seed)
        want = jrt.sample_hop(g.column_offset, g.row_indices, dsts, fanout, seed)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_dedup_remap_matches_numpy(rt):
    rng = np.random.default_rng(5)
    for n, hi in ((0, 10), (1, 10), (1000, 50), (20000, 10 ** 9)):
        ids = rng.integers(0, hi, n, dtype=np.int64)
        uniq, local = rt.dedup_remap(ids)
        want = np.unique(ids)
        np.testing.assert_array_equal(uniq, want)
        np.testing.assert_array_equal(local, np.searchsorted(want, ids))
    with pytest.raises(ValueError, match="nonnegative"):
        rt.dedup_remap(np.array([3, -1]))


@pytest.mark.parametrize("fanouts", [[3, 3], [5, 10, 10], [25]])
def test_sampled_batches_bitwise_jax_native(rt, jrt, host_graphs, fanouts):
    g = host_graphs["power"]
    jg = j_build_graph(*_edges(3, 2000, 80000, True), 2000, use_native=False)
    assert graph_digest(g) == graph_digest(jg)
    nids = np.arange(0, g.v_num, 7)
    t = t_sampler.Sampler(g, nids, 32, fanouts, seed=11)
    j = j_sampler.Sampler(jg, nids, 32, fanouts, seed=11, use_native=True)
    assert t.use_native and j.use_native
    for _ in range(2):
        got, want = list(t.sample_epoch()), list(j.sample_epoch())
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            arrays = lambda x: list(x.nodes) + [x.seed_mask, x.seeds] + [  # noqa: E731
                getattr(h, f) for h in x.hops for f in ("src_local", "dst_local", "weight")]
            for p, q in zip(arrays(a), arrays(b)):
                assert p.dtype == q.dtype and np.array_equal(p, q)
            assert [h.n_dst for h in a.hops] == [h.n_dst for h in b.hops]


def test_sampler_refusals(host_graphs):
    g = host_graphs["uniform"]
    with pytest.raises(ValueError, match="injected rng"):
        t_sampler.Sampler(g, np.arange(10), 4, [2], use_native=True,
                          rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="hop_sampler"):
        t_sampler.Sampler(g, np.arange(10), 4, [2], use_native=True, hop_sampler=object())
    # an injected Generator or a hop sampler takes the NumPy draw
    assert not t_sampler.Sampler(g, np.arange(10), 4, [2], rng=np.random.default_rng(0)).use_native
    assert not t_sampler.Sampler(g, np.arange(10), 4, [2], hop_sampler=object()).use_native


# ---- building, switching off ----------------------------------------------------

def test_failing_build_raises_with_the_compilers_output(rt, tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int nts_native_version(void) { return undefined_name; }\n')
    with pytest.raises(RuntimeError, match="undefined_name"):
        rt.build([str(bad)], str(tmp_path / "lib.so"))
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    # a CXX that cannot build is followed by g++, which can
    wrapper = tmp_path / "broken-cxx"
    wrapper.write_text("#!/bin/sh\necho 'cannot read spec file libgomp.spec' >&2\nexit 1\n")
    wrapper.chmod(0o755)
    monkeypatch.setenv("CXX", str(wrapper))
    assert rt.compilers()[0] == str(wrapper) and len(rt.compilers()) == 2
    seconds, cc = rt.build(rt.SRCS, str(tmp_path / "lib1.so"))
    assert cc == rt.compilers()[1] and os.path.exists(tmp_path / "lib1.so")
    with pytest.raises(RuntimeError, match="libgomp.spec(.|\n)*undefined_name"):
        rt.build([str(bad)], str(tmp_path / "lib3.so"))
    # the same through available(): a compiler is there, so nothing falls back
    monkeypatch.setattr(rt, "_lib", None)
    monkeypatch.setattr(rt, "SRCS", (str(bad),))
    monkeypatch.setattr(rt, "SO", str(tmp_path / "lib2.so"))
    with pytest.raises(RuntimeError, match="native build failed"):
        rt.available()


def test_no_native_and_no_compiler_select_numpy(monkeypatch, host_graphs, tmp_path):
    g = host_graphs["uniform"]
    monkeypatch.setenv("NTS_NO_NATIVE", "1")
    assert not native.available()
    assert not t_sampler.Sampler(g, np.arange(10), 4, [2]).use_native
    monkeypatch.delenv("NTS_NO_NATIVE")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler-nts")
    monkeypatch.setenv("PATH", str(tmp_path))  # and no g++ either
    assert native.compilers() == [] and not native.available()
    src, dst = _edges(0, 60, 400, False)
    got = build_graph(src, dst, 60)
    want = build_graph(src, dst, 60, use_native=False)
    for f in ("row_indices", "edge_weight_forward", "column_indices", "edge_weight_backward"):
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes()


_CONCURRENT = """
import sys
from neutronstarlite_torch import native
native.SO = sys.argv[1]
native._lib = None
assert native.available()
print("LOADED", native.get_lib().nts_native_version())
"""


def test_concurrent_first_builds_both_load(rt, tmp_path):
    so = str(tmp_path / "build" / "libnts_native.so")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("NTS_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", _CONCURRENT, so], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "LOADED 6" in out, err[-2000:]
    assert os.listdir(tmp_path / "build") == ["libnts_native.so"]


_POOL = """
import sys
import numpy as np
from neutronstarlite_torch.graph.storage import build_graph
from neutronstarlite_torch.graph.synthetic import synthetic_power_law_graph
from neutronstarlite_torch.sample.parallel import ParallelEpochSampler

def main():
    g = build_graph(*synthetic_power_law_graph(3000, 90000, seed=1), 3000)
    nids = np.arange(0, 3000, 2)
    inline = ParallelEpochSampler(g, nids, 64, [5, 5], seed=3, workers=0)
    pool = ParallelEpochSampler(g, nids, 64, [5, 5], seed=3, workers=2, ctx_method="fork")
    print("CTX", pool.ctx_method, flush=True)
    try:
        for epoch in (0, 1):
            want, got = list(inline.sample_epoch(epoch)), list(pool.sample_epoch(epoch))
            assert len(got) == len(want) > 1
            for a, b in zip(got, want):
                for p, q in zip(a.nodes, b.nodes):
                    assert np.array_equal(p, q)
    finally:
        pool.close()
    print("POOL OK", flush=True)

if __name__ == "__main__":
    main()
"""


def test_native_sampling_pool_finishes_in_its_limit(rt, tmp_path):
    """A parent that built its graph natively and asks for a fork pool: the
    workers are threads (an OpenMP thread pool does not survive a fork) and
    give the inline batches, within 180 s."""
    script = tmp_path / "pool.py"
    script.write_text(_POOL)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("NTS_NO_NATIVE", None)
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=180, env=env, cwd=str(tmp_path), start_new_session=True)
    assert out.returncode == 0 and "POOL OK" in out.stdout, out.stderr[-2000:]
    assert "CTX thread" in out.stdout
