"""The port's vertex subsets (utils/bitmap), neighbourhood tables
(ops/edge_tensor) and ``GNNDatum.random_generate`` held against the
reference's on the inputs of ``tests/test_utils_ops.py``.

Tolerances: counts, ids, masks and slots exactly; float reductions of the
same float32 values exactly (one ``where`` and one reduction on each
side); the neighbourhood sums at rtol=atol=1e-5 (float32 sums over K in
another order).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutronstarlite_tpu.ops import edge_tensor as j_et
from neutronstarlite_tpu.ops.device_graph import DeviceGraph
from neutronstarlite_tpu.graph.dataset import GNNDatum as JDatum
from neutronstarlite_tpu.utils import bitmap as j_bm
from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import CSCGraph
from neutronstarlite_torch.ops import edge_tensor as t_et
from neutronstarlite_torch.ops.aggregate import ScatterGraph
from neutronstarlite_torch.utils import bitmap as t_bm
from tests.conftest import tiny_graph


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_graph(jg) -> CSCGraph:
    """The reference's host graph as the port's (one shared host graph)."""
    return CSCGraph(**{f.name: getattr(jg, f.name) for f in dataclasses.fields(CSCGraph)})


def _subsets(mod, of):
    s = mod.VertexSubset.empty(10).set_bit(3).set_bit(7)
    t = mod.VertexSubset.of(10, of)
    return {
        "s": s, "t": t, "union": s.union(t), "intersect": s.intersect(t),
        "invert": s.invert(), "full": mod.VertexSubset.full(10),
        "cleared": s.clear_bit(3), "empty": mod.VertexSubset.empty(10),
    }


@pytest.mark.parametrize("of", [[3, 5], [0, 9], [3, 7]])
def test_vertex_subset_ops_equal_the_reference(of):
    """``test_utils_ops.py::test_vertex_subset_ops`` on both packages: every
    mask and count equal."""
    j, t = _subsets(j_bm, of), _subsets(t_bm, of)
    for name in j:
        assert t[name].mask.dtype == torch.bool
        np.testing.assert_array_equal(t[name].mask.numpy(), np.asarray(j[name].mask), name)
        assert int(t[name].count()) == int(j[name].count()), name
    assert bool(t["s"].get_bit(3)) and not bool(t["s"].get_bit(4))
    assert int(t["union"].count()) == len(set(of) | {3, 7})
    assert t["s"].v_num == 10


@pytest.mark.parametrize("reducer", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
def test_process_vertices_equals_the_reference(reducer, dtype):
    """Masked reductions, floats, integers and booleans: the port's value is
    the reference's (inactive vertices give the reducer's identity)."""
    vals = np.array([5.0, -2.0, 7.0, 1.0, 3.0, 0.0])
    if dtype == "bool":
        vals = vals > 2.0
    vals = vals.astype(dtype)
    ids = [0, 2, 4]
    want = j_bm.process_vertices(lambda i: jnp.asarray(vals)[i],
                                 j_bm.VertexSubset.of(6, ids), reducer)
    got = t_bm.process_vertices(lambda i: torch.from_numpy(vals)[i],
                                t_bm.VertexSubset.of(6, ids), reducer)
    assert got.item() == np.asarray(want).item()


def test_process_vertices_degree_sum_and_an_empty_set(rng):
    """The reference's degree-sum check (sum of in-degrees == e_num), and an
    empty active set reducing to each reducer's identity as in JAX."""
    g = _port_graph(tiny_graph(rng, v_num=30, e_num=150)[0])
    deg = torch.from_numpy(g.in_degree.astype(np.float32))
    total = t_bm.process_vertices(lambda i: deg[i], t_bm.VertexSubset.full(30), "sum")
    assert int(total) == g.e_num
    vals = np.arange(4, dtype=np.float32)
    for reducer in ("sum", "max", "min"):
        want = j_bm.process_vertices(lambda i: jnp.asarray(vals)[i],
                                     j_bm.VertexSubset.empty(4), reducer)
        got = t_bm.process_vertices(lambda i: torch.from_numpy(vals)[i],
                                    t_bm.VertexSubset.empty(4), reducer)
        assert got.item() == np.asarray(want).item()
    with pytest.raises(ValueError, match="reducer"):
        t_bm.process_vertices(lambda i: deg[i], t_bm.VertexSubset.full(30), "mean")


@pytest.mark.parametrize("reducer", ["sum", "max", "min"])
def test_reduce_over_shards_is_the_reference_psum(rng, reducer):
    """The distributed twin: four shards' results combined by
    ``reduce_over_shards`` equal the reference's ``psum``/``pmax``/``pmin``
    across a named axis (here a ``vmap`` axis over the same four shards)
    and the whole-set result."""
    vals = rng.standard_normal((4, 8)).astype(np.float32)
    masks = rng.random((4, 8)) < 0.5
    masks[0, :] = False  # a shard with nothing active

    def shard(v, m):
        return j_bm.process_vertices(lambda i: v[i], j_bm.VertexSubset(m), reducer,
                                     axis_name="shards")

    want = jax.vmap(shard, axis_name="shards")(jnp.asarray(vals), jnp.asarray(masks))
    parts = [t_bm.process_vertices(lambda i, k=k: torch.from_numpy(vals[k])[i],
                                   t_bm.VertexSubset(torch.from_numpy(masks[k])), reducer)
             for k in range(4)]
    got = t_bm.reduce_over_shards(parts, reducer)
    assert got.item() == pytest.approx(float(np.asarray(want)[0]), rel=1e-6)
    whole = t_bm.process_vertices(lambda i: torch.from_numpy(vals.reshape(-1))[i],
                                  t_bm.VertexSubset(torch.from_numpy(masks.reshape(-1))), reducer)
    assert got.item() == pytest.approx(whole.item(), rel=1e-6)


def test_nbr_table_views_equal_the_reference(rng):
    """``test_nbr_table_views_match_dense``: the slot table and mask bitwise
    JAX's, both views and their sums within 1e-5, and the vertex-view sum
    the 0/1 adjacency times x."""
    jg, dense = tiny_graph(rng, v_num=25, e_num=120)
    g = _port_graph(jg)
    jt, tt = j_et.NbrTable.build(jg), t_et.NbrTable.build(g)
    assert tt.cap == jt.cap
    np.testing.assert_array_equal(tt.edge_slot.numpy(), np.asarray(jt.edge_slot))
    np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
    x = rng.standard_normal((g.v_num, 6)).astype(np.float32)
    blocks = tt.vertex_view(ScatterGraph.from_host(g), torch.from_numpy(x))
    jblocks = jt.vertex_view(DeviceGraph.from_host(jg), jnp.asarray(x))
    assert tuple(blocks.shape) == (g.v_num, tt.cap, 6)
    np.testing.assert_allclose(blocks.numpy(), np.asarray(jblocks), rtol=1e-5, atol=1e-5)
    summed = tt.reduce_sum(blocks).numpy()
    np.testing.assert_allclose(summed, np.asarray(jt.reduce_sum(jblocks)), rtol=1e-5, atol=1e-5)
    adj01 = np.zeros_like(dense)
    np.add.at(adj01, (g.dst_of_edge.astype(np.int64), g.row_indices.astype(np.int64)), 1.0)
    np.testing.assert_allclose(summed, adj01 @ x, rtol=1e-4, atol=1e-4)
    w = g.edge_weight_forward[:, None]
    wsum = tt.reduce_sum(tt.edge_view(torch.from_numpy(w))).numpy()[:, 0]
    jw = np.asarray(jt.reduce_sum(jt.edge_view(jnp.asarray(w))))[:, 0]
    np.testing.assert_allclose(wsum, jw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wsum, dense.sum(axis=1), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cap", [1, 3, 1000])
def test_nbr_table_cap_equals_the_reference(rng, cap):
    """``test_nbr_table_cap_truncates``: capped tables bitwise JAX's, each
    row holding min(in-degree, cap) slots."""
    jg, _ = tiny_graph(rng, v_num=25, e_num=300)
    g = _port_graph(jg)
    jt, tt = j_et.NbrTable.build(jg, cap=cap), t_et.NbrTable.build(g, cap=cap)
    assert tt.cap == jt.cap == min(cap, int(g.in_degree.max()))
    np.testing.assert_array_equal(tt.edge_slot.numpy(), np.asarray(jt.edge_slot))
    np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
    np.testing.assert_array_equal(tt.mask.sum(dim=1).numpy(),
                                  np.minimum(g.in_degree, cap).astype(np.float32))


@pytest.mark.parametrize("v_num,f,labels,seed", [(2708, 1433, 7, 0), (465, 602, 41, 7),
                                                  (1, 3, 2, 123)])
def test_random_generate_is_bitwise_the_reference(v_num, f, labels, seed):
    j = JDatum.random_generate(v_num, f, labels, seed=seed)
    t = GNNDatum.random_generate(v_num, f, labels, seed=seed)
    for name in ("feature", "label", "mask"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
