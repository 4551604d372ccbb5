"""The port's edge ops, segment ops and GAT's ELL attention against the JAX
package's.

One host graph (the JAX package's ``tiny_graph`` and friends, built with
NumPy) feeds both sides: the JAX ``DeviceGraph`` pads its edge arrays to a
chunk multiple, so edge tensors are compared on their first E entries.
Same numpy inputs, float32; tolerance rtol=1e-5, atol=1e-6 (the two sides
sum in different orders), except the GAT layers, held at the tolerances
of the JAX package's own fused-vs-chain test (``tests/test_ell_gat.py``).
On the CPU the ELL kernel's wrapper runs its plain version; the kernel on
runtime weights is held against it on the card by
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutronstarlite_tpu.graph import storage as jax_storage
from neutronstarlite_tpu.models import gat as jax_gat
from neutronstarlite_tpu.ops import edge as jax_edge
from neutronstarlite_tpu.ops import segment as jax_segment
from neutronstarlite_tpu.ops.device_graph import DeviceGraph
from neutronstarlite_tpu.ops.ell_gat import GatEllPair as JGatEllPair

from neutronstarlite_torch.models import gat as t_gat
from neutronstarlite_torch.ops import edge as t_edge
from neutronstarlite_torch.ops import ell as t_ell
from neutronstarlite_torch.ops import ell_gat as t_ell_gat
from neutronstarlite_torch.ops import ell_kernel as t_ellk
from neutronstarlite_torch.ops import segment as t_segment
from neutronstarlite_torch.ops.aggregate import ScatterGraph

TOL = dict(rtol=1e-5, atol=1e-6)


def _edges(seed, v_num, e_num, hub=0, self_loops=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v_num, size=e_num, dtype=np.uint32)
    dst = rng.integers(0, v_num, size=e_num, dtype=np.uint32)
    if hub:
        many = rng.integers(0, v_num, size=hub, dtype=np.uint32)
        src = np.concatenate([src, many, np.full(hub, 5, np.uint32)])
        dst = np.concatenate([dst, np.full(hub, 5, np.uint32), many])
    if self_loops:
        loops = np.arange(v_num, dtype=np.uint32)
        src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    return src, dst


GRAPHS = {
    "tiny": dict(seed=17, v_num=23, e_num=101),  # tiny_graph's shape
    "multigraph": dict(seed=1, v_num=83, e_num=460),
    "hub": dict(seed=2, v_num=150, e_num=600, hub=1300),  # a K=2048 level
    "isolated": dict(seed=3, v_num=60, e_num=70, self_loops=False),  # empty rows
}


def _host(name, weight="ones"):
    src, dst = _edges(**GRAPHS[name])
    return jax_storage.build_graph(src, dst, GRAPHS[name]["v_num"], weight=weight,
                                   use_native=False)


def _both(name, weight="ones"):
    g = _host(name, weight)
    return g, DeviceGraph.from_host(g, edge_chunk=128), ScatterGraph.from_host(g)


def _r(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.detach().numpy()


def test_scatter_graph_holds_the_device_graph_edges():
    g, dg, sg = _both("multigraph")
    e = g.e_num
    assert dg.e_pad > e and float(np.asarray(dg.edge_mask)[e:].sum()) == 0.0
    for name in ("csc_src", "csc_dst", "csc_weight", "csr_src", "csr_dst", "csr_weight"):
        np.testing.assert_array_equal(
            getattr(sg, name).numpy(), np.asarray(getattr(dg, name))[:e], err_msg=name
        )


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_segment_ops_match_jax(op):
    ids = np.sort(np.random.default_rng(0).integers(0, 9, size=40)).astype(np.int64)
    ids = ids[ids != 4]  # segment 4 is empty
    data = _r(1, len(ids), 3)
    got = getattr(t_segment, f"segment_{op}_sorted")(
        torch.from_numpy(data), torch.from_numpy(ids), 10)
    want = getattr(jax_segment, f"segment_{op}_sorted")(jnp.asarray(data), jnp.asarray(ids), 10)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    counts = torch.from_numpy(np.ones(len(ids), np.int32))
    got_i = getattr(t_segment, f"segment_{op}_sorted")(counts, torch.from_numpy(ids), 10)
    want_i = getattr(jax_segment, f"segment_{op}_sorted")(
        jnp.ones(len(ids), jnp.int32), jnp.asarray(ids), 10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def _check_op(name, t_fn, j_fn, x_np, graph_name="multigraph", edge_out=False):
    """Forward and the gradient of sum(out * c) in the input, JAX vs port."""
    g, dg, sg = _both(graph_name)
    e = g.e_num
    out_t = None
    xt = torch.from_numpy(x_np).requires_grad_(True)
    out_t = t_fn(sg, xt)
    c = _r(99, *out_t.shape)
    (out_t * torch.from_numpy(c)).sum().backward()
    x_j = jnp.asarray(x_np)
    if x_np.shape[0] == e:  # an edge input: pad it as the JAX graph is
        x_j = jnp.zeros((dg.e_pad,) + x_np.shape[1:], jnp.float32).at[:e].set(x_j)
    out_j = j_fn(dg, x_j)
    c_j = jnp.asarray(c)
    if edge_out:
        out_j = out_j[:e]

        def loss(v):
            return (j_fn(dg, v)[:e] * c_j).sum()
    else:
        def loss(v):
            return (j_fn(dg, v) * c_j).sum()
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), err_msg=name, **TOL)
    grad_j = np.asarray(jax.grad(loss)(x_j))[: x_np.shape[0]]
    np.testing.assert_allclose(_np(xt.grad), grad_j, err_msg=name, **TOL)


@pytest.mark.parametrize("op", ["src", "dst", "src_dst"])
def test_scatter_to_edge_matches_jax(op):
    fn = f"scatter_{op}_to_edge"
    g = _host("multigraph")
    _check_op(fn, getattr(t_edge, fn), getattr(jax_edge, fn), _r(3, g.v_num, 5),
              edge_out=True)


def test_aggregate_edge_to_dst_matches_jax():
    g = _host("multigraph")
    _check_op("aggregate", t_edge.aggregate_edge_to_dst, jax_edge.aggregate_edge_to_dst,
              _r(4, g.e_num, 6))


@pytest.mark.parametrize("w_shape", ["E", "E1", "Ef"])
def test_weighted_aggregate_matches_jax_in_both_inputs(w_shape, monkeypatch):
    """Forward, the gradient in the weights and in x; the chunk is forced
    small so that both directions run over several chunks of edges."""
    import neutronstarlite_torch.ops.edge as edge_mod

    monkeypatch.setattr(edge_mod, "_CHUNK_BYTES", 4 * 7 * 50)  # 50 edges per chunk
    g, dg, sg = _both("multigraph")
    e, f = g.e_num, 7
    w_np = _r(5, *{"E": (e,), "E1": (e, 1), "Ef": (e, f)}[w_shape])
    x_np, c = _r(6, g.v_num, f), _r(7, g.v_num, f)
    wt = torch.from_numpy(w_np).requires_grad_(True)
    xt = torch.from_numpy(x_np).requires_grad_(True)
    out = t_edge.aggregate_edge_to_dst_weighted(sg, wt, xt)
    (out * torch.from_numpy(c)).sum().backward()
    w_pad = jnp.zeros((dg.e_pad,) + w_np.shape[1:], jnp.float32).at[:e].set(w_np)

    def loss(w, x):
        return (jax_edge.aggregate_edge_to_dst_weighted(dg, w, x) * jnp.asarray(c)).sum()

    want = jax_edge.aggregate_edge_to_dst_weighted(dg, w_pad, jnp.asarray(x_np))
    gw, gx = jax.grad(loss, argnums=(0, 1))(w_pad, jnp.asarray(x_np))
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(wt.grad), np.asarray(gw)[:e], **TOL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx), **TOL)


@pytest.mark.parametrize("kind", ["max", "min"])
@pytest.mark.parametrize("graph", ["multigraph", "isolated"])
def test_edge_extreme_routes_to_the_first_winner(kind, graph):
    """Values rounded to a few levels, so many edges of one destination tie;
    the gradient goes to the first of them in CSC order, as in JAX, and a
    destination without in-edges gets 0."""
    g = _host(graph)
    ev = np.round(_r(8, g.e_num, 4)).astype(np.float32)
    fn = f"aggregate_edge_to_dst_{kind}"
    _check_op(fn, getattr(t_edge, fn), getattr(jax_edge, fn), ev, graph_name=graph)
    g, _, sg = _both(graph)
    evt = torch.from_numpy(ev).requires_grad_(True)
    out = getattr(t_edge, fn)(sg, evt)
    out.sum().backward()
    # one edge per (destination, column) holds the gradient
    per_dst = t_segment.segment_sum_sorted(evt.grad, sg.csc_dst, sg.v_num)
    has_in = torch.from_numpy(g.in_degree > 0)
    assert torch.equal(per_dst[has_in], torch.ones_like(per_dst[has_in]))
    assert not out[~has_in].any() and not per_dst[~has_in].any()


@pytest.mark.parametrize("channels", [1, 5])
@pytest.mark.parametrize("graph", ["multigraph", "isolated"])
def test_edge_softmax_matches_jax(channels, graph):
    g = _host(graph)
    score = _r(9, g.e_num, channels) * 3
    _check_op("edge_softmax", t_edge.edge_softmax, jax_edge.edge_softmax, score,
              graph_name=graph, edge_out=True)


def test_edge_softmax_empty_destination_gives_exact_zeros():
    """A destination with no in-edge aggregates to exact zeros and passes a
    finite gradient, through the softmax and the weighted sum."""
    g, _, sg = _both("isolated")
    empty = torch.from_numpy(g.in_degree == 0)
    assert empty.any()
    score = torch.from_numpy(_r(10, g.e_num, 1)).requires_grad_(True)
    h = torch.from_numpy(_r(11, g.v_num, 3)).requires_grad_(True)
    out = t_edge.aggregate_edge_to_dst_weighted(sg, t_edge.edge_softmax(sg, score), h)
    assert torch.equal(out[empty], torch.zeros_like(out[empty]))
    out.sum().backward()
    assert torch.isfinite(score.grad).all() and torch.isfinite(h.grad).all()
    # each destination's weights sum to one
    s = t_edge.edge_softmax(sg, score.detach())
    sums = t_segment.segment_sum_sorted(s, sg.csc_dst, sg.v_num)[~empty]
    np.testing.assert_allclose(_np(sums), 1.0, rtol=1e-6)


# ---- GAT over the ELL tables -----------------------------------------------

@pytest.mark.parametrize("name", list(GRAPHS))
def test_gat_ell_pair_maps_bitwise_equal_jax(name):
    g = _host(name)
    ours = t_ell_gat.GatEllPair.from_host(g)
    ref = JGatEllPair.from_host(g)
    np.testing.assert_array_equal(ours.fwd_row_vertex.numpy(), np.asarray(ref.fwd_row_vertex))
    assert ours.fwd_row_vertex.dtype == torch.int32
    assert len(ours.bwd_alpha_idx) == len(ref.bwd_alpha_idx)
    for a, b in zip(ours.bwd_alpha_idx, ref.bwd_alpha_idx):
        assert a.dtype == torch.int32 and tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gat_ell_pair_refuses_int32_overflow(monkeypatch):
    g = _host("tiny")
    pair = t_ell.EllPair.from_host(g)
    real = t_ell_gat._flat_slot_layout

    def huge(buckets):
        bases, rows, ks, rv = real(buckets)
        return bases, rows[:-1] + [2 ** 31], ks, rv

    monkeypatch.setattr(t_ell_gat, "_flat_slot_layout", huge)
    with pytest.raises(ValueError, match="int32"):
        t_ell_gat.GatEllPair.from_pair(pair, g)


def _xavier(seed, w, h):
    s = np.sqrt(6.0 / (w + h))
    return np.random.default_rng(seed).uniform(-s, s, (w, h)).astype(np.float32)


def _gat_setup(name, f_in=12, f_out=9):
    """The shapes and initialisation of tests/test_ell_gat.py's setup."""
    g = _host(name)
    W, a, x = _xavier(20, f_in, f_out), _xavier(21, 2 * f_out, 1), _r(22, g.v_num, f_in)
    c = _r(23, g.v_num, f_out)
    return g, W, a, x, c


def _port_layer(graph, fn, W, a, x, c, last):
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (W, a, x)]
    out = fn(graph, *ts, last=last)
    (out * torch.from_numpy(c)).sum().backward()
    return _np(out), [_np(t.grad) for t in ts]


@pytest.mark.parametrize("route", ["ell", "chain"])
@pytest.mark.parametrize("last", [True, False], ids=["last", "hidden"])
@pytest.mark.parametrize("name", ["multigraph", "tiny", "isolated"])
def test_gat_layers_match_jax(name, route, last):
    """Forward and the gradients in W, a and x of the port's two GAT layers
    (``gat_layer_ell`` over the ELL tables, ``gat_layer`` over the edge
    arrays) against JAX's ``gat_layer_ell``, at the tolerances of
    tests/test_ell_gat.py, which holds JAX's two layers against each other
    on graphs of this size."""
    _check_gat_layer(name, route, last, tol=lambda ref: dict(rtol=4e-5, atol=4e-6))


@pytest.mark.parametrize("route", ["ell", "chain"])
@pytest.mark.parametrize("last", [True, False], ids=["last", "hidden"])
def test_gat_layers_match_jax_on_a_hub(route, last):
    """The same on the hub graph (one vertex with 1,300 in- and out-edges,
    a K=2,048 level). The W and a gradients there are sums of thousands of
    f32 terms that cancel, so two summation orders differ by more than a
    fixed atol: the atol is 2e-5 of the reference's rms."""
    _check_gat_layer("hub", route, last, tol=lambda ref: dict(
        rtol=4e-5, atol=2e-5 * float(np.sqrt(np.mean(np.square(ref))))))


def _check_gat_layer(name, route, last, tol):
    g, W, a, x, c = _gat_setup(name)
    jgep = JGatEllPair.from_host(g)
    if route == "ell":
        graph, fn = t_ell_gat.GatEllPair.from_host(g), t_gat.gat_layer_ell
    else:
        graph, fn = ScatterGraph.from_host(g), t_gat.gat_layer

    @jax.jit
    def value_and_grads(W, a, x):
        def loss(W, a, x):
            out = jax_gat.gat_layer_ell(jgep, W, a, x, last)
            return (out * jnp.asarray(c)).sum(), out

        return jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(W, a, x)

    (_, want), grads = value_and_grads(jnp.asarray(W), jnp.asarray(a), jnp.asarray(x))
    out, t_grads = _port_layer(graph, fn, W, a, x, c, last)
    np.testing.assert_allclose(out, np.asarray(want), rtol=2e-5, atol=2e-6)
    for got, ref, what in zip(t_grads, grads, ("W", "a", "x")):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, err_msg=what, **tol(ref))


def test_gat_chain_and_ell_layers_agree():
    """The port's two GAT layers against each other (tests/test_ell_gat.py's
    check, on the port's side)."""
    g, W, a, x, c = _gat_setup("multigraph")
    out_e, grads_e = _port_layer(t_ell_gat.GatEllPair.from_host(g), t_gat.gat_layer_ell,
                                 W, a, x, c, True)
    out_c, grads_c = _port_layer(ScatterGraph.from_host(g), t_gat.gat_layer, W, a, x, c, True)
    np.testing.assert_allclose(out_e, out_c, rtol=2e-5, atol=2e-6)
    for got, ref in zip(grads_e, grads_c):
        np.testing.assert_allclose(got, ref, rtol=4e-5, atol=4e-6)


def test_gather_al_levels_transpose_matches_autograd_and_repeats():
    """The scatter-free transpose equals autograd's indexed backward, and
    two backward passes give the same bits."""
    g = _host("hub")
    gep = t_ell_gat.GatEllPair.from_host(g)
    al_np = _r(30, g.v_num)
    cs = [torch.from_numpy(_r(31 + i, *n.shape)) for i, n in enumerate(gep.pair.fwd.nbr)]
    grads = []
    for _ in range(2):
        al = torch.from_numpy(al_np).requires_grad_(True)
        levels = t_ell_gat.GatherAlLevels.apply(al, gep)
        sum((lv * c * w).sum() for lv, c, w in zip(levels, cs, gep.pair.fwd.wgt)).backward()
        grads.append(al.grad.clone())
    assert torch.equal(grads[0], grads[1])
    al = torch.from_numpy(al_np).requires_grad_(True)
    sum((al[n] * c * w).sum() for n, c, w in zip(gep.pair.fwd.nbr, cs, gep.pair.fwd.wgt)).backward()
    np.testing.assert_allclose(_np(grads[0]), _np(al.grad), **TOL)


@pytest.mark.parametrize("budget", [1, 40, 1 << 26])
def test_grad_alpha_level_in_pieces_matches_dense(monkeypatch, budget):
    """Row and slot pieces (forced by a small budget) give the dense einsum,
    0 on padding."""
    monkeypatch.setattr(t_ell_gat, "_PLAIN_CHUNK_ELEMS", budget)
    rng = np.random.default_rng(5)
    nk, k, f, v = 37, 16, 8, 200
    nbr = rng.integers(0, v, (nk, k)).astype(np.int32)
    real = rng.random((nk, k)) > 0.3
    h, g_lv = _r(40, v, f), _r(41, nk, f)
    want = np.where(real, np.einsum("rf,rkf->rk", g_lv, h[nbr]), 0.0)
    got = t_ell_gat.grad_alpha_level(torch.from_numpy(g_lv), torch.from_numpy(h),
                                     torch.from_numpy(nbr), torch.from_numpy(real))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_runtime_weights_take_the_place_of_the_tables_own():
    """The wrapper on runtime weights equals the plain sum with those
    weights, and leaves the tables' own weights (and the GCN path) alone."""
    g = _host("hub", weight="gcn_norm")
    fwd = t_ell.EllPair.from_host(g).fwd
    x = torch.from_numpy(_r(50, g.v_num, 6))
    w = [torch.from_numpy(_r(51 + i, *n.shape)) * (t != 0) for i, (n, t) in
         enumerate(zip(fwd.nbr, fwd.wgt))]
    got = t_ellk.ell_level_aggregate(fwd, x, w)
    want = t_ell.ell_tables_aggregate(x, fwd.nbr, w)[fwd.inv_perm]
    np.testing.assert_array_equal(_np(got), _np(want))
    own = t_ellk.ell_level_aggregate(fwd, x)
    np.testing.assert_array_equal(_np(own), _np(fwd.plain(x)))
    assert not np.allclose(_np(own), _np(got))


def test_ell_weighted_aggregate_gradients_match_dense():
    """EllWeightedAggregate's x- and weight-gradients against a dense
    [V, V] product built from the same runtime weights."""
    g = _host("multigraph")
    gep = t_ell_gat.GatEllPair.from_host(g)
    fwd = gep.pair.fwd
    alphas = [torch.from_numpy(np.abs(_r(60 + i, *n.shape))) * r
              for i, (n, r) in enumerate(zip(fwd.nbr, gep.fwd_real))]
    h_np, c = _r(70, g.v_num, 5), torch.from_numpy(_r(71, g.v_num, 5))
    al = [a.clone().requires_grad_(True) for a in alphas]
    h = torch.from_numpy(h_np).requires_grad_(True)
    (t_ell_gat.runtime_weighted_aggregate(gep, al, h) * c).sum().backward()
    # dense reference: A[dst, src] += alpha of the slot
    rows = gep.fwd_row_vertex.long()
    starts = gep.row_starts()
    dense = torch.zeros((g.v_num, g.v_num), dtype=torch.float64)
    for i, (n, a) in enumerate(zip(fwd.nbr, alphas)):
        dv = rows[starts[i]:starts[i + 1]][:, None].expand_as(n)
        dense.index_put_((dv.reshape(-1), n.long().reshape(-1)), a.double().reshape(-1),
                         accumulate=True)
    np.testing.assert_allclose(_np(h.grad), (dense.T @ c.double()).numpy(), **TOL)
    g_rows = c.double()[rows]
    for i, (n, r, a) in enumerate(zip(fwd.nbr, gep.fwd_real, al)):
        lv = g_rows[starts[i]:starts[i + 1]]
        want = torch.einsum("rf,rkf->rk", lv, torch.from_numpy(h_np).double()[n.long()]) * r
        np.testing.assert_allclose(_np(a.grad), want.numpy(), **TOL)
