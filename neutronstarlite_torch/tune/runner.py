"""Per-candidate scoring: an analytic prior, then short timed trials — port of
``neutronstarlite_tpu/tune/runner.py``.

1. **Analytic prior** (:func:`analytic_priors`): a byte score per candidate
   from ``tools/wire_accounting.predict_all`` (exchange bytes per epoch and
   peak exchange residency; the 2D mesh's from ``predict_mesh``, its
   feature all-reduce included), plus the edge chain's ``[E, .]`` tensor
   traffic (the ``kernel.edge_hbm_bytes_per_epoch`` formula), or the sampled
   path's per-epoch host-to-device payload. No device work. It prunes the
   space to ``NTS_TUNE_MAX_TRIALS`` (default 4) before anything is timed.
2. **Timed trials** (:func:`measure_candidates`): one forward and backward
   leg per surviving candidate at the model's widths, with the inputs JAX's
   runner draws (``np.random.default_rng(seed)``, in its order), so each
   leg computes JAX's value. The dense exchanges run their twin on one
   device (the same twin the trainer runs there) and the real exchange over
   ``torch.distributed`` ranks; the all_gather leg runs the rectangular
   ``ell_level`` kernel. The edge families run the edge chain against the
   fused op at the hidden width and score channels. Each leg runs eagerly,
   with a synchronise around each call (launch overhead is part of what is
   compared: no compiled or captured graph), ``NTS_TUNE_STEPS`` (default
   2) timed calls after one call that is left out, and scores their warm
   median (``obs/collectors.steady_state_stats``). A candidate the rig
   cannot measure keeps its prior (``source=prior``).

Every kernel a leg runs is built before its first timed call: the excluded
call is the first use, which builds it (``ops/_build.py``). Rigs (tables
and inputs) that no later candidate shares are freed after their trial;
the trial phase's peak device memory is the ``tune.trial_peak_bytes``
gauge. Over ranks each rank times its own legs and the scores are then
all-reduced with MAX (the step's time is its slowest rank's), so every
rank picks the same tuple.

Every scored candidate emits one ``tune_trial`` record; with a registry
whose program costs are captured (``obs/cost``) each timed leg also writes
a ``tune.trial/<label>`` ``program_cost``, counted over one extra call.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from neutronstarlite_torch.obs import cost
from neutronstarlite_torch.obs.collectors import steady_state_stats
from neutronstarlite_torch.parallel import mesh as pmesh
from neutronstarlite_torch.tune.space import Candidate, _norm, mesh_reachable
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("tune")

SLOPE = 0.01  # the attention's leaky_relu slope in every edge leg


def tune_steps() -> int:
    """Timed calls per trial (``NTS_TUNE_STEPS``, default 2, at least 1);
    one more call runs first and is left out of the score."""
    raw = os.environ.get("NTS_TUNE_STEPS", "")
    try:
        return max(int(raw), 1) if raw else 2
    except ValueError:
        log.warning("bad NTS_TUNE_STEPS=%r; using 2", raw)
        return 2


def max_trials() -> int:
    """The trial budget after the prior's pruning (``NTS_TUNE_MAX_TRIALS``,
    default 4, at least 1)."""
    raw = os.environ.get("NTS_TUNE_MAX_TRIALS", "")
    try:
        return max(int(raw), 1) if raw else 4
    except ValueError:
        log.warning("bad NTS_TUNE_MAX_TRIALS=%r; using 4", raw)
        return 4


def _bf16(wire_dtype: str) -> bool:
    return _norm("wire_dtype", wire_dtype) == "bf16"


# ---- stage 1: the analytic prior -------------------------------------------


def _sample_caps(sample_cfg) -> tuple:
    """(batch_size, fanouts, node_caps, n_seeds) of the sampled family's
    facts: the sampler's capacity recurrence."""
    sc = sample_cfg or {}
    B = int(sc.get("batch_size", 16) or 16)
    fans = [int(x) for x in (sc.get("fanouts") or [])] or [2]
    caps = [B]
    for fo in reversed(fans):
        caps.append(caps[-1] * fo)
    caps = list(reversed(caps))
    return B, fans, caps, int(sc.get("n_seeds", 0) or 0)


def analytic_priors(host_graph, P: int, sizes: List[int], family: str,
                    candidates: List[Candidate], precision: str = "float32",
                    score_channels: int = 1, eager_widths: bool = False,
                    sample_cfg: Optional[dict] = None) -> Dict[str, int]:
    """{label: predicted bytes per epoch}; lower is better. The score is
    exchange bytes + peak exchange residency + edge-tensor traffic, from the
    formulas the live counters are priced by."""
    from neutronstarlite_torch.models.gcn_dist import exchange_widths
    from neutronstarlite_torch.tools.wire_accounting import predict_all

    sizes = [int(s) for s in sizes] or [1]
    widths = exchange_widths(eager_widths, sizes) or [sizes[0]]
    hidden = sizes[1:] or [sizes[0]]
    base_item = 2 if precision == "bfloat16" else 4
    # one predict_all pass at itemsize 1 (its rows do not depend on the
    # itemsize and its mirror estimates walk every edge); each candidate
    # scales the unit scores by its own itemsize
    unit = None
    if family in ("dist_dense", "edge_dist"):
        unit = predict_all(host_graph, P, widths[0],
                           widths=(hidden if family == "edge_dist" else widths),
                           itemsize=1)["strategies"]
    mesh_units: Dict[str, dict] = {}
    out: Dict[str, int] = {}
    for cand in candidates:
        item = 2 if _bf16(cand.wire_dtype) else base_item
        score = 0
        if family == "dist_dense" and cand.mesh:
            # the ring at slab width + the feature all-reduce at each
            # contraction + the slab-resident double buffer; the all-reduce
            # keeps a (1, P) shape from pricing as wire-free
            from neutronstarlite_torch.tools.wire_accounting import predict_mesh

            if cand.mesh not in mesh_units:
                pv, pf = (int(t) for t in cand.mesh.split(","))
                mesh_units[cand.mesh] = predict_mesh(host_graph, pv, pf, widths, itemsize=1,
                                                     out_widths=hidden)
            pred = mesh_units[cand.mesh]
            score = item * pred["bytes_per_epoch"] + base_item * pred[
                "allreduce_bytes_per_epoch"] + item * pred["peak_resident_feature_bytes"]
        elif family == "dist_dense":
            pred = unit["ell" if cand.dist_path == "all_gather" else "ring_blocked"]
            score = item * (pred["bytes_per_epoch"] + pred["peak_resident_bytes"])
        elif family in ("edge_single", "edge_dist"):
            if family == "edge_dist":
                pred = unit["ring" if cand.kernel == "fused_edge" else "mirror"]
                score += base_item * (pred["bytes_per_epoch"] + pred["peak_resident_bytes"])
            if cand.kernel != "fused_edge":
                # the edge chain's [E, .] traffic: two feature-wide and three
                # score-wide passes per layer; the fused op has none
                e = int(host_graph.e_num)
                score += sum(e * (2 * f + 3 * score_channels) * 4 for f in hidden)
        elif family == "sampled":
            # the per-epoch payload: sync, pipelined and device ship every
            # padded batch, fused none (the trials order the other three)
            from neutronstarlite_torch.tools.wire_accounting import sample_h2d_bytes_per_epoch

            B, fans, caps, n_seeds = _sample_caps(sample_cfg)
            mode = _norm("sample_pipeline", cand.sample_pipeline) or "sync"
            score = sample_h2d_bytes_per_epoch(n_seeds or int(host_graph.v_num), caps, fans,
                                               mode=mode)
        out[cand.label()] = int(score)
    return out


# ---- stage 2: timed trials ---------------------------------------------------


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _warm(run: Callable[[], Any], steps: int, device) -> float:
    """Warm-median seconds of ``run()`` over ``steps`` timed calls after
    one call that is left out; a synchronise closes each call."""
    times = []
    for _ in range(steps + 1):
        _sync(device)
        t0 = time.perf_counter()
        run()
        _sync(device)
        times.append(time.perf_counter() - t0)
    warm = steady_state_stats(times)["warm_median_s"]
    return float(warm if warm is not None else times[-1])


def _count_cost(metrics, label: str, run: Callable[[], Any], device, dims) -> None:
    """One counted call of ``run`` as the ``tune.trial/<label>`` program
    cost, when the registry's costs are captured (``obs/cost``)."""
    if metrics is None or not cost.cost_enabled(metrics):
        return
    with cost.count_step(device) as count:
        run()
    cost.capture_program_cost(metrics, f"tune.trial/{label}", count, int(dims[0]),
                              int(dims[1]), torch.device(device).type)


def _time_leg(fn, steps: int, metrics=None, label: str = "", device="cpu",
              dims=(0, 0)) -> float:
    """Warm-median seconds of ``fn(1.0)`` (the leg's forward and backward);
    ``dims`` = (edges, vertices) price the kernels' cost records."""
    _count_cost(metrics, label, lambda: fn(1.0), device, dims)
    return _warm(lambda: fn(1.0), steps, device)


def _grad_leg(exchange_fn, x: torch.Tensor):
    """``s -> (value, d value / d s)`` of ``sum(exchange_fn(x * s) ** 2)``:
    the gradient with respect to the scale runs the whole backward."""

    def leg(s):
        scale = torch.tensor(float(s), dtype=torch.float32, device=x.device,
                             requires_grad=True)
        value = (exchange_fn(x * scale) ** 2).sum()
        (grad,) = torch.autograd.grad(value, scale)
        return value.detach(), grad

    return leg


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _padded(space, rng, width: int, group, device) -> torch.Tensor:
    """A padded vertex-space random array (a rank's rows on ranks)."""
    arr = space.pad_vertex_array(
        rng.standard_normal((int(space.v_num), width)).astype(np.float32))
    if group is not None:
        arr = arr[group.rank * space.vp:(group.rank + 1) * space.vp]
    return _tensor(arr, device)


def _last_use(keys: List[List[str]]) -> Dict[str, int]:
    """The index of the last candidate that uses each rig key."""
    out: Dict[str, int] = {}
    for i, ks in enumerate(keys):
        for k in ks:
            out[k] = i
    return out


def _dist_dense_legs(host_graph, P, sizes, candidates, simulate, kernel_tile, edge_chunk,
                     steps, rng, metrics, device) -> Dict[str, Optional[float]]:
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
    from neutronstarlite_torch.parallel.dist_ell import build_dist_ell
    from neutronstarlite_torch.parallel.dist_graph import DistGraph
    from neutronstarlite_torch.parallel.dist_ops import GatherExchange, dist_gather_dst_from_src
    from neutronstarlite_torch.parallel.dist_ring_blocked import (
        RingBlockedExchange,
        RingBlockedPair,
        default_ring_vt,
    )
    from neutronstarlite_torch.parallel.partitioner import MeshSpec, Partitioner, pad_feature_cols

    out: Dict[str, Optional[float]] = {}
    f = sizes[0]  # the input width: the widest exchange
    dims = (int(host_graph.e_num), int(host_graph.v_num))
    rigs: Dict[str, Any] = {}

    def base_rig():
        # the P-way 1D layout and its input, built on first use (a space of
        # mesh candidates alone never partitions over P)
        if "base" not in rigs:
            d = DistGraph.build(host_graph, P, edge_chunk=edge_chunk or None)
            xh = d.pad_vertex_array(
                rng.standard_normal((host_graph.v_num, f)).astype(np.float32))
            rigs["base"] = (d, xh)
        return rigs["base"]

    def group_of(n):
        return None if simulate or not mesh_reachable(n) else pmesh.resolve_group(n, False)[0]

    # every leg is the exchange and one contraction at the first hidden
    # width: the same matmul for each candidate, and on a 2D mesh its
    # feature all-reduce (the twin: the slab-partial sum) is timed too
    h1 = sizes[1] if len(sizes) > 1 else f
    W_c = _tensor(rng.standard_normal((f, h1)).astype(np.float32), device)

    def keys_of(c: Candidate) -> List[str]:
        if c.mesh:
            return [f"mesh:{c.mesh}"]
        if c.dist_path == "all_gather":
            return ["base", "ag"]
        if _norm("dist_path", c.dist_path) == "ring_blocked":
            return ["base", "ring"]
        return []

    keys = [keys_of(c) for c in candidates]
    last = _last_use(keys)
    for i, cand in enumerate(candidates):
        label = cand.label()
        wdt = torch.bfloat16 if _bf16(cand.wire_dtype) else None
        if cand.mesh:
            pv, pf = (int(t) for t in cand.mesh.split(","))
            key = f"mesh:{cand.mesh}"
            if key not in rigs:
                d2 = DistGraph.build(host_graph, pv, edge_chunk=edge_chunk or None)
                vt = default_ring_vt(d2.vp, kernel_tile)
                part = Partitioner.build(MeshSpec(pv, pf), simulate or not mesh_reachable(pv * pf))
                grid = part.grid
                shards = range(pv) if grid is None else [grid.v]
                pair = RingBlockedPair.build(d2, vt, shards, device=device)
                xh = pad_feature_cols(d2.pad_vertex_array(
                    rng.standard_normal((host_graph.v_num, f)).astype(np.float32)), pf)
                if grid is not None:
                    xh = xh[grid.v * d2.vp:(grid.v + 1) * d2.vp]
                    if part.slabbed:
                        xh = xh[:, part.slab_cols(xh.shape[1])]
                rigs[key] = (pair, part, _tensor(xh, device))
            pair, part, x = rigs[key]
            ex = RingBlockedExchange(pair, part.grid.vertex if part.grid is not None else None,
                                     wdt)
            fn = (lambda v, e=ex, c=part.contract:  # noqa: E731
                  c(dist_gather_dst_from_src(e, v), W_c))
            out[label] = _time_leg(_grad_leg(fn, x), steps, metrics, label, device, dims)
        elif cand.dist_path == "all_gather":
            if simulate or not mesh_reachable(P):
                out[label] = None  # no trial on the twin
            else:
                group = group_of(P)
                d, xh = base_rig()
                if "ag" not in rigs:
                    shards = range(P) if group is None else [group.rank]
                    rigs["ag"] = (build_dist_ell(d, shards, device=device),
                                  _tensor(xh if group is None else
                                          xh[group.rank * d.vp:(group.rank + 1) * d.vp],
                                          device))
                tables, x = rigs["ag"]
                ex = GatherExchange(tables, ell_level_aggregate, group, "ell_level")
                fn = lambda v, e=ex: dist_gather_dst_from_src(e, v) @ W_c  # noqa: E731
                out[label] = _time_leg(_grad_leg(fn, x), steps, metrics, label, device, dims)
        elif _norm("dist_path", cand.dist_path) == "ring_blocked":
            d, xh = base_rig()
            group = group_of(P)
            if "ring" not in rigs:
                shards = range(P) if group is None else [group.rank]
                pair = RingBlockedPair.build(d, default_ring_vt(d.vp, kernel_tile), shards,
                                             device=device)
                rigs["ring"] = (pair, _tensor(
                    xh if group is None else xh[group.rank * d.vp:(group.rank + 1) * d.vp],
                    device))
            pair, x = rigs["ring"]
            ex = RingBlockedExchange(pair, group, wdt)
            fn = lambda v, e=ex: dist_gather_dst_from_src(e, v) @ W_c  # noqa: E731
            out[label] = _time_leg(_grad_leg(fn, x), steps, metrics, label, device, dims)
        else:
            out[label] = None
        for k in keys[i]:  # free what no later candidate shares
            if last[k] == i:
                rigs.pop(k, None)
    return out


def _edge_single_legs(host_graph, sizes, candidates, kernel_tile, score_channels, steps,
                      rng, metrics, device) -> Dict[str, Optional[float]]:
    from neutronstarlite_torch.ops.aggregate import ScatterGraph
    from neutronstarlite_torch.ops.edge import aggregate_edge_to_dst_weighted, edge_softmax
    from neutronstarlite_torch.ops.fused_edge import FusedEdgePair, fused_edge_attention_aggregate

    f1 = sizes[1] if len(sizes) > 1 else sizes[0]
    C = int(score_channels)
    v = host_graph.v_num
    dims = (int(host_graph.e_num), int(v))
    h = _tensor(rng.standard_normal((v, f1)).astype(np.float32), device)
    al = _tensor(rng.standard_normal((v, C)).astype(np.float32), device)
    ar = _tensor(rng.standard_normal((v, C)).astype(np.float32), device)
    sg = None
    out: Dict[str, Optional[float]] = {}
    for cand in candidates:
        label = cand.label()
        if cand.kernel == "fused_edge":
            fep = FusedEdgePair.from_host(host_graph, vt=kernel_tile,
                                          levels=cand.ell_levels or "", device=device)
            fn = lambda x, fe=fep: fused_edge_attention_aggregate(fe, x, al, ar, SLOPE)  # noqa: E731
        else:
            if sg is None:
                sg = ScatterGraph.from_host(host_graph, device=device)

            def fn(x, g=sg):  # the edge chain
                score = F.leaky_relu(al[g.csc_src] + ar[g.csc_dst], SLOPE)
                return aggregate_edge_to_dst_weighted(g, edge_softmax(g, score), x)

        out[label] = _time_leg(_grad_leg(fn, h), steps, metrics, label, device, dims)
    return out


def _edge_dist_legs(host_graph, P, sizes, candidates, simulate, kernel_tile, edge_chunk,
                    score_channels, steps, rng, metrics, device) -> Dict[str, Optional[float]]:
    from neutronstarlite_torch.models.gat_dist import edge_chunk as chain_chunk
    from neutronstarlite_torch.parallel.dist_edge_ops import UniformMirror, dist_gated_chain
    from neutronstarlite_torch.parallel.dist_fused_edge import (
        RingFusedEdgePair,
        dist_fused_edge_aggregate,
    )
    from neutronstarlite_torch.parallel.dist_graph import DistGraph
    from neutronstarlite_torch.parallel.dist_ring_blocked import default_ring_vt
    from neutronstarlite_torch.parallel.mirror import MirrorGraph

    f1 = sizes[1] if len(sizes) > 1 else sizes[0]
    C = int(score_channels)
    dims = (int(host_graph.e_num), int(host_graph.v_num))
    group = None
    if not simulate and mesh_reachable(P):
        group = pmesh.resolve_group(P, False)[0]
    out: Dict[str, Optional[float]] = {}
    for cand in candidates:
        label = cand.label()
        if cand.kernel == "fused_edge":
            dist = DistGraph.build(host_graph, P, edge_chunk=edge_chunk or None)
            shards = range(P) if group is None else [group.rank]
            pair = RingFusedEdgePair.build(dist, default_ring_vt(dist.vp, kernel_tile), shards,
                                           device=device)
            h = _padded(dist, rng, f1, group, device)
            al = _padded(dist, rng, C, group, device)
            ar = _padded(dist, rng, C, group, device)
            fn = (lambda x, p=pair, a=al, b=ar:  # noqa: E731
                  dist_fused_edge_aggregate(p, group, x, a, b, SLOPE))
            out[label] = _time_leg(_grad_leg(fn, h), steps, metrics, label, device, dims)
        elif C == 1:
            # the edge chain's trial is the GAT layer over the mirror (the
            # GGCN form, C = f', has no generic leg and keeps its prior)
            mg = MirrorGraph.build(host_graph, P)
            ex = UniformMirror(mg, group, device,
                               chunk=chain_chunk() if group is not None else None)
            f0 = sizes[0]
            W = _tensor(rng.standard_normal((f0, f1)).astype(np.float32), device)
            a = _tensor(rng.standard_normal((2 * f1, 1)).astype(np.float32), device)
            h = _padded(mg, rng, f0, group, device)

            def fn(x, e=ex):
                hh = x @ W
                payload = torch.cat([hh, hh @ a[:f1]], dim=1)
                return dist_gated_chain(e, payload, hh @ a[f1:], f1, SLOPE)

            out[label] = _time_leg(_grad_leg(fn, h), steps, metrics, label, device, dims)
        else:
            out[label] = None
    return out


def measure_candidates(host_graph, P: int, sizes: List[int], family: str,
                       candidates: List[Candidate], simulate: bool,
                       kernel_tile: int = 0, edge_chunk: int = 0, score_channels: int = 1,
                       steps: Optional[int] = None, seed: int = 7, metrics=None,
                       sample_cfg: Optional[dict] = None,
                       device="cpu") -> Dict[str, Optional[float]]:
    """{label: warm seconds, or None where this rig cannot measure it}."""
    steps = steps if steps is not None else tune_steps()
    sizes = [int(s) for s in sizes] or [8]
    rng = np.random.default_rng(seed)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    if family == "dist_dense":
        out = _dist_dense_legs(host_graph, P, sizes, candidates, simulate, kernel_tile,
                               edge_chunk, steps, rng, metrics, device)
    elif family == "edge_single":
        out = _edge_single_legs(host_graph, sizes, candidates, kernel_tile, score_channels,
                                steps, rng, metrics, device)
    elif family == "edge_dist":
        out = _edge_dist_legs(host_graph, P, sizes, candidates, simulate, kernel_tile,
                              edge_chunk, score_channels, steps, rng, metrics, device)
    elif family == "sampled":
        out = _measure_sampled(host_graph, candidates, steps, seed, sample_cfg, metrics,
                               device)
    else:
        # the plain family: nothing to measure, the space is one empty tuple
        out = {cand.label(): None for cand in candidates}
    if cuda and metrics is not None:
        metrics.gauge_set("tune.trial_peak_bytes", int(torch.cuda.max_memory_allocated(device)))
    return out


def _measure_sampled(host_graph, candidates: List[Candidate], steps: int, seed: int,
                     sample_cfg: Optional[dict], metrics=None,
                     device="cpu") -> Dict[str, Optional[float]]:
    """Each mode's critical path for one batch at the model's (batch size,
    fanouts), host work included (that is what is compared):

    - sync: the host fan-out sample and the payload's copy to the device;
    - pipelined: the copy of a payload sampled before (the sampling
      overlaps the step);
    - device: the device hop draw, the host dedup and remap, the copy;
    - fused: one dispatch of the on-device sample program
      (``sample/fused.fused_sample_subgraph``): on the card one replay of
      its CUDA graph, captured in the call left out of the score.
    """
    from neutronstarlite_torch.sample.pipeline import batch_arrays
    from neutronstarlite_torch.sample.sampler import Sampler

    device = torch.device(device)
    B, fans, caps, _ = _sample_caps(sample_cfg)
    v = int(host_graph.v_num)
    seed_ids = np.random.default_rng(seed).integers(0, v, size=min(B, v)).astype(np.int64)

    def put(b):
        return [torch.from_numpy(np.asarray(a)).to(device) for a in batch_arrays(b)]

    host = Sampler(host_graph, np.empty(0, np.int64), B, fans, rng=np.random.default_rng(seed))
    device_sampler = None
    out: Dict[str, Optional[float]] = {}
    for cand in candidates:
        label = cand.label()
        mode = _norm("sample_pipeline", cand.sample_pipeline) or "sync"
        if mode in ("device", "fused") and device_sampler is None:
            from neutronstarlite_torch.sample.device_sampler import DeviceUniformSampler

            device_sampler = DeviceUniformSampler.from_host(host_graph, device=device)
        if mode == "sync":
            out[label] = _warm(lambda s=host: put(s.sample_batch(seed_ids)), steps, device)
        elif mode == "pipelined":
            staged = host.sample_batch(seed_ids)
            out[label] = _warm(lambda b=staged: put(b), steps, device)
        elif mode == "device":
            dsam = Sampler(host_graph, np.empty(0, np.int64), B, fans,
                           rng=np.random.default_rng(seed), hop_sampler=device_sampler)
            out[label] = _warm(lambda s=dsam: put(s.sample_batch(seed_ids)), steps, device)
        elif mode == "fused":
            out[label] = _fused_leg(host_graph, device_sampler, seed_ids, B, caps, fans, steps,
                                    metrics, label, device)
        else:
            out[label] = None
    return out


def _fused_leg(host_graph, ds, seed_ids, B, caps, fans, steps, metrics, label, device) -> float:
    """The fused sample program's warm seconds per dispatch."""
    from neutronstarlite_torch.sample.fused import degree_tables, fused_sample_subgraph

    out_deg, in_deg = degree_tables(host_graph, device)
    seeds_pad = np.zeros((B,), np.int64)
    seeds_pad[:len(seed_ids)] = seed_ids
    seeds = _tensor(seeds_pad, device)
    n_real = torch.tensor(len(seed_ids), dtype=torch.int64, device=device)
    key = torch.zeros((), dtype=torch.int64, device=device)
    caps_t, fans_t = tuple(caps), tuple(fans)

    def program():
        return fused_sample_subgraph(ds.nbr, ds.eff_deg, out_deg, in_deg, seeds, n_real, key,
                                     caps_t, fans_t)

    _count_cost(metrics, label, program, device, (host_graph.e_num, host_graph.v_num))
    tick = [0]
    graph: List[Any] = []

    def run():
        tick[0] += 1
        key.fill_(tick[0])
        if device.type != "cuda":
            program()
        elif graph:
            graph[0].replay()
        else:
            # the first call (left out of the score) warms up on a side
            # stream, then captures the program
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                program()
            torch.cuda.current_stream(device).wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                program()
            graph.append(g)
            g.replay()

    return _warm(run, steps, device)


# ---- orchestration -------------------------------------------------------------


def _max_over_ranks(measured: Dict[str, Optional[float]], labels: List[str],
                    device) -> Dict[str, Optional[float]]:
    """Each label's seconds, the maximum over the joined ranks (the
    distributed step's time); every rank then holds the same scores."""
    if pmesh.world_size() <= 1:
        return measured
    vals = [measured.get(k) for k in labels]
    t = torch.tensor([-1.0 if s is None else float(s) for s in vals], dtype=torch.float64,
                     device=device)
    pmesh.ProcessGroup().max_(t)
    return {k: (None if v < 0 else float(v)) for k, v in zip(labels, t.tolist())}


def score_candidates(host_graph, P: int, sizes: List[int], family: str,
                     candidates: List[Candidate], simulate: bool,
                     emit: Optional[Callable[..., Any]] = None, measure: bool = True,
                     family_label: Optional[str] = None, metrics=None,
                     **leg_kwargs) -> List[Dict[str, Any]]:
    """The prior and (with ``measure``) the measured score of every
    candidate, in space order, as {candidate, seconds, predicted_bytes,
    source} rows, each also emitted as a ``tune_trial`` record; candidates
    the prior cut below the trial budget are ``source=pruned``. Without
    ``measure`` no device work runs and nothing is emitted."""
    priors = analytic_priors(
        host_graph, P, sizes, family, candidates,
        precision=leg_kwargs.pop("precision", "float32"),
        score_channels=leg_kwargs.get("score_channels", 1),
        eager_widths=leg_kwargs.pop("eager_widths", False),
        sample_cfg=leg_kwargs.get("sample_cfg"),
    )
    rows = [{"candidate": c.label(), "seconds": None, "predicted_bytes": priors[c.label()],
             "source": "prior"} for c in candidates]
    if not measure:
        return rows
    budget = max_trials()
    if len(candidates) > budget:
        keep = {r["candidate"] for r in sorted(rows, key=lambda r: r["predicted_bytes"])[:budget]}
        log.info("tune: prior pruned %d -> %d candidates (NTS_TUNE_MAX_TRIALS)",
                 len(candidates), budget)
    else:
        keep = {r["candidate"] for r in rows}
    kept = [c for c in candidates if c.label() in keep]
    measured = measure_candidates(host_graph, P, sizes, family, kept, simulate,
                                  metrics=metrics, **leg_kwargs)
    measured = _max_over_ranks(measured, [c.label() for c in kept],
                               leg_kwargs.get("device", "cpu"))
    for row in rows:
        secs = measured.get(row["candidate"])
        if secs is not None:
            row["seconds"] = float(secs)
            row["source"] = "measured"
        elif row["candidate"] not in keep:
            row["source"] = "pruned"
        if emit is not None:
            emit("tune_trial", family=family_label or family, candidate=row["candidate"],
                 source=row["source"], seconds=row["seconds"],
                 predicted_bytes=row["predicted_bytes"], partitions=int(P))
    return rows


def pick_best(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The least measured seconds; when nothing was measured, the least
    prior. A tie goes to the earlier row."""
    measured = [r for r in rows if r["seconds"] is not None]
    pool = measured or rows
    best = pool[0]
    for r in pool[1:]:
        key = "seconds" if measured else "predicted_bytes"
        if r[key] < best[key]:
            best = r
    return best
