"""Does this cfg fit one H100? — the port's counterpart of
``neutronstarlite_tpu/tools/aot_check.py``, answered without running a
step on the card.

The JAX tool compiled the cfg's train step for a TPU topology and read
XLA's memory analysis. The card has no ahead-of-time compiler to ask, so
this tool builds what a run would put on the card, on the CPU, and counts:

- **static**: the host graph and the route's tables are built as the
  trainer builds them (on the CPU device), and every tensor the trainer
  then holds is counted by its ``nbytes``, once per storage: the tables,
  features, labels, masks, parameters and the Adam state;
- **kernel caches**: the ELL kernel's work lists and the bsp kernel's
  piece lists, one per width the epoch aggregates at, which the kernels
  build at their first launch and keep (``ops/ell_kernel.work_list``,
  ``BspEll.pieces``);
- **transient**: one training step and one eval forward run on the CPU with
  each aggregation replaced by a stand-in that allocates what the card's
  kernel allocates (its output, and its scratch for as long as it runs:
  bsp's f32 accumulation buffer [V, round_up(f, 4)], the ELL split rows'
  f32 scratch), while a dispatch mode counts the live bytes of every tensor
  made in the step; the highest count is the step's transient.

The step's own peak is static + caches + transient. A process on the card
also holds the cuBLAS and cuBLASLt workspaces from its first matmul (32 MiB
each, PyTorch's default on sm_90, allocated through the caching allocator);
``peak_bytes`` adds them, and the cfg fits when that is below the card's
memory (``torch.cuda.get_device_properties`` on a card,
else ``--memory-gib``, else the H100 SXM data sheet's 80 GB). Every launch
is also held to the kernels' limits: each value passed to a C entry point
as ``int`` below 2^31, each grid within 2^31 - 1 CTAs, a bsp row's slots
within the kernel's registers, and shared memory per block within the
card's (both kernels declare none; on a card the occupancy API's count is
read). The kernels' geometry is the built kernel's on a card, else the
constants its source declares.

Cases: full-batch single-device trainers (every route); one rank of a
P-rank run for every distributed family (``GCNDIST`` and its eager, GIN
and CommNet kin on every exchange, ``GATDIST``, ``GGCNDIST``): the rank
with the most in-edges is built alone on the CPU through a
:class:`DryRank` group, whose collectives allocate what the real ones do,
and counted as above (a test holds it equal to a real gloo rank's count);
``GCNSAMPLE*`` (the features on the card and one batch at the sampler's
capacities). The 2D mesh (``MESH:Pv,Pf``) is not modelled and refuses.

Usage: python -m neutronstarlite_torch.tools.aot_check <file.cfg>
         [--synthetic-scale S] [--memory-gib G]
Prints ONE JSON line; exits 0 when the step fits and every limit holds,
1 when not, 2 on a refused case.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
import weakref
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

INT_MAX = 2 ** 31 - 1
# cuBLAS + cuBLASLt workspaces, 32 MiB each on sm_90 (PyTorch's default)
LIBRARY_WORKSPACE = 2 * 32 * 2 ** 20
PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- the kernels' geometry ----------------------------------------------

def _source_constants(name: str) -> Dict[str, int]:
    """``constexpr int`` values declared in ``csrc/<name>.cu`` (products of
    earlier constants and literals evaluated)."""
    with open(os.path.join(PKG, "csrc", f"{name}.cu")) as fh:
        src = fh.read()
    out: Dict[str, int] = {}
    for key, expr in re.findall(r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);", src):
        expr = re.sub(r"//.*", "", expr).strip()
        if re.fullmatch(r"[\w\s*+()-]+", expr):
            try:
                out[key] = int(eval(expr, {"__builtins__": {}}, dict(out)))
            except Exception:  # an expression of names this parser skips
                continue
    return out


def kernel_geometry() -> Dict[str, Dict[str, int]]:
    """The two kernels' launch geometry: the built kernels' exports on a
    card, else the constants of their sources (``source`` says which)."""
    if torch.cuda.is_available():
        from neutronstarlite_torch.ops import _build, bsp_ell, ell_kernel

        eg, bg = ell_kernel.geometry(), bsp_ell.geometry()
        return {
            "ell_level": {"cols": _build.kernel_cols("ell_level"), "max_cap": eg.max_cap,
                          "min_cap": eg.min_cap, "target_warps": eg.target_warps,
                          "warps_per_cta": eg.warps_per_cta, "source": "built"},
            "bsp_ell": {"cols": _build.kernel_cols("bsp_ell"), "max_k": bg.max_k,
                        "target_ctas": bg.target_ctas,
                        "min_piece_blocks": bg.min_piece_blocks, "source": "built"},
        }
    e, b = _source_constants("ell_level"), _source_constants("bsp_ell")
    return {
        "ell_level": {"cols": e["kChunk"], "max_cap": e["kMaxCap"], "min_cap": e["kMinCap"],
                      "target_warps": e["kTargetWarps"], "warps_per_cta": e["kWarps"],
                      "source": "csrc/ell_level.cu"},
        "bsp_ell": {"cols": b["kCols"], "max_k": b["kMaxK"], "target_ctas": b["kTargetCtas"],
                    "min_piece_blocks": b["kMinPieceBlocks"], "source": "csrc/bsp_ell.cu"},
    }


def shared_bytes(kernel: str, dtype: torch.dtype, f: int) -> int:
    """Shared memory per CTA: the occupancy API's on a card; neither kernel
    declares any (no ``__shared__`` in its source), so 0 without one."""
    if torch.cuda.is_available():
        from neutronstarlite_torch.ops import bsp_ell, ell_kernel

        mod = ell_kernel if kernel == "ell_level" else bsp_ell
        return int(mod.occupancy(dtype, f)["smem_bytes"])
    return 0


# ---- limits ---------------------------------------------------------------

def limit(name: str, value: int, bound: int = INT_MAX) -> Dict[str, object]:
    return {"name": name, "value": int(value), "limit": int(bound),
            "ok": 0 <= int(value) <= int(bound)}


def int_checks(prefix: str, values: Dict[str, int]) -> List[Dict[str, object]]:
    """One check per value an ``int`` carries: at or above 2^31 is refused."""
    return [limit(f"{prefix}.{k}", v) for k, v in values.items()]


def ell_launch_checks(tag: str, buckets, f: int, dtype, geo, smem_limit: int):
    """The ELL launch at width f over ``buckets``: its ints, grids, shared
    memory; returns (checks, cache bytes, scratch bytes)."""
    from neutronstarlite_torch.ops.ell_kernel import ell_work

    g = geo["ell_level"]
    w = ell_work([d.numpy() for d in buckets.deg], [r.numpy() for r in buckets.rows_vertex],
                 f, g["cols"], g["target_warps"], g["min_cap"], g["max_cap"])
    chunks = -(-f // g["cols"])
    ctas = -(-w.n_items * chunks // g["warps_per_cta"])
    checks = int_checks(tag, {"n_items": w.n_items, "n_split": w.n_split, "f": f,
                              "max_target": buckets.v_num, "n_pieces": w.n_pieces})
    checks.append(limit(f"{tag}.grid_ctas", ctas))
    checks.append(limit(f"{tag}.smem_per_block", shared_bytes("ell_level", dtype, f),
                        smem_limit))
    cache = (w.items.nbytes + w.split_ptr.nbytes + w.split_out.nbytes
             + len(buckets.nbr) * 3 * 8)
    return checks, cache, w.n_pieces * f * 4


def bsp_launch_checks(tag: str, t, f: int, dtype, geo, smem_limit: int):
    """The bsp launch at width f over tables ``t``."""
    from neutronstarlite_torch.ops.bsp_ell import bsp_pieces

    g = geo["bsp_ell"]
    pieces = bsp_pieces(t.tile_ptr.numpy(), f, g["cols"], g["target_ctas"],
                        g["min_piece_blocks"])
    n_pieces = len(pieces) - 1
    b, k, r = t.nbr.shape
    checks = int_checks(tag, {
        "n_pieces": n_pieces, "t_src": t.t_src, "dt": t.dt, "vt": t.vt, "K": k, "R": r,
        "n_src": t.n_src, "v_num": t.v_num, "f": f,
        "blk_key_max": t.t_dst * t.t_src - 1, "piece_ptr_max": b,
        "src_base_max": (t.t_src - 1) * t.vt, "dst_base_max": (t.t_dst - 1) * t.dt,
    })
    checks.append(limit(f"{tag}.grid_ctas", -(-f // g["cols"]) * n_pieces))
    checks.append(limit(f"{tag}.K_in_registers", k, g["max_k"]))
    checks.append(limit(f"{tag}.smem_per_block", shared_bytes("bsp_ell", dtype, f), smem_limit))
    return checks, pieces.nbytes, t.v_num * (-(-f // 4) * 4) * 4


# ---- bytes ----------------------------------------------------------------

def tensors_in(obj, seen=None, objects: bool = False) -> Iterable[torch.Tensor]:
    """Every tensor reachable from ``obj`` through dataclasses, lists,
    tuples and dicts (the kernels' lazy caches, the ``_`` fields, excluded);
    with ``objects``, through the attributes of other objects too (the
    distributed exchanges hold their tables so)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if torch.is_tensor(obj):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for fld in dataclasses.fields(obj):
            if fld.name.startswith("_"):
                continue
            yield from tensors_in(getattr(obj, fld.name), seen, objects)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors_in(v, seen, objects)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors_in(v, seen, objects)
    elif objects and hasattr(obj, "__dict__") and not callable(obj):
        for k, v in vars(obj).items():
            if not k.startswith("_"):
                yield from tensors_in(v, seen, objects)


def storage_bytes(tensors: Iterable[torch.Tensor], seen: Optional[set] = None) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen = set() if seen is None else seen
    total = 0
    for t in tensors:
        s = t.untyped_storage()
        key = (s.data_ptr(), s.nbytes())
        if key not in seen and s.nbytes():
            seen.add(key)
            total += s.nbytes()
    return total


def static_bytes(tr) -> Dict[str, int]:
    """The device bytes a built full-batch trainer holds, by category."""
    seen: set = set()
    out = {"tables": storage_bytes(tensors_in(tr.compute_graph), seen)}
    for name in ("feature", "label", "mask", "train01"):
        out[name] = storage_bytes(tensors_in(getattr(tr, name, None)), seen)
    out["params"] = storage_bytes(tensors_in(tr.params), seen)
    out["adam"] = storage_bytes(tensors_in([tr.opt_state.m, tr.opt_state.v]), seen)
    return out


class LiveBytes(TorchDispatchMode):
    """Counts the live bytes of the tensors made while it is active (per
    storage, released when the storage's last tensor is freed) and keeps
    the highest count."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, List[int]] = {}

    def _release(self, key: int) -> None:
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._refs[key]

    def note(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s.data_ptr()
        if not s.nbytes():
            return
        entry = self._refs.get(key)
        if entry is None:
            entry = self._refs[key] = [s.nbytes(), 0]
            self.live += s.nbytes()
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if torch.is_tensor(t):
                self.note(t)
        return out


def _stand_ins(scratch: Dict[str, Dict[int, int]]):
    """Aggregation stand-ins: the card kernel's output and, while it runs,
    its scratch (``scratch[kernel][f]`` bytes)."""
    def run(kernel, v_num, x):
        f = x.shape[1]
        out = torch.zeros((v_num, f), dtype=x.dtype)
        tmp = torch.empty(scratch[kernel].get(f, 0) // 4, dtype=torch.float32)
        del tmp
        return out

    def ell(buckets, x, weights=None):
        return run("ell_level", buckets.v_num, x)

    def bsp(t, x):
        return run("bsp_ell", t.v_num, x)

    def scatter(src, dst, w, x, v_num):
        # the gathered, weighted [E, f] rows index_add_ consumes
        rows = torch.empty((len(src), x.shape[1]), dtype=x.dtype)
        del rows
        return torch.zeros((v_num, x.shape[1]), dtype=x.dtype)

    return ell, bsp, scatter


def transient_bytes(tr, scratch: Dict[str, Dict[int, int]]) -> int:
    """The highest live bytes of one training step and one eval forward on
    the CPU, aggregations replaced by stand-ins."""
    from neutronstarlite_torch.ops import aggregate, bsp_ell, ell_kernel

    counter = LiveBytes()
    ell, bsp, scatter = _stand_ins(scratch)
    saved = (ell_kernel.ell_level_aggregate, bsp_ell.bsp_aggregate,
             aggregate.scatter_accumulate)
    # a distributed exchange holds its kernel
    cg = tr.compute_graph
    held = getattr(cg, "kernel", None)
    ell_kernel.ell_level_aggregate, bsp_ell.bsp_aggregate = ell, bsp
    aggregate.scatter_accumulate = scatter
    if held is not None:
        cg.kernel = {saved[0]: ell, saved[1]: bsp}.get(held, held)
    try:
        with counter:
            tr.train_step()
            tr.eval_logits()
    finally:
        (ell_kernel.ell_level_aggregate, bsp_ell.bsp_aggregate,
         aggregate.scatter_accumulate) = saved
        if held is not None:
            cg.kernel = held
    return counter.peak


# ---- cases ----------------------------------------------------------------

def aggregation_widths(tr) -> List[int]:
    """The widths one epoch aggregates at, forward then backward
    (``roofline.aggregation_calls`` at the cfg's layers)."""
    from neutronstarlite_torch.tools.roofline import aggregation_calls

    order = "eager" if getattr(tr, "eager", False) else "standard"
    return aggregation_calls(order, tr.cfg.layer_sizes())


def full_batch_case(tr, geo, smem_limit: int) -> Dict[str, object]:
    """static + caches + transient of a built full-batch trainer, and every
    launch's checks."""
    from neutronstarlite_torch.ops.bsp_ell import BspEllPair
    from neutronstarlite_torch.ops.ell import EllPair

    static = static_bytes(tr)
    cg = tr.compute_graph
    dtype = torch.bfloat16 if tr.cfg.precision == "bfloat16" else torch.float32
    checks: List[Dict[str, object]] = []
    cache = 0
    scratch: Dict[str, Dict[int, int]] = {"ell_level": {}, "bsp_ell": {}}
    widths = aggregation_widths(tr)
    n_fwd = len(tr.cfg.layer_sizes()) - 1
    seen_cache = set()
    for i, f in enumerate(widths):
        direction = "fwd" if i < n_fwd else "bwd"
        tables = getattr(cg, direction, None)
        tag = f"{direction}[{i}].f{f}"
        if isinstance(cg, EllPair):
            c, cb, sb = ell_launch_checks(f"ell_level.{tag}", tables, f, dtype, geo, smem_limit)
            scratch["ell_level"][f] = max(scratch["ell_level"].get(f, 0), sb)
            chunk_key = (direction, -(-f // geo["ell_level"]["cols"]))
        elif isinstance(cg, BspEllPair):
            c, cb, sb = bsp_launch_checks(f"bsp_ell.{tag}", tables, f, dtype, geo, smem_limit)
            scratch["bsp_ell"][f] = max(scratch["bsp_ell"].get(f, 0), sb)
            chunk_key = (direction, -(-f // geo["bsp_ell"]["cols"]))
        else:
            continue
        checks += c
        if chunk_key not in seen_cache:
            seen_cache.add(chunk_key)
            cache += cb
    transient = transient_bytes(tr, scratch)
    own = sum(static.values()) + cache + transient
    return {"static": static, "static_bytes": sum(static.values()), "kernel_cache": cache,
            "transient": transient, "step_peak_bytes": own,
            "library_workspace": LIBRARY_WORKSPACE, "peak_bytes": own + LIBRARY_WORKSPACE,
            "checks": checks, "aggregation_widths": widths}


def build_trainer(cfg, base_dir: Optional[str], synthetic_scale: float = 0.0, seed: int = 0):
    """The cfg's trainer, built on the CPU (host graph, tables, datum,
    parameters); ``synthetic_scale`` > 0 replaces the cfg's files by the
    bench graph's generator at that scale of Reddit (random features)."""
    from neutronstarlite_torch.models import get_algorithm

    cls = get_algorithm(cfg.algorithm)
    if synthetic_scale > 0:
        from neutronstarlite_torch.graph.dataset import GNNDatum
        from neutronstarlite_torch.graph.synthetic import reddit_scaled, synthetic_power_law_graph

        v, e = reddit_scaled(synthetic_scale)
        src, dst = synthetic_power_law_graph(v, e, seed=seed)
        cfg.vertices = v
        f0, classes = cfg.layer_sizes()[0], cfg.layer_sizes()[-1]
        rng = np.random.default_rng(seed)
        datum = GNNDatum(
            feature=rng.standard_normal((v, f0), dtype=np.float32) * 0.1,
            label=rng.integers(0, classes, size=v, dtype=np.int32),
            mask=(np.arange(v) % 3).astype(np.int32),
        )
        return cls.from_arrays(cfg, src, dst, datum, seed=seed, device="cpu")
    tr = cls(cfg, base_dir=base_dir, seed=seed, device="cpu")
    tr.init_graph()
    tr.init_nn()
    return tr


def check(cfg, base_dir: Optional[str] = None, synthetic_scale: float = 0.0,
          memory_bytes: Optional[float] = None, trainer=None) -> Dict[str, object]:
    """The report for one cfg (or a trainer already built on the CPU)."""
    from neutronstarlite_torch.tools.roofline import device_limits

    t0 = time.perf_counter()
    limits = device_limits()
    hbm = float(memory_bytes if memory_bytes else limits["hbm_bytes"])
    alg = cfg.algorithm.upper()
    geo = kernel_geometry()
    smem = int(limits["smem_per_block"])
    out: Dict[str, object] = {"cfg_algorithm": cfg.algorithm, "memory_bytes": hbm,
                              "memory_source": limits["source"] if not memory_bytes
                              else "--memory-gib", "geometry_source":
                              geo["ell_level"]["source"]}
    if "SAMPLE" in alg:
        out.update(case="sampled", **sampled_case(cfg, base_dir, synthetic_scale, trainer))
    elif "DIST" in alg:
        out.update(case="dist", **dist_case(cfg, base_dir, synthetic_scale, geo, smem))
    else:
        tr = trainer or build_trainer(cfg, base_dir, synthetic_scale)
        out.update(case="single_device", v_num=tr.host_graph.v_num,
                   e_num=tr.host_graph.e_num, route=type(tr.compute_graph).__name__,
                   **full_batch_case(tr, geo, smem))
    fails = [c for c in out.get("checks", []) if not c["ok"]]
    out["refused"] = [c["name"] for c in fails]
    out["fits"] = bool(out["peak_bytes"] <= hbm and not fails)
    out["peak_gib"] = out["peak_bytes"] / 2 ** 30
    out["check_s"] = time.perf_counter() - t0
    return out


def sampled_case(cfg, base_dir, synthetic_scale, trainer=None) -> Dict[str, object]:
    """The sampled trainer: features, labels and masks on the card, the
    parameters and Adam state, and one batch at the sampler's capacities
    (node ids, edge lists, gathered features, activations)."""
    tr = trainer or build_trainer(cfg, base_dir, synthetic_scale)
    seen: set = set()
    static = {n: storage_bytes(tensors_in(getattr(tr, n, None)), seen)
              for n in ("feature", "label", "mask")}
    static["params"] = storage_bytes(tensors_in(tr.params), seen)
    static["adam"] = storage_bytes(tensors_in([tr.opt_state.m, tr.opt_state.v]), seen)
    caps, fans, sizes = tr.node_caps, tr.fanouts, cfg.layer_sizes()
    b = 2 if cfg.precision == "bfloat16" else 4
    batch = sum(c * 8 for c in caps)  # node ids
    batch += sum(caps[h + 1] * fans[h] * (8 + 8 + 4) for h in range(len(fans)))  # edges
    batch += caps[0] * sizes[0] * (4 + b)  # gathered rows and their cast
    acts = sum(caps[i + 1] * (sizes[i] + sizes[i + 1]) * 4 * 3 for i in range(len(sizes) - 1))
    own = sum(static.values()) + batch + acts
    return {"static": static, "static_bytes": sum(static.values()), "batch_bytes": batch,
            "transient": acts, "step_peak_bytes": own, "library_workspace": LIBRARY_WORKSPACE,
            "peak_bytes": own + LIBRARY_WORKSPACE, "node_caps": list(caps), "checks": []}


class DryRank:
    """One rank of a P-rank process group, without the others: the
    collectives allocate what the real ones allocate (``mesh.ProcessGroup``:
    all_gather's P receive buffers and their concatenation, the all-reduce's
    copy, the ring hop's receive buffer) and carry no data. A trainer built
    with it holds one rank's tables and rows, so a dry step counts that
    rank's bytes."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world
        self.ranks = list(range(world))
        self.pg, self.backend = None, "dry"

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.empty_like(x) for _ in range(self.world)])

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t.clone()

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        return t

    max_ = broadcast_ = sum_

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return torch.empty_like(x)

    def shift_start(self, t: torch.Tensor, step: int):
        from neutronstarlite_torch.parallel.mesh import Hop

        return Hop(torch.empty_like(t), [], t)

    @staticmethod
    def shift_wait(hop) -> torch.Tensor:
        hop.sent = None
        return hop.out


def rank_bytes(tr, geo, smem):
    """One rank's bytes of a built distributed trainer, counted as the
    full-batch case counts them: (static by category, kernel caches,
    transient, launch checks, route)."""
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate

    cg, cfg = tr.compute_graph, tr.cfg
    rank = tr.group.rank
    seen: set = set()
    static = {"tables": storage_bytes(tensors_in(cg, objects=True), seen)}
    for name in ("feature", "label", "valid", "train01", "mask"):
        static[name] = storage_bytes(tensors_in(getattr(tr, name, None)), seen)
    static["params"] = storage_bytes(tensors_in(tr.params), seen)
    static["adam"] = storage_bytes(tensors_in([tr.opt_state.m, tr.opt_state.v]), seen)
    dtype = torch.bfloat16 if cfg.precision == "bfloat16" else torch.float32
    route = {ell_level_aggregate: "ell_level", bsp_aggregate: "bsp_ell"}.get(
        getattr(cg, "kernel", None))
    checks: List[Dict[str, object]] = []
    cache = 0
    scratch: Dict[str, Dict[int, int]] = {"ell_level": {}, "bsp_ell": {}}
    if route is not None:
        n_fwd = len(cfg.layer_sizes()) - 1
        seen_cache = set()
        for i, f in enumerate(aggregation_widths(tr)):
            direction = "fwd" if i < n_fwd else "bwd"
            t = getattr(cg.tables, direction)[rank]
            launch = ell_launch_checks if route == "ell_level" else bsp_launch_checks
            c, cb, sb = launch(f"{route}.{direction}[{i}].rank{rank}.f{f}", t, f, dtype,
                               geo, smem)
            checks += c
            scratch[route][f] = max(scratch[route].get(f, 0), sb)
            key = (direction, -(-f // geo[route]["cols"]))
            if key not in seen_cache:
                seen_cache.add(key)
                cache += cb
    transient = transient_bytes(tr, scratch)
    return static, cache, transient, checks, route or type(cg).__name__


def dist_case(cfg, base_dir, synthetic_scale, geo, smem) -> Dict[str, object]:
    """One rank of a P-rank distributed run (every ``*DIST`` family): the
    trainer is built on the CPU as the rank with the most in-edges builds
    it (its own shard's tables and rows, the replicated parameters and Adam
    state), through a :class:`DryRank` group; its bytes are counted as the
    full-batch case counts them, and a dry step gives the transient (the
    gathered slab, the exchanges' buffers, the activations; the kernels
    stood in by their card allocations)."""
    from neutronstarlite_torch.graph.storage import partition_offsets
    from neutronstarlite_torch.parallel import mesh

    if cfg.mesh not in ("", "auto"):
        raise NotImplementedError(f"MESH:{cfg.mesh}: the 2D mesh is not modelled")
    p = int(cfg.partitions or 2)
    if synthetic_scale > 0:
        from neutronstarlite_torch.graph.synthetic import reddit_scaled, synthetic_power_law_graph

        v, e = reddit_scaled(synthetic_scale)
        dst = synthetic_power_law_graph(v, e, seed=0)[1]
    else:
        from neutronstarlite_torch.graph.storage import load_edges

        v, dst = cfg.vertices, load_edges(cfg.resolve_path(cfg.edge_file, base_dir))[1]
    in_degree = np.bincount(dst, minlength=v)
    # the shards' in-edges, with the trainers' partition map
    offs = partition_offsets(v, in_degree, p)
    cum = np.concatenate([[0], np.cumsum(in_degree)])
    edges = cum[offs[1:]] - cum[offs[:-1]]
    rank = int(np.argmax(edges))
    saved = (mesh.resolve_group, os.environ.pop("NTS_DIST_SIMULATE", None))
    mesh.resolve_group = lambda partitions, simulate: (DryRank(rank, p), p)
    try:
        tr = build_trainer(cfg, base_dir, synthetic_scale)
    finally:
        mesh.resolve_group = saved[0]
        if saved[1] is not None:
            os.environ["NTS_DIST_SIMULATE"] = saved[1]
    static, cache, transient, checks, route = rank_bytes(tr, geo, smem)
    own = sum(static.values()) + cache + transient
    return {"partitions": p, "vp": int(tr.dist.vp), "rank": rank,
            "rank_in_edges": [int(x) for x in edges], "comm_layer": tr.comm_layer,
            "route": route, "static": static,
            "static_bytes": sum(static.values()), "kernel_cache": cache,
            "transient": transient, "step_peak_bytes": own,
            "library_workspace": LIBRARY_WORKSPACE, "peak_bytes": own + LIBRARY_WORKSPACE,
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cfg")
    ap.add_argument("--synthetic-scale", type=float, default=0.0,
                    help="replace the cfg's data by the bench graph at this scale")
    ap.add_argument("--memory-gib", type=float, default=None,
                    help="the card's memory when there is no card (default: 80 GB)")
    args = ap.parse_args(argv)
    from neutronstarlite_torch.utils.config import InputInfo

    cfg = InputInfo.read_from_cfg_file(args.cfg)
    try:
        out = check(cfg, os.path.dirname(os.path.abspath(args.cfg)), args.synthetic_scale,
                    args.memory_gib * 2 ** 30 if args.memory_gib else None)
    except NotImplementedError as e:
        print(json.dumps({"cfg": args.cfg, "refused": str(e)}))
        return 2
    out["cfg"] = args.cfg
    print(json.dumps(out))
    return 0 if out["fits"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
