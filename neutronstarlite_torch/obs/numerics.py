"""Numerics health plane: what is inside the tensors, as telemetry — port of
``neutronstarlite_tpu/obs/numerics.py``.

1. **Tensor-stat telemetry** (``NTS_NUMERICS=1``): the trainers run a stats
   variant of their step that is the default step plus ``step_stats``, a
   handful of reductions on the device per group (params / grads /
   activations per layer, the logits, the global gradient norm): integer
   counts (non-finite, zero, elements) and f32 absmax / rms. Nothing is
   fetched in the step; the host copies the stats in one transfer every
   ``NTS_NUMERICS_EVERY`` epochs (``fetch_stats``) and ``emit_stats``
   writes one typed ``tensor_stats`` record per group plus the
   ``numerics.*`` gauges, pinned into the flight recorder. With
   ``NTS_NUMERICS`` unset the default step runs, untouched.

2. **Non-finite provenance** (``capture_provenance``): when a guard trips
   ``nonfinite_loss`` / ``nonfinite_params``, a one-shot replay of the
   failing epoch's forward layer by layer (the trainer's
   ``numerics_replay``) names the first layer/op that produced a non-finite
   value in a typed ``nonfinite_provenance`` record. ``nan_loss@layer=k``
   (resilience/faults) arms a poison that ``poison_hook`` applies inside
   the replayed forward at layer k, so provenance must name layer k.

3. ``observe_serve_batch``: the serving engine's gauges over each executed
   request batch's logits (host numpy), and a ``tensor_stats`` record when
   a batch carries a non-finite logit.

4. ``nonfinite_leaf_names``: the key paths of the floating leaves of a tree
   that hold a NaN or an inf, in one reduction and one host fetch for the
   whole tree (the guards use it).

5. **Wire quantisation error** (``quant_rel_err``): the relative RMS error
   of shipping a payload at the ring's ``WIRE_DTYPE`` instead of f32. The
   stats step adds the layer-0 payload's group (``wire/l0``, stats at the
   wire dtype plus ``quant_rel_err``) on a narrowed wire, and
   ``NTS_QUANT_PROBE=1`` measures it once (the layer-0 payload is the
   feature matrix, the same every epoch) and re-emits the verdict each
   epoch (``emit_payload_stats``: a ``tensor_stats`` record and the
   ``wire.quant_rel_err`` gauge, which the reference's drift auditor holds
   against ``NTS_QUANT_TOL``).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neutronstarlite_torch.utils import tree as tree_util
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("obs")


# ---- knobs ------------------------------------------------------------------


def numerics_enabled() -> bool:
    """``NTS_NUMERICS=1`` arms the stats variant of the step; unset/0 runs
    the untouched default step."""
    return os.environ.get("NTS_NUMERICS", "0") == "1"


def numerics_every() -> int:
    """``NTS_NUMERICS_EVERY``: fetch/emit cadence in epochs (default 1;
    the stats are computed on the device every step either way — this
    gates only the small device->host copy)."""
    raw = os.environ.get("NTS_NUMERICS_EVERY", "")
    try:
        n = int(raw) if raw else 1
    except ValueError:
        log.warning("NTS_NUMERICS_EVERY=%r is not an int; using 1", raw)
        n = 1
    return max(n, 1)


def quant_probe_enabled() -> bool:
    """``NTS_QUANT_PROBE=1``: the per-epoch wire quantisation-error probe
    on a narrowed ring (one measurement, re-emitted each epoch)."""
    return os.environ.get("NTS_QUANT_PROBE", "0") == "1"


DEFAULT_QUANT_TOL = 0.01


def quant_tol() -> float:
    """``NTS_QUANT_TOL``: the measured wire quantisation error above which
    the drift auditor flags a bf16 decision (default 0.01, above bf16's
    ~4e-3 per-element RMS)."""
    raw = os.environ.get("NTS_QUANT_TOL", "")
    if not raw:
        return DEFAULT_QUANT_TOL
    try:
        return float(raw)
    except ValueError:
        log.warning("bad NTS_QUANT_TOL=%r; using %g", raw, DEFAULT_QUANT_TOL)
        return DEFAULT_QUANT_TOL


# ---- device-side stat reductions ----------------------------------------------
# Everything below this banner runs on the device inside the step and
# reads nothing back: the stats stay 0-dim device tensors until fetch_stats.


def _float_leaves(tree) -> List[torch.Tensor]:
    return [t.detach() for t in tree_util.leaves(tree)
            if torch.is_tensor(t) and t.is_floating_point()]


# per (device, leaf sizes, leaf -> group map): the group index of each leaf
# and each group's element count, as device tensors built once (a captured CUDA
# graph then reads them as static inputs: no host-to-device copy per step)
_layouts: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _layout(device, sizes: Tuple[int, ...], gids: Tuple[int, ...], n_groups: int):
    key = (str(device), sizes, gids, n_groups)
    got = _layouts.get(key)
    if got is None:
        per_group = [0] * n_groups
        for n, g in zip(sizes, gids):
            per_group[g] += n
        got = _layouts[key] = (
            torch.tensor(gids, dtype=torch.int64, device=device),
            torch.tensor(per_group, dtype=torch.float32, device=device),
        )
    return got


def _reduce(groups: List[Tuple[str, List[torch.Tensor]]]):
    """The stat reduce of every group at once: per leaf an int64 tally of
    its non-finite and its zero elements (one comparison and one sum each) and
    its f32 absmax and L2 norm (two multi-tensor ``_foreach_norm`` calls
    over all the leaves), then per group by one ``index_add_`` /
    ``scatter_reduce_`` each. A group that holds a NaN or an inf reports
    absmax and rms as NaN, as the reference's raw reductions do. Returns
    ({name: stats}, the groups' sums of squares)."""
    leaves = [t for _, ls in groups for t in ls]
    gids = tuple(i for i, (_, ls) in enumerate(groups) for _ in ls)
    sizes = tuple(t.numel() for t in leaves)
    dev = leaves[0].device
    gid, n_group = _layout(dev, sizes, gids, len(groups))
    l32 = [t.float() for t in leaves]
    # x * 0 is NaN exactly where x is NaN or infinite
    nonfinite = torch.stack([z.isnan().sum() for z in torch._foreach_mul(l32, 0.0)])
    zero = torch.stack([(t == 0).sum() for t in leaves])
    absmax = torch.stack(torch._foreach_norm(l32, float("inf")))
    sumsq = torch.stack(torch._foreach_norm(l32, 2)).square()
    g = len(groups)
    tallies = torch.zeros((2, g), dtype=torch.int64, device=dev).index_add_(
        1, gid, torch.stack([nonfinite, zero]))
    gmax = torch.zeros(g, dtype=torch.float32, device=dev).scatter_reduce_(
        0, gid, absmax, "amax", include_self=False)
    gsq = torch.zeros(g, dtype=torch.float32, device=dev).index_add_(0, gid, sumsq)
    bad = tallies[0] > 0
    gmax = torch.where(bad, float("nan"), gmax)
    rms = torch.where(bad, float("nan"), torch.sqrt(gsq / n_group))
    stats = {name: {"nonfinite_count": tallies[0, i], "zero_count": tallies[1, i],
                    "count": sum(t.numel() for t in ls), "absmax": gmax[i], "rms": rms[i]}
             for i, (name, ls) in enumerate(groups)}
    return stats, gsq


def group_stats(tree) -> Optional[Dict[str, Any]]:
    """The stat reduce over every floating leaf of ``tree`` (None when it
    has none): ``nonfinite_count`` and ``zero_count`` as exact int64
    tallies, ``count`` (a host int), ``absmax`` and ``rms`` in f32."""
    leaves = _float_leaves(tree)
    if not leaves:
        return None
    return _reduce([("g", leaves)])[0]["g"]


def grad_global_norm(grads) -> Optional[torch.Tensor]:
    """Global L2 norm over every floating grad leaf (f32 accumulate)."""
    leaves = _float_leaves(grads)
    if not leaves:
        return None
    return torch.stack(torch._foreach_norm([t.float() for t in leaves], 2)).square().sum().sqrt()


def quant_rel_err(x: torch.Tensor, wire_dtype: torch.dtype) -> torch.Tensor:
    """Relative RMS error of shipping ``x`` at ``wire_dtype`` instead of
    f32: ||cast(x) - x|| / ||x|| over all elements, in f32 (the casts round
    to nearest even both ways, so the host reproduces it exactly)."""
    x32 = x.detach().float()
    q = x32.to(wire_dtype).float()
    num = torch.sqrt(torch.mean(torch.square(q - x32)))
    den = torch.sqrt(torch.mean(torch.square(x32)))
    return num / torch.clamp(den, min=1e-30)


def _layered(tag: str, tree) -> List[Tuple[str, List[torch.Tensor]]]:
    """Per-layer (name, leaves) groups: a list/tuple (the per-layer params
    and grads convention) splits per index; anything else is one group."""
    if isinstance(tree, (list, tuple)):
        out = [(f"{tag}/l{i}", _float_leaves(sub)) for i, sub in enumerate(tree)]
        out = [(n, ls) for n, ls in out if ls]
        if out:
            return out
    leaves = _float_leaves(tree)
    return [(tag, leaves)] if leaves else []


def step_stats(params=None, grads=None, acts: Optional[Sequence[Any]] = None,
               logits=None, wire=None, wire_dtype=None) -> Dict[str, Any]:
    """The full per-step stat tree (device tensors): per-layer groups for
    params / grads / activations, the logits group and the global grad
    norm; with a narrowed wire (``wire_dtype``) the layer-0 payload
    ``wire`` at the wire dtype (``wire/l0``) with its ``quant_rel_err``.
    ``grads`` has the structure of ``params``."""
    groups = _layered("params", params) if params is not None else []
    first_grad = len(groups)
    grad_groups = _layered("grads", grads) if grads is not None else []
    groups += grad_groups
    for i, a in enumerate(acts or []):
        leaves = _float_leaves(a)
        if leaves:
            groups.append((f"acts/l{i}", leaves))
    if logits is not None and _float_leaves(logits):
        groups.append(("logits", _float_leaves(logits)))
    narrowed = wire is not None and wire_dtype is not None
    if narrowed:
        groups.append(("wire/l0", [wire.detach().to(wire_dtype)]))
    out: Dict[str, Any] = {"groups": {}}
    if not groups:
        return out
    out["groups"], gsq = _reduce(groups)
    if narrowed:
        out["groups"]["wire/l0"]["quant_rel_err"] = quant_rel_err(wire, wire_dtype)
    if grad_groups:  # one run of the group list
        out["grad_global_norm"] = gsq[first_grad:first_grad + len(grad_groups)].sum().sqrt()
    return out


def pack_stats(stats: Dict[str, Any]) -> Tuple[tuple, torch.Tensor]:
    """(layout, flat float64 device tensor) of a ``step_stats`` tree: the
    groups' (nonfinite_count, zero_count) pairs, then their (absmax, rms)
    pairs, then the grad norm, then the ``quant_rel_err`` of the groups
    that carry one. One tensor, so that the host fetch is one copy and a
    captured CUDA graph can write the stats into one static buffer;
    float64 holds the integer tallies exactly."""
    names = tuple(sorted(stats["groups"]))
    groups = [stats["groups"][n] for n in names]
    tallies = torch.stack([st[k] for st in groups for k in ("nonfinite_count", "zero_count")])
    values = [st[k] for st in groups for k in ("absmax", "rms")]
    has_norm = "grad_global_norm" in stats
    if has_norm:
        values.append(stats["grad_global_norm"])
    quant = tuple(n for n, st in zip(names, groups) if "quant_rel_err" in st)
    values += [stats["groups"][n]["quant_rel_err"] for n in quant]
    flat = torch.cat([tallies.double(), torch.stack(values).double()])
    return (names, tuple(int(st["count"]) for st in groups), has_norm, quant), flat


def unpack_stats(layout: tuple, values: Sequence[float]) -> Dict[str, Any]:
    """The host form of a packed stat tree (``pack_stats``'s inverse)."""
    names, counts, has_norm, quant = layout
    g = len(names)
    groups = {}
    for i, (name, n) in enumerate(zip(names, counts)):
        groups[name] = {
            "nonfinite_count": int(values[2 * i]), "zero_count": int(values[2 * i + 1]),
            "count": n, "absmax": float(values[2 * g + 2 * i]),
            "rms": float(values[2 * g + 2 * i + 1]),
        }
    out: Dict[str, Any] = {"groups": groups}
    if has_norm:
        out["grad_global_norm"] = float(values[4 * g])
    for i, name in enumerate(quant):
        groups[name]["quant_rel_err"] = float(values[4 * g + int(has_norm) + i])
    return out


def fetch_stats(stats) -> Dict[str, Any]:
    """Copy a device stat tree, or an already packed ``(layout, flat)``
    pair, to the host in one transfer."""
    layout, flat = stats if isinstance(stats, tuple) else pack_stats(stats)
    return unpack_stats(layout, flat.cpu().tolist())


# ---- host-side emission (copied) ----------------------------------------------


def _f(v) -> Optional[float]:
    """Host float, with non-finite collapsed to None (the JSONL records
    stay strict-JSON; finite_fraction already says when values went bad)."""
    if v is None:
        return None
    v = float(v)
    return v if math.isfinite(v) else None


def _stat_fields(st: Dict[str, Any]) -> Dict[str, Any]:
    # fractions from the exact integer tallies, divided host-side in
    # f64 — one NaN in 1.4e8 elements must read < 1.0, never 1.0
    n = max(int(st["count"]), 1)
    fields = {
        "finite_fraction": 1.0 - int(st["nonfinite_count"]) / n,
        "absmax": _f(st.get("absmax")),
        "rms": _f(st.get("rms")),
        "zero_fraction": int(st["zero_count"]) / n,
    }
    if "quant_rel_err" in st:
        fields["quant_rel_err"] = _f(st["quant_rel_err"])
    return fields


def emit_stats(metrics, stats: Dict[str, Any], epoch: int) -> List[dict]:
    """One ``tensor_stats`` record per group (a host ``fetch_stats``
    tree) + the ``numerics.*`` gauges, each record pinned into the flight
    recorder. Returns the emitted records."""
    if metrics is None or not stats:
        return []
    recs: List[dict] = []
    ff_min = None
    absmax_max = None
    for name, st in sorted((stats.get("groups") or {}).items()):
        fields = _stat_fields(st)
        rec = metrics.event("tensor_stats", name=name, epoch=int(epoch), **fields)
        recs.append(rec)
        _pin(metrics, f"tensor_stats/{name}", rec)
        ff = fields["finite_fraction"]
        ff_min = ff if ff_min is None else min(ff_min, ff)
        am = fields["absmax"]
        if am is not None:
            absmax_max = am if absmax_max is None else max(absmax_max, am)
        if fields.get("quant_rel_err") is not None:
            metrics.gauge_set("wire.quant_rel_err", fields["quant_rel_err"])
    if ff_min is not None:
        metrics.gauge_set("numerics.finite_fraction_min", ff_min)
    if absmax_max is not None:
        metrics.gauge_set("numerics.absmax_max", absmax_max)
    gn = _f(stats.get("grad_global_norm"))
    if gn is not None:
        metrics.gauge_set("numerics.grad_global_norm", gn)
        # the norm rides its own field; absmax/rms stay null
        rec = metrics.event(
            "tensor_stats", name="grads/global", epoch=int(epoch),
            finite_fraction=1.0,
            absmax=None, rms=None, zero_fraction=0.0, grad_global_norm=gn,
        )
        recs.append(rec)
        _pin(metrics, "tensor_stats/grads/global", rec)
    elif "grad_global_norm" in stats:
        # a NaN/inf grad norm: keep the gauge numeric-free but say so
        metrics.gauge_set("numerics.grad_global_norm_finite", 0)
    return recs


def emit_payload_stats(metrics, stats: Dict[str, Any], epoch: int,
                       name: str = "wire.payload/l0") -> Optional[dict]:
    """One probe ``tensor_stats`` record for a ring payload (host stats,
    ``NTS_QUANT_PROBE``'s per-epoch leg) and the ``wire.quant_rel_err``
    gauge."""
    if metrics is None or not stats:
        return None
    fields = _stat_fields(stats)
    rec = metrics.event("tensor_stats", name=name, epoch=int(epoch), **fields)
    _pin(metrics, f"tensor_stats/{name}", rec)
    if fields.get("quant_rel_err") is not None:
        metrics.gauge_set("wire.quant_rel_err", fields["quant_rel_err"])
    return rec


def _pin(metrics, key: str, rec: dict) -> None:
    flight = getattr(metrics, "flight", None)
    if flight is not None:
        flight.pin(key, rec)


def observe_serve_batch(metrics, logits: np.ndarray, bucket: int) -> None:
    """Engine-side numerics on one executed request batch (host numpy —
    the logits are already fetched for the reply, so this costs no extra
    device sync): the finite-fraction/absmax gauges always, a LOUD
    ``tensor_stats`` record only when a batch actually carries a
    non-finite logit."""
    if metrics is None:
        return
    try:
        arr = np.asarray(logits, dtype=np.float32)
        n = arr.size or 1
        finite = float(np.isfinite(arr).sum()) / n
        with np.errstate(invalid="ignore"):
            absmax = float(np.max(np.abs(arr))) if arr.size else 0.0
        metrics.gauge_set("numerics.serve_logits_finite_fraction", finite)
        if math.isfinite(absmax):
            metrics.gauge_set("numerics.serve_logits_absmax", absmax)
        if finite < 1.0:
            metrics.counter_add("numerics.serve_nonfinite_batches")
            rec = metrics.event(
                "tensor_stats", name=f"serve/logits/bucket_{int(bucket)}",
                finite_fraction=finite,
                absmax=absmax if math.isfinite(absmax) else None,
                rms=None,
                zero_fraction=float((arr == 0).sum()) / n,
            )
            _pin(metrics, "tensor_stats/serve/logits", rec)
    except Exception as e:  # telemetry must never fail a reply
        log.warning("serve batch numerics failed: %s", e)


# ---- batched non-finite leaf check --------------------------------------------


def nonfinite_leaf_names(tree) -> List[str]:
    """Key paths (``jax.tree_util.keystr`` form) of the floating tensors of
    ``tree`` that hold a NaN or an inf. ``0 * x`` is NaN exactly where x is
    not finite, so the norms of the zeroed leaves (one multi-tensor op
    each) flag them; the flags reach the host in one copy."""
    named = [(p, t) for p, t in tree_util.flatten_with_path(tree)
             if torch.is_tensor(t) and t.is_floating_point()]
    if not named:
        return []
    tensors = [t.detach() for _, t in named]
    flags = torch.stack(torch._foreach_norm(torch._foreach_mul(tensors, 0.0))).isnan()
    return [p for (p, _), bad in zip(named, flags.cpu().tolist()) if bad]


# ---- non-finite provenance ------------------------------------------------------


def poison_hook(h: torch.Tensor, layer: int) -> torch.Tensor:
    """The chaos seam of the provenance replay: multiplies the layer's
    activation by NaN when a ``nan_loss@layer=k`` fault armed a pending
    poison for this layer (resilience/faults); identity otherwise."""
    from neutronstarlite_torch.resilience import faults

    if faults.pending_layer_poison() == layer:
        log.warning("provenance replay: applying injected nan_loss poison at layer %d",
                    layer)
        return h * float("nan")
    return h


def _finite_fraction_host(t: torch.Tensor) -> float:
    t = t.detach()
    return float(torch.isfinite(t).sum()) / (t.numel() or 1)


def capture_provenance(toolkit, epoch: Optional[int], fault_kind: str) -> Optional[dict]:
    """The guard->provenance handoff (resilience/guards calls this right
    before raising a non-finite HealthError): one-shot per toolkit — walk
    the parameters layer by layer, then replay the failing epoch's forward
    through the trainer's ``numerics_replay`` hook, and emit a typed
    ``nonfinite_provenance`` record naming the first layer/op that produced
    a non-finite value. An error in the replay raises (it runs the model's
    own forward and kernels); the pending poison is consumed either way.
    Returns the record (or None)."""
    from neutronstarlite_torch.resilience import faults

    metrics = getattr(toolkit, "metrics", None)
    if metrics is None or getattr(toolkit, "_nonfinite_replayed", False):
        # the early exits still consume a pending poison: a stale
        # process-global poison would falsely mark the next organic
        # fault's replay as injected (and poison its layer)
        faults.clear_layer_poison()
        return None
    toolkit._nonfinite_replayed = True
    injected = faults.pending_layer_poison() is not None
    layer = op = name = None
    frac: Optional[float] = None
    checked = 0
    try:
        # params first, without the replay: a poisoned weight layer is
        # attributable from the leaves alone, and the replay only runs
        # when the params walk comes back clean
        params = getattr(toolkit, "params", None)
        param_entries: List[Tuple[Optional[int], str, str, Any]] = []
        if isinstance(params, (list, tuple)):
            for i, sub in enumerate(params):
                param_entries.append((i, "params", f"params/l{i}", sub))
        elif params is not None:
            param_entries.append((None, "params", "params", params))
        for lyr, op_name, label, value in param_entries:
            checked += 1
            if nonfinite_leaf_names(value):
                layer, op, name = lyr, op_name, label
                break
        if op is None:
            replay = None
            replay_fn = getattr(toolkit, "numerics_replay", None)
            if replay_fn is not None:
                replay = replay_fn(epoch if epoch is not None else 0)
            if replay is None:
                log.warning(
                    "non-finite provenance: trainer %s has no replay hook; "
                    "emitting an unattributed record", type(toolkit).__name__,
                )
            for lyr, op_name, label, value in (replay or []):
                checked += 1
                f = _finite_fraction_host(value)
                if f < 1.0:
                    layer, op, name, frac = lyr, op_name, label, f
                    break
    finally:
        faults.clear_layer_poison()
    rec = metrics.event(
        "nonfinite_provenance",
        fault_kind=fault_kind,
        epoch=int(epoch) if epoch is not None else None,
        layer=int(layer) if layer is not None else None,
        op=op,
        name=name,
        finite_fraction=frac,
        checked=checked,
        injected=bool(injected),
    )
    _pin(metrics, "nonfinite_provenance", rec)
    if layer is not None or op is not None:
        log.warning(
            "non-finite provenance: %s bisected to %s (layer %s, finite_fraction=%s) "
            "after %d checks", fault_kind, name, layer, frac, checked,
        )
    return rec
