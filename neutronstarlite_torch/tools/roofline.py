"""The least time one full-batch GCN epoch can take on one H100, and how far
a measured epoch is from it — the port's counterpart of
``neutronstarlite_tpu/tools/roofline.py``.

The JAX tool priced the epoch against a TPU: its VMEM budget, the one-hot
MXU work of its Mosaic bsp kernel and that kernel's measured block counts.
None of those exist on the card, so this tool asks the same question of
the H100's own limits: per layer, forward and backward and the Adam
update, the bytes each step must move over the HBM rate and the
operations it must do over the peak rate of their type, the larger of the
two per step, summed over the epoch (602-128-41, Reddit's widths).

- Aggregations are priced by ``obs/cost.aggregation_cost``, the formula of
  ``chip_smoke.py``'s kernel bound and of the ``program_cost`` records:
  2·E·f f32 operations; E·8 + (V+1)·4 bytes of indices, weights and
  offsets, x read once and the output written once (padding is a layout's
  cost, so the ELL, bsp and blocked paths share one bound). The standard
  order aggregates at 602 and 128 forward and 128 backward (the input
  features need no gradient); the eager order at 128 and 41 forward and
  41 and 128 backward. The scatter path (plain ``index_add_``) also moves
  every gathered row and every f32 update: E·12 + E·f·b + E·f·4 bytes.
- Matmuls: 2·V·f_in·f_out bf16 tensor-core operations forward and twice
  that backward, their activations read and written once.
- Element-wise steps (batch norm, ReLU, the casts, the loss): the bytes of
  their [V, f] inputs and outputs.
- Adam: 6 f32 passes over the parameters.

Constants are the H100 SXM 80 GB data sheet's (3.35 TB/s HBM, 989 TFLOP/s
dense bf16, 67 TFLOP/s f32, 50 MB L2, 227 KB shared memory per block, 132
SMs); ``device_limits`` reads the card's own memory, SMs, L2 and shared
memory when a card is present. The bound is a floor, not a prediction.

``collect_measured`` reads measured epochs from the step JSONs that
``tools/tpu_plan.py`` saves (``{"value": epoch_s, "extra": {"order",
"path"}}``). Usage::

    python -m neutronstarlite_torch.tools.roofline [--scale 1.0]
        [--runs-dir DIR] [--markdown | --json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Tuple

from neutronstarlite_torch.graph.synthetic import REDDIT_E, REDDIT_V
from neutronstarlite_torch.obs.cost import aggregation_cost

LAYERS = (602, 128, 41)
# NVIDIA H100 SXM 80 GB, data sheet (dense, 700 W)
H100_HBM_BYTES = 80e9
H100_HBM_BYTES_S = 3.35e12
H100_L2_BYTES = 50e6
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_SMEM_PER_BLOCK = 232_448  # 227 KB, the opt-in maximum per block
H100_SMS = 132
DATA_SHEET = "NVIDIA H100 SXM 80 GB data sheet"
PATHS = ("scatter", "ell", "bsp")
ORDERS = ("standard", "eager")


def device_limits() -> Dict[str, object]:
    """Memory, SMs, L2 and shared memory per block: the card's own when a
    card is present, else the data sheet's (``source`` says which). The
    rates always come from the data sheet (a card does not report them)."""
    out: Dict[str, object] = {
        "hbm_bytes": H100_HBM_BYTES, "sms": H100_SMS, "l2_bytes": H100_L2_BYTES,
        "smem_per_block": H100_SMEM_PER_BLOCK, "hbm_bytes_s": H100_HBM_BYTES_S,
        "bf16_flops": H100_BF16_FLOPS, "f32_flops": H100_F32_FLOPS,
        "source": DATA_SHEET,
    }
    try:
        import torch

        if torch.cuda.is_available():
            p = torch.cuda.get_device_properties(0)
            out.update(
                hbm_bytes=int(p.total_memory), sms=int(p.multi_processor_count),
                l2_bytes=int(getattr(p, "L2_cache_size", H100_L2_BYTES)),
                smem_per_block=int(getattr(p, "shared_memory_per_block_optin",
                                           H100_SMEM_PER_BLOCK)),
                source=torch.cuda.get_device_name(0),
            )
    except Exception:  # an unusable CUDA runtime: the data sheet stands
        pass
    return out


def aggregation_calls(order: str, widths=LAYERS) -> List[int]:
    """The aggregation widths of one epoch, forward then backward."""
    w = list(widths)
    if order == "standard":
        # forward at each layer's input width; backward for every layer but
        # the first, whose input (the features) needs no gradient
        return list(w[:-1]) + list(w[1:-1])
    # eager: transform then aggregate, forward and backward at f_out
    return list(w[1:]) + list(reversed(w[1:]))


def epoch_terms(order: str, path: str, v: int, e: int, b: int = 2) -> List[Tuple[str, float, float, float]]:
    """(name, bytes, operations, peak operations/s) of every step of one
    epoch; ``b`` is the compute dtype's itemsize (2: bf16)."""
    if order not in ORDERS or path not in PATHS:
        raise ValueError(f"order {order} / path {path}: known {ORDERS} x {PATHS}")
    terms = []
    for i, f in enumerate(aggregation_calls(order)):
        ops, moved = aggregation_cost(e, v, f, b)
        if path == "scatter":
            moved = e * 12.0 + e * f * b + e * f * 4.0 + (2 * v * f * b)
        terms.append((f"aggregate[{i}] f={f}", float(moved), float(ops), H100_F32_FLOPS))
    widths = list(LAYERS)
    for i in range(len(widths) - 1):
        f_in, f_out = widths[i], widths[i + 1]
        mm = 2.0 * v * f_in * f_out
        act = float(v * (f_in + f_out) * b + f_in * f_out * 4)
        terms.append((f"matmul[{i}] fwd", act, mm, H100_BF16_FLOPS))
        terms.append((f"matmul[{i}] bwd", 2 * act, 2 * mm, H100_BF16_FLOPS))
        last = i == len(widths) - 2
        # batch norm (read, write) and ReLU (read, write) on hidden layers,
        # forward and twice backward; the loss on the logits
        ew = (0 if last else 3 * (2 * v * f_in * b + 2 * v * f_out * b)) + (
            3 * v * f_out * 4 if last else 0)
        terms.append((f"elementwise[{i}]", float(ew), 0.0, H100_F32_FLOPS))
    params = sum(widths[i] * widths[i + 1] for i in range(len(widths) - 1))
    terms.append(("adam", 6.0 * 4 * params, 0.0, H100_F32_FLOPS))
    return terms


def term_seconds(moved: float, ops: float, peak: float) -> float:
    return max(moved / H100_HBM_BYTES_S, ops / peak if ops else 0.0)


def bound_s(order: str, path: str, v: int, e: int, b: int = 2) -> float:
    """The epoch's least time in seconds: each step at the larger of its
    bytes over the HBM rate and its operations over their peak."""
    return sum(term_seconds(m, o, p) for _, m, o, p in epoch_terms(order, path, v, e, b))


def aggregation_bound_ms(order: str, v: int, e: int, b: int = 2) -> Tuple[float, float]:
    """(bytes ms, operations ms) of the epoch's aggregations summed apart,
    as ``chip_smoke.py``'s kernel table states them."""
    moved = ops = 0.0
    for f in aggregation_calls(order):
        o, m = aggregation_cost(e, v, f, b)
        moved, ops = moved + m, ops + o
    return 1e3 * moved / H100_HBM_BYTES_S, 1e3 * ops / H100_F32_FLOPS


def collect_measured(runs_dir: str):
    """(name, epoch_s, order, path, kernel_tile) from the plan's saved step
    JSONs, each read from its last JSON line; records without a value or
    marked stale are skipped."""
    out = []
    for p in sorted(glob.glob(os.path.join(runs_dir, "*.json"))):
        try:
            with open(p) as fh:
                lines = [ln for ln in fh.read().strip().splitlines() if ln.startswith("{")]
            rec = json.loads(lines[-1]) if lines else {}
        except (OSError, json.JSONDecodeError, IndexError):
            continue
        extra = rec.get("extra") or {}
        if rec.get("value") is None or extra.get("stale"):
            continue
        if "order" in extra and "path" in extra:
            out.append((os.path.basename(p)[:-5], float(rec["value"]), extra["order"],
                        extra["path"], int(extra.get("kernel_tile") or 0)))
    return out


def rows(scale: float, runs_dir: str) -> List[Dict[str, object]]:
    """One row per (order, path): the bound and, where a step measured it,
    the epoch and the achieved fraction (bound / measured)."""
    v = max(int(REDDIT_V * scale), 64)
    e = max(int(REDDIT_E * scale), 512)
    measured = {(o, p): (n, t) for n, t, o, p, _ in collect_measured(runs_dir)}
    out = []
    for order in ORDERS:
        for path in PATHS:
            t_bound = bound_s(order, path, v, e)
            m = measured.get((order, path))
            out.append({
                "order": order, "path": path, "v": v, "e": e, "bound_s": t_bound,
                "measured_s": m[1] if m else None, "run": m[0] if m else None,
                "achieved": t_bound / m[1] if m else None,
            })
    return out


def default_runs_dir() -> str:
    from neutronstarlite_torch.tools.tpu_plan import default_out

    return default_out()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--runs-dir", default=None, help="step JSONs (tpu_plan --out)")
    fmt = ap.add_mutually_exclusive_group()
    fmt.add_argument("--markdown", action="store_true")
    fmt.add_argument("--json", action="store_true", help="one JSON line")
    args = ap.parse_args(argv)
    table = rows(args.scale, args.runs_dir or default_runs_dir())
    if args.json:
        print(json.dumps({"scale": args.scale, "device": DATA_SHEET,
                          "hbm_bytes_s": H100_HBM_BYTES_S, "rows": table}))
        return 0
    if args.markdown:
        print("| order | path | bound (s) | measured (s) | achieved |")
        print("|---|---|---|---|---|")
    else:
        print(f"roofline @ scale {args.scale:g} (V={table[0]['v']} E={table[0]['e']}, "
              f"{DATA_SHEET}: {H100_HBM_BYTES_S / 1e12:.2f} TB/s)")
    for r in table:
        if args.markdown:
            got = (f"{r['measured_s']:.6f} | {100 * r['achieved']:.1f}% ({r['run']})"
                   if r["run"] else "— | —")
            print(f"| {r['order']} | {r['path']} | {r['bound_s']:.6f} | {got} |")
        else:
            tail = (f"  measured {r['measured_s']:.6f}s = {100 * r['achieved']:.1f}% of "
                    f"the bound ({r['run']})" if r["run"] else "")
            print(f"{r['order']:9s} {r['path']:8s} bound {r['bound_s']:.6f}s{tail}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
