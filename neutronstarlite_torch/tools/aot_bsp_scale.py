"""The bsp tables at 10x Reddit, from their geometry — the port's counterpart
of ``neutronstarlite_tpu/tools/aot_bsp_scale.py``.

The JAX tool proved that its segmented Mosaic bsp grid compiles at 10x
Reddit (a lattice of segment shapes compiled for a TPU topology, because
the kernel's scalar-prefetch key had to fit SMEM). The port's
``csrc/bsp_ell.cu`` has no segmentation and nothing to compile per shape,
so the question becomes: at this scale, does every value the card's launch
takes fit its type, and do the tables fit the card? This tool answers it
from V, E and the tile sizes, without drawing the 1.15 G-edge graph:

- the blocks: a bound that holds for any graph of this V and E (packed
  rows <= min(E, V * t_src) runs + E / K; each (dst tile, src tile) group
  adds at most one part-filled block; one filler per empty dst tile; 8
  padding), and an estimate for the bench graph
  (``graph/synthetic.synthetic_power_law_graph``, seed 7): its id
  permutation is recovered by advancing the generator past the edge draws
  (no edge is drawn), each source tile's share of the endpoint mass
  follows, and a destination of in-degree d fills Poisson(d * share) slots
  in each source tile, ceil(slots / K) rows, ceil(rows / R) blocks per
  group (the in-degrees are their expectation, or exact with ``--dist``);
- the grid (column chunks x pieces <= 2^31 - 1) and every value of an
  ``int`` the entry point ``nts_bsp_ell`` takes, or an ``int32`` table
  holds (block keys, piece pointers, tile-local ids), or the kernel forms
  in ``int`` (``src_base``, ``dst_base``), each with its headroom to 2^31;
  the slots (B * K * R), which the kernel and the native fill index in 64
  bits, are reported beside 2^31 with that note;
- the device bytes of the forward and transposed tables (the transposed
  count taken equal to the forward one), x ([V, f] bf16), the f32
  accumulation buffer and the output, against the card's memory.

``--dist P`` takes the per-shard rectangular geometry (``vp`` destination
rows over ``P * vp`` sources), with ``vp`` exact from the degree vector and
``graph/storage.partition_offsets`` as JAX's tool does; the in-degrees are
then counted exactly by drawing the destinations alone, in chunks. Without
``--dist``, on a card, the tool adds one launch of ``bsp_ell.cu`` over a
few blocks placed at the 10x index ranges (the last source and
destination tiles, x of [n_src, f] bf16), held against the plain version on
the rows it touches.

Usage: python -m neutronstarlite_torch.tools.aot_bsp_scale [--scale 10]
         [--f 602] [--dist P]
Prints ONE JSON line; exits 1 when a value does not fit.
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from typing import Dict, Optional, Tuple

import numpy as np

from neutronstarlite_torch.graph.synthetic import REDDIT_E, REDDIT_V
from neutronstarlite_torch.ops.bsp_ell import DEFAULT_DT, DEFAULT_K, DEFAULT_R, DEFAULT_VT

INT_MAX = 2 ** 31 - 1
SEED = 7  # the bench graph's generator seed (tools/bench_graph.py)
_CHUNK = 1 << 25


@functools.lru_cache(maxsize=None)
def _poisson_rows_grid(k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(log lambda, E[ceil(X / k)]) on a grid of lambda in [1e-9, 2000]."""
    grid = np.geomspace(1e-9, 2000.0, 3000)
    n = np.arange(0, 2400)
    logp = (n[None, :] * np.log(grid[:, None]) - grid[:, None]
            - np.cumsum(np.log(np.maximum(n, 1)))[None, :])
    return np.log(grid), (np.exp(logp) * (-(-n // k))[None, :]).sum(axis=1)


def ceil_poisson_rows(lam: np.ndarray, k: int) -> np.ndarray:
    """E[ceil(X / k)] for X ~ Poisson(lam): the expected packed rows of a
    run whose slot count is Poisson."""
    lam = np.asarray(lam, np.float64)
    log_grid, vals = _poisson_rows_grid(int(k))
    out = np.interp(np.log(np.maximum(lam, 1e-9)), log_grid, vals)
    out = np.where(lam < 1e-9, lam, out)
    return np.where(lam > 2000.0, lam / k + (k - 1) / (2.0 * k), out)


def generator_layout(v_num: int, e_num: int, seed: int = SEED, exact_degrees: bool = False):
    """(perm, in_degree) of ``synthetic_power_law_graph(v_num, e_num,
    seed)`` without its edge list: the id permutation (the generator
    advanced past the 2 * n_rand endpoint draws) and each id's in-degree,
    its expectation or, with ``exact_degrees``, the count (the destination
    draws alone, in chunks)."""
    n_rand = e_num - v_num
    if exact_degrees:
        rng = np.random.default_rng(seed)
        rng.bit_generator.advance(n_rand)  # past the sources
        raw = np.zeros(v_num, np.int64)
        for lo in range(0, n_rand, _CHUNK):
            n = min(_CHUNK, n_rand - lo)
            raw += np.bincount((v_num * rng.random(n) ** 3.0).astype(np.int64),
                               minlength=v_num)
        perm = rng.permutation(v_num)
        deg = np.empty(v_num, np.float64)
        deg[perm] = raw
    else:
        rng = np.random.default_rng(seed)
        rng.bit_generator.advance(2 * n_rand)
        perm = rng.permutation(v_num)
        q = np.diff((np.arange(v_num + 1) / v_num) ** (1.0 / 3.0))
        deg = np.empty(v_num, np.float64)
        deg[perm] = n_rand * q
    return perm, deg + 1.0  # + the self loop


def estimate_blocks(v_num: int, e_num: int, dt: int, vt: int, k: int, r: int,
                    deg: np.ndarray, perm: np.ndarray, dst_lo: int = 0,
                    dst_rows: Optional[int] = None, n_src: Optional[int] = None) -> Dict:
    """Expected data blocks and packed rows of the bench graph's bsp tables
    (destinations ``dst_lo : dst_lo + dst_rows``, sources below ``n_src``)."""
    dst_rows = v_num if dst_rows is None else dst_rows
    n_src = v_num if n_src is None else n_src
    t_dst, t_src = -(-dst_rows // dt), -(-n_src // vt)
    # each source tile's share of the endpoint mass (ids below v_num)
    q = np.diff((np.arange(v_num + 1) / v_num) ** (1.0 / 3.0))
    mass = np.zeros(v_num, np.float64)
    mass[perm] = q
    share = np.bincount(np.arange(v_num) // vt, weights=mass, minlength=t_src)[:t_src]
    d = deg[dst_lo: dst_lo + dst_rows]
    tile = np.arange(len(d)) // dt
    # per dst tile, a histogram of log degree (bins 1.1x apart), kept sparse
    b = np.floor(np.log(np.maximum(d, 1.0)) / np.log(1.1)).astype(np.int64)
    nb = int(b.max()) + 1 if len(b) else 1
    key = tile * nb + b
    cnt = np.bincount(key, minlength=t_dst * nb)
    tot = np.bincount(key, weights=d, minlength=t_dst * nb)
    nz = np.nonzero(cnt)[0]
    c_nz, mean_nz, tile_nz = cnt[nz], tot[nz] / cnt[nz], nz // nb
    blocks, rows_total, busy = 0, 0.0, np.zeros(t_dst, bool)
    for t in range(t_src):
        rows = np.bincount(tile_nz, weights=c_nz * ceil_poisson_rows(mean_nz * share[t], k),
                           minlength=t_dst)
        blocks += int(np.ceil(rows / r - 1e-9).sum())
        rows_total += float(rows.sum())
        busy |= rows > 0.5
    busy_tiles = int(busy.sum())
    return {"data_blocks": blocks, "packed_rows": rows_total,
            "empty_dst_tiles": t_dst - busy_tiles}


def geometry(v_num: int, e_num: int, f: int, dt: int = DEFAULT_DT, vt: int = DEFAULT_VT,
             k: int = DEFAULT_K, r: int = DEFAULT_R, dst_rows: Optional[int] = None,
             n_src: Optional[int] = None, data_blocks: Optional[int] = None,
             cols: int = 128, hbm_bytes: float = 80e9) -> Dict:
    """The launch's values and one direction's device bytes. The block
    count is ``data_blocks`` when given (an estimate or a build's count),
    else the bound for any graph of this V and E."""
    dst_rows = v_num if dst_rows is None else dst_rows
    n_src = v_num if n_src is None else n_src
    t_dst, t_src = -(-dst_rows // dt), -(-n_src // vt)
    runs = min(e_num, dst_rows * t_src)
    rows_bound = min(e_num, runs + -(-e_num // k))
    bound = -(-rows_bound // r) + min(t_dst * t_src, runs) + t_dst
    bound += (-bound) % 8
    blocks = bound if data_blocks is None else data_blocks + t_dst
    blocks += (-blocks) % 8
    chunks = -(-f // cols)
    fp = -(-f // 4) * 4
    ints = {
        "n_pieces": blocks, "t_src": t_src, "dt": dt, "vt": vt, "K": k, "R": r,
        "n_src": n_src, "v_num": dst_rows, "f": f,
        "grid_ctas": chunks * blocks,
        "blk_key_max": t_dst * t_src - 1,
        "piece_ptr_max": blocks,
        "src_base_max": (t_src - 1) * vt,
        "dst_base_max": (t_dst - 1) * dt,
    }
    table_bytes = blocks * k * r * 8 + blocks * r * 4 + blocks * 4 + (t_dst + 1) * 4
    # the forward and the transposed tables (the same count on the
    # transpose of a square graph), x, the f32 buffer and the output
    dev = {
        "tables_fwd_bwd": 2 * table_bytes, "x_bf16": n_src * f * 2,
        "acc_f32": dst_rows * fp * 4, "out_bf16": dst_rows * f * 2,
    }
    return {
        "t_dst": t_dst, "t_src": t_src, "blocks": blocks, "blocks_bound": bound,
        "slots": blocks * k * r,
        "ints": {n: {"value": int(val), "headroom": INT_MAX - int(val),
                     "ok": 0 <= int(val) <= INT_MAX} for n, val in ints.items()},
        "slots_vs_2_31": {"value": blocks * k * r,
                          "headroom": INT_MAX - blocks * k * r,
                          "note": "indexed in 64 bits by bsp_ell.cu and the native fill"},
        "device_bytes": dev, "device_bytes_total": int(sum(dev.values())),
        "fits": sum(dev.values()) <= hbm_bytes,
    }


def launch_check(v_num: int, f: int, n_blocks: int = 16) -> Dict:
    """One launch of ``bsp_ell.cu`` over ``n_blocks`` blocks in the last
    destination tile reading the last source tile at this V, x [V, f] bf16
    on the card; held against the plain version on the rows it touches."""
    import torch

    from neutronstarlite_torch.ops import bsp_ell as bsp

    dev = torch.device("cuda")
    dt, vt, k, r = DEFAULT_DT, DEFAULT_VT, DEFAULT_K, DEFAULT_R
    t_dst, t_src = -(-v_num // dt), -(-v_num // vt)
    g = torch.Generator().manual_seed(SEED)
    src_hi = v_num - (t_src - 1) * vt  # rows of the last source tile
    dst_hi = v_num - (t_dst - 1) * dt
    nbr = torch.randint(0, src_hi, (n_blocks, k, r), generator=g, dtype=torch.int32)
    wgt = torch.rand((n_blocks, k, r), generator=g) * 0.01
    ldst = torch.randint(0, dst_hi, (n_blocks, r), generator=g, dtype=torch.int32)
    key = (t_dst - 1) * t_src + (t_src - 1)
    n_pad = n_blocks + (-n_blocks) % 8
    pad = n_pad - n_blocks
    t = bsp.BspEll(
        nbr=torch.cat([nbr, torch.zeros((pad, k, r), dtype=torch.int32)]).to(dev),
        wgt=torch.cat([wgt, torch.zeros((pad, k, r))]).to(dev),
        ldst=torch.cat([ldst, torch.zeros((pad, r), dtype=torch.int32)]).to(dev),
        blk_key=torch.full((n_pad,), key, dtype=torch.int32).to(dev),
        tile_ptr=torch.tensor([0] * (t_dst) + [n_blocks], dtype=torch.int32).to(dev),
        v_num=v_num, dt=dt, vt=vt,
    )
    gd = torch.Generator(device=dev).manual_seed(SEED)
    x = (torch.randn((v_num, f), generator=gd, device=dev, dtype=torch.bfloat16) * 0.1)
    t0 = time.perf_counter()
    before = bsp.bsp_aggregate.launches
    out = bsp.bsp_aggregate(t, x)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lo = (t_dst - 1) * dt
    ref = bsp.bsp_blocks_aggregate(t, x, 0, n_blocks)[lo: v_num]
    got = out[lo:].float()
    err = float((got - ref).abs().max())
    tol = float(2 ** -7 * ref.pow(2).mean().sqrt() + 2 ** -7 * ref.abs().max())
    untouched = float(out[:lo].float().abs().max()) if lo else 0.0
    return {"blocks": n_blocks, "key": key, "x_gib": v_num * f * 2 / 2 ** 30,
            "launches": bsp.bsp_aggregate.launches - before, "seconds": seconds,
            "max_abs_err": err, "tol": tol, "untouched_max": untouched,
            "ok": err <= tol and untouched == 0.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--f", type=int, default=602)
    ap.add_argument("--dist", type=int, default=0, help="P shards (rectangular geometry)")
    ap.add_argument("--memory-gib", type=float, default=None,
                    help="the card's memory when there is no card (default: 80 GB)")
    args = ap.parse_args(argv)
    from neutronstarlite_torch.tools.roofline import device_limits

    t0 = time.perf_counter()
    limits = device_limits()
    hbm = args.memory_gib * 2 ** 30 if args.memory_gib else float(limits["hbm_bytes"])
    v_num = max(int(REDDIT_V * args.scale), 64)
    e_num = max(int(REDDIT_E * args.scale), 512)
    perm, deg = generator_layout(v_num, e_num, exact_degrees=args.dist > 0)
    out: Dict = {"scale": args.scale, "v_num": v_num, "e_num": e_num, "f": args.f,
                 "dist_partitions": args.dist or None, "memory_bytes": hbm,
                 "memory_source": limits["source"] if args.memory_gib is None else "--memory-gib"}
    if args.dist > 0:
        from neutronstarlite_torch.graph.storage import partition_offsets
        from neutronstarlite_torch.parallel.vertex_space import round_up

        offs = partition_offsets(v_num, deg.astype(np.int64), args.dist)
        vp = round_up(max(int(np.diff(offs).max()), 1), 8)
        shard = int(np.argmax(np.diff(offs)))
        est = estimate_blocks(v_num, e_num, DEFAULT_DT, DEFAULT_VT, DEFAULT_K, DEFAULT_R,
                              deg, perm, dst_lo=int(offs[shard]),
                              dst_rows=int(offs[shard + 1] - offs[shard]), n_src=v_num)
        geo = geometry(v_num, int(deg[offs[shard]:offs[shard + 1]].sum()), args.f,
                       dst_rows=vp, n_src=args.dist * vp, data_blocks=est["data_blocks"],
                       hbm_bytes=hbm)
        out.update(vp=vp, widest_shard=shard)
    else:
        est = estimate_blocks(v_num, e_num, DEFAULT_DT, DEFAULT_VT, DEFAULT_K, DEFAULT_R,
                              deg, perm)
        geo = geometry(v_num, e_num, args.f, data_blocks=est["data_blocks"], hbm_bytes=hbm)
    out.update(estimate=est, geometry=geo,
               bound_geometry=geometry(v_num, e_num, args.f, hbm_bytes=hbm)["ints"]["grid_ctas"])
    out["model_s"] = time.perf_counter() - t0
    ok = all(v["ok"] for v in geo["ints"].values())
    if args.dist == 0:
        import torch

        if torch.cuda.is_available():
            out["launch"] = launch_check(v_num, args.f)
            ok = ok and out["launch"]["ok"]
    out["ok"] = bool(ok)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
