"""Run the cross-host serve router (serve/crosshost) as a process — port of
``neutronstarlite_tpu/tools/serve_router.py``.

Two modes:

**Spawn (supervision) mode** — ``<cfg> <ckpt>`` given: fork
``--replicas`` serve children (each its own process, its own exporter
port carrying /predict + the scrape surfaces; on the CUDA card unless
``--device cpu``), then route, supervise (miss-K ``target_loss`` ->
respawn from the recorded launch recipe, ``recovery action=restart``)
and — with ``--rollout CKPT`` — perform one rolling model rollout
(digest preflight -> canary gate under ``NTS_CANARY_TOL`` -> drain +
restart one replica at a time, rollback on abort).

**Targets (discovery) mode** — ``--targets host:port,...`` (or
``NTS_FLEET_TARGETS``): route and aggregate over already-running
replicas. No launch recipes, so replica death stays a ``target_loss``
(the fleet serves on the survivors) and rollout is refused.

Usage:
  python -m neutronstarlite_torch.tools.serve_router <cfg> <ckpt>
      [--replicas N]     children to spawn (default 3)
      [--targets T,T]    discovery mode instead of spawning
      [--poll S]         router poll interval (default 0.5)
      [--miss-k K]       missed polls before loss/restart
                         (NTS_HUB_MISS_K, default 3)
      [--polls N]        report N status cycles then exit
                         (default: forever; ^C exits cleanly)
      [--ledger DIR]     append kind=fleet rows (default NTS_LEDGER_DIR)
      [--ledger-every N] one row per N polls
      [--rollout CKPT]   roll the fleet onto CKPT after --rollout-after
                         status cycles, then keep serving
      [--rollout-after N] (default 2)
      [--device cpu]     serve (and canary) on the CPU; default the
                         CUDA card, and the children exit 2 without one
      [--json]           one JSON status line per cycle

Exit 0 on a completed bounded run or clean ^C; 1 on setup errors; 3 when
a requested rollout did not promote (the fleet still exits cleanly on
its surviving checkpoint — a refused rollout is a verdict, not a crash).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from neutronstarlite_torch.obs import ledger
from neutronstarlite_torch.serve import crosshost


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="cross-host serve router: spawn/supervise replica "
        "processes, route over HTTP, rolling rollout with canary gate"
    )
    ap.add_argument("cfg", nargs="?", default="")
    ap.add_argument("ckpt", nargs="?", default="")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--targets", default=None,
                    help="comma-separated replica addresses (discovery "
                    "mode; default spawn mode needs cfg+ckpt)")
    ap.add_argument("--poll", type=float, default=0.5)
    ap.add_argument("--miss-k", type=int, default=None)
    ap.add_argument("--polls", type=int, default=None,
                    help="status cycles to report before exiting")
    ap.add_argument("--ledger", default=None)
    ap.add_argument("--ledger-every", type=int, default=1)
    ap.add_argument("--rollout", default=None,
                    help="checkpoint dir to roll the fleet onto")
    ap.add_argument("--rollout-after", type=int, default=2)
    ap.add_argument("--spawn-dir", default=None,
                    help="port-file directory (spawn mode)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="the children's (and the canary's) device "
                    "(default: the CUDA card)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    common = dict(
        poll_s=args.poll, miss_k=args.miss_k,
        ledger_dir=args.ledger or ledger.ledger_dir(),
        ledger_every=args.ledger_every,
    )
    try:
        if args.targets is not None or (not args.cfg and
                                        crosshost.fleet_targets()):
            targets = ([t.strip() for t in args.targets.split(",")
                        if t.strip()] if args.targets else None)
            fleet = crosshost.CrossHostFleet.from_targets(targets, **common)
        elif args.cfg and args.ckpt:
            fleet = crosshost.CrossHostFleet.spawn(
                args.cfg, args.ckpt, args.replicas,
                spawn_dir=args.spawn_dir, device=args.device, **common,
            )
        else:
            print("serve_router: need <cfg> <ckpt> (spawn mode) or "
                  "--targets/NTS_FLEET_TARGETS (discovery mode)",
                  file=sys.stderr)
            return 1
    except (ValueError, RuntimeError, TimeoutError, OSError) as e:
        print(f"serve_router: {e}", file=sys.stderr)
        return 1

    for r in fleet.replicas:
        print(f"serve_router: replica {r.rid} -> {r.base_url}"
              + (f" (pid {r.proc.pid})" if r.proc is not None else ""),
              file=sys.stderr, flush=True)

    rollout_verdict = None
    n = 0
    try:
        while args.polls is None or n < args.polls:
            time.sleep(max(args.poll, 0.05))
            n += 1
            s = fleet.stats()
            if args.json:
                print(json.dumps({"cycle": n, **s}), flush=True)
            else:
                lat = s["latency_ms"]
                print(
                    f"serve_router: cycle {n}: "
                    f"{s['replicas'] - s['targets_lost']}/{s['replicas']} "
                    f"replica(s) ok, {s['requests']} served, "
                    f"{s['shed']} shed, {s['restarts']} restart(s), "
                    f"p99={lat.get('p99')}",
                    file=sys.stderr, flush=True,
                )
            if args.rollout and rollout_verdict is None and \
                    n >= args.rollout_after:
                rec = fleet.rollout(args.rollout)
                rollout_verdict = rec["verdict"]
                print(f"serve_router: rollout {rollout_verdict}: "
                      f"{json.dumps(rec)}", file=sys.stderr, flush=True)
    except KeyboardInterrupt:
        print("serve_router: interrupted; closing the fleet",
              file=sys.stderr)
    finally:
        stats = fleet.close()
        print(f"serve_router: closed: {json.dumps(stats)}",
              file=sys.stderr, flush=True)
    if args.rollout and rollout_verdict != "promoted":
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
