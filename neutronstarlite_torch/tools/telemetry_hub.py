"""Run the cross-host telemetry hub (obs/hub) as a process.

Port of ``neutronstarlite_tpu/tools/telemetry_hub.py``, copied: only the
import paths differ.

Polls each target's ``/telemetry`` endpoint, merges the fleet view via
the exact histogram merge law, writes ONE schema-valid merged stream
under ``NTS_METRICS_DIR`` (rendered natively by tools/metrics_report and
tools/dashboard), optionally appends ``kind=fleet`` perf-ledger rows,
and re-exports the merged view on its own /metrics + /healthz (+
/telemetry — hubs compose: a region hub's endpoint is a valid target
for a global hub).

Usage:
  python -m neutronstarlite_torch.tools.telemetry_hub
      --targets host1:9100,host2:9100[,...]   (or NTS_HUB_TARGETS)
      [--poll S]        poll interval (NTS_HUB_POLL_S, default 2.0)
      [--miss-k K]      polls missed before target_loss
                        (NTS_HUB_MISS_K, default 3)
      [--polls N]       stop after N cycles (default: forever; the CI
                        smoke uses a bounded run)
      [--port P]        arm the merged-view exporter on port P
                        (0 = ephemeral; omit to not serve)
      [--ledger DIR]    append kind=fleet rows (default NTS_LEDGER_DIR)
      [--ledger-every N] one row per N polls (default 1)

Exit 0 on a completed bounded run or a clean ^C; exit 1 on setup errors
(no targets). A DEAD TARGET IS NOT AN ERROR: it becomes a typed
``target_loss`` record and /healthz reports degraded-but-ok while any
target still answers — the hub outliving its fleet is the point.
"""

from __future__ import annotations

import argparse
import json
import sys

from neutronstarlite_torch.obs import exporter as exp
from neutronstarlite_torch.obs import hub as hub_mod
from neutronstarlite_torch.obs import ledger


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="cross-host telemetry aggregation hub: poll "
        "/telemetry targets, merge the fleet view (exact histogram "
        "merge), re-export + re-stream it"
    )
    ap.add_argument("--targets", default=None,
                    help="comma-separated /telemetry endpoints "
                    "(default NTS_HUB_TARGETS)")
    ap.add_argument("--poll", type=float, default=None,
                    help="poll interval seconds (NTS_HUB_POLL_S)")
    ap.add_argument("--miss-k", type=int, default=None,
                    help="consecutive missed polls before target_loss "
                    "(NTS_HUB_MISS_K)")
    ap.add_argument("--polls", type=int, default=None,
                    help="stop after N poll cycles (default: forever)")
    ap.add_argument("--port", type=int, default=None,
                    help="serve the merged view on this port "
                    "(0 = ephemeral; omit to not serve)")
    ap.add_argument("--ledger", default=None,
                    help="fleet-row ledger directory "
                    "(default NTS_LEDGER_DIR)")
    ap.add_argument("--ledger-every", type=int, default=1)
    ap.add_argument("--json", action="store_true",
                    help="print one JSON line per poll cycle")
    args = ap.parse_args(argv)

    targets = ([t.strip() for t in args.targets.split(",") if t.strip()]
               if args.targets else hub_mod.hub_targets())
    if not targets:
        print("telemetry_hub: no targets (--targets or NTS_HUB_TARGETS)",
              file=sys.stderr)
        return 1

    hub = hub_mod.TelemetryHub(
        targets, poll_s=args.poll, miss_k=args.miss_k,
        ledger_dir=args.ledger or ledger.ledger_dir(),
        ledger_every=args.ledger_every,
    )
    server = None
    if args.port is not None:
        server = exp.MetricsExporter(hub.registry, port=args.port)
        print(f"telemetry_hub: merged view on port {server.port} "
              "(/metrics /healthz /telemetry)", file=sys.stderr)

    def on_poll(cycle):
        if args.json:
            print(json.dumps(cycle), flush=True)
        else:
            print(
                f"telemetry_hub: poll {cycle['poll']}: "
                f"{cycle['targets_ok']}/{cycle['targets']} target(s) ok"
                + (f", {cycle['targets_lost']} LOST"
                   if cycle["targets_lost"] else ""),
                file=sys.stderr, flush=True,
            )

    try:
        hub.run(polls=args.polls, on_poll=on_poll)
    finally:
        hub.close()
        if server is not None:
            server.close()
        if hub.stream_path():
            print(f"telemetry_hub: merged stream -> {hub.stream_path()}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
