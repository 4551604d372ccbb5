"""Opt-in pull-based HTTP telemetry endpoint (``NTS_METRICS_PORT``).

Port of ``neutronstarlite_tpu/obs/exporter.py``, copied: only the import paths
differ.

Serves three paths from lock-light snapshots of one or MANY live
registries — scrapes copy the metric dicts under each registry's lock
(microseconds) and format OUTSIDE it, so a scrape can never block a serve
flush or a ring step:

- ``/metrics`` — Prometheus text exposition: counters, numeric gauges,
  timing summaries (``_count``/``_sum``), and every LogHistogram as a
  cumulative-bucket histogram over the ``le`` ladder
  (obs/hist.prom_edges — NTS_METRICS_LADDER-configurable, default
  PROM_EDGES_MS) plus ``_sum``/``_count``. The ladder is LOSSY: a
  ladder-derived quantile snaps to an edge, so remote aggregation must
  not reconstruct distributions from it — that is what /telemetry is
  for;
- ``/healthz`` — JSON liveness: run identity, uptime, fault/restart
  counters, the supervisor state gauge, elastic partition count;
- ``/slo`` — the SLO engine's current objective verdicts as JSON (404
  when no engine is armed);
- ``/telemetry`` — the FULL-RESOLUTION schema-valid JSONL snapshot: per
  surface one typed ``telemetry`` record (counters/gauges/timings +
  the /healthz liveness facts + run identity), one cumulative ``hist``
  record per histogram with its NATIVE 1.02-growth buckets, and one
  ``slo_status`` record per objective verdict. This is the wire format
  obs/hub.py polls: native buckets merge by the exact LogHistogram
  merge law, so fleet p50/p95/p99 over N hosts equals what one process
  would have measured (within the documented ~1% bucket bound).
  ``?replica=rK`` filters to one labeled fleet surface.

**Replica labels (the serve fleet).** One process can serve N replicas
(serve/fleet.py), each with its own registry + SLO engine — and
latest-registry-wins would make them clobber each other's ``/metrics``.
``maybe_start(registry, slo, replica="r0")`` instead registers a LABELED
surface: every replica's families merge under the one port with a
``replica="rK"`` label per sample (ONE ``# TYPE`` line per family — the
Prometheus single-declaration rule), ``/healthz`` reports per-replica
payloads plus the fleet aggregate, and ``/slo`` maps replica → verdicts.
An unlabeled ``maybe_start`` keeps the legacy single-surface
latest-wins semantics (train-then-serve handoffs) and REPLACES any
labeled fleet — the newest run owns the port either way.

``NTS_METRICS_PORT=0`` binds an ephemeral port (``exporter.port`` reports
it — tests and in-process drivers use this); the listener binds
``NTS_METRICS_HOST`` (default 127.0.0.1 — expose deliberately, not by
default).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterator, List, Optional, Tuple

from urllib.parse import parse_qs

from neutronstarlite_torch.obs.hist import PROM_EDGES_MS, prom_edges  # noqa: F401 (PROM_EDGES_MS re-exported for callers pinned to the canonical ladder)
from neutronstarlite_torch.obs.schema import SCHEMA_VERSION
from neutronstarlite_torch.obs.trace import TraceContext, Tracer
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("obs")


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"nts_{out}"


# one sample for the merged renderer: (family, prom type or None, name
# suffix, label dict, preformatted value string)
_Sample = Tuple[str, Optional[str], str, Dict[str, str], str]


def _fmt(v) -> str:
    return f"{float(v):g}"


def _surface_samples(registry, slo=None) -> Iterator[_Sample]:
    """One registry's Prometheus samples, typed per family.

    A name can exist as BOTH a scalar and a histogram (sample.stall_ms
    is a cumulative counter and a distribution; sample.queue_depth a
    high-water gauge and a distribution) — Prometheus rejects a second
    TYPE declaration for one family, so the colliding scalar renders
    under a suffixed name (`_total` for counters, `_peak` for gauges)
    and the histogram keeps the bare family."""
    snap = registry.snapshot(include_hists=False)
    hists = registry.hists()
    for name, v in sorted(snap["counters"].items()):
        fam = _prom_name(name + "_total" if name in hists else name)
        yield (fam, "counter", "", {}, _fmt(v))
    for name, v in sorted(snap["gauges"].items()):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue  # non-numeric gauges (strings) have no Prom encoding
        fam = _prom_name(name + "_peak" if name in hists else name)
        yield (fam, "gauge", "", {}, _fmt(v))
    for name, t in sorted(snap["timings"].items()):
        fam = _prom_name(name + "_seconds")
        yield (fam, "summary", "_count", {}, str(int(t["count"])))
        yield (fam, "summary", "_sum", {}, _fmt(t["total_s"]))
    edges = prom_edges()
    for name, h in sorted(hists.items()):
        fam = _prom_name(name)
        for edge in edges:
            yield (fam, "histogram", "_bucket", {"le": f"{edge:g}"},
                   str(h.count_le(edge)))
        yield (fam, "histogram", "_bucket", {"le": "+Inf"}, str(h.count))
        yield (fam, "histogram", "_sum", {}, _fmt(h.sum))
        yield (fam, "histogram", "_count", {}, str(h.count))
    if slo is not None:
        for v in slo.verdicts():
            burn = v["burn_rate"]
            yield ("nts_slo_burn_rate", None, "",
                   {"objective": str(v["objective"])},
                   _fmt(burn) if burn is not None else "NaN")
            yield ("nts_slo_breached", None, "",
                   {"objective": str(v["objective"])},
                   "1" if v["state"] == "breach" else "0")


def prometheus_text_multi(
    surfaces: "OrderedDict[str, Tuple[Any, Any]]"
) -> str:
    """Render every labeled surface into ONE exposition: families merge
    across replicas (single TYPE line), samples carry ``replica=`` when
    their surface is labeled."""
    fam_type: Dict[str, Optional[str]] = {}
    fam_samples: "OrderedDict[str, List[Tuple[str, Dict[str, str], str]]]" \
        = OrderedDict()
    for label, (registry, slo) in surfaces.items():
        for fam, typ, suffix, labels, value in _surface_samples(
            registry, slo
        ):
            if label:
                merged = OrderedDict()
                merged["replica"] = label
                merged.update(labels)
                labels = merged
            fam_type.setdefault(fam, typ)
            fam_samples.setdefault(fam, []).append((suffix, labels, value))
    lines: List[str] = []
    for fam, samples in fam_samples.items():
        typ = fam_type.get(fam)
        if typ:
            lines.append(f"# TYPE {fam} {typ}")
        for suffix, labels, value in samples:
            lab = (
                "{" + ",".join(f'{k}="{v}"' for k, v in labels.items()) + "}"
                if labels else ""
            )
            lines.append(f"{fam}{suffix}{lab} {value}")
    return "\n".join(lines) + "\n"


def prometheus_text(registry, slo=None) -> str:
    """Single-surface rendering (the legacy entry point)."""
    return prometheus_text_multi(OrderedDict([("", (registry, slo))]))


def health_payload(registry, started_at: float) -> Dict[str, Any]:
    snap = registry.snapshot(include_hists=False)
    counters = snap["counters"]
    gauges = snap["gauges"]
    gave_up = bool(gauges.get("resilience.gave_up"))
    beating = gauges.get("serve.beating")  # fleet replicas pin this
    out = {
        "ok": not gave_up and beating is not False,
        "run_id": registry.run_id,
        "algorithm": registry.algorithm,
        "uptime_s": round(time.time() - started_at, 3),
        "supervisor": {
            "state": gauges.get("resilience.state"),
            "attempt": gauges.get("resilience.attempt"),
            "faults": counters.get("resilience.faults", 0),
            "restarts": counters.get("resilience.restarts", 0),
            "replans": counters.get("resilience.replans", 0),
        },
        "liveness": {
            "active_partitions": gauges.get("dist.active_partitions"),
            "last_event_ts": registry.last_event_ts,
        },
    }
    if gauges.get("serve.replica") is not None or beating is not None:
        out["serve"] = {
            "replica": gauges.get("serve.replica"),
            "beating": beating,
            "requests": counters.get("serve.requests", 0),
            "shed": counters.get("serve.shed", 0),
        }
    # a telemetry hub's surface (obs/hub.py): degraded-but-alive while at
    # least one polled target answers; ok flips only when the WHOLE fleet
    # is unreachable (or the hub itself gave up)
    targets = gauges.get("hub.targets")
    if targets is not None:
        ok_targets = int(gauges.get("hub.targets_ok") or 0)
        lost = int(gauges.get("hub.targets_lost") or 0)
        out["hub"] = {
            "targets": int(targets),
            "targets_ok": ok_targets,
            "targets_lost": lost,
            "degraded": lost > 0,
            "polls": counters.get("hub.polls", 0),
        }
        out["ok"] = bool(out["ok"] and (ok_targets > 0 or int(targets) == 0))
    return out


def fleet_health_payload(
    surfaces: "OrderedDict[str, Tuple[Any, Any]]", started_at: float
) -> Dict[str, Any]:
    """Labeled surfaces -> per-replica payloads + the fleet aggregate;
    a single unlabeled surface keeps the legacy flat payload."""
    if list(surfaces) == [""]:
        return health_payload(surfaces[""][0], started_at)
    replicas = {
        label: health_payload(reg, started_at)
        for label, (reg, _slo) in surfaces.items()
    }
    ok = all(p["ok"] for p in replicas.values())
    return {
        "ok": ok,
        "fleet": {
            "replicas": len(replicas),
            "ok_count": sum(1 for p in replicas.values() if p["ok"]),
        },
        "replicas": replicas,
    }


def telemetry_records(
    surfaces: "OrderedDict[str, Tuple[Any, Any]]", started_at: float,
    replica: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """The /telemetry payload: per surface one typed ``telemetry``
    record, one cumulative ``hist`` record per histogram (NATIVE
    buckets — this is the lossless half the /metrics ladder drops), and
    one ``slo_status`` record per objective verdict. Every record is
    schema-valid (obs/schema.py) with the surface registry's run
    identity; ``replica`` filters to one labeled fleet surface."""
    recs: List[Dict[str, Any]] = []
    now = time.time()
    for label, (registry, slo) in surfaces.items():
        if replica is not None and label != replica:
            continue
        snap = registry.snapshot(include_hists=False)
        seq = 0

        def env(body: Dict[str, Any], *, _reg=registry) -> Dict[str, Any]:
            nonlocal seq
            rec = {
                "event": body.pop("event"),
                "run_id": _reg.run_id,
                "schema": SCHEMA_VERSION,
                "ts": now,
                "seq": seq,
            }
            rec.update(body)
            seq += 1
            return rec

        top: Dict[str, Any] = {
            "event": "telemetry",
            "source": "exporter",
            "algorithm": registry.algorithm,
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "timings": snap["timings"],
            "health": health_payload(registry, started_at),
            "uptime_s": round(now - started_at, 3),
        }
        if label:
            top["replica"] = label
        recs.append(env(top))
        for name, h in sorted(registry.hists().items()):
            recs.append(env({"event": "hist", "name": name, **h.to_dict()}))
        if slo is not None:
            try:
                slo.tick()
                verdicts = slo.verdicts()
            except Exception as e:  # a scrape must not die on a bad engine
                log.warning("telemetry slo verdicts unavailable: %s", e)
                verdicts = []
            for v in verdicts:
                recs.append(env({"event": "slo_status", **v}))
    return recs


def telemetry_ndjson(
    surfaces: "OrderedDict[str, Tuple[Any, Any]]", started_at: float,
    replica: Optional[str] = None,
) -> str:
    return "".join(
        json.dumps(r, default=str) + "\n"
        for r in telemetry_records(surfaces, started_at, replica=replica)
    )


class MetricsExporter:
    """The HTTP listener; its surfaces are rebindable live.

    Besides the read-only scrape paths, a serve process can bind a DATA
    plane onto the same port: ``bind_predict(fn)`` arms ``POST
    /predict`` (serve/crosshost replica children use this so one
    host:port per replica carries both traffic and telemetry — the
    NTS_FLEET_TARGETS grammar stays a single address). ``fn`` receives
    the decoded JSON body and returns ``(status_code, payload_dict)``;
    unbound, /predict answers 404 like any other unknown path."""

    def __init__(self, registry, port: int, host: str = "127.0.0.1",
                 slo=None, replica: Optional[str] = None):
        self._surface_lock = threading.Lock()
        self._surfaces: "OrderedDict[str, Tuple[Any, Any]]" = OrderedDict()
        self.registry = registry
        self.slo = slo
        self.started_at = time.time()
        self._predict_fn = None
        self._predict_takes_ctx = False
        self._tracer = Tracer(registry)
        self.rebind(registry, slo, replica=replica)
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *_a):  # scrapes must not spam the log
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                try:
                    path = self.path.split("?", 1)[0]
                    surfaces = exporter.surfaces()
                    if path == "/metrics":
                        body = prometheus_text_multi(surfaces).encode()
                        self._send(
                            200, body,
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/healthz":
                        body = json.dumps(fleet_health_payload(
                            surfaces, exporter.started_at
                        )).encode()
                        self._send(200, body, "application/json")
                    elif path == "/slo":
                        armed = OrderedDict(
                            (label, slo_) for label, (_reg, slo_)
                            in surfaces.items() if slo_ is not None
                        )
                        if not armed:
                            self._send(
                                404,
                                b'{"error": "no SLO engine armed '
                                b'(NTS_SLO_SPEC unset)"}',
                                "application/json",
                            )
                        elif list(armed) == [""]:
                            armed[""].tick()
                            body = json.dumps(
                                armed[""].verdicts()
                            ).encode()
                            self._send(200, body, "application/json")
                        else:  # labeled fleet: replica -> verdicts
                            out = {}
                            for label, slo_ in armed.items():
                                slo_.tick()
                                out[label] = slo_.verdicts()
                            self._send(
                                200, json.dumps(out).encode(),
                                "application/json",
                            )
                    elif path == "/telemetry":
                        ctx = (
                            TraceContext.from_headers(self.headers)
                            if exporter._tracer.enabled else None
                        )
                        t_scrape = time.monotonic()
                        want: Optional[str] = None
                        parts = self.path.split("?", 1)
                        if len(parts) == 2:
                            vals = parse_qs(parts[1]).get("replica")
                            if vals:
                                want = vals[0]
                        if want is not None and want not in surfaces:
                            self._send(
                                404,
                                json.dumps({
                                    "error": f"no surface labeled "
                                             f"{want!r}",
                                    "replicas": [
                                        k for k in surfaces if k
                                    ],
                                }).encode(),
                                "application/json",
                            )
                        else:
                            body = telemetry_ndjson(
                                surfaces, exporter.started_at,
                                replica=want,
                            ).encode()
                            self._send(
                                200, body, "application/x-ndjson"
                            )
                            if ctx is not None:
                                # remote-parented scrape span: carries
                                # the (send_ts, recv_ts) clock pair the
                                # fleet timeline merge estimates
                                # cross-process offsets from
                                exporter._tracer.complete(
                                    "telemetry_scrape",
                                    dur_s=time.monotonic() - t_scrape,
                                    cat="http", ctx=ctx,
                                    bytes=len(body),
                                )
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # a bad scrape must not kill serving
                    try:
                        self._send(
                            500, f"scrape failed: {e}\n".encode(),
                            "text/plain",
                        )
                    except Exception:
                        pass

            def do_POST(self):  # noqa: N802 (http.server API)
                try:
                    path = self.path.split("?", 1)[0]
                    fn = exporter._predict_fn
                    if path != "/predict" or fn is None:
                        self._send(404, b'{"error": "not found"}\n',
                                   "application/json")
                        return
                    try:
                        n = int(self.headers.get("Content-Length") or 0)
                        payload = json.loads(
                            self.rfile.read(n).decode("utf-8") or "{}"
                        )
                        if not isinstance(payload, dict):
                            raise ValueError("body must be a JSON object")
                    except (ValueError, UnicodeDecodeError) as e:
                        self._send(
                            400,
                            json.dumps({"error": f"bad request: {e}"}
                                       ).encode(),
                            "application/json",
                        )
                        return
                    tracer = exporter._tracer
                    ctx = (TraceContext.from_headers(self.headers)
                           if tracer.enabled else None)
                    if ctx is not None:
                        # pre-allocate the handler span's id so the
                        # replica's request/queue spans (emitted first,
                        # from the batcher) can parent into it
                        hid = tracer.next_id()
                        t_handle = time.monotonic()
                        down = ctx.child(hid)
                    else:
                        hid = None
                        down = None
                    if exporter._predict_takes_ctx:
                        code, out = fn(payload, down)
                    else:
                        code, out = fn(payload)
                    self._send(int(code), json.dumps(out).encode(),
                               "application/json")
                    if hid is not None:
                        tracer.complete(
                            "predict_handler",
                            dur_s=time.monotonic() - t_handle,
                            cat="serve", ctx=ctx, span_id=hid,
                            status=int(code),
                        )
                except Exception as e:  # a bad request must not kill serving
                    try:
                        self._send(
                            500,
                            json.dumps({"error": str(e)}).encode(),
                            "application/json",
                        )
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-exporter",
            daemon=True,
        )
        self._thread.start()
        log.info("metrics exporter listening on http://%s:%d "
                 "(/metrics /healthz /slo /telemetry)", host, self.port)

    def surfaces(self) -> "OrderedDict[str, Tuple[Any, Any]]":
        with self._surface_lock:
            return OrderedDict(self._surfaces)

    def rebind(self, registry, slo=None,
               replica: Optional[str] = None) -> None:
        """Latest surface wins. Unlabeled: REPLACE everything (keeping a
        previous run's SLO engine — bound to its closed registry — would
        serve stale /slo verdicts next to the new registry's /metrics).
        Labeled (``replica=``): register/replace that replica's surface,
        dropping any unlabeled leftover — a fleet owns the whole port."""
        with self._surface_lock:
            if replica is None:
                self._surfaces = OrderedDict([("", (registry, slo))])
            else:
                self._surfaces.pop("", None)
                self._surfaces[str(replica)] = (registry, slo)
            # legacy attributes track the newest surface; handler spans
            # (predict_handler / telemetry_scrape) follow it
            self.registry = registry
            self.slo = slo
            self._tracer = Tracer(registry)

    def bind_predict(self, fn) -> None:
        """Arm (or with ``None`` disarm) the POST /predict data plane.
        ``fn(payload_dict) -> (status_code, response_dict)`` runs on the
        listener's request thread — it must be thread-safe and bounded
        (the serve batcher's submit/result path already is). A two-arg
        ``fn(payload_dict, ctx)`` additionally receives the request's
        :class:`TraceContext` (or None) so replica-side spans can parent
        into the caller's trace."""
        takes_ctx = False
        if fn is not None:
            import inspect

            try:
                sig = inspect.signature(fn)
                pos = [
                    p for p in sig.parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD)
                ]
                takes_ctx = len(pos) >= 2 or any(
                    p.kind == p.VAR_POSITIONAL
                    for p in sig.parameters.values()
                )
            except (TypeError, ValueError):
                takes_ctx = False
        self._predict_takes_ctx = takes_ctx
        self._predict_fn = fn

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5.0)


_singleton: Optional[MetricsExporter] = None
_singleton_lock = threading.Lock()


def maybe_start(registry, slo=None,
                replica: Optional[str] = None) -> Optional[MetricsExporter]:
    """Start (or rebind) the process's exporter when ``NTS_METRICS_PORT``
    is set; None otherwise. ``replica`` registers a labeled fleet
    surface (see the module docstring). Never raises — a taken port
    degrades to a warning, not a dead trainer."""
    global _singleton
    raw = os.environ.get("NTS_METRICS_PORT", "")
    if not raw:
        return None
    with _singleton_lock:
        if _singleton is not None:
            _singleton.rebind(registry, slo, replica=replica)
            return _singleton
        try:
            port = int(raw)
        except ValueError:
            log.warning("NTS_METRICS_PORT=%r is not an int; exporter off",
                        raw)
            return None
        host = os.environ.get("NTS_METRICS_HOST", "127.0.0.1")
        try:
            _singleton = MetricsExporter(registry, port, host=host, slo=slo,
                                         replica=replica)
        except OSError as e:
            log.warning("metrics exporter could not bind %s:%s (%s); "
                        "exporter off", host, port, e)
            return None
        return _singleton
