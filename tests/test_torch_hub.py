"""The port's telemetry hub (obs/hub), shared HTTP client (obs/httpc) and
fleet trace join (tools/trace_timeline --fleet) held against the
reference's.

- Hub parity: the same /telemetry payloads, fetch script and clock fed to
  the reference's TelemetryHub and the port's give the same merged
  records, target_loss latches, rejoins and kind=fleet ledger rows, field
  by field apart from timestamps; then the counterparts of
  tests/test_hub.py over the port's hub.
- The counterparts of tests/test_httpc.py over the port's client, with
  ``net_drop`` / ``slow_net`` firing at ``http_fetch``.
- The counterparts of tests/test_trace_fleet.py over the port's
  trace_timeline, the live round trip through the port's router and
  exporter (and the reference's tool reading the same streams).
"""

from __future__ import annotations

import http.server
import json
import math
import os
import threading
import time
import types
from collections import OrderedDict

import pytest

from neutronstarlite_tpu.obs import hub as j_hub
from neutronstarlite_tpu.obs import ledger as j_ledger
from neutronstarlite_tpu.obs import registry as j_registry
from neutronstarlite_tpu.tools import trace_timeline as j_trace_timeline
from neutronstarlite_torch.obs import exporter, httpc, ledger, registry, schema
from neutronstarlite_torch.obs import hub as hub_mod
from neutronstarlite_torch.obs.hub import TelemetryHub, normalize_target
from neutronstarlite_torch.resilience import faults
from neutronstarlite_torch.tools import trace_timeline


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("NTS_TRACE", "NTS_METRICS_DIR", "NTS_FAULT_SPEC", "NTS_LEDGER_DIR",
              "NTS_HUB_TARGETS", "NTS_HUB_POLL_S", "NTS_HUB_MISS_K", "NTS_HTTPC_TIMEOUT_S",
              "NTS_HTTPC_RETRIES", "NTS_HTTPC_BACKOFF_S", "NTS_METRICS_PORT"):
        monkeypatch.delenv(k, raising=False)
    faults.reset()
    yield
    faults.reset()


# ---- rig: fake targets backed by real registries ---------------------------


def _source(run_id, tmp_path, values):
    reg = registry.MetricsRegistry(
        run_id, algorithm="SERVE", fingerprint="f",
        path=str(tmp_path / f"{run_id}.jsonl"),
    )
    for v in values:
        reg.hist_observe("serve.latency_ms", v)
    return reg


def _payload(reg, ts=None):
    """What a real exporter would serve on /telemetry for this run."""
    return exporter.telemetry_ndjson(
        OrderedDict([("", (reg, None))]), time.time() if ts is None else ts
    )


def _hub_registry(tmp_path, name="hub.jsonl", mod=registry, run_id="hub-none-0"):
    return mod.MetricsRegistry(run_id, algorithm="HUB", fingerprint="f",
                               path=str(tmp_path / name))


def _exact_p99(values):
    s = sorted(values)
    return s[min(len(s) - 1, math.ceil(0.99 * len(s)) - 1)]


def _stream_events(path):
    events = [json.loads(ln) for ln in open(path) if ln.strip()]
    assert schema.validate_stream(events) == len(events)
    return events


class _FlakyFetch:
    """Scripted per-target availability: the poll indices that fail (or
    answer a torn payload) per target."""

    def __init__(self, regs, down, bad=None, ts=None):
        self.regs = regs      # key -> registry
        self.down = down      # key -> set of poll indices that fail
        self.bad = bad or {}  # key -> set of poll indices with a bad payload
        self.ts = ts
        self.poll = -1

    def begin_poll(self):
        self.poll += 1

    def __call__(self, url):
        key = url.split("//", 1)[1].split(".", 1)[0]
        if self.poll in self.down.get(key, set()):
            raise OSError("connection refused")
        if self.poll in self.bad.get(key, set()):
            return '{"event": "telemetry", "ts": 1'
        return _payload(self.regs[key], self.ts)


# ---- parity with the reference's hub ---------------------------------------

SCENARIOS = {
    # name: (miss_k, down per target, bad payloads per target, polls)
    "merge": (3, {}, {}, 2),
    "loss_and_rejoin": (2, {"r1": {1, 2, 3, 4}}, {}, 6),
    "bad_payload_and_never_answered": (2, {"r2": set(range(9))}, {"r0": {1, 2}}, 5),
}


def _strip(rec):
    """A record without its clock and process fields."""
    return {k: v for k, v in rec.items() if k not in ("ts", "backend", "pid", "host")}


def _fake_clock():
    t = [1.7e9]

    def now():
        t[0] += 0.25
        return t[0]

    return types.SimpleNamespace(time=now, sleep=time.sleep, perf_counter=time.perf_counter,
                                 monotonic=time.monotonic)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_hub_records_and_fleet_rows_equal_the_reference(tmp_path, monkeypatch, scenario):
    miss_k, down, bad, polls = SCENARIOS[scenario]
    regs = {
        "r0": _source("serve-r0-9", tmp_path, [float(i) for i in range(1, 101)]),
        "r1": _source("serve-r1-9", tmp_path, [10.0 + 0.5 * i for i in range(200)]),
        "r2": _source("serve-r2-9", tmp_path, [250.0] * 20 + [5.0] * 80),
    }
    out = {}
    for name, mod, reg_mod, led in (("port", hub_mod, registry, ledger),
                                    ("jax", j_hub, j_registry, j_ledger)):
        monkeypatch.setattr(mod, "time", _fake_clock())
        fetch = _FlakyFetch(regs, down, bad, ts=1.7e9)
        ldir = tmp_path / f"ledger-{name}"
        h = mod.TelemetryHub(
            ["r0.local:1", "r1.local:1", "r2.local:1"], miss_k=miss_k,
            registry=_hub_registry(tmp_path, f"{name}.jsonl", reg_mod),
            ledger_dir=str(ldir), fetch=fetch,
        )
        summaries = []
        for _ in range(polls):
            fetch.begin_poll()
            summaries.append(h.poll_once())
        h.registry.close()
        events = [json.loads(ln) for ln in open(tmp_path / f"{name}.jsonl") if ln.strip()]
        rows = led.read_rows(directory=str(ldir))
        out[name] = (summaries, [_strip(e) for e in events], [_strip(r) for r in rows],
                     {n: (m.count, m.quantiles()) for n, m in h.merged_hists().items()},
                     [(t.url, t.lost, t.missed, t.ever_ok) for t in h.targets])
    for got, want in zip(out["port"], out["jax"]):
        assert got == want
    summaries, events, rows, merged, targets = out["port"]
    assert len(rows) == polls and all(r["kind"] == "fleet" for r in rows)
    kinds = [e["event"] for e in events]
    if scenario == "loss_and_rejoin":
        assert kinds.count("target_loss") == 1 and kinds.count("recovery") == 1
    if scenario == "bad_payload_and_never_answered":
        losses = [e for e in events if e["event"] == "target_loss"]
        assert sorted(e["reason"] for e in losses) == ["never_answered", "poll_miss"]
    for r in regs.values():
        r.close()


# ---- the port's hub: counterparts of tests/test_hub.py -----------------------


@pytest.mark.parametrize("raw,want", [
    ("host:9100", "http://host:9100/telemetry"),
    ("http://host:9100", "http://host:9100/telemetry"),
    ("  10.0.0.2:9101 ", "http://10.0.0.2:9101/telemetry"),
    ("http://h:1/telemetry?replica=r1", "http://h:1/telemetry?replica=r1"),
    ("https://h:1/custom/path", "https://h:1/custom/path"),
])
def test_normalize_target(raw, want):
    assert normalize_target(raw) == want == j_hub.normalize_target(raw)


def test_hub_requires_targets(tmp_path):
    with pytest.raises(ValueError):
        TelemetryHub([])


def test_hub_env_knobs(monkeypatch):
    monkeypatch.setenv("NTS_HUB_TARGETS", "a:1, b:2 ,")
    monkeypatch.setenv("NTS_HUB_POLL_S", "0.5")
    monkeypatch.setenv("NTS_HUB_MISS_K", "7")
    assert hub_mod.hub_targets() == ["a:1", "b:2"]
    assert hub_mod.hub_poll_s() == 0.5
    assert hub_mod.hub_miss_k() == 7
    monkeypatch.setenv("NTS_HUB_POLL_S", "fast")
    monkeypatch.setenv("NTS_HUB_MISS_K", "many")
    assert hub_mod.hub_poll_s() == hub_mod.DEFAULT_POLL_S
    assert hub_mod.hub_miss_k() == hub_mod.DEFAULT_MISS_K


def test_three_target_merge_matches_exact_sort(tmp_path):
    """Fleet p99 over 3 targets equals the client-side exact sort within the
    histogram's ~1% bucket error (asserted at 2.1%: two half-bucket
    roundings)."""
    vals = {
        "r0": [float(i) for i in range(1, 101)],          # 1..100 ms
        "r1": [10.0 + 0.5 * i for i in range(200)],       # 10..109.5
        "r2": [250.0] * 20 + [5.0] * 80,                  # bimodal tail
    }
    regs = {k: _source(f"serve-{k}-1", tmp_path, v) for k, v in vals.items()}
    fetch = lambda url: _payload(regs[url.split("//", 1)[1].split(".", 1)[0]])  # noqa: E731
    h = TelemetryHub(["r0.local:1", "r1.local:1", "r2.local:1"],
                     registry=_hub_registry(tmp_path), fetch=fetch)
    try:
        summary = h.poll_once()
        assert summary["targets_ok"] == 3 and summary["targets_lost"] == 0
        merged = h.merged_hists()["serve.latency_ms"]
        all_vals = [v for vs in vals.values() for v in vs]
        assert merged.count == len(all_vals)
        exact = _exact_p99(all_vals)
        assert abs(merged.quantile(0.99) - exact) / exact <= 0.021
        # the merged view is installed on the hub's own registry, so the
        # stock exporter serves the FLEET histograms
        own = h.registry.hists()["serve.latency_ms"]
        assert own.count == merged.count
        assert own.quantile(0.99) == merged.quantile(0.99)
    finally:
        h.registry.close()
    for r in regs.values():
        r.close()


def test_target_loss_latch_freeze_and_rejoin(tmp_path):
    regs = {
        "r0": _source("serve-r0-2", tmp_path, [10.0] * 50),
        "r1": _source("serve-r1-2", tmp_path, [20.0] * 50),
    }
    fetch = _FlakyFetch(regs, down={"r1": {1, 2, 3, 4}})
    hub_path = tmp_path / "hub.jsonl"
    h = TelemetryHub(["r0.local:1", "r1.local:1"], miss_k=2,
                     registry=_hub_registry(tmp_path, run_id="hub-none-1"), fetch=fetch)
    try:
        summaries = []
        for _ in range(6):
            fetch.begin_poll()
            summaries.append(h.poll_once())
        # polls 1..4 fail for r1: lost latches at poll index 2 (miss 2)
        assert [s["targets_lost"] for s in summaries] == [0, 0, 1, 1, 1, 0]
        # the frozen snapshot keeps r1's 50 observations in the merge
        assert all(s["hists"]["serve.latency_ms"] == 100 for s in summaries)
        events = _stream_events(hub_path)
        losses = [e for e in events if e["event"] == "target_loss"]
        assert len(losses) == 1, "the loss must latch: ONE record per loss"
        assert losses[0]["reason"] == "poll_miss" and losses[0]["miss_k"] == 2
        assert "r1.local" in losses[0]["target"]
        rejoins = [e for e in events if e["event"] == "recovery"
                   and e.get("action") == "target_rejoin"]
        assert len(rejoins) == 1 and "r1.local" in rejoins[0]["target"]
        # the hub block in health_payload: degraded but alive while lost
        h2 = TelemetryHub(["r0.local:1", "r1.local:1"], miss_k=1,
                          registry=_hub_registry(tmp_path, "hub2.jsonl"), fetch=fetch)
        fetch.down["r1"] = set(range(100))
        fetch.begin_poll()
        h2.poll_once()
        payload = exporter.health_payload(h2.registry, h2.started_at)
        assert payload["hub"]["degraded"] is True
        assert payload["hub"]["targets_lost"] == 1
        assert payload["ok"] is True  # one target still answers
        h2.registry.close()
    finally:
        h.registry.close()
    for r in regs.values():
        r.close()


def test_never_answered_and_bad_payload_are_misses(tmp_path):
    responses = {"r0": "{not json", "r1": '{"event": "bogus_kind"}\n'}
    fetch = lambda url: responses[url.split("//", 1)[1].split(".", 1)[0]]  # noqa: E731
    h = TelemetryHub(["r0.local:1", "r1.local:1"], miss_k=2,
                     registry=_hub_registry(tmp_path), fetch=fetch)
    try:
        h.poll_once()
        h.poll_once()
        events = _stream_events(h.registry.path)
        losses = [e for e in events if e["event"] == "target_loss"]
        assert len(losses) == 2
        assert all(loss["reason"] == "never_answered" for loss in losses)
        assert all(loss["last_ok_ts"] is None for loss in losses)
    finally:
        h.registry.close()


def test_hub_stream_renders_in_metrics_report(tmp_path, capsys):
    reg = _source("serve-r0-3", tmp_path, [5.0, 7.0, 9.0])
    fetch = _FlakyFetch({"r0": reg, "r1": reg}, down={"r1": set(range(9))})
    hub_path = tmp_path / "hubstream.jsonl"
    h = TelemetryHub(["r0.local:1", "r1.local:1"], miss_k=1,
                     registry=_hub_registry(tmp_path, "hubstream.jsonl", run_id="hub-none-2"),
                     fetch=fetch)
    try:
        for _ in range(2):
            fetch.begin_poll()
            h.poll_once()
    finally:
        h.registry.close()
    reg.close()
    from neutronstarlite_torch.tools.metrics_report import main as report_main

    rc = report_main([str(hub_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "#telemetry=" in out
    assert "#fleet_targets=1/2 ok, 1 lost" in out
    assert "#target_loss=" in out
    assert "#hist_serve.latency_ms=" in out


def test_fleet_ledger_row_and_gating(tmp_path):
    from neutronstarlite_tpu.tools.perf_sentinel import GATED_METRICS

    reg = _source("serve-r0-4", tmp_path, [10.0] * 100)
    ldir = tmp_path / "ledger"
    h = TelemetryHub(["r0.local:1"], registry=_hub_registry(tmp_path),
                     ledger_dir=str(ldir), fetch=lambda url: _payload(reg))
    try:
        h.poll_once()
        h.poll_once()
    finally:
        h.registry.close()
    reg.close()
    rows = ledger.read_rows(directory=str(ldir))
    fleet = [r for r in rows if r["kind"] == "fleet"]
    assert len(fleet) == 2
    row = fleet[-1]
    assert row["targets"] == 1 and row["targets_ok"] == 1
    assert row["targets_lost"] == 0 and row["polls"] == 2
    hq = row["hist_quantiles"]["serve.latency_ms"]
    assert hq["count"] == 100
    assert abs(hq["p99"] - 10.0) / 10.0 <= 0.011
    # the reference's sentinel gates the fleet trajectory on these scalars
    assert "targets_lost" in GATED_METRICS["fleet"]
    assert all(k in row for k in GATED_METRICS["fleet"])


def test_bounded_run_and_close(tmp_path):
    reg = _source("serve-r0-5", tmp_path, [3.0])
    seen = []
    h = TelemetryHub(["r0.local:1"], poll_s=0.0, registry=_hub_registry(tmp_path),
                     fetch=lambda url: _payload(reg))
    try:
        last = h.run(polls=3, on_poll=seen.append)
        assert last["poll"] == 3 and len(seen) == 3
        assert h.stream_path() == h.registry.path
    finally:
        h.registry.close()
    reg.close()


def test_telemetry_hub_cli_polls_a_live_exporter(tmp_path, monkeypatch, capsys):
    """tools/telemetry_hub over a real exporter: a bounded run, JSON
    cycles, a kind=fleet row per poll and the merged stream."""
    from neutronstarlite_torch.tools import telemetry_hub

    reg = _source("serve-r0-6", tmp_path, [4.0, 8.0])
    exp = exporter.MetricsExporter(reg, port=0)
    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path / "m"))
    try:
        rc = telemetry_hub.main(["--targets", f"127.0.0.1:{exp.port}", "--polls", "2",
                                 "--poll", "0", "--json", "--ledger", str(tmp_path / "l")])
    finally:
        exp.close()
        reg.close()
    assert rc == 0
    cycles = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert [c["targets_ok"] for c in cycles] == [1, 1]
    assert cycles[-1]["hists"]["serve.latency_ms"] == 2
    assert len(ledger.read_rows(directory=str(tmp_path / "l"))) == 2
    assert telemetry_hub.main(["--polls", "1"]) == 1  # no targets


# ---- the port's HTTP client: counterparts of tests/test_httpc.py -------------


class _Script:
    """Per-path behaviour: a list of (status, body) consumed per request;
    the last entry repeats."""

    def __init__(self):
        self.steps = {}
        self.hits = {}
        self.headers = {}  # path -> one header dict per hit, in order
        self.lock = threading.Lock()

    def next_step(self, path, headers=None):
        with self.lock:
            self.hits[path] = self.hits.get(path, 0) + 1
            if headers is not None:
                self.headers.setdefault(path, []).append(
                    {k.lower(): v for k, v in headers.items()})
            steps = self.steps.get(path, [(200, "ok")])
            i = min(self.hits[path] - 1, len(steps) - 1)
            return steps[i]


@pytest.fixture()
def server():
    script = _Script()

    class Handler(http.server.BaseHTTPRequestHandler):
        def _serve(self):
            status, body = script.next_step(self.path, self.headers)
            data = body.encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        do_GET = _serve
        do_POST = _serve

        def log_message(self, *a):  # keep pytest output clean
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", script
    httpd.shutdown()
    httpd.server_close()


def test_ok_fetch_and_post(server):
    base, script = server
    assert httpc.fetch(f"{base}/x", retries=0) == "ok"
    script.steps["/echo"] = [(200, "posted")]
    assert httpc.fetch(f"{base}/echo", data=json.dumps({"a": 1}).encode(),
                       retries=0) == "posted"


def test_refused_is_typed(server):
    with pytest.raises(httpc.HttpRefused):  # a port with no listener
        httpc.fetch("http://127.0.0.1:9", retries=0, timeout_s=2.0)


def test_status_error_carries_status(server):
    base, script = server
    script.steps["/bad"] = [(503, "overloaded")]
    with pytest.raises(httpc.HttpStatusError) as ei:
        httpc.fetch(f"{base}/bad", retries=0)
    assert ei.value.status == 503
    assert isinstance(ei.value, httpc.HttpError)
    assert isinstance(ei.value, OSError)  # legacy handlers keep working


def test_classify_timeout_and_oserror():
    import socket

    assert isinstance(httpc._classify(socket.timeout("t"), "u"), httpc.HttpTimeout)
    assert isinstance(httpc._classify(TimeoutError(), "u"), httpc.HttpTimeout)
    assert isinstance(httpc._classify(ConnectionResetError(), "u"), httpc.HttpRefused)
    e = OSError()
    e.errno = 113  # EHOSTUNREACH
    assert isinstance(httpc._classify(e, "u"), httpc.HttpRefused)
    assert type(httpc._classify(RuntimeError("x"), "u")) is httpc.HttpError
    for exc in (httpc.HttpTimeout("t"), httpc.HttpRefused("r"),
                httpc.HttpStatusError(500, "u"), httpc.HttpError("e")):
        from neutronstarlite_tpu.obs import httpc as j_httpc

        assert httpc.error_class(exc) == j_httpc.error_class(
            getattr(j_httpc, type(exc).__name__)(*(
                (500, "u") if isinstance(exc, httpc.HttpStatusError) else ("x",))))


def test_retry_then_succeed(server):
    base, script = server
    script.steps["/flaky"] = [(500, "boom"), (500, "boom"), (200, "fine")]
    assert httpc.fetch(f"{base}/flaky", retries=2, backoff_s=0.001) == "fine"
    assert script.hits["/flaky"] == 3


def test_retries_zero_is_single_shot(server):
    base, script = server
    script.steps["/once"] = [(500, "boom"), (200, "fine")]
    with pytest.raises(httpc.HttpStatusError):
        httpc.fetch(f"{base}/once", retries=0)
    assert script.hits["/once"] == 1


def test_deadline_bounds_whole_call():
    t0 = time.monotonic()
    with pytest.raises(httpc.HttpError):
        # every attempt refuses at once, so only the backoff sleeps could
        # overshoot: the deadline must clamp them
        httpc.fetch("http://127.0.0.1:9", retries=50, backoff_s=0.2,
                    timeout_s=1.0, deadline_s=0.5)
    assert time.monotonic() - t0 < 5.0


def test_deadline_already_spent_raises_typed():
    with pytest.raises(httpc.HttpTimeout):
        httpc.fetch("http://127.0.0.1:9", retries=0, deadline_s=0.0)


def test_env_knobs(monkeypatch):
    monkeypatch.setenv("NTS_HTTPC_TIMEOUT_S", "1.5")
    monkeypatch.setenv("NTS_HTTPC_RETRIES", "7")
    monkeypatch.setenv("NTS_HTTPC_BACKOFF_S", "0.25")
    assert httpc.http_timeout_s() == 1.5
    assert httpc.http_retries() == 7
    assert httpc.http_backoff_s() == 0.25
    monkeypatch.setenv("NTS_HTTPC_RETRIES", "nope")
    assert httpc.http_retries() == httpc.DEFAULT_RETRIES


def test_net_drop_fires_at_http_fetch(server, monkeypatch):
    base, script = server
    monkeypatch.setenv("NTS_FAULT_SPEC", "net_drop@times=1")
    # the first attempt is dropped by the injected fault, the retry
    # succeeds: the chaos path spends the retry budget a real blip would
    assert httpc.fetch(f"{base}/x", retries=1, backoff_s=0.001) == "ok"
    assert script.hits["/x"] == 1  # the dropped attempt never hit a socket


def test_net_drop_target_selectivity(server, monkeypatch):
    base, _ = server
    monkeypatch.setenv("NTS_FAULT_SPEC", "net_drop@target=1")
    # target 0 unaffected (the spec names target 1, so it stays armed)
    assert httpc.fetch(f"{base}/x", retries=0, target=0) == "ok"
    with pytest.raises(httpc.HttpRefused):  # no retries: the refusal surfaces
        httpc.fetch(f"{base}/x", retries=0, target=1)


def test_slow_net_injects_latency(server, monkeypatch):
    base, _ = server
    monkeypatch.setenv("NTS_FAULT_SPEC", "slow_net@target=0,ms=80,times=1")
    t0 = time.monotonic()
    assert httpc.fetch(f"{base}/x", retries=0, target=0) == "ok"
    assert time.monotonic() - t0 >= 0.08


def test_fault_records_are_emitted(server, monkeypatch, tmp_path):
    from neutronstarlite_torch.resilience import events

    reg = registry.MetricsRegistry("r", algorithm="A", fingerprint="f",
                                   path=str(tmp_path / "s.jsonl"))
    prev = events.get_sink()
    events.set_sink(reg)
    try:
        base, _ = server
        monkeypatch.setenv("NTS_FAULT_SPEC", "net_drop@times=1")
        httpc.fetch(f"{base}/x", retries=1, backoff_s=0.001, target=3)
    finally:
        events.set_sink(prev)
        reg.close()
    recs = [json.loads(ln) for ln in open(tmp_path / "s.jsonl") if ln.strip()]
    drops = [r for r in recs if r["event"] == "fault" and r["kind"] == "net_drop"]
    assert len(drops) == 1
    assert drops[0]["target"] == 3 and drops[0]["injected"] is True


def test_unknown_net_fault_args_refuse_to_parse():
    for bad in ("net_drop@bogus=1", "slow_net@point=nowhere", "net_lag@target=1",
                "slow_net@ms=fast"):
        with pytest.raises(ValueError):
            faults.parse_fault_spec(bad)
    specs = faults.parse_fault_spec("net_drop@target=2,times=3;slow_net@ms=20")
    assert [s.kind for s in specs] == ["net_drop", "slow_net"]
    assert specs[0].target == 2 and specs[0].times == 3
    assert specs[1].ms == 20


def test_hub_default_fetch_retries_before_missing(server, monkeypatch):
    base, script = server
    payload = json.dumps({
        "event": "telemetry", "ts": time.time(), "run_id": "x",
        "source": "serve", "counters": {}, "gauges": {},
    })
    script.steps["/telemetry"] = [(500, "blip"), (200, payload)]
    monkeypatch.setenv("NTS_HTTPC_BACKOFF_S", "0.001")
    body = hub_mod._default_fetch(f"{base}/telemetry")
    assert json.loads(body)["event"] == "telemetry"
    assert script.hits["/telemetry"] == 2  # retried within ONE poll


def _tracer(tmp_path, monkeypatch, name="client", trace="1"):
    from neutronstarlite_torch.obs.trace import Tracer

    monkeypatch.setenv("NTS_TRACE", trace)
    path = tmp_path / f"{name}.jsonl"
    reg = registry.MetricsRegistry(name, algorithm="A", fingerprint="f", path=str(path))
    return reg, Tracer(reg), path


def test_trace_headers_injected_and_restamped_per_attempt(server, tmp_path, monkeypatch):
    """ctx crosses the wire on every attempt: the same trace id and parent
    (the call's own span), send_ts re-stamped per retry; the failed attempt
    leaves an http_retry child tagged with its error class."""
    from neutronstarlite_torch.obs.trace import TraceContext

    base, script = server
    reg, tr, path = _tracer(tmp_path, monkeypatch)
    script.steps["/p"] = [(503, "overloaded"), (200, "ok")]
    ctx = TraceContext("trace-1", "root-1")
    out = httpc.fetch(f"{base}/p", retries=1, backoff_s=0.001,
                      tracer=tr, ctx=ctx, span_name="predict_post")
    assert out == "ok"
    hdrs = script.headers["/p"]
    assert len(hdrs) == 2
    assert [h["x-nts-trace-id"] for h in hdrs] == ["trace-1", "trace-1"]
    sid = hdrs[0]["x-nts-parent-span"]
    assert sid and sid != "root-1"  # the call's OWN span, not the root
    assert hdrs[1]["x-nts-parent-span"] == sid
    assert float(hdrs[1]["x-nts-send-ts"]) > float(hdrs[0]["x-nts-send-ts"])
    reg.close()
    spans = [json.loads(ln) for ln in open(path) if ln.strip()]
    spans = [e for e in spans if e.get("event") == "span"]
    post = next(s for s in spans if s["name"] == "predict_post")
    assert post["span_id"] == sid and post["trace_id"] == "trace-1"
    assert post["parent_id"] == "root-1"
    assert post["outcome"] == "ok" and post["attempts"] == 2
    retry = next(s for s in spans if s["name"] == "http_retry")
    assert retry["parent_id"] == sid and retry["trace_id"] == "trace-1"
    assert retry["error"] == "status" and retry["status"] == 503
    assert retry["will_retry"] is True


def test_retry_spans_tag_error_class_and_final_failure(server, tmp_path, monkeypatch):
    reg, tr, path = _tracer(tmp_path, monkeypatch)
    with pytest.raises(httpc.HttpRefused):
        httpc.fetch("http://127.0.0.1:9", retries=1, backoff_s=0.001,
                    timeout_s=1.0, tracer=tr)
    reg.close()
    spans = [json.loads(ln) for ln in open(path) if ln.strip()]
    spans = [e for e in spans if e.get("event") == "span"]
    retries = [s for s in spans if s["name"] == "http_retry"]
    assert [r["error"] for r in retries] == ["refused", "refused"]
    assert [r["will_retry"] for r in retries] == [True, False]
    fetch_span = next(s for s in spans if s["name"] == "http_fetch")
    assert fetch_span["outcome"] == "refused" and fetch_span["attempts"] == 2


def test_trace_off_means_zero_records_and_clean_wire(server, tmp_path, monkeypatch):
    """NTS_TRACE=0: no headers and zero span records."""
    base, script = server
    reg, tr, path = _tracer(tmp_path, monkeypatch, trace="0")
    assert not tr.enabled
    assert httpc.fetch(f"{base}/q", retries=0, tracer=tr) == "ok"
    reg.close()
    assert all(not k.lower().startswith("x-nts") for k in script.headers["/q"][0])
    events = ([json.loads(ln) for ln in open(path) if ln.strip()] if path.exists() else [])
    assert [e for e in events if e.get("event") == "span"] == []


# ---- the fleet trace join: counterparts of tests/test_trace_fleet.py ---------

W = 1.7e9       # router wall = mono + W
RTT_S = 0.002   # synthetic network: 1 ms each way


def _mk(events, path):
    assert schema.validate_stream(events) == len(events)
    with open(path, "w", encoding="utf-8") as fh:
        for e in events:
            fh.write(json.dumps(e) + "\n")
    return str(path)


def _env(run_id, seq, ts, **fields):
    return {"event": "span", "run_id": run_id, "schema": schema.SCHEMA_VERSION,
            "seq": seq, "ts": ts, "rank": 0, **fields}


def _fleet_streams(tmp_path, skew_s, n, router_only_extra=0):
    """Synthetic router + replica streams for ``n`` traced requests; the
    replica's wall clock runs ``skew_s`` ahead of the router's. Per request:
    50 ms client latency, 40 ms of recorded replica stages -> 10 ms router
    overhead. ``router_only_extra`` traces have no replica leg."""
    router, replica = [], []
    rs, ps = [0], [0]

    def r_ev(**f):
        rs[0] += 1
        return _env("router-run", rs[0], W + f["t0"] + f["dur_s"], **f)

    def p_ev(**f):
        ps[0] += 1
        return _env("replica-run", ps[0], W + skew_s + f["t0"] + f["dur_s"], **f)

    router.append({"event": "run_start", "run_id": "router-run",
                   "schema": schema.SCHEMA_VERSION, "seq": 0, "ts": W,
                   "algorithm": "ROUTER", "fingerprint": "f", "process_index": 0})
    replica.append({"event": "run_start", "run_id": "replica-run",
                    "schema": schema.SCHEMA_VERSION, "seq": 0, "ts": W + skew_s,
                    "algorithm": "SERVE", "fingerprint": "f", "process_index": 0})
    for k in range(n + router_only_extra):
        tk = 10.0 + k
        tid = f"router-run:q{k}"
        root_id, post_id = f"r{k}", f"p{k}"
        send = W + tk + 0.002
        router.append(r_ev(name="fleet_request", cat="router", span_id=root_id,
                           trace_id=tid, parent_id=None, t0=tk, dur_s=0.050,
                           req_id=f"q{k}", status="ok", n_seeds=3, target=0))
        router.append(r_ev(name="route_decision", cat="router", span_id=f"rd{k}",
                           trace_id=tid, parent_id=root_id, t0=tk + 0.001,
                           dur_s=0.0005, req_id=f"q{k}", target=0))
        router.append(r_ev(name="predict_post", cat="http", span_id=post_id,
                           trace_id=tid, parent_id=root_id, t0=tk + 0.002,
                           dur_s=0.047, outcome="ok", attempts=1, send_ts=send))
        if k >= n:
            continue  # router-only trace: the replica leg is missing
        hid, qid = f"h{k}", f"rq{k}"
        replica.append(p_ev(name="predict_handler", cat="serve", span_id=hid,
                            trace_id=tid, parent_id=post_id, t0=tk + 0.003,
                            dur_s=0.045, send_ts=send, recv_ts=W + skew_s + tk + 0.003))
        replica.append(p_ev(name="request", cat="serve", span_id=qid, trace_id=tid,
                            parent_id=hid, t0=tk + 0.004, dur_s=0.043,
                            req_id=f"q{k}", flush_id=k, graph_seq=5 + k, model_seq=2))
        replica.append(p_ev(name="queue", cat="serve", span_id=f"qu{k}", trace_id=tid,
                            parent_id=qid, t0=tk + 0.004, dur_s=0.002))
        for name, st0, dur in (("sample", 0.006, 0.005), ("execute", 0.011, 0.030),
                               ("reply", 0.041, 0.003)):
            replica.append(p_ev(name=name, cat="stage", span_id=f"{name[0]}s{k}",
                                trace_id="replica-run", parent_id=None, t0=tk + st0,
                                dur_s=dur, flush_id=k))
    return (_mk(router, tmp_path / "router.jsonl"),
            _mk(replica, tmp_path / "replica.jsonl"))


def test_fleet_align_recovers_injected_skew(tmp_path):
    skew = 5.0
    paths = _fleet_streams(tmp_path, skew, n=4)
    streams = trace_timeline.load_streams(list(paths), fleet=True)
    router = next(s for s in streams if s.run_id == "router-run")
    rep = next(s for s in streams if s.run_id == "replica-run")
    # the router (most client hops) is the reference; the replica shifts
    # back by exactly the injected skew, bounded by RTT/2
    assert router.align == 0.0 and router.skew_bound == 0.0
    assert rep.align == pytest.approx(-skew, abs=1e-6)
    assert rep.skew_bound == pytest.approx(RTT_S / 2.0, abs=1e-6)
    assert rep.align_warning is None
    assert router.pid != rep.pid  # distinct Chrome pids, both rank 0
    trace = trace_timeline.chrome_trace(streams)
    assert trace_timeline.validate_chrome_trace(trace) > 0
    evs = trace["traceEvents"]
    post = next(e for e in evs if e.get("name") == "predict_post")
    handler = next(e for e in evs if e.get("name") == "predict_handler")
    assert post["ts"] <= handler["ts"] <= post["ts"] + post["dur"]


def test_clock_pairs_exclude_same_stream_links(tmp_path):
    """Replica-internal spans parent within their stream and must not
    enter the clock estimate."""
    paths = _fleet_streams(tmp_path, 2.0, n=2)
    streams = trace_timeline.load_streams(list(paths), fleet=False)
    pairs = trace_timeline.clock_pairs(streams)
    ridx = next(i for i, s in enumerate(streams) if s.run_id == "router-run")
    pidx = 1 - ridx
    assert set(pairs) == {(ridx, pidx)}  # only the cross-stream hop
    assert len(pairs[(ridx, pidx)]) == 2


def test_request_chains_join_overhead_and_lineage(tmp_path):
    paths = _fleet_streams(tmp_path, 5.0, n=3)
    streams = trace_timeline.load_streams(list(paths), fleet=True)
    merged = [e for s in streams for e in s.events]
    rep = trace_timeline.request_tracing_report(merged)
    assert rep["n_traces"] == 3 and rep["n_ok"] == 3
    assert rep["n_complete"] == 3 and rep["complete_frac"] == 1.0
    for c in rep["chains"]:
        assert c["complete"]
        assert c["total_ms"] == pytest.approx(50.0)
        # queue 2 + sample 5 + execute 30 + reply 3 (the batch stages
        # joined through (replica run_id, flush_id), not the trace id)
        assert c["replica_stage_sum_ms"] == pytest.approx(40.0)
        assert c["router_overhead_ms"] == pytest.approx(10.0)
        assert c["replica_run_id"] == "replica-run"
        assert c["model_seq"] == 2
    assert rep["router_overhead_p99_ms"] == pytest.approx(10.0)
    assert rep["graph_seqs"] == [5, 6, 7]
    block = "\n".join(trace_timeline.request_tracing_block(merged))
    assert "complete_chain_frac=1.000" in block
    assert "#lineage=graph_seq[5..7] model_seq[2]" in block
    j_streams = j_trace_timeline.load_streams(list(paths), fleet=True)
    assert j_trace_timeline.request_tracing_report(
        [e for s in j_streams for e in s.events]) == rep


def test_torn_replica_stream_and_missing_legs_warn_not_crash(tmp_path, capsys):
    router_p, replica_p = _fleet_streams(tmp_path, 0.5, n=2, router_only_extra=2)
    with open(replica_p, "a", encoding="utf-8") as fh:
        fh.write('{"event": "span", "run_id": "replica-run", "sch')
    out_chrome = tmp_path / "fleet.json"
    rc = trace_timeline.main([router_p, replica_p, "--fleet", "--json",
                              "--chrome", str(out_chrome)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    rt = out["request_tracing"]
    assert rt["n_traces"] == 4 and rt["n_complete"] == 2
    assert rt["complete_frac"] == pytest.approx(0.5)
    assert all(c["router_overhead_ms"] is None for c in rt["chains"] if not c["complete"])
    assert os.path.exists(out_chrome)
    rep_row = next(s for s in out["streams"] if s["run_id"] == "replica-run")
    assert rep_row["skew_bound_s"] == pytest.approx(RTT_S / 2.0, abs=1e-6)


def test_unreached_stream_gets_align_warning(tmp_path, capsys):
    router_p, replica_p = _fleet_streams(tmp_path, 1.0, n=2)
    lone = [
        {"event": "run_start", "run_id": "lone-run", "schema": schema.SCHEMA_VERSION,
         "seq": 0, "ts": W, "algorithm": "SERVE", "fingerprint": "f", "process_index": 0},
        _env("lone-run", 1, W + 10.5, name="execute", cat="stage", span_id="x0",
             trace_id="lone-run", parent_id=None, t0=10.0, dur_s=0.5, flush_id=0),
    ]
    lone_p = _mk(lone, tmp_path / "lone.jsonl")
    streams = trace_timeline.load_streams([router_p, replica_p, lone_p], fleet=True)
    capsys.readouterr()
    st = next(s for s in streams if s.run_id == "lone-run")
    assert st.align_warning is not None
    assert st.align == 0.0  # kept on its own clock, not guessed
    assert all(s.align_warning is None for s in streams if s.run_id != "lone-run")


@pytest.fixture()
def live_fleet_dirs(tmp_path, monkeypatch):
    """The port's router -> urllib -> the port's exporter -> a handler, in
    one process: two registries (router / replica) as two hosts."""
    from neutronstarlite_torch.obs.exporter import MetricsExporter
    from neutronstarlite_torch.obs.trace import Tracer
    from neutronstarlite_torch.serve.crosshost import CrossHostFleet, _RouterReplica

    monkeypatch.setenv("NTS_TRACE", "1")
    router_p = tmp_path / "router.jsonl"
    replica_p = tmp_path / "replica.jsonl"
    rep_reg = registry.MetricsRegistry("replica-run", path=str(replica_p))
    rep_tracer = Tracer(rep_reg)
    exp = MetricsExporter(rep_reg, port=0)
    flush = [0]

    def predict(payload, ctx=None):
        ids = payload.get("node_ids") or []
        fid = flush[0]
        flush[0] += 1
        h = rep_tracer.complete("request", dur_s=0.004, cat="serve", ctx=ctx,
                                req_id=f"q{fid:x}", status="ok", n_seeds=len(ids),
                                flush_id=fid, graph_seq=7, model_seq=42)
        rep_tracer.complete("queue", dur_s=0.001, cat="serve", parent=h, req_id=f"q{fid:x}")
        for name, d in (("sample", 0.001), ("execute", 0.002), ("reply", 0.0005)):
            rep_tracer.complete(name, dur_s=d, cat="serve", flush_id=fid)
        return 200, {"status": "ok", "values": [0.5] * len(ids), "dtype": "float32",
                     "req_id": f"q{fid:x}"}

    exp.bind_predict(predict)
    router_reg = registry.MetricsRegistry("router-run", path=str(router_p))
    fleet = CrossHostFleet([_RouterReplica(0, f"http://127.0.0.1:{exp.port}")],
                           registry=router_reg, start_polling=False)
    try:
        for _ in range(6):
            assert fleet.predict([1, 2, 3]) is not None
        fleet.hub.poll_once()
    finally:
        fleet.close()
        rep_reg.close()
        exp.close()
    yield str(router_p), str(replica_p)


def test_live_round_trip_yields_complete_chains(live_fleet_dirs):
    router_p, replica_p = live_fleet_dirs
    streams = trace_timeline.load_streams([router_p, replica_p], fleet=True)
    rep_st = next(s for s in streams if s.run_id == "replica-run")
    assert rep_st.skew_bound is not None  # same host: near zero, and bounded
    assert abs(rep_st.align) <= max(rep_st.skew_bound, 0.05)
    merged = [e for s in streams for e in s.events]
    rep = trace_timeline.request_tracing_report(merged)
    assert rep["n_ok"] == 6 and rep["complete_frac"] == 1.0
    assert rep["graph_seqs"] == [7] and rep["model_seqs"] == [42]
    for c in rep["chains"]:
        assert c["router_overhead_ms"] is not None
        assert c["n_sheds"] == 0
    trace = trace_timeline.chrome_trace(streams)
    assert trace_timeline.validate_chrome_trace(trace) > 0
    assert len({e.get("pid") for e in trace["traceEvents"]}) == 2
    # the reference's tool reads the port's streams to the same report
    j_streams = j_trace_timeline.load_streams([router_p, replica_p], fleet=True)
    j_rep = j_trace_timeline.request_tracing_report([e for s in j_streams for e in s.events])
    assert (j_rep["n_ok"], j_rep["n_complete"], j_rep["graph_seqs"]) == (
        rep["n_ok"], rep["n_complete"], rep["graph_seqs"])


def test_live_streams_render_report_block(live_fleet_dirs, capsys):
    """tools/metrics_report over the same two streams embeds the 'request
    tracing:' block."""
    from neutronstarlite_torch.tools.metrics_report import main as report

    router_p, replica_p = live_fleet_dirs
    assert report([router_p, replica_p]) == 0
    out = capsys.readouterr().out
    assert "request tracing:" in out
    assert "complete_chain_frac=1.000" in out
    assert "#lineage=graph_seq[7] model_seq[42]" in out
