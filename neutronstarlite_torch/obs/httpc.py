"""Shared retrying HTTP client for every cross-host surface.

Port of ``neutronstarlite_tpu/obs/httpc.py``, copied: only the import paths
differ.

Two subsystems talk HTTP to the fleet: the telemetry hub polls
``/telemetry`` (obs/hub.py) and the cross-host serve router scrapes the
same endpoint plus POSTs ``/predict`` (serve/crosshost.py). Before this
module each caller rolled its own single-shot urllib fetch, so one
dropped SYN — a replica mid-restart, a transient listen-queue overflow —
counted as a full missed poll. This client gives them ONE retry policy:

- a per-request socket timeout (``NTS_HTTPC_TIMEOUT_S``, default 5.0 —
  the hub's historical FETCH_TIMEOUT_S);
- bounded retries (``NTS_HTTPC_RETRIES``, default 2 retries after the
  first attempt) with the supervisor's jittered exponential backoff
  math reused verbatim (resilience/supervisor.backoff_jitter_frac):
  ``delay = base * 2**(attempt-1) * (1 + jitter)``, base
  ``NTS_HTTPC_BACKOFF_S`` (default 0.05 s — scrapes, not restarts);
- an overall per-call deadline (``deadline_s``) that bounds BOTH the
  in-flight request and any backoff sleep — a caller with a poll budget
  never overshoots it because a retry was in progress;
- a typed error taxonomy so callers can route on failure mode instead
  of string-matching urllib internals: :class:`HttpTimeout` (the socket
  timed out / the deadline expired mid-flight), :class:`HttpRefused`
  (connection refused / reset — the "process is dead" signal the router
  escalates), :class:`HttpStatusError` (an answer arrived but not 200 —
  carries ``.status``). All subclass :class:`HttpError` (an ``OSError``,
  so legacy ``except OSError`` call sites keep working).

Effect on the hub: ``_default_fetch`` now delegates here, turning
miss-on-first-blip into retry-then-miss — a target only burns one of
its ``NTS_HUB_MISS_K`` misses after the client's whole retry budget is
exhausted.

Chaos: every attempt passes through ``fault_point("http_fetch",
target=...)`` (resilience/faults), so ``net_drop@target=k`` (raises
refused) and ``slow_net@target=k,ms=`` (injects latency) exercise the
retry path, the miss-K escalation, and the router's re-route logic
end-to-end without touching a real socket fault.
"""

from __future__ import annotations

import errno as _errno
import os
import socket
import time
import urllib.error
import urllib.request
from typing import Optional

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("obs")

DEFAULT_TIMEOUT_S = 5.0
DEFAULT_RETRIES = 2
DEFAULT_BACKOFF_S = 0.05


class HttpError(OSError):
    """Base of the typed taxonomy (an OSError: legacy handlers match)."""


class HttpTimeout(HttpError):
    """The request (or the caller's deadline) timed out in flight."""


class HttpRefused(HttpError):
    """Connection refused/reset — nothing is listening at the target."""


class HttpStatusError(HttpError):
    """An HTTP answer arrived but with a non-200 status."""

    def __init__(self, status: int, url: str, detail: str = ""):
        super().__init__(f"HTTP {status} from {url}"
                         + (f": {detail}" if detail else ""))
        self.status = int(status)


def _env_pos_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return max(float(raw), 0.0)
    except ValueError:
        log.warning("bad %s=%r; using %g", name, raw, default)
        return default


def _env_pos_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return max(int(raw), 0)
    except ValueError:
        log.warning("bad %s=%r; using %d", name, raw, default)
        return default


def http_timeout_s() -> float:
    return _env_pos_float("NTS_HTTPC_TIMEOUT_S", DEFAULT_TIMEOUT_S)


def http_retries() -> int:
    return _env_pos_int("NTS_HTTPC_RETRIES", DEFAULT_RETRIES)


def http_backoff_s() -> float:
    return _env_pos_float("NTS_HTTPC_BACKOFF_S", DEFAULT_BACKOFF_S)


# connection-level "nobody home" errnos (refused, reset, aborted, no
# route): all mean the target process is not answering, which is the
# distinction the router's death-escalation cares about
_REFUSED_ERRNOS = frozenset({
    _errno.ECONNREFUSED, _errno.ECONNRESET, _errno.ECONNABORTED,
    _errno.EHOSTUNREACH, _errno.ENETUNREACH, _errno.EPIPE,
})


def _classify(exc: BaseException, url: str) -> HttpError:
    """Map the urllib/socket zoo onto the typed taxonomy."""
    if isinstance(exc, urllib.error.HTTPError):
        return HttpStatusError(exc.code, url, getattr(exc, "reason", ""))
    if isinstance(exc, urllib.error.URLError):
        exc = exc.reason if isinstance(exc.reason, BaseException) else exc
    if isinstance(exc, (socket.timeout, TimeoutError)):
        return HttpTimeout(f"timed out fetching {url}: {exc}")
    if isinstance(exc, ConnectionError):
        return HttpRefused(f"connection failed to {url}: {exc}")
    if isinstance(exc, OSError) and exc.errno in _REFUSED_ERRNOS:
        return HttpRefused(f"connection failed to {url}: {exc}")
    return HttpError(f"fetch failed for {url}: {exc}")


def error_class(exc: BaseException) -> str:
    """The span-attribute error taxonomy: timeout / refused / status /
    error — the retry-attribution tag on httpc's child spans and the
    router's suspect spans."""
    if isinstance(exc, HttpTimeout):
        return "timeout"
    if isinstance(exc, HttpRefused):
        return "refused"
    if isinstance(exc, HttpStatusError):
        return "status"
    return "error"


def fetch(url: str, *,
          timeout_s: Optional[float] = None,
          retries: Optional[int] = None,
          backoff_s: Optional[float] = None,
          deadline_s: Optional[float] = None,
          target: Optional[int] = None,
          data: Optional[bytes] = None,
          content_type: str = "application/json",
          tracer=None,
          ctx=None,
          span_name: str = "http_fetch") -> str:
    """GET (or POST, when ``data`` is given) ``url`` with retries.

    ``deadline_s`` bounds the WHOLE call (requests + backoff sleeps);
    ``target`` is the caller's integer index for this endpoint, matched
    by ``net_drop@target=k`` / ``slow_net@target=k`` fault specs. POSTs
    are retried like GETs — callers whose POST is not idempotent (the
    router's /predict) should pass ``retries=0`` and own re-dispatch.

    Distributed tracing (both optional, zero cost when absent):

    - ``tracer`` (obs/trace.Tracer) — the call emits one ``span_name``
      span covering the whole call (child of ``ctx`` / the caller's open
      span), plus one ``http_retry`` child span per FAILED attempt
      tagged with the :func:`error_class` (timeout/refused/status) and
      the backoff it cost;
    - ``ctx`` (obs/trace.TraceContext) — the trace crosses the wire:
      ``X-NTS-Trace-Id`` / ``X-NTS-Parent-Span`` / ``X-NTS-Send-Ts``
      headers are injected on every attempt (send_ts re-stamped per
      retry), parenting the server-side handler spans under this call's
      span. With a disabled tracer (``NTS_TRACE=0``) no context exists,
      no headers are added and no spans allocate — the hot path is
      byte-identical to the pre-tracing client.

    Raises the typed :class:`HttpError` subclass of the LAST attempt
    once the retry budget (or the deadline) is exhausted.
    """
    # lazy imports: obs.httpc is imported by obs/hub at module load, and
    # resilience/{faults,supervisor} import obs modules — a top-level
    # import here would be a cycle
    from neutronstarlite_torch.resilience import faults
    from neutronstarlite_torch.resilience.supervisor import backoff_jitter_frac

    timeout_s = http_timeout_s() if timeout_s is None else float(timeout_s)
    retries = http_retries() if retries is None else max(int(retries), 0)
    backoff_s = (http_backoff_s() if backoff_s is None
                 else max(float(backoff_s), 0.0))
    t0 = time.monotonic()

    trace_on = tracer is not None and getattr(tracer, "enabled", False)
    sid = None          # this call's span id (remote spans parent to it)
    hdr_ctx = None      # context serialized into the request headers
    emit_ctx = None     # context our own child retry spans emit under
    send_ts: Optional[float] = None
    if trace_on:
        from neutronstarlite_torch.obs.trace import TraceContext

        sid = tracer.next_id()
        trace_id = ctx.trace_id if ctx is not None else tracer.trace_id
        hdr_ctx = TraceContext(trace_id, sid)
        emit_ctx = TraceContext(trace_id, sid)
    elif ctx is not None:
        hdr_ctx = ctx

    def remaining() -> Optional[float]:
        if deadline_s is None:
            return None
        return deadline_s - (time.monotonic() - t0)

    def finish(outcome: str, status: Optional[int], attempts: int) -> None:
        if not trace_on:
            return
        attrs = {"url": url, "outcome": outcome, "attempts": attempts}
        if target is not None:
            attrs["target"] = target
        if status is not None:
            attrs["status"] = status
        if send_ts is not None:
            attrs["send_ts"] = send_ts
        tracer.complete(
            span_name, dur_s=time.monotonic() - t0, cat="http",
            span_id=sid, ctx=ctx, **attrs,
        )

    last: Optional[HttpError] = None
    attempt = 0
    for attempt in range(1, retries + 2):
        budget = remaining()
        if budget is not None and budget <= 0:
            err = last or HttpTimeout(
                f"deadline {deadline_s:g}s expired before fetching {url}"
            )
            finish(error_class(err), getattr(err, "status", None),
                   attempt - 1)
            raise err
        t_attempt = time.monotonic()
        try:
            # the chaos seam: net_drop raises refused here, slow_net
            # sleeps here — BEFORE the socket, so injected faults spend
            # the same retry/deadline budget a real one would
            faults.fault_point("http_fetch", target=target)
            req = urllib.request.Request(url, data=data)
            if data is not None:
                req.add_header("Content-Type", content_type)
            if hdr_ctx is not None:
                send_ts = time.time()  # re-stamped per attempt
                for k, v in hdr_ctx.to_headers(send_ts=send_ts).items():
                    req.add_header(k, v)
            t = timeout_s if budget is None else max(min(timeout_s, budget),
                                                     1e-3)
            with urllib.request.urlopen(req, timeout=t) as resp:
                if resp.status != 200:
                    raise HttpStatusError(resp.status, url)
                body = resp.read().decode("utf-8")
                finish("ok", 200, attempt)
                return body
        except HttpError as e:
            last = e
        except Exception as e:
            last = _classify(e, url)
        delay = 0.0
        will_retry = attempt <= retries
        if will_retry:
            delay = backoff_s * (2.0 ** (attempt - 1))
            delay *= 1.0 + backoff_jitter_frac(attempt)
            budget = remaining()
            if budget is not None:
                if budget <= 0:
                    will_retry = False
                    delay = 0.0
                else:
                    delay = min(delay, budget)
        if trace_on:
            # retry attribution: one child span per failed attempt, the
            # error class + the backoff it cost readable off the trace
            retry_attrs = {
                "attempt": attempt, "error": error_class(last),
                "backoff_s": delay if will_retry else 0.0,
                "will_retry": will_retry,
            }
            if isinstance(last, HttpStatusError):
                retry_attrs["status"] = last.status
            tracer.complete(
                "http_retry", dur_s=time.monotonic() - t_attempt,
                cat="http", ctx=emit_ctx, **retry_attrs,
            )
        if not will_retry:
            break
        if delay > 0:
            time.sleep(delay)
    assert last is not None
    finish(error_class(last), getattr(last, "status", None), attempt)
    raise last
