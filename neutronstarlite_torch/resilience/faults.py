"""Deterministic, spec-driven fault injection (``NTS_FAULT_SPEC``) — port of
``neutronstarlite_tpu/resilience/faults.py``.

``NTS_FAULT_SPEC`` holds entries such as

    nan_loss@epoch=3;crash@epoch=5,rank=0;ckpt_corrupt@save=1;stall@epoch=2,ms=5000

each ``kind`` or ``kind@key=value,...``, and the run loops call named
:func:`fault_point` hooks where the entries fire. The parser accepts and
rejects exactly what the reference's does. The port runs these kinds:

============ ========================== =====================================
kind         args                       effect at its fault point
============ ========================== =====================================
nan_loss     epoch, layer (optional)    replaces the epoch loss with NaN;
                                        with ``layer=k`` it also arms the
                                        provenance poison, which the
                                        replay (obs/numerics) applies at
                                        layer k, so the
                                        ``nonfinite_provenance`` record
                                        must name layer k
crash        epoch, rank (optional)     ``os._exit(41)``: the simulated kill
stall        epoch, ms (default 1000)   sleeps ms inside the epoch
exc          epoch, point (optional)    raises RuntimeError at its point
ckpt_corrupt save (1-based save index)  bit-flips the just-published
                                        arrays.npz
rank_loss    epoch, partition           kills one partition of the sim twin
             (default 0)                (resilience/elastic.kill_partition):
                                        its heartbeats stop and the liveness
                                        monitor detects the loss; partition
                                        is in the original launch numbering
slow_rank    epoch, partition           sleeps ms inside one partition's
             (default 0), ms, times     ``partition_step``: slow, not dead
                                        (it keeps beating), so the straggler
                                        detector (obs/skew) must name it;
                                        ``times=M`` outlasts its latch
net_drop     target (optional), times   raises ConnectionRefusedError at
                                        ``http_fetch`` (obs/httpc): one HTTP
                                        attempt sees a refused connection;
                                        ``target=k`` hits only fetches of
                                        the caller's target k, ``times=M``
                                        outlasts the client's retries
slow_net     target (optional), ms,     sleeps ms at ``http_fetch`` before
             times                      the socket opens: slow, not dead
writer_crash seq (optional)             ``os._exit(41)`` at ``delta_commit``,
                                        between the two halves of that log
                                        entry's line (stream/log.py): the
                                        tail is left torn
============ ========================== =====================================

Common args: ``times`` (default 1: a spec fires once, so a supervised
retry replays the same epochs without the fault) and ``point`` (another
planted point). The port plants ``epoch_loss`` (the run loops, after the
step), ``save`` (``utils/checkpoint.save_checkpoint``, after the step
directory is published), ``sample_produce`` (the sampling pipeline's
producer, before each batch is staged), ``partition_step`` (the
distributed trainers' per-partition step timing, once per epoch and live
partition, with ``partition=`` the partition: an injected sleep lands in
that partition's measured seconds alone), ``delta_commit`` (the delta log's
tail append, with ``seq=`` the entry's sequence number), ``finetune_round``
(each fine-tune worker round, with ``epoch=`` the round) and ``http_fetch``
(obs/httpc, once per HTTP attempt before the socket opens, with ``target=``
the caller's index of the endpoint).

The plan, its fired counts and the save counter are process-global on
purpose: a supervised retry in the same process must see the fired counts.
Tests call :func:`reset` between scenarios.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

from neutronstarlite_torch.resilience import events
from neutronstarlite_torch.utils.logging import get_logger, process_index

log = get_logger("faults")

FAULT_KINDS = ("nan_loss", "crash", "stall", "ckpt_corrupt", "exc",
               "rank_loss", "slow_rank", "net_drop", "slow_net",
               "writer_crash")

# every point planted in the reference; a spec naming any other point
# would never fire, so the parser refuses it
FAULT_POINTS = ("epoch_loss", "save", "sample_produce", "partition_step",
                "http_fetch", "delta_commit", "finetune_round")

DEFAULT_POINTS = {
    "nan_loss": "epoch_loss",
    "crash": "epoch_loss",
    "stall": "epoch_loss",
    "exc": "epoch_loss",
    "ckpt_corrupt": "save",
    "rank_loss": "epoch_loss",
    "slow_rank": "partition_step",
    "net_drop": "http_fetch",
    "slow_net": "http_fetch",
    "writer_crash": "delta_commit",
}

# exit code of a simulated crash, told apart from a real failure's 1
CRASH_EXIT_CODE = int(os.environ.get("NTS_CRASH_EXIT_CODE", "41"))


@dataclasses.dataclass
class FaultSpec:
    kind: str
    epoch: Optional[int] = None  # fire at this epoch (None: first chance)
    rank: Optional[int] = None  # crash: only on this process index
    save: Optional[int] = None  # ckpt_corrupt: 1-based save counter
    ms: float = 1000.0  # stall / slow_rank: sleep duration
    partition: Optional[int] = None  # rank_loss / slow_rank
    layer: Optional[int] = None  # nan_loss: poison the provenance replay at this layer
    target: Optional[int] = None  # net_drop / slow_net
    seq: Optional[int] = None  # writer_crash
    times: int = 1  # max firings (one-shot by default)
    point: Optional[str] = None  # fire at this point (default DEFAULT_POINTS)
    fired: int = 0

    def exhausted(self) -> bool:
        return self.fired >= self.times


_INT_ARGS = ("epoch", "rank", "save", "times", "partition", "layer",
             "target", "seq")
_ALLOWED_ARGS = frozenset(_INT_ARGS) | {"ms", "point"}


def parse_fault_spec(text: str) -> List[FaultSpec]:
    """Parse the ``NTS_FAULT_SPEC`` grammar; raises ValueError on an
    unknown kind or point or a malformed argument."""
    specs: List[FaultSpec] = []
    for entry in (text or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        kind, _, argstr = entry.partition("@")
        kind = kind.strip()
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in NTS_FAULT_SPEC entry "
                f"{entry!r}; known: {FAULT_KINDS}"
            )
        spec = FaultSpec(kind=kind)
        for arg in argstr.split(","):
            arg = arg.strip()
            if not arg:
                continue
            key, eq, value = arg.partition("=")
            key = key.strip()
            # an allowlist: the dataclass internals (kind, fired,
            # exhausted) are not settable from the environment
            if not eq or key not in _ALLOWED_ARGS:
                raise ValueError(
                    f"bad fault arg {arg!r} in NTS_FAULT_SPEC entry {entry!r}"
                )
            try:
                setattr(
                    spec, key,
                    int(value) if key in _INT_ARGS else float(value)
                    if key == "ms" else value,
                )
            except ValueError:
                raise ValueError(
                    f"bad fault arg value {arg!r} in NTS_FAULT_SPEC entry "
                    f"{entry!r}"
                ) from None
        if spec.point is not None and spec.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {spec.point!r} in NTS_FAULT_SPEC "
                f"entry {entry!r}; planted points: {FAULT_POINTS}"
            )
        specs.append(spec)
    return specs


# ---- process-global plan ---------------------------------------------------

_plan: Optional[List[FaultSpec]] = None
_plan_src: Optional[str] = None
_save_count = 0
# the pending layer poison a ``nan_loss@layer=k`` firing arms: consumed by
# the one-shot provenance replay (obs/numerics.capture_provenance), which
# applies it inside the replayed forward through ``poison_hook``
_layer_poison: Optional[int] = None


def pending_layer_poison() -> Optional[int]:
    """The layer index a fired ``nan_loss@layer=k`` spec armed, or None."""
    return _layer_poison


def clear_layer_poison() -> None:
    """Consume the pending poison (the provenance replay's one-shot)."""
    global _layer_poison
    _layer_poison = None


def reset() -> None:
    """Forget the parsed plan, the fired and save counters and a pending
    poison (tests)."""
    global _plan, _plan_src, _save_count, _layer_poison
    _plan = None
    _plan_src = None
    _save_count = 0
    _layer_poison = None


def active_plan() -> List[FaultSpec]:
    """The plan of the current ``NTS_FAULT_SPEC``; parsed anew,
    with fresh fired counts, whenever the variable changes."""
    global _plan, _plan_src
    src = os.environ.get("NTS_FAULT_SPEC", "")
    if _plan is None or src != _plan_src:
        _plan, _plan_src = parse_fault_spec(src), src
        if _plan:
            log.warning("fault injection armed: %s", src)
    return _plan


def _corrupt_file(path: str) -> None:
    """Bit-flip a 64-byte window in the middle of ``path`` (a file under
    256 bytes is truncated instead)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        if size >= 256:
            fh.seek(size // 2)
            window = fh.read(64)
            fh.seek(size // 2)
            fh.write(bytes(b ^ 0xFF for b in window))
        else:
            fh.truncate(max(size // 2, 1))


def _epoch_matches(spec: FaultSpec, epoch: Optional[int]) -> bool:
    return spec.epoch is None or spec.epoch == epoch


def fault_point(point: str, *, epoch: Optional[int] = None, value=None,
                path: Optional[str] = None, partition: Optional[int] = None,
                target: Optional[int] = None, seq: Optional[int] = None):
    """Named injection hook: matching specs of the active plan fire (at
    most ``times`` each) and may replace ``value`` (the epoch loss), sleep,
    raise, corrupt ``path``, kill a sim partition or end the process.
    ``partition`` is the ``partition_step`` point's context (slow_rank
    matches it); ``target`` the ``http_fetch`` point's (net_drop and
    slow_net match it); ``seq`` the ``delta_commit`` point's (writer_crash
    matches it). Returns ``value`` unchanged when ``NTS_FAULT_SPEC`` is
    unset."""
    plan = active_plan()
    if not plan:
        return value
    global _save_count
    if point == "save":
        _save_count += 1
    for spec in plan:
        if spec.exhausted() or (spec.point or DEFAULT_POINTS[spec.kind]) != point:
            continue
        if spec.kind == "ckpt_corrupt":
            if (spec.save is not None and spec.save != _save_count) or path is None:
                continue
            spec.fired += 1
            log.warning("injecting checkpoint corruption into %s (save #%d)",
                        path, _save_count)
            _corrupt_file(path)
            continue
        if spec.kind == "writer_crash":
            if spec.seq is not None and spec.seq != seq:
                continue
            spec.fired += 1
            # like crash, the record can only come from the injection site;
            # the point is planted mid entry write, so the log's tail holds
            # a torn line that recovery must drop
            events.emit_fault("writer_crash", point=point, seq=seq, injected=True,
                              rank=process_index())
            log.warning("injecting writer crash mid-commit of seq %s (exit %d)", seq,
                        CRASH_EXIT_CODE)
            os._exit(CRASH_EXIT_CODE)
        if spec.kind in ("net_drop", "slow_net"):
            if spec.target is not None and spec.target != target:
                continue
            spec.fired += 1
            # the injection-site record; the detection records are the
            # caller's (the hub's miss-K target_loss, the router's re-route)
            events.emit_fault(spec.kind, point=point, target=target, injected=True,
                              rank=process_index())
            if spec.kind == "net_drop":
                log.warning("injecting net drop: refusing HTTP fetch of target %s", target)
                raise ConnectionRefusedError(
                    f"injected fault: net_drop at point {point!r} (target {target})"
                )
            # slow, not dead: the fetch goes on after the sleep
            log.warning("injecting %.0f ms scrape latency into target %s", spec.ms, target)
            time.sleep(spec.ms / 1000.0)
            continue
        if not _epoch_matches(spec, epoch):
            continue
        if spec.kind == "crash" and spec.rank is not None and spec.rank != process_index():
            continue
        if spec.kind == "slow_rank" and (spec.partition or 0) != partition:
            continue
        spec.fired += 1
        if spec.kind == "nan_loss":
            if spec.layer is not None:
                global _layer_poison
                _layer_poison = spec.layer
                log.warning("injecting nan_loss at epoch %s (provenance poison armed "
                            "for layer %d)", epoch, spec.layer)
            else:
                log.warning("injecting nan_loss at epoch %s", epoch)
            value = float("nan")
        elif spec.kind == "stall":
            log.warning("injecting %.0f ms stall at epoch %s", spec.ms, epoch)
            time.sleep(spec.ms / 1000.0)
        elif spec.kind == "exc":
            events.emit_fault("exc", point=point, epoch=epoch, injected=True,
                              rank=process_index())
            log.warning("injecting exception at point %s (epoch %s)", point, epoch)
            raise RuntimeError(
                f"injected fault: exc at point {point!r} (epoch {epoch})"
            )
        elif spec.kind == "rank_loss":
            part = spec.partition or 0
            # the injection-site record; the detection record is the
            # liveness monitor's rank_loss, once the missed beats reach K
            events.emit_fault("rank_loss", point=point, epoch=epoch, partition=part,
                              injected=True, rank=process_index())
            log.warning("injecting rank loss: killing sim partition %d at epoch %s",
                        part, epoch)
            from neutronstarlite_torch.resilience import elastic

            elastic.kill_partition(part)
        elif spec.kind == "slow_rank":
            # slow, not dead: the sleep lands in this partition's measured
            # step time while its heartbeats keep flowing
            events.emit_fault("slow_rank", point=point, epoch=epoch, partition=partition,
                              injected=True, rank=process_index())
            log.warning("injecting %.0f ms straggler sleep into partition %s at epoch %s",
                        spec.ms, partition, epoch)
            time.sleep(spec.ms / 1000.0)
        elif spec.kind == "crash":
            # nothing survives the exit to detect it, so the record comes
            # from the injection site
            events.emit_fault("crash", point=point, epoch=epoch, injected=True,
                              rank=process_index())
            log.warning("injecting crash at epoch %s (exit %d)", epoch,
                        CRASH_EXIT_CODE)
            os._exit(CRASH_EXIT_CODE)
    return value
