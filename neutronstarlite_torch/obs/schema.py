"""The JSONL event schema (versioned) and its validator.

Port of ``neutronstarlite_tpu/obs/schema.py``, copied: the same records, the same
validation and the same semantics (tests/test_torch_obs.py holds the two
copies against each other).

Every line a MetricsRegistry writes is one JSON object carrying the common
envelope plus kind-specific fields. tests/test_metrics.py validates live
runs against this module; tools/metrics_report uses it to reject garbage
before rendering. The schema is deliberately narrow — it pins the fields
consumers rely on and allows extra keys (forward compatibility).

Envelope (all events):
  event: str       one of run_start | epoch | ring_step | run_summary |
                   fault | recovery | heartbeat | rank_loss | replan |
                   serve_request | batch_flush | shed | serve_summary |
                   graph_delta | tune_trial | tune_decision | span |
                   stream_rotated | hist | slo_status | backend_probe |
                   program_cost | model_drift | tensor_stats |
                   nonfinite_provenance | telemetry | target_loss |
                   straggler | rollout | delta_commit | finetune_round |
                   epoch_scan
                   (open set)
  run_id: str      "<algo>-<fingerprint>-<pid>"
  schema: int      SCHEMA_VERSION
  ts: float        wall-clock seconds (time.time())
  seq: int         per-run monotonically increasing sequence number

epoch:
  epoch: int >= 0, seconds: number > 0, loss: number | null

epoch_scan (models/gcn_sample.py, SAMPLE_PIPELINE:fused): one fused
  lax.scan epoch — the whole draw→remap→gather→train loop ran as a
  single XLA dispatch with zero per-batch host→device transfer
  bucket: int > 0 (the per-epoch batch-count bucket the scan program
  was compiled for), batches: int > 0 (batches the scan consumed this
  epoch), dispatches: int > 0 (XLA dispatches for the epoch — the
  zero-H2D contract pins this to 1), h2d_bytes: int >= 0 (per-batch
  sample payload bytes shipped host→device inside the epoch — pinned
  to 0 in fused mode), epoch: int | absent, seconds: number | absent

ring_step (parallel/dist_ring_blocked.py): one rotation hop of the
  ring-pipelined exchange, per epoch — bytes shipped per device across
  that epoch's layer exchanges and the static skip verdict
  step: int > 0 (hop index; step 0 computes on the resident shard and
  ships nothing), bytes: int >= 0, skipped: bool | absent (compute at
  this step dropped by the static skip schedule),
  seconds: number | null (per-hop wall time is not separable inside one
  XLA program; comm_bench fills it from standalone measurement),
  epoch: int | absent,
  slab_cols: int > 0 | absent (the feature-slab columns this hop
  carried across all layer exchanges — sum of slab_width(w, Pf) on a
  2D (vertex x feature) mesh, the full widths on the 1D layout;
  parallel/partitioner.py; the mesh.* gauges carry the shape)

fault (resilience/): a detected or injected fault occurrence
  kind: str     nonfinite_loss | nonfinite_params | divergence | stall |
                crash | ckpt_corrupt (open set)
  epoch: int | absent, attempt: int | absent, injected: bool | absent

recovery (resilience/): a recovery action taken
  action: str   rollback | restart | resume | ckpt_fallback | giveup |
                replan | ckpt_retry (open set)
  epoch/attempt/step: int | absent

heartbeat (resilience/elastic.py): one partition's per-epoch liveness
  beat (NTS_ELASTIC=1)
  partition: int >= 0, epoch: int | absent,
  seconds: number | null | absent (that partition's measured step/epoch
  wall time, when the caller separates it — what obs/skew.py's straggler
  detector and the dashboard heat strip consume)

rank_loss (resilience/elastic.py): the liveness monitor declared a
  partition lost (missed-K heartbeats) or a collective timed out
  partition: int >= 0 | null (a collective timeout cannot attribute),
  reason: str (heartbeat_miss | collective_timeout, open set),
  epoch: int | absent, missed_beats: int | absent

replan (resilience/elastic.py): the supervisor rebuilt the distributed
  plan for the survivors at the rollback boundary
  from_partitions: int > 0, to_partitions: int > 0 (VERTEX partitions),
  lost: int | absent (the dropped partition),
  seconds: number | null (plan rebuild wall time),
  moved_vertices: int | absent (vertices that changed owner),
  from_mesh / to_mesh: str | absent (a 2D-mesh plan's replan is a MESH
  RESHAPE — the (Pv, Pf) labels before/after, e.g. "2x2" -> "3x1";
  parallel/partitioner.py)

serve_request (serve/): one answered (or shed) inference request
  n_seeds: int > 0, status: str (ok | cached | shed, open set),
  total_ms: number | null (null only for a request that never completed)

batch_flush (serve/): one micro-batch leaving the queue for the device
  n_requests: int > 0, n_seeds: int >= 0 (0 = fully cache-served),
  reason: str (size | deadline | drain), bucket: int | null (the AOT
  shape bucket executed; null when nothing reached the device)

shed (serve/): an overload rejection (bounded queue, reject-with-reason)
  reason: str, queue_depth: int | absent

serve_summary (serve/): consolidated end-of-serving record (the serving
  analog of run_summary; SLO telemetry)
  requests: int >= 0, shed: int >= 0,
  latency_ms: object with p50 / p95 / p99 (nullable),
  throughput_rps: number | null,
  counters: object (the registry snapshot: serve.* counters incl.
  per-bucket compile counts)

graph_delta (serve/delta.py): one live-graph update batch applied to a
  serving engine between flushes — the incremental-invalidation receipt
  (what changed, what was invalidated, the new digest the tuner/ledger
  keying now sees)
  added_edges / removed_edges / added_vertices: int >= 0,
  graph_digest: str (non-empty; the POST-delta canonical digest,
  graph/digest.py),
  cache_invalidated: int | absent (embedding-cache entries dropped —
  only the dirty out-closure, never the whole cache),
  rows_patched: int | absent (device neighbor-table rows rewritten;
  V on a shape-forced full rebuild),
  dirty_predictions: int | absent (vertices whose served logits may
  have changed),
  seconds: number | null (plan + apply wall time),
  replica: str | absent (the fleet replica this record's stream serves)

delta_commit (stream/ingest.py): one stream-log entry applied to this
  process's serving engines — the per-sequence-point receipt of the
  multi-writer delta log (stream/log.py). graph_delta records the
  server-side damage; delta_commit records the LOG's total-order facts:
  which writer's delta landed at which seq, under which dirty-closure
  mode, with the digest every replica must agree on
  seq: int > 0 (the log's total-order position),
  writer: str (non-empty; the committing WriterSession id),
  writer_seq: int > 0 (position within that writer's session),
  added_edges / removed_edges / added_vertices: int >= 0,
  graph_digest: str (non-empty; the canonical digest AT this seq —
  bitwise-identical to a fresh build, the replicated-apply oracle),
  dirty: int >= 0 | absent (dirty-region size this entry contributed),
  dirty_mode: str | absent (exact | bitset),
  fp_rate: number | absent (bitset mode's measured false-positive rate
  on an audited commit), seconds: number | null

finetune_round (stream/finetune.py): one completed continuous
  fine-tune drain — the dirty region between serve flushes trained
  through the sampled trainer's jitted step, checkpointed through the
  digest-verified path, and (when wired) published into the
  canary-gated rollout
  round: int >= 0,
  seq_lo / seq_hi: int >= 0 (the drained sequence range, inclusive),
  dirty: int >= 0 (dirty vertices drained),
  epochs: int > 0 (epochs-per-drain), batches: int >= 0,
  loss: number | null (last batch's loss),
  ckpt_step: int >= 0 (the published checkpoint step),
  verdict: str | null | absent (the rollout verdict when a publish
  hook is wired: promoted | canary_reject | ..., open set),
  seconds: number | null

tune_trial (tune/runner.py): one autotuner candidate scored — a timed
  micro-trial (source=measured), an analytic-prior-only entry
  (source=prior) when the candidate cannot be measured on this rig, or
  a candidate the prior cut below the trial budget (source=pruned)
  candidate: str (non-empty canonical tuple label,
  "dist_path|kernel|ell_levels|wire_dtype" with "-" for empty axes),
  family: str (non-empty; the tune-space family + trainer class),
  source: str (measured | prior | pruned, open set),
  seconds: number | null (warm trial step time; null for prior-only),
  predicted_bytes: int | absent (the analytic prior's byte score),
  partitions: int | absent

tune_decision (tune/select.py): the resolved auto-knob tuple a trainer
  will build with (DIST_PATH:auto / KERNEL:auto / WIRE_DTYPE:auto /
  ELL_LEVELS:auto), whether freshly measured, replayed from the
  persisted cache, or prior-derived (e.g. inside the elastic replan
  recovery path, which never measures)
  candidate: str (non-empty), family: str (non-empty),
  source: str (measured | cached | prior, open set),
  partitions: int > 0,
  seconds: number | null (the winning candidate's measured score),
  predicted_bytes: int | absent,
  decision: object | absent ({dist_path, kernel, ell_levels,
  wire_dtype} as strings — the concrete cfg values applied)

span (obs/trace.py): one completed interval on the causal timeline
  name: str (non-empty), cat: str (phase | lifecycle | epoch | stage |
  serve | ring | resilience | probe | sample, open set; cat=sample spans
  are the async sampling pipeline's sample_produce / h2d_copy /
  sample_wait intervals, sample/pipeline.py),
  span_id: str (non-empty, unique within the stream),
  trace_id: str (non-empty; defaults to the run_id),
  parent_id: str | null (the enclosing span),
  t0: number (time.perf_counter seconds at begin — monotonic,
  process-local; tools/trace_timeline maps it to wall clock via the
  envelope ts and aligns ranks on epoch spans),
  dur_s: number >= 0,
  rank: int | absent, thread: str | absent,
  send_ts: number | absent, recv_ts: number | absent (remote-parent
  link stamps, obs/trace.TraceContext: the caller's wall clock at HTTP
  send and this process's wall clock at receive — the NTP-style pair
  tools/trace_timeline --fleet uses to estimate per-process clock
  offset with an RTT/2 skew bound),
  graph_seq: int | absent, model_seq: int | absent (prediction
  freshness lineage: the last applied graph-delta sequence and the
  serving model's rollout sequence at execution time),
  plus open attribute fields

stream_rotated (obs/registry.py): the NTS_METRICS_MAX_MB size guard fired
  reason: str, rotated_to: str | null, bytes_written: int

hist (obs/hist.py): one CUMULATIVE snapshot of a log-bucketed mergeable
  latency histogram — within a stream the latest record per
  (run_id, name) supersedes earlier ones; records from different
  streams/ranks merge by bucket addition (that is what lets p99 survive
  NTS_METRICS_MAX_MB rotation and multi-rank runs)
  name: str (non-empty; e.g. serve.latency_ms), unit: str | absent,
  growth: number > 1 (bucket ratio; sqrt(growth)-1 is the relative
  quantile error bound, ~1% at the default 1.02),
  min_value: number > 0 (bucket-0 lower edge),
  count: int >= 0, sum: number, zero_count: int >= 0,
  min: number | null, max: number | null,
  buckets: array of [index, count] pairs (index int >= 0, count int > 0)

slo_status (obs/slo.py): one objective's burn-rate verdict — emitted on
  every state transition and on the objective's first evaluation
  (NTS_SLO_SPEC)
  objective: str (non-empty; the spec entry, e.g. serve_p99_ms<=75@5m),
  metric: str (non-empty), state: str (ok | breach, open set),
  threshold: number, window_s: number > 0,
  value: number | null (the window's observed value),
  burn_rate: number | null (long window), burn_rate_short: number | null,
  window_count: int | absent (samples in the window)

backend_probe (bench.py): one accelerator-backend probe attempt — the
  subprocess PJRT-init check bench runs before measuring; a timed-out
  probe (the stale-anchor cause) now leaves a typed trace
  attempt: int > 0, outcome: str (ok | timeout | error, open set),
  seconds: number >= 0 (attempt wall time),
  platform: str | null (the answering backend; null on failure),
  devices / error / init_s: open context fields

program_cost (obs/cost.py): one compiled/lowered XLA program's own cost
  numbers, captured once at build time per executable (train steps, ring
  bodies, serve AOT buckets, tuner micro-trials) and keyed by a stable
  program label — real per-executable FLOPs/bytes/memory next to the
  structural jaxpr pins
  label: str (non-empty; e.g. serve.bucket_16, fullbatch.train_step),
  available: bool (false = the backend exposed neither analysis — a
  degraded-capture record, never a crash),
  source: str (compiled | lowered | error, open set),
  flops: number | null, bytes_accessed: number | null,
  transcendentals: number | null,
  memory: object | null ({argument_bytes, output_bytes, temp_bytes,
  alias_bytes, generated_code_bytes, peak_bytes} nullable ints — the
  Compiled.memory_analysis() buffer allocation; null on the
  lowering-only capture path and on backends without it),
  platform: str | null | absent, error: str | absent

tensor_stats (obs/numerics.py): one tensor group's numerics snapshot —
  the stats-fused step output (params/grads/activations per layer, the
  global grad norm, wire payloads), fetched every NTS_NUMERICS_EVERY
  epochs under NTS_NUMERICS=1, or a NTS_QUANT_PROBE ring-payload probe,
  or a serve engine's non-finite-batch alarm
  name: str (non-empty; e.g. params/l0, grads/global, acts/l1,
  wire/l0, wire.payload/l0, serve/logits/bucket_16),
  finite_fraction: number in [0, 1],
  zero_fraction: number in [0, 1],
  absmax: number | null (null when the group itself went non-finite —
  finite_fraction says why),
  rms: number | null,
  epoch: int | absent,
  quant_rel_err: number | null | absent (wire payload groups only: the
  measured relative RMS error of the wire-dtype cast vs f32 — what
  tools/drift_audit compares against NTS_QUANT_TOL),
  grad_global_norm: number | null | absent (the grads/global group)

nonfinite_provenance (obs/numerics.py): the one-shot layer-by-layer
  eager replay's verdict after a nonfinite_loss/nonfinite_params guard
  trip — the FIRST layer/op that produced a non-finite value
  fault_kind: str (non-empty; nonfinite_loss | nonfinite_params),
  layer: int >= 0 | null (null: unattributed — no replay hook, or the
  non-finite value appeared only at the loss),
  op: str | null (params | activation | logits | loss, open set),
  name: str | null (the offending tap label, e.g. acts/l2),
  finite_fraction: number | null (of the offending tensor),
  checked: int >= 0 (taps examined before the verdict),
  epoch: int | null | absent, injected: bool | absent (a
  nan_loss@layer=k chaos poison was pending when the replay ran)

telemetry (obs/exporter.py /telemetry, obs/hub.py): one full-resolution
  scalar snapshot of a telemetry surface — the non-histogram half of the
  /telemetry endpoint (the hist/slo_status records travel alongside as
  their own typed lines) and the hub's per-poll merged fleet fact
  source: str (non-empty; exporter | hub, open set),
  counters/gauges: objects (the registry snapshot halves),
  timings: object | absent,
  health: object | absent (the /healthz payload facts: ok, liveness,
  supervisor — the heartbeat/liveness side of the snapshot),
  replica: str | absent (a fleet replica surface's label),
  targets / targets_ok / targets_lost: int >= 0 | absent (hub records
  only: fleet width and liveness at this poll),
  slo: object | absent (hub records: per-objective worst burn/state
  across targets), uptime_s: number | absent

target_loss (obs/hub.py): the hub's miss-K liveness verdict on one
  polled target — the cross-host analog of rank_loss (a dead TARGET is
  a typed record and a degraded merged view, never a hub exception)
  target: str (non-empty; the polled URL),
  reason: str (non-empty; poll_miss, open set),
  missed_polls: int > 0, miss_k: int > 0 | absent,
  last_ok_ts: number | null | absent (wall clock of the last good poll)

straggler (obs/skew.py): a partition's epoch time exceeded the fleet
  median by the k·MAD tolerance (perf_sentinel math) for M consecutive
  epochs — ADVISORY skew detection, slow-but-alive (a straggler still
  heartbeats; it is NOT a rank_loss and never trips elastic by itself)
  partition: int >= 0, epoch: int >= 0,
  seconds: number (the partition's epoch time),
  median_s: number (fleet median that epoch),
  mad_s: number | absent (median absolute deviation),
  threshold_s: number | absent (median * (1 + tolerance)),
  excess: number | absent (seconds/median - 1),
  consecutive: int > 0 (epochs over threshold in a row),
  source: str | absent (partition_step | heartbeat | ring_step)

rollout (serve/crosshost.py): one rolling model rollout attempt across
  the cross-host fleet — preflight (digest manifest) → canary
  (shadow-eval the candidate vs the serving model under NTS_CANARY_TOL)
  → sequential drain/restart — and where it ended. Exactly one record
  per rollout() call, whatever the outcome
  ckpt_dir: str (non-empty; the candidate checkpoint root),
  verdict: str (non-empty: promoted | preflight_reject | canary_reject |
  aborted | refused, open set),
  ckpt_step: int | null | absent (the candidate's step, once known),
  replicas: int >= 0 | absent (fleet width at rollout start),
  restarted: int >= 0 | absent (replicas running the candidate when the
  rollout ended — 0 for every refusal),
  rolled_back: int >= 0 | absent (replicas returned to the old model by
  an abort),
  canary: object | null | absent (the gate's evidence: disagreement /
  tolerance / seeds / passed),
  seconds: number | absent, error: str | absent (why it aborted)

model_drift (tools/drift_audit.py): an analytic prediction disagreed
  with what actually ran beyond the audit threshold — the record that
  turns the predict_all/predict_mesh priors and the wire gauges from
  trusted constants into audited models
  metric: str (non-empty; e.g. wire_bytes_fwd_per_epoch,
  tune_prior_ranking),
  predicted: number | null, observed: number | null,
  drift: number (signed fraction, observed/predicted - 1; for ranking
  drift, the measured slowdown of the prior's pick vs the measured
  best), threshold: number,
  source: str (wire_accounting | tune_prior | program_cost | staleness,
  open set),
  family / candidate / partitions / graph_digest / backend / layers /
  episode_run_id: open context fields (the tuning episode's cache-key
  facts when the stream carries them),
  flagged_entry: str | absent (the first tune-cache file marked for
  re-trial), flagged_entries: array | absent (all of them)

run_summary:
  algorithm: str, fingerprint: str,
  counters/gauges/timings: objects (the registry snapshot),
  epochs: int >= 0,
  epoch_time: object with first_s / warm_median_s / compile_overhead_s
              (nullable when fewer than 2 epochs ran),
  phases: object  name -> {total_s, count}  (PhaseTimers snapshot),
  memory: object  with "available" bool; explicit nulls where the backend
          exposes no memory_stats (CPU)
"""

from __future__ import annotations

from typing import Any, Dict

SCHEMA_VERSION = 1

# every typed record kind this schema pins fields for. The round-trip test
# (tests/test_schema_roundtrip.py) constructs + validates + report-renders
# one instance of each, so adding a kind here without renderer/test support
# fails tier-1 — the "no silently unrenderable records" contract.
KNOWN_KINDS = (
    "run_start",
    "epoch",
    "ring_step",
    "fault",
    "recovery",
    "heartbeat",
    "rank_loss",
    "replan",
    "serve_request",
    "batch_flush",
    "shed",
    "serve_summary",
    "graph_delta",
    "tune_trial",
    "tune_decision",
    "span",
    "stream_rotated",
    "hist",
    "slo_status",
    "backend_probe",
    "program_cost",
    "model_drift",
    "tensor_stats",
    "nonfinite_provenance",
    "telemetry",
    "target_loss",
    "straggler",
    "rollout",
    "delta_commit",
    "finetune_round",
    "epoch_scan",
    "run_summary",
)

_ENVELOPE = ("event", "run_id", "schema", "ts", "seq")


def _fail(msg: str) -> None:
    raise ValueError(f"metrics schema: {msg}")


def _require_number(obj: Dict[str, Any], key: str, allow_none: bool = False):
    v = obj.get(key)
    if v is None and allow_none:
        return
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        _fail(f"{obj.get('event')}.{key} must be a number, got {v!r}")


def validate_event(obj: Any) -> None:
    """Raise ValueError when ``obj`` is not a valid metrics event."""
    if not isinstance(obj, dict):
        _fail(f"event must be an object, got {type(obj).__name__}")
    for key in _ENVELOPE:
        if key not in obj:
            _fail(f"missing envelope field {key!r} in {obj!r}")
    if not isinstance(obj["event"], str) or not obj["event"]:
        _fail("event kind must be a non-empty string")
    if obj["schema"] != SCHEMA_VERSION:
        _fail(f"schema version {obj['schema']!r} != {SCHEMA_VERSION}")
    if not isinstance(obj["run_id"], str) or not obj["run_id"]:
        _fail("run_id must be a non-empty string")
    _require_number(obj, "ts")
    if not isinstance(obj["seq"], int) or obj["seq"] < 0:
        _fail(f"seq must be a non-negative int, got {obj['seq']!r}")

    kind = obj["event"]
    if kind == "epoch":
        if not isinstance(obj.get("epoch"), int) or obj["epoch"] < 0:
            _fail(f"epoch.epoch must be a non-negative int, got "
                  f"{obj.get('epoch')!r}")
        _require_number(obj, "seconds")
        if obj["seconds"] <= 0:
            _fail(f"epoch.seconds must be > 0, got {obj['seconds']!r}")
        _require_number(obj, "loss", allow_none=True)
    elif kind == "run_summary":
        for key in ("algorithm", "fingerprint"):
            if not isinstance(obj.get(key), str):
                _fail(f"run_summary.{key} must be a string")
        for key in ("counters", "gauges", "timings", "phases"):
            if not isinstance(obj.get(key), dict):
                _fail(f"run_summary.{key} must be an object")
        if not isinstance(obj.get("epochs"), int) or obj["epochs"] < 0:
            _fail("run_summary.epochs must be a non-negative int")
        et = obj.get("epoch_time")
        if not isinstance(et, dict):
            _fail("run_summary.epoch_time must be an object")
        for key in ("first_s", "warm_median_s", "compile_overhead_s"):
            if key not in et:
                _fail(f"run_summary.epoch_time missing {key!r}")
            _require_number(et, key, allow_none=True)
        mem = obj.get("memory")
        if not isinstance(mem, dict) or not isinstance(
            mem.get("available"), bool
        ):
            _fail("run_summary.memory must be an object with an "
                  "'available' bool")
    elif kind == "run_start":
        if not isinstance(obj.get("algorithm"), str):
            _fail("run_start.algorithm must be a string")
        if not isinstance(obj.get("fingerprint"), str):
            _fail("run_start.fingerprint must be a string")
    elif kind == "ring_step":
        if not isinstance(obj.get("step"), int) or obj["step"] <= 0:
            _fail(f"ring_step.step must be a positive int (hop index), "
                  f"got {obj.get('step')!r}")
        if not isinstance(obj.get("bytes"), int) or obj["bytes"] < 0:
            _fail(f"ring_step.bytes must be a non-negative int, got "
                  f"{obj.get('bytes')!r}")
        if "skipped" in obj and not isinstance(obj["skipped"], bool):
            _fail("ring_step.skipped must be a bool when present")
        _require_number(obj, "seconds", allow_none=True)
        if "epoch" in obj and obj["epoch"] is not None and not isinstance(
            obj["epoch"], int
        ):
            _fail("ring_step.epoch must be an int when present")
        sc = obj.get("slab_cols")
        if "slab_cols" in obj and (
            not isinstance(sc, int) or isinstance(sc, bool) or sc <= 0
        ):
            _fail(f"ring_step.slab_cols must be a positive int when "
                  f"present, got {sc!r}")
    elif kind == "fault":
        if not isinstance(obj.get("kind"), str) or not obj["kind"]:
            _fail("fault.kind must be a non-empty string")
        for key in ("epoch", "attempt"):
            if key in obj and obj[key] is not None and not isinstance(
                obj[key], int
            ):
                _fail(f"fault.{key} must be an int when present")
    elif kind == "recovery":
        if not isinstance(obj.get("action"), str) or not obj["action"]:
            _fail("recovery.action must be a non-empty string")
        for key in ("epoch", "attempt", "step"):
            if key in obj and obj[key] is not None and not isinstance(
                obj[key], int
            ):
                _fail(f"recovery.{key} must be an int when present")
    elif kind == "heartbeat":
        p = obj.get("partition")
        if not isinstance(p, int) or isinstance(p, bool) or p < 0:
            _fail(f"heartbeat.partition must be a non-negative int, got "
                  f"{p!r}")
        if "epoch" in obj and obj["epoch"] is not None and not isinstance(
            obj["epoch"], int
        ):
            _fail("heartbeat.epoch must be an int when present")
        if "seconds" in obj:
            _require_number(obj, "seconds", allow_none=True)
    elif kind == "rank_loss":
        p = obj.get("partition")
        if p is not None and (
            not isinstance(p, int) or isinstance(p, bool) or p < 0
        ):
            _fail(f"rank_loss.partition must be a non-negative int or "
                  f"null, got {p!r}")
        if not isinstance(obj.get("reason"), str) or not obj["reason"]:
            _fail("rank_loss.reason must be a non-empty string")
        for key in ("epoch", "missed_beats"):
            if key in obj and obj[key] is not None and not isinstance(
                obj[key], int
            ):
                _fail(f"rank_loss.{key} must be an int when present")
    elif kind == "replan":
        for key in ("from_partitions", "to_partitions"):
            v = obj.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                _fail(f"replan.{key} must be a positive int, got {v!r}")
        for key in ("lost", "moved_vertices", "epoch"):
            if key in obj and obj[key] is not None and not isinstance(
                obj[key], int
            ):
                _fail(f"replan.{key} must be an int when present")
        for key in ("from_mesh", "to_mesh"):
            if key in obj and (
                not isinstance(obj[key], str) or not obj[key]
            ):
                _fail(f"replan.{key} must be a non-empty string when "
                      "present")
        _require_number(obj, "seconds", allow_none=True)
    elif kind == "serve_request":
        if not isinstance(obj.get("n_seeds"), int) or obj["n_seeds"] <= 0:
            _fail(f"serve_request.n_seeds must be a positive int, got "
                  f"{obj.get('n_seeds')!r}")
        if not isinstance(obj.get("status"), str) or not obj["status"]:
            _fail("serve_request.status must be a non-empty string")
        _require_number(obj, "total_ms", allow_none=True)
    elif kind == "batch_flush":
        if not isinstance(obj.get("n_requests"), int) or obj["n_requests"] <= 0:
            _fail("batch_flush.n_requests must be a positive int")
        if not isinstance(obj.get("n_seeds"), int) or obj["n_seeds"] < 0:
            _fail("batch_flush.n_seeds must be a non-negative int")
        if not isinstance(obj.get("reason"), str) or not obj["reason"]:
            _fail("batch_flush.reason must be a non-empty string")
        b = obj.get("bucket")
        if b is not None and not isinstance(b, int):
            _fail(f"batch_flush.bucket must be an int or null, got {b!r}")
    elif kind == "epoch_scan":
        for key in ("bucket", "batches", "dispatches"):
            v = obj.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                _fail(f"epoch_scan.{key} must be a positive int, got "
                      f"{v!r}")
        hb = obj.get("h2d_bytes")
        if not isinstance(hb, int) or isinstance(hb, bool) or hb < 0:
            _fail(f"epoch_scan.h2d_bytes must be a non-negative int, got "
                  f"{hb!r}")
        if "epoch" in obj and (
            not isinstance(obj["epoch"], int) or isinstance(obj["epoch"], bool)
        ):
            _fail(f"epoch_scan.epoch must be an int when present, got "
                  f"{obj['epoch']!r}")
        if "seconds" in obj:
            _require_number(obj, "seconds", allow_none=True)
    elif kind == "shed":
        if not isinstance(obj.get("reason"), str) or not obj["reason"]:
            _fail("shed.reason must be a non-empty string")
        if "queue_depth" in obj and not isinstance(obj["queue_depth"], int):
            _fail("shed.queue_depth must be an int when present")
    elif kind == "graph_delta":
        for key in ("added_edges", "removed_edges", "added_vertices"):
            v = obj.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                _fail(f"graph_delta.{key} must be a non-negative int, "
                      f"got {v!r}")
        gd = obj.get("graph_digest")
        if not isinstance(gd, str) or not gd:
            _fail("graph_delta.graph_digest must be a non-empty string")
        for key in ("cache_invalidated", "rows_patched",
                    "dirty_predictions"):
            if key in obj and obj[key] is not None and (
                not isinstance(obj[key], int) or isinstance(obj[key], bool)
            ):
                _fail(f"graph_delta.{key} must be an int when present")
        _require_number(obj, "seconds", allow_none=True)
        if "replica" in obj and not isinstance(obj["replica"], str):
            _fail("graph_delta.replica must be a string when present")
    elif kind == "delta_commit":
        s = obj.get("seq")
        if not isinstance(s, int) or isinstance(s, bool) or s <= 0:
            _fail(f"delta_commit.seq must be a positive int, got {s!r}")
        if not isinstance(obj.get("writer"), str) or not obj["writer"]:
            _fail("delta_commit.writer must be a non-empty string")
        ws = obj.get("writer_seq")
        if not isinstance(ws, int) or isinstance(ws, bool) or ws <= 0:
            _fail(f"delta_commit.writer_seq must be a positive int, "
                  f"got {ws!r}")
        for key in ("added_edges", "removed_edges", "added_vertices"):
            v = obj.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                _fail(f"delta_commit.{key} must be a non-negative int, "
                      f"got {v!r}")
        gd = obj.get("graph_digest")
        if not isinstance(gd, str) or not gd:
            _fail("delta_commit.graph_digest must be a non-empty string")
        d = obj.get("dirty")
        if "dirty" in obj and (
            not isinstance(d, int) or isinstance(d, bool) or d < 0
        ):
            _fail(f"delta_commit.dirty must be a non-negative int when "
                  f"present, got {d!r}")
        if "dirty_mode" in obj and (
            not isinstance(obj["dirty_mode"], str) or not obj["dirty_mode"]
        ):
            _fail("delta_commit.dirty_mode must be a non-empty string "
                  "when present")
        if "fp_rate" in obj:
            _require_number(obj, "fp_rate", allow_none=True)
        _require_number(obj, "seconds", allow_none=True)
    elif kind == "finetune_round":
        r = obj.get("round")
        if not isinstance(r, int) or isinstance(r, bool) or r < 0:
            _fail(f"finetune_round.round must be a non-negative int, "
                  f"got {r!r}")
        for key in ("seq_lo", "seq_hi", "dirty", "batches", "ckpt_step"):
            v = obj.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                _fail(f"finetune_round.{key} must be a non-negative int, "
                      f"got {v!r}")
        e = obj.get("epochs")
        if not isinstance(e, int) or isinstance(e, bool) or e <= 0:
            _fail(f"finetune_round.epochs must be a positive int, got {e!r}")
        _require_number(obj, "loss", allow_none=True)
        if "verdict" in obj and obj["verdict"] is not None and (
            not isinstance(obj["verdict"], str) or not obj["verdict"]
        ):
            _fail("finetune_round.verdict must be a non-empty string or "
                  "null")
        _require_number(obj, "seconds", allow_none=True)
    elif kind in ("tune_trial", "tune_decision"):
        for key in ("candidate", "family", "source"):
            if not isinstance(obj.get(key), str) or not obj[key]:
                _fail(f"{kind}.{key} must be a non-empty string, got "
                      f"{obj.get(key)!r}")
        _require_number(obj, "seconds", allow_none=True)
        if "predicted_bytes" in obj and obj["predicted_bytes"] is not None \
                and not isinstance(obj["predicted_bytes"], int):
            _fail(f"{kind}.predicted_bytes must be an int when present")
        p = obj.get("partitions")
        if kind == "tune_decision":
            if not isinstance(p, int) or isinstance(p, bool) or p <= 0:
                _fail(f"tune_decision.partitions must be a positive int, "
                      f"got {p!r}")
            d = obj.get("decision")
            if d is not None and not isinstance(d, dict):
                _fail(f"tune_decision.decision must be an object, got {d!r}")
        elif p is not None and (not isinstance(p, int) or isinstance(p, bool)):
            _fail(f"tune_trial.partitions must be an int when present")
    elif kind == "span":
        for key in ("name", "cat", "span_id", "trace_id"):
            if not isinstance(obj.get(key), str) or not obj[key]:
                _fail(f"span.{key} must be a non-empty string, got "
                      f"{obj.get(key)!r}")
        pid_ = obj.get("parent_id")
        if pid_ is not None and (not isinstance(pid_, str) or not pid_):
            _fail(f"span.parent_id must be a non-empty string or null, "
                  f"got {pid_!r}")
        _require_number(obj, "t0")
        _require_number(obj, "dur_s")
        if obj["dur_s"] < 0:
            _fail(f"span.dur_s must be >= 0, got {obj['dur_s']!r}")
        if "rank" in obj and not isinstance(obj["rank"], int):
            _fail("span.rank must be an int when present")
        # remote-parent link stamps (obs/trace.TraceContext) — wall
        # clocks from TWO processes, so numbers, never required
        for key in ("send_ts", "recv_ts"):
            if key in obj and obj[key] is not None:
                _require_number(obj, key)
        # prediction freshness lineage rides serve-request spans
        for key in ("graph_seq", "model_seq"):
            if key in obj and obj[key] is not None and (
                    not isinstance(obj[key], int)
                    or isinstance(obj[key], bool)):
                _fail(f"span.{key} must be an int when present, "
                      f"got {obj[key]!r}")
    elif kind == "stream_rotated":
        if not isinstance(obj.get("reason"), str) or not obj["reason"]:
            _fail("stream_rotated.reason must be a non-empty string")
        if not isinstance(obj.get("bytes_written"), int):
            _fail("stream_rotated.bytes_written must be an int")
    elif kind == "hist":
        if not isinstance(obj.get("name"), str) or not obj["name"]:
            _fail("hist.name must be a non-empty string")
        _require_number(obj, "growth")
        if obj["growth"] <= 1:
            _fail(f"hist.growth must be > 1, got {obj['growth']!r}")
        _require_number(obj, "min_value")
        if obj["min_value"] <= 0:
            _fail(f"hist.min_value must be > 0, got {obj['min_value']!r}")
        for key in ("count", "zero_count"):
            v = obj.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                _fail(f"hist.{key} must be a non-negative int, got {v!r}")
        _require_number(obj, "sum")
        _require_number(obj, "min", allow_none=True)
        _require_number(obj, "max", allow_none=True)
        buckets = obj.get("buckets")
        if not isinstance(buckets, list):
            _fail(f"hist.buckets must be an array, got {buckets!r}")
        for pair in buckets:
            if (not isinstance(pair, (list, tuple)) or len(pair) != 2
                    or not all(isinstance(x, int) and not isinstance(x, bool)
                               for x in pair)
                    or pair[0] < 0 or pair[1] <= 0):
                _fail(f"hist.buckets entries must be [index>=0, count>0] "
                      f"int pairs, got {pair!r}")
    elif kind == "slo_status":
        for key in ("objective", "metric", "state"):
            if not isinstance(obj.get(key), str) or not obj[key]:
                _fail(f"slo_status.{key} must be a non-empty string, got "
                      f"{obj.get(key)!r}")
        _require_number(obj, "threshold")
        _require_number(obj, "window_s")
        if obj["window_s"] <= 0:
            _fail(f"slo_status.window_s must be > 0, got "
                  f"{obj['window_s']!r}")
        _require_number(obj, "value", allow_none=True)
        _require_number(obj, "burn_rate", allow_none=True)
        if "burn_rate_short" in obj:
            _require_number(obj, "burn_rate_short", allow_none=True)
        if "window_count" in obj and obj["window_count"] is not None \
                and not isinstance(obj["window_count"], int):
            _fail("slo_status.window_count must be an int when present")
    elif kind == "backend_probe":
        a = obj.get("attempt")
        if not isinstance(a, int) or isinstance(a, bool) or a <= 0:
            _fail(f"backend_probe.attempt must be a positive int, got {a!r}")
        if not isinstance(obj.get("outcome"), str) or not obj["outcome"]:
            _fail("backend_probe.outcome must be a non-empty string")
        _require_number(obj, "seconds")
        if obj["seconds"] < 0:
            _fail(f"backend_probe.seconds must be >= 0, got "
                  f"{obj['seconds']!r}")
        p = obj.get("platform")
        if p is not None and not isinstance(p, str):
            _fail(f"backend_probe.platform must be a string or null, "
                  f"got {p!r}")
    elif kind == "program_cost":
        if not isinstance(obj.get("label"), str) or not obj["label"]:
            _fail("program_cost.label must be a non-empty string")
        if not isinstance(obj.get("available"), bool):
            _fail(f"program_cost.available must be a bool, got "
                  f"{obj.get('available')!r}")
        if not isinstance(obj.get("source"), str) or not obj["source"]:
            _fail("program_cost.source must be a non-empty string")
        for key in ("flops", "bytes_accessed", "transcendentals"):
            _require_number(obj, key, allow_none=True)
        mem = obj.get("memory")
        if mem is not None:
            if not isinstance(mem, dict):
                _fail(f"program_cost.memory must be an object or null, "
                      f"got {mem!r}")
            for k, v in mem.items():
                if v is not None and (
                    not isinstance(v, int) or isinstance(v, bool)
                ):
                    _fail(f"program_cost.memory.{k} must be an int or "
                          f"null, got {v!r}")
    elif kind == "tensor_stats":
        if not isinstance(obj.get("name"), str) or not obj["name"]:
            _fail("tensor_stats.name must be a non-empty string")
        for key in ("finite_fraction", "zero_fraction"):
            _require_number(obj, key)
            if not (0.0 <= obj[key] <= 1.0):
                _fail(f"tensor_stats.{key} must be in [0, 1], got "
                      f"{obj[key]!r}")
        _require_number(obj, "absmax", allow_none=True)
        _require_number(obj, "rms", allow_none=True)
        if "epoch" in obj and obj["epoch"] is not None and not isinstance(
            obj["epoch"], int
        ):
            _fail("tensor_stats.epoch must be an int when present")
        for key in ("quant_rel_err", "grad_global_norm"):
            if key in obj:
                _require_number(obj, key, allow_none=True)
    elif kind == "nonfinite_provenance":
        fk = obj.get("fault_kind")
        if not isinstance(fk, str) or not fk:
            _fail("nonfinite_provenance.fault_kind must be a non-empty "
                  "string")
        lyr = obj.get("layer")
        if lyr is not None and (
            not isinstance(lyr, int) or isinstance(lyr, bool) or lyr < 0
        ):
            _fail(f"nonfinite_provenance.layer must be a non-negative int "
                  f"or null, got {lyr!r}")
        for key in ("op", "name"):
            v = obj.get(key)
            if v is not None and not isinstance(v, str):
                _fail(f"nonfinite_provenance.{key} must be a string or "
                      f"null, got {v!r}")
        _require_number(obj, "finite_fraction", allow_none=True)
        ck = obj.get("checked")
        if not isinstance(ck, int) or isinstance(ck, bool) or ck < 0:
            _fail(f"nonfinite_provenance.checked must be a non-negative "
                  f"int, got {ck!r}")
        if "epoch" in obj and obj["epoch"] is not None and not isinstance(
            obj["epoch"], int
        ):
            _fail("nonfinite_provenance.epoch must be an int when present")
        if "injected" in obj and not isinstance(obj["injected"], bool):
            _fail("nonfinite_provenance.injected must be a bool when "
                  "present")
    elif kind == "telemetry":
        if not isinstance(obj.get("source"), str) or not obj["source"]:
            _fail("telemetry.source must be a non-empty string")
        for key in ("counters", "gauges"):
            if not isinstance(obj.get(key), dict):
                _fail(f"telemetry.{key} must be an object, got "
                      f"{obj.get(key)!r}")
        for key in ("timings", "health", "slo"):
            if key in obj and obj[key] is not None and not isinstance(
                obj[key], dict
            ):
                _fail(f"telemetry.{key} must be an object when present")
        if "replica" in obj and obj["replica"] is not None and not isinstance(
            obj["replica"], str
        ):
            _fail("telemetry.replica must be a string when present")
        for key in ("targets", "targets_ok", "targets_lost"):
            v = obj.get(key)
            if key in obj and (
                not isinstance(v, int) or isinstance(v, bool) or v < 0
            ):
                _fail(f"telemetry.{key} must be a non-negative int when "
                      f"present, got {v!r}")
        if "uptime_s" in obj:
            _require_number(obj, "uptime_s", allow_none=True)
    elif kind == "target_loss":
        if not isinstance(obj.get("target"), str) or not obj["target"]:
            _fail("target_loss.target must be a non-empty string")
        if not isinstance(obj.get("reason"), str) or not obj["reason"]:
            _fail("target_loss.reason must be a non-empty string")
        mp = obj.get("missed_polls")
        if not isinstance(mp, int) or isinstance(mp, bool) or mp <= 0:
            _fail(f"target_loss.missed_polls must be a positive int, got "
                  f"{mp!r}")
        mk = obj.get("miss_k")
        if "miss_k" in obj and (
            not isinstance(mk, int) or isinstance(mk, bool) or mk <= 0
        ):
            _fail(f"target_loss.miss_k must be a positive int when "
                  f"present, got {mk!r}")
        if "last_ok_ts" in obj:
            _require_number(obj, "last_ok_ts", allow_none=True)
    elif kind == "straggler":
        p = obj.get("partition")
        if not isinstance(p, int) or isinstance(p, bool) or p < 0:
            _fail(f"straggler.partition must be a non-negative int, got "
                  f"{p!r}")
        ep = obj.get("epoch")
        if not isinstance(ep, int) or isinstance(ep, bool) or ep < 0:
            _fail(f"straggler.epoch must be a non-negative int, got "
                  f"{ep!r}")
        _require_number(obj, "seconds")
        _require_number(obj, "median_s")
        for key in ("mad_s", "threshold_s", "excess"):
            if key in obj:
                _require_number(obj, key, allow_none=True)
        c = obj.get("consecutive")
        if not isinstance(c, int) or isinstance(c, bool) or c <= 0:
            _fail(f"straggler.consecutive must be a positive int, got "
                  f"{c!r}")
        if "source" in obj and not isinstance(obj["source"], str):
            _fail("straggler.source must be a string when present")
    elif kind == "rollout":
        if not isinstance(obj.get("ckpt_dir"), str) or not obj["ckpt_dir"]:
            _fail("rollout.ckpt_dir must be a non-empty string")
        if not isinstance(obj.get("verdict"), str) or not obj["verdict"]:
            _fail("rollout.verdict must be a non-empty string")
        for key in ("replicas", "restarted", "rolled_back"):
            v = obj.get(key)
            if key in obj and (
                not isinstance(v, int) or isinstance(v, bool) or v < 0
            ):
                _fail(f"rollout.{key} must be a non-negative int when "
                      f"present, got {v!r}")
        if "ckpt_step" in obj:
            v = obj.get("ckpt_step")
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, int)):
                _fail(f"rollout.ckpt_step must be an int or null, got {v!r}")
        if "canary" in obj and obj["canary"] is not None \
                and not isinstance(obj["canary"], dict):
            _fail("rollout.canary must be an object or null")
        if "seconds" in obj:
            _require_number(obj, "seconds", allow_none=True)
        if "error" in obj and obj["error"] is not None \
                and not isinstance(obj["error"], str):
            _fail("rollout.error must be a string when present")
    elif kind == "model_drift":
        if not isinstance(obj.get("metric"), str) or not obj["metric"]:
            _fail("model_drift.metric must be a non-empty string")
        if not isinstance(obj.get("source"), str) or not obj["source"]:
            _fail("model_drift.source must be a non-empty string")
        _require_number(obj, "predicted", allow_none=True)
        _require_number(obj, "observed", allow_none=True)
        _require_number(obj, "drift")
        _require_number(obj, "threshold")
    elif kind == "serve_summary":
        for key in ("requests", "shed"):
            if not isinstance(obj.get(key), int) or obj[key] < 0:
                _fail(f"serve_summary.{key} must be a non-negative int")
        lat = obj.get("latency_ms")
        if not isinstance(lat, dict):
            _fail("serve_summary.latency_ms must be an object")
        for key in ("p50", "p95", "p99"):
            if key not in lat:
                _fail(f"serve_summary.latency_ms missing {key!r}")
            _require_number(lat, key, allow_none=True)
        _require_number(obj, "throughput_rps", allow_none=True)
        if not isinstance(obj.get("counters"), dict):
            _fail("serve_summary.counters must be an object")


def validate_stream(events) -> int:
    """Validate an iterable of events; returns the count (ValueError on the
    first bad record)."""
    n = 0
    for obj in events:
        validate_event(obj)
        n += 1
    return n
