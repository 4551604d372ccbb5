"""Auto-knob resolution: the hook the trainer's funnel and the elastic
replan consult — port of ``neutronstarlite_tpu/tune/select.py``.

``resolve_auto_knobs(toolkit)`` runs right after the trainer's host graph
exists and again, as a no-op, at the head of ``_finalize_datum``, before
any table of a route is built and before the funnel's checks. It folds
``NTS_MESH`` into the cfg, then turns every ``auto`` axis into a concrete
value:

- ``NTS_TUNE=off`` (the default): ``DIST_PATH:auto`` keeps its legacy
  meaning (the ``COMM_LAYER`` rule); any other ``auto`` axis is refused,
  since a knob only the tuner resolves must not fall back to a default
  while the user benchmarks it as tuned.
- ``NTS_TUNE=cached``: the persisted cache (``tune/cache.py``); on a miss
  the analytic prior decides (no device work, not stored).
- ``NTS_TUNE=measure``: the cache; on a miss the funnel-valid space is
  enumerated, pruned by the prior, timed (``tune/runner.py``), the best
  measured candidate taken and stored. On ranks every rank measures, the
  scores are all-reduced with MAX, and world rank 0 alone writes the entry.

Either way one ``tune_decision`` record (candidate, source measured,
cached or prior, score) lands in the stream, with the ``tune.decision``,
``tune.decision_source`` and ``tune.partitions`` gauges. The funnel's
checks then run on the concrete values, so a corrupt entry dies at the
same refusal a hand-written cfg would.

``reconsult_for_replan(toolkit)``: after a survivor replan shrank the
plan to P' = P - 1, the axes the tuner resolved are resolved again for P':
a cached P' entry, else the prior (``source=prior``); nothing is measured
in the recovery path.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Set

from neutronstarlite_torch.tune import cache, runner, space
from neutronstarlite_torch.utils.config import tuner_off_refusal
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("tune")


def _simulate_active(toolkit) -> bool:
    """Whether the trainer runs the collective-free twin."""
    if getattr(toolkit.cfg, "dist_path", "") == "ring_blocked_sim":
        return True
    return os.environ.get("NTS_DIST_SIMULATE", "0") == "1"


def _partition_count(toolkit) -> int:
    """The P a decision is keyed by, the trainer's device budget: ``Pv*Pf``
    of a concrete MESH, else PARTITIONS, else the twin's default 2 or the
    world size; 1 for the single-device families."""
    fam = space.family_of(type(toolkit))
    if fam not in ("dist_dense", "edge_dist"):
        return 1
    mesh_v = space._norm("mesh", getattr(toolkit.cfg, "mesh", ""))
    if mesh_v not in ("", "auto"):
        from neutronstarlite_torch.parallel.partitioner import MeshSpec

        return MeshSpec.parse(mesh_v).devices
    cfg_p = int(getattr(toolkit.cfg, "partitions", 0) or 0)
    if cfg_p:
        return cfg_p
    if _simulate_active(toolkit):
        return 2
    from neutronstarlite_torch.parallel import mesh

    return mesh.world_size()


def _world_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _graph_digest_of(toolkit) -> str:
    digest = getattr(toolkit, "_tune_graph_digest", None)
    if digest is None:
        from neutronstarlite_torch.graph.digest import graph_digest

        digest = graph_digest(toolkit.host_graph)
        toolkit._tune_graph_digest = digest
    return digest


def _cache_key(toolkit, family: str, P: int) -> cache.CacheKey:
    return cache.CacheKey(
        graph_digest=_graph_digest_of(toolkit),
        family=family,
        partitions=int(P),
        layers=toolkit.cfg.layer_string,
        backend=cache.backend_fingerprint(),
    )


def _decision_matches_pins(decision: Dict[str, Any], cfg, autos: Set[str]) -> bool:
    """A cached decision holds only while its pinned axes still match."""
    for axis in space.AXES:
        if axis in autos:
            continue
        if space._norm(axis, decision.get(axis, "")) != space._norm(axis, getattr(cfg, axis, "")):
            return False
    return True


def _apply(toolkit, decision: Dict[str, Any], autos: Set[str]) -> None:
    for axis in autos:
        setattr(toolkit.cfg, axis, decision.get(axis, ""))


def _emit_decision(toolkit, family: str, P: int, decision: Dict[str, Any],
                   source: str) -> None:
    metrics = getattr(toolkit, "metrics", None)
    if metrics is None:
        return
    # the record carries the whole cache key, so a cached-mode stream (no
    # trial records) still names the entry it replayed
    key = _cache_key(toolkit, family, P)
    metrics.event(
        "tune_decision",
        family=family,
        candidate=decision["candidate"],
        source=source,
        partitions=int(P),
        seconds=decision.get("seconds"),
        predicted_bytes=decision.get("predicted_bytes"),
        decision={a: decision.get(a, "") for a in space.AXES},
        graph_digest=key.graph_digest,
        backend=key.backend,
        layers=key.layers,
    )
    metrics.gauge_set("tune.decision", decision["candidate"])
    metrics.gauge_set("tune.decision_source", source)
    metrics.gauge_set("tune.partitions", int(P))


def _cached_decision(toolkit, key, autos: Set[str], measure_allowed: bool,
                     in_recovery: bool):
    """The entry's decision when it may be replayed, else None (a miss)."""
    entry = cache.load(key)
    if entry is None:
        return None
    flag = entry.get("drift_flag")
    if flag and measure_allowed and not in_recovery:
        # a drift-flagged entry re-trials in measure mode; cached mode and
        # the recovery path replay it with a warning
        log.warning("tune cache: entry %s is drift-flagged (%s) — re-trialing instead of "
                    "replaying a decision whose cost model drifted",
                    key.filename(), (flag or {}).get("reason"))
        return None
    if flag:
        log.warning("tune cache: replaying drift-flagged entry %s (%s) — run with "
                    "NTS_TUNE=measure to re-trial it", key.filename(),
                    (flag or {}).get("reason"))
    decision = entry["decision"]
    stored_autos = set(entry.get("autos") or [])
    if not autos <= stored_autos:
        log.warning("tune cache: entry %s was measured with auto axes %s but %s are auto "
                    "now — the entry never explored the newly freed axis; re-tuning",
                    key.filename(), sorted(stored_autos), sorted(autos))
        return None
    if not _decision_matches_pins(decision, toolkit.cfg, autos):
        log.warning("tune cache: entry %s was decided under different pinned axes — "
                    "re-tuning", key.filename())
        return None
    return decision


def _sample_cfg(toolkit, sizes):
    """The sampled family's facts for its legs and prior: batch size, the
    last fanouts (one per layer) and the training seeds."""
    import numpy as np

    cfg = toolkit.cfg
    fans = cfg.fanouts()
    if len(sizes) > 1 and fans:
        fans = fans[-(len(sizes) - 1):]
    datum = getattr(toolkit, "datum", None)
    mask = getattr(datum, "mask", None) if datum is not None else None
    n_seeds = (int((np.asarray(mask) == 0).sum()) if mask is not None
               else int(toolkit.host_graph.v_num) // 3)
    return {"batch_size": int(cfg.batch_size or 16), "fanouts": fans, "n_seeds": n_seeds}


def _decide(toolkit, autos: Set[str], measure_allowed: bool, in_recovery: bool) -> None:
    """Resolve ``autos`` through the cache, the trials or the prior."""
    cfg = toolkit.cfg
    cls = type(toolkit)
    family = f"{space.family_of(cls)}/{cls.__name__}"
    P = _partition_count(toolkit)
    key = _cache_key(toolkit, family, P)

    decision = _cached_decision(toolkit, key, autos, measure_allowed, in_recovery)
    if decision is not None:
        _apply(toolkit, decision, autos)
        _emit_decision(toolkit, family, P, decision, source="cached")
        log.info("tune: cached decision %s (P=%d, %s)", decision["candidate"], P,
                 key.filename())
        return

    sim = _simulate_active(toolkit)
    fam_short = space.family_of(cls)
    candidates = space.enumerate_candidates(cls, cfg, P, simulate=sim)
    if not candidates:
        raise ValueError(
            f"tune: no funnel-valid candidate exists for ALGORITHM {cfg.algorithm!r} with "
            f"the pinned axes { {a: getattr(cfg, a) for a in space.AXES if a not in autos} }"
            " — relax a pin or drop the auto knobs"
        )
    sizes = cfg.layer_sizes()
    C = 1
    if fam_short in ("edge_single", "edge_dist") and len(sizes) > 1:
        chan = getattr(cls, "edge_score_channels", None)
        if chan is not None:
            C = int(chan(sizes[1]))
    sample_cfg = _sample_cfg(toolkit, sizes) if fam_short == "sampled" else None
    metrics = getattr(toolkit, "metrics", None)
    # trial records carry the whole cache key too
    key_ctx = {"graph_digest": key.graph_digest, "backend": key.backend, "layers": key.layers}
    emit = ((lambda kind, **f: metrics.event(kind, **dict(key_ctx, **f)))
            if metrics is not None else None)
    measure = measure_allowed and not in_recovery
    rows = runner.score_candidates(
        toolkit.host_graph, P, sizes, fam_short, candidates,
        simulate=sim, emit=emit, measure=measure, family_label=family, metrics=metrics,
        kernel_tile=cfg.kernel_tile, edge_chunk=getattr(cfg, "edge_chunk", 0),
        score_channels=C, precision=cfg.precision,
        eager_widths=bool(getattr(cls, "eager", False)),
        sample_cfg=sample_cfg, device=toolkit.device,
    )
    toolkit.tune_rows = rows  # each candidate's prior, trial seconds and source
    if metrics is not None and measure:
        metrics.counter_add("tune.trials", sum(1 for r in rows if r["seconds"] is not None))
    best = runner.pick_best(rows)
    chosen = {c.label(): c for c in candidates}[best["candidate"]]
    decision = dict(chosen.as_dict(), **best)
    source = "measured" if best["seconds"] is not None else "prior"
    _apply(toolkit, decision, autos)
    _emit_decision(toolkit, family, P, decision, source=source)
    log.info(
        "tune: %s decision %s (P=%d, score=%s, predicted=%dB, %d candidates)",
        source, decision["candidate"], P,
        f"{best['seconds'] * 1e3:.3f}ms" if best["seconds"] is not None else "n/a",
        best["predicted_bytes"], len(candidates),
    )
    if source == "measured":
        # only measured decisions persist; on ranks, world rank 0 writes
        if _world_rank() == 0:
            cache.store(key, decision, trials=rows, autos=sorted(autos))
    elif measure_allowed:
        log.warning("tune: nothing was measurable on this rig; decided from the analytic "
                    "prior (decision not persisted)")


# ---- entry points ------------------------------------------------------------


def resolve_auto_knobs(toolkit) -> None:
    """Resolve every ``auto`` axis of ``toolkit.cfg`` before the funnel's
    checks; a no-op when none is left."""
    from neutronstarlite_torch.parallel.partitioner import fold_mesh_env

    cfg = toolkit.cfg
    fold_mesh_env(cfg)
    autos = space.auto_axes(cfg)
    if not autos:
        return
    mode = cache.tune_mode()
    if mode == "off":
        others = autos - {"dist_path"}
        if others:
            raise tuner_off_refusal(others)
        # DIST_PATH:auto predates the tuner: the COMM_LAYER rule decides
        return
    toolkit._tune_autos = set(autos)
    _decide(toolkit, autos, measure_allowed=(mode == "measure"), in_recovery=False)


def reconsult_for_replan(toolkit) -> bool:
    """Resolve the tuner's axes again for the survivor plan (after
    ``cfg.partitions`` shrank, before the model is rebuilt): a cached
    entry for P', else the prior; never a measurement. True when a
    resolution ran."""
    autos = getattr(toolkit, "_tune_autos", None)
    if not autos:
        return False
    for axis in autos:  # the original freedom, for the enumeration
        setattr(toolkit.cfg, axis, "auto")
    _decide(toolkit, set(autos), measure_allowed=False, in_recovery=True)
    return True
