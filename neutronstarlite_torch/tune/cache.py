"""The autotuner's persisted decision cache — port of ``neutronstarlite_tpu/tune/cache.py``.

One JSON file per decision under ``NTS_TUNE_DIR``, keyed by the five facts
a measured decision holds for: graph content digest, family (tune-space
family / trainer class), partition count, layer stack and backend
fingerprint. The file name is the first 16 hex digits of the sha256 of the
key's sorted JSON, as in JAX, so either package finds the other's entry
for the same five facts; the backend field differs between them (the
port's ``torch-...``, JAX's ``jax-...``), so such an entry is a warned
miss.

Publication is atomic (a temporary file, then ``os.replace``): a writer
that dies mid-store leaves the previous entry or none. Staleness is loud:
the key is embedded in the entry and checked on load, the schema is
versioned, and a torn or unparsable entry is a warned miss. Only measured
decisions are stored: a prior-only one (``NTS_TUNE=cached`` on a cold
cache, the replan path) is recomputed each time.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

from neutronstarlite_torch.obs.ledger import backend_fingerprint  # noqa: F401
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("tune")

# 3: the sixth axis (SAMPLE_PIPELINE); 5-part labels of schema 2 are misses
TUNE_SCHEMA_VERSION = 3

_MODES = ("off", "cached", "measure")


def tune_mode() -> str:
    """``NTS_TUNE``: off (the default: auto axes keep their legacy meaning
    or refuse), cached (the cache, else the analytic prior; never
    measures) or measure (timed trials on a miss, then stored)."""
    raw = (os.environ.get("NTS_TUNE", "") or "off").strip().lower()
    if raw not in _MODES:
        raise ValueError(f"NTS_TUNE must be one of {'|'.join(_MODES)}, got {raw!r}")
    return raw


def tune_dir() -> Optional[str]:
    """The cache directory (``NTS_TUNE_DIR``), or None: decisions then
    live for the process only."""
    return os.environ.get("NTS_TUNE_DIR") or None


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """The five facts one cached decision holds for."""

    graph_digest: str
    family: str  # tune-space family + trainer class, e.g. dist_dense/DistGCNTrainer
    partitions: int
    layers: str  # the LAYERS string
    backend: str

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def filename(self) -> str:
        blob = json.dumps(self.as_dict(), sort_keys=True)
        return f"tune-{hashlib.sha256(blob.encode()).hexdigest()[:16]}.json"

    def path(self, directory: str) -> str:
        return os.path.join(directory, self.filename())


def load(key: CacheKey, directory: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The entry for ``key``, or None. Schema drift, a foreign embedded key
    and torn JSON are warned misses, never a reuse and never a crash."""
    directory = directory or tune_dir()
    if not directory:
        return None
    path = key.path(directory)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as fh:
            entry = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        log.warning("tune cache: %s is unreadable (%s) — treating as a miss and "
                    "re-tuning", path, e)
        return None
    if not isinstance(entry, dict):
        log.warning("tune cache: %s is not an object — re-tuning", path)
        return None
    if entry.get("tune_schema") != TUNE_SCHEMA_VERSION:
        log.warning("tune cache: %s has schema %r != %d — stale entry, re-tuning",
                    path, entry.get("tune_schema"), TUNE_SCHEMA_VERSION)
        return None
    if entry.get("key") != key.as_dict():
        log.warning(
            "tune cache: %s embeds key %r but was looked up as %r (digest or backend "
            "drift, or a hand-moved file) — refusing to reuse, re-tuning",
            path, entry.get("key"), key.as_dict(),
        )
        return None
    decision = entry.get("decision")
    if not isinstance(decision, dict) or not decision.get("candidate"):
        log.warning("tune cache: %s carries no decision — re-tuning", path)
        return None
    return entry


def _publish(path: str, entry: Dict[str, Any]) -> None:
    """Write ``entry`` to ``path`` atomically."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(entry, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)  # the commit point: readers see all or nothing


def store(key: CacheKey, decision: Dict[str, Any],
          trials: Optional[List[Dict[str, Any]]] = None,
          directory: Optional[str] = None,
          autos: Optional[List[str]] = None) -> Optional[str]:
    """Publish a measured decision; the entry's path, or None when no
    directory is set (a warned no-op: the decision still holds for this
    run). ``autos`` are the axes that were free: a later lookup with more
    of them re-tunes."""
    directory = directory or tune_dir()
    if not directory:
        log.warning("NTS_TUNE_DIR is unset: the measured tune decision %s will not be "
                    "persisted (every future run re-measures)", decision.get("candidate"))
        return None
    os.makedirs(directory, exist_ok=True)
    path = key.path(directory)
    _publish(path, {
        "tune_schema": TUNE_SCHEMA_VERSION,
        "key": key.as_dict(),
        "created_ts": time.time(),
        "autos": sorted(autos or []),
        "decision": dict(decision),
        "trials": list(trials or []),
    })
    log.info("tune cache: stored %s -> %s", decision.get("candidate"), path)
    return path


# ---- drift flags -------------------------------------------------------------


def find_entries(directory: Optional[str] = None, family: Optional[str] = None,
                 partitions: Optional[int] = None, graph_digest: Optional[str] = None,
                 backend: Optional[str] = None, layers: Optional[str] = None) -> List[str]:
    """Paths of the parsable entries whose embedded key matches the given
    facts (None matches any)."""
    directory = directory or tune_dir()
    if not directory or not os.path.isdir(directory):
        return []
    want = {"family": family, "partitions": partitions, "graph_digest": graph_digest,
            "backend": backend, "layers": layers}
    out: List[str] = []
    for path in sorted(glob.glob(os.path.join(directory, "tune-*.json"))):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                entry = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        key = entry.get("key") if isinstance(entry, dict) else None
        if not isinstance(key, dict):
            continue
        if any(v is not None and key.get(k) != v for k, v in want.items()):
            continue
        out.append(path)
    return out


def flag_for_retrial(path: str, reason: str) -> bool:
    """Mark an entry drift-flagged (atomic rewrite): the next
    ``NTS_TUNE=measure`` run re-trials it; cached mode replays it with a
    warning. False when the entry is unreadable (warned)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            entry = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        log.warning("tune cache: cannot flag %s (%s)", path, e)
        return False
    if not isinstance(entry, dict):
        log.warning("tune cache: cannot flag non-object entry %s", path)
        return False
    entry["drift_flag"] = {"reason": str(reason), "flagged_ts": time.time()}
    try:
        _publish(path, entry)
    except OSError as e:
        log.warning("tune cache: flagging %s failed (%s)", path, e)
        return False
    log.warning("tune cache: flagged %s for re-trial (%s) — the next NTS_TUNE=measure "
                "run will re-run real trials", path, reason)
    return True
