"""npz checkpoints — port of ``neutronstarlite_tpu/utils/checkpoint.py``
(its npz backend; orbax is a JAX library and is refused, see
``utils/config.check_ckpt_backend``).

The files are the reference's, byte for byte in layout: each save is one
``step-<n>/`` directory (``n`` zero-padded to 8 digits) holding
``arrays.npz`` and ``manifest.json`` (format 2: the step, per tree its
structure string and leaf count, per array its sha256, shape and dtype).
The arrays are written first and the manifest last, as the commit marker,
both through a temporary directory and ``os.replace``, so a crash mid-save
never shows a half-written step. Leaves are stored as ``<tree>.<i>`` in
the reference's leaf order (``utils/tree.py``), so either package restores
the other's checkpoints.

- Retention keeps the newest ``NTS_CKPT_KEEP`` steps (default 2).
- ``restore_checkpoint`` verifies every digest before it trusts a step. A
  corrupt step is quarantined (renamed ``*.corrupt``, a ``ckpt_corrupt``
  fault record) and restore falls back to the previous step (a
  ``ckpt_fallback`` recovery record).
- A transient read error (an ``OSError``) is retried
  ``NTS_CKPT_RETRIES`` times (default 2) after ``NTS_CKPT_RETRY_BASE_S``
  (default 0.1 s) doubling, each retry a ``ckpt_retry`` record, before the
  step is quarantined.
- The legacy flat layout (``manifest.json`` and ``arrays.npz`` directly
  in the directory, no digests) is read too.

Leaves may be torch tensors (saved from wherever they live, restored as
numpy arrays in the template's dtype), numpy arrays or numbers.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from neutronstarlite_torch.resilience import events
from neutronstarlite_torch.utils import tree as tree_util
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("checkpoint")

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
STEP_PREFIX = "step-"
CORRUPT_SUFFIX = ".corrupt"
MANIFEST_FORMAT = 2  # 1 = legacy flat layout without digests

_STEP_RE = re.compile(rf"^{STEP_PREFIX}(\d+)$")


def keep_last_k() -> int:
    """Retention depth (``NTS_CKPT_KEEP``, default 2, min 1)."""
    try:
        return max(int(os.environ.get("NTS_CKPT_KEEP", "2")), 1)
    except ValueError:
        return 2


def _step_dirname(step: int) -> str:
    return f"{STEP_PREFIX}{int(step):08d}"


def list_steps(path: str) -> List[Tuple[int, str]]:
    """(step, directory) of every step directory under ``path``, ascending;
    quarantined ``*.corrupt`` directories are left out."""
    if not os.path.isdir(path):
        return []
    out = []
    for name in os.listdir(path):
        m = _STEP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(path, name)))
    return sorted(out)


def _legacy_files(path: str) -> Optional[Tuple[str, str]]:
    """(manifest, arrays) of a legacy flat-layout checkpoint."""
    manifest_path = os.path.join(path, MANIFEST)
    arrays_path = os.path.join(path, ARRAYS)
    if os.path.exists(manifest_path) and os.path.exists(arrays_path):
        return manifest_path, arrays_path
    return None


def have_checkpoint(path: str) -> bool:
    """True when ``path`` holds a checkpoint by its files (a manifest and a
    non-empty arrays file). No digest is checked: restore does that."""
    for _step, step_dir in reversed(list_steps(path)):
        arrays = os.path.join(step_dir, ARRAYS)
        if os.path.isfile(os.path.join(step_dir, MANIFEST)) and os.path.isfile(arrays) \
                and os.path.getsize(arrays) > 0:
            return True
    return _legacy_files(path) is not None


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def save_checkpoint(path: str, state: Dict[str, Any], step: int) -> None:
    """Write a dict of trees (``{"params": ..., "opt": ...}``) as step
    ``step`` under ``path``, then prune to the newest ``NTS_CKPT_KEEP``."""
    os.makedirs(path, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {
        "step": int(step),
        "format": MANIFEST_FORMAT,
        "trees": {},
        "arrays": {},
    }
    for name, tree in state.items():
        leaves = tree_util.leaves(tree)
        manifest["trees"][name] = {
            "treedef": tree_util.treedef_str(tree),
            "n_leaves": len(leaves),
        }
        for i, leaf in enumerate(leaves):
            arr = _to_numpy(leaf)
            key = f"{name}.{i}"
            flat[key] = arr
            manifest["arrays"][key] = {
                "sha256": _leaf_digest(arr),
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
    step_dir = os.path.join(path, _step_dirname(step))
    tmp_dir = os.path.join(path, f".tmp-{_step_dirname(step)}-{os.getpid()}")
    if os.path.isdir(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    # arrays first, the manifest (the commit marker) second
    tmp_npz = os.path.join(tmp_dir, ARRAYS + ".tmp.npz")
    np.savez(tmp_npz, **flat)
    os.replace(tmp_npz, os.path.join(tmp_dir, ARRAYS))
    with open(os.path.join(tmp_dir, MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=1)
    if os.path.isdir(step_dir):  # a re-save of the same step replaces it
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)
    # ckpt_corrupt@save=N damages the published file, as bit rot would
    if os.environ.get("NTS_FAULT_SPEC"):
        from neutronstarlite_torch.resilience.faults import fault_point

        fault_point("save", path=os.path.join(step_dir, ARRAYS))
    _prune(path, keep=keep_last_k())


def _prune(path: str, keep: int) -> None:
    """Drop the oldest step directories beyond ``keep`` and stale temporary
    ones; quarantined directories stay as evidence."""
    for _step, d in list_steps(path)[:-keep]:
        try:
            shutil.rmtree(d)
        except OSError as e:  # retention is best-effort
            log.warning("could not prune old checkpoint %s: %s", d, e)
    try:
        for name in os.listdir(path):
            if name.startswith(".tmp-" + STEP_PREFIX):
                shutil.rmtree(os.path.join(path, name), ignore_errors=True)
    except OSError:
        pass


# ---- verification -----------------------------------------------------------


def ckpt_retries() -> int:
    """Retries over transient read errors (``NTS_CKPT_RETRIES``, default 2)."""
    try:
        return max(int(os.environ.get("NTS_CKPT_RETRIES", "2")), 0)
    except ValueError:
        return 2


def ckpt_retry_base_s() -> float:
    """First retry delay (``NTS_CKPT_RETRY_BASE_S``, default 0.1 s)."""
    try:
        return max(float(os.environ.get("NTS_CKPT_RETRY_BASE_S", "0.1")), 0.0)
    except ValueError:
        return 0.1


class CheckpointCorruptError(RuntimeError):
    """A step directory failed verification. ``transient`` marks an IO-level
    read failure that a retry may clear."""

    def __init__(self, msg: str, problems: Optional[List[str]] = None,
                 transient: bool = False):
        super().__init__(msg)
        self.problems = problems or [msg]
        self.transient = transient


def _read_arrays(arrays_path: str) -> Dict[str, np.ndarray]:
    with np.load(arrays_path) as data:
        return {k: data[k] for k in data.files}


def verify_step_dir(
    step_dir: str,
) -> Tuple[Dict[str, Any], Dict[str, str], Dict[str, np.ndarray]]:
    """Check one step directory's files, manifest and every array's shape,
    dtype and sha256. Returns (manifest, status per array, the arrays);
    raises :class:`CheckpointCorruptError` on any problem."""
    problems: List[str] = []
    status: Dict[str, str] = {}
    manifest_path = os.path.join(step_dir, MANIFEST)
    arrays_path = os.path.join(step_dir, ARRAYS)
    if not os.path.exists(manifest_path):
        raise CheckpointCorruptError(f"{step_dir}: missing {MANIFEST} (interrupted save?)")
    try:
        with open(manifest_path) as fh:
            manifest = json.load(fh)
    except FileNotFoundError as e:
        raise CheckpointCorruptError(f"{step_dir}: missing manifest: {e}")
    except OSError as e:
        raise CheckpointCorruptError(f"{step_dir}: unreadable manifest: {e}", transient=True)
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(f"{step_dir}: unreadable manifest: {e}")
    if not isinstance(manifest.get("step"), int) or not isinstance(manifest.get("trees"), dict):
        raise CheckpointCorruptError(f"{step_dir}: manifest missing step/trees fields")
    if not os.path.exists(arrays_path):
        raise CheckpointCorruptError(f"{step_dir}: missing {ARRAYS}")
    try:
        loaded = _read_arrays(arrays_path)
    except FileNotFoundError as e:
        raise CheckpointCorruptError(f"{step_dir}: missing {ARRAYS}: {e}")
    except OSError as e:
        raise CheckpointCorruptError(f"{step_dir}: unreadable {ARRAYS}: {e}", transient=True)
    except Exception as e:  # a torn or garbled zip: BadZipFile, ValueError
        raise CheckpointCorruptError(f"{step_dir}: unreadable {ARRAYS}: {e}")
    declared = manifest.get("arrays", {})
    if manifest.get("format", 1) >= 2 and not isinstance(declared, dict):
        raise CheckpointCorruptError(f"{step_dir}: manifest arrays not a dict")
    for key, meta in declared.items():
        if key not in loaded:
            status[key] = "missing from arrays.npz"
            problems.append(f"{key}: missing from {ARRAYS}")
            continue
        arr = loaded[key]
        if list(arr.shape) != list(meta.get("shape", [])):
            status[key] = f"shape {list(arr.shape)} != manifest {meta.get('shape')}"
            problems.append(f"{key}: {status[key]}")
            continue
        if str(arr.dtype) != meta.get("dtype"):
            status[key] = f"dtype {arr.dtype} != manifest {meta.get('dtype')}"
            problems.append(f"{key}: {status[key]}")
            continue
        if _leaf_digest(arr) != meta.get("sha256"):
            status[key] = "sha256 digest mismatch"
            problems.append(f"{key}: sha256 digest mismatch")
            continue
        status[key] = "ok"
    extra = set(loaded) - set(declared)
    if declared and extra:
        problems.append(f"undeclared arrays in {ARRAYS}: {sorted(extra)}")
    if problems:
        raise CheckpointCorruptError(
            f"{step_dir}: {len(problems)} integrity violation(s): "
            + "; ".join(problems[:4]),
            problems=problems,
        )
    return manifest, status, loaded


def _verify_step_with_retries(step_dir: str):
    """:func:`verify_step_dir`, retrying transient read errors with a
    doubling delay; each retry is a ``ckpt_retry`` recovery record."""
    retries = ckpt_retries()
    attempt = 0
    while True:
        try:
            return verify_step_dir(step_dir)
        except CheckpointCorruptError as e:
            if not e.transient or attempt >= retries:
                raise
            attempt += 1
            delay = ckpt_retry_base_s() * (2.0 ** (attempt - 1))
            log.warning("transient checkpoint read error in %s (retry %d/%d in %.2fs): %s",
                        step_dir, attempt, retries, delay, e)
            events.emit_recovery(action="ckpt_retry", attempt=attempt, path=step_dir,
                                 error=str(e)[:200])
            if delay > 0:
                time.sleep(delay)


def _quarantine(step_dir: str, reason: str) -> None:
    """Rename a corrupt step directory to ``*.corrupt`` and record the fault
    (the record says when the rename itself failed)."""
    target = step_dir + CORRUPT_SUFFIX
    n = 1
    while os.path.exists(target):
        target = f"{step_dir}{CORRUPT_SUFFIX}.{n}"
        n += 1
    quarantined = None
    try:
        os.replace(step_dir, target)
        quarantined = os.path.basename(target)
        log.warning("quarantined corrupt checkpoint %s -> %s (%s)", step_dir, quarantined,
                    reason)
    except OSError as e:
        log.warning("could not quarantine %s: %s", step_dir, e)
    events.emit_fault("ckpt_corrupt", path=step_dir, quarantined=quarantined,
                      error=reason[:500])


def _np_dtype(leaf) -> np.dtype:
    if torch.is_tensor(leaf):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _rebuild_state(like: Dict[str, Any], manifest: Dict[str, Any],
                   data: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, tree in like.items():
        leaves = tree_util.leaves(tree)
        n = manifest["trees"][name]["n_leaves"]
        if n != len(leaves):
            raise ValueError(f"checkpoint tree {name!r} has {n} leaves; expected {len(leaves)}")
        out[name] = tree_util.unflatten_like(tree, [
            np.asarray(data[f"{name}.{i}"], dtype=_np_dtype(leaf))
            for i, leaf in enumerate(leaves)
        ])
    return out


def restore_checkpoint(
    path: str, like: Dict[str, Any]
) -> Optional[Tuple[Dict[str, Any], int]]:
    """The newest intact checkpoint under ``path`` in the structure of
    ``like`` (numpy leaves in like's dtypes), and its step; None when there
    is none. A corrupt step is quarantined and the previous one tried."""
    quarantined = 0
    for step, step_dir in reversed(list_steps(path)):
        try:
            manifest, _status, arrays = _verify_step_with_retries(step_dir)
            state = _rebuild_state(like, manifest, arrays)
        except CheckpointCorruptError as e:
            _quarantine(step_dir, str(e))
            quarantined += 1
            continue
        if quarantined:
            events.emit_recovery(action="ckpt_fallback", step=step, quarantined=quarantined)
            log.warning("restored step %d after quarantining %d newer corrupt checkpoint(s)",
                        step, quarantined)
        return state, int(manifest["step"])
    # legacy flat layout: no digests, but a torn file still degrades to
    # "no checkpoint" (quarantined, with a fault record)
    legacy = _legacy_files(path)
    if legacy is None:
        return None
    manifest_path, arrays_path = legacy
    try:
        with open(manifest_path) as fh:
            manifest = json.load(fh)
        state = _rebuild_state(like, manifest, _read_arrays(arrays_path))
        return state, int(manifest["step"])
    except (OSError, ValueError, KeyError, json.JSONDecodeError, zipfile.BadZipFile) as e:
        for p in (manifest_path, arrays_path):
            try:
                os.replace(p, p + CORRUPT_SUFFIX)
            except OSError:
                pass
        log.warning("legacy checkpoint in %s unreadable (%s); quarantined", path, e)
        events.emit_fault("ckpt_corrupt", path=path, legacy=True, error=str(e)[:500])
        return None


def dump_vertex_array(path: str, name: str, arr) -> None:
    """Whole-array vertex dump (the reference's ``dump_vertex_array``)."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, f"{name}.npy"), _to_numpy(arr))


def restore_vertex_array(path: str, name: str) -> Optional[np.ndarray]:
    p = os.path.join(path, f"{name}.npy")
    return np.load(p) if os.path.exists(p) else None
