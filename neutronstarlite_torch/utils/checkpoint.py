"""Checkpoints — port of ``neutronstarlite_tpu/utils/checkpoint.py``.

Two backends, as in JAX (``CKPT_BACKEND`` / ``NTS_CKPT_BACKEND``;
:func:`resolve_backend` refuses other names):

- ``npz`` (default): the host-side single-writer files below;
- ``orbax``: JAX's name kept for the sharded asynchronous backend, written
  here with ``torch.distributed.checkpoint`` (``async_save`` and
  ``load``) under the same ``orbax/`` subdirectory, one ``<step>/``
  directory per save, the newest 2 kept (JAX's ``max_to_keep=2``). Every
  rank of a joined process group takes part in a save and a restore; the
  replicated tensors are written by the lowest rank, so rank 0's
  directory alone holds a whole checkpoint. A step counts once its
  ``.metadata`` is written (the coordinator writes it last), so an empty
  or unfinished directory is no step (:func:`orbax_latest_step`).
  :func:`finalize_checkpoints` drains the saves in flight (the trainers
  call it from ``ckpt_final``). Where ``async_save`` cannot run, the save
  is synchronous, with one log line. A restore from a directory without a
  completed step falls through to the npz files, as JAX's does.

The npz files are the reference's, byte for byte in layout: each save is one
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
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from neutronstarlite_torch.resilience import events
from neutronstarlite_torch.utils import tree as tree_util
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("checkpoint")

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
ORBAX_SUBDIR = "orbax"
SHARDED_KEEP = 2  # JAX's CheckpointManager max_to_keep
BACKENDS = ("npz", "orbax")
STEP_PREFIX = "step-"
CORRUPT_SUFFIX = ".corrupt"
MANIFEST_FORMAT = 2  # 1 = legacy flat layout without digests

_STEP_RE = re.compile(rf"^{STEP_PREFIX}(\d+)$")


def resolve_backend(requested: str = "") -> str:
    """The checkpoint backend: ``requested`` (CKPT_BACKEND), else
    ``NTS_CKPT_BACKEND``, else npz; an unknown name refuses."""
    backend = requested or os.environ.get("NTS_CKPT_BACKEND", "") or "npz"
    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r} (CKPT_BACKEND / "
                         "NTS_CKPT_BACKEND: npz | orbax)")
    return backend


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


def latest_npz_step(path: str) -> Optional[int]:
    """Newest intact npz step under ``path`` (legacy flat layout reads as
    its manifest step), or None."""
    steps = list_steps(path)
    if steps:
        return steps[-1][0]
    legacy = _legacy_files(path)
    if legacy:
        try:
            with open(legacy[0]) as fh:
                return int(json.load(fh)["step"])
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return None
    return None


def have_checkpoint(path: str, backend: str = "") -> bool:
    """True when ``path`` holds a checkpoint by its files (a completed
    sharded step, or a manifest and a non-empty arrays file). No digest is
    checked: restore does that."""
    if resolve_backend(backend) == "orbax" and orbax_latest_step(path) is not None:
        return True
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


def save_checkpoint(path: str, state: Dict[str, Any], step: int, backend: str = "") -> None:
    """Write a dict of trees (``{"params": ..., "opt": ...}``) as step
    ``step`` under ``path``. npz: one writer (the caller gates it), then
    prune to the newest ``NTS_CKPT_KEEP``. orbax: asynchronous and sharded,
    every rank calls."""
    if resolve_backend(backend) == "orbax":
        _sharded_save(path, state, step)
        return
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
    path: str, like: Dict[str, Any], backend: str = "", local: bool = False
) -> Optional[Tuple[Dict[str, Any], int]]:
    """The newest intact checkpoint under ``path`` in the structure of
    ``like`` (numpy leaves in like's dtypes), and its step; None when there
    is none. A corrupt npz step is quarantined and the previous one tried.
    orbax: every rank of a joined group calls, unless ``local`` (one
    process reads its own directory; the restore broadcast's rank 0)."""
    if resolve_backend(backend) == "orbax":
        step = orbax_latest_step(path)
        if step is not None:
            return _sharded_load(path, like, step, local), step
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


# ---- the sharded asynchronous backend (CKPT_BACKEND:orbax) ---------------------

# without a process group (the twin, one device) DCP warns on every save and
# load that it runs in one process: that is the intent here
warnings.filterwarnings("ignore", message="torch.distributed is disabled",
                        category=UserWarning)

# the future of the save in flight, per sharded directory
_pending: Dict[str, Any] = {}


def _sharded_root(path: str) -> str:
    return os.path.abspath(os.path.join(path, ORBAX_SUBDIR))


def _joined() -> bool:
    return tdist.is_available() and tdist.is_initialized()


# (the world it was made in, a gloo group of every rank): the saves and
# loads coordinate over their own group, since an asynchronous save's
# collectives run in a background thread beside the training's
_group: Optional[tuple] = None


def _ckpt_group():
    """The checkpoint's own process group (None without a joined world),
    made by every rank at its first sharded save or restore."""
    global _group
    if not _joined():
        return None
    if _group is None or _group[0] is not tdist.group.WORLD:
        _group = (tdist.group.WORLD, tdist.new_group(backend="gloo"))
    return _group[1]


def _flat_state(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{key path: CPU tensor} of every leaf (copies: training goes on while
    an asynchronous save writes them)."""
    out = {}
    for key, leaf in tree_util.flatten_with_path(state):
        if torch.is_tensor(leaf):
            out[key] = leaf.detach().to("cpu", copy=True)
        else:
            out[key] = torch.from_numpy(np.array(leaf))
    return out


def _wait(root: str) -> None:
    fut = _pending.pop(root, None)
    if fut is not None:
        fut.result()


def finalize_checkpoints() -> None:
    """Drain the sharded saves in flight and prune to the newest
    ``SHARDED_KEEP`` steps (npz: nothing to do)."""
    for root in list(_pending):
        _wait(root)
        _prune_sharded(root)


def _completed_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    return sorted(int(n) for n in os.listdir(root)
                  if n.isdigit() and os.path.isfile(os.path.join(root, n, ".metadata")))


def orbax_latest_step(path: str) -> Optional[int]:
    """The newest completed sharded step under ``path`` (after the saves in
    flight finish), or None: no subdirectory, or none with its metadata
    (an interrupted first save)."""
    root = _sharded_root(path)
    _wait(root)
    steps = _completed_steps(root)
    return steps[-1] if steps else None


def _prune_sharded(root: str) -> None:
    if _joined() and tdist.get_rank() != 0:
        return
    for step in _completed_steps(root)[:-SHARDED_KEEP]:
        shutil.rmtree(os.path.join(root, str(step)), ignore_errors=True)


def _sharded_save(path: str, state: Dict[str, Any], step: int) -> None:
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import DefaultSavePlanner

    root = _sharded_root(path)
    _wait(root)  # one save in flight per directory, as orbax's manager
    _prune_sharded(root)
    step_dir = os.path.join(root, str(int(step)))
    if not _joined() or tdist.get_rank() == 0:
        os.makedirs(root, exist_ok=True)
        if os.path.isdir(step_dir):  # a re-save of the same step replaces it
            shutil.rmtree(step_dir)
    flat = _flat_state(state)
    kw = dict(checkpoint_id=step_dir, no_dist=not _joined(), process_group=_ckpt_group(),
              planner=DefaultSavePlanner(dedup_save_to_lowest_rank=True))
    try:
        _pending[root] = dcp.async_save(flat, **kw)
    except (RuntimeError, TypeError, NotImplementedError) as e:
        log.info("sharded checkpoint: async_save unavailable here (%s); saving step %d "
                 "synchronously", e, step)
        dcp.save(flat, **kw)


def _sharded_load(path: str, like: Dict[str, Any], step: int, local: bool) -> Dict[str, Any]:
    import torch.distributed.checkpoint as dcp

    leaves = tree_util.flatten_with_path(like)
    flat = {}
    for key, leaf in leaves:
        t = leaf.detach() if torch.is_tensor(leaf) else torch.from_numpy(np.array(leaf))
        flat[key] = torch.zeros(tuple(t.shape), dtype=t.dtype)
    dist = not local and _joined()
    dcp.load(flat, checkpoint_id=os.path.join(_sharded_root(path), str(int(step))),
             no_dist=not dist, process_group=_ckpt_group() if dist else None)
    return tree_util.unflatten_like(like, [
        flat[key].numpy().astype(_np_dtype(leaf), copy=False) for key, leaf in leaves])
