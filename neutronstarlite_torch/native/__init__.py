"""ctypes bindings for the native host runtime (``libnts_native.so``) — port
of ``neutronstarlite_tpu/native/__init__.py``.

``graph_native.cpp`` is a copy of the JAX package's source, code-equal and
at its version (``nts_native_version`` 6): the OpenMP counting-sort CSC/CSR
build, the table fills of the ELL, blocked ELL and bsp layouts, and the
fan-out sampler with its dedup. ``segment_sort.cpp`` is the port's own: it
sorts each CSC/CSR segment of the build by neighbour id, so a native graph
is the same arrays in every build and every process (JAX's orders a
vertex's edges by thread timing). It is host code (the card's kernels are
in ``csrc/``). The names and signatures of the bindings are JAX's.

The library is built at first use by a host compiler into
``neutronstarlite_torch/_build/``: ``CXX`` when it is set, then ``g++``,
the next tried when one fails (a ``CXX`` wrapper may lack OpenMP's spec
file that ``g++`` has)::

    g++ -O3 -march=native -fPIC -shared -fopenmp -std=c++17 \\
        -o _build/libnts_native.so native/graph_native.cpp native/segment_sort.cpp

and rebuilt when it is missing or older than a source (``-march=native``
output is machine-specific, so it is never shipped). Each build writes a
name of its own and renames it into place, so processes that build at the
same moment each load a whole file.

Unlike JAX, nothing falls back quietly. :func:`available` is False in
exactly two cases, each logged once: ``NTS_NO_NATIVE=1`` (the switch both
packages honour; read on every call) or no host compiler on ``PATH``. When
every compiler there fails, or the library does not load, it raises with
the compilers' output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("native")

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRCS = tuple(os.path.join(PKG_DIR, "native", name)
             for name in ("graph_native.cpp", "segment_sort.cpp"))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SO = os.path.join(BUILD_DIR, "libnts_native.so")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp", "-std=c++17")
VERSION = 6

_lib: Optional[ctypes.CDLL] = None
_said: set = set()
# wall seconds of this process's build (0.0 when an up-to-date library was
# loaded) and the compiler that built it (None then), set at the first load
build_seconds: Optional[float] = None
built_with: Optional[str] = None


def _say_once(key: str, msg: str, *args) -> None:
    if key not in _said:
        _said.add(key)
        log.info(msg, *args)


def compilers() -> List[str]:
    """The host compilers to try, in order: ``CXX`` when set, then ``g++``
    (those found on ``PATH``, each once)."""
    out: List[str] = []
    for name in (os.environ.get("CXX"), "g++"):
        path = shutil.which(name) if name else None
        if path and path not in out:
            out.append(path)
    return out


def compiler() -> Optional[str]:
    """The first host compiler to try, None if there is none."""
    found = compilers()
    return found[0] if found else None


def disabled() -> bool:
    return os.environ.get("NTS_NO_NATIVE", "0") == "1"


def _stale(srcs: Sequence[str], so: str) -> bool:
    return not os.path.exists(so) or max(map(os.path.getmtime, srcs)) > os.path.getmtime(so)


def build(srcs: Optional[Sequence[str]] = None, so: Optional[str] = None,
          cxx: Optional[str] = None) -> Tuple[float, str]:
    """Compile ``srcs`` into ``so`` (through a file of this process's own,
    renamed into place) with ``cxx``, else each of :func:`compilers` until
    one succeeds; returns (wall seconds, the compiler). Raises with every
    compiler's output when none succeeds."""
    srcs, so = list(srcs or SRCS), so or SO
    todo = [cxx] if cxx else compilers()
    if not todo:
        raise RuntimeError(f"no host compiler ({os.environ.get('CXX') or 'g++'}) on PATH")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    errors = []
    t0 = time.perf_counter()
    for cc in todo:
        proc = subprocess.run(
            [cc, *CXX_FLAGS, "-o", tmp, *srcs], capture_output=True, text=True, timeout=600,
        )
        if proc.returncode == 0:
            os.replace(tmp, so)
            return time.perf_counter() - t0, cc
        if os.path.exists(tmp):
            os.unlink(tmp)
        errors.append(f"{cc} {' '.join(srcs)}, exit {proc.returncode}:\n"
                      f"{proc.stderr}{proc.stdout}")
    raise RuntimeError("native build failed:\n" + "\n".join(errors))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.nts_count_degrees.argtypes = [u32p, u32p, ctypes.c_int64, ctypes.c_int32, i32p, i32p]
    lib.nts_build_adjacency.argtypes = [
        u32p, u32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int,
        i32p, i32p, i64p, i32p, i32p, f32p, i64p, i32p, i32p, f32p,
    ]
    lib.nts_sample_hop.argtypes = [
        i64p, i32p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64, i32p, i32p, i32p,
    ]
    lib.nts_sort_by_tile.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i64p]
    lib.nts_fill_blocked_level.argtypes = [
        i64p, i64p, i32p, i32p, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, i32p, f32p, i32p, f32p, i32p,
    ]
    lib.nts_fill_bsp.argtypes = [
        i64p, i64p, i64p, i32p, ctypes.c_int64, i64p, i64p, i32p, f32p,
        ctypes.c_int32, ctypes.c_int32, i32p, f32p, i32p,
    ]
    lib.nts_sort_segments.argtypes = [i64p, ctypes.c_int32, i32p, f32p]
    lib.nts_dedup_remap.argtypes = [i64p, ctypes.c_int64, i64p, i32p]
    lib.nts_dedup_remap.restype = ctypes.c_int64
    lib.nts_native_version.restype = ctypes.c_int
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first when missing or stale. Raises when
    the build or the load fails, or when :func:`available` is False."""
    if _lib is not None:
        return _lib
    if not available():
        raise RuntimeError(
            "the native runtime is unavailable (NTS_NO_NATIVE=1 or no host compiler)"
        )
    return _lib


def _load() -> None:
    global _lib, build_seconds, built_with
    seconds, cc = build() if _stale(SRCS, SO) else (0.0, None)
    try:
        lib = ctypes.CDLL(SO)
    except OSError as e:
        raise RuntimeError(f"native runtime {SO} does not load: {e}") from e
    _bind(lib)
    got = lib.nts_native_version()
    if got != VERSION:
        raise RuntimeError(f"{SO} is version {got}, the bindings are {VERSION}")
    _lib, build_seconds, built_with = lib, seconds, cc
    log.info("native runtime loaded (v%d; %s)", got,
             f"built by {cc} in {seconds:.2f} s" if cc else "up to date")


def available() -> bool:
    """True when the native runtime is in use: not ``NTS_NO_NATIVE=1`` and a
    host compiler exists. The first True call builds and loads the
    library; a failing build or load raises."""
    if disabled():
        _say_once("env", "native runtime off (NTS_NO_NATIVE=1): NumPy host builds")
        return False
    if _lib is not None:
        return True
    if compiler() is None:
        _say_once("cxx", "no host compiler (%s) on PATH: NumPy host builds",
                  os.environ.get("CXX") or "g++")
        return False
    _load()
    return True


def resolve(use_native: Optional[bool]) -> bool:
    """A call site's choice: None follows :func:`available`; True requires
    the runtime (raises without it); False is NumPy."""
    if use_native is None:
        return available()
    if use_native and not available():
        raise RuntimeError(
            "use_native=True, but the native runtime is unavailable "
            "(NTS_NO_NATIVE=1 or no host compiler)"
        )
    return bool(use_native)


def build_adjacency(
    src: np.ndarray, dst: np.ndarray, v_num: int, weight_mode: int
) -> Tuple[np.ndarray, ...]:
    """Counting-sort CSC+CSR build. Returns (column_offset, csc_src, csc_dst,
    csc_w, row_offset, csr_src, csr_dst, csr_w, out_degree, in_degree),
    grouped and dst-/src-sorted across groups. The threads place a group's
    edges through atomic cursors; each group is then sorted by neighbour id
    (``nts_sort_segments``), so every build gives the same arrays.
    ``weight_mode``: 0 = gcn_norm, 1 = ones."""
    lib = get_lib()
    e_num = src.shape[0]
    src = np.ascontiguousarray(src, dtype=np.uint32)
    dst = np.ascontiguousarray(dst, dtype=np.uint32)
    out_degree = np.empty(v_num, np.int32)
    in_degree = np.empty(v_num, np.int32)
    lib.nts_count_degrees(src, dst, e_num, v_num, out_degree, in_degree)
    column_offset = np.zeros(v_num + 1, np.int64)
    np.cumsum(in_degree, out=column_offset[1:])
    row_offset = np.zeros(v_num + 1, np.int64)
    np.cumsum(out_degree, out=row_offset[1:])
    csc_src = np.empty(e_num, np.int32)
    csc_dst = np.empty(e_num, np.int32)
    csc_w = np.empty(e_num, np.float32)
    csr_src = np.empty(e_num, np.int32)
    csr_dst = np.empty(e_num, np.int32)
    csr_w = np.empty(e_num, np.float32)
    lib.nts_build_adjacency(
        src, dst, e_num, v_num, weight_mode, out_degree, in_degree,
        column_offset, csc_src, csc_dst, csc_w,
        row_offset, csr_src, csr_dst, csr_w,
    )
    lib.nts_sort_segments(column_offset, v_num, csc_src, csc_w)
    lib.nts_sort_segments(row_offset, v_num, csr_dst, csr_w)
    return (
        column_offset, csc_src, csc_dst, csc_w,
        row_offset, csr_src, csr_dst, csr_w, out_degree, in_degree,
    )


def sort_by_tile(tile_of_edge: np.ndarray, n_tiles: int) -> np.ndarray:
    """Stable counting-sort permutation by tile (O(E)); with dst-grouped
    input edges the result is (tile, dst)-sorted."""
    lib = get_lib()
    tile = np.ascontiguousarray(tile_of_edge, np.int32)
    order = np.empty(len(tile), np.int64)
    lib.nts_sort_by_tile(tile, len(tile), n_tiles, order)
    return order


def fill_blocked_level(
    row_start: np.ndarray, row_len: np.ndarray, row_tile: np.ndarray,
    row_dst: np.ndarray, row_slot: np.ndarray, n_l: int, K: int,
    src_sorted: np.ndarray, w_sorted: np.ndarray,
    nbr: np.ndarray, wgt: np.ndarray, dstr: np.ndarray,
) -> None:
    """Fill one stacked [T, n_l, K] blocked-ELL level in place (nbr/wgt
    zero-initialised and dstr filled by the caller)."""
    lib = get_lib()
    lib.nts_fill_blocked_level(
        np.ascontiguousarray(row_start, np.int64),
        np.ascontiguousarray(row_len, np.int64),
        np.ascontiguousarray(row_tile, np.int32),
        np.ascontiguousarray(row_dst, np.int32),
        np.ascontiguousarray(row_slot, np.int64),
        len(row_start), n_l, K,
        np.ascontiguousarray(src_sorted, np.int32),
        np.ascontiguousarray(w_sorted, np.float32),
        nbr, wgt, dstr,
    )


def fill_bsp(
    run_start: np.ndarray, run_len: np.ndarray, row_of_first: np.ndarray,
    run_ldst: np.ndarray, row_block: np.ndarray, row_slot: np.ndarray,
    src_local: np.ndarray, w_sorted: np.ndarray, K: int, R: int,
    nbr: np.ndarray, wgt: np.ndarray, ldst: np.ndarray,
) -> None:
    """Fill the [B, K, R] block-sparse tables in place (ops/bsp_ell.py);
    nbr/wgt/ldst zero-initialised by the caller."""
    lib = get_lib()
    lib.nts_fill_bsp(
        np.ascontiguousarray(run_start, np.int64),
        np.ascontiguousarray(run_len, np.int64),
        np.ascontiguousarray(row_of_first, np.int64),
        np.ascontiguousarray(run_ldst, np.int32),
        len(run_start),
        np.ascontiguousarray(row_block, np.int64),
        np.ascontiguousarray(row_slot, np.int64),
        np.ascontiguousarray(src_local, np.int32),
        np.ascontiguousarray(w_sorted, np.float32),
        K, R, nbr, wgt, ldst,
    )


def sample_hop(
    column_offset: np.ndarray,
    row_indices: np.ndarray,
    dsts: np.ndarray,
    fanout: int,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fan-out sampling (reservoir, or Floyd for a destination of more
    than 8 x fanout in-edges), one xorshift64* stream per (seed, dst);
    returns (src, dst_idx). ``sample_hop.calls`` counts the calls."""
    lib = get_lib()
    sample_hop.calls += 1
    n = len(dsts)
    out_src = np.empty(n * fanout, np.int32)
    out_dst_idx = np.empty(n * fanout, np.int32)
    out_counts = np.empty(n, np.int32)
    lib.nts_sample_hop(
        np.ascontiguousarray(column_offset, np.int64),
        np.ascontiguousarray(row_indices, np.int32),
        np.ascontiguousarray(dsts, np.int64),
        n, fanout, seed, out_src, out_dst_idx, out_counts,
    )
    # keep the first counts[i] entries of each destination's slot
    keep = (np.arange(n * fanout) % fanout) < np.repeat(out_counts, fanout)
    return out_src[keep].astype(np.int64), out_dst_idx[keep].astype(np.int64)


sample_hop.calls = 0


def dedup_remap(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted unique ids and each input's index into them: what
    ``uniq = np.unique(ids); local = np.searchsorted(uniq, ids)`` gives,
    through two hash passes around an m-element sort. Ids must be
    nonnegative (the hash table's empty slot is -1)."""
    lib = get_lib()
    ids = np.ascontiguousarray(ids, np.int64)
    if len(ids) and ids.min() < 0:
        raise ValueError("dedup_remap requires nonnegative ids (vertex ids)")
    n = len(ids)
    uniq = np.empty(n, np.int64)
    local = np.empty(n, np.int32)
    m = lib.nts_dedup_remap(ids, n, uniq, local)
    return uniq[:m], local.astype(np.int64)
