"""Build and load the hand-written CUDA kernels (``neutronstarlite_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` into ``neutronstarlite_torch/_build/lib<name>.so``, then
loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>.so csrc/<name>.cu

A library is rebuilt when it is missing or older than its source. Nothing
outside the repository is built or fetched. A missing ``nvcc`` or a failed
build raises; there is no fallback. Every C entry point returns the
``cudaError_t`` of its launches and ``check`` raises on a non-zero one.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
KERNELS = ("ell_level", "bsp_ell")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}
_cols: Dict[str, int] = {}

VP = ctypes.c_void_p
I32 = ctypes.c_int

# C signatures: pointers and the stream as void*, sizes as int
_SIGNATURES = {
    "ell_level": {
        "nts_ell_level": [VP, VP, VP, VP, VP, VP, I32, I32, I32, I32, I32, VP],
    },
    "bsp_ell": {
        "nts_bsp_ell": [
            VP, VP, VP, VP, VP, VP, VP, VP,
            I32, I32, I32, I32, I32, I32, I32, I32, I32, I32, VP,
        ],
        "nts_bsp_ell_geometry": [VP],
        "nts_bsp_ell_occupancy": [I32, I32, VP],
    },
}
# the feature columns one warp (ell_level) or one CTA (bsp_ell) covers,
# exported by each kernel so that its wrapper reads the kernel's own value
# (bsp_ell also exports the rest of its launch geometry, read by
# ops/bsp_ell.py)
_COLS_FN = {"ell_level": "nts_ell_level_cols", "bsp_ell": "nts_bsp_ell_cols"}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "neutronstarlite_torch build from csrc/ with nvcc at first use"
    )


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib, src = _lib_path(name), os.path.join(CSRC_DIR, f"{name}.cu")
    return not os.path.exists(lib) or os.path.getmtime(src) > os.path.getmtime(lib)


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile the stale kernels, one nvcc per source, all started
    together; returns the wall seconds. Raises on any failure."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        tmp = _lib_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(_lib_path(name))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = I32
    cols = getattr(lib, _COLS_FN[name])
    cols.argtypes, cols.restype = [], I32
    _cols[name] = cols()
    _libs[name] = lib
    return lib


def kernel_cols(name: str) -> int:
    """The feature columns one work unit of kernel ``name`` covers, as
    the built kernel reports it."""
    load(name)
    return _cols[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
