"""Flat KEY:VALUE cfg parser — port of ``neutronstarlite_tpu/utils/config.py``.

Same on-disk format (the reference's ``InputInfo::readFromCfgFile``): one
``KEY:VALUE`` per line, ``#`` comments, dash-separated ``LAYERS``. Unlike
the JAX parser, which ignores keys it does not know, this one refuses every
key and every ALGORITHM the port does not implement yet with a one-line
``ValueError``: a knob that would be silently ignored lets a user benchmark
a path that never runs.

The port honours the single-device full-batch keys (GCN, GAT, GIN,
CommNet, GGCN) and the sampled trainer's (``GCNSAMPLE*``: ``BATCH_SIZE``,
dash-separated ``FANOUT``, ``SAMPLE_PIPELINE`` = sync, pipelined, device or
fused; ``SAMPLE_PIPELINE:auto`` needs the autotuner and is refused, and a
full-batch trainer given ``SAMPLE_PIPELINE`` refuses it). ``KERNEL`` is empty (the edge chain) or ``fused_edge``
(``ops/fused_edge.py``, GAT and GGCN); ``KERNEL:auto`` and
``ELL_LEVELS:auto`` need the autotuner, which is not ported, and are
refused. ``ELL_LEVELS`` (``pow2`` or ``binned``) sets the fused tables'
level ladder. ``KERNEL_TILE`` sets the source-tile height of the bsp
kernel (``PALLAS:1``), of the blocked ELL route (``OPTIM_KERNEL:1``
without ``PALLAS``) and of the fused tables. ``PROC_CUDA`` and ``LOCK_FREE`` are
reference compatibility flags that the single-device trainer has no use for
(the JAX trainer ignores them too; the port's device comes from
``--device``); ``PROC_OVERLAP``, ``PROC_LOCAL``, ``PROC_REP`` and
``PARTITIONS`` select distributed features and are accepted only at their
single-device values. ``CHECKPOINT_DIR`` and ``CHECKPOINT_EVERY`` turn on
checkpoints (``utils/checkpoint.py``); ``CKPT_BACKEND`` takes ``npz`` alone:
``orbax`` is a JAX library, and the sharded asynchronous saves it gives
the reference come with the distributed slice.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

# ALGORITHM strings of the single-device full-batch trainers (models/
# registers the same names)
GCN_ALGORITHMS = ("GCNCPU", "GCN", "GCNTPU")
GCN_EAGER_ALGORITHMS = ("GCNCPUEAGER", "GCNEAGER", "GCNEAGERSINGLE", "GCN_CPU_EAGER")
GAT_ALGORITHMS = ("GATCPU", "GAT", "GATSINGLE")
GIN_ALGORITHMS = ("GINCPU", "GINGPU", "GIN")
COMMNET_ALGORITHMS = ("COMMNETGPU", "COMMNETCPU", "COMMNET")
GGCN_ALGORITHMS = ("GGCNCPU", "GGCN", "GGNN")
GCN_SAMPLE_ALGORITHMS = ("GCNSAMPLESINGLE", "GCNSAMPLE", "GCNCPUSAMPLE")
SUPPORTED_ALGORITHMS = (
    GCN_ALGORITHMS + GCN_EAGER_ALGORITHMS + GAT_ALGORITHMS + GIN_ALGORITHMS
    + COMMNET_ALGORITHMS + GGCN_ALGORITHMS + GCN_SAMPLE_ALGORITHMS
)
SAMPLE_PIPELINE_MODES = ("sync", "pipelined", "device", "fused")

_INT_KEYS = {
    "VERTICES": "vertices",
    "EPOCHS": "epochs",
    "DECAY_EPOCH": "decay_epoch",
    "KERNEL_TILE": "kernel_tile",
    "CHECKPOINT_EVERY": "checkpoint_every",
    "BATCH_SIZE": "batch_size",
}
_FLOAT_KEYS = {
    "LEARN_RATE": "learn_rate",
    "WEIGHT_DECAY": "weight_decay",
    "DECAY_RATE": "decay_rate",
    "DROP_RATE": "drop_rate",
}
_BOOL_KEYS = {
    "PROC_CUDA": "with_cuda",
    "LOCK_FREE": "lock_free",
    "OPTIM_KERNEL": "optim_kernel",
    "PALLAS": "pallas_kernel",
    "SUBLINEAR": "sublinear",
}
_STR_KEYS = {
    "LAYERS": "layer_string",
    "EDGE_FILE": "edge_file",
    "FEATURE_FILE": "feature_file",
    "LABEL_FILE": "label_file",
    "MASK_FILE": "mask_file",
    "CHECKPOINT_DIR": "checkpoint_dir",
    "FANOUT": "fanout_string",
}
# distributed switches: accepted only at the single-device value
_SINGLE_DEVICE_KEYS = {
    "PROC_OVERLAP": ("0",),
    "PROC_LOCAL": ("0",),
    "PROC_REP": ("0",),
    "PARTITIONS": ("0", "1"),
}


@dataclasses.dataclass
class InputInfo:
    """Parsed cfg (the fields of the JAX ``InputInfo`` that slice 1 uses)."""

    algorithm: str = ""
    vertices: int = 0
    epochs: int = 10
    layer_string: str = ""
    edge_file: str = ""
    feature_file: str = ""
    label_file: str = ""
    mask_file: str = ""
    learn_rate: float = 0.01
    weight_decay: float = 0.0001
    decay_rate: float = 0.97
    decay_epoch: int = 100
    drop_rate: float = 0.5
    with_cuda: bool = False
    lock_free: bool = False
    optim_kernel: bool = False
    pallas_kernel: bool = False
    kernel_tile: int = 0  # source-tile height: bsp kernel, blocked ELL, fused tables
    precision: str = "float32"  # or "bfloat16"
    sublinear: bool = False  # activation recomputation (torch.utils.checkpoint)
    kernel: str = ""  # KERNEL: "" (the edge chain) or fused_edge
    ell_levels: str = ""  # ELL_LEVELS: "" (the path's default), pow2 or binned
    checkpoint_dir: str = ""  # checkpoint and resume when set
    checkpoint_every: int = 0  # epochs between checkpoints (0: at the end only)
    ckpt_backend: str = ""  # CKPT_BACKEND: "" (NTS_CKPT_BACKEND, else npz) or npz
    batch_size: int = 64  # sampled trainer: seeds per mini-batch
    fanout_string: str = ""  # sampled trainer: FANOUT, e.g. "25-10"
    sample_pipeline: str = ""  # SAMPLE_PIPELINE: "" (sync) or one of SAMPLE_PIPELINE_MODES

    @staticmethod
    def read_from_cfg_file(path: str) -> "InputInfo":
        cfg = InputInfo()
        with open(path, "r") as fh:
            for raw in fh:
                line = raw.strip()
                if not line or line.startswith("#") or ":" not in line:
                    continue
                key, _, value = line.partition(":")
                cfg._apply(key.strip().upper(), value.strip())
        return cfg

    def _apply(self, key: str, value: str) -> None:
        if key == "ALGORITHM":
            if value.upper() not in SUPPORTED_ALGORITHMS:
                raise ValueError(
                    f"ALGORITHM {value!r} is not ported yet; the torch port "
                    f"implements {', '.join(SUPPORTED_ALGORITHMS)}"
                )
            self.algorithm = value
        elif key in _INT_KEYS:
            setattr(self, _INT_KEYS[key], int(value))
        elif key in _FLOAT_KEYS:
            setattr(self, _FLOAT_KEYS[key], float(value))
        elif key in _BOOL_KEYS:
            setattr(self, _BOOL_KEYS[key], bool(int(value)))
        elif key in _STR_KEYS:
            setattr(self, _STR_KEYS[key], value)
        elif key == "KERNEL":
            self.kernel = value.strip().lower()
            _check_kernel(self.kernel)
        elif key == "ELL_LEVELS":
            self.ell_levels = value.strip().lower()
            _check_ell_levels(self.ell_levels)
        elif key == "SAMPLE_PIPELINE":
            self.sample_pipeline = value.strip().lower()
            check_sample_pipeline(self.sample_pipeline)
        elif key == "CKPT_BACKEND":
            check_ckpt_backend(value)
            self.ckpt_backend = value
        elif key == "PRECISION":
            if value not in ("float32", "bfloat16"):
                raise ValueError(
                    f"PRECISION must be float32 or bfloat16, got {value!r}"
                )
            self.precision = value
        elif key in _SINGLE_DEVICE_KEYS:
            if value not in _SINGLE_DEVICE_KEYS[key]:
                raise ValueError(
                    f"{key}:{value} selects a distributed feature the torch "
                    "port does not implement yet (single device only)"
                )
        else:
            raise ValueError(
                f"cfg key {key}:{value} is not implemented by the torch port yet"
            )

    def layer_sizes(self) -> List[int]:
        """Parse "1433-128-7" -> [1433, 128, 7]."""
        if not self.layer_string:
            return []
        return [int(tok) for tok in self.layer_string.split("-") if tok]

    def fanouts(self) -> List[int]:
        """Parse "5-10-10" -> [5, 10, 10]."""
        if not self.fanout_string:
            return []
        return [int(tok) for tok in self.fanout_string.split("-") if tok]

    def resolve_path(self, path: str, base_dir: Optional[str] = None) -> str:
        """Data paths resolve relative to the cfg file's directory."""
        if not path or os.path.isabs(path) or not base_dir:
            return path
        return os.path.normpath(os.path.join(base_dir, path))

    def print(self) -> str:
        """Config echo (same lines as the JAX CLI)."""
        lines = [
            f"ALGORITHM: {self.algorithm}",
            f"VERTICES: {self.vertices}",
            f"LAYERS: {self.layer_string}",
            f"FANOUT: {self.fanout_string}",
            f"EPOCHS: {self.epochs}",
            f"BATCH_SIZE: {self.batch_size}",
            f"EDGE_FILE: {self.edge_file}",
            f"FEATURE_FILE: {self.feature_file}",
            f"LABEL_FILE: {self.label_file}",
            f"MASK_FILE: {self.mask_file}",
            f"LEARN_RATE: {self.learn_rate}",
            f"WEIGHT_DECAY: {self.weight_decay}",
            f"DECAY_RATE: {self.decay_rate}",
            f"DECAY_EPOCH: {self.decay_epoch}",
            f"DROP_RATE: {self.drop_rate}",
            f"OPTIM_KERNEL: {int(self.optim_kernel)}",
            f"PALLAS: {int(self.pallas_kernel)}",
            f"PRECISION: {self.precision}",
        ]
        return "\n".join(lines)


def _check_kernel(value: str) -> None:
    if value == "auto":
        raise ValueError(
            "KERNEL:auto lets the autotuner (tune/) choose the kernel; the "
            "torch port does not implement the autotuner yet: set "
            "KERNEL:fused_edge, or drop KERNEL to run the edge chain"
        )
    if value not in ("", "fused_edge"):
        raise ValueError(f"KERNEL must be fused_edge (or empty), got {value!r}")


def _check_ell_levels(value: str) -> None:
    if value == "auto":
        raise ValueError(
            "ELL_LEVELS:auto lets the autotuner (tune/) choose the level "
            "ladder; the torch port does not implement the autotuner yet: set "
            "pow2 or binned"
        )
    if value not in ("", "pow2", "binned"):
        raise ValueError(f"ELL_LEVELS must be pow2 or binned (or empty), got {value!r}")


def check_sample_pipeline(value: str) -> None:
    """Refuse an unknown SAMPLE_PIPELINE and ``auto`` (the tuner's)."""
    if value == "auto":
        raise ValueError(
            "SAMPLE_PIPELINE:auto lets the autotuner (tune/) choose the sampling "
            "mode; the torch port does not implement the autotuner yet: set sync, "
            "pipelined, device or fused"
        )
    if value not in ("",) + SAMPLE_PIPELINE_MODES:
        raise ValueError(
            f"SAMPLE_PIPELINE must be sync, pipelined, device or fused, got {value!r}"
        )


def check_ckpt_backend(value: str) -> str:
    """The checkpoint backend ``value`` names (empty: ``NTS_CKPT_BACKEND``,
    else npz); refuses orbax and unknown names."""
    backend = value or os.environ.get("NTS_CKPT_BACKEND", "") or "npz"
    if backend == "orbax":
        raise ValueError(
            "checkpoint backend orbax (CKPT_BACKEND / NTS_CKPT_BACKEND) is a JAX "
            "library; the torch port writes npz checkpoints, and sharded "
            "asynchronous saves come with the distributed slice: set npz"
        )
    if backend != "npz":
        raise ValueError(
            f"unknown checkpoint backend {backend!r} (CKPT_BACKEND / "
            "NTS_CKPT_BACKEND: npz)"
        )
    return backend


def check_supported(cfg: InputInfo, resident: bool, supports_fused_edge: bool = False) -> None:
    """Cross-key refusals at the trainer's lifecycle funnel (cfgs built in
    code skip the file parser, so the per-key checks repeat here).
    ``resident`` is the NTS_PALLAS_RESIDENT=1 switch (the ELL-level kernel
    instead of the bsp kernel under PALLAS:1); ``supports_fused_edge`` is
    the trainer's flag (GAT, GGCN)."""
    if cfg.algorithm.upper() not in SUPPORTED_ALGORITHMS:
        raise ValueError(
            f"ALGORITHM {cfg.algorithm!r} is not ported yet; the torch port "
            f"implements {', '.join(SUPPORTED_ALGORITHMS)}"
        )
    if cfg.precision not in ("float32", "bfloat16"):
        raise ValueError(
            f"PRECISION must be float32 or bfloat16, got {cfg.precision!r}"
        )
    _check_kernel(cfg.kernel)
    _check_ell_levels(cfg.ell_levels)
    check_sample_pipeline(cfg.sample_pipeline)
    if cfg.sample_pipeline and cfg.algorithm.upper() not in GCN_SAMPLE_ALGORITHMS:
        raise ValueError(
            f"SAMPLE_PIPELINE:{cfg.sample_pipeline} is not available for ALGORITHM "
            f"{cfg.algorithm!r}: only the sampled trainer "
            f"({', '.join(GCN_SAMPLE_ALGORITHMS)}) samples; drop the key"
        )
    if cfg.checkpoint_dir:
        check_ckpt_backend(cfg.ckpt_backend)
    if cfg.pallas_kernel and not cfg.optim_kernel:
        raise ValueError(
            "PALLAS:1 requires OPTIM_KERNEL:1 (the kernels are layouts of the "
            "OPTIM_KERNEL aggregation path)"
        )
    if cfg.kernel == "fused_edge":
        if not supports_fused_edge:
            raise ValueError(
                f"KERNEL:fused_edge is not available for ALGORITHM "
                f"{cfg.algorithm!r}: the fused score+softmax+aggregation op "
                "serves the attention/edge-op families (GAT, GGCN); other "
                "families aggregate through OPTIM_KERNEL/PALLAS instead"
            )
        if cfg.optim_kernel or cfg.pallas_kernel:
            raise ValueError(
                "KERNEL:fused_edge and OPTIM_KERNEL/PALLAS select different "
                "routes for the same chain: choose one"
            )
    if cfg.kernel_tile and resident:
        raise ValueError(
            "KERNEL_TILE sets the bsp kernel's source tile; the ELL-level "
            "kernel (NTS_PALLAS_RESIDENT=1) has no tile to set"
        )
    if cfg.kernel_tile < 0:
        raise ValueError(f"KERNEL_TILE must be >= 0, got {cfg.kernel_tile}")
