"""Flat KEY:VALUE cfg parser — port of ``neutronstarlite_tpu/utils/config.py``.

Same on-disk format (the reference's ``InputInfo::readFromCfgFile``): one
``KEY:VALUE`` per line, ``#`` comments, dash-separated ``LAYERS``. Unlike
the JAX parser, which ignores keys it does not know, this one refuses every
key and every ALGORITHM the port does not implement yet with a one-line
``ValueError``: a knob that would be silently ignored lets a user benchmark
a path that never runs.

Slice 1 honours the full-batch GCN keys. ``PROC_CUDA`` and ``LOCK_FREE`` are
reference compatibility flags that the single-device trainer has no use for
(the JAX trainer ignores them too; the port's device comes from
``--device``); ``PROC_OVERLAP``, ``PROC_LOCAL``, ``PROC_REP`` and
``PARTITIONS`` select distributed features and are accepted only at their
single-device values.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

# ALGORITHM strings of slice 1 (models/gcn.py registers the same names)
GCN_ALGORITHMS = ("GCNCPU", "GCN", "GCNTPU")
GCN_EAGER_ALGORITHMS = ("GCNCPUEAGER", "GCNEAGER", "GCNEAGERSINGLE", "GCN_CPU_EAGER")
SUPPORTED_ALGORITHMS = GCN_ALGORITHMS + GCN_EAGER_ALGORITHMS

_INT_KEYS = {
    "VERTICES": "vertices",
    "EPOCHS": "epochs",
    "DECAY_EPOCH": "decay_epoch",
    "KERNEL_TILE": "kernel_tile",
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
    kernel_tile: int = 0  # PALLAS:1 -> the bsp kernel's source-tile height
    precision: str = "float32"  # or "bfloat16"
    sublinear: bool = False  # activation recomputation (torch.utils.checkpoint)

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
            f"EPOCHS: {self.epochs}",
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


def check_supported(cfg: InputInfo, resident: bool) -> None:
    """Cross-key refusals at the trainer's lifecycle funnel (cfgs built in
    code skip the file parser, so the per-key checks repeat here).
    ``resident`` is the NTS_PALLAS_RESIDENT=1 switch (the ELL-level kernel
    instead of the bsp kernel under PALLAS:1)."""
    if cfg.algorithm.upper() not in SUPPORTED_ALGORITHMS:
        raise ValueError(
            f"ALGORITHM {cfg.algorithm!r} is not ported yet; the torch port "
            f"implements {', '.join(SUPPORTED_ALGORITHMS)}"
        )
    if cfg.precision not in ("float32", "bfloat16"):
        raise ValueError(
            f"PRECISION must be float32 or bfloat16, got {cfg.precision!r}"
        )
    if cfg.pallas_kernel and not cfg.optim_kernel:
        raise ValueError(
            "PALLAS:1 requires OPTIM_KERNEL:1 (the kernels are layouts of the "
            "OPTIM_KERNEL aggregation path)"
        )
    if cfg.kernel_tile and not cfg.pallas_kernel:
        raise ValueError(
            "KERNEL_TILE without PALLAS:1 selects the blocked ELL route, "
            "which the torch port does not implement yet"
        )
    if cfg.kernel_tile and resident:
        raise ValueError(
            "KERNEL_TILE sets the bsp kernel's source tile; the ELL-level "
            "kernel (NTS_PALLAS_RESIDENT=1) has no tile to set"
        )
    if cfg.kernel_tile < 0:
        raise ValueError(f"KERNEL_TILE must be >= 0, got {cfg.kernel_tile}")
