"""Feature / label / mask IO — port of ``neutronstarlite_tpu/graph/dataset.py``.

File formats (the reference's readFeature_Label_Mask): feature lines
``ID f0 ... f_{d-1}`` (or a ``.npy`` [V, d] table); label lines ``ID label``;
mask lines ``ID train|val|eval|test`` with train=0, val/eval=1, test=2. A
missing file falls back per field to the same ``np.random.default_rng(seed)``
draws as the JAX loader, in the same order, so a run without a featuretable
sees bit-identical features on both sides.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("dataset")

MASK_TRAIN = 0
MASK_VAL = 1
MASK_TEST = 2

_MASK_NAMES = {"train": MASK_TRAIN, "val": MASK_VAL, "eval": MASK_VAL, "test": MASK_TEST}


@dataclasses.dataclass
class GNNDatum:
    """Per-vertex features, labels, masks for the full graph (host NumPy)."""

    feature: np.ndarray  # [V, f0] float32
    label: np.ndarray  # [V] int32
    mask: np.ndarray  # [V] int32 in {0=train, 1=val, 2=test}

    @staticmethod
    def random_generate(
        v_num: int, feature_size: int, label_num: int, seed: int = 0
    ) -> "GNNDatum":
        """Deterministic stand-in data (reference: random_generate): the JAX
        loader's ``default_rng(seed)`` draws in its order, so the arrays are
        bitwise the reference's."""
        rng = np.random.default_rng(seed)
        feature = rng.standard_normal((v_num, feature_size), dtype=np.float32) * 0.1
        label = rng.integers(0, label_num, size=v_num, dtype=np.int32)
        mask = (np.arange(v_num) % 3).astype(np.int32)
        return GNNDatum(feature=feature, label=label, mask=mask)

    @staticmethod
    def read_feature_label_mask(
        feature_file: str,
        label_file: str,
        mask_file: str,
        v_num: int,
        feature_size: int,
        seed: int = 0,
    ) -> "GNNDatum":
        rng = np.random.default_rng(seed)

        def fallback(kind: str, path: str) -> None:
            if path:
                log.warning("%s file %r missing — generating random %s", kind, path, kind)

        if feature_file and os.path.exists(feature_file):
            feature = _read_feature_table(feature_file, v_num, feature_size)
        else:
            fallback("feature", feature_file)
            feature = rng.standard_normal((v_num, feature_size), dtype=np.float32) * 0.1

        if label_file and os.path.exists(label_file):
            label = _read_id_value_table(label_file, v_num).astype(np.int32)
        else:
            fallback("label", label_file)
            label = rng.integers(0, 2, size=v_num, dtype=np.int32)

        if mask_file and os.path.exists(mask_file):
            mask = _read_mask_table(mask_file, v_num)
        else:
            fallback("mask", mask_file)
            mask = (np.arange(v_num) % 3).astype(np.int32)
        return GNNDatum(feature=feature, label=label, mask=mask)


def _read_feature_table(path: str, v_num: int, feature_size: int) -> np.ndarray:
    if path.endswith(".npy"):
        out = np.load(path).astype(np.float32, copy=False)
        if out.shape != (v_num, feature_size):
            raise ValueError(
                f"{path}: expected shape {(v_num, feature_size)}, got {out.shape}"
            )
        return out
    data = np.loadtxt(path, dtype=np.float32)
    if data.ndim == 1:
        data = data.reshape(1, -1)
    if data.shape[1] != feature_size + 1:
        raise ValueError(
            f"{path}: expected {feature_size + 1} columns (ID + features), "
            f"got {data.shape[1]}"
        )
    out = np.zeros((v_num, feature_size), dtype=np.float32)
    out[data[:, 0].astype(np.int64)] = data[:, 1:]
    return out


def _read_id_value_table(path: str, v_num: int) -> np.ndarray:
    data = np.loadtxt(path, dtype=np.int64)
    if data.ndim == 1:
        data = data.reshape(1, -1)
    out = np.zeros(v_num, dtype=np.int64)
    out[data[:, 0]] = data[:, 1]
    return out


def _read_mask_table(path: str, v_num: int) -> np.ndarray:
    out = np.full(v_num, MASK_TEST, dtype=np.int32)
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 2:
                continue
            out[int(parts[0])] = _MASK_NAMES.get(parts[1].strip().lower(), MASK_TEST)
    return out
