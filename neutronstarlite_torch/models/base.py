"""Toolkit lifecycle — port of ``neutronstarlite_tpu/models/base.py``.

``init_graph`` (edge list -> dual CSC/CSR with the trainer's edge weights,
``weight_mode``: the GCN norm, or ones where attention supplies them), ``init_nn``
(features, labels, masks -> device, then ``build_model``), ``from_arrays``
(the same from in-memory arrays: tests and the chip smoke), the masked NLL
loss, per-split accuracy and the report lines. Trainers are registered by
their ALGORITHM strings, as in the JAX registry.

Device rule: every entry point takes an explicit ``device``. ``None`` means
the CUDA card, and raises when there is none: the port never carries on
quietly on the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Type

import numpy as np
import torch

from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import CSCGraph, build_graph, load_edges
from neutronstarlite_torch.utils.config import SUPPORTED_ALGORITHMS, InputInfo
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("models")

_REGISTRY: Dict[str, Type["ToolkitBase"]] = {}


def register_algorithm(*names: str):
    """Register a trainer under its ALGORITHM string(s)."""

    def deco(cls):
        for n in names:
            _REGISTRY[n.upper()] = cls
        return cls

    return deco


def get_algorithm(name: str) -> Type["ToolkitBase"]:
    cls = _REGISTRY.get(name.upper())
    if cls is None:
        raise ValueError(
            f"ALGORITHM {name!r} is not ported yet; the torch port implements "
            f"{', '.join(SUPPORTED_ALGORITHMS)}"
        )
    return cls


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card, or raise; otherwise the named device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' (CLI: --device "
                "cpu) to run the port on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, got {device!r}")
    return dev


class ToolkitBase:
    """Shared lifecycle: graph + datum loading, accuracy reporting, timing."""

    weight_mode = "gcn_norm"

    def __init__(
        self, cfg: InputInfo, base_dir: Optional[str] = None, seed: int = 0, device=None
    ):
        self.cfg = cfg
        self.base_dir = base_dir
        self.seed = seed
        self.device = resolve_device(device)
        self.host_graph: Optional[CSCGraph] = None
        self.datum: Optional[GNNDatum] = None
        self.epoch_times: list = []
        self.loss_history: list = []
        self.phase_times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_times[name] = (
                self.phase_times.get(name, 0.0) + time.perf_counter() - t0
            )

    def _log_graph(self) -> None:
        g = self.host_graph
        log.info("loaded graph |V|=%d |E|=%d avg_deg=%.1f", g.v_num, g.e_num, g.avg_degree)

    # ---- init_graph ------------------------------------------------------
    def init_graph(self) -> None:
        cfg = self.cfg
        with self.phase("graph_load"):
            src, dst = load_edges(cfg.resolve_path(cfg.edge_file, self.base_dir))
            self.host_graph = build_graph(src, dst, cfg.vertices, weight=self.weight_mode)
        self._log_graph()

    # ---- init_nn ---------------------------------------------------------
    def init_nn(self) -> None:
        cfg = self.cfg
        with self.phase("datum_load"):
            self.datum = GNNDatum.read_feature_label_mask(
                cfg.resolve_path(cfg.feature_file, self.base_dir),
                cfg.resolve_path(cfg.label_file, self.base_dir),
                cfg.resolve_path(cfg.mask_file, self.base_dir),
                cfg.vertices,
                cfg.layer_sizes()[0],
                seed=self.seed,
            )
        self._finalize_datum()

    def _finalize_datum(self) -> None:
        dev = self.device
        self.feature = torch.from_numpy(self.datum.feature).to(dev)
        self.label = torch.from_numpy(self.datum.label.astype(np.int64)).to(dev)
        self.mask = torch.from_numpy(self.datum.mask).to(dev)
        with self.phase("build_model"):
            self.build_model()

    @classmethod
    def from_arrays(
        cls,
        cfg: InputInfo,
        src: np.ndarray,
        dst: np.ndarray,
        datum: GNNDatum,
        seed: int = 0,
        device=None,
        host_graph: Optional[CSCGraph] = None,
    ) -> "ToolkitBase":
        """Construct from an in-memory edge list + datum. ``host_graph``
        shares one prebuilt CSC/CSR (matching ``weight_mode``) across
        trainers."""
        t = cls(cfg, seed=seed, device=device)
        with t.phase("graph_load"):
            t.host_graph = (
                host_graph
                if host_graph is not None
                else build_graph(src, dst, cfg.vertices, weight=cls.weight_mode)
            )
        t._log_graph()
        t.datum = datum
        t._finalize_datum()
        return t

    def build_model(self) -> None:
        raise NotImplementedError

    # ---- accuracy / loss helpers ----------------------------------------
    @staticmethod
    def masked_nll_loss(
        logits: torch.Tensor, label: torch.Tensor, mask01: torch.Tensor
    ) -> torch.Tensor:
        """nll_loss on masked log_softmax."""
        logp = torch.log_softmax(logits, dim=-1)
        picked = logp.gather(1, label[:, None])[:, 0]
        denom = torch.clamp(mask01.sum(), min=1.0)
        return -(picked * mask01).sum() / denom

    def test(self, logits: np.ndarray, which: int) -> float:
        """Accuracy over mask class ``which`` (0 train, 1 eval, 2 test)."""
        sel = self.datum.mask == which
        n = int(sel.sum())
        if n == 0:
            return 0.0
        correct = int((logits[sel].argmax(axis=1) == self.datum.label[sel]).sum())
        acc = correct / n
        name = {0: "Train", 1: "Eval", 2: "Test"}[which]
        log.info("%s Acc: %f %d %d", name, acc, n, correct)
        return acc

    def avg_epoch_time(self) -> float:
        """Mean epoch time, the first (kernel build) epoch excluded when
        more than one was timed."""
        times = self.epoch_times[1:] if len(self.epoch_times) > 1 else self.epoch_times
        return float(np.mean(times)) if times else 0.0

    def report(self) -> str:
        lines = ["--------------------finish algorithm !"]
        for name, t in sorted(self.phase_times.items()):
            lines.append(f"#{name}_time={t:.6f}(s)")
        lines.append(f"#device={self.device}")
        return "\n".join(lines)
