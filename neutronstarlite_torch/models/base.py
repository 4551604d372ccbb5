"""Toolkit lifecycle — port of ``neutronstarlite_tpu/models/base.py``.

``init_graph`` (edge list -> dual CSC/CSR with the trainer's edge weights,
``weight_mode``: the GCN norm, or ones where attention supplies them), ``init_nn``
(features, labels, masks -> device, then ``build_model``), ``from_arrays``
(the same from in-memory arrays: tests and the chip smoke), the masked NLL
loss, per-split accuracy and the report lines. Trainers are registered by
their ALGORITHM strings, as in the JAX registry.

Checkpoints (``CHECKPOINT_DIR``, ``CHECKPOINT_EVERY``): the run loop calls
``ckpt_begin`` (resume, or the supervisor's rollback), ``emit_epoch`` (the
health guards) and ``ckpt_epoch_end`` each epoch, and ``ckpt_final``. The
saved state is the trainer's ``checkpoint_state()`` in the reference's
structure and leaf order, so each package restores the other's files.

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
from neutronstarlite_torch.resilience import events, guards
from neutronstarlite_torch.utils import checkpoint as ckpt
from neutronstarlite_torch.utils import tree as tree_util
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
        # the first epoch this process trained: maps epoch numbers onto
        # epoch_times indices after a resume
        self._first_epoch_trained: Optional[int] = None
        # set by supervised_run before a retry: "rollback" or "restart"
        self._supervised_retry = False

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

    def init_model(self) -> None:
        """(Re)initialise the parameters and the optimizer on the tables
        already built (the supervisor's restart)."""
        raise NotImplementedError

    # ---- checkpoint / resume ----------------------------------------------
    def checkpoint_state(self) -> Dict[str, object]:
        """``{"params": ..., "opt": ...}`` in the reference's structure."""
        raise NotImplementedError

    def _apply_restored(self, state) -> None:
        raise NotImplementedError

    def save(self, path: str, epoch: int) -> None:
        ckpt.save_checkpoint(path, self.checkpoint_state(), epoch)

    def _validate_restored(self, state) -> None:
        """Refuse a checkpoint whose leaf shapes do not fit the model,
        naming the leaves (e.g. LAYERS changed between save and resume)."""
        mismatches = []
        template = self.checkpoint_state()
        for name in ("params", "opt"):
            got = state.get(name)
            if got is None:
                continue
            for (path, t_leaf), g_leaf in zip(tree_util.flatten_with_path(template[name]),
                                              tree_util.leaves(got)):
                t_shape, g_shape = tuple(np.shape(t_leaf)), tuple(np.shape(g_leaf))
                if t_shape != g_shape:
                    mismatches.append(
                        f"{name}{path}: checkpoint {g_shape} vs model {t_shape}"
                    )
        if mismatches:
            raise ValueError(
                "checkpoint does not fit this model (did LAYERS/HIDDEN change "
                "between save and resume?); mismatched leaves: " + "; ".join(mismatches)
            )

    def restore(self, path: str) -> int:
        """The epoch to resume from (0 when there is no checkpoint)."""
        got = ckpt.restore_checkpoint(path, self.checkpoint_state())
        if got is None:
            return 0
        state, step = got
        self._validate_restored(state)
        self._apply_restored(state)
        log.info("restored checkpoint at epoch %d from %s", step, path)
        return step

    def ckpt_begin(self) -> int:
        """The epoch the run loop starts at (0 without CHECKPOINT_DIR). A
        resume is recorded as ``recovery(action=resume)``, except in a
        supervised retry, whose rollback the supervisor recorded. A retry
        rewinds ``epoch_times``/``loss_history`` to the resume point, so
        the rolled-back tail does not count twice; when a rollback finds
        no intact step, the model is re-initialised instead of training
        on with the poisoned state."""
        retry = self._supervised_retry
        start = self.restore(self.cfg.checkpoint_dir) if self.cfg.checkpoint_dir else 0
        if retry:
            if start == 0 and retry == "rollback":
                log.warning(
                    "supervised rollback found no restorable checkpoint under %s; "
                    "re-initialising the model", self.cfg.checkpoint_dir,
                )
                self.init_model()
                events.emit_recovery(action="restart", epoch=0)
            first = self._first_epoch_trained
            keep = max(start - (first if first is not None else 0), 0)
            del self.epoch_times[keep:]
            del self.loss_history[keep:]
            if keep == 0:
                self._first_epoch_trained = None
        elif start > 0:
            events.emit_recovery(action="resume", epoch=start)
        self._supervised_retry = False
        return start

    def ckpt_epoch_end(self, epoch: int) -> None:
        cfg = self.cfg
        if cfg.checkpoint_dir and cfg.checkpoint_every > 0 \
                and (epoch + 1) % cfg.checkpoint_every == 0:
            self.save(cfg.checkpoint_dir, epoch + 1)

    def ckpt_final(self) -> None:
        if self.cfg.checkpoint_dir:
            self.save(self.cfg.checkpoint_dir, self.cfg.epochs)

    def emit_epoch(self, epoch: int, seconds: float, loss=None) -> None:
        """Record one trained epoch, then run the health guards (they raise
        only when armed): after the epoch is in the history, before
        ``ckpt_epoch_end`` could save a poisoned state. The reference also
        writes the epoch to its metrics stream here (the obs slice)."""
        if self._first_epoch_trained is None:
            self._first_epoch_trained = epoch
        guards.epoch_check(self, epoch, seconds, loss)

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
