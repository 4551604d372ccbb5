"""Toolkit lifecycle — port of ``neutronstarlite_tpu/models/base.py``.

``init_graph`` (edge list -> dual CSC/CSR with the trainer's edge weights,
``weight_mode``: the GCN norm, or ones where attention supplies them), ``init_nn``
(features, labels, masks -> device, then ``build_model``), ``from_arrays``
(the same from in-memory arrays: tests and the chip smoke), the masked NLL
loss, per-split accuracy and the report lines. Trainers are registered by
their ALGORITHM strings, as in the JAX registry.

Checkpoints (``CHECKPOINT_DIR``, ``CHECKPOINT_EVERY``, ``CKPT_BACKEND``):
the run loop calls ``ckpt_begin`` (resume, or the supervisor's rollback),
``emit_epoch`` (the health guards) and ``ckpt_epoch_end`` each epoch, and
``ckpt_final`` (which drains the sharded backend's saves in flight). The
saved state is the trainer's ``checkpoint_state()`` in the reference's
structure and leaf order, so each package restores the other's npz files.
On a joined world of more than one rank (the distributed trainers' ranks)
only world rank 0 writes npz checkpoints, and CHECKPOINT_DIR need not be
shared: world rank 0 reads its checkpoint, broadcasts the resume epoch and,
unless it is 0, the flat parameter and Adam state, and every rank applies
it (JAX's ``ckpt_begin`` rule). The sharded backend restores on every rank
at once when every rank sees the same completed step, else through the
same broadcast.

``NTS_ELASTIC=1`` (resilience/elastic) is checked at the funnel
(``_check_elastic``): it refuses on every class without
``supports_elastic`` (all but the fuse-op distributed family), as JAX does.

Run metrics (``obs/``), as in the reference: each trainer opens a metrics
registry (``obs.open_run``; the JSONL stream under ``NTS_METRICS_DIR``), a
tracer whose root ``run`` span opens here and closes in
``finalize_metrics``, and the ``NTS_SLO_SPEC`` engine's ``train`` scope; its
registry becomes the fault/recovery sink. ``emit_epoch`` writes the epoch
record, the ``train.epoch_ms`` histogram, the SLO tick and the epoch and
stage spans, then runs the guards; ``maybe_emit_numerics`` writes the
``NTS_NUMERICS`` tensor stats; ``finalize_metrics`` writes the
``run_summary`` (epoch times, memory, phases, counters, program costs) and
the ``NTS_LEDGER_DIR`` row. ``NTS_METRICS_PORT`` starts the live scrape
endpoint (``obs/exporter.py``) over the trainer's registry.

Auto axes (``tune/``): ``_resolve_tune_autos`` runs right after
``host_graph`` exists (``init_graph``, ``from_arrays``) and again, as a
no-op, at the head of ``_finalize_datum``, before any table for a route is
built; it turns each ``auto`` axis into a concrete value
(``tune.select.resolve_auto_knobs``, ``NTS_TUNE``). Each trainer class has
one check entry point, ``check_cfg``, which its construction runs and the
tuner's candidate probe (``tune.space.candidate_valid``) calls, and the
flags that place it in a tune-space family (``supports_dist_path``,
``supports_fused_edge``, ``supports_sample_pipeline``,
``needs_device_graph``).

Device rule: every entry point takes an explicit ``device``. ``None`` means
the CUDA card, and raises when there is none: the port never carries on
quietly on the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Type

import numpy as np
import torch

from neutronstarlite_torch import obs
from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.digest import graph_digest
from neutronstarlite_torch.graph.storage import CSCGraph, build_graph, load_edges
from neutronstarlite_torch.nn.param import adam_init, param_leaves, param_tree
from neutronstarlite_torch.obs import collectors, cost
from neutronstarlite_torch.obs import exporter as obs_exporter
from neutronstarlite_torch.obs import ledger as obs_ledger
from neutronstarlite_torch.obs import numerics as obs_numerics
from neutronstarlite_torch.obs.slo import SloEngine
from neutronstarlite_torch.resilience import elastic, events, guards
from neutronstarlite_torch.utils import checkpoint as ckpt
from neutronstarlite_torch.utils import tree as tree_util
from neutronstarlite_torch.utils.config import (
    SUPPORTED_ALGORITHMS,
    InputInfo,
    check_algorithm,
    check_supported,
)
from neutronstarlite_torch.utils.logging import get_logger
from neutronstarlite_torch.utils.timing import PhaseTimers, get_time

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
        check_algorithm(name)  # names the slice of a planned trainer
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
    # the tune-space family flags (tune/space.family_of), JAX's names: a
    # single-device trainer holds the whole graph on the device, the
    # distributed and the sampled ones do not
    needs_device_graph = True
    supports_fused_edge = False  # KERNEL:fused_edge (GAT, GGCN and their dist twins)
    supports_sample_pipeline = False  # SAMPLE_PIPELINE (the sampled trainer)
    supports_dist_path = False  # DIST_PATH, WIRE_DTYPE, MESH (the GCN dist family)
    # NTS_ELASTIC=1: liveness and the survivor replan (the fuse-op dist family)
    supports_elastic = False

    @classmethod
    def check_cfg(cls, cfg: InputInfo) -> None:
        """The funnel's refusals for this class: the one check that its
        construction runs and the tuner's candidate probe calls."""
        check_supported(cfg, resident=False, supports_fused_edge=cls.supports_fused_edge)

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
        # the first epoch this process trained: maps epoch numbers onto
        # epoch_times indices after a resume
        self._first_epoch_trained: Optional[int] = None
        # set by supervised_run before a retry: "rollback" or "restart"
        self._supervised_retry = False
        # host seconds of build_model (the kernel tables and the model)
        self.build_model_s = 0.0
        # run metrics: the registry, the span tracer with its root "run"
        # span (closed in finalize_metrics), the train-scope SLO engine
        name = cfg.algorithm or type(self).__name__
        self.timers = PhaseTimers()
        self.metrics = obs.open_run(name, cfg=cfg, seed=seed)
        self.tracer = obs.Tracer(self.metrics)
        self.timers.tracer = self.tracer
        self._run_span = self.tracer.begin("run", cat="lifecycle", algorithm=name)
        self.run_summary_record: Optional[dict] = None
        self._step_cost_done = False  # program_cost is captured once per trainer
        events.adopt_registry(self.metrics)
        self.slo = SloEngine.from_env(self.metrics, scope="train")
        # NTS_METRICS_PORT: the process's scrape endpoint rebinds to the
        # newest trainer (a train-then-serve run hands it to the server)
        obs_exporter.maybe_start(self.metrics, slo=self.slo)

    def _log_graph(self) -> None:
        g = self.host_graph
        log.info("loaded graph |V|=%d |E|=%d avg_deg=%.1f", g.v_num, g.e_num, g.avg_degree)

    # ---- init_graph ------------------------------------------------------
    def init_graph(self) -> None:
        cfg = self.cfg
        with self.timers.phase("graph_load"):
            src, dst = load_edges(cfg.resolve_path(cfg.edge_file, self.base_dir))
            self.host_graph = build_graph(src, dst, cfg.vertices, weight=self.weight_mode)
            self._resolve_tune_autos()
        self._log_graph()

    # ---- init_nn ---------------------------------------------------------
    def init_nn(self) -> None:
        cfg = self.cfg
        with self.timers.phase("datum_load"):
            self.datum = GNNDatum.read_feature_label_mask(
                cfg.resolve_path(cfg.feature_file, self.base_dir),
                cfg.resolve_path(cfg.label_file, self.base_dir),
                cfg.resolve_path(cfg.mask_file, self.base_dir),
                cfg.vertices,
                cfg.layer_sizes()[0],
                seed=self.seed,
            )
        self._finalize_datum()

    def _resolve_tune_autos(self) -> None:
        """Every ``auto`` axis -> a concrete cfg value (``tune/select``);
        a no-op once resolved. The funnel's checks run after it, on the
        concrete values."""
        from neutronstarlite_torch.tune import select as tune_select

        tune_select.resolve_auto_knobs(self)

    def _check_elastic(self) -> None:
        """``NTS_ELASTIC=1`` refuses where there is no partitioned plan to
        rebuild, instead of letting the rank loss it was armed against end
        the run."""
        if elastic.elastic_enabled() and not type(self).supports_elastic:
            raise ValueError(
                f"NTS_ELASTIC=1 is not available for ALGORITHM {self.cfg.algorithm!r}: "
                "elastic degraded-mode training (rank-loss detection + survivor replan) "
                "serves the fuse-op dist family (GCNDIST / GINDIST / COMMNETDIST and "
                "their eager variants); single-chip and mirror-family trainers have no "
                "partitioned plan to rebuild"
            )

    def _finalize_datum(self) -> None:
        self._resolve_tune_autos()
        self._check_elastic()
        dev = self.device
        self.feature = torch.from_numpy(self.datum.feature).to(dev)
        self.label = torch.from_numpy(self.datum.label.astype(np.int64)).to(dev)
        self.mask = torch.from_numpy(self.datum.mask).to(dev)
        t0 = get_time()
        self.build_model()
        self.build_model_s = get_time() - t0

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
        t.host_graph = (
            host_graph
            if host_graph is not None
            else build_graph(src, dst, cfg.vertices, weight=cls.weight_mode)
        )
        t._resolve_tune_autos()
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
    # the trainers keep ``params`` (a list of per-layer dicts of tensors),
    # ``flat_params`` (its ``param_leaves``) and ``opt_state`` (AdamState)
    def checkpoint_state(self) -> Dict[str, Any]:
        """``{"params": ..., "opt": ...}`` in the reference's structure."""
        return {
            "params": self.params,
            "opt": self.opt_state.as_tree(lambda flat: param_tree(self.params, flat)),
        }

    @torch.no_grad()
    def _apply_restored(self, state) -> None:
        """Copy a restored state (numpy leaves) into the parameters and the
        optimizer in place."""
        for t, a in zip(param_leaves(self.params), param_leaves(state["params"])):
            t.copy_(torch.from_numpy(a))
        opt = state["opt"]
        for mine, got in ((self.opt_state.m, opt.m), (self.opt_state.v, opt.v)):
            for t, a in zip(mine, param_leaves(got)):
                t.copy_(torch.from_numpy(a))
        self.opt_state.step = int(opt.step)

    @torch.no_grad()
    def load_params(self, params: List[Dict[str, Any]]) -> None:
        """Overwrite the parameters (same structure and shapes) and reset
        the optimizer state."""
        new = param_leaves(params)
        if len(new) != len(self.flat_params):
            raise ValueError(
                f"expected {len(self.flat_params)} parameter tensors, got {len(new)}"
            )
        for p, q in zip(self.flat_params, new):
            if tuple(p.shape) != tuple(q.shape):
                raise ValueError(f"parameter shape {tuple(q.shape)} != {tuple(p.shape)}")
            p.copy_(q.to(p.device, p.dtype))
        self.opt_state = adam_init(self.flat_params)


    def _ckpt_backend(self) -> str:
        return ckpt.resolve_backend(self.cfg.ckpt_backend)

    def save(self, path: str, epoch: int) -> None:
        ckpt.save_checkpoint(path, self.checkpoint_state(), epoch,
                             backend=self._ckpt_backend())

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
        got = ckpt.restore_checkpoint(path, self.checkpoint_state(),
                                      backend=self._ckpt_backend())
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
        start = self._ckpt_resume()
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

    def _ckpt_resume(self) -> int:
        """The restored epoch (0 without CHECKPOINT_DIR). With a joined
        world of more than one rank (``self.world``) world rank 0 reads its
        checkpoint on the host and broadcasts the epoch, then, unless it is
        0, the state; the sharded backend restores on every rank when every
        rank sees the same completed step."""
        path = self.cfg.checkpoint_dir
        if not path:
            return 0
        world = getattr(self, "world", None)
        if world is None or world.world <= 1:
            return self.restore(path)
        backend = self._ckpt_backend()
        dev = self.device
        if backend == "orbax":
            step = ckpt.orbax_latest_step(path)
            seen = torch.tensor([-1 if step is None else step] * 2, dtype=torch.int64,
                                device=dev)
            seen[1] = -seen[1]
            lo_neg_hi = world.max_(seen)  # [max step, -min step]
            if int(lo_neg_hi[0]) == -int(lo_neg_hi[1]) >= 0:
                return self.restore(path)  # every rank reads the shared step
        like = self.checkpoint_state()
        got = (ckpt.restore_checkpoint(path, like, backend=backend, local=True)
               if world.rank == 0 else None)
        step_t = torch.tensor([got[1] if got else 0], dtype=torch.int64, device=dev)
        step = int(world.broadcast_(step_t)[0])
        if step == 0:  # no checkpoint: no model-sized broadcast
            return 0
        src = got[0] if got is not None else like
        flat = torch.cat([torch.as_tensor(np.asarray(
            leaf.detach().cpu() if torch.is_tensor(leaf) else leaf),
            dtype=torch.float64).reshape(-1) for leaf in tree_util.leaves(src)]).to(dev)
        flat = world.broadcast_(flat).cpu().numpy()
        leaves, at = [], 0
        for leaf in tree_util.leaves(like):
            shape = tuple(np.shape(leaf.detach() if torch.is_tensor(leaf) else leaf))
            n = int(np.prod(shape))
            leaves.append(flat[at:at + n].reshape(shape).astype(ckpt._np_dtype(leaf)))
            at += n
        state = tree_util.unflatten_like(like, leaves)
        self._validate_restored(state)
        self._apply_restored(state)
        log.info("restored checkpoint at epoch %d from %s (broadcast from rank 0)", step, path)
        return step

    def ckpt_epoch_end(self, epoch: int) -> None:
        cfg = self.cfg
        if cfg.checkpoint_dir and cfg.checkpoint_every > 0 \
                and (epoch + 1) % cfg.checkpoint_every == 0:
            self.save(cfg.checkpoint_dir, epoch + 1)

    def ckpt_final(self) -> None:
        if self.cfg.checkpoint_dir:
            self.save(self.cfg.checkpoint_dir, self.cfg.epochs)
            ckpt.finalize_checkpoints()  # drain the sharded saves in flight

    # ---- run metrics -----------------------------------------------------
    def emit_epoch(self, epoch: int, seconds: float, loss=None,
                   stages: Optional[dict] = None, **extra):
        """Record one trained epoch in the metrics stream, then run the
        health guards (they raise only when armed): after the epoch is in
        the history and the stream, before ``ckpt_epoch_end`` could save a
        poisoned state.

        ``stages``: ordered {name: seconds} sub-intervals of the epoch
        (``step_dispatch``/``step_device``, or ``NTS_TRACE_STEP``'s
        ``forward_backward``/``optim``), emitted as child spans laid back to
        back from the epoch's start and attached to the epoch record."""
        if self._first_epoch_trained is None:
            self._first_epoch_trained = epoch
        if stages:
            extra = dict(extra, stages={k: float(v) for k, v in stages.items()})
        rec = self.metrics.epoch_event(
            epoch, seconds, loss=float(loss) if loss is not None else None, **extra,
        )
        self.metrics.hist_observe("train.epoch_ms", seconds * 1000.0)
        if self.slo is not None:
            self.slo.tick()
        # retroactive spans: the epoch just ended, so its end is now
        end = get_time()
        span = self.tracer.complete(
            "epoch", dur_s=seconds, end=end, cat="epoch", parent=self._run_span,
            epoch=int(epoch),
        )
        self._last_epoch_span = span
        if stages:
            t = end - seconds
            for name, dur in stages.items():
                self.tracer.complete(name, dur_s=float(dur), t0=t, cat="stage",
                                     parent=span, epoch=int(epoch))
                t += float(dur)
        guards.epoch_check(self, epoch, seconds, loss)
        return rec

    def maybe_emit_numerics(self, epoch: int, stats_dev) -> float:
        """``NTS_NUMERICS=1``: the step's device stats (``obs/numerics``),
        fetched in one copy and written as ``tensor_stats`` records every
        ``NTS_NUMERICS_EVERY`` epochs. Called before ``emit_epoch``, so a
        failing epoch's stats are in the stream before its guard trips.
        Returns the host seconds it took, which the run loops keep out of
        the epoch's time."""
        if stats_dev is None or epoch % obs_numerics.numerics_every() != 0:
            return 0.0
        t0 = get_time()
        stats = obs_numerics.fetch_stats(stats_dev)
        try:
            obs_numerics.emit_stats(self.metrics, stats, epoch)
        except Exception as e:  # the records are telemetry: a failed write warns
            log.warning("numerics emission failed at epoch %d: %s", epoch, e)
        return get_time() - t0

    def numerics_replay(self, epoch: int):
        """Ordered ``(layer, op, label, tensor)`` intermediates of the
        failing epoch's forward, replayed layer by layer for the non-finite
        provenance (``obs/numerics.capture_provenance``), with
        ``numerics.poison_hook`` applied at each layer. None: this trainer
        has no replay hook, and the record is unattributed."""
        return None

    def count_program_cost(self, label: str, step, state: List[torch.Tensor],
                           **extra) -> None:
        """Once per trainer, when program costs are captured for this run
        (``NTS_PROGRAM_COST``, ``obs/cost``): run ``step()`` once, counted,
        outside any timed epoch, then put back ``state`` (the tensors the
        step changes) and the optimizer's update count, and write the
        step's and its kernels' ``program_cost`` records."""
        if self._step_cost_done or not cost.cost_enabled(self.metrics):
            return
        self._step_cost_done = True
        saved = [t.detach().clone() for t in state]
        opt_step = self.opt_state.step
        with cost.count_step(self.device) as count:
            step()
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)
        self.opt_state.step = opt_step
        for p in self.flat_params:
            p.grad = None
        g = self.host_graph
        cost.capture_program_cost(self.metrics, label, count, g.e_num, g.v_num,
                                  self.device.type, **extra)

    def finalize_metrics(self, result: Optional[dict] = None) -> dict:
        """Write the consolidated ``run_summary`` record (idempotent: a
        second call returns the first record) and the ledger row."""
        if self.run_summary_record is not None:
            return self.run_summary_record
        if self.slo is not None:
            self.slo.close()
        # the root span closes before the summary that consolidates it
        if self._run_span is not None:
            self.tracer.end(self._run_span, epochs=len(self.epoch_times))
            self._run_span = None
        fields: dict = {
            "epochs": len(self.epoch_times),
            "epoch_time": collectors.steady_state_stats(self.epoch_times),
            "avg_epoch_s": self.avg_epoch_time(),
            "epoch_times_s": [float(t) for t in self.epoch_times],
            "loss_history": [float(v) for v in self.loss_history],
            "phases": collectors.phase_snapshot(self.timers),
            "memory": collectors.device_memory_stats(self.device),
            "compile_cache": collectors.compile_cache_info(),
        }
        if result is not None:
            fields["result"] = {
                "loss": result.get("loss"),
                "acc": result.get("acc"),
                "avg_epoch_s": result.get("avg_epoch_s"),
            }
        self.run_summary_record = self.metrics.run_summary(**fields)
        self._append_ledger_row()
        self.metrics.close()
        return self.run_summary_record

    def _append_ledger_row(self) -> None:
        """One ``kind=run`` row into the perf ledger (``NTS_LEDGER_DIR``;
        unset: nothing; a failed write warns)."""
        if not obs_ledger.ledger_dir():
            return
        try:
            digest = graph_digest(self.host_graph) if self.host_graph is not None else None
            obs_ledger.append_row(obs_ledger.run_row(self.run_summary_record, digest))
        except Exception as e:
            log.warning("perf ledger append failed: %s", e)

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

    @staticmethod
    def skip_final_eval(loss) -> bool:
        """``NTS_FINAL_EVAL=0``: benchmark mode, no end-of-run accuracy pass
        (only when an epoch ran, so that a restore-only run still reports
        the restored model's accuracy)."""
        return os.environ.get("NTS_FINAL_EVAL", "1") == "0" and loss is not None

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
        return self.timers.report() + f"\n#device={self.device}"
