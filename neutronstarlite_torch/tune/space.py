"""The autotuner's typed candidate space — port of ``neutronstarlite_tpu/tune/space.py``.

A candidate is one (dist_path, kernel, ell_levels, wire_dtype, mesh,
sample_pipeline) tuple: the six cfg axes that take ``auto``.
:func:`enumerate_candidates` yields the tuples that are (a) shaped for the
trainer's family, (b) consistent with every axis the user pinned (a value
other than ``auto`` is a constraint) and (c) accepted by the trainer
class's own funnel check (``check_cfg``, the one its construction runs),
so the tuner never proposes what the funnel would refuse.

Families, keyed by the trainer's flags as in JAX:

- ``dist_dense`` (``supports_dist_path``: GCNDIST, GINDIST, COMMNETDIST
  and the eager variant): DIST_PATH all_gather vs ring_blocked, WIRE_DTYPE
  f32 vs bf16 (the ring only: the all_gather family ships the compute
  dtype) and MESH '' (1D) vs the ``Pf > 1`` factorizations of P (``(P,
  1)`` is the 1D layout itself and left out). The all_gather family is a
  candidate only on ranks that can form it (``mesh_reachable``): never on
  the sim twin, although the port's all_gather family has one, as in JAX.
- ``edge_single`` (``supports_fused_edge`` on one device: GAT, GGCN):
  KERNEL eager vs fused_edge, ELL_LEVELS binned vs pow2 for the fused
  tables.
- ``edge_dist`` (``supports_fused_edge``, ``needs_device_graph`` False:
  GATDIST, GGCNDIST): KERNEL eager (the mirror chain) vs fused_edge (the
  ring).
- ``sampled`` (``supports_sample_pipeline``: GCNSAMPLE): SAMPLE_PIPELINE
  '' (sync) vs pipelined vs device vs fused.
- ``plain`` (every other trainer): the single empty tuple.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Set

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("tune")

# the auto axes in label order (mesh and sample_pipeline last: labels grew
# at the end, and the cache schema with them)
AXES = ("dist_path", "kernel", "ell_levels", "wire_dtype", "mesh",
        "sample_pipeline")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the space; the empty string is the axis default (the
    edge chain, the heuristic dist path, the path's level ladder, the
    compute-dtype wire, the 1D mesh, sync sampling)."""

    dist_path: str = ""
    kernel: str = ""
    ell_levels: str = ""
    wire_dtype: str = ""
    mesh: str = ""
    sample_pipeline: str = ""

    def label(self) -> str:
        """The record and cache label: the values joined by '|', '-' for
        empty, e.g. ``ring_blocked|-|-|bf16|2,2|-``."""
        return "|".join(getattr(self, a) or "-" for a in AXES)

    def as_dict(self) -> dict:
        return {a: getattr(self, a) for a in AXES}

    @staticmethod
    def from_label(label: str) -> "Candidate":
        parts = label.split("|")
        if len(parts) != len(AXES):
            raise ValueError(f"malformed candidate label {label!r}")
        return Candidate(**{a: ("" if v == "-" else v) for a, v in zip(AXES, parts)})


def family_of(trainer_cls) -> str:
    """The tune-space family of a trainer class (module docstring)."""
    if getattr(trainer_cls, "supports_dist_path", False):
        return "dist_dense"
    if getattr(trainer_cls, "supports_fused_edge", False):
        if not getattr(trainer_cls, "needs_device_graph", True):
            return "edge_dist"
        return "edge_single"
    if getattr(trainer_cls, "supports_sample_pipeline", False):
        return "sampled"
    return "plain"


def auto_axes(cfg) -> Set[str]:
    """The axes the cfg marks ``auto``: the only ones the tuner sets."""
    return {a for a in AXES if getattr(cfg, a, "") == "auto"}


def _norm(axis: str, value: str) -> str:
    """An axis value for pinned-axis comparison: the sim spelling of the
    ring, the dtype and sampling aliases and ``PvxPf`` collapse."""
    v = (value or "").strip().lower()
    if axis == "dist_path" and v == "ring_blocked_sim":
        return "ring_blocked"
    if axis == "wire_dtype":
        return {"f32": "", "float32": "", "bfloat16": "bf16"}.get(v, v)
    if axis == "sample_pipeline":
        return {"sync": "", "off": "", "0": "", "on": "pipelined",
                "1": "pipelined"}.get(v, v)
    if axis == "mesh" and v not in ("", "auto"):
        from neutronstarlite_torch.parallel.partitioner import normalize_mesh_value

        return normalize_mesh_value(v)
    return v


def apply_candidate(cfg, cand: Candidate, autos: Optional[Set[str]] = None):
    """A copy of ``cfg`` with the candidate on its auto axes; pinned axes
    keep the user's spelling (``ring_blocked_sim`` stays the twin)."""
    if autos is None:
        autos = set(AXES)
    out = copy.copy(cfg)
    for a in autos:
        setattr(out, a, getattr(cand, a))
    return out


def candidate_valid(trainer_cls, cfg, cand: Candidate,
                    autos: Optional[Set[str]] = None) -> bool:
    """The candidate through the trainer class's own funnel check."""
    try:
        trainer_cls.check_cfg(apply_candidate(cfg, cand, autos))
    except ValueError:
        return False
    return True


def _axis_values(family: str, axis: str, autos: Set[str], cfg,
                 include_all_gather: bool, partitions: int = 0) -> List[str]:
    """The values one axis ranges over: a pinned axis only the user's
    value ('' included), an ``auto`` one its family's values."""
    if axis not in autos:
        return [getattr(cfg, axis, "")]
    if family == "dist_dense":
        if axis == "dist_path":
            return (["all_gather"] if include_all_gather else []) + ["ring_blocked"]
        if axis == "wire_dtype":
            return ["", "bf16"]
        if axis == "mesh":
            P = max(int(partitions), 1)
            return [""] + [f"{P // pf},{pf}" for pf in range(2, P + 1) if P % pf == 0]
    elif family == "edge_single":
        if axis == "kernel":
            return ["", "fused_edge"]
        if axis == "ell_levels":
            return ["binned", "pow2"]
    elif family == "edge_dist":
        if axis == "kernel":
            return ["", "fused_edge"]
    elif family == "sampled":
        if axis == "sample_pipeline":
            return ["", "pipelined", "device", "fused"]
    return [""]


def _consistent(family: str, cand: Candidate) -> bool:
    """Cross-axis rules the funnel only warns about: a warned-and-ignored
    knob must not make a candidate that measures as its base tuple."""
    if family == "dist_dense" and _norm("wire_dtype", cand.wire_dtype):
        # the wire dtype rides the ring (1D or 2D) only
        if _norm("dist_path", cand.dist_path) != "ring_blocked" and not cand.mesh:
            return False
    if family == "edge_single" and cand.ell_levels:
        # the ladder shapes only the fused tables
        if cand.kernel != "fused_edge":
            return False
    return True


def mesh_reachable(partitions: int) -> bool:
    """Whether a real P-way exchange can run: a joined process group of at
    least P ranks (JAX: at least P devices). On one card, only P = 1."""
    from neutronstarlite_torch.parallel import mesh

    return mesh.world_size() >= max(int(partitions), 1)


def enumerate_candidates(trainer_cls, cfg, partitions: int,
                         simulate: bool = False) -> List[Candidate]:
    """The valid tuples for (trainer class, cfg, P) on this rig, in order."""
    family = family_of(trainer_cls)
    autos = auto_axes(cfg)
    include_ag = not simulate and mesh_reachable(partitions)
    values = {a: _axis_values(family, a, autos, cfg, include_ag, partitions) for a in AXES}
    out = []
    for dp in values["dist_path"]:
        for kn in values["kernel"]:
            # an auto ladder pairs with the empty value where the knob has
            # no tables to shape (the edge chain)
            lvs = [""] if "ell_levels" in autos and kn != "fused_edge" \
                else values["ell_levels"]
            for lv in lvs:
                for wd in values["wire_dtype"]:
                    for ms in values["mesh"]:
                        for sp in values["sample_pipeline"]:
                            cand = Candidate(dist_path=dp, kernel=kn, ell_levels=lv,
                                             wire_dtype=wd, mesh=ms, sample_pipeline=sp)
                            if _consistent(family, cand) and candidate_valid(
                                    trainer_cls, cfg, cand, autos):
                                out.append(cand)
    return out
