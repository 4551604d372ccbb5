"""The 2D (vertex x feature) mesh — port of ``neutronstarlite_tpu/parallel/partitioner.py``.

``MESH:Pv,Pf`` lays the distributed trainers' ranks out as a ``(Pv, Pf)``
grid (``parallel/mesh.Grid2D``): Pv vertex shards, each feature slab split
Pf ways. The pipelined ring (``dist_ring_blocked.py``) rotates over the
vertex group of a slab, so each rank holds and ships ``[vp, f/Pf]`` slabs;
``(Pv, 1)`` is the 1D ring itself. The feature axis is reduced only where
the layer contracts it: ``agg @ W`` (``Partitioner.contract``).

Widths that ``Pf`` does not divide are zero-padded to the next multiple
(``padded_width``): the input feature gains zero columns and layer 0's
feature-dim parameters zero rows (``pad_params_feature_dim``), which stay
zero through training, so the padded model computes the unpadded math.
Checkpoints hold the unpadded parameters.

The sim twin (one process, ``grid=None``) keeps every array full width; as
in JAX its exchange is the 1D twin (the aggregation is column-independent)
and its contraction sums one partial product per feature slab, in slab
order, the all-reduce made deterministic.

On ranks, activations come in two forms. A *slab* lives on one rank of
its feature group: the feature input, every exchange's output. A
*replicated* tensor is held whole, and equal, by every rank of a feature
group: every contraction's output and what is computed from it.
``scatter`` cuts a replicated tensor to this rank's slab (zero-padded),
``contract`` turns slabs into a replicated product (the slab's partial
product, all-reduced over the feature group), and ``gather`` turns an
exchange's output slabs back into a replicated tensor (the eager order's
logits). The gradient rule: **summed over all ranks, the gradients of
every rank's copies of a tensor are its true gradient.** Each rank's loss
is its vertex shard's share divided by Pf (so the world's sum of the
losses is the loss); ``scatter``'s backward is the plain slice's (this
slab's gradient, zeros elsewhere); the contraction's all-reduce has an
all-reduce for its backward, ``gather``'s a reduce-scatter. The
parameters' gradients are then summed over the whole world, once, after
the backward: a parameter read as slab rows (``W`` in the contraction,
batch norm on a slab) adds disjoint rows, one read whole by replicated
code adds Pf copies that each hold 1/Pf of it. Batch-norm statistics and
the loss's denominator are summed over the vertex group only.

``MESH:auto`` and ``NTS_MESH=auto`` leave the shape to the autotuner
(``tune/``), which picks among ``factor_shapes`` of the device budget at
the head of the trainer's funnel; an ``auto`` that reaches ``mesh_spec_of``
unresolved is refused. ``choose_mesh_shape`` is the analytic choice
(``tools/wire_accounting.predict_mesh``).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from neutronstarlite_torch.parallel import mesh


def slab_width(width: int, pf: int) -> int:
    """Feature-slab columns of a ``width``-wide tensor on a ``pf``-way
    feature axis: ``ceil(width / pf)``, the one definition the wire gauges,
    ``ring_wire_plan`` and ``wire_accounting.predict_mesh`` share."""
    pf = max(int(pf), 1)
    return -(-int(width) // pf)


def padded_width(width: int, pf: int) -> int:
    """``width`` rounded up to a multiple of ``pf``."""
    return slab_width(width, pf) * max(int(pf), 1)


# ---- the MESH value ---------------------------------------------------------

_MESH_RE = re.compile(r"^(\d+)\s*[x,]\s*(\d+)$")


def normalize_mesh_value(value: str) -> str:
    """'' | 'auto' | 'Pv,Pf' ('PvxPf' becomes the comma form); anything
    else is refused."""
    v = (value or "").strip().lower()
    if v in ("", "auto"):
        return v
    m = _MESH_RE.match(v)
    if not m:
        raise ValueError(
            f"MESH must be 'Pv,Pf' (or 'PvxPf'), 'auto', or empty, "
            f"got {value!r}"
        )
    pv, pf = int(m.group(1)), int(m.group(2))
    if pv < 1 or pf < 1:
        raise ValueError(
            f"MESH:{value} is not a mesh: both axes must be >= 1"
        )
    return f"{pv},{pf}"


def fold_mesh_env(cfg) -> None:
    """``NTS_MESH`` overrides ``cfg.mesh``, folded at the head of the
    funnel so that the env spelling goes through the same auto-resolution
    and checks as the cfg key. Once per cfg: a second fold of
    ``NTS_MESH=auto`` would undo the shape the tuner resolved."""
    if getattr(cfg, "_nts_mesh_folded", False):
        return
    raw = os.environ.get("NTS_MESH", "")
    if raw.strip():
        cfg.mesh = normalize_mesh_value(raw)
    cfg._nts_mesh_folded = True


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """One concrete mesh shape: ``pv`` vertex shards x ``pf`` feature slabs."""

    pv: int
    pf: int

    @property
    def devices(self) -> int:
        return self.pv * self.pf

    def label(self) -> str:
        """e.g. ``2x2`` (the mesh.shape gauge)."""
        return f"{self.pv}x{self.pf}"

    def cfg_value(self) -> str:
        """e.g. ``2,2``."""
        return f"{self.pv},{self.pf}"

    @staticmethod
    def parse(value: str) -> "MeshSpec":
        v = normalize_mesh_value(value)
        if v in ("", "auto"):
            raise ValueError(
                f"MESH value {value!r} is not a concrete shape "
                "(auto must resolve through the tuner first)"
            )
        pv, pf = (int(t) for t in v.split(","))
        return MeshSpec(pv=pv, pf=pf)


def mesh_spec_of(cfg) -> Optional[MeshSpec]:
    """The MeshSpec a cfg asks for, or None (the 1D layout). An ``auto``
    here was never resolved by the tuner: refused."""
    v = normalize_mesh_value(getattr(cfg, "mesh", "") or "")
    if not v:
        return None
    if v == "auto":
        raise ValueError(
            "MESH:auto reached build_model unresolved: set NTS_TUNE="
            "cached or NTS_TUNE=measure so the autotuner can choose the "
            "shape, or pin MESH:Pv,Pf"
        )
    return MeshSpec.parse(v)


def check_mesh_cfg(cfg) -> None:
    """JAX's refusals: a MESH rides the ring only, and PARTITIONS (when set)
    must equal ``Pv * Pf``."""
    spec = mesh_spec_of(cfg)
    if spec is None:
        return
    dist_path = getattr(cfg, "dist_path", "")
    if dist_path not in ("", "auto", "ring_blocked", "ring_blocked_sim"):
        raise ValueError(
            f"MESH:{spec.cfg_value()} rides the ring-pipelined layout "
            f"(parallel/partitioner.py) and cannot combine with "
            f"DIST_PATH:{dist_path}: the {dist_path} family replicates "
            "the feature axis"
        )
    if getattr(cfg, "optim_kernel", False):
        raise ValueError(
            f"MESH:{spec.cfg_value()} cannot combine with OPTIM_KERNEL:1 "
            "(the all_gather ELL family materializes every [vp, f] shard "
            "full-width); drop one"
        )
    comm = getattr(cfg, "comm_layer", "auto")
    if comm not in ("", "auto", "ring"):
        raise ValueError(
            f"MESH:{spec.cfg_value()} cannot combine with "
            f"COMM_LAYER:{comm}: the mirror/ell exchanges ship full-width "
            "feature rows; the 2D layout is ring-only"
        )
    parts = int(getattr(cfg, "partitions", 0) or 0)
    if parts and parts != spec.devices:
        raise ValueError(
            f"MESH:{spec.cfg_value()} needs Pv*Pf = {spec.devices} "
            f"devices but PARTITIONS:{parts} disagrees — set "
            f"PARTITIONS:{spec.devices} or drop it (0 = derive from the "
            "mesh)"
        )


# ---- padding ----------------------------------------------------------------


def pad_feature_cols(a: np.ndarray, pf: int) -> np.ndarray:
    """Zero-pad a host ``[N, f]`` array to ``[N, padded_width(f, pf)]``."""
    f = a.shape[-1]
    fp = padded_width(f, pf)
    if fp == f:
        return a
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, fp - f)])


def _map_layer0(params, pad_keys: Sequence[str], fn):
    out = list(params)
    layer0 = dict(out[0])
    for key in pad_keys:
        if key in layer0:
            v = layer0[key]
            layer0[key] = {n: fn(t) for n, t in v.items()} if isinstance(v, dict) else fn(v)
    out[0] = layer0
    return out


def pad_params_feature_dim(params, pad_keys: Sequence[str], fin: int, pf: int):
    """Zero rows on layer 0's ``pad_keys`` arrays (torch or numpy) whose
    leading dim is ``fin``, up to ``padded_width(fin, pf)``."""
    fp = padded_width(fin, pf)
    if fp == int(fin) or not params:
        return params

    def pad(a):
        if getattr(a, "ndim", 0) >= 1 and a.shape[0] == int(fin):
            if torch.is_tensor(a):
                return F.pad(a, (0, 0) * (a.ndim - 1) + (0, fp - int(fin)))
            return np.pad(a, ((0, fp - int(fin)),) + ((0, 0),) * (a.ndim - 1))
        return a

    return _map_layer0(params, pad_keys, pad)


def unpad_params_feature_dim(params, pad_keys: Sequence[str], fin: int, pf: int):
    """Inverse of :func:`pad_params_feature_dim`."""
    fp = padded_width(fin, pf)
    if fp == int(fin) or not params:
        return params

    def unpad(a):
        if getattr(a, "ndim", 0) >= 1 and a.shape[0] == fp:
            return a[: int(fin)]
        return a

    return _map_layer0(params, pad_keys, unpad)


# ---- the partitioner --------------------------------------------------------


class _GatherCols(torch.autograd.Function):
    """The feature group's slabs, concatenated and cut to ``width``; the
    backward is a reduce-scatter (the gradient summed over the group, this
    rank's slab of it)."""

    @staticmethod
    def forward(ctx, x, width, group):
        ctx.group, ctx.width, ctx.sw = group, width, x.shape[1]
        return group.all_gather(x.t().contiguous()).t()[:, :width].contiguous()

    @staticmethod
    def backward(ctx, g):
        g = ctx.group.sum_(g.contiguous().clone())
        lo = ctx.group.rank * ctx.sw
        return F.pad(g, (0, ctx.sw * ctx.group.world - ctx.width))[:, lo:lo + ctx.sw], None, None


class Partitioner:
    """One resolved mesh: the spec and, on ranks, the grid (None: the sim
    twin, one process holding every array full width)."""

    def __init__(self, spec: MeshSpec, grid: Optional[mesh.Grid2D] = None):
        self.spec = spec
        self.grid = grid

    @property
    def pv(self) -> int:
        return self.spec.pv

    @property
    def pf(self) -> int:
        return self.spec.pf

    @staticmethod
    def build(spec: MeshSpec, simulate: bool) -> "Partitioner":
        return Partitioner(spec, mesh.resolve_grid(spec.pv, spec.pf, simulate))

    @property
    def slabbed(self) -> bool:
        """True on ranks with a feature axis: activations come as slabs."""
        return self.grid is not None and self.pf > 1

    def slab_cols(self, width: int) -> slice:
        """This rank's columns of a (padded) ``width``-wide tensor."""
        sw = slab_width(width, self.pf)
        return slice(self.grid.f * sw, (self.grid.f + 1) * sw)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor's slab on this rank (identity off ranks)."""
        if not self.slabbed:
            return x
        w = x.shape[-1]
        return F.pad(x, (0, padded_width(w, self.pf) - w))[..., self.slab_cols(w)]

    def gather(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """The feature group's slabs of a ``width``-wide tensor, whole."""
        if not self.slabbed:
            return x
        return _GatherCols.apply(x, width, self.grid.feature)

    def contract(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``a @ w`` over the (padded) feature axis of ``a``. ``w`` gains
        zero rows to the padded width. In the twin: one partial product per
        feature slab, summed in slab order; on ranks ``a`` is this rank's
        slab and its partial product is all-reduced over the feature group."""
        if self.slabbed:
            fp = padded_width(w.shape[0], self.pf)
            cols = self.slab_cols(fp)
            if a.shape[-1] != cols.stop - cols.start:
                raise ValueError(
                    f"contract: slab width {a.shape[-1]} != {cols.stop - cols.start}"
                )
            w = F.pad(w, (0, 0, 0, fp - w.shape[0]))
            return self.grid.feature.sum(a @ w[cols])
        fin = a.shape[-1]
        if w.shape[0] != fin:
            if w.shape[0] > fin:
                raise ValueError(
                    f"contract: activation width {fin} < parameter rows "
                    f"{w.shape[0]} (mesh padding never shrinks)"
                )
            w = F.pad(w, (0, 0, 0, fin - w.shape[0]))
        if self.grid is not None or self.pf == 1:
            return a @ w
        ws = slab_width(fin, self.pf)
        acc = None
        for q in range(self.pf):
            lo, hi = q * ws, min((q + 1) * ws, fin)
            if lo >= hi:
                break
            part = a[..., lo:hi] @ w[lo:hi]
            acc = part if acc is None else acc + part
        return acc

    def slab_vector(self, p: torch.Tensor) -> torch.Tensor:
        """A per-column parameter (batch norm's) cut to this rank's slab."""
        if not self.slabbed:
            return p
        w = p.shape[0]
        return F.pad(p, (0, padded_width(w, self.pf) - w))[self.slab_cols(w)]


# ---- mesh-shape choice ------------------------------------------------------


def factor_shapes(total: int) -> List[MeshSpec]:
    """Every ``(pv, pf)`` factorization of ``total`` devices, widest vertex
    axis first."""
    total = max(int(total), 1)
    return [MeshSpec(pv=total // pf, pf=pf) for pf in range(1, total + 1)
            if total % pf == 0]


def choose_mesh_shape(host_graph, total: int, widths: Sequence[int], itemsize: int = 4,
                      out_widths: Optional[Sequence[int]] = None) -> MeshSpec:
    """The shape of least (ring exchange + feature all-reduce + peak
    resident slab) bytes (``wire_accounting.predict_mesh``; ``widths`` the
    exchange widths, ``out_widths`` the contractions' outputs); a tie goes
    to the larger vertex axis."""
    from neutronstarlite_torch.tools.wire_accounting import predict_mesh

    best, best_score = None, None
    for spec in factor_shapes(total):
        pred = predict_mesh(host_graph, spec.pv, spec.pf, widths, itemsize=itemsize,
                            out_widths=out_widths)
        score = (pred["bytes_per_epoch"] + pred["allreduce_bytes_per_epoch"]
                 + pred["peak_resident_feature_bytes"])
        if best_score is None or score < best_score:
            best, best_score = spec, score
    return best
