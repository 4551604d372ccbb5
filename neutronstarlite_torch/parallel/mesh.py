"""The process group — the port's counterpart of
``neutronstarlite_tpu/parallel/mesh.py``.

JAX lays the partitions over a 1-D device ``Mesh``; here each partition is
one rank of a ``torch.distributed`` process group: gloo for CPU tensors,
NCCL for CUDA tensors (one card per rank) when the world size is above 1.
``None`` in place of a group is the collective-free sim twin
(``NTS_DIST_SIMULATE=1``, the reference's own switch): one process holds
all P shards and the exchanges run every shard's tables in turn. NCCL
cannot put two ranks on one card, so on a single card the distributed
trainers run the twin.

A multi-process run is launched by ``torch.distributed.run``, which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``::

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m neutronstarlite_torch.run <cfg with PARTITIONS:2> --device cpu

``maybe_init_process_group`` (called by the CLI) joins that world; a
caller may equally call ``torch.distributed.init_process_group`` itself.

The 2D mesh (``MESH:Pv,Pf``, ``parallel/partitioner.py``) lays the world
out as a ``(Pv, Pf)`` grid, rank = ``v * Pf + f`` (``Grid2D``): one vertex
group per feature slab f (ranks ``{v' * Pf + f}``, where the ring runs)
and one feature group per vertex shard v (ranks ``{v * Pf + f'}``, where
the contraction's all-reduce runs). JAX keeps the feature axis within a
host; here the ranks of one host are consecutive, so a feature group is
consecutive ranks too.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("mesh")


def simulate_requested() -> bool:
    """``NTS_DIST_SIMULATE=1``: the collective-free twin."""
    return os.environ.get("NTS_DIST_SIMULATE", "0") == "1"


def world_size() -> int:
    """Ranks of the joined process group (1 when there is none)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def launched_world_size() -> int:
    """``WORLD_SIZE`` as a launcher set it (1 when unset)."""
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def maybe_init_process_group(device: Optional[str]) -> Optional[str]:
    """Join the launcher's world when ``WORLD_SIZE`` > 1: gloo for the CPU,
    NCCL for CUDA (each rank then takes card ``LOCAL_RANK``). Returns the
    device string the rank runs on (``device`` itself on the CPU)."""
    if launched_world_size() <= 1 or dist.is_initialized():
        return device
    cuda = device != "cpu"
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")
    log.info("process group: rank %d of %d (%s)", dist.get_rank(),
             dist.get_world_size(), dist.get_backend())
    return device


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``pg``; its gradient is the sum of the ranks'
    gradients (each rank's loss reads its own copy of the result)."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        y = x.clone()
        dist.all_reduce(y, group=pg)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


class Hop:
    """One ring hop in flight: the buffer being received, the requests,
    and the tensor being sent, kept alive until ``ProcessGroup.shift_wait``
    (on NCCL the send runs on NCCL's stream after the caller moves on)."""

    def __init__(self, out: torch.Tensor, reqs, sent: torch.Tensor):
        self.out, self.reqs, self.sent = out, reqs, sent


class ProcessGroup:
    """A process group seen by one of its ranks: ``rank`` is the index in
    ``ranks`` (the global ranks of the group, in order), ``world`` their
    count. ``pg`` is the torch group (None: the default world)."""

    def __init__(self, pg=None, ranks: Optional[List[int]] = None):
        self.pg = pg
        self.ranks = list(ranks) if ranks is not None else list(range(dist.get_world_size()))
        self.rank = self.ranks.index(dist.get_rank())
        self.world = len(self.ranks)
        self.backend = dist.get_backend()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[vp, ...] per rank -> [P*vp, ...], rank-major."""
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous(), group=self.pg)
        return torch.cat(parts)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over the ranks."""
        return _AllReduceSum.apply(t, self.pg)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the ranks (no gradient)."""
        dist.all_reduce(t, group=self.pg)
        return t

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place elementwise max over the ranks (no gradient)."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.pg)
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """In place: every rank gets the group's first rank's ``t``."""
        dist.broadcast(t, src=self.ranks[0], group=self.pg)
        return t

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """[P*m, ...] per rank, chunk q for rank q -> [P*m, ...] whose chunk
        q came from rank q."""
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self.pg)
        return out

    def shift_start(self, t: torch.Tensor, step: int) -> Hop:
        """Start one ring hop: send ``t`` to rank ``rank - step`` and receive
        what rank ``rank + step`` sends (step = +1 or -1). The caller may
        launch work before ``shift_wait``."""
        t = t.contiguous()
        out = torch.empty_like(t)
        to = self.ranks[(self.rank - step) % self.world]
        frm = self.ranks[(self.rank + step) % self.world]
        ops = [dist.P2POp(dist.isend, t, to, group=self.pg),
               dist.P2POp(dist.irecv, out, frm, group=self.pg)]
        return Hop(out, dist.batch_isend_irecv(ops), t)

    @staticmethod
    def shift_wait(hop: Hop) -> torch.Tensor:
        """Finish a hop and return what arrived. On NCCL the wait orders the
        caller's stream after the transfer; it does not block the host."""
        for req in hop.reqs:
            req.wait()
        hop.sent = None
        return hop.out


class Grid2D:
    """The ``(pv, pf)`` grid of the world for the 2D mesh: this rank's
    coordinates ``(v, f)``, the world, its vertex group (the ring) and its
    feature group (the contraction's all-reduce). Every rank creates every
    group, in the same order (all vertex groups, then all feature groups),
    as ``torch.distributed.new_group`` requires."""

    def __init__(self, pv: int, pf: int):
        self.pv, self.pf = pv, pf
        self.world = ProcessGroup()
        if self.world.world != pv * pf:
            raise ValueError(
                f"MESH:{pv},{pf} needs {pv * pf} ranks but this run has {self.world.world}"
            )
        self.v, self.f = divmod(self.world.rank, pf)
        vertex = [[v * pf + f for v in range(pv)] for f in range(pf)]
        feature = [[v * pf + f for f in range(pf)] for v in range(pv)]
        vgroups = [dist.new_group(r) for r in vertex]
        fgroups = [dist.new_group(r) for r in feature]
        self.vertex = ProcessGroup(vgroups[self.f], vertex[self.f])
        self.feature = ProcessGroup(fgroups[self.v], feature[self.v])


def resolve_group(partitions: int, simulate: bool) -> Tuple[Optional[ProcessGroup], int]:
    """(group, P): ``None`` and PARTITIONS (default 2, as in JAX) for the
    sim twin; else the joined group, whose world size must equal
    PARTITIONS (0: the world size). A PARTITIONS above the world size is
    refused: the port never falls back to the twin silently."""
    if simulate:
        return None, partitions or 2
    world = world_size()
    P = partitions or world
    if P != world:
        raise ValueError(
            f"PARTITIONS:{P} needs {P} ranks but this run has {world}: launch "
            f"{P} processes under python -m torch.distributed.run, or set "
            "NTS_DIST_SIMULATE=1 for the collective-free twin in one process"
        )
    if P == 1:
        return None, 1  # one partition: the twin is the collective-free path
    return ProcessGroup(), P


def resolve_grid(pv: int, pf: int, simulate: bool) -> Optional[Grid2D]:
    """The 2D grid of ``MESH:pv,pf``: None for the sim twin (and for a
    one-rank mesh); else the joined world laid out as a grid, whose size
    must be ``pv * pf``: a larger mesh is refused, never run as the twin."""
    if simulate:
        return None
    world = world_size()
    if pv * pf != world:
        raise ValueError(
            f"MESH:{pv},{pf} needs {pv * pf} ranks but this run has {world}: launch "
            f"{pv * pf} processes under python -m torch.distributed.run, or set "
            "NTS_DIST_SIMULATE=1 (or DIST_PATH:ring_blocked_sim) for the collective-free "
            "twin in one process"
        )
    if world == 1:
        return None
    return Grid2D(pv, pf)
