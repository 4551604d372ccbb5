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
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

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
    """Sum over the ranks; its gradient is the sum of the ranks' gradients
    (each rank's loss reads its own copy of the result)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class ProcessGroup:
    """The default process group seen by one partition: its rank, the world
    size, and the collectives the distributed trainers use."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = dist.get_backend()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[vp, ...] per rank -> [P*vp, ...], rank-major."""
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over the ranks."""
        return _AllReduceSum.apply(t)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the ranks (no gradient)."""
        dist.all_reduce(t)
        return t

    def shift(self, t: torch.Tensor, step: int) -> torch.Tensor:
        """One ring hop: send ``t`` to rank ``rank - step`` and return what
        rank ``rank + step`` sent (step = +1 or -1)."""
        out = torch.empty_like(t)
        ops = [
            dist.P2POp(dist.isend, t.contiguous(), (self.rank - step) % self.world),
            dist.P2POp(dist.irecv, out, (self.rank + step) % self.world),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


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
