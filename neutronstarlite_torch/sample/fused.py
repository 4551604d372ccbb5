"""Fused on-device sampling: draw -> dedup/remap -> weights -> feature gather
-> forward/backward -> Adam, one CUDA graph per batch step — port of
``neutronstarlite_tpu/sample/fused.py``.

JAX runs a whole epoch as one ``lax.scan`` dispatch over the resident
neighbour table (``sample/device_sampler.py``'s ``[V, D]`` layout), the
degree vectors and the feature slab, with no per-batch host-to-device
transfer. The port captures one batch step as a CUDA graph, once per
(capacities, fanouts) and parameter set, and replays it once per batch:

- the epoch's seed shuffle runs on the device (a stable sort of hashed
  priorities) into static buffers, before the replays;
- the epoch, the batch index and each batch's live-seed count are device
  scalars: the graph reads them, and the step adds one to the batch index
  in place, so nothing moves from the host between two replays;
- every random draw is a counter hash (``device_sampler.fold``/``mix32``)
  of (seed, epoch, batch, hop, row, slot): no generator state, so it is
  safe to capture, and the CPU and the card draw the same subgraph;
- nothing in the step reads a value back to the host: no ``.item()``, no
  ``torch.unique``, no shape that depends on data. Ranks past a hop's
  capacity go to a spare cell of an ``ncap + 1`` buffer that is sliced off
  (JAX's ``mode="drop"``); ``torch.sort(stable=True)`` is JAX's stable
  argsort;
- the step's Adam reads its update count, hence its decay epoch, from a
  device scalar.

Before the capture the step runs once on a side stream (lazy set-up of the
libraries it calls), and the state it changed is put back, so every batch
of every epoch is a replay. On the CPU, which the tests use, the same step
runs eagerly, batch by batch. On CUDA a capture that fails raises: the step
never runs eagerly there.

Fused draws are distribution-equivalent to the host sampler (the same
k-smallest-priorities construction) and bitwise repeatable from one run to
the next.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neutronstarlite_torch.sample.device_sampler import _hop, fold, hash_bits
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("fused_sample")

# tags that keep the key streams apart: the draws must not alias the
# dropout masks, which use the batch key with their own tag
DRAW_TAG = 0x5EED
SHUFFLE_TAG = 0x5F0E
DROPOUT_TAG = 0xD0


def device_dedup_remap(src: torch.Tensor, valid: torch.Tensor, ncap: int):
    """``np.unique`` + ``np.searchsorted`` at a fixed width, on the device.

    ``src [E]`` candidate global ids, ``valid [E]`` the real draws; returns
    ``(uniq [ncap] int64, src_local [E] int64, n_uniq)``: the sorted
    distinct valid ids, zero-padded past ``n_uniq`` (a 0-dim tensor), and
    each entry's index in ``uniq`` (0 for invalid entries). Invalid slots
    are priced at the int64 maximum, a stable sort groups equal ids, the
    run heads' cumulative sum gives dense ranks, and each run head is
    written at its rank; ranks past ``ncap`` land in a spare cell."""
    E = src.shape[0]
    sent = torch.iinfo(torch.int64).max
    keyv = torch.where(valid, src.long(), sent)
    sv, order = torch.sort(keyv, stable=True)
    prev = torch.cat([sv.new_full((1,), -1), sv[:-1]])
    new_run = (sv != prev) & (sv != sent)
    rank = torch.cumsum(new_run.long(), dim=0) - 1
    n_uniq = new_run.sum()
    buf = torch.zeros(ncap + 1, dtype=torch.int64, device=src.device)
    buf[torch.where(new_run, rank, ncap).clamp(max=ncap)] = sv
    src_local = torch.zeros(E, dtype=torch.int64, device=src.device)
    src_local[order] = torch.where(sv != sent, rank, 0)
    return buf[:ncap], src_local, n_uniq


def _draw_hop(nbr, eff_deg, key, dsts_pad, n_dst, fanout: int):
    """One draw over a padded dst set: ``device_sampler._hop`` plus the row
    mask ``row < n_dst`` (a padded row indexes vertex 0, which has a real
    degree) and zero columns when the table is narrower than the fanout."""
    src, valid = _hop(nbr, eff_deg, key, dsts_pad, fanout)
    rows = torch.arange(dsts_pad.shape[0], device=dsts_pad.device)
    valid = valid & (rows[:, None] < n_dst)
    pad = int(fanout) - src.shape[1]
    if pad > 0:
        src = F.pad(src, (0, pad))
        valid = F.pad(valid, (0, pad))
    return src, valid


def fused_sample_subgraph(nbr, eff_deg, out_deg, in_deg, seeds_pad, n_real, key,
                          node_caps: Sequence[int], fanouts: Sequence[int]):
    """One seed batch's padded multi-hop subgraph, on the device: the
    counterpart of ``Sampler._make_batch``, in the trainer's batch layout.
    ``nodes[l] [node_caps[l]]`` padded global ids; ``hops[h] = (src_local,
    dst_local, weight)``, each ``node_caps[h+1] * fanouts[h]`` long, edges
    row-major (slot ``r * fanout + j``); weights ``1/sqrt(out_deg *
    in_deg)``, 0 on padding (JAX computes them in float32; the port in
    float64, rounded once, as both host samplers do). ``n_real`` is the
    live-seed count (a 0-dim tensor or an int)."""
    n_hops = len(fanouts)
    nodes: List = [None] * (n_hops + 1)
    hops: List = [None] * n_hops
    nodes[-1] = seeds_pad
    cur, cur_n = seeds_pad, n_real
    for h in range(n_hops - 1, -1, -1):
        fanout = int(fanouts[h])
        dcap, ncap = int(node_caps[h + 1]), int(node_caps[h])
        src2d, valid2d = _draw_hop(nbr, eff_deg, fold(key, h), cur, cur_n, fanout)
        src = src2d.reshape(-1)
        valid = valid2d.reshape(-1)
        dst_idx = torch.arange(dcap, device=src.device).view(-1, 1).expand(dcap, fanout)
        dst_idx = dst_idx.reshape(-1)
        uniq, src_local, n_uniq = device_dedup_remap(src, valid, ncap)
        # float64, rounded once to float32, as the host sampler computes it:
        # the card and the CPU then agree bitwise
        d_out = torch.clamp(out_deg[src], min=1).double()
        d_in = torch.clamp(in_deg[cur[dst_idx]], min=1).double()
        w = torch.where(valid, (1.0 / torch.sqrt(d_out * d_in)).float(), 0.0)
        hops[h] = (src_local, torch.where(valid, dst_idx, 0), w)
        nodes[h] = uniq
        cur, cur_n = uniq, n_uniq
    return nodes, hops


def degree_tables(graph, device, rows: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 out- and in-degree vectors on the device, for the weights;
    ``rows`` > V pads them with zeros to a neighbour table's row capacity
    (a reserved margin), so that a vertex append within it can rewrite
    them in place."""
    n = max(int(rows), graph.v_num)
    out = []
    for deg in (graph.out_degree, graph.in_degree):
        host = np.zeros(n, dtype=np.int32)
        host[:graph.v_num] = deg
        out.append(torch.from_numpy(host).to(device))
    return out[0], out[1]



def dropout_keep(key, layer: int, shape, rate: float, device) -> torch.Tensor:
    """A hashed keep-mask for one layer of one batch (capture-safe)."""
    bits = hash_bits(fold(key, DROPOUT_TAG, layer), shape, device) >> 8
    return bits >= int(round(rate * (1 << 24)))


class FusedEpochRunner:
    """The fused step, captured once and replayed once per batch.

    ``step_fn(nodes, hops, seed_mask, seeds, key)`` is the trainer's batch
    update: it changes the trainer's state in place (the tensors
    ``state_fn()`` lists: parameters, Adam moments and update count) and
    returns the batch loss as a 0-dim tensor, or (loss, stats) with the
    step's packed tensor stats (``NTS_NUMERICS``), which each step writes
    into the static buffer ``stats``: after an epoch it holds the last
    batch's. ``tables`` is ``(nbr, eff_deg, out_deg, in_deg)`` on the
    device. ``run_epoch(epoch)`` returns the epoch's per-batch losses as a
    device tensor."""

    def __init__(self, step_fn: Callable, state_fn: Callable, node_caps: Sequence[int],
                 fanouts: Sequence[int], batch_size: int, tables, train_nids,
                 seed: int, device):
        self.step_fn = step_fn
        self.state_fn = state_fn
        self.node_caps = tuple(int(c) for c in node_caps)
        self.fanouts = tuple(int(f) for f in fanouts)
        self.batch_size = B = int(batch_size)
        self.nbr, self.eff_deg, self.out_deg, self.in_deg = tables
        self.device = dev = torch.device(device)
        nids = np.asarray(train_nids, dtype=np.int64)
        self.n_seeds = len(nids)
        if self.n_seeds == 0:
            raise ValueError("fused sampling needs at least one seed")
        self.seed = int(seed)
        self.train_nids = torch.from_numpy(nids).to(dev)
        self.n_batches = n = -(-self.n_seeds // B)
        self.epoch_t = torch.zeros((), dtype=torch.int64, device=dev)
        self.batch_t = torch.zeros((), dtype=torch.int64, device=dev)
        live = (torch.arange(n * B, device=dev) < self.n_seeds).view(n, B)
        self.mask_mat = live.float()
        self.counts = live.sum(dim=1)
        self.seeds_mat = torch.zeros((n, B), dtype=torch.int64, device=dev)
        self.losses = torch.zeros(n, dtype=torch.float32, device=dev)
        self.stats = None  # the last step's packed stats, when the step returns them
        self.graph = None
        self._captured_state = None
        self.captures = 0  # CUDA graphs captured
        self.replays = 0  # graph replays, all epochs

    def _shuffle(self) -> None:
        """This epoch's seed order, on the device, into the static buffer."""
        prio = hash_bits(fold(self.seed, self.epoch_t, SHUFFLE_TAG), (self.n_seeds,),
                         self.device)
        perm = torch.sort(prio, stable=True).indices
        flat = self.seeds_mat.view(-1)
        flat.zero_()
        flat[: self.n_seeds] = self.train_nids[perm]

    def step(self) -> None:
        """One batch: the body the graph captures."""
        bi = self.batch_t.view(1)
        seeds = self.seeds_mat.index_select(0, bi).view(-1)
        seed_mask = self.mask_mat.index_select(0, bi).view(-1)
        n_live = self.counts.index_select(0, bi).view(())
        key = fold(self.seed, self.epoch_t, self.batch_t)
        nodes, hops = fused_sample_subgraph(
            self.nbr, self.eff_deg, self.out_deg, self.in_deg, seeds, n_live,
            fold(key, DRAW_TAG), self.node_caps, self.fanouts,
        )
        out = self.step_fn(nodes, hops, seed_mask, seeds, key)
        loss, stats = out if isinstance(out, tuple) else (out, None)
        self.losses.index_copy_(0, bi, loss.detach().float().view(1))
        if stats is not None:
            if self.stats is None:  # allocated by the first (eager) step
                self.stats = torch.zeros_like(stats)
            self.stats.copy_(stats)
        self.batch_t.add_(1)

    def _capture(self) -> None:
        state = self.state_fn()
        saved = [t.clone() for t in state]
        losses = self.losses.clone()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.step()  # warm-up outside the capture
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)
            self.losses.copy_(losses)
        self.batch_t.zero_()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.step()
        self.graph = graph
        self._captured_state = [t.data_ptr() for t in state]
        self.captures += 1
        log.info(
            "captured the fused batch step as a CUDA graph (%d batches x %d seeds, caps %s)",
            self.n_batches, self.batch_size, list(self.node_caps),
        )

    def run_epoch(self, epoch: int) -> torch.Tensor:
        """One epoch: the shuffle, then n_batches replays (CUDA) or eager
        steps (CPU). Returns the per-batch losses (a device tensor)."""
        self.epoch_t.fill_(int(epoch))
        self.batch_t.zero_()
        self._shuffle()
        if self.device.type != "cuda":
            for _ in range(self.n_batches):
                self.step()
            return self.losses.clone()
        if self.graph is None or self._captured_state != [t.data_ptr()
                                                          for t in self.state_fn()]:
            self._capture()
        for _ in range(self.n_batches):
            self.graph.replay()
        self.replays += self.n_batches
        return self.losses.clone()
