"""The mirror exchange's correctness pseudo-model (``TEST_GETDEP``) — port
of ``neutronstarlite_tpu/models/test_getdep.py``.

Vertex v's feature row is the constant v (4 columns), so after
``dist_get_dep_nbr`` mirror slot (q, s) of consumer p must hold
``offsets[q] + need_ids[q, p, s]`` exactly, and the gradient of
``sum(mirrors)`` must give each master exactly 4 times the number of slots
that name it. ``run()`` logs PASS or FAIL and returns ``pass``,
``fwd_err`` and ``bwd_err`` (the largest absolute errors; 0 on a pass) and
``partitions``. On ranks each computes its own slots and rows and the
errors are the largest over the ranks; ``mirrors`` holds this process's
mirror rows ``[P*mb, 4]`` (the twin's ``[P*P*mb, 4]``) for callers that
compare them.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from neutronstarlite_torch.models.base import ToolkitBase, register_algorithm
from neutronstarlite_torch.models.gcn_dist import check_dist_supported, check_mirror_knobs
from neutronstarlite_torch.parallel import mesh
from neutronstarlite_torch.parallel.dist_edge_ops import UniformMirror, dist_get_dep_nbr
from neutronstarlite_torch.parallel.mirror import MirrorGraph
from neutronstarlite_torch.utils.config import TEST_GETDEP_ALGORITHMS
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("test_getdep")

WIDTH = 4


@register_algorithm(*TEST_GETDEP_ALGORITHMS)
class GetDepNbrCheck(ToolkitBase):
    """Checks the uniform mirror exchange forward and backward."""

    weight_mode = "ones"

    def build_model(self) -> None:
        cfg = self.cfg
        check_dist_supported(cfg)
        check_mirror_knobs(cfg, "TEST_GETDEP")
        self.group, P = mesh.resolve_group(cfg.partitions, mesh.simulate_requested())
        self.mg = MirrorGraph.build(self.host_graph, P)
        self.exchange = UniformMirror(self.mg, self.group, self.device, edges=False)
        self.metrics.gauge_set("dist.active_partitions", P)

    def init_model(self) -> None:
        """No parameters: a restart has nothing to re-initialise."""

    def _max(self, v: float) -> float:
        t = torch.tensor([v], dtype=torch.float64, device=self.device)
        if self.group is not None:
            self.group.max_(t)
        return float(t.item())

    def run(self) -> Dict[str, Any]:
        mg, g = self.mg, self.group
        P, mb, vp = mg.partitions, mg.mb, mg.vp
        ids = mg.pad_vertex_array(np.arange(mg.v_num, dtype=np.float32)[:, None]
                                  .repeat(WIDTH, axis=1))
        ranks = range(P) if g is None else [g.rank]
        if g is not None:
            ids = ids[g.rank * vp:(g.rank + 1) * vp]
        x = torch.from_numpy(np.ascontiguousarray(ids)).to(self.device).requires_grad_(True)
        mirrors = dist_get_dep_nbr(self.exchange, x)
        mirrors.sum().backward()
        self.mirrors = mirrors.detach()

        got = self.mirrors[:, 0].cpu().numpy().reshape(len(ranks), P * mb)
        expect = np.stack([np.concatenate([mg.offsets[q] + mg.need_ids[q, p]
                                           for q in range(P)]) for p in ranks])
        fwd_err = self._max(float(np.abs(got - expect.astype(np.float32)).max()))

        counts = np.zeros(mg.padded_v, dtype=np.float32)
        for p in range(P):
            for q in range(P):
                np.add.at(counts, q * vp + mg.need_ids[q, p], float(WIDTH))
        if g is not None:
            counts = counts[g.rank * vp:(g.rank + 1) * vp]
        grad = x.grad.sum(dim=1).cpu().numpy()
        bwd_err = self._max(float(np.abs(grad - counts).max()))

        ok = fwd_err == 0.0 and bwd_err == 0.0
        log.info("test_getdep [%s] P=%d Mb=%d fwd_err=%g bwd_err=%g",
                 "PASS" if ok else "FAIL", P, mb, fwd_err, bwd_err)
        result = {"pass": ok, "fwd_err": fwd_err, "bwd_err": bwd_err, "partitions": P}
        self.finalize_metrics(result)
        return result
