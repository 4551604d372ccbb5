"""Trainers of the torch port; importing registers the ALGORITHM names."""

from neutronstarlite_torch.models import (  # noqa: F401
    commnet,
    commnet_dist,
    gat,
    gat_dist,
    gcn,
    gcn_dist,
    gcn_dist_cache,
    gcn_sample,
    ggcn,
    ggcn_dist,
    gin,
    gin_dist,
    test_getdep,
)
from neutronstarlite_torch.models.base import get_algorithm, register_algorithm

__all__ = ["get_algorithm", "register_algorithm"]
