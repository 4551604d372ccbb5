"""Trainers of the torch port; importing registers the ALGORITHM names."""

from neutronstarlite_torch.models import (  # noqa: F401
    commnet,
    commnet_dist,
    gat,
    gcn,
    gcn_dist,
    gcn_sample,
    ggcn,
    gin,
    gin_dist,
)
from neutronstarlite_torch.models.base import get_algorithm, register_algorithm

__all__ = ["get_algorithm", "register_algorithm"]
