"""Trainers of the torch port; importing registers the ALGORITHM names."""

from neutronstarlite_torch.models import commnet, gat, gcn, gcn_sample, ggcn, gin  # noqa: F401
from neutronstarlite_torch.models.base import get_algorithm, register_algorithm

__all__ = ["get_algorithm", "register_algorithm"]
