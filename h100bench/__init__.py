"""The H100 benchmark of ``neutronstarlite_torch`` (see README.md)."""
