"""Wire accounting of the distributed exchanges — the part of
``neutronstarlite_tpu/tools/wire_accounting.py`` the distributed trainers
use: ``exchange_rows_per_device``, the formula behind their ``wire.*``
gauges and counters. The offline report and its policy checks come with a
later slice.
"""

from __future__ import annotations


def exchange_rows_per_device(P: int, vp: int) -> int:
    """Remote feature rows one partition receives per layer exchange: the
    port's exchanges (the ring's rotation, the all_gather family) deliver
    P - 1 shards of ``vp`` rows. (JAX's form also prices the mirror
    exchange's compacted chunks, which come with the edge-family slice.)"""
    return (P - 1) * vp if P > 1 else 0
