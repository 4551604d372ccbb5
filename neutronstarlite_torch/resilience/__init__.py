"""Resilient training — port of ``neutronstarlite_tpu/resilience``.

- :mod:`faults`: ``NTS_FAULT_SPEC`` fault injection through named
  ``fault_point`` hooks in the run loop and the checkpoint store;
- :mod:`guards`: per-epoch health checks (non-finite loss or parameters,
  divergence, stall) and the hung-step watchdog;
- :mod:`supervisor`: ``supervised_run(toolkit)``, rollback to the last
  good checkpoint with bounded retries and backoff;
- :mod:`events`: every fault and recovery as a typed record for a sink;
- :mod:`elastic`: heartbeats and the liveness monitor (the serve fleet's
  replica supervision).

Checkpoint integrity (digests, atomic publication, retention, quarantine)
lives in ``utils/checkpoint.py`` and reports through :mod:`events`.
"""
