"""CLI: ``python -m neutronstarlite_torch.run <file.cfg> [--device cpu|cuda]``.

Port of ``neutronstarlite_tpu/run.py``: reads the cfg, builds the trainer
registered for its ALGORITHM, loads graph and data (paths resolve relative
to the cfg file), trains under ``resilience.supervised_run`` (the health
guards, rollback to the last good checkpoint, bounded retries), and prints
the same lines as the JAX CLI (config echo, ``loaded graph``, ``Epoch N
loss``, ``Train/Eval/Test Acc:``, ``--avg epoch time``). With
``CHECKPOINT_DIR`` in the cfg a run resumes where the last one stopped. It
returns 1 only when the retries (``NTS_MAX_RESTARTS``) are spent. Without
``--device`` it runs on the CUDA card and raises when there is none.

A distributed cfg (``PARTITIONS:P``) runs one partition per process when
launched by ``torch.distributed.run`` (gloo with ``--device cpu``, NCCL on
one card per rank)::

    python -m torch.distributed.run --nproc_per_node P \
        -m neutronstarlite_torch.run <cfg> --device cpu

or all P in one process with ``NTS_DIST_SIMULATE=1`` (the sim twin). With
``MESH:Pv,Pf`` the world is ``Pv * Pf`` ranks, which the trainer lays out
as a grid of vertex and feature groups (``parallel/mesh.Grid2D``); a cfg
with ``DIST_PATH:ring_blocked_sim`` runs the twin in every rank.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch.distributed as dist

from neutronstarlite_torch.models import get_algorithm
from neutronstarlite_torch.parallel import mesh
from neutronstarlite_torch.resilience.supervisor import RetriesExhaustedError, supervised_run
from neutronstarlite_torch.utils.config import InputInfo
from neutronstarlite_torch.utils.logging import get_logger

log = get_logger("main")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m neutronstarlite_torch.run")
    ap.add_argument("cfg", help="KEY:VALUE cfg file")
    ap.add_argument(
        "--device", choices=("cpu", "cuda"), default=None,
        help="run device (default: the CUDA card; raises when there is none)",
    )
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    cfg = InputInfo.read_from_cfg_file(args.cfg)
    print(cfg.print())
    cls = get_algorithm(cfg.algorithm)
    device = mesh.maybe_init_process_group(args.device)
    try:
        toolkit = cls(
            cfg, base_dir=os.path.dirname(os.path.abspath(args.cfg)), device=device
        )
        toolkit.init_graph()
        toolkit.init_nn()
        try:
            result = supervised_run(toolkit)
        except RetriesExhaustedError as e:
            log.error("run failed permanently: %s", e)
            return 1
        print(toolkit.report())
        log.info("result: %s", result)
        return 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
