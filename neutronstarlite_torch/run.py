"""CLI: ``python -m neutronstarlite_torch.run <file.cfg> [--device cpu|cuda]``.

Port of ``neutronstarlite_tpu/run.py``: reads the cfg, builds the trainer
registered for its ALGORITHM, loads graph and data (paths resolve relative
to the cfg file), trains, and prints the same lines as the JAX CLI (config
echo, ``loaded graph``, ``Epoch N loss``, ``Train/Eval/Test Acc:``,
``--avg epoch time``). Without ``--device`` it runs on the CUDA card and
raises when there is none.
"""

from __future__ import annotations

import argparse
import os
import sys

from neutronstarlite_torch.models import get_algorithm
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
    toolkit = cls(
        cfg, base_dir=os.path.dirname(os.path.abspath(args.cfg)), device=args.device
    )
    toolkit.init_graph()
    toolkit.init_nn()
    result = toolkit.run()
    print(toolkit.report())
    log.info("result: %s", result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
