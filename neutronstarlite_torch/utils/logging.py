"""Leveled logging — port of ``neutronstarlite_tpu/utils/logging.py``.

The same one-line format on stdout and the same ``NTS_LOG_LEVEL`` switch.
The port runs on one device, so every record is stamped ``p0``. Loggers
live under their own root (``nts_torch``) so that a process that imports
both packages (the parity tests) prints each line once.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "ERROR": logging.ERROR,
    "WARN": logging.WARNING,
    "INFO": logging.INFO,
    "DEBUG": logging.DEBUG,
    "TRACE": logging.DEBUG,
}

_ROOT = "nts_torch"


def _configure() -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if root.handlers:
        return root
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(
        "[%(levelname)s] p0 %(asctime)s %(name)s - %(message)s", "%H:%M:%S",
    ))
    root.setLevel(_LEVELS.get(
        os.environ.get("NTS_LOG_LEVEL", "INFO").upper(), logging.INFO
    ))
    root.addHandler(handler)
    root.propagate = False
    return root


def get_logger(name: str = "") -> logging.Logger:
    root = _configure()
    return root.getChild(name) if name else root
