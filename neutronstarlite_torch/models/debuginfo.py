"""DEBUGINFO: the epoch's forward / backward / update attribution — port of
``neutronstarlite_tpu/models/debuginfo.py`` and of the single-device report
in the reference's ``FullBatchTrainer.debug_info``.

The reference's toolkits split an epoch into buckets with host timers
around every engine call (``DEBUGINFO()``). Here, as in the JAX package,
the split is recovered from separately run prefixes of the step: the
forward alone, forward + backward, and the whole step, each timed warm
over ``n`` runs (median). On a CUDA device each run is timed with CUDA
events around it; on the CPU with the host clock. ``NTS_DEBUGINFO=1`` on
the full-batch trainer prints the report after training.

The distributed trainers' report (:func:`format_dist_report`) adds the
forward with the graph exchange disabled (the same layer widths and
matmuls, no exchange, no aggregation) and splits the forward into
``nn_time`` and ``graph_time`` = forward - nn_time, as JAX's does.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from neutronstarlite_torch.utils.timing import get_time


def time_median(fn: Callable[[], object], device, n: int = 3) -> float:
    """Median seconds of ``fn()`` over ``n`` warm runs (one warm-up run
    first): CUDA events on a CUDA device, the host clock otherwise."""
    cuda = torch.device(device).type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    ts = []
    for _ in range(n):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = get_time()
            fn()
            ts.append(get_time() - t0)
    return float(np.median(ts))


def format_report(t_fwd: float, t_grad: float, t_step: float) -> str:
    """The reference-shaped ``#key=value(ms)`` lines."""
    return "\n".join([
        "DEBUGINFO:",
        f"#forward_time={t_fwd * 1000:.3f}(ms)",
        f"#backward_time={max(t_grad - t_fwd, 0.0) * 1000:.3f}(ms)",
        f"#update_time={max(t_step - t_grad, 0.0) * 1000:.3f}(ms)",
        f"#all_train_step_time={t_step * 1000:.3f}(ms)",
    ])


def format_dist_report(t_nn: float, t_fwd: float, t_grad: float, t_step: float) -> str:
    """The distributed trainers' ``#key=value(ms)`` lines: nn, graph
    (forward - nn), forward, backward, update and the whole step."""
    return "\n".join([
        "DEBUGINFO:",
        f"#nn_time={t_nn * 1000:.3f}(ms)",
        f"#graph_time={max(t_fwd - t_nn, 0.0) * 1000:.3f}(ms)",
        f"#forward_time={t_fwd * 1000:.3f}(ms)",
        f"#backward_time={max(t_grad - t_fwd, 0.0) * 1000:.3f}(ms)",
        f"#update_time={max(t_step - t_grad, 0.0) * 1000:.3f}(ms)",
        f"#all_train_step_time={t_step * 1000:.3f}(ms)",
    ])
