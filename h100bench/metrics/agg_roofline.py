"""The aggregation's share of its roofline, in %: the least time of the
epoch's aggregation calls (``counts/``) over the device time per epoch of
``ell_work_kernel`` and ``ell_split_reduce`` in the trace."""

from h100bench import metrics


def read(rec):
    least = rec["counts"].get("aggregation_ms")
    spent = metrics.device_s(rec, lambda n: "ell_work_kernel" in n or "ell_split_reduce" in n)
    if not least or spent <= 0:
        return None
    return 100.0 * least / (1e3 * spent)
