"""Device ms per epoch of the kernels that are neither the port's hand-written
kernels nor dense products (GAT's attention and edge ops, element-wise
work, the loss, Adam), by name in the trace."""

from h100bench import metrics


def read(rec):
    if not rec.get("trace"):
        return None
    s = metrics.device_s(rec, lambda n: not metrics.is_hand_written(n) and not metrics.is_gemm(n))
    return 1e3 * s if s > 0 else None
