"""The whole epoch's share of the chip's peak, in %: the least time the
epoch's work needs (``counts/``: each term's bytes over the HBM rate or
operations over its peak, whichever is larger) over the measured
``epoch_ms``."""


def read(rec):
    least, ms = rec["counts"].get("least_ms"), rec.get("epoch_ms")
    if not least or not ms:
        return None
    return 100.0 * least / ms
