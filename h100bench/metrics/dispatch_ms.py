"""Host ms from the call to ``train_step()`` to its return (the enqueue),
the mean over the window's epochs."""


def read(rec):
    d = rec.get("dispatch_s") or []
    return 1e3 * sum(d) / len(d) if d else None
