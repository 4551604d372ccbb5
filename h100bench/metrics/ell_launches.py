"""``ell_level`` kernel launches per window epoch (the wrapper's counter:
the work kernel and, when a row splits, the reduction)."""


def read(rec):
    n = rec["counters"].get("ell_level.launches")
    if not n or not rec.get("epochs"):
        return None
    return n / rec["epochs"]
