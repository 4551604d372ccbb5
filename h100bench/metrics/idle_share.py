"""The device's idle share of the traced window, in %: 1 minus the union
of its kernel and copy intervals over the window."""

from h100bench import profile_window


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or not tr["device"]:
        return None
    return 100.0 * (1.0 - profile_window.busy_s(tr) / tr["window_s"])
