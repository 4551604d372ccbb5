"""Device idle ms per traced epoch in gaps that begin while one of the
step's scopes (``nts.step.forward``, ``.backward``, ``.optim``) is open:
idle the program leaves inside ``train_step()``. The gap after the
harness's loss fetch (its copy back) is left out wherever the drift of the
host and device clocks puts it."""

from h100bench import spans


def read(rec):
    return spans.step_idle_ms(rec)
