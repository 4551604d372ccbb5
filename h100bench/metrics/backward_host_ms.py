"""Host ms per epoch the calling thread spends in the step's
``loss.backward()`` (the program's counter ``step.backward_s``, its rise
over the measured window)."""

from h100bench import spans


def read(rec):
    return spans.counter_ms(rec, "step.backward_s")
