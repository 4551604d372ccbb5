"""Host ms per epoch in the step's forward and loss (the program's counter
``step.forward_s``, its rise over the measured window)."""

from h100bench import spans


def read(rec):
    return spans.counter_ms(rec, "step.forward_s")
