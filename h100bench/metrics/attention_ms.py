"""Device ms per traced epoch of the work launched inside GAT's attention
scopes (``nts.gat.*``: the projection halves, the scores, the softmax, the
slot-map transposes, ``grad_alpha``), mapped to its launches by
``spans.attributed``. The autograd backward of the scores' and softmax's
element-wise ops runs under ``nts.step.backward`` and is not counted."""

from h100bench import spans


def read(rec):
    return spans.scope_ms(rec, "nts.gat.")
