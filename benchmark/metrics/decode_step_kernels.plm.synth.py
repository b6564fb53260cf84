"""Device ops a step of the PLM decode loop: the ops of the traced slice
that started inside its ``plm.decode`` spans (``program_spans.by_span``),
over their steps."""
from benchmark import program_spans as P


def read(rec):
    return P.in_slice_per_unit(rec, "plm.decode", "ops")
