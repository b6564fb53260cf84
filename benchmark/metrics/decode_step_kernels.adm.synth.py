"""Device ops a step of the ADM decode loop: the ops of the traced slice
that started inside its ``adm.decode`` spans (``program_spans.by_span``),
over their steps."""
from benchmark import program_spans as P


def read(rec):
    return P.in_slice_per_unit(rec, "adm.decode", "ops")
