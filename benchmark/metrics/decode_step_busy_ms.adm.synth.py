"""Device-busy ms a step of the ADM decode loop: the union of the ops that
started inside its ``adm.decode`` spans in the traced slice
(``program_spans.by_span``), over their steps."""
from benchmark import program_spans as P


def read(rec):
    ms = P.in_slice_per_unit(rec, "adm.decode", "busy_s")
    return None if ms is None else 1000.0 * ms
