"""Host ms a step of the ADM decode loop: its ``adm.decode`` spans (the
port's tracer, one a ``synthesize`` call, ``n`` its steps) outside the
traced slice, where CUPTI does not slow the launches, over their steps."""
from benchmark import program_spans as P


def read(rec):
    return P.host_ms_per_unit(rec, "adm.decode")
