"""Mean host ms of the port's ``gan.g_step`` spans outside the traced
slice, where CUPTI does not slow the launches: the host's issue of the
phase, and any wait for the device inside it."""
from benchmark import program_spans as P


def read(rec):
    return P.host_ms_per_span(rec, "gan.g_step")
