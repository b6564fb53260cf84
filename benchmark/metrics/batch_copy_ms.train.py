"""Mean host ms a train step spends handing its batch to the card: the
port's ``train.batch_to_device`` spans (a pageable upload, which waits for
the stream to reach it) outside the traced slice."""
from benchmark import program_spans as P


def read(rec):
    return P.host_ms_per_span(rec, "train.batch_to_device")
