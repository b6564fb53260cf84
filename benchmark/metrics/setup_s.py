"""Seconds from the process's start to the window's: imports, weights,
the kernels' build or load, casts, inputs and the warm-up."""


def read(rec):
    return rec["setup_s"]
