"""The window's wall time over the optimizer steps completed in it, in ms."""


def read(rec):
    return 1000.0 * rec["window_s"] / rec["steps"] if rec.get("steps") else None
