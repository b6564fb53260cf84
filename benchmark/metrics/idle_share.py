"""Share of the traced slice of the window, as the host clocked it, in
which no kernel, copy or set ran on the device, %."""


def read(rec):
    t = rec.get("trace")
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
