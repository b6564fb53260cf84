"""Share of the traced slice's device-busy time in cuDNN's layout
conversions between NCHW and NHWC (ops named ``nchwToNhwc`` or
``nhwcToNchw``), %; nothing when the slice ran none."""
from benchmark import trace as T


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("busy_s"):
        return None
    seconds, launches = T.kernel_time(t, "nchwToNhwc", "nhwcToNchw")
    return 100.0 * seconds / t["busy_s"] if launches else None
