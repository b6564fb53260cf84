"""Device-busy ms a GAN step in its ``gan.g_step`` phase: the union of the
device ops of the traced slice that started inside the port's
``gan.g_step`` spans (``program_spans.by_span``), over those spans.
The host runs ahead of a device-bound step, so these are the ops that
started while the host was in the phase, not all the phase's work."""


def read(rec):
    got = rec.get("trace", {}).get("by_span", {}).get("gan.g_step")
    return 1000.0 * got["busy_s"] / got["spans"] if got and got["spans"] else None
