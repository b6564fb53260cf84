"""Model FLOPs of the batches synthesised outside the traced slice
(``yardstick.synthesis_flops`` each) over the seconds they took times the
bf16 peak, %."""
from benchmark import yardstick as Y


def read(rec):
    if not rec.get("untraced_batches") or "work" not in rec:
        return None
    w = rec["work"]
    flops = Y.synthesis_flops(w["cfg"], w["batch"], w["phones"], w["prompt_frames"],
                              w["max_frames"])["total"]
    return 100.0 * flops * rec["untraced_batches"] / (rec["untraced_s"] * Y.PEAK_FLOPS["bf16"])
