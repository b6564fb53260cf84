"""Model FLOPs of the steps taken outside the traced slice
(``yardstick.plm_train_flops`` each: 6 × matmul parameters × real tokens,
plus attention at the real lengths) over the seconds they took times the
bf16 peak, %."""
from benchmark import yardstick as Y


def read(rec):
    w = rec.get("work", {})
    if not w.get("untraced_lens"):
        return None
    flops = sum(Y.plm_train_flops(w["plm"], lens) for lens in w["untraced_lens"])
    return 100.0 * flops / (rec["untraced_s"] * Y.PEAK_FLOPS["bf16"])
