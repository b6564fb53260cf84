"""Model FLOPs of the GAN steps taken outside the traced slice
(``yardstick_gan.train_step_flops`` of each batch of the pool, once a
pass: G forward and backward, D's three passes) over the seconds they
took times the bf16 peak, %."""
from benchmark import yardstick as Y
from benchmark import yardstick_gan as YG


def read(rec):
    w = rec.get("work", {})
    if not w.get("untraced_passes") or "shapes" not in w:
        return None
    per_pass = sum(YG.train_step_flops(w["cfg"], *shape) for shape in w["shapes"])
    return 100.0 * per_pass * w["untraced_passes"] / (rec["untraced_s"] * Y.PEAK_FLOPS["bf16"])
