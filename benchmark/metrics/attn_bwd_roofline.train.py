"""Kernel C's share of its roofline in the traced slice, %: the least
time of the attention backward at the rows' real lengths
(``yardstick.attention_bwd_work``, one backward, its dq and dkdv launches, a layer and step) over the summed device
time of the ops named ``flash_bwd``; nothing when the slice ran none."""
from benchmark import trace as T
from benchmark import yardstick as Y


def read(rec):
    t, w = rec.get("trace"), rec.get("work", {})
    if not t or not w.get("traced_lens"):
        return None
    seconds, launches = T.kernel_time(t, "flash_bwd")
    if not launches:
        return None
    c = w["plm"]
    H = c["n_heads"]
    Dh = (c["vq_dim"] + c["tc_latent_dim"]) // H
    least = 0.0
    for lens in w["traced_lens"]:
        nbytes, flops = Y.attention_bwd_work(lens, H, Dh)
        least += c["n_layers"] * Y.least_time(flops, nbytes)
    return 100.0 * least / seconds
