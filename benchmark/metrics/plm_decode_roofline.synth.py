"""The int8 PLM decode step's share of its roofline, %: the least time one
step could take (``yardstick.plm_decode_step_work``: int8 weights, fp32
scales and biases and the used KV cache each read once, at 3.35 TB/s; or
its FLOPs at the bf16 peak, whichever is longer) over the measured time a
step (the PLM stage's mean over ceil(max_frames / 8) steps)."""
from benchmark import yardstick as Y


def read(rec):
    times = rec.get("stage_times", {}).get("plm")
    if not times:
        return None
    w = rec["work"]
    T = -(-w["max_frames"] // 8)
    nbytes, flops = Y.plm_decode_step_work(w["cfg"]["plm"], w["batch"], T)
    step_s = sum(times) / len(times) / T
    return 100.0 * Y.least_time(flops, nbytes) / step_s
