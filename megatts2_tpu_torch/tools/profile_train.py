"""Per-op device profile of the training steps (port of ``tools/profile_train.py``).

    python -m megatts2_tpu_torch.tools.profile_train gan [trace_dir] [--device cuda]
    python -m megatts2_tpu_torch.tools.profile_train vocoder
    python -m megatts2_tpu_torch.tools.profile_train plm

Builds the same reference-size synthetic steps as ``bench_train`` (its
``build_*_step``), runs two warm steps, records a ``torch.profiler`` trace
of three more into ``trace_dir/trace.json`` (Chrome format) and prints, one
JSON line each, the traced window (device busy ms, the span from the first
device op's start to the last one's end, and the idle share of that span)
and the top 40 device ops by total self time.  Every line carries the card's
name and power limit.  Runs on the card unless given ``--device cpu``; on
the CPU the trace holds CPU ops, whose times include their children.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
from typing import Callable

from ..training.lm_trainers import train_device
from . import bench_train
from .bw_ceiling import card_name

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device ops in a torch.profiler trace
TRACED_STEPS = 3
BUILDERS = {"gan": bench_train.build_gan_step, "vocoder": bench_train.build_vocoder_step,
            "plm": bench_train.build_plm_step}


def _busy_ms(spans: list) -> float:
    """ms covered by the union of (start, end) µs intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def summarize(trace_path: str, top: int = 40, cats: tuple = DEVICE_CATS, plane: str = "cuda",
              card: str = "", emit: Callable = print) -> list:
    """The window's line, then the ``top`` ops of the categories ``cats`` by
    total time, from a Chrome trace that ``torch.profiler`` wrote."""
    with open(trace_path) as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev.get("ph") == "X" and ev.get("cat") in cats]
    if not events:
        raise RuntimeError(f"{trace_path}: no op of {cats} in the trace")
    tot, cnt = collections.Counter(), collections.Counter()
    for ev in events:
        tot[ev["name"]] += ev["dur"]
        cnt[ev["name"]] += 1
    spans = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in events]
    window = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3
    busy = _busy_ms(spans)
    total = sum(tot.values())
    records = [{"plane": plane, "total_ms": round(total / 1e3, 3), "busy_ms": round(busy, 3),
                "window_ms": round(window, 3), "idle_share": round(1 - busy / window, 4),
                "ops": len(tot), "device": card}]
    for name, us in tot.most_common(top):
        records.append({"op": name[:140], "ms": round(us / 1e3, 3), "count": cnt[name],
                        "pct": round(100 * us / max(total, 1), 1), "device": card})
    for rec in records:
        emit(json.dumps(rec))
    return records


def profile(stage: str, trace_dir: str, device="cuda", top: int = 40, emit: Callable = print,
            **build_kwargs) -> list:
    """Trace TRACED_STEPS warm steps of ``stage`` (``bench_train``'s builders,
    ``build_kwargs`` passed on) and summarize the trace; returns the records."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    device = train_device(device)
    step, state, batch, key = BUILDERS[stage](device=device, **build_kwargs)
    batch = bench_train.to_device(batch, device)
    for _ in range(2):  # warm
        float(step(state, batch)[key])
    on_card = device.type == "cuda"
    activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    with torch_profile(activities=[activity]) as prof:
        for _ in range(TRACED_STEPS):
            m = step(state, batch)
        float(m[key])
        bench_train.sync(device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return summarize(path, top, DEVICE_CATS if on_card else ("cpu_op",),
                     "cuda" if on_card else "cpu (op times include their children)",
                     card_name(device), emit)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stage", nargs="?", default="gan", choices=sorted(BUILDERS))
    ap.add_argument("trace_dir", nargs="?", default=None,
                    help="default: train_trace_<stage> in the temporary directory")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    trace_dir = args.trace_dir or os.path.join(tempfile.gettempdir(), f"train_trace_{args.stage}")
    return profile(args.stage, trace_dir, args.device)


if __name__ == "__main__":
    main()
