"""Where a kernel call's time goes: the device, or the host that issues it.

    python megatts2_tpu_torch/tools/kernel_times.py [--root DIR]

For kernels A and B at the synthesis path's shapes, kernel A's backward
at the vocoder trainer's (B 8 and 16; also with clusters of one block, its
halo-only variant), and kernels B (with its statistics) and C at the
PLM trainer's (:func:`cases`, the inputs ``chip_smoke.py`` times too),
prints one JSON line each with three times per call, on the card:

* ``event_ms`` — CUDA events around 20 back-to-back warm calls;
* ``device_us`` — the kernel's own span in a ``torch.profiler`` trace;
* ``host_us`` — what the wrapper (Python, ctypes, allocation) costs the
  host to issue one call: the median over 21 rounds of the host clock
  around 100 calls with no synchronisation, the cases taking turns round
  by round (:func:`host_us`).

When ``host_us`` exceeds ``device_us`` the event time measures the host.
One more case, host work alone, is the Python check of TMA's rule on the
MRTE's q, k, v, which kernel B's wrapper makes only after its launcher
refuses a view.  ``--root`` imports ``megatts2_tpu_torch`` from another
checkout (an older tree unpacked beside this one), so two versions are
timed by one script on one card; each record's ``package`` names the tree.
Needs a card.
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import torch

ROOT = Path(__file__).resolve().parents[2]  # the checkout that holds this file
HOST_ITERS, HOST_ROUNDS = 100, 21
EVENT_ITERS = 20
PLM_LENS = (1024, 1024, 960, 800, 700, 512, 384, 100)  # the PLM batch's mixed lengths, as chip_smoke.py's


def trace_kernels(fn: Callable, n: int = 2) -> dict:
    """Device ms per call of each kernel that ``fn`` launches, by name, from
    a ``torch.profiler`` trace of n warm calls (each kernel's own span)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms[ev.name] = ms.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / n
    return ms


def device_kernels(fn: Callable) -> list[str]:
    """The names of the device kernels one warm call of ``fn`` launches, in
    order, from a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without device events: take another
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def host_us(fns: dict[str, Callable], iters: int = HOST_ITERS, rounds: int = HOST_ROUNDS) -> dict:
    """Host microseconds to issue one call of each of ``fns``: the median
    over ``rounds`` of the host clock around ``iters`` calls that end
    without a synchronisation (100 launches stay far inside the launch
    queue, so the host never waits on the device).  The functions take
    turns round by round, so a host that slows for a while slows them
    alike."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    samples: dict = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            samples[name].append((time.perf_counter() - t0) / iters * 1e6)
            torch.cuda.synchronize()
    return {name: statistics.median(s) for name, s in samples.items()}


def device_times(fn: Callable, kernel: str) -> dict:
    """``event_ms`` of ``fn`` and its ``device_us``: the profiled spans
    whose name contains ``kernel``, summed per call (None if the trace
    holds none)."""
    from megatts2_tpu_torch.tools.bw_ceiling import time_ms

    for _ in range(3):  # a trace now and then comes back without device events: take another
        spans = trace_kernels(fn, 10)
        dev = [t for name, t in spans.items() if kernel in name]
        if dev:
            break
    return {"event_ms": time_ms(fn, torch.device("cuda"), EVENT_ITERS),
            "device_us": sum(dev) * 1e3 if dev else None}


def time_cases(cases: dict) -> dict:
    """name → ``event_ms``, ``device_us`` and ``host_us`` of each of
    :func:`cases`; the first two None for host work."""
    out = {name: device_times(fn, kernel) if kernel else {"event_ms": None, "device_us": None}
           for name, (fn, kernel) in cases.items()}
    for name, us in host_us({name: fn for name, (fn, _) in cases.items()}).items():
        out[name]["host_us"] = us
    return out


def inputs(dev: torch.device, seed: int = 0) -> dict:
    """Kernel B's and A's inputs on the synthesis path: the MRTE's
    self-attention (8, 64, 2, 256) bf16 with mixed key lengths, the batched
    prompt front end (8, 131000) and one ~4 s prompt (64001,), fp32; and
    kernel A's backward on the vocoder trainer's crops, (8, 16384) fp32
    with a gradient for each of its (8, 65, 80) mels, and at the shipped
    config's batch of 16 (``mel_bwd_16``); the PLM trainer's
    causal self-attention (8, 1024, 16, 64) bf16 with mixed lengths, q, k,
    v and the output's gradient."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(8, 64, 2, 256, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
    lens = torch.randint(16, 65, (8,), generator=gen, dtype=torch.int32).to(dev)
    plm = [torch.randn(8, 1024, 16, 64, generator=gen).to(dev, torch.bfloat16) for _ in range(4)]
    plm_lens = torch.tensor(PLM_LENS, dtype=torch.int32, device=dev)
    return {"mrte": (q, k, v, lens), "plm": (*plm, plm_lens),
            "mel": (torch.randn(8, 131000, generator=gen) * 0.1).to(dev),
            "mel_prompt": (torch.randn(64001, generator=gen) * 0.1).to(dev),
            "mel_bwd": ((torch.randn(8, 16384, generator=gen) * 0.1).to(dev),
                        torch.randn(8, 65, 80, generator=gen).to(dev)),
            "mel_bwd_16": ((torch.randn(16, 16384, generator=gen) * 0.1).to(dev),
                           torch.randn(16, 65, 80, generator=gen).to(dev))}


def cases(x: dict) -> dict[str, tuple[Callable, Optional[str]]]:
    """name → (call, kernel name in the trace, or None for host work) over
    :func:`inputs`; kernel A's backward also in its halo-only variant
    (``_halo``: clusters of one block) where the package has it."""
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.ops import mel

    q, k, v, lens = x["mrte"]
    pq, pk, pv, pg, plens = x["plm"]
    _, m, l = att.flash_attention_cuda(pq, pk, pv, plens, True, return_stats=True)

    class Counter:  # _tma_ready's wrapper argument; never counts here
        layout_copies = 0

    bwd = {}
    for key in ("mel_bwd", "mel_bwd_16"):
        bwd[key] = (functools.partial(mel.mel_spectrogram_bwd_cuda, *x[key]), "mel_bwd")
        if hasattr(mel, "bwd_plan"):  # the one-launch design takes a cluster size
            bwd[f"{key}_halo"] = (functools.partial(mel.mel_spectrogram_bwd_cuda, *x[key], cluster=1),
                                  "mel_bwd")
    return {
        "flash_mrte": (lambda: att.flash_attention_cuda(q, k, v, lens), "flash"),
        "flash_mrte_simt": (lambda: att.flash_attention_cuda(q, k, v, lens, simt=True), "flash"),
        "tma_check": (lambda: [att._tma_ready(t, Counter) for t in (q, k, v)], None),
        "mel": (lambda: mel.mel_spectrogram_cuda(x["mel"]), "mel"),
        "mel_prompt": (lambda: mel.mel_spectrogram_cuda(x["mel_prompt"]), "mel"),
        **bwd,
        "flash_plm": (lambda: att.flash_attention_cuda(pq, pk, pv, plens, True, return_stats=True),
                      "flash"),
        "flash_bwd_plm": (lambda: att.flash_attention_bwd_cuda(pq, pk, pv, plens, True, pg, m, l),
                          "flash_"),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT), help="checkout whose megatts2_tpu_torch to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA device")
    import megatts2_tpu_torch
    from megatts2_tpu_torch.csrc.build import load_library
    from megatts2_tpu_torch.tools.bw_ceiling import card_name

    load_library()
    dev = torch.device("cuda")
    card = card_name(dev)
    for name, times in time_cases(cases(inputs(dev))).items():
        print(json.dumps({"package": megatts2_tpu_torch.__file__, "case": name, **times, "card": card}),
              flush=True)


if __name__ == "__main__":
    main()
