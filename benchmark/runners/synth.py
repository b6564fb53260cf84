"""Offline batch synthesis: ``models/megatts.py`` ``synthesize`` back to back
on the modules a ``Megatts`` instance prepared, the waveforms brought to
the host and trimmed by their frame counts.

Traffic keys: ``batch``, ``phones`` (a row's phone count), ``phone_ids``
([low, high] of the drawn ids), ``prompt_frames``, ``prompt_pool``
(speakers whose prompt mels the port's front end makes once in set-up),
``max_frames``, ``pool_batches`` (distinct batches drawn from the seed,
taken in turn), ``check_batches`` (batches of the window the reference
judges, drawn from the seed), ``trace_start_s`` and ``trace_seconds``.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

import numpy as np
import torch

from .. import reference as R
from ..harness import Context, Spans, Tap, compared, rng, sub_seed
from ..stack import HOP, SR, Reference, build, judge_sample, prompt_waves, stack_weights
from ..trace import Slice

STAGES = ("mrte", "adm", "plm", "decoder", "vocoder")


def make_inputs(ctx: Context, mt) -> dict:
    from megatts2_tpu_torch.ops import mel_spectrogram

    tr, dev = ctx.traffic, ctx.device
    B, Tp, n = tr["batch"], tr["phones"], tr["pool_batches"]
    r = rng(ctx.seed, "phones")
    lo, hi = tr["phone_ids"]
    phones = torch.from_numpy(r.integers(lo, hi + 1, (n, B, Tp))).to(dev)
    speaker = r.integers(0, tr["prompt_pool"], (n, B))
    waves = prompt_waves(ctx.seed, tr["prompt_pool"], tr["prompt_frames"], dev)
    mels = mel_spectrogram(waves)  # the port's front end, once
    return {"phones": phones, "lens": torch.full((B,), Tp, dtype=torch.long, device=dev),
            "speaker": speaker, "waves": waves,
            "mels": [mels[torch.from_numpy(speaker[k]).to(dev)] for k in range(n)]}


class Capture:
    """Taps on what ``synthesize`` computes on the way (the MRTE latent, the
    ADM's raw predictions and durations, the prosody codes), kept for the
    batches the check draws."""

    def __init__(self, mt, spans: Spans):
        from megatts2_tpu_torch.models import fast_decode, megatts

        self.last: Dict[str, torch.Tensor] = {}
        put = lambda key: (lambda out, *a, **k: self.last.__setitem__(key, out))  # noqa: E731
        self.taps = [Tap(mt.g.mrte, "tc_latent", put("tc"), spans, "mrte"),
                     Tap(fast_decode, "adm_decode_raw", put("raw"), Spans(False)),
                     Tap(megatts, "adm_infer", put("dt"), spans, "adm"),
                     Tap(megatts, "plm_infer", put("codes"), spans, "plm")]

    def close(self) -> None:
        for t in reversed(self.taps):
            t.restore()


def run(ctx: Context, control: bool = False) -> dict:
    """One run; with ``control`` also the control's numbers (``calibrate.py``)."""
    from megatts2_tpu_torch.models import megatts

    tr = ctx.traffic
    spans = Spans(ctx.trace)
    mt, layouts = build(ctx.cfg, ctx.seed, ctx.device, ctx.work_dir)
    inputs = make_inputs(ctx, mt)
    cap = Capture(mt, spans)
    synthesize = spans.wrap(megatts.synthesize, "synthesize")
    B, n_pool, max_frames = tr["batch"], tr["pool_batches"], tr["max_frames"]
    stage_times: Dict[str, List[float]] = {s: [] for s in STAGES}

    def one(k: int, timed: bool):
        st = {} if (ctx.trace and timed) else None
        wav, mel, nf = synthesize(mt.g, mt.plm, mt.adm, mt.vocoder, inputs["phones"][k],
                                  inputs["lens"], inputs["mels"][k], max_frames,
                                  quant=mt.quant_int8, stage_times=st)
        t0 = time.perf_counter_ns()
        wav_h, nf_h = wav.cpu().numpy(), nf.cpu().numpy()
        wavs = [wav_h[b, : int(nf_h[b]) * HOP] for b in range(B)]
        spans.add("waveforms to the host", t0, time.perf_counter_ns())
        if st is not None:
            for s in STAGES:
                stage_times[s].append(st[s])
        return wavs, nf_h, mel

    one(0, False)  # warm-up: every shape of the cell
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    draw = random.Random(sub_seed(ctx.seed, "check"))
    kept, seen = [], 0
    utts = failed = 0
    audio_s = 0.0
    trace = Slice() if ctx.trace else None
    tracing, untraced = False, 0
    t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - t0
        if trace is not None and trace.h0 is None and now >= tr["trace_start_s"]:
            trace.start()
            tracing, t_trace = True, time.perf_counter()
        k = i % n_pool
        untraced += not tracing
        wavs, nf_h, mel = one(k, True)
        utts += B
        failed += sum(1 for w in wavs if not np.isfinite(w).all())
        audio_s += float(nf_h.sum()) * HOP / SR
        seen += 1  # reservoir sample of the batches the check judges
        slot = seen - 1 if len(kept) < tr["check_batches"] else draw.randrange(seen)
        if slot < tr["check_batches"]:
            sample = dict(cap.last, k=k, mel=mel, n_frames=nf_h,
                          wav=torch.from_numpy(np.concatenate(wavs)))
            if len(kept) < tr["check_batches"]:
                kept.append(sample)
            else:
                kept[slot] = sample
        i += 1
        if tracing and time.perf_counter() - t_trace >= tr["trace_seconds"]:
            trace.stop()
            tracing = False
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if tracing:
        trace.stop()
    window_s = time.perf_counter() - t0
    memory = ctx.memory_peak()
    cap.close()
    del mt, cap
    rec = {"setup_s": setup_s, "window_s": window_s, "batches": i, "utterances": utts,
           "untraced_s": window_s - (trace.span_s if trace is not None else 0.0),
           "untraced_batches": untraced,
           "attempted": utts, "failed": failed, "audio_s": audio_s,
           "memory_peak_bytes": memory, "stage_times": stage_times,
           "work": {"batch": B, "phones": tr["phones"], "prompt_frames": tr["prompt_frames"],
                    "max_frames": max_frames, "cfg": ctx.cfg}}
    if trace is not None:
        rec["trace"] = trace.result(spans.items)
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()
    rec["readings"], rec["notes"] = check(ctx, layouts, inputs, kept)
    rec["checks"] = compared(rec["readings"], ctx.limits)
    if control:
        rec["control_readings"] = check(ctx, layouts, inputs, kept, control=True)[0]
        rec["control_checks"] = compared(rec["control_readings"], ctx.limits)
    rec["notes"].insert(0, f"window: {i} batches, {utts} utterances, {audio_s:.3f} audio s "
                           f"in {window_s:.4f} s")
    return rec


def check(ctx: Context, layouts, inputs: dict, kept: list, control: bool = False):
    """Every number the check reads (the worst over the judged batches),
    and notes; with ``control``, those of the control."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = stack_weights(layouts, ctx.cfg, ctx.seed, ctx.device)
    ref = Reference(weights, ctx.cfg, R.Precision("fp32", 8))
    ctl = Reference(weights, ctx.cfg, R.Precision("fp8", 4)) if control else None
    worst: Dict[str, float] = {}
    for s in kept:
        k = s["k"]
        ins = {"phone": inputs["phones"][k], "lens": inputs["lens"],
               "waves": inputs["waves"][torch.from_numpy(inputs["speaker"][k]).to(ctx.device)]}
        for name, v in judge_sample(ref, s, ins, ctx.traffic["max_frames"], ctl).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst, [f"judged {len(kept)} batches"]
