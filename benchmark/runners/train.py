"""PLM training: the step of ``training/lm_trainers.make_plm_train_step``
over a ``TrainState`` of the port's ``MegaPLM`` (fp32 masters, bf16
compute) and its AdamW, fed numpy batches as the loader hands them over.

Set-up builds the state with the benchmark's weights, moves the schedule
past warmup (so every timed update has lr > 0), and drives the first
``checked_steps`` steps through the window's own call and feed with
dropout masks the benchmark drew; the reference follows those steps.
The same state then runs the window.

Traffic keys, as ``data/datasets.py`` ``PLMBatchBuilder`` builds a batch:
``batch`` (rows), ``cuts_per_row`` (a cut behind its same-speaker prompt
cuts), ``cut_seconds`` ([low, high] of a cut's length, drawn uniformly),
``frame_rate`` and ``frames_per_code`` (a cut of d s has 1 + floor(d ×
frame_rate) frames, ceil(/ frames_per_code) codes), ``max_tokens`` (a
row's tail cut), ``pad_multiple`` (rows padded to a multiple of it over
the batch's longest), ``sizes_seed`` (the lengths: the same in every run,
so the seed changes what is said and the order, not the work),
``pool_batches`` (distinct batches made in set-up, taken in turn; each
warmed once), ``checked_steps``, ``trace_start_s`` and ``trace_seconds``.
"""
from __future__ import annotations

import statistics
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from .. import reference as R
from ..harness import Context, Spans, Tap, compared, rng, sub_seed
from ..trace import Slice
from ..weights import layout_of, make_weights

# rows a reference step takes at a time: its (rows, H, L, L) fp32 attention
# tensors, kept for the backward in 12 layers, fit in memory at L 1280
REFERENCE_ROWS = 3


def row_lengths(tr: dict) -> np.ndarray:
    """(pool_batches, batch) real code lengths, from ``sizes_seed`` alone:
    each row ``cuts_per_row`` cuts of uniform length in ``cut_seconds``,
    cut at ``max_tokens``."""
    r = np.random.default_rng(tr["sizes_seed"])
    lo, hi = tr["cut_seconds"]
    secs = r.uniform(lo, hi, (tr["pool_batches"], tr["batch"], tr["cuts_per_row"]))
    frames = 1 + np.floor(secs * tr["frame_rate"])
    codes = np.ceil(frames / tr["frames_per_code"]).sum(-1)
    return np.minimum(codes, tr["max_tokens"]).astype(np.int32)


def make_batches(seed: int, tr: dict, plm: dict) -> List[dict]:
    """The pool of PLM batches in the seed's order: BOS, then uniform codes
    over a row's real length, EOS after it, each batch padded to a multiple
    of ``pad_multiple`` over its longest row; code-rate latents N(0, 1) in
    fp16, zero past the length (``PLMBatchBuilder``'s layout)."""
    r = rng(seed, "batches")
    bos, eos, m = plm["vq_bins"], plm["vq_bins"] + 1, tr["pad_multiple"]
    out = []
    for lens in row_lengths(tr)[r.permutation(tr["pool_batches"])]:
        B, L = len(lens), -(-int(lens.max()) // m) * m
        codes = np.full((B, L + 1), eos, np.int32)
        codes[:, 0] = bos
        tc = np.zeros((B, L, plm["tc_latent_dim"]), np.float16)
        for b, n in enumerate(lens):
            codes[b, 1: n + 1] = r.integers(0, plm["vq_bins"], n)
            tc[b, :n] = r.standard_normal((n, plm["tc_latent_dim"]), np.float32)
        out.append({"p_codes": codes, "tc_latents": tc, "lens": lens})
    return out


def make_masks(seed: int, step: int, batch: dict, plm: dict, device) -> List[torch.Tensor]:
    """The dropout keep masks of one step over ``batch`` in the order the
    forward takes them: per layer the attention output's (B, L, d), then
    the FF hidden's (B, L, 4d)."""
    d = plm["vq_dim"] + plm["tc_latent_dim"]
    B, L, _ = batch["tc_latents"].shape
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "masks", step))
    out = []
    for _ in range(plm["n_layers"]):
        for width in (d, 4 * d):
            out.append(torch.rand((B, L, width), generator=gen, device=device) >= plm["dropout"])
    return out


def build_state(ctx: Context):
    from megatts2_tpu_torch.config import MegaPLMConfig, TrainConfig
    from megatts2_tpu_torch.models import MegaPLM
    from megatts2_tpu_torch.training import make_plm_train_step
    from megatts2_tpu_torch.training.lm_trainers import TrainState
    from megatts2_tpu_torch.training.schedules import make_adamw

    c, t = ctx.cfg["plm"], ctx.cfg["train"]
    plm_cfg = MegaPLMConfig(**c)
    tcfg = TrainConfig(initial_learning_rate=t["initial_learning_rate"],
                       warmup_steps=t["warmup_steps"], max_steps=t["max_steps"],
                       train_dtype=t["train_dtype"])
    with torch.device(ctx.device):
        model = MegaPLM(plm_cfg).to(ctx.device)  # the sinusoid table is made on the host
    layout = layout_of(model)
    model.load_state_dict(make_weights(layout, sub_seed(ctx.seed, "weights", "plm"), ctx.device))
    opt, sched = make_adamw(model.parameters(), tcfg.initial_learning_rate, tcfg.warmup_steps,
                            tcfg.max_steps)
    gen = torch.Generator(device=ctx.device).manual_seed(sub_seed(ctx.seed, "dropout"))
    state = TrainState(model, opt, sched, gen)
    with warnings.catch_warnings():  # the schedule alone, before any update
        warnings.simplefilter("ignore")
        for _ in range(t["start_step"]):
            sched.step()
    return make_plm_train_step(plm_cfg, tcfg)[0], state, layout


def run(ctx: Context, control: bool = False) -> dict:
    """One run; with ``control`` also the control's numbers (``calibrate.py``)."""
    from megatts2_tpu_torch.nn import Draws

    tr, c = ctx.traffic, ctx.cfg["plm"]
    step, state, layout = build_state(ctx)
    batches = make_batches(ctx.seed, tr, c)
    names = [n for n, _ in state.model.named_parameters()]
    params = dict(state.model.named_parameters())
    b1 = ctx.cfg["train"]["b1"]
    p0 = {n: p.detach().clone() for n, p in params.items()}
    prog = {"losses": []}
    notes = []
    for i in range(tr["checked_steps"]):
        batch = batches[i % len(batches)]
        state.draws = Draws(replay={"masks": make_masks(ctx.seed, i, batch, c, ctx.device)})
        m = step(state, batch)
        prog["losses"].append(float(m["loss_sum"]))
        left = len(state.draws.replay["masks"])
        if left:
            notes.append(f"step {i + 1} left {left} of the injected dropout masks unused")
            prog["losses"][-1] = float("nan")
        if i == 0:
            prog["grad"] = {n: _first_grad(state.opt, params[n], b1).cpu() for n in names}
            prog["first_grad"] = {n: float(g.norm()) for n, g in prog["grad"].items()}
    prog["change"] = {n: (params[n].detach() - p0[n]).cpu() for n in names}
    del p0
    state.draws = None
    n_pool = len(batches)
    k = max(tr["checked_steps"], n_pool) - 1
    for j in range(tr["checked_steps"], n_pool):  # warm: every batch's shape, the window's own draws
        m = step(state, batches[j])
    float(m["loss"])
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    spans = Spans(ctx.trace)
    trace = Slice() if ctx.trace else None
    if ctx.trace:  # host phases of a step, to name the device's idle gaps
        Tap(state.opt, "step", None, spans, "optimizer")
        fwd: list = []
        state.model.register_forward_pre_hook(lambda *a: fwd.append(time.perf_counter_ns()))
        state.model.register_forward_hook(
            lambda *a: spans.add("forward", fwd.pop(), time.perf_counter_ns()))
    tracing, traced, untraced = False, [], []
    results, ks = [], []
    t0 = time.perf_counter()
    while True:
        if trace is not None and trace.h0 is None and time.perf_counter() - t0 >= tr["trace_start_s"]:
            trace.start()
            tracing, t_trace = True, time.perf_counter()
        k += 1
        a = time.perf_counter_ns()
        results.append(step(state, batches[k % n_pool])["loss"])
        spans.add("train step: loss, backward, batch to the card", a, time.perf_counter_ns())
        ks.append(k % n_pool)
        (traced if tracing else untraced).append(k % n_pool)
        if tracing:
            if time.perf_counter() - t_trace >= tr["trace_seconds"]:
                trace.stop()
                tracing = False
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    if tracing:
        trace.stop()
    losses = torch.stack(results).float().cpu().numpy()
    memory = ctx.memory_peak()
    del state, step, params, results
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()
    lens = [b["lens"].tolist() for b in batches]
    rec = {"setup_s": setup_s, "window_s": window_s, "steps": len(ks), "attempted": len(ks),
           "failed": int((~np.isfinite(losses)).sum()), "memory_peak_bytes": memory,
           "untraced_s": window_s - (trace.span_s if trace is not None else 0.0),
           "work": {"plm": c, "step_lens": [lens[j] for j in ks],
                    "untraced_lens": [lens[j] for j in untraced],
                    "traced_lens": [lens[j] for j in traced]}}
    if trace is not None:
        rec["trace"] = trace.result(spans.items)
    ref = reference_steps(ctx, layout, batches, R.Precision("fp32"))
    rec["readings"], rec["control_readings"] = {}, {}
    rec["checks"], note = compare(prog, ref, ctx.limits, rec["readings"])
    notes.append(note)
    if control:
        rec["control_checks"], note = compare(
            reference_steps(ctx, layout, batches, R.Precision("fp8")), ref, ctx.limits,
            rec["control_readings"])
        notes.append("control's " + note)
    rec["notes"] = notes + [f"window: {len(ks)} steps in {window_s:.4f} s",
                            f"losses program {prog['losses']} reference {ref['losses']}"]
    return rec


def _first_grad(opt, p, b1: float) -> torch.Tensor:
    """The first gradient as AdamW got it: its first moment after one update / (1 - b1)."""
    return opt.state[p]["exp_avg"] / (1 - b1)


def reference_steps(ctx: Context, layout, batches, precision: R.Precision) -> dict:
    """The reference's ``checked_steps`` steps from the same weights, batches
    and dropout masks; per-leaf norms of the first gradient and the change."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr, c, t = ctx.traffic, ctx.cfg["plm"], ctx.cfg["train"]
    W = make_weights(layout, sub_seed(ctx.seed, "weights", "plm"), ctx.device)
    n = tr["checked_steps"]
    dev_batches = [{k: torch.as_tensor(v).to(ctx.device) for k, v in batches[i % len(batches)].items()}
                   for i in range(n)]
    keeps = [make_masks(ctx.seed, i, b, c, ctx.device) for i, b in enumerate(dev_batches)]
    opt = {"lr": t["initial_learning_rate"], "warmup_steps": t["warmup_steps"],
           "max_steps": t["max_steps"], "b1": t["b1"], "b2": t["b2"], "eps": t["eps"],
           "weight_decay": t["weight_decay"]}
    out = R.train_plm(W, c, opt, dev_batches, keeps, t["start_step"], precision,
                      REFERENCE_ROWS)
    return {"losses": out["losses"],
            "first_grad": {k: float(v.norm()) for k, v in out["first_grad"].items()},
            "grad": out["first_grad"], "change": out["change"]}


def leaf_gap(judged: Dict[str, float], ref: Dict[str, float], leaves,
             against_zero: bool = False) -> tuple:
    """(the worst leaf's |judged - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf, that leaf);
    ``against_zero``: ``judged`` holds each leaf's norm of the difference
    itself, set against 0."""
    med = statistics.median(ref[k] for k in ref)
    return max((abs(judged[k] - (0.0 if against_zero else ref[k])) / max(ref[k], med, 1e-30), k)
               for k in leaves)


def change_norms(judged: dict, ref: dict) -> tuple:
    """Each leaf's change norm on both sides over the elements whose
    reference gradient is at least a thousandth of the median leaf's RMS
    gradient; the rest are nought to rounding (a key's bias under softmax,
    merged into ``qkv``'s bias) and move under Adam by round-off alone.
    → (judged norms, reference norms, leaves with an element kept, elements
    left out)."""
    rms = {k: float(g.norm()) / max(g.numel(), 1) ** 0.5 for k, g in ref["grad"].items()}
    floor = 1e-3 * statistics.median(rms.values())
    a, b, out = {}, {}, 0
    for k, g in ref["grad"].items():
        keep = g.abs() >= floor
        out += int((~keep).sum())
        if keep.any():
            a[k] = float(judged["change"][k].to(g.device)[keep].norm())
            b[k] = float(ref["change"][k][keep].norm())
    return a, b, list(b), out


def compare(judged: dict, ref: dict, limits: Dict[str, float], readings: dict) -> tuple:
    """loss_gap (the worst step's relative gap), grad_gap and change_gap
    (the worst leaf's gap of norms, :func:`leaf_gap`; the change over the
    elements :func:`change_norms` keeps), and grad_err: the worst leaf's
    norm of the first gradient's difference, on the same scale.  A gap of
    norms barely moves under noise that averages out (an fp8 control reads
    2-3× bf16's on them), where the difference itself grows with it."""
    judged_change, ref_change, moving, n_out = change_norms(judged, ref)
    loss_gap = max(abs(a - b) / abs(b) if np.isfinite(a) else float("inf")
                   for a, b in zip(judged["losses"], ref["losses"]))
    grad, grad_leaf = leaf_gap(judged["first_grad"], ref["first_grad"], ref["first_grad"])
    errs = {k: float((judged["grad"][k].to(g.device) - g).norm()) for k, g in ref["grad"].items()}
    grad_err, err_leaf = leaf_gap(errs, ref["first_grad"], ref["first_grad"], against_zero=True)
    change, change_leaf = leaf_gap(judged_change, ref_change, moving)
    values = {"loss_gap": loss_gap, "grad_gap": grad, "change_gap": change, "grad_err": grad_err}
    readings.update(values)
    note = (f"worst leaf: gradient {grad_leaf}, its error {err_leaf}, change {change_leaf}; {n_out} elements "
            f"({len(ref['grad']) - len(moving)} whole leaves) left out of the change")
    return compared(values, limits), note
