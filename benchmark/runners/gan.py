"""VQ-GAN training (stage 1): the step of ``training/gan_trainer.py``
``make_gan_train_step`` over the ``GANTrainState`` that
``create_gan_state`` makes (G and D in fp32, their AdamWs), computing in
``train_dtype``, fed numpy batches in ``GANBatchBuilder``'s layout, as
``cli fit gan`` drives it.

Set-up loads the benchmark's weights into the state (the codebook as a
resumed run leaves it, :func:`gan_weights`), moves both schedules past
warmup (so every timed update has lr > 0) and drives the first
``checked_steps`` steps through the window's own call with the draws the
benchmark made (dropout masks, the codebook's sample rows, the window
starts, replayed through a ``Draws``); ``benchmark/reference_gan.py``
follows those steps, teacher-forced with the program's codes, and the
codes are held against the reference's latents and codebook and against
the program's own.  The state,
its draws then taken from generators seeded by the run's seed, runs the
window: whole passes over the pool of batches, each ended by a
synchronisation, while another pass fits in ``--seconds``;
``train_step_ms`` is their wall over their steps, so every batch weighs
the same in every run.  With ``--trace 1`` the port's tracer is on over
the window, and one whole pass after ``trace_start_s`` is the traced
slice; its ``gan.*`` spans go to ``rec["program"]`` and ``by_span``.

Traffic keys: ``batch`` (rows), ``cut_seconds`` ([low, high] of a row's
length, drawn uniformly from ``sizes_seed``), ``frame_rate`` (a cut of d
s has 1 + floor(d × frame_rate) target frames), ``phones_per_second``
(round(d × it) phones, their durations summing to the frames),
``phone_pad`` and ``mel_pad`` (``GANBatchBuilder``'s multiples), ``min_mel_frames``,
``timbre_frames``, ``phone_ids`` ([low, high] of the drawn ids),
``sizes_seed``, ``pool_batches`` (made in set-up, each warmed once),
``checked_steps`` and ``trace_start_s``.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from .. import reference as R
from .. import reference_gan as RG
from .. import trace
from ..harness import Context, Spans, compared, rng, sub_seed
from ..program_spans import by_span
from ..weights import layout_of, make_weights
from .train import change_norms, leaf_gap

# rows G's reference takes at a time: its fp32 activations, kept for the
# backward, fit beside the program's freed state
REFERENCE_ROWS = 8
# the codebook's EMA mass a code: uniform in [low, high), about the mean
# a code holds at 6656 latents a step over 1024 codes; those under 2 expire
CLUSTER_SIZE = (1.0, 12.0)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def row_sizes(tr: dict) -> tuple:
    """(target frames, phones), each (pool_batches, batch), from ``sizes_seed`` alone."""
    r = np.random.default_rng(tr["sizes_seed"])
    lo, hi = tr["cut_seconds"]
    secs = r.uniform(lo, hi, (tr["pool_batches"], tr["batch"]))
    frames = (1 + np.floor(secs * tr["frame_rate"])).astype(np.int64)
    phones = np.maximum(np.rint(secs * tr["phones_per_second"]), 1).astype(np.int64)
    return frames, phones


def make_batches(seed: int, tr: dict) -> List[Dict[str, np.ndarray]]:
    """The pool in the seed's order, in ``GANBatchBuilder``'s layout: phone
    ids and durations (a row's frames split at distinct random points)
    padded with 0 to a multiple of ``phone_pad``; fp16 target mels N(0, 1)
    over a row's frames, zero past them, padded to a multiple of
    ``mel_pad`` over the batch's longest (at least ``min_mel_frames``);
    fp16 timbre mels of ``timbre_frames``."""
    r = rng(seed, "batches")
    frames, phones = row_sizes(tr)
    lo, hi = tr["phone_ids"]
    out = []
    for k in r.permutation(tr["pool_batches"]):
        F_, P_ = frames[k], phones[k]
        B = len(F_)
        T = _round_up(max(int(F_.max()), tr["min_mel_frames"]), tr["mel_pad"])
        Tp = _round_up(int(P_.max()), tr["phone_pad"])
        phone = np.zeros((B, Tp), np.int32)
        dur = np.zeros((B, Tp), np.int32)
        mel = np.zeros((B, T, 80), np.float16)
        for b in range(B):
            n, f = int(P_[b]), int(F_[b])
            phone[b, :n] = r.integers(lo, hi + 1, n)
            cuts = np.sort(r.choice(np.arange(1, f), n - 1, replace=False))
            dur[b, :n] = np.diff(np.concatenate([[0], cuts, [f]]))
            mel[b, :f] = r.standard_normal((f, 80), np.float32)
        out.append({"phone_tokens": phone, "duration_tokens": dur,
                    "tokens_lens": P_.astype(np.int32), "mel_targets": mel,
                    "mel_target_lens": F_.astype(np.int32),
                    "mel_timbres": r.standard_normal((B, tr["timbre_frames"], 80),
                                                     np.float32).astype(np.float16)})
    return out


def make_draws(seed: int, step: int, batch: dict, cfg: dict, device) -> dict:
    """The draws of checked step ``step`` over ``batch``, as a ``Draws``
    replays them: the dropout keep masks in the order the step takes them
    (``reference_gan.mask_shapes``), the codebook's sample rows (distinct,
    over the batch's latents) and one window start a window length."""
    B, T = batch["mel_targets"].shape[:2]
    Tp, Tm = batch["phone_tokens"].shape[1], batch["mel_timbres"].shape[1]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "masks", step))
    masks = [torch.rand(shape, generator=gen, device=device) >= rate
             for shape, rate in RG.mask_shapes(cfg, B, T, Tp, Tm)]
    v = cfg["g"]["vqpe"]
    n, K = B * -(-T // v["stride"]), v["vq_bins"]
    idx = (torch.randperm(n, generator=gen, device=device)[:K] if n >= K
           else torch.randint(0, n, (K,), generator=gen, device=device))
    r = rng(seed, "starts", step)
    max_len = min(int(batch["mel_target_lens"].max()), T)
    starts = [int(r.integers(0, max(max_len - wl, 0) + 1)) for wl in cfg["d"]["time_lengths"]]
    return {"masks": masks, "indices": [idx], "starts": starts}


def port_configs(cfg: dict) -> tuple:
    from megatts2_tpu_torch.config import (DiscriminatorConfig, MegaGConfig, MRTEConfig,
                                           TrainConfig, VQPEConfig)

    g = dict(cfg["g"])
    g_cfg = MegaGConfig(mrte=MRTEConfig(**g.pop("mrte")), vqpe=VQPEConfig(**g.pop("vqpe")), **g)
    d = dict(cfg["d"])
    d_cfg = DiscriminatorConfig(**{**d, "time_lengths": tuple(d["time_lengths"]),
                                   "kernel": tuple(d["kernel"])})
    t = cfg["train"]
    keys = ("initial_learning_rate", "warmup_steps", "max_steps", "G_commit_loss_coeff",
            "G_vq_loss_coeff", "G_adv_loss_coeff", "g_ema_decay", "train_dtype")
    return g_cfg, d_cfg, TrainConfig(**{k: t[k] for k in keys})


def gan_weights(layout: list, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """G's and D's fp32 weights from the seed (``weights.make_weights``),
    under ``g.`` and ``d.``: BatchNorm as flax starts it (scale 1, bias 0,
    mean 0, variance 1); the codebook as a resumed run leaves it:
    ``inited`` 1, rows N(0, 1), each code's EMA mass uniform in
    :data:`CLUSTER_SIZE` and ``embed_avg`` the rows times their smoothed
    mass, so that ``embed = embed_avg / smoothed`` holds."""
    W = make_weights(layout, sub_seed(seed, "weights", "gan"), device)
    for k in W:
        if ".bn." in k:
            leaf = k.rsplit(".", 1)[-1]
            W[k] = torch.full_like(W[k], 1.0 if leaf in ("scale", "var") else 0.0)
    K = cfg["g"]["vqpe"]["vq_bins"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "cluster_size"))
    lo, hi = CLUSTER_SIZE
    size = lo + (hi - lo) * torch.rand(K, generator=gen, device=device)
    total = size.sum()
    smoothed = (size + RG.EPSILON) / (total + K * RG.EPSILON) * total
    W[RG.CODEBOOK + "cluster_size"] = size
    W[RG.CODEBOOK + "embed_avg"] = W[RG.CODEBOOK + "embed"] * smoothed[:, None]
    W[RG.CODEBOOK + "inited"] = torch.ones_like(W[RG.CODEBOOK + "inited"])
    return W


def _split(W: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in W.items() if k.startswith(prefix)}


def build_state(ctx: Context):
    """(train step, state, layout): ``create_gan_state`` with the
    benchmark's weights, its draws from the run's seed, both schedules at
    ``start_step``."""
    import warnings

    from megatts2_tpu_torch.training import create_gan_state, make_gan_train_step

    g_cfg, d_cfg, tcfg = port_configs(ctx.cfg)
    state = create_gan_state(g_cfg, d_cfg, tcfg, device=ctx.device)
    layout = ([("g." + n, s) for n, s in layout_of(state.g)]
              + [("d." + n, s) for n, s in layout_of(state.d)])
    W = gan_weights(layout, ctx.cfg, ctx.seed, ctx.device)
    state.g.load_state_dict(_split(W, "g."))
    state.d.load_state_dict(_split(W, "d."))
    del W
    state.draws = _run_draws(ctx)
    with warnings.catch_warnings():  # the schedules alone, before any update
        warnings.simplefilter("ignore")
        for _ in range(ctx.cfg["train"]["start_step"]):
            state.g_sched.step()
            state.d_sched.step()
    return make_gan_train_step(g_cfg, d_cfg, tcfg), state, layout


def _run_draws(ctx: Context):
    from megatts2_tpu_torch.nn import Draws

    return Draws(torch.Generator(device=ctx.device).manual_seed(sub_seed(ctx.seed, "draws")),
                 torch.Generator().manual_seed(sub_seed(ctx.seed, "host draws")))


def params_of(state) -> Dict[str, torch.nn.Parameter]:
    """G's and D's parameters under ``g.`` and ``d.``, the weights' layout."""
    return {**{"g." + n: p for n, p in state.g.named_parameters()},
            **{"d." + n: p for n, p in state.d.named_parameters()}}


def statistics_of(state) -> Dict[str, torch.Tensor]:
    """The codebook's and BatchNorm's statistics on the host, fp32."""
    sd = {**{"g." + n: t for n, t in state.g.state_dict().items()},
          **{"d." + n: t for n, t in state.d.state_dict().items()}}
    return {k: v.detach().float().cpu().clone() for k, v in sd.items() if RG.is_statistic(k)}


class GanSlice(trace.Slice):
    """The traced slice, reduced as ``trace.Slice`` reduces it with the
    port's spans beside the runner's phases (they name the idle gaps), and
    ``by_span``: the device ops, as that reduction maps them to the host
    clock, that start inside each span (``program_spans.by_span``)."""

    def result(self, phases_ns: list, program: list) -> dict:
        seen, reduce = {}, trace.summarize

        def keep_ops(ops, t0, t1, phases):
            seen["ops"] = ops
            return reduce(ops, t0, t1, phases)

        trace.summarize = keep_ops
        try:
            out = super().result(list(phases_ns) + [s[:3] for s in program])
        finally:
            trace.summarize = reduce
        at = lambda ns: (ns - self.h0) / 1e9  # noqa: E731
        out["by_span"] = by_span(seen["ops"], [(n, at(a), at(b), k) for n, a, b, k in program],
                                 out["window_s"])
        return out


def run(ctx: Context, control: bool = False) -> dict:
    """One run; with ``control`` also the control's numbers (``calibrate.py``)."""
    from megatts2_tpu_torch.nn import Draws
    from megatts2_tpu_torch.utils import tracing

    tr, cfg = ctx.traffic, ctx.cfg
    step, state, layout = build_state(ctx)
    batches = make_batches(ctx.seed, tr)
    params = params_of(state)
    p0 = {n: p.detach().clone() for n, p in params.items()}
    b1 = cfg["train"]["b1"]
    prog = {"metrics": [], "ze": [], "embed": [], "codes": []}

    def before(cb, args):  # the latents and the codebook they are assigned from
        prog["ze"].append(args[0].detach().float().clone())
        prog["embed"].append(cb.embed.detach().clone())

    cb = state.g.vqpe.vq.layers[0]._codebook
    hooks = [cb.register_forward_pre_hook(before),
             cb.register_forward_hook(lambda m, a, o: prog["codes"].append(o[1].detach().clone()))]
    notes = []
    n_pool, checked = len(batches), tr["checked_steps"]
    for i in range(checked):
        batch = batches[i % n_pool]
        state.draws = Draws(replay=make_draws(ctx.seed, i, batch, cfg, ctx.device))
        m = step(state, batch)
        prog["metrics"].append({k: float(v) for k, v in m.items()})
        left = {k: len(v) for k, v in state.draws.replay.items() if v}
        if left:
            notes.append(f"step {i + 1} left injected draws unused: {left}")
            prog["metrics"][-1] = {k: float("nan") for k in m}
        if i == 0:
            opt = {**{n: state.g_opt for n in params if n.startswith("g.")},
                   **{n: state.d_opt for n in params if n.startswith("d.")}}
            prog["grad"] = {n: (opt[n].state[p]["exp_avg"] / (1 - b1)).cpu()
                            for n, p in params.items()}
    for h in hooks:
        h.remove()
    prog["change"] = {n: (params[n].detach() - p0[n]).cpu() for n in params}
    prog["stats"] = statistics_of(state)
    del p0
    state.draws = _run_draws(ctx)
    for j in range(checked, n_pool):  # warm: every batch, the window's own draws
        m = step(state, batches[j])
    float(m["G_loss_total"])
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    spans = Spans(ctx.trace)
    sliced = GanSlice() if ctx.trace else None
    if ctx.trace:
        tracing.drain()
        tracing.enable()
    losses, passes = [], []  # passes: whether each was traced
    t0 = time.perf_counter()
    while True:
        traced = sliced is not None and sliced.h0 is None and \
            time.perf_counter() - t0 >= tr["trace_start_s"]
        if traced:
            sliced.start()
        for b in batches:
            a = time.perf_counter_ns()
            losses.append(step(state, b)["G_loss_total"])
            spans.add("gan_train_step", a, time.perf_counter_ns())
        if traced:
            sliced.stop()
        else:
            ctx.sync()
        passes.append(traced)
        window_s = time.perf_counter() - t0
        if window_s + window_s / len(passes) > ctx.seconds:  # another pass would not fit
            break
    program = tracing.drain() if ctx.trace else []
    tracing.disable()
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    memory = ctx.memory_peak()
    del state, step, params, losses
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()

    def shape(b):  # (B, T, Tp, Tm)
        return [*b["mel_targets"].shape[:2], b["phone_tokens"].shape[1], b["mel_timbres"].shape[1]]

    steps = n_pool * len(passes)
    rec = {"setup_s": setup_s, "window_s": window_s, "steps": steps, "attempted": steps,
           "failed": failed, "memory_peak_bytes": memory,
           "untraced_s": window_s - (sliced.span_s if sliced is not None else 0.0),
           "work": {"cfg": {"g": cfg["g"], "d": cfg["d"]}, "shapes": [shape(b) for b in batches],
                    "untraced_passes": passes.count(False), "passes": len(passes)}}
    if sliced is not None:
        rec["trace"] = sliced.result(spans.items, program)
        rec["program"] = {"spans": [list(s) for s in program],
                          "slice_ns": [int(sliced.t_enter * 1e9), int(sliced.t_exit * 1e9)]}

    dev_batches = [_on_device(batches[i % n_pool], ctx.device) for i in range(checked)]
    ref = reference_steps(ctx, layout, dev_batches, R.Precision("fp32"), prog["codes"])
    rec["readings"], rec["control_readings"] = {}, {}
    rec["checks"], note = compare(prog, ref, ctx.limits, rec["readings"])
    notes.append(note)
    if control:
        ctl = reference_steps(ctx, layout, dev_batches, R.Precision("fp8"))
        ctl_ref = reference_steps(ctx, layout, dev_batches, R.Precision("fp32"), ctl["codes"])
        rec["control_checks"], note = compare(ctl, ctl_ref, ctx.limits, rec["control_readings"])
        notes.append("control's " + note)
    rec["notes"] = notes + [
        f"window: {steps} steps in {len(passes)} passes in {window_s:.4f} s",
        f"G_loss_total program {[m['G_loss_total'] for m in prog['metrics']]} "
        f"reference {[m['G_loss_total'] for m in ref['metrics']]}"]
    return rec


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def reference_steps(ctx: Context, layout, batches: list, precision: R.Precision,
                    codes=None) -> dict:
    """The reference's ``checked_steps`` steps from the same weights, batches
    and draws (``codes``: the assignment teacher-forced, or None; codes
    that do not cover a batch's latents, as those of a step over fewer
    rows, are not taken, and :func:`reference_gan.code_gap` reads them
    infinite)."""
    stride = ctx.cfg["g"]["vqpe"]["stride"]
    if codes is not None and any(
            tuple(c.shape) != (b["mel_targets"].shape[0], -(-b["mel_targets"].shape[1] // stride))
            for c, b in zip(codes, batches)):
        codes = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    W = gan_weights(layout, ctx.cfg, ctx.seed, ctx.device)
    draws = [make_draws(ctx.seed, i, b, ctx.cfg, ctx.device) for i, b in enumerate(batches)]
    out = RG.train_gan(W, ctx.cfg, batches, draws, ctx.cfg["train"]["start_step"], precision,
                       REFERENCE_ROWS, codes)
    out["grad"] = out.pop("first_grad")
    out["stats"] = {k: v.float().cpu() for k, v in out["stats"].items()}
    return out


def compare(judged: dict, ref: dict, limits: Dict[str, float], readings: dict) -> tuple:
    """The readings, each the worst over the checked steps or the leaves:
    ``loss_gap`` (a metric's relative gap), ``grad_gap``, ``grad_err`` and
    ``change_gap`` as ``plm-train`` reads them (the first gradient and the
    change of every parameter of G and D), ``codebook_gap`` (``embed``,
    ``embed_avg``, ``cluster_size``) and ``bn_gap`` (BatchNorm's running
    statistics): the norm of a leaf's difference over the larger of its
    reference norm and the median leaf's; the judged side's codes, which
    the reference takes as they are, held against the reference's latents
    and the codebook before each update (``ref_assign_gap``) and against
    the judged side's own (``assign_gap``: 0 when each is the nearest,
    whatever the precision), both ``reference_gan.code_gap``;
    ``grad_err_median``, the median leaf's ``grad_err``: the worst leaf's
    is set by the few whose gradient is weak beside what the step's kinks
    (ReLU, LeakyReLU, L1) pass or stop when rounding moves an input across
    them, and the median's by the whole step.  The cell's
    limits file names the readings compared; the rest are read for
    calibration."""
    loss_gap = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) if np.isfinite(a[k]) else float("inf")
                   for a, b in zip(judged["metrics"], ref["metrics"]) for k in b)
    norms = {k: float(g.norm()) for k, g in ref["grad"].items()}
    grad, grad_leaf = leaf_gap({k: float(judged["grad"][k].to(g.device).norm())
                                for k, g in ref["grad"].items()}, norms, norms)
    errs = {k: float((judged["grad"][k].to(g.device) - g).norm()) for k, g in ref["grad"].items()}
    grad_err, err_leaf = leaf_gap(errs, norms, norms, against_zero=True)
    judged_change, ref_change, moving, n_out = change_norms(judged, ref)
    change, change_leaf = leaf_gap(judged_change, ref_change, moving)
    stats = {}
    for kind, keys in (("codebook_gap", [RG.CODEBOOK + s for s in ("embed", "embed_avg",
                                                                   "cluster_size")]),
                       ("bn_gap", [k for k in ref["stats"] if ".bn." in k])):
        ref_n = {k: float(ref["stats"][k].norm()) for k in keys}
        err_n = {k: float((judged["stats"][k] - ref["stats"][k]).norm()) for k in keys}
        stats[kind] = leaf_gap(err_n, ref_n, keys, against_zero=True)
    assign = max(RG.code_gap(ze, e, c) for ze, e, c in
                 zip(judged["ze"], judged["embed"], judged["codes"]))
    ref_assign = max(RG.code_gap(ze, e, c) for ze, e, c in
                     zip(ref["ze"], ref["embed"], judged["codes"]))
    med = statistics.median(norms.values())
    values = {"loss_gap": loss_gap, "grad_gap": grad, "grad_err": grad_err, "change_gap": change,
              "codebook_gap": stats["codebook_gap"][0], "bn_gap": stats["bn_gap"][0],
              "assign_gap": assign, "ref_assign_gap": ref_assign,
              "grad_err_median": statistics.median(e / max(norms[k], med, 1e-30)
                                                   for k, e in errs.items())}
    readings.update(values)
    note = (f"worst leaf: gradient {grad_leaf}, its error {err_leaf}, change {change_leaf}, "
            f"codebook {stats['codebook_gap'][1]}, BatchNorm {stats['bn_gap'][1]}; {n_out} "
            f"elements ({len(ref['grad']) - len(moving)} whole leaves) left out of the change")
    return compared(values, limits), note
