"""Smoke run of the PyTorch port (``megatts2_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and exits non-zero:

1. device — requires CUDA; prints ``nvidia-smi``'s card name and power limit.
2. build — compiles the hand-written kernels from ``megatts2_tpu_torch/csrc``
   with nvcc (``build/torch_kernels/``) and loads them.
3. kernels — each kernel against its plain PyTorch version on the card, at
   the slices' shapes and beyond, in fp32 and bf16: kernel A at (64001,),
   (62377,), (8, 131000), (1, 513) and (3, 777), kernel B and its row
   statistics, kernel C (the attention backward) at the PLM's training
   shape (8, 1024, 16, 64) causal with mixed lengths that include 0, and
   at (2, 300, 4, 128) non-causal, and at the GAN step's MRTE shape (8, 64,
   2, 256) bf16 on its tensor-core path (two blocks split the output
   columns) and its SIMT path (checked with lengths that include 0 and 1
   and with every phone real, causal and not; timed with every phone real,
   as ``tools/profile_train.py``'s batch, beside its bound and SDPA's
   autograd backward); kernels B (with and without statistics)
   and C on their bf16 tensor-core path at its edges (Tq of 1, 32, 300 and
   1000 at head dim 64, (3, 77, 4, 128); at head dim 256 the MRTE's (8, 64,
   2, 256) and (1, 3, 2, 256), (2, 300, 4, 256) and one row against 70
   keys; at head dim 96 several key tiles and one row; k_lens holding 0 and
   1; causal and not), each line beside the SIMT path's error on the same inputs, and on
   views off TMA's 16-byte rule (copied and counted); kernel D (the copy
   pump) at (3, 16, 256) and the tool's (144, 256, 4096) for 1, 2 and 16
   passes, both outputs exact; kernel A's backward against autograd through
   the plain mel at the vocoder trainer's (8, 16384) and (16, 16384)
   (through the trainer's [:, :64] slice and without), (1, 513), (3, 777),
   (8, 131000) and its block plan's edges, each bit-equal on a second call
   and in the halo-only variant, one device kernel a call in a
   ``torch.profiler`` trace; then kernel and plain timed in turns
   (plain, kernel, kernel, plain) with CUDA events, each beside its bound
   (the larger of its bytes over 3.35 TB/s and its operations over the
   peak rate of their type) and one PyTorch library call that computes the
   same function; kernels A and B at the synthesis shapes, and B and C at
   the PLM's training shape, also split into device us (``torch.profiler``) and the host's issue us a call
   (``tools/kernel_times.py``'s cases, kernel A's backward at (8, 16384)
   and (16, 16384) too, also in its halo-only variant, beside the autograd
   backward of ``torch.stft`` + filterbank + log),
   with what kernel B's tensor-core
   wrapper adds to the host's cost; the attention kernels also beside their
   SIMT path, with the achieved TFLOP/s, the backward's two passes from a
   ``torch.profiler`` trace, and each tensor-core kernel's HGMMA count
   (``cuobjdump -sass``) and spills (the build's ptxas log).
4. reference — small fp32 slices on the card (kernels) against the same
   modules on the CPU (plain versions): greedy from BOS with Vocos, then an
   int8 PLM sampled at top-k 8 with injected noise after a prefilled
   prompt, with HiFi-GAN; durations, codes and n_frames equal, mel and
   waveform close.
5. slice — the full-width synthesis configuration in bf16 with seeded
   random weights, driven through ``Megatts.__call__`` (two ~4 s prompt
   wavs) and ``Megatts.synthesize_batch`` (B=8, Tp=64, Tm=512,
   max_frames=512), three times: the float PLM with Vocos, greedy; the int8
   PLM with Vocos, greedy; the int8 PLM with HiFi-GAN, sampled at top-k 8
   after a prosody prompt.  Before each, kernel A's and kernel B's launch
   counters are set to 0; after it, both must be > 0, and kernel B's
   tensor-core counter too (the MRTE; on the prompted run also the
   prefill).  Then warm wall
   times of the batch and of each cascade stage, and of the MRTE stage
   with kernel B's forward on its tensor-core and SIMT routes in turns.
6. bandwidth — ``megatts2_tpu_torch.tools.bw_ceiling`` at its full shapes:
   read_reduce, dots, kernel D at 16 and 64 passes and their fit, and the
   int8 PLM decode at B=8, T=64 against that ceiling.  Kernel D's counter
   is set to 0 before and must be > 0 after.
7. train reference — a small fp32 PLM (head dim 64, dropout 0) takes 3
   AdamW steps on the card (kernels B and C) and 3 on the CPU (plain
   versions) from the same seeded weights: losses, first gradients and
   final parameters close.
8. train — the full-width PLM in bf16 over fp32 master weights, driven by
   ``training.run_training`` for 6 steps on one synthetic batch of B=8,
   L=1024 in ``PLMBatchBuilder``'s format with mixed lengths.  The forward
   and backward launch counters and their tensor-core counters are set to
   0 just before and must be > 0 after; losses finite and the eval loss
   falling.  Then the warm step's
   ms, tokens/s and peak device memory; a few ADM steps at
   ``MegaADMConfig(tc_emb_dim=512)`` (head dim 96), B=8, T=64, with plain
   attention and with ``use_flash`` from the same seeded weights (B's and
   C's counters set to 0 before and read after each: none may launch on
   the plain route, both only on their tensor-core path with
   ``use_flash``; the first losses within ``ADM_FLASH_RTOL``; each route's
   warm step ms); and a greedy ``plm_infer``
   from the trained weights that the teacher-forced forward agrees with.
9. GAN reference — a small fp32 G + D (the MRTE at head dim 64 with
   ``use_flash``) takes 3 GAN steps on the card (kernels B and C) and 3 on
   the CPU (plain versions) from the same seeded weights; the CPU run's
   dropout masks, codebook samples and window starts are recorded
   (``nn.Draws``) and replayed on the card.  Metrics, first gradients,
   final parameters, codebook and running statistics close.
10. GAN train — ``configs/config_gan.yaml``'s G and D at full width and
   depth, bf16 over fp32 masters, one synthetic batch of
   ``tools/profile_train.py``'s geometry (B=8, Tp=64, 512 timbre and 512
   target frames, durations 1-8, every phone real), through ``training.run_training`` for 6
   steps and an eval, twice: as shipped (plain attention; no attention
   kernel may launch) and with ``MRTEConfig(use_flash=True)`` (kernel B's
   counters and kernel C's set to 0 before and read after: B and its
   tensor-core path must launch, and C on its tensor-core path 8 times a
   step).
   Losses finite, the codebook alive after the kmeans init, the eval
   ``loss_re`` finite; then each run's warm step ms, peak device memory
   and a ``torch.profiler`` breakdown of a warm step by kernel group.
11. vocoder reference — a small fp32 Vocos G and wave D take 3 vocoder
   GAN steps on the card (kernel A's forward and backward) and 3 on the
   CPU (plain) from the same seeded weights, then one small HiFi-GAN step
   the same way: metrics, first gradients and final parameters close; both
   of kernel A's counters must rise.
12. vocoder train — ``configs/config_vocoder.yaml`` as shipped (Vocos dim
   512, 8 layers; MPD periods 2-11 + 3 MSD scales; bf16 over fp32
   masters), written out as dataclass values, on ``tools/profile_train.py``'s
   batch (B=8, 64 frames: 16384 samples a row of ``RandomState(0).randn``),
   through ``training.run_training`` for 6 steps and an eval.  Kernel A's
   forward and backward counters are set to 0 just before and must be > 0
   after; losses finite.  Then the warm step ms, peak device memory and a
   ``torch.profiler`` breakdown of a warm step by kernel group (conv,
   matmul, FFT, kernel A, other) with the idle share.

Added for the serving slice (run after the kernels phase and the slice):

3b. kernels, serving — kernels B and C at the ADM's head dim, (8, 64, 8,
   96) (``tc_emb_dim=512``) and (2, 50, 3, 80) (zero-padded to 96), fp32
   and bf16 (bf16 on the tensor cores and on SIMT), causal and not, against
   their plain versions under ``ATOL_ATT`` and ``REL_BWD``; B and C above
   head dim 256 (257, 320, 512 and 640 at (3, 70, 2, Dh), fp32 and bf16,
   causal and not, on SIMT; at 320 also timed, fp32 and bf16, beside
   plain, SDPA's forward and autograd backward, and the bound); B and C at
   Dh 96 bf16 timed on each route
   (event ms, device and host us, plain, SDPA, bound) and kernel B causal
   at the engine's prefill (8, 2048, 16, 64) bf16, timed beside SDPA and
   the bound.
13. serve reference — small fp32 models: the port's checkpoints written in
   the reference layout and read back onto the card (every tensor equal);
   the continuous engine (2 slots, requests at Tp 40, 64 and 24, the third
   admitted mid-flight) and a stream, each equal to ``synthesize`` at its
   frame budget; the card equal to the CPU (lengths equal, waveforms
   within 1e-3).
14. serve — ``configs/config_plm.yaml`` and ``configs/config_adm.yaml`` as
   shipped and a copy of ``configs/config_gan.yaml`` with ``use_flash``
   under the MRTE, read by the port's YAML reader; seeded random weights
   written by the port's checkpoint writer as reference-layout ``.ckpt``
   files (sizes printed) and loaded through ``megatts_from_pretrained``;
   ``serve.main`` in process with ``serve.py``'s defaults (batch 8,
   buckets 256-2048, 16 frames a phone, 1024 frames, 8 slots, chunks of
   128, HiFi-GAN) over 16 requests of mixed lengths and two prompt dirs:
   batch, ``--continuous``, ``--continuous`` with a synthetic stage-2
   ``--prompt_ds`` at ``--prompt_tokens 2048``, and ``--http`` on
   127.0.0.1 (8 concurrent POSTs and a ``/healthz``).  Kernel A's and B's
   counters (B's tensor-core and causal ones too) are set to 0 before each
   mode and must be > 0 after it (B causal in the prompted mode: the
   prefill); every wav a whole number of frames.  Each mode's wall, utt/s,
   audio seconds, RTF and peak memory; kernel B timed at the largest MRTE
   launch signature of the four modes, beside plain, SDPA and the bound;
   then a stream's time to first chunk.

Added for the training pipeline (run last):

15. pipeline — dataset preparation and the training CLI as a user runs
   them, in process, on a synthetic corpus from the seed (4 speakers × 12
   utterances of 2.5-6.0 s, ``tools/synth_corpus.py``): ``prepare_ds``
   stage 0 and stage 1 (kernel A, one launch a mel batch); ``cli fit`` of
   the gan stage on ``configs/config_gan.yaml`` with ``use_flash`` under
   the MRTE (4 steps: one validation, one artifact, one checkpoint; B and
   C must launch), then its resume to 6 steps from the checkpoint
   directory; stage 2 from that checkpoint (kernel B in fp32); ``cli fit``
   of plm (B and C), adm (14 steps, ``--trace_dir``: the trace must be
   written) and vocoder (A forward and backward), each the shipped config
   with only max_steps, val_check_interval, log_every_n_steps and ds_path
   overridden; then a short fit of the ADM on a copy with ``use_flash`` and
   ``train_dtype: bfloat16`` (4 steps: B and C only on their tensor-core
   path).  Every counter is set to 0 before each step of the
   pipeline and read after it; each step's line gives its wall, steps,
   median step ms and loader wait (``run_training``'s ``loop/`` row), peak
   memory, checkpoint MiB and launches, beside the card's name and power
   limit.  Losses and latents finite, shapes and counts as expected.

Added for the measurement tools (run after the pipeline):

16. tools — the functions of ``megatts2_tpu_torch/tools``' measurement
   tools on the card, every counter set to 0 before each and read after:
   ``bench_train``'s four stages at full width (B and C only on the tensor
   cores in the PLM step, A and its backward in the vocoder step; the GAN's
   MFU in (0, 1)); ``profile_train gan``, top 10, with the idle share of
   the traced window; ``http_bench`` at full width, 8 requests from 4
   clients at 8 rps offered (A on the prompt); ``bench_input_pipeline``
   on a 4 x 12 corpus (stage 0; stage 1 at 1 and 2 workers, A once a mel
   batch; 10 loader batches, native ring and numpy; 4 loader-fed GAN
   steps); ``long_train`` on that corpus (SIGKILLed once its log reaches
   step 6, resumed to step 10 from its checkpoint: two launches) and
   ``long_run_summary`` of its log (one resume); ``bench_input_pipeline``'s stage 2 from that
   run's checkpoint, then 2 loader-fed PLM steps (B and C on the tensor
   cores) and 2 ADM steps.  Every record parses, every number in it is
   finite and every rate positive; every line names the card and its
   power limit.

Added for the quality tools (run after the tools):

17. quality — the six quality tools of ``megatts2_tpu_torch/tools``
   through their ``main(argv)`` on the card at full width (the shipped
   ``configs/config_{gan,plm,adm,vocoder}.yaml``; only the steps are few),
   every counter set to 0 before each and read after, each tool's stdout
   printed under ``quality <tool>:`` with its wall and launches:
   ``train_curve --stages gan,vocoder,plm,adm`` on its 2 x 8 corpus (4
   steps a stage, one validation and one checkpoint each; stage 2 from the
   GAN's checkpoint; A and its backward in the vocoder fit, B and C on the
   tensor cores in the PLM fit), ``e2e_quality`` on that stack, float and
   ``--quant_int8`` (A for the mels, B on the tensor cores in the prompt
   prefill), ``quality_table`` of the two records, ``int8_margins
   --n_batches 2`` (B on the tensor cores), ``at_scale_stack`` on a 4 x 12
   corpus with ``--g_ema_decay 0.999`` (A in stage 1; its fits and stage 2
   are subprocesses, each launched once with rc 0), then its stage 2's
   stored latents against the best GAN checkpoint's ``g_ema`` weights and
   its raw weights on the same batch (the EMA's within ``ATOL_EMA_LATENT``
   and ten times closer than the raw ones), and ``heldout_eval --n_speakers 2 --n_seeds 1`` on
   that stack (disjoint bands at 75 and 92 Hz, tolerance 0.08).  Every
   record has the JAX tool's keys and names the card; its numbers are
   finite, but for the MCD of a tail of 8 frames or fewer (NaN, as in
   JAX).  As in "pipeline", every launch signature of A, A's backward, B
   and C in this process is recorded and then held against the plain
   version ("quality shapes ..." lines, worst error into the ``kernels``
   line, whose launches gain the phase's under ``quality <tool>``), and
   ``train_curve``'s stage 1 features against the plain mel.  The phase's
   directory (checkpoints of up to 2.3 GiB) is removed at its end.

Added for data and tensor parallelism (run last):

18. parallel — data and tensor parallelism (``megatts2_tpu_torch/parallel/``)
   on the one card, on "pipeline"'s dataset; correctness runs, not
   scaling: (a) ``torchrun --standalone --nproc_per_node 1`` (one NCCL
   rank) fits the full-width PLM (``config_plm.yaml``) 3 steps with
   ``--zero_opt`` and a checkpoint, then a plain process resumes it a
   step; its losses against a plain process doing the same
   (``PAR_RTOL_RUN``); (b) two ranks spawned over gloo
   (``maybe_initialize_distributed(backend="gloo")``: NCCL refuses two
   ranks on one device) take 2 steps of the full-width PLM in bf16 at (2,
   1) with ZeRO-1 and at (1, 2), and of the full-width GAN in fp32 (its
   first step's kmeans) at (2, 1), each against the one-process steps on
   the same global batch: metrics (``PAR_RTOL_BF16``, ``PAR_ATOL_AC10``,
   ``PAR_RTOL_FP32``), the weights' largest difference (AdamW's
   ``PAR_ADAM`` lr bound) and mean, the codebook's and BatchNorms' buffers,
   B and C launched on every PLM rank; (c) four ranks fit a
   ``PAR_DEPTH``-layer PLM through ``cli fit --n_model 2``, a (2, 2) mesh,
   against one process (the batch plans checked equal first).  Each run's
   walls and step ms are printed with the card; the ranks' launches join
   the ``kernels`` line under ``parallel ...``.

Each phase's seconds are printed.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX and nothing of
the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from scipy.io import wavfile

ATOL_ATT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # fp32 sum order; bf16 output rounding
ATOL_MEL = 1e-3  # DFT vs FFT sum order over 1024 terms, magnified by log near the 1e-5 clamp
ATOL_M, RTOL_L = 1e-4, 1e-5  # kernel B's row max and row sum: fp32 sums in another order
# kernel C, as a fraction of each gradient's largest magnitude: fp32 sums in
# another order; in bf16, P and ds are rounded before their products, and a
# rounding that flips moves a term by one bf16 ulp (2^-8)
REL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# kernel A's backward, as a fraction of the gradient's largest magnitude:
# the FFTs and sums in other orders, log's 1/mel amplifying where a mel is small
REL_MEL_BWD = 1e-4
# kernel A's backward at its block plan's edges (ops/mel.py::bwd_plan): rows
# of 5 frames (shorter than a block), 7 and 28 (the block before the last
# gives up a frame), 24 (one whole cluster), 25 (the last block a cluster's
# first), 66
MEL_BWD_EDGES = ((2, 1024), (2, 1025), (2, 1279), (2, 1536), (3, 5888), (2, 6144), (2, 6912),
                 (2, 16640))
SEED = 0
PLM_B, PLM_L = 8, 1024  # tools/bench_train.py's PLM geometry
VOC_B = 8  # tools/profile_train.py's vocoder geometry: B=8, segment_frames 64
GAN_B = 8  # tools/profile_train.py's GAN geometry: B=8, Tp=64, 512 timbre + 512 target frames
PLM_LENS = [1024, 1024, 960, 800, 700, 512, 384, 100]  # mixed, as PLMBatchBuilder pads
GAN_TP = 64  # tools/profile_train.py: tokens_lens = Tp for every row
MRTE_EDGE_LENS = [64, 0, 33, 63, 1, 17, 64, 48]  # kernel C's check only: lengths 0, 1, partial tiles
# the ADM's first bf16 step with use_flash against plain attention, relative:
# the plain route rounds P to bf16 for P V, kernel B carries it to ~16 bits
# (hi + lo), so each layer's bf16 attention output may differ by a bf16 ulp
# (2^-8) and the loss by a few of them over 8 layers
ADM_FLASH_RTOL = 2e-2
PUMP_SHAPE, PUMP_STEPS = (144, 256, 4096), 16  # tools/bw_ceiling.py's W; the fit's first point
TEMPERATURE = 0.8  # the sampled slices' PLM temperature, at top-k 8


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls, warm."""
    from megatts2_tpu_torch.tools.bw_ceiling import time_ms

    return time_ms(fn, torch.device("cuda"), iters)


def bound(n_bytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(least ms the card could take, what sets it): the bytes over the memory
    rate or the operations over the peak rate of their type (``kind`` bf16,
    fp32 or int8), at the H100 SXM's peaks of ``utils/flops.py``."""
    from megatts2_tpu_torch.utils.flops import PEAK_BYTES_PER_S, PEAK_FLOPS

    peak = PEAK_FLOPS["f32" if kind == "fp32" else kind]
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_pairs(lens, Tq: int, H: int, causal: bool) -> int:
    """(query, key) pairs the length and causal masks keep, over all heads."""
    q = np.arange(Tq)[None, :]
    L = np.asarray(lens)[:, None]
    keys = np.minimum(L, q + 1) if causal else np.broadcast_to(L, (len(lens), Tq))
    return int(keys.sum()) * H


def sdpa_mask(lens: torch.Tensor, T: int, causal: bool) -> torch.Tensor:
    """Boolean (B, 1, T, T) mask for ``scaled_dot_product_attention``."""
    kpos = torch.arange(T, device=lens.device)
    mask = kpos[None, None, None, :] < lens[:, None, None, None]
    if causal:
        mask = mask & (kpos[None, None, None, :] <= kpos[None, None, :, None])
    return mask


def in_turns(plain, kernel) -> tuple[float, float]:
    """(kernel ms, plain ms), each the mean of two runs taken plain, kernel,
    kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        raise SystemExit(2)
    from megatts2_tpu_torch.tools.bw_ceiling import card_name

    smi = card_name(torch.device("cuda"))
    print(smi)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain references in full fp32
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from megatts2_tpu_torch.csrc.build import load_library, library_path

    t0 = time.perf_counter()
    load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {library_path()}")

# the tensor-core path's edges (bf16): (B, Tq, H, Dh, Tk), Tq of 1, 32, 300
# and 1000 inside 64-row tiles at Dh 64, Dh 128, Dh 256 (output columns
# split over two blocks): the MRTE's two shapes, several key tiles, one row;
# Dh 96 (128-wide tiles, columns 96-127 zero): several key tiles, one row
TC_EDGES = ((4, 1, 2, 64, 70), (4, 32, 2, 64, 32), (4, 300, 2, 64, 300), (4, 1000, 2, 64, 1000),
            (3, 77, 4, 128, 77), (8, 64, 2, 256, 64), (1, 3, 2, 256, 3), (2, 300, 4, 256, 300),
            (4, 1, 2, 256, 70), (3, 150, 2, 96, 150), (4, 1, 2, 96, 70))


def _rel_errs(got, ref) -> list[tuple[float, float]]:
    """(max abs error, largest reference magnitude) of each gradient."""
    return [((a.float() - b.float()).abs().max().item(), b.float().abs().max().item())
            for a, b in zip(got, ref)]


def tc_edges(dev: torch.device, gen: torch.Generator, err: dict) -> None:
    """Kernels B (with and without statistics) and C on the tensor-core path
    at its edges, k_lens holding 0 and 1, causal and not, against the plain
    versions; each line also gives the SIMT path's error on the same inputs
    (the first kernels, kept for fp32 and head dims above 256).  Then views
    off the TMA rule: copied, counted, right."""
    from megatts2_tpu_torch.ops import attention as att

    bf = torch.bfloat16
    for B, Tq, H, Dh, Tk in TC_EDGES:
        q, g = (torch.randn(B, Tq, H, Dh, generator=gen).to(dev, bf) for _ in range(2))
        k, v = (torch.randn(B, Tk, H, Dh, generator=gen).to(dev, bf) for _ in range(2))
        lens = torch.tensor(([Tk, 0, 1, Tk // 3 + 1] * B)[:B], dtype=torch.int32, device=dev)
        for causal in (False, True):
            ref, pm, pl = att.flash_attention_plain(q, k, v, lens, causal, return_stats=True)
            line = []
            for simt in (False, True):
                out = att.flash_attention_cuda(q, k, v, lens, causal, simt=simt)
                o2, m, l = att.flash_attention_cuda(q, k, v, lens, causal, return_stats=True, simt=simt)
                e = max((x.float() - ref.float()).abs().max().item() for x in (out, o2))
                em, el = (m - pm).abs().max().item(), ((l - pl).abs() / pl).max().item()
                grads = att.flash_attention_bwd_cuda(q, k, v, lens, causal, g, m, l, simt=simt)
                ge = _rel_errs(grads, att.flash_attention_bwd_plain(q, k, v, lens, causal, g, m, l))
                line.append(f"{'simt' if simt else 'tensor cores'}: fwd {e:.3g}, m {em:.3g}, "
                            f"l rel {el:.3g}, " + ", ".join(f"{n} {a:.3g}/{t:.3g}" for n, (a, t)
                                                           in zip(("dq", "dk", "dv"), ge)))
                check(all(bool(torch.isfinite(x).all()) for x in (out, o2, *grads)),
                      f"tc edge {(B, Tq, H, Dh, Tk)}: non-finite")
                if simt:
                    continue
                check(e <= ATOL_ATT[bf] and em <= ATOL_M and el <= RTOL_L,
                      f"tc edge {(B, Tq, H, Dh, Tk)} causal={causal}: fwd {e}, m {em}, l {el}")
                check(all(a <= REL_BWD[bf] * t for a, t in ge),
                      f"tc edge {(B, Tq, H, Dh, Tk)} causal={causal}: bwd {ge}")
                err["flash"] = max(err["flash"], e)
                err["flash_bwd"] = max(err["flash_bwd"], *(a for a, _ in ge))
            print(f"kernel flash tc edge (B,Tq,H,Dh,Tk)={(B, Tq, H, Dh, Tk)} bf16 lens {lens.tolist()} "
                  f"causal={causal}: max_abs_err {'; '.join(line)} (atol {ATOL_ATT[bf]}, "
                  f"bwd rel {REL_BWD[bf]})")

    # views TMA cannot read: a base 2 bytes past a 16-byte boundary
    def misaligned(x):
        buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
        view = buf.as_strided(x.shape, x.stride(), storage_offset=1)
        view.copy_(x)
        return view

    q, k, v, g = (torch.randn(2, 70, 2, 64, generator=gen).to(dev, bf) for _ in range(4))
    lens = torch.tensor([70, 0], dtype=torch.int32, device=dev)
    fc, bc = att.flash_attention_cuda.layout_copies, att.flash_attention_bwd_cuda.layout_copies
    out, m, l = att.flash_attention_cuda(misaligned(q), k, v, lens, True, return_stats=True)
    grads = att.flash_attention_bwd_cuda(q, misaligned(k), v, lens, True, misaligned(g), m, l)
    copies = (att.flash_attention_cuda.layout_copies - fc, att.flash_attention_bwd_cuda.layout_copies - bc)
    e = (out.float() - att.flash_attention_plain(q, k, v, lens, True).float()).abs().max().item()
    ge = _rel_errs(grads, att.flash_attention_bwd_plain(q, k, v, lens, True, g, m, l))
    check(copies[0] > 0 and copies[1] > 0, f"misaligned views were not copied: {copies}")
    check(e <= ATOL_ATT[bf] and all(a <= REL_BWD[bf] * t for a, t in ge), f"misaligned: {e}, {ge}")
    print(f"kernel flash tc misaligned views (base + 2 bytes): layout copies fwd {copies[0]}, bwd "
          f"{copies[1]}; max_abs_err fwd {e:.3g}, bwd {', '.join(f'{a:.3g}/{t:.3g}' for a, t in ge)}")
    torch.cuda.synchronize()


TC_KERNEL = re.compile(r"\d(flash_\w+?_tc_kernel)ILi(\d+)")  # in a mangled name


def sass_hgmma() -> dict:
    """HGMMA instructions in each tensor-core kernel of the built library,
    from ``cuobjdump -sass``."""
    from megatts2_tpu_torch.csrc import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build.library_path())], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = TC_KERNEL.search(line)
            name = f"{m.group(1)}<{m.group(2)}>" if m else None
            if name:
                counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


# a SIMT attention kernel's mangled name: <T, DH, NC> (<T, DH> before the chunk loop)
SIMT_KERNEL = re.compile(r"\d(flash_(?:fwd|bwd_dq|bwd_dkdv)_kernel)I(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?")


def ptxas_report(log: Path = None) -> tuple:
    """ptxas's register and spill report of each tensor-core kernel and of
    each SIMT attention kernel instance (<dtype, DH, NC>), from a build's
    log (by default the built library's)."""
    from megatts2_tpu_torch.csrc import build

    lines = (log or build.library_path().parent / "build.log").read_text().splitlines()
    tc, simt = {}, {}
    for i, line in enumerate(lines):
        if "Function properties for" not in line:
            continue
        rep = f"{lines[i + 1].strip()}; {lines[i + 2].strip()}"
        if m := TC_KERNEL.search(line):
            tc[f"{m.group(1)}<{m.group(2)}>"] = rep
        elif m := SIMT_KERNEL.search(line):
            dtype = "fp32" if m.group(2) == "f" else "bf16"
            nc = "" if m.group(4) is None else f",{m.group(4)}"
            simt[f"{m.group(1)}<{dtype},{m.group(3)}{nc}>"] = rep
    return tc, simt


def ptxas_line(kernel: str) -> str:
    """ptxas's register, shared memory and spill report of one kernel, from
    the built library's log."""
    from megatts2_tpu_torch.csrc import build

    lines = (build.library_path().parent / "build.log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            rep = f"{lines[i + 1].strip()}; {lines[i + 2].strip()}"
            used = next((ln.strip() for ln in lines[i + 3:i + 6] if "Used" in ln), "")
            return f"{rep}; {used}"
    return "not in the build log"


def phase_kernels(dev: torch.device, card: str) -> dict:
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.ops import mel, pump
    from megatts2_tpu_torch.tools import kernel_times

    gen = torch.Generator().manual_seed(SEED)
    err = {"flash": 0.0, "mel": 0.0}
    # the MRTE's shapes in synthesize_batch and __call__, stage 2's and the
    # GAN fit's shorter phone buckets, then a long one
    for shape in ((8, 64, 2, 256), (1, 3, 2, 256), (8, 32, 2, 256), (8, 48, 2, 256),
                  (2, 1000, 16, 64)):
        B, T = shape[0], shape[1]
        lens = torch.tensor(([T, 0, T // 3 + 1, T - 5] * B)[:B], dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(3))
            for causal in (False, True):
                got = att.flash_attention_cuda(q, k, v, lens, causal)
                ref = att.flash_attention_plain(q, k, v, lens, causal)
                e = (got.float() - ref.float()).abs().max().item()
                check(bool(torch.isfinite(got).all()), f"flash {shape} {dtype}: non-finite output")
                check(e <= ATOL_ATT[dtype], f"flash {shape} {dtype} causal={causal}: err {e}")
                err["flash"] = max(err["flash"], e)
                print(f"kernel flash_attention {shape} {str(dtype)[6:]} causal={causal}: "
                      f"max_abs_err {e:.3g} (atol {ATOL_ATT[dtype]})")
    # __call__'s prompts, the batch, the shortest signal (3 frames), ragged
    # rows, stage 1's padded batches (a partial one too), the vocoder config's
    # batch of 16 crops
    for shape in ((64001,), (62377,), (8, 131000), (1, 513), (3, 777), (8, 65536), (8, 98304),
                  (5, 32768), (16, 16384)):
        y = (torch.randn(shape, generator=gen) * 0.1).to(dev)
        got, ref = mel.mel_spectrogram_cuda(y), mel.mel_spectrogram_plain(y)
        e = (got - ref).abs().max().item()
        check(got.shape == ref.shape and e <= ATOL_MEL, f"mel {shape}: err {e}")
        err["mel"] = max(err["mel"], e)
        print(f"kernel mel_spectrogram {shape}: max_abs_err {e:.3g} (atol {ATOL_MEL})")
    # kernel A's backward: the vocoder trainer's crops (B 8 and the config's
    # 16), through its [:, :64] slice (autograd, the Function on the card) and
    # whole; the shortest signal; ragged rows; the batched front end; the
    # block plan's edges (MEL_BWD_EDGES).  Each also called directly: a second
    # call and the halo-only variant (clusters of one block) give the same
    # bits, and a trace of the direct calls shows one kernel a call
    err["mel_bwd"] = 0.0
    direct = []
    for shape, keep in (((8, 16384), 64), ((8, 16384), None), ((16, 16384), 64),
                        ((16, 16384), None), ((1, 513), None), ((3, 777), None),
                        ((8, 131000), None), *((s, None) for s in MEL_BWD_EDGES)):
        y = (torch.randn(shape, generator=gen) * 0.1).to(dev)
        g_mel = torch.randn(shape[0], mel.num_frames(shape[-1]), 80, generator=gen).to(dev)
        if keep is None:
            got = mel.mel_spectrogram_bwd_cuda(y, g_mel)
        else:
            g_mel[:, keep:] = 0  # what the slice's backward hands on
            yr = y.clone().requires_grad_()
            got = torch.autograd.grad(mel.mel_spectrogram(yr)[:, :keep], yr, g_mel[:, :keep])[0]
        ref = mel.mel_spectrogram_bwd_plain(y, g_mel)
        e, top = (got - ref).abs().max().item(), ref.abs().max().item()
        check(bool(torch.isfinite(got).all()) and e <= REL_MEL_BWD * top,
              f"mel bwd {shape} keep {keep}: err {e}, max {top}")
        same = (torch.equal(mel.mel_spectrogram_bwd_cuda(y, g_mel), got)
                and torch.equal(mel.mel_spectrogram_bwd_cuda(y, g_mel, cluster=1), got))
        check(same, f"mel bwd {shape} keep {keep}: a second call or the halo-only variant differs")
        direct.append((y, g_mel))
        err["mel_bwd"] = max(err["mel_bwd"], e)
        print(f"kernel mel_spectrogram_bwd {shape}{f' [:, :{keep}]' if keep else ''}: max_abs_err "
              f"{e:.3g} of max {top:.3g} (rel {REL_MEL_BWD}); bit-equal again and at clusters of 1")
    names = kernel_times.device_kernels(lambda: [mel.mel_spectrogram_bwd_cuda(*a) for a in direct])
    check(len(names) == len(direct) and all("mel_bwd" in name for name in names),
          f"mel bwd: {len(direct)} calls launched {names}")
    print(f"trace mel_spectrogram_bwd: {len(direct)} calls, {len(names)} device kernels "
          f"({sorted(set(names))}); ptxas {ptxas_line('mel_bwd_kernel')} [{card}]")
    torch.cuda.synchronize()

    # timing at the slice's shapes (tools/kernel_times.py's inputs): MRTE
    # self-attention (8, 64, 2, 256) bf16 with mixed lengths; the batched
    # prompt front-end (8, 131000) fp32
    x = kernel_times.inputs(dev, SEED)
    q, k, v, lens = x["mrte"]
    y = x["mel"]
    t_att = in_turns(lambda: att.flash_attention_plain(q, k, v, lens),
                     lambda: att.flash_attention_cuda(q, k, v, lens))
    t_mel = in_turns(lambda: mel.mel_spectrogram_plain(y), lambda: mel.mel_spectrogram_cuda(y))
    simt = {"flash_mrte": cuda_ms(lambda: att.flash_attention_cuda(q, k, v, lens, simt=True))}
    # where a call's time goes: event ms, the kernel's device us (torch.profiler)
    # and the host's issue us, each path and kernel
    split = kernel_times.time_cases(kernel_times.cases(x))
    window, fb = mel._tables(1024, 1024, 80, dev)

    def mel_library(sig):  # torch.stft + filterbank matmul + log clamp: a composite of library calls
        spec = torch.stft(sig, 1024, 256, 1024, window=window, center=True, pad_mode="reflect",
                          return_complex=True).abs()
        return torch.log(torch.clamp(spec.transpose(-1, -2) @ fb, min=1e-5))

    frames = mel.num_frames(y.shape[-1])
    lib = {"mel": cuda_ms(lambda: mel_library(y)), "flash_mrte": cuda_ms(
        lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                               v.transpose(1, 2), attn_mask=sdpa_mask(lens, 64, False)))}
    # per frame: a real 1024-point FFT (5/2 N log2 N), |X| (3 a bin), the
    # filterbank (2 a nonzero weight: the function needs no others), the log
    nnz = int((mel.mel_filterbank() != 0).sum())
    mel_ops = y.shape[0] * frames * (2.5 * 1024 * 10 + 3 * 513 + 2 * nnz + 80)
    dense_ops = y.shape[0] * frames * (2.5 * 1024 * 10 + 3 * 513 + 2 * 513 * 80 + 80)
    bounds = {"mel": bound(y.numel() * 4 + y.shape[0] * frames * 80 * 4, mel_ops, "fp32"),
              "flash_mrte": bound(4 * q.numel() * 2,
                                  4 * 256 * attn_pairs(lens.cpu().numpy(), 64, 2, False), "bf16")}
    print(f"bound mel_spectrogram (8,131000): {mel_ops / 1e9:.4f} GFLOP with the filterbank's {nnz} "
          f"nonzeros ({bounds['mel'][0]:.4f} ms by {bounds['mel'][1]}); counted dense (513 x 80) "
          f"{dense_ops / 1e9:.4f} GFLOP ({bound(0, dense_ops, 'fp32')[0]:.4f} ms)")
    for name, (tk, tp), key in (("flash_attention (8,64,2,256) bf16", t_att, "flash_mrte"),
                                ("mel_spectrogram (8,131000) fp32", t_mel, "mel")):
        extra = f", simt {simt[key]:.4f} ms" if key in simt else ""
        print(f"time {name}: kernel {tk:.4f} ms{extra}, plain {tp:.4f} ms, library {lib[key]:.4f} ms, "
              f"bound {bounds[key][0]:.4f} ms by {bounds[key][1]} [{card}]")
    for name, key, b_key in (("flash_attention (8,64,2,256) bf16 tensor cores", "flash_mrte", "flash_mrte"),
                             ("flash_attention (8,64,2,256) bf16 simt", "flash_mrte_simt", "flash_mrte"),
                             ("mel_spectrogram (8,131000) fp32", "mel", "mel"),
                             ("mel_spectrogram (64001,) fp32", "mel_prompt", None)):
        sp = split[key]
        dev_us = sp["device_us"]
        side = "not measured" if dev_us is None else (
            "host-bound" if sp["host_us"] > dev_us else "device-bound")
        ref = (f"; bound {bounds[b_key][0]:.4f} ms, library {lib[b_key]:.4f} ms" if b_key else "")
        print(f"time split {name}: event {sp['event_ms']:.4f} ms, device "
              f"{'not measured' if dev_us is None else f'{dev_us:.2f} us'} (torch.profiler), host "
              f"issue {sp['host_us']:.2f} us a call: {side}{ref} [{card}]")
    hs = {key: sp["host_us"] for key, sp in split.items()}
    print(f"host split flash_attention (8,64,2,256) bf16, medians of interleaved rounds: tensor cores "
          f"{hs['flash_mrte']:.2f} us a call, simt {hs['flash_mrte_simt']:.2f} "
          f"({hs['flash_mrte'] - hs['flash_mrte_simt']:+.2f}: the tensor-core launcher's three "
          f"tensor-map encodes and _launch_tma); the Python check of TMA's rule on q, k, v {hs['tma_check']:.2f} us, "
          f"off the path (made only after the launcher refuses a view) [{card}]")

    # kernel B's row statistics and kernel C against the plain backward
    err["flash_bwd"] = 0.0
    for shape, causal in (((8, 1024, 16, 64), True), ((2, 300, 4, 128), False)):
        B, T = shape[0], shape[1]
        lens = torch.tensor([T, 0, T // 3 + 1, T - 5, 77, T, 1, 512][:B], dtype=torch.int32,
                            device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(4))
            _, m, l = att.flash_attention_cuda(q, k, v, lens, causal, return_stats=True)
            _, pm, pl = att.flash_attention_plain(q, k, v, lens, causal, return_stats=True)
            em, el = (m - pm).abs().max().item(), ((l - pl).abs() / pl).max().item()
            check(em <= ATOL_M and el <= RTOL_L, f"flash stats {shape} {dtype}: m {em}, l {el}")
            got = att.flash_attention_bwd_cuda(q, k, v, lens, causal, g, m, l)
            ref = att.flash_attention_bwd_plain(q, k, v, lens, causal, g, m, l)
            errs = []
            for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                e, top = (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()
                check(bool(torch.isfinite(a).all()), f"flash bwd {name} {shape} {dtype}: non-finite")
                check(e <= REL_BWD[dtype] * top, f"flash bwd {name} {shape} {dtype}: err {e}, max {top}")
                err["flash_bwd"] = max(err["flash_bwd"], e)
                errs.append(f"{name} {e:.3g}/{top:.3g}")
            print(f"kernel flash_attention_bwd {shape} {str(dtype)[6:]} causal={causal}: "
                  f"max_abs_err/max {', '.join(errs)} (rel {REL_BWD[dtype]}); "
                  f"stats m {em:.3g} (atol {ATOL_M}), l rel {el:.3g} (rtol {RTOL_L})")
    torch.cuda.synchronize()
    # kernel C at the MRTE's shape, where the GAN step with use_flash runs
    # it: (8, 64, 2, 256) bf16 on its tensor-core path (two blocks split the
    # output columns) and on its SIMT path; checked with edge lengths and
    # with every phone real, causal and not, then timed with every phone real
    q, k, v, g = (torch.randn(8, 64, 2, 256, generator=gen).to(dev, torch.bfloat16) for _ in range(4))
    for lens_list in (MRTE_EDGE_LENS, [GAN_TP] * 8):
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        for causal in (False, True):
            _, m, l = att.flash_attention_cuda(q, k, v, lens, causal, return_stats=True)
            ref = att.flash_attention_bwd_plain(q, k, v, lens, causal, g, m, l)
            line = []
            for use_simt in (False, True):
                tc0 = att.flash_attention_bwd_cuda.tc_launches
                got = att.flash_attention_bwd_cuda(q, k, v, lens, causal, g, m, l, simt=use_simt)
                ge = _rel_errs(got, ref)
                check(att.flash_attention_bwd_cuda.tc_launches == tc0 + (not use_simt),
                      f"kernel C at Dh 256 simt={use_simt}: tensor-core launches {tc0} -> "
                      f"{att.flash_attention_bwd_cuda.tc_launches}")
                check(all(bool(torch.isfinite(x).all()) for x in got)
                      and all(a <= REL_BWD[torch.bfloat16] * t for a, t in ge),
                      f"flash bwd MRTE {lens_list} causal={causal} simt={use_simt}: {ge}")
                err["flash_bwd"] = max(err["flash_bwd"], *(a for a, _ in ge))
                line.append(f"{'simt' if use_simt else 'tensor cores'} " + ", ".join(
                    f"{n} {a:.3g}/{t:.3g}" for n, (a, t) in zip(("dq", "dk", "dv"), ge)))
            print(f"kernel flash_attention_bwd (8, 64, 2, 256) bf16, lens {lens_list} causal={causal}: "
                  f"max_abs_err/max {'; '.join(line)} (rel {REL_BWD[torch.bfloat16]})")
    _, m, l = att.flash_attention_cuda(q, k, v, lens, return_stats=True)  # every phone real
    t_bwd_mrte = in_turns(lambda: att.flash_attention_bwd_plain(q, k, v, lens, False, g, m, l),
                          lambda: att.flash_attention_bwd_cuda(q, k, v, lens, False, g, m, l))
    simt["flash_bwd_mrte"] = cuda_ms(lambda: att.flash_attention_bwd_cuda(q, k, v, lens, False, g, m, l,
                                                                          simt=True))
    split_bwd_mrte = kernel_times.time_cases({
        "flash_bwd_mrte": (lambda: att.flash_attention_bwd_cuda(q, k, v, lens, False, g, m, l), "flash_"),
        "flash_bwd_mrte_simt": (lambda: att.flash_attention_bwd_cuda(q, k, v, lens, False, g, m, l,
                                                                     simt=True), "flash_")})
    mask = sdpa_mask(lens, 64, False)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    gt = g.transpose(1, 2)
    lib_bwd_mrte = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
    del out, qt, kt, vt
    pairs = attn_pairs([GAN_TP] * 8, 64, 2, False)
    bound_bwd_mrte = bound(7 * q.numel() * 2 + 2 * m.numel() * 4, 10 * 256 * pairs, "bf16")
    print(f"time flash_attention_bwd (8,64,2,256) bf16 (the GAN step's MRTE, every phone real): tensor "
          f"cores {t_bwd_mrte[0]:.4f} ms, simt {simt['flash_bwd_mrte']:.4f} ms, plain {t_bwd_mrte[1]:.4f} "
          f"ms, library (SDPA autograd backward) {lib_bwd_mrte:.4f} ms, bound {bound_bwd_mrte[0]:.5f} ms "
          f"by {bound_bwd_mrte[1]} ({10 * 256 * pairs / 1e9:.4f} GFLOP) [{card}]")
    for key, route in (("flash_bwd_mrte", "tensor cores"), ("flash_bwd_mrte_simt", "simt")):
        sp = split_bwd_mrte[key]
        dev_us = sp["device_us"]
        print(f"time split flash_attention_bwd (8,64,2,256) bf16 {route}: event {sp['event_ms']:.4f} ms, "
              f"device {'not measured' if dev_us is None else f'{dev_us:.2f} us'} (torch.profiler, both "
              f"passes), host issue {sp['host_us']:.2f} us a call; bound {bound_bwd_mrte[0]:.5f} ms, "
              f"library {lib_bwd_mrte:.4f} ms [{card}]")
    tc_edges(dev, gen, err)

    # timing at the PLM's training shape: (8, 1024, 16, 64) bf16 causal, mixed lengths
    q, k, v, g = (torch.randn(8, 1024, 16, 64, generator=gen).to(dev, torch.bfloat16)
                  for _ in range(4))
    lens = torch.tensor(PLM_LENS, dtype=torch.int32, device=dev)
    _, m, l = att.flash_attention_cuda(q, k, v, lens, True, return_stats=True)
    t_fwd = in_turns(lambda: att.flash_attention_plain(q, k, v, lens, True, return_stats=True),
                     lambda: att.flash_attention_cuda(q, k, v, lens, True, return_stats=True))
    t_bwd = in_turns(lambda: att.flash_attention_bwd_plain(q, k, v, lens, True, g, m, l),
                     lambda: att.flash_attention_bwd_cuda(q, k, v, lens, True, g, m, l))
    # the SIMT kernels (the first version) on the same inputs, for the before/after lines
    simt.update({"flash_plm": cuda_ms(lambda: att.flash_attention_cuda(q, k, v, lens, True,
                                                                       return_stats=True, simt=True)),
                 "flash_bwd": cuda_ms(lambda: att.flash_attention_bwd_cuda(q, k, v, lens, True, g, m,
                                                                           l, simt=True))})
    passes = {}
    for name, t in kernel_times.trace_kernels(lambda: att.flash_attention_bwd_cuda(q, k, v, lens, True,
                                                                                   g, m, l),
                                 5).items():
        hit = re.search(r"(flash_\w+?_kernel)<(\d+)", name)
        if hit:
            passes[f"{hit.group(1)}<{hit.group(2)}>"] = t
    mask = sdpa_mask(lens, 1024, True)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    gt = g.transpose(1, 2)
    lib["flash_plm"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    lib["flash_bwd"] = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
    del out, qt, kt, vt
    pairs = attn_pairs(PLM_LENS, 1024, 16, True)
    stats = 2 * m.numel() * 4
    bounds["flash_plm"] = bound(4 * q.numel() * 2 + stats, 4 * 64 * pairs, "bf16")
    # recompute Q K^T, then dP = g V^T, dV = P^T g, dQ = dS K, dK = dS^T Q
    bounds["flash_bwd"] = bound(7 * q.numel() * 2 + stats, 10 * 64 * pairs, "bf16")
    flops = {"flash_plm": 4 * 64 * pairs, "flash_bwd": 10 * 64 * pairs}
    # the PLM prompt prefill: causal over P prompt codes, every row of length P
    times = {}
    for P in (32, 256):
        q, k, v = (torch.randn(8, P, 16, 64, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
        plen = torch.full((8,), P, dtype=torch.int32, device=dev)
        got, ref = att.flash_attention_cuda(q, k, v, plen, True), att.flash_attention_plain(q, k, v, plen, True)
        e = (got.float() - ref.float()).abs().max().item()
        check(e <= ATOL_ATT[torch.bfloat16], f"flash prefill P={P}: err {e}")
        err["flash"] = max(err["flash"], e)
        tk, tp = in_turns(lambda: att.flash_attention_plain(q, k, v, plen, True),
                          lambda: att.flash_attention_cuda(q, k, v, plen, True))
        t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True))
        key = f"prefill_{P}"
        simt[key] = cuda_ms(lambda: att.flash_attention_cuda(q, k, v, plen, True, simt=True))
        flops[key] = 4 * 64 * attn_pairs([P] * 8, P, 16, True)
        b = bound(4 * q.numel() * 2, flops[key], "bf16")
        times[key], lib[key], bounds[key] = (tk, tp), t_lib, b
        print(f"time flash_attention prefill (8,{P},16,64) bf16 causal: kernel {tk:.4f} ms, simt "
              f"{simt[key]:.4f} ms, plain {tp:.4f} ms, library (SDPA) {t_lib:.4f} ms, bound "
              f"{b[0]:.4f} ms by {b[1]}; max_abs_err {e:.3g} [{card}]")
    times.update({"flash_plm": t_fwd, "flash_bwd": t_bwd})
    for name, key in (("flash_attention +stats (8,1024,16,64) bf16 causal", "flash_plm"),
                      ("flash_attention_bwd (8,1024,16,64) bf16 causal", "flash_bwd")):
        tk, tp = times[key]
        print(f"time {name}: kernel {tk:.4f} ms, simt {simt[key]:.4f} ms, plain {tp:.4f} ms, "
              f"library (SDPA) {lib[key]:.4f} ms, bound {bounds[key][0]:.4f} ms by {bounds[key][1]} [{card}]")
    # achieved rate: the kept (query, key) pairs times the operations a pair
    # needs (4 Dh forward; 10 Dh backward: the five products), over the time
    tflops = {}
    for key in ("prefill_32", "prefill_256", "flash_plm", "flash_bwd"):
        tflops[key] = flops[key] / times[key][0] / 1e9
        print(f"tflops {key}: tensor cores {tflops[key]:.1f} TFLOP/s, simt "
              f"{flops[key] / simt[key] / 1e9:.1f}, library (SDPA) {flops[key] / lib[key] / 1e9:.1f} "
              f"({flops[key] / 1e9:.2f} GFLOP; peak 989) [{card}]")
    for key, name, b_key in (("flash_plm", "flash_attention +stats (8,1024,16,64) bf16 causal", "flash_plm"),
                             ("flash_bwd_plm", "flash_attention_bwd (8,1024,16,64) bf16 causal", "flash_bwd")):
        sp = split[key]
        dev_us = sp["device_us"]
        print(f"time split {name} (tools/kernel_times.py's lengths as PLM_LENS): event {sp['event_ms']:.4f} "
              f"ms, device {'not measured' if dev_us is None else f'{dev_us:.2f} us'} (torch.profiler), "
              f"host issue {sp['host_us']:.2f} us a call; bound {bounds[b_key][0]:.4f} ms, library "
              f"{lib[b_key]:.4f} ms [{card}]")
    print(f"trace flash_attention_bwd (8,1024,16,64) bf16 causal, device ms a call by kernel "
          f"(torch.profiler): {passes or 'not measured'} [{card}]")
    hgmma, (regs, simt_regs) = sass_hgmma(), ptxas_report()
    print(f"sass HGMMA instructions per tensor-core kernel: {hgmma} [{card}]")
    for name, rep in {**regs, **simt_regs}.items():
        print(f"ptxas {name}: {rep}")
    # B at Dh 64, 96, 128, 256; C's two passes at the same four
    check(len(hgmma) == 12 and all(n > 0 for n in hgmma.values()), f"HGMMA counts {hgmma}")
    check(len(regs) == 12 and all("0 bytes spill stores, 0 bytes spill loads" in r for r in regs.values()),
          f"ptxas report {regs}")
    # B and C's two passes, fp32 and bf16, at 64, 96, 128, 256 and the chunked 256
    check(len(simt_regs) == 30, f"ptxas report of the SIMT kernels {sorted(simt_regs)}")

    # kernel D: both outputs exact, at a small shape and the tool's
    err["pump"] = 0
    for shape in ((3, 16, 256), PUMP_SHAPE):
        w = torch.randint(-127, 127, shape, generator=gen, dtype=torch.int8).to(dev)
        for steps in (1, 2, 16):
            (h, t), (ph, pt) = pump.pump_cuda(w, steps), pump.pump_plain(w, steps)
            e = max(abs(h.item() - ph.item()), abs(t.item() - pt.item()))
            check(e == 0, f"pump {shape} steps {steps}: head {h.item()} vs {ph.item()}, "
                          f"total {t.item()} vs {pt.item()}")
            err["pump"] = max(err["pump"], e)
        print(f"kernel pump {shape} steps 1, 2, 16: head and total equal to plain "
              f"(16 passes: head {h.item():.0f}, total {t.item()})")
    w32 = w.view(torch.int32)
    dst = torch.empty_like(w)
    t_pump = in_turns(lambda: pump.pump_plain(w, PUMP_STEPS), lambda: pump.pump_cuda(w, PUMP_STEPS))
    lib["pump"] = cuda_ms(lambda: [torch.sum(w32, dtype=torch.int64) for _ in range(PUMP_STEPS)])
    lib["pump_copy"] = cuda_ms(lambda: [dst.copy_(w) for _ in range(PUMP_STEPS)])
    n = PUMP_STEPS * w.numel()
    bounds["pump"] = bound(n, n, "int8")  # one add per byte streamed
    print(f"time pump {PUMP_SHAPE} x{PUMP_STEPS} passes: kernel {t_pump[0]:.4f} ms "
          f"({n / t_pump[0] / 1e9:.1f} TB/s), plain {t_pump[1]:.4f} ms, library {PUMP_STEPS} x "
          f"int32 sum {lib['pump']:.4f} ms, {PUMP_STEPS} x copy_ {lib['pump_copy']:.4f} ms, bound "
          f"{bounds['pump'][0]:.4f} ms by {bounds['pump'][1]} [{card}]")
    del w, w32, dst
    torch.cuda.synchronize()
    lib["flash_bwd_mrte"], bounds["flash_bwd_mrte"] = lib_bwd_mrte, bound_bwd_mrte
    split.update(split_bwd_mrte)
    # kernel A's bound at one ~4 s prompt, counted as at (8, 131000), and
    # the library composite there
    y1 = (torch.randn(64001, generator=gen) * 0.1).to(dev)
    f1 = mel.num_frames(y1.shape[-1])
    bounds["mel_prompt"] = bound(y1.numel() * 4 + f1 * 80 * 4,
                                 f1 * (2.5 * 1024 * 10 + 3 * 513 + 2 * nnz + 80), "fp32")
    lib["mel_prompt"] = cuda_ms(lambda: mel_library(y1))
    t_mel_prompt = in_turns(lambda: mel.mel_spectrogram_plain(y1), lambda: mel.mel_spectrogram_cuda(y1))
    print(f"time mel_spectrogram (64001,) fp32: kernel {t_mel_prompt[0]:.4f} ms, plain "
          f"{t_mel_prompt[1]:.4f} ms, library {lib['mel_prompt']:.4f} ms, bound "
          f"{bounds['mel_prompt'][0]:.5f} ms by {bounds['mel_prompt'][1]} [{card}]")
    # kernel A's backward at the vocoder trainer's (8, 16384) and the shipped
    # config's (16, 16384); the plain version runs the plain forward and its
    # autograd, as the kernel recomputes the forward; the library, the
    # autograd backward alone of torch.stft + filterbank matmul + log over its
    # saved graph
    t_mel_bwd = {}
    for key in ("mel_bwd", "mel_bwd_16"):
        yb, gb = x[key]
        t_mel_bwd[key] = in_turns(lambda: mel.mel_spectrogram_bwd_plain(yb, gb),
                                  lambda: mel.mel_spectrogram_bwd_cuda(yb, gb))
        yl = yb.detach().clone().requires_grad_()
        ml = mel_library(yl)
        lib[key] = cuda_ms(lambda: torch.autograd.grad(ml, yl, gb, retain_graph=True))
        del ml, yl
        # per frame: two real 1024-point FFTs, |X|, the filterbank forward and by
        # bin (2 a nonzero each), the mels' division, G (6 a bin), the window;
        # per sample the overlap-add (<= 4 frames, 3 adds)
        fr_b = gb.shape[0] * gb.shape[1]
        bwd_ops = fr_b * (2 * 2.5 * 1024 * 10 + 3 * 513 + 4 * nnz + 80 + 6 * 513 + 1024) + 3 * yb.numel()
        bounds[key] = bound(2 * yb.numel() * 4 + gb.numel() * 4, bwd_ops, "fp32")
        sp, halo = split[key], split[f"{key}_halo"]
        dev_us = {name: "not measured" if s["device_us"] is None else f"{s['device_us']:.2f} us"
                  for name, s in (("cluster", sp), ("halo", halo))}
        shape = tuple(yb.shape)
        print(f"time mel_spectrogram_bwd {shape} fp32: kernel {t_mel_bwd[key][0]:.4f} ms, plain "
              f"{t_mel_bwd[key][1]:.4f} ms, library (torch.stft + matmul + log, autograd backward) "
              f"{lib[key]:.4f} ms, bound {bounds[key][0]:.5f} ms by {bounds[key][1]} "
              f"({bwd_ops / 1e6:.1f} MFLOP, {(2 * yb.numel() + gb.numel()) * 4 / 1e6:.2f} MB) [{card}]")
        print(f"time split mel_spectrogram_bwd {shape} fp32: event {sp['event_ms']:.4f} ms, device "
              f"{dev_us['cluster']} (torch.profiler), host issue {sp['host_us']:.2f} us a call; "
              f"halo-only variant: event {halo['event_ms']:.4f} ms, device {dev_us['halo']}, host "
              f"{halo['host_us']:.2f} us [{card}]")
    return {"err": err, "lib": lib, "bound": bounds, "simt": simt, "tflops": tflops, "split": split,
            "ms": {"flash": t_att, "mel": t_mel, "pump": t_pump, "flash_bwd_mrte": t_bwd_mrte,
                   "mel_prompt": t_mel_prompt, **t_mel_bwd, **times}}


# kernels B and C at the ADM's head dim: 96 (tc_emb_dim 512; 128-wide tiles on
# the tensor cores, columns 96-127 zero) and 80 (zero-padded to 96)
HEAD_DIM_SHAPES = ((8, 64, 8, 96), (2, 50, 3, 80))
WIDE_HEAD_DIMS = (257, 320, 512, 640)  # SIMT chunks of 256: 257-512 as two, 640 as three (-> 768)
PREFILL_P = 2048  # the continuous engine's prompt budget at --prompt_tokens 2048


def wide_head_dims(dev: torch.device, err: dict) -> None:
    """Kernels B (with statistics) and C above head dim 256, fp32 and bf16,
    causal and not, on the SIMT path against their plain versions."""
    from megatts2_tpu_torch.ops import attention as att

    gen = torch.Generator().manual_seed(SEED + 12)
    lens = torch.tensor([70, 1, 24], dtype=torch.int32, device=dev)
    for dh in WIDE_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.randn(3, 70, 2, dh, generator=gen).to(dev, dtype) for _ in range(4))
            for causal in (False, True):
                tc0 = att.flash_attention_cuda.tc_launches, att.flash_attention_bwd_cuda.tc_launches
                out, m, l = att.flash_attention_cuda(q, k, v, lens, causal, return_stats=True)
                grads = att.flash_attention_bwd_cuda(q, k, v, lens, causal, g, m, l)
                ref, pm, pl = att.flash_attention_plain(q, k, v, lens, causal, return_stats=True)
                e = (out.float() - ref.float()).abs().max().item()
                em, el = (m - pm).abs().max().item(), ((l - pl).abs() / pl).max().item()
                ge = _rel_errs(grads, att.flash_attention_bwd_plain(q, k, v, lens, causal, g, m, l))
                check(out.shape == q.shape and all(x.shape == q.shape for x in grads)
                      and (att.flash_attention_cuda.tc_launches,
                           att.flash_attention_bwd_cuda.tc_launches) == tc0,
                      f"flash Dh {dh}: shapes or a tensor-core launch")
                check(e <= ATOL_ATT[dtype] and em <= ATOL_M and el <= RTOL_L
                      and all(a <= REL_BWD[dtype] * t for a, t in ge),
                      f"flash Dh {dh} {dtype} causal={causal}: fwd {e}, m {em}, l {el}, bwd {ge}")
                err["flash"] = max(err["flash"], e)
                err["flash_bwd"] = max(err["flash_bwd"], *(a for a, _ in ge))
                print(f"kernel flash_attention (3, 70, 2, {dh}) {str(dtype)[6:]} causal={causal} (simt, "
                      f"instance {att.instance_head_dim(dh)}): max_abs_err {e:.3g} (atol {ATOL_ATT[dtype]}), "
                      f"m {em:.3g}, l rel {el:.3g}; backward max_abs_err/max "
                      f"{', '.join(f'{n} {a:.3g}/{t:.3g}' for n, (a, t) in zip(('dq', 'dk', 'dv'), ge))}"
                      f" (rel {REL_BWD[dtype]})")
    torch.cuda.synchronize()


WIDE_TIMED = 320  # the head dim above 256 timed: two chunks of 256 on SIMT


def time_wide_head_dims(dev: torch.device, card: str, k: dict) -> None:
    """Kernels B and C at (3, 70, 2, WIDE_TIMED), fp32 and bf16, key lengths
    70, 1 and 24, not causal: kernel and plain in turns, SDPA (a boolean
    mask) and its autograd backward, and the bound; into ``k`` under
    ``wide_<dtype>`` and ``bwd_wide_<dtype>``."""
    from megatts2_tpu_torch.ops import attention as att

    gen = torch.Generator().manual_seed(SEED + 13)
    lens = torch.tensor([70, 1, 24], dtype=torch.int32, device=dev)
    pairs = attn_pairs([70, 1, 24], 70, 2, False)
    for dtype, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        q, k_, v, g = (torch.randn(3, 70, 2, WIDE_TIMED, generator=gen).to(dev, dtype)
                       for _ in range(4))
        _, m, l = att.flash_attention_cuda(q, k_, v, lens, return_stats=True)
        fwd, bwd = f"wide_{kind}", f"bwd_wide_{kind}"
        k["ms"][fwd] = in_turns(lambda: att.flash_attention_plain(q, k_, v, lens),
                                lambda: att.flash_attention_cuda(q, k_, v, lens))
        k["ms"][bwd] = in_turns(lambda: att.flash_attention_bwd_plain(q, k_, v, lens, False, g, m, l),
                                lambda: att.flash_attention_bwd_cuda(q, k_, v, lens, False, g, m, l))
        mask = sdpa_mask(lens, 70, False)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k_, v))
        k["lib"][fwd] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k_, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        gt = g.transpose(1, 2)
        k["lib"][bwd] = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
        del out, qt, kt, vt
        elt = q.element_size()
        k["bound"][fwd] = bound(4 * q.numel() * elt, 4 * WIDE_TIMED * pairs, kind)
        k["bound"][bwd] = bound(7 * q.numel() * elt + 2 * m.numel() * 4, 10 * WIDE_TIMED * pairs, kind)
        for name, key in (("flash_attention", fwd), ("flash_attention_bwd", bwd)):
            tk, tp = k["ms"][key]
            print(f"time {name} (3,70,2,{WIDE_TIMED}) {kind} (simt, chunks of 256): kernel {tk:.4f} ms, "
                  f"plain {tp:.4f} ms, library (SDPA{' autograd backward' if key == bwd else ''}) "
                  f"{k['lib'][key]:.4f} ms, bound {k['bound'][key][0]:.6f} ms by {k['bound'][key][1]} "
                  f"[{card}]")
    torch.cuda.synchronize()


def phase_kernels_serving(dev: torch.device, card: str, k: dict) -> None:
    """Kernels B and C at head dims 96 and 80, fp32 and bf16 (bf16 on the
    tensor cores and on SIMT), against their plain versions; both at Dh 96
    bf16 timed on each route; B and C above head dim 256; kernel B causal at
    the engine's prefill shape (8, 2048, 16, 64) bf16, timed beside SDPA and
    the bound.  Adds its errors, times, bounds and library times to the
    kernels phase's ``k``."""
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.tools import kernel_times

    gen = torch.Generator().manual_seed(SEED + 11)
    err, ms, lib, bounds, simt = k["err"], k["ms"], k["lib"], k["bound"], k["simt"]
    for shape in HEAD_DIM_SHAPES:
        B, T = shape[0], shape[1]
        lens = torch.tensor(([T, 1, T // 3 + 1, T - 5] * B)[:B], dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k_, v, g = (torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(4))
            for causal in (False, True):
                ref, pm, pl = att.flash_attention_plain(q, k_, v, lens, causal, return_stats=True)
                line = []
                for use_simt in ((False, True) if dtype == torch.bfloat16 else (True,)):
                    tc0 = att.flash_attention_cuda.tc_launches, att.flash_attention_bwd_cuda.tc_launches
                    out, m, l = att.flash_attention_cuda(q, k_, v, lens, causal, return_stats=True,
                                                         simt=use_simt)
                    e = (out.float() - ref.float()).abs().max().item()
                    em, el = (m - pm).abs().max().item(), ((l - pl).abs() / pl).max().item()
                    got = att.flash_attention_bwd_cuda(q, k_, v, lens, causal, g, m, l, simt=use_simt)
                    ge = _rel_errs(got, att.flash_attention_bwd_plain(q, k_, v, lens, causal, g, m, l))
                    tc = int(dtype == torch.bfloat16 and not use_simt)
                    check((att.flash_attention_cuda.tc_launches, att.flash_attention_bwd_cuda.tc_launches)
                          == (tc0[0] + tc, tc0[1] + tc), f"flash {shape} {dtype} simt={use_simt}: route")
                    check(out.shape == q.shape and bool(torch.isfinite(out).all()),
                          f"flash {shape} {dtype}: shape or non-finite")
                    check(e <= ATOL_ATT[dtype] and em <= ATOL_M and el <= RTOL_L,
                          f"flash {shape} {dtype} causal={causal} simt={use_simt}: err {e}, m {em}, l {el}")
                    check(all(a.shape == q.shape for a in got) and
                          all(a <= REL_BWD[dtype] * t for a, t in ge),
                          f"flash bwd {shape} {dtype} causal={causal} simt={use_simt}: {ge}")
                    err["flash"] = max(err["flash"], e)
                    err["flash_bwd"] = max(err["flash_bwd"], *(a for a, _ in ge))
                    line.append(f"{'simt' if use_simt else 'tensor cores'}: fwd {e:.3g}, m {em:.3g}, l rel "
                                f"{el:.3g}, " + ", ".join(f"{n} {a:.3g}/{t:.3g}" for n, (a, t)
                                                           in zip(("dq", "dk", "dv"), ge)))
                print(f"kernel flash_attention {shape} {str(dtype)[6:]} causal={causal} (head dim "
                      f"{shape[3]} on instance {att.instance_head_dim(shape[3])}): max_abs_err "
                      f"{'; '.join(line)} (atol {ATOL_ATT[dtype]}, bwd rel {REL_BWD[dtype]})")
    wide_head_dims(dev, err)
    time_wide_head_dims(dev, card, k)
    # kernels B and C at Dh 96 bf16 (the ADM's self-attention), every row of
    # length 64, on each route; the library: SDPA and its autograd backward
    q, k_, v, g = (torch.randn(8, 64, 8, 96, generator=gen).to(dev, torch.bfloat16) for _ in range(4))
    lens = torch.full((8,), 64, dtype=torch.int32, device=dev)
    _, m, l = att.flash_attention_cuda(q, k_, v, lens, return_stats=True)
    ms["dh96"] = in_turns(lambda: att.flash_attention_plain(q, k_, v, lens),
                          lambda: att.flash_attention_cuda(q, k_, v, lens))
    ms["bwd_dh96"] = in_turns(lambda: att.flash_attention_bwd_plain(q, k_, v, lens, False, g, m, l),
                              lambda: att.flash_attention_bwd_cuda(q, k_, v, lens, False, g, m, l))
    simt["dh96"] = cuda_ms(lambda: att.flash_attention_cuda(q, k_, v, lens, simt=True))
    simt["bwd_dh96"] = cuda_ms(lambda: att.flash_attention_bwd_cuda(q, k_, v, lens, False, g, m, l,
                                                                    simt=True))
    k["split"].update(kernel_times.time_cases({
        "dh96": (lambda: att.flash_attention_cuda(q, k_, v, lens), "flash"),
        "dh96_simt": (lambda: att.flash_attention_cuda(q, k_, v, lens, simt=True), "flash"),
        "bwd_dh96": (lambda: att.flash_attention_bwd_cuda(q, k_, v, lens, False, g, m, l), "flash_"),
        "bwd_dh96_simt": (lambda: att.flash_attention_bwd_cuda(q, k_, v, lens, False, g, m, l, simt=True),
                          "flash_")}))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k_, v))
    lib["dh96"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k_, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    gt = g.transpose(1, 2)
    lib["bwd_dh96"] = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
    del out, qt, kt, vt
    pairs = attn_pairs([64] * 8, 64, 8, False)
    bounds["dh96"] = bound(4 * q.numel() * 2, 4 * 96 * pairs, "bf16")
    bounds["bwd_dh96"] = bound(7 * q.numel() * 2 + 2 * m.numel() * 4, 10 * 96 * pairs, "bf16")
    # the engine's prompt prefill: causal over 2048 prompt codes in every row
    q, k_, v = (torch.randn(8, PREFILL_P, 16, 64, generator=gen).to(dev, torch.bfloat16)
                for _ in range(3))
    plen = torch.full((8,), PREFILL_P, dtype=torch.int32, device=dev)
    got = att.flash_attention_cuda(q, k_, v, plen, True)
    e = (got.float() - att.flash_attention_plain(q, k_, v, plen, True).float()).abs().max().item()
    check(e <= ATOL_ATT[torch.bfloat16], f"flash prefill P={PREFILL_P}: err {e}")
    err["flash"] = max(err["flash"], e)
    key = f"prefill_{PREFILL_P}"
    ms[key] = in_turns(lambda: att.flash_attention_plain(q, k_, v, plen, True),
                       lambda: att.flash_attention_cuda(q, k_, v, plen, True))
    lib[key] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k_.transpose(1, 2), v.transpose(1, 2), is_causal=True))
    bounds[key] = bound(4 * q.numel() * 2, 4 * 64 * attn_pairs([PREFILL_P] * 8, PREFILL_P, 16, True),
                        "bf16")
    for name, key_, lib_name in (("flash_attention (8,64,8,96) bf16", "dh96", "SDPA"),
                                 ("flash_attention_bwd (8,64,8,96) bf16", "bwd_dh96", "SDPA autograd backward"),
                                 (f"flash_attention prefill (8,{PREFILL_P},16,64) bf16 causal", key, "SDPA")):
        tk, tp = ms[key_]
        extra = f", simt {simt[key_]:.4f} ms" if key_ in simt else ""
        print(f"time {name}: tensor cores {tk:.4f} ms{extra}, plain {tp:.4f} ms, library ({lib_name}) "
              f"{lib[key_]:.4f} ms, bound {bounds[key_][0]:.5f} ms by {bounds[key_][1]} [{card}]")
    for key_, name in (("dh96", "flash_attention (8,64,8,96) bf16 tensor cores"),
                       ("dh96_simt", "flash_attention (8,64,8,96) bf16 simt"),
                       ("bwd_dh96", "flash_attention_bwd (8,64,8,96) bf16 tensor cores"),
                       ("bwd_dh96_simt", "flash_attention_bwd (8,64,8,96) bf16 simt")):
        sp = k["split"][key_]
        dev_us = sp["device_us"]
        b_key = key_.removesuffix("_simt")
        print(f"time split {name}: event {sp['event_ms']:.4f} ms, device "
              f"{'not measured' if dev_us is None else f'{dev_us:.2f} us'} (torch.profiler), host issue "
              f"{sp['host_us']:.2f} us a call; bound {bounds[b_key][0]:.5f} ms, library "
              f"{lib[b_key]:.4f} ms [{card}]")
    print(f"kernel flash_attention prefill (8,{PREFILL_P},16,64) bf16 causal: max_abs_err {e:.3g} "
          f"(atol {ATOL_ATT[torch.bfloat16]})")
    torch.cuda.synchronize()


def _configs(full: bool):
    from megatts2_tpu_torch import config as c

    if full:  # the slice: full width, as bench.py configures the JAX package
        return (c.MegaGConfig(mrte=c.MRTEConfig(use_flash=True)), c.MegaPLMConfig(),
                c.MegaADMConfig(tc_emb_dim=512), c.VocosConfig())
    return (  # small, with head dim 64 so the flash kernel takes it (MRTE, PLM prefill)
        c.MegaGConfig(
            mrte=c.MRTEConfig(mel_n_layer=2, mel_n_stack=1, mel_n_block=1, content_ff_dim=256,
                              content_n_layers=2, hidden_size=128, use_flash=True),
            vqpe=c.VQPEConfig(vq_bins=64, vq_dim=32), hidden_size=64, decoder_n_stack=1,
            decoder_n_block=1),
        c.MegaPLMConfig(n_layers=2, n_heads=3, vq_dim=64, tc_latent_dim=128, vq_bins=64),
        c.MegaADMConfig(n_layers=2, n_heads=2, emb_dim=64, tc_latent_dim=128, tc_emb_dim=64),
        c.VocosConfig(dim=64, intermediate_dim=128, num_layers=2),
    )


def _models(full: bool, seed: int):
    from megatts2_tpu_torch import models as m

    g_cfg, plm_cfg, adm_cfg, voc_cfg = _configs(full)
    gen = torch.Generator().manual_seed(seed)
    return (m.init_random_(m.MegaG(g_cfg), gen), m.init_random_(m.MegaPLM(plm_cfg), gen),
            m.init_random_(m.MegaADM(adm_cfg), gen), m.init_random_(m.Vocos(voc_cfg), gen))


def _hifigan(full: bool, seed: int):
    from megatts2_tpu_torch import config as c
    from megatts2_tpu_torch import models as m

    cfg = c.HiFiGANConfig() if full else c.HiFiGANConfig(
        upsample_initial_channel=64, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
        resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)))
    return m.init_random_(m.HiFiGAN(cfg), torch.Generator().manual_seed(seed))


def phase_reference(dev: torch.device) -> None:
    """Small fp32 slice: the card (kernels) against the CPU (plain versions)."""
    from megatts2_tpu_torch.models import adm_infer, plm_infer, synthesize
    from megatts2_tpu_torch.models.megatts import max_pool_time
    from megatts2_tpu_torch.ops import mel_spectrogram, regulate_length

    rng = np.random.RandomState(SEED)
    phone = torch.from_numpy(rng.randint(1, 320, (3, 20)))
    lens = torch.tensor([20, 13, 7])
    wavs = torch.from_numpy((rng.randn(3, 40000) * 0.1).astype(np.float32))
    out = {}
    for d in (torch.device("cpu"), dev):
        g, plm, adm, voc = (x.to(d).eval() for x in _models(False, SEED + 1))
        mels = mel_spectrogram(wavs.to(d))
        ph, ln = phone.to(d), lens.to(d)
        with torch.inference_mode():
            tc = g.mrte.tc_latent(ph, mels, ln)
            dt = adm_infer(adm, tc)
            dt = torch.where(torch.arange(20, device=d)[None] < ln[:, None], dt, 0)
            codes = plm_infer(plm, max_pool_time(regulate_length(tc, dt, 128), 8))
        wav, mel_hat, n = synthesize(g, plm, adm, voc, ph, ln, mels, 128)
        out[d.type] = [x.cpu() for x in (mels, tc, dt, codes, n, mel_hat, wav)]
    (m0, t0, d0, c0, n0, h0, w0), (m1, t1, d1, c1, n1, h1, w1) = out["cpu"], out["cuda"]
    errs = {k: (a - b).abs().max().item() for k, a, b in
            (("mel", m0, m1), ("tc_latent", t0, t1), ("mel_hat", h0, h1), ("wav", w0, w1))}
    check(errs["mel"] <= ATOL_MEL and errs["tc_latent"] <= 1e-3, f"reference: {errs}")
    check(torch.equal(d0, d1) and torch.equal(c0, c1) and torch.equal(n0, n1),
          "reference: durations, codes or n_frames differ between card and CPU")
    check(errs["mel_hat"] <= 1e-3 and errs["wav"] <= 1e-3, f"reference: {errs}")
    print(f"reference fp32 small slice, card vs CPU: durations, codes, n_frames equal; "
          f"max_abs_err {errs}")

    # the serving options: int8 PLM sampled at top-k 8 with the same injected
    # noise on both devices, after a prefilled P = 8 prompt; HiFi-GAN
    from megatts2_tpu_torch.quantization.weight_only import quantize_

    B, P, V = 3, 8, 64
    ptc = torch.from_numpy(rng.randn(B, P, 128).astype(np.float32))
    pcodes = torch.from_numpy(rng.randint(0, V, (B, P)))
    noise = torch.from_numpy(-np.log(-np.log(rng.uniform(1e-12, 1.0, (16, B, V)))).astype(np.float32))
    for d in (torch.device("cpu"), dev):
        g, plm, adm, _ = (x.to(d).eval() for x in _models(False, SEED + 5))
        quantize_(plm, 8)
        hifi = _hifigan(False, SEED + 6).to(d).eval()
        mels = mel_spectrogram(wavs.to(d))
        ph, ln = phone.to(d), lens.to(d)
        kw = dict(quant=True, temperature=TEMPERATURE, top_k=8, gumbel=noise.to(d),
                  prompt_tc=ptc.to(d), prompt_codes=pcodes.to(d))
        with torch.inference_mode():
            tc = g.mrte.tc_latent(ph, mels, ln)
            dt = adm_infer(adm, tc)
            dt = torch.where(torch.arange(20, device=d)[None] < ln[:, None], dt, 0)
            codes = plm_infer(plm, max_pool_time(regulate_length(tc, dt, 128), 8), **kw)
        wav, mel_hat, n = synthesize(g, plm, adm, hifi, ph, ln, mels, 128, quant=True,
                                     plm_temperature=TEMPERATURE, plm_top_k=8,
                                     plm_gumbel=kw["gumbel"], plm_prompt_tc=kw["prompt_tc"],
                                     plm_prompt_codes=kw["prompt_codes"])
        out[d.type] = [x.cpu() for x in (dt, codes, n, mel_hat, wav)]
    (d0, c0, n0, h0, w0), (d1, c1, n1, h1, w1) = out["cpu"], out["cuda"]
    check(torch.equal(d0, d1) and torch.equal(c0, c1) and torch.equal(n0, n1),
          "reference serving: durations, codes or n_frames differ between card and CPU")
    errs = {"mel_hat": (h0 - h1).abs().max().item(), "wav": (w0 - w1).abs().max().item()}
    check(errs["mel_hat"] <= 1e-3 and errs["wav"] <= 1e-3, f"reference serving: {errs}")
    print(f"reference fp32 small slice, int8 PLM, top-k 8 sampled with injected noise after a "
          f"P={P} prompt, HiFi-GAN, card vs CPU: durations, codes, n_frames equal; "
          f"max_abs_err {errs}")


def _write_prompts(root: str) -> tuple[str, str]:
    """A symbol table and two ~4 s 16 kHz int16 prompt wavs under ``root``."""
    sym = os.path.join(root, "symbols")
    with open(sym, "w") as f:
        for i, s in enumerate(["<eps>", "_", "-", "hello", "world"]):
            f.write(f"{s} {i}\n")
    wavs = os.path.join(root, "wavs")
    os.makedirs(wavs)
    rng = np.random.RandomState(SEED)
    for name, n, f0 in (("a.wav", 64001, 180.0), ("b.wav", 62377, 140.0)):
        t = np.arange(n) / 16000.0
        y = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.randn(n)
        wavfile.write(os.path.join(wavs, name), 16000, (np.clip(y, -1, 1) * 32767).astype(np.int16))
    return sym, wavs


def _read_prompt(path: str) -> np.ndarray:
    """The prompt as the caller gave it: int16 samples scaled to [-1, 1),
    then peak-normalised — the samples the output must start with."""
    _, data = wavfile.read(path)
    y = data.astype(np.float32) / 32768.0
    return y / np.max(np.abs(y))


def _mrte_routes(tts, text: str, mels: torch.Tensor, label: str, card: str, rounds: int = 8,
                 reps: int = 4) -> None:
    """The MRTE stage (``g.mrte.tc_latent``) at the batch's shapes with
    kernel B's forward on its tensor-core path (the default) and forced onto
    its SIMT path: wall ms a call, the host clock around ``reps`` calls that
    end in a synchronize, the routes taking turns (SIMT first in even
    rounds) for ``rounds`` rounds; the median and range of each route."""
    from megatts2_tpu_torch.ops import attention as att

    ids = torch.from_numpy(tts.phone_ids(text))
    B, n = mels.shape[0], len(ids)
    phone = torch.zeros(B, -(-n // 16) * 16, dtype=torch.long)
    phone[:, :n] = ids
    phone, lens = phone.to(tts.device), torch.full((B,), n, device=tts.device)
    default = att.uses_tensor_cores

    def wall(tensor_cores: bool) -> tuple[float, int]:
        att.uses_tensor_cores = default if tensor_cores else (lambda dtype, head_dim: False)
        try:
            with torch.inference_mode():
                tts.g.mrte.tc_latent(phone, mels, lens)
                torch.cuda.synchronize()
                tc0 = att.flash_attention_cuda.tc_launches
                t0 = time.perf_counter()
                for _ in range(reps):
                    tts.g.mrte.tc_latent(phone, mels, lens)
                torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3, att.flash_attention_cuda.tc_launches - tc0
        finally:
            att.uses_tensor_cores = default

    walls: dict = {True: [], False: []}
    calls = 0  # kernel B calls a tc_latent
    for r in range(rounds):
        for tensor_cores in ((False, True) if r % 2 == 0 else (True, False)):
            ms, n_tc = wall(tensor_cores)
            check((n_tc > 0) == tensor_cores, f"{label}: MRTE route tensor_cores={tensor_cores} "
                                              f"made {n_tc} tensor-core launches")
            walls[tensor_cores].append(ms)
            calls = n_tc // reps if tensor_cores else calls
    tc, simt = sorted(walls[True]), sorted(walls[False])
    print(f"slice {label}: MRTE stage (tc_latent, {calls} kernel B calls) wall ms a call, median "
          f"[min, max] of {rounds} rounds of {reps}: tensor cores {np.median(tc):.3f} [{tc[0]:.3f}, "
          f"{tc[-1]:.3f}], simt {np.median(simt):.3f} [{simt[0]:.3f}, {simt[-1]:.3f}] [{card}]")


def _drive_slice(tts, label: str, card: str, root: str, wavs: str, sig: torch.Tensor,
                 features=None) -> dict:
    """One full-width configuration through ``__call__`` and
    ``synthesize_batch``, kernel A's and B's counters set to 0 just before
    and read just after; then checks, warm walls and stage walls."""
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.ops import mel, mel_spectrogram

    MAX_FRAMES, B = tts.max_frames, sig.shape[0]
    dev = tts.device
    text = " ".join(["hello world"] * 16)  # 63 phones → Tp 64
    check(len(tts.phone_ids(text)) == 63, "bench text must give 63 phones")

    def batch(stage_times=None):
        t0 = time.perf_counter()
        mels = mel_spectrogram(sig.to(dev))  # (8, 512, 80)
        if stage_times is not None:
            torch.cuda.synchronize()
            stage_times["mel_frontend"] = time.perf_counter() - t0
        return tts.synthesize_batch([text] * B, mels, stage_times=stage_times,
                                    prompt_features=features), mels

    torch.cuda.synchronize()
    mel.mel_spectrogram_cuda.launches = 0
    att.flash_attention_cuda.launches = 0
    att.flash_attention_cuda.tc_launches = 0
    full = tts(wavs, "hello world", out_path=os.path.join(root, "test.wav"),
               prompt_features=features)
    outs, mels = batch()
    torch.cuda.synchronize()
    launches = {"mel": mel.mel_spectrogram_cuda.launches, "flash": att.flash_attention_cuda.launches,
                "flash_tc": att.flash_attention_cuda.tc_launches}
    print(f"slice {label}: launches on this path {launches} (flash_tc: kernel B on the tensor cores, "
          f"the MRTE and the prompt prefill)")
    check(launches["mel"] > 0 and launches["flash"] > 0, f"{label}: a kernel was not launched: {launches}")
    check(launches["flash_tc"] > 0, f"{label}: kernel B missed the tensor cores")

    prompt = _read_prompt(os.path.join(wavs, "a.wav"))
    gen_len = len(full) - len(prompt)
    check(np.array_equal(full[: len(prompt)], prompt), "prompt prefix is not the input")
    check(bool(np.isfinite(full).all()), "__call__: non-finite wav")
    check(gen_len % 256 == 0 and 256 <= gen_len <= MAX_FRAMES * 256, f"__call__: {gen_len} samples")
    check(tuple(mels.shape) == (B, 512, 80), f"prompt mels {tuple(mels.shape)}")
    check(len(outs) == B and all(np.isfinite(w).all() for w in outs), "batch: non-finite wav")
    check(all(len(w) % 256 == 0 and 256 <= len(w) <= MAX_FRAMES * 256 for w in outs),
          f"batch lengths {[len(w) for w in outs]}")
    check(all(np.abs(w).max() <= 1.0 for w in outs), "batch: |wav| > 1")
    print(f"slice {label}: __call__ wrote {len(prompt)} prompt + {gen_len} generated samples; "
          f"batch frames {[len(w) // 256 for w in outs]}")

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    stages: dict = {}
    batch(stage_times=stages)
    print(f"slice {label}: warm synthesize_batch B={B} wall s {[round(w, 4) for w in walls]} [{card}]")
    for name, sec in stages.items():
        print(f"slice {label}: stage {name} {sec * 1e3:.2f} ms [{card}]")
    _mrte_routes(tts, text, mels, label, card)
    print(f"slice {label}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_slice(dev: torch.device, card: str, root: str) -> dict:
    """The full-width slice three times: float PLM + Vocos (greedy), int8 PLM
    + Vocos (greedy), int8 PLM + HiFi-GAN sampled at top-k 8 after a
    prosody prompt of 32 codes shared by the batch."""
    from megatts2_tpu_torch.models import Megatts

    sym, wavs = _write_prompts(root)
    sig = torch.randn(8, 131000, generator=torch.Generator().manual_seed(SEED)) * 0.1
    rng = np.random.RandomState(SEED + 7)
    features = (rng.randn(1, 32, 512).astype(np.float32), rng.randint(0, 1024, (1, 32)))
    runs = (("bf16 Vocos", {}, False, None),
            ("int8 Vocos", dict(quant_int8=True), False, None),
            ("int8 HiFi-GAN top-k 8 prompt", dict(quant_int8=True, plm_temperature=TEMPERATURE,
                                                   plm_top_k=8), True, features))
    launches = {}
    for label, kw, hifigan, feats in runs:
        t0 = time.perf_counter()
        g, plm, adm, vocos = _models(True, SEED)
        tts = Megatts(g, plm, adm, _hifigan(True, SEED) if hifigan else vocos, sym,
                      max_frames=512, dtype=torch.bfloat16, device=dev, **kw)
        print(f"slice {label}: full-width models built and cast in {time.perf_counter() - t0:.1f} s")
        launches[label] = _drive_slice(tts, label, card, root, wavs, sig, feats)
        del tts, g, plm, adm, vocos
        torch.cuda.empty_cache()
    return launches


SERVE_TPS = (40, 64, 24)  # the serve reference's requests: the third is admitted mid-flight


def _serve_requests(mels, seed: int) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for i, tp in enumerate(SERVE_TPS):
        phone = rng.randint(1, 320, (1, tp))
        out.append({"id": f"r{i}", "phone": phone, "lens": np.array([tp]),
                    "mels_prompt": mels[i % len(mels)][None]})
    return out


def phase_serve_reference(dev: torch.device, root: str) -> None:
    """Small fp32 models: the port's checkpoints written and read back onto
    the card; the continuous engine (2 slots, 3 requests, one admitted
    mid-flight) and a stream, each equal to ``synthesize`` at its budget;
    the card equal to the CPU."""
    from megatts2_tpu_torch.continuous import ContinuousEngine
    from megatts2_tpu_torch.models import synthesize
    from megatts2_tpu_torch.models.pretrained import _load
    from megatts2_tpu_torch.models.streaming import stream_geometry, stream_synthesize
    from megatts2_tpu_torch.ops import mel_spectrogram
    from megatts2_tpu_torch.training.checkpoints import model_state_dict

    src = _models(False, SEED + 21)
    path = os.path.join(root, "small.ckpt")
    sd = {}
    for module in src:
        sd.update(model_state_dict(module))
    torch.save({"state_dict": sd}, path)
    fresh = _models(False, SEED + 22)
    loaded = [_load(m, path).to(dev) for m in fresh]
    for a, b in zip(src, loaded):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            check(torch.equal(x, y.cpu()), f"checkpoint round trip: {type(a).__name__}.{name}")
    print(f"serve reference: {len(sd)} reference-layout tensors written ({os.path.getsize(path) / 2**20:.1f} "
          f"MiB) and read back onto the card, every parameter and buffer equal")

    rng = np.random.RandomState(SEED + 23)
    wavs = torch.from_numpy((rng.randn(2, 20000) * 0.1).astype(np.float32))
    out = {}
    for d in (torch.device("cpu"), dev):
        g, plm, adm, voc = (x.to(d).eval() for x in _models(False, SEED + 21))
        mels = mel_spectrogram(wavs.to(d))
        eng = ContinuousEngine(g, plm, adm, voc, slots=2, max_frames=256, chunk_frames=64, device=d)
        reqs = _serve_requests(mels, SEED + 24)
        got = dict(eng.run(reqs))
        check(sorted(got) == ["r0", "r1", "r2"], f"engine on {d.type}: {sorted(got)}")
        for r in reqs:
            tp = r["phone"].shape[1]
            phone = torch.zeros((1, -(-tp // 16) * 16), dtype=torch.long)
            phone[0, :tp] = torch.from_numpy(r["phone"][0])
            wav, _, n = synthesize(g, plm, adm, voc, phone.to(d), torch.tensor([tp], device=d),
                                   r["mels_prompt"], eng.Tmax)
            want = wav[0, : int(n[0]) * 256].cpu().numpy()
            e = float(np.abs(got[r["id"]] - want).max()) if got[r["id"]].shape == want.shape else None
            check(e is not None and e <= 1e-3,
                  f"engine on {d.type}, {r['id']}: {got[r['id']].shape} vs {want.shape}, err {e}")
        F_, rv, rd, Tmax = stream_geometry(g.cfg, voc.cfg, 192, 64)
        r = reqs[0]
        phone = torch.from_numpy(r["phone"]).to(d)
        lens = torch.tensor([phone.shape[1]], device=d)
        chunks = list(stream_synthesize(g, plm, adm, voc, phone, lens, r["mels_prompt"], 192, 64))
        wav, _, n = synthesize(g, plm, adm, voc, phone, lens, r["mels_prompt"], Tmax)
        want = wav[0, : int(n[0]) * 256].cpu().numpy()
        streamed = np.concatenate(chunks)
        check(streamed.shape == want.shape and float(np.abs(streamed - want).max()) <= 1e-3,
              f"stream on {d.type}: {streamed.shape} vs {want.shape}")
        out[d.type] = (got, streamed, len(chunks))
    (g0, s0, c0), (g1, s1, c1) = out["cpu"], out["cuda"]
    errs = {rid: float(np.abs(g0[rid] - g1[rid]).max()) for rid in g0 if g0[rid].shape == g1[rid].shape}
    check(len(errs) == 3 and max(errs.values()) <= 1e-3 and s0.shape == s1.shape
          and float(np.abs(s0 - s1).max()) <= 1e-3,
          f"serve reference card vs CPU: {errs}, stream {s0.shape} vs {s1.shape}")
    print(f"serve reference fp32 small: engine (2 slots; Tp {SERVE_TPS}, one admitted mid-flight) and "
          f"a {c1}-chunk stream each equal synthesize at their budget (atol 1e-3), on card and CPU; "
          f"card vs CPU lengths equal, max_abs_err engine {errs}, stream "
          f"{float(np.abs(s0 - s1).max()):.3g}")


SERVE_REPEATS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 2)  # "hello world" x n


def _serve_inputs(root: str, wavs: str) -> dict:
    """Configs (the GAN's copied with use_flash under the MRTE), two prompt
    dirs of one wav each, the 16 requests and a synthetic stage-2 prompt
    dataset for speaker spkA."""
    import shutil

    from megatts2_tpu_torch.data import Cut, CutManifest

    repo = os.path.dirname(os.path.abspath(__file__))
    gan = os.path.join(root, "config_gan_flash.yaml")
    with open(os.path.join(repo, "configs", "config_gan.yaml")) as f:
        text = f.read()
    check("    mrte:\n" in text, "config_gan.yaml: no mrte block")
    with open(gan, "w") as f:
        f.write(text.replace("    mrte:\n", "    mrte:\n      use_flash: true\n", 1))
    dirs = {}
    for name in ("a", "b"):
        dirs[name] = os.path.join(root, f"prompt_{name}")
        os.makedirs(dirs[name])
        shutil.copy(os.path.join(wavs, f"{name}.wav"), dirs[name])
    reqs = os.path.join(root, "requests.jsonl")
    with open(reqs, "w") as f:
        for i, n in enumerate(SERVE_REPEATS):
            f.write(json.dumps({"id": f"u{i:02d}", "text": " ".join(["hello world"] * n),
                                "wavs_dir": dirs["a" if i % 2 else "b"]}) + "\n")
    prompted = os.path.join(root, "requests_prompted.jsonl")
    with open(reqs) as f, open(prompted, "w") as g:
        for line in f:
            g.write(json.dumps({**json.loads(line), "prompt_speaker": "spkA"}) + "\n")
    ds = os.path.join(root, "prompt_ds")
    os.makedirs(os.path.join(ds, "latents", "spkA"))
    rng = np.random.RandomState(SEED + 31)
    cuts = []
    for i in range(3):  # 3 utterances of 100 phones x 8 frames = 100 codes each
        cid = f"c{i}"
        cuts.append(Cut(id=cid, speaker="spkA", duration=800 * 256 / 16000, num_frames=800,
                        phone_tokens=["hello"] * 100, duration_tokens=[8] * 100))
        np.save(os.path.join(ds, "latents", "spkA", f"{cid}.npy"),
                {"tc_latent": rng.randn(1, 100, 512).astype(np.float32),
                 "p_code": rng.randint(0, 1024, (1, 1, 100)).astype(np.int32)}, allow_pickle=True)
    CutManifest(cuts).save(os.path.join(ds, "cuts_train.jsonl.gz"))
    return dict(gan=gan, plm=os.path.join(repo, "configs", "config_plm.yaml"),
                adm=os.path.join(repo, "configs", "config_adm.yaml"), reqs=reqs,
                prompted=prompted, prompt_ds=ds, dirs=dirs)


def _write_serve_checkpoints(root: str, inputs: dict) -> dict:
    """Seeded random full-width weights written by the port's checkpoint
    writer as reference-layout .ckpt files; their sizes and seconds."""
    from megatts2_tpu_torch import config as c
    from megatts2_tpu_torch import models as m
    from megatts2_tpu_torch.training.checkpoints import model_state_dict

    gen = torch.Generator().manual_seed(SEED + 32)
    modules = {"g": m.MegaG(c.load_gan_config(inputs["gan"])[0]),
               "plm": m.MegaPLM(c.load_plm_config(inputs["plm"])[0]),
               "adm": m.MegaADM(c.load_adm_config(inputs["adm"])[0]),
               "hifigan": m.HiFiGAN(c.HiFiGANConfig())}
    paths = {}
    t0 = time.perf_counter()
    for name, module in modules.items():
        m.init_random_(module, gen)
        paths[name] = os.path.join(root, f"{name}.ckpt")
        torch.save({"state_dict": model_state_dict(module), "global_step": 0}, paths[name])
    sizes = {k: round(os.path.getsize(p) / 2**20, 1) for k, p in paths.items()}
    print(f"serve: reference-layout checkpoints written in {time.perf_counter() - t0:.1f} s, MiB {sizes}")
    return paths


def _serve_args(inputs: dict, ck: dict, sym: str) -> list:
    return ["--g_ckpt", ck["g"], "--g_config", inputs["gan"], "--plm_ckpt", ck["plm"],
            "--plm_config", inputs["plm"], "--adm_ckpt", ck["adm"], "--adm_config", inputs["adm"],
            "--hifigan_ckpt", ck["hifigan"], "--symbol_table", sym]


def _serve_http(argv: list, inputs: dict, n: int = 8) -> dict:
    """``serve.main --http 0`` in process; n concurrent POSTs and a /healthz."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import megatts2_tpu_torch.serve as serve_mod

    texts = [" ".join(["hello world"] * k) for k in SERVE_REPEATS[:n]]
    out = {}

    def post(i_text):
        i, text = i_text
        body = json.dumps({"text": text, "wavs_dir": inputs["dirs"]["a" if i % 2 else "b"]}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{out['port']}/synthesize", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()

    def ready(server):
        try:
            out["port"] = server.server_address[1]
            with urllib.request.urlopen(f"http://127.0.0.1:{out['port']}/healthz", timeout=60) as r:
                out["healthz"] = r.status
            t0 = time.perf_counter()
            with ThreadPoolExecutor(n) as ex:
                out["replies"] = list(ex.map(post, enumerate(texts)))
            out["wall_s"] = time.perf_counter() - t0
        except BaseException as e:  # raised in the caller
            out["error"] = e
        finally:
            server.shutdown()

    orig = serve_mod.run_http
    serve_mod.run_http = lambda args, tts: orig(args, tts, _ready_cb=ready)
    try:
        serve_mod.main(argv)
    finally:
        serve_mod.run_http = orig
    if "error" in out:
        raise out["error"]
    return out


def _serve_mrte_times(dev: torch.device, card: str, k: dict, sigs: set) -> None:
    """Kernel B at the largest MRTE launch signature (head dim 256, not
    causal) of the serving path, every phone real: kernel and plain in
    turns, SDPA and the bound, into ``k["serve_mrte"]``."""
    from megatts2_tpu_torch.ops import attention as att

    mrte = [sig for sig in sigs if sig[4] == 256 and not sig[6]]
    check(bool(mrte), f"serve: no MRTE launch among {sigs}")
    B, Tq, Tk, H, dh = max(mrte, key=lambda sig: sig[0] * sig[1] * sig[2])[:5]
    gen = torch.Generator().manual_seed(SEED + 13)
    q = torch.randn(B, Tq, H, dh, generator=gen).to(dev, torch.bfloat16)
    k_, v = (torch.randn(B, Tk, H, dh, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    lens = torch.full((B,), Tk, dtype=torch.int32, device=dev)
    tk, tp = in_turns(lambda: att.flash_attention_plain(q, k_, v, lens),
                      lambda: att.flash_attention_cuda(q, k_, v, lens))
    t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k_.transpose(1, 2),
                                                           v.transpose(1, 2)))
    b = bound(2 * (2 * q.numel() + k_.numel() + v.numel()), 4 * dh * attn_pairs([Tk] * B, Tq, H, False), "bf16")
    k["serve_mrte"] = {"shape": f"({B}, {Tq}, {Tk}, {H}, {dh}) bf16", "ms": tk, "plain_ms": tp,
                       "library_ms": t_lib, "bound_ms": b[0], "signatures": len(mrte)}
    print(f"time flash_attention serve MRTE (B,Tq,Tk,H,Dh)={(B, Tq, Tk, H, dh)} bf16 (the largest of the "
          f"serving path's {len(mrte)} MRTE signatures {sorted(sig[:3] for sig in mrte)}), every phone "
          f"real: tensor cores {tk:.4f} ms, plain {tp:.4f} ms, library (SDPA) {t_lib:.4f} ms, bound "
          f"{b[0]:.5f} ms by {b[1]} [{card}]")


def phase_serve(dev: torch.device, card: str, root: str, k: dict) -> dict:
    """The full-width serving path in bf16 through ``serve.main`` in process
    with ``serve.py``'s defaults: batch, --continuous, --continuous with a
    2048-token prosody prompt, --http.  Kernel A's and B's counters (and B's
    tensor-core and causal ones) are set to 0 before each mode and read
    after it; kernel B's launch signatures are recorded and it is timed at
    the largest MRTE one; then the stream's time to first chunk."""
    import io

    from megatts2_tpu_torch.models import megatts_from_pretrained
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.ops import mel
    from megatts2_tpu_torch.serve import main as serve_main

    root = os.path.join(root, "serve")
    os.makedirs(root)
    sym, wavs = _write_prompts(root)
    inputs = _serve_inputs(root, wavs)
    ck = _write_serve_checkpoints(root, inputs)
    base = _serve_args(inputs, ck, sym)
    out_dir = os.path.join(root, "out")
    modes = (("batch", ["--requests", inputs["reqs"]]),
             ("continuous", ["--requests", inputs["reqs"], "--continuous"]),
             ("continuous prompted", ["--requests", inputs["prompted"], "--continuous",
                                      "--prompt_ds", inputs["prompt_ds"], "--prompt_tokens",
                                      str(PREFILL_P)]),
             ("http", ["--http", "0"]))
    launches = {}
    att.flash_attention_cuda.shapes = set()
    for label, extra in modes:
        d = os.path.join(out_dir, label.replace(" ", "_"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mel.mel_spectrogram_cuda.launches = 0
        for name in ("launches", "tc_launches", "causal_launches"):
            setattr(att.flash_attention_cuda, name, 0)
        t0 = time.perf_counter()
        if label == "http":
            rec = _serve_http(base + extra, inputs)
            wav_lens = []
            for status, payload in rec["replies"]:
                sr, data = wavfile.read(io.BytesIO(payload))
                check(status == 200 and sr == 16000, f"http: status {status}, sr {sr}")
                wav_lens.append(len(data))
            check(rec["healthz"] == 200, "http: /healthz")
            audio_s = sum(wav_lens) / 16000
            rec = {"requests": len(wav_lens), "wall_s": rec["wall_s"],
                   "utt_per_sec": len(wav_lens) / rec["wall_s"], "audio_s": audio_s,
                   "rtf": rec["wall_s"] / audio_s, "load_s": None}
        else:
            rec = serve_main(base + extra + ["--out_dir", d])
            names = sorted(os.listdir(d))
            check(names == [f"u{i:02d}.wav" for i in range(len(SERVE_REPEATS))],
                  f"{label}: wavs {names}")
            wav_lens = [len(wavfile.read(os.path.join(d, n))[1]) for n in names]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {"mel": mel.mel_spectrogram_cuda.launches, "flash": att.flash_attention_cuda.launches,
             "flash_tc": att.flash_attention_cuda.tc_launches,
             "flash_causal": att.flash_attention_cuda.causal_launches}
        launches[label] = n
        check(n["mel"] > 0 and n["flash"] > 0 and n["flash_tc"] > 0,
              f"serve {label}: a kernel was not launched: {n}")
        if label == "continuous prompted":
            check(n["flash_causal"] > 0, f"serve {label}: kernel B causal (the prefill) not launched")
        check(all(0 < x <= 1024 * 256 and x % 256 == 0 for x in wav_lens),
              f"serve {label}: wav lengths {wav_lens}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        load = "" if rec["load_s"] is None else f", checkpoints loaded in {rec['load_s']:.1f} s"
        print(f"serve {label}: {rec['requests']} requests, wall {rec['wall_s']:.3f} s ({wall:.1f} s "
              f"for the mode{load}), {rec['utt_per_sec']:.3f} utt/s, audio {rec['audio_s']:.2f} s, "
              f"RTF {rec['rtf']:.4f}, peak memory {peak:.2f} GiB, launches {n}, frames "
              f"{[x // 256 for x in wav_lens]} [{card}]")
    sigs, att.flash_attention_cuda.shapes = att.flash_attention_cuda.shapes, None
    _serve_mrte_times(dev, card, k, sigs)
    # the stream's time to first chunk, warm (the second of two streams)
    t0 = time.perf_counter()
    tts = megatts_from_pretrained(ck["g"], inputs["gan"], ck["plm"], inputs["plm"], ck["adm"],
                                  inputs["adm"], sym, hifigan_ckpt=ck["hifigan"], max_frames=1024,
                                  device=dev)
    print(f"serve: megatts_from_pretrained loaded in {time.perf_counter() - t0:.1f} s")
    text = " ".join(["hello world"] * 32)
    ttfc = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks = tts.stream(inputs["dirs"]["a"], text, chunk_frames=128)
        first = next(chunks)
        ttfc.append(time.perf_counter() - t0)
        rest = list(chunks)
    lens = [len(c) for c in [first] + rest]
    check(all(n == 128 * 256 for n in lens[:-1]) and 0 < lens[-1] <= 128 * 256
          and lens[-1] % 256 == 0 and all(np.isfinite(c).all() for c in [first] + rest),
          f"stream: chunk lengths {lens} or non-finite")
    print(f"serve stream: time to first chunk ({lens[0] // 256} frames) {ttfc[1] * 1e3:.1f} ms warm, "
          f"{ttfc[0] * 1e3:.1f} ms cold, {len(lens)} chunks, {sum(lens) // 256} frames [{card}]")
    del tts
    torch.cuda.empty_cache()
    return launches


def phase_bandwidth(card: str) -> int:
    """The bandwidth tool at its full shapes; kernel D must launch."""
    from megatts2_tpu_torch.ops import pump
    from megatts2_tpu_torch.tools import bw_ceiling

    torch.cuda.synchronize()
    pump.pump_cuda.launches = 0
    recs = bw_ceiling.run(device="cuda", card=card, emit=lambda line: print(f"bw_ceiling: {line}"))
    torch.cuda.synchronize()
    launches = pump.pump_cuda.launches
    print(f"bw_ceiling: kernel D launches on this path {launches}")
    check(launches > 0, "bw_ceiling: kernel D was not launched")
    check([r["case"] for r in recs] == ["read_reduce", "dots", "pump_16", "pump_64", "pump_fit",
                                         "decode"], f"bw_ceiling cases {[r['case'] for r in recs]}")
    check(all(np.isfinite(v) and v > 0 for r in recs for k, v in r.items()
              if isinstance(v, float) and k != "intercept_ms"), f"bw_ceiling: {recs}")
    return launches


def _plm_batch(cfg, lens: list[int], L: int, seed: int) -> dict:
    """A batch in PLMBatchBuilder's format: BOS then codes then eos padding,
    (B, L + 1) int32; fp16 latents zero past each length; int32 lengths."""
    rng = np.random.RandomState(seed)
    p_codes = np.full((len(lens), L + 1), cfg.eos_id, np.int32)
    tc = np.zeros((len(lens), L, cfg.tc_latent_dim), np.float16)
    for i, n in enumerate(lens):
        p_codes[i, 0] = cfg.bos_id
        p_codes[i, 1 : n + 1] = rng.randint(0, cfg.vq_bins, n)
        tc[i, :n] = rng.randn(n, cfg.tc_latent_dim)
    return {"p_codes": p_codes, "tc_latents": tc, "lens": np.asarray(lens, np.int32)}


def phase_train_reference(dev: torch.device) -> None:
    """Small fp32 PLM, 3 AdamW steps on the card (kernels) and on the CPU
    (plain versions) from the same seeded weights.  The first step has lr 0
    (warmup 1), so its gradients are those of the initial weights."""
    from megatts2_tpu_torch import config as c
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.training import create_plm_state, make_plm_train_step

    cfg = c.MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=64, tc_latent_dim=64, vq_bins=64,
                          dropout=0.0)
    lr = 1e-3
    tcfg = c.TrainConfig(warmup_steps=1, initial_learning_rate=lr, train_dtype="float32")
    batch = _plm_batch(cfg, [96, 61, 7, 0], 96, SEED + 2)
    out = {}
    for d in (torch.device("cpu"), dev):
        st = create_plm_state(cfg, tcfg, device=d)
        step, _ = make_plm_train_step(cfg, tcfg)
        fb, bb = att.flash_attention_cuda.launches, att.flash_attention_bwd_cuda.launches
        losses = [float(step(st, batch)["loss"])]
        grads = {n: p.grad.cpu() for n, p in st.model.named_parameters()}
        losses += [float(step(st, batch)["loss"]) for _ in range(2)]
        launched = (att.flash_attention_cuda.launches - fb, att.flash_attention_bwd_cuda.launches - bb)
        params = {n: p.detach().cpu() for n, p in st.model.named_parameters()}
        out[d.type] = losses, grads, params, launched
    (l0, g0, p0, _), (l1, g1, p1, launched) = out["cpu"], out["cuda"]
    check(launched[0] > 0 and launched[1] > 0, f"train reference: kernels not launched {launched}")
    check(np.allclose(l1, l0, rtol=1e-5, atol=0), f"train reference: losses {l1} vs {l0}")
    # gradients: fp32 sums in another order, 1e-5 of the largest gradient
    g_top = max(g.abs().max().item() for g in g0.values())
    g_err = max((g1[n] - g).abs().max().item() for n, g in g0.items())
    # parameters: Adam normalises each update, so a weight whose gradient is
    # near 0 moves by up to ~lr whatever its rounding; 0.05 of the two
    # nonzero updates' largest movement.  The key-projection bias has a true
    # gradient of 0 (softmax is shift invariant): up to ~lr per update apart.
    D = cfg.d_model
    p_err, kb_err = 0.0, 0.0
    for n, a in p1.items():
        d = (a - p0[n]).abs()
        if n.endswith("attn.qkv.bias"):
            kb_err = max(kb_err, d[D : 2 * D].max().item())
            d = torch.cat([d[:D], d[2 * D :]])
        p_err = max(p_err, d.max().item())
    check(g_err <= 1e-5 * g_top, f"train reference: gradients err {g_err}, max {g_top}")
    check(p_err <= 0.05 * 2 * lr and kb_err <= 2.1 * 2 * lr,
          f"train reference: params err {p_err}, key bias {kb_err}")
    print(f"train reference fp32 small PLM, card vs CPU, 3 AdamW steps: losses {l1} vs {l0}; "
          f"gradients max_abs_err {g_err:.3g} of max {g_top:.3g} (rel 1e-5); params max_abs_err "
          f"{p_err:.3g} (atol {0.05 * 2 * lr:.3g}), key bias {kb_err:.3g} (atol {2.1 * 2 * lr:.3g}); "
          f"launches fwd {launched[0]} bwd {launched[1]}")


def _steps_ms(step, state, batch, n: int = 5) -> float:
    """Warm milliseconds per train step, host clock around n steps that end
    in a synchronize (the numpy batch is uploaded in every step)."""
    step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_train(dev: torch.device, card: str, root: str) -> dict:
    from megatts2_tpu_torch import config as c
    from megatts2_tpu_torch.models import plm_infer
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.training import (create_adm_state, create_plm_state,
                                             make_adm_train_step, make_plm_train_step,
                                             run_training)

    cfg, tcfg = c.MegaPLMConfig(), c.TrainConfig(train_dtype="bfloat16", warmup_steps=1)
    batch = _plm_batch(cfg, PLM_LENS, PLM_L, SEED + 3)
    t0 = time.perf_counter()
    st = create_plm_state(cfg, tcfg, device=dev)
    n_params = sum(p.numel() for p in st.model.parameters())
    print(f"train: full-width PLM, {n_params} fp32 parameters, built in {time.perf_counter() - t0:.1f} s")
    step, evaluate = make_plm_train_step(cfg, tcfg)
    eval_before = float(evaluate(st, batch)["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (att.flash_attention_cuda, att.flash_attention_bwd_cuda):
        fn.launches = fn.tc_launches = fn.layout_copies = 0
    log_dir = os.path.join(root, "logs")
    run_training("plm", st, step, lambda epoch: [batch], max_steps=6, log_dir=log_dir,
                 log_every=1, val_every=6, eval_step=evaluate,
                 valid_loader_factory=lambda epoch: [batch])
    torch.cuda.synchronize()
    launches = {"flash": att.flash_attention_cuda.launches,
                "flash_bwd": att.flash_attention_bwd_cuda.launches,
                "flash_tc": att.flash_attention_cuda.tc_launches,
                "flash_bwd_tc": att.flash_attention_bwd_cuda.tc_launches}
    print(f"train: launches on the main path {launches}; views copied for TMA: fwd "
          f"{att.flash_attention_cuda.layout_copies}, bwd {att.flash_attention_bwd_cuda.layout_copies}")
    check(all(n > 0 for n in launches.values()), f"a kernel or its tensor-core path was not launched: {launches}")
    with open(os.path.join(log_dir, "plm_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    eval_after = [r["val/loss"] for r in rows if "val/loss" in r][-1]
    check(len(losses) == 6 and all(np.isfinite(losses)), f"train: losses {losses}")
    check(eval_after < eval_before, f"train: eval loss {eval_before} -> {eval_after} did not fall")
    print(f"train: PLM losses {[round(x, 4) for x in losses]}; eval loss (no dropout) "
          f"{eval_before:.4f} -> {eval_after:.4f} over 6 steps (lr 0 at the first)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = _steps_ms(step, st, batch)
    tokens = PLM_B * PLM_L
    print(f"train: PLM warm step {ms:.2f} ms, {tokens / ms * 1e3:.0f} tokens/s "
          f"(B={PLM_B}, L={PLM_L}, padded; {sum(PLM_LENS) / ms * 1e3:.0f} valid tokens/s), "
          f"peak device memory {peak:.2f} GiB [{card}]")
    from megatts2_tpu_torch.tools.kernel_times import trace_kernels

    groups = {"attention B, C": 0.0, "matmul": 0.0, "other": 0.0}
    kernels = trace_kernels(lambda: step(st, batch))
    for name, t in kernels.items():
        groups["attention B, C" if "flash_" in name else "matmul" if re.search(
            r"gemm|xmma|cutlass|cublas|nvjet|sm90_", name) else "other"] += t
    top = [(name[:48], round(t, 3)) for name, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:5]]
    busy = sum(groups.values())
    print(f"train: trace of a warm step (torch.profiler), device ms by kernel group "
          f"{ {k: round(v, 3) for k, v in groups.items()} }, busy {busy:.2f} of {ms:.2f} ms "
          f"({1 - busy / ms:.1%} idle); top kernels {top} [{card}]")

    acfg = c.MegaADMConfig(tc_emb_dim=512)
    rng = np.random.RandomState(SEED + 4)
    B, T = 8, 64
    abatch = {"tc_latents": rng.randn(B, T, acfg.tc_latent_dim).astype(np.float16),
              "duration_tokens": np.concatenate(
                  [np.zeros((B, 1, 1), np.float32), rng.randint(1, 9, (B, T, 1)).astype(np.float32)], 1),
              "lens": np.full((B,), T, np.int32)}
    first = {}
    for flash in (False, True):  # the same seeded weights and dropout draws on either route
        acfg = c.MegaADMConfig(tc_emb_dim=512, use_flash=flash)
        ast = create_adm_state(acfg, tcfg, device=dev)
        astep, _ = make_adm_train_step(acfg, tcfg)
        torch.cuda.synchronize()
        for fn in (att.flash_attention_cuda, att.flash_attention_bwd_cuda):
            fn.launches = fn.tc_launches = 0
        alosses = [float(astep(ast, abatch)["loss"]) for _ in range(4)]
        torch.cuda.synchronize()
        n = {"B": att.flash_attention_cuda.launches, "B_tc": att.flash_attention_cuda.tc_launches,
             "C": att.flash_attention_bwd_cuda.launches, "C_tc": att.flash_attention_bwd_cuda.tc_launches}
        check(all(np.isfinite(alosses)), f"train: ADM use_flash={flash} losses {alosses}")
        if flash:
            check(n["B"] > 0 and n["C"] > 0 and n["B_tc"] == n["B"] and n["C_tc"] == n["C"],
                  f"train: ADM use_flash: B and C must launch, only on the tensor cores: {n}")
            check(abs(alosses[0] - first[False]) <= ADM_FLASH_RTOL * abs(first[False]),
                  f"train: ADM first loss {alosses[0]} with use_flash, {first[False]} plain")
        else:
            check(sum(n.values()) == 0, f"train: ADM plain attention launched {n}")
        first[flash] = alosses[0]
        ams = _steps_ms(astep, ast, abatch)
        label = "use_flash" if flash else "plain attention"
        print(f"train: ADM (tc_emb_dim 512, head dim 96, {label}) losses "
              f"{[round(x, 4) for x in alosses]}; launches B {n['B']} (tensor cores {n['B_tc']}, SIMT "
              f"{n['B'] - n['B_tc']}), C {n['C']} (tensor cores {n['C_tc']}, SIMT {n['C'] - n['C_tc']}); "
              f"warm step {ams:.2f} ms, B={B}, T={T} [{card}]")
        launches["adm_flash" if flash else "adm_plain"] = n
        del ast, astep
    print(f"train: ADM first-step loss, plain attention {first[False]:.6f}, use_flash {first[True]:.6f} "
          f"(rel {abs(first[True] - first[False]) / abs(first[False]):.3g}, rtol {ADM_FLASH_RTOL})")

    tc = torch.randn(2, 16, cfg.tc_latent_dim, generator=torch.Generator().manual_seed(SEED)).to(dev)
    codes = plm_infer(st.model, tc)
    check(tuple(codes.shape) == (2, 16) and int(codes.min()) >= 0 and int(codes.max()) < cfg.vq_bins,
          f"decode: codes {tuple(codes.shape)}")
    p_codes = torch.cat([torch.full((2, 1), cfg.bos_id, device=dev), codes], dim=1)
    with torch.no_grad():
        logits, _ = st.model(tc, p_codes, torch.full((2,), 16, device=dev))
    agree = (logits.argmax(-1) == codes).float().mean().item()
    check(agree >= 0.9, f"decode: teacher-forced argmax agrees on {agree:.3f} of the codes")
    print(f"train: plm_infer from the trained weights, 16 greedy codes x 2; the teacher-forced "
          f"forward picks the same code at {agree:.3f} of the steps")
    return launches


def _gan_batch(tokens_lens: list, Tp: int, Tt: int, mel_target_lens: list, Tm: int, vocab: int,
               seed: int) -> dict:
    """A GAN batch in GANBatchBuilder's format, as ``tools/profile_train.py``
    builds it: durations 1-8, fp32 mels; the lengths are the caller's."""
    rng = np.random.RandomState(seed)
    B = len(tokens_lens)
    return {"duration_tokens": rng.randint(1, 9, (B, Tp)).astype(np.int32),
            "phone_tokens": rng.randint(0, vocab, (B, Tp)).astype(np.int32),
            "tokens_lens": np.asarray(tokens_lens, np.int32),
            "mel_timbres": rng.randn(B, Tt, 80).astype(np.float32),
            "mel_targets": rng.randn(B, Tm, 80).astype(np.float32),
            "mel_target_lens": np.asarray(mel_target_lens, np.int32)}


# parameters whose true gradient is 0 (softmax's shift invariance for the
# key bias; a train-mode BatchNorm after the D's first two convs): Adam
# turns their rounding residue into steps of up to ~lr either way
ZERO_GRAD = ("w_k.bias", "conv.0.bias", "conv.1.bias")


def phase_gan_reference(dev: torch.device) -> None:
    """Small fp32 G + D, the MRTE at head dim 64 with use_flash: 3 GAN steps
    on the card (kernels B and C, SIMT at fp32) and on the CPU (plain
    versions) from the same seeded weights, with the CPU run's dropout
    masks, codebook samples and window starts replayed on the card.  The
    first step has lr 0 (warmup 1), so its gradients are the initial
    weights'."""
    from megatts2_tpu_torch import config as c
    from megatts2_tpu_torch.nn import Draws
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.training import create_gan_state, make_gan_train_step

    g_cfg = c.MegaGConfig(
        mrte=c.MRTEConfig(mel_stride=4, mel_n_layer=1, mel_n_stack=1, mel_n_block=1,
                          content_ff_dim=64, content_n_heads=2, content_n_layers=2,
                          hidden_size=128, phone_vocab_size=40, use_flash=True),
        vqpe=c.VQPEConfig(hidden_size=32, kernel_size=3, n_layers=1, n_stacks=1, n_blocks=1,
                          vq_bins=32, vq_dim=16),
        kernel_size=3, hidden_size=32, decoder_n_stack=1, decoder_n_block=1)
    d_cfg = c.DiscriminatorConfig(time_lengths=(8, 16), hidden_size=8)
    lr = 1e-3
    tcfg = c.TrainConfig(warmup_steps=1, initial_learning_rate=lr, train_dtype="float32",
                         max_steps=100)
    batch = _gan_batch([12, 7, 3], 12, 48, [40, 12, 30], 64, 40, SEED + 8)
    out, recorded = {}, None
    for d in (torch.device("cpu"), dev):
        st = create_gan_state(g_cfg, d_cfg, tcfg, device=d)
        st.draws = (Draws(torch.Generator().manual_seed(SEED), torch.Generator().manual_seed(SEED),
                          record=True) if recorded is None else Draws(replay=recorded))
        step = make_gan_train_step(g_cfg, d_cfg, tcfg)
        fb, bb = att.flash_attention_cuda.launches, att.flash_attention_bwd_cuda.launches
        metrics = [{k: float(v) for k, v in step(st, batch).items()}]
        grads = {f"{n}.{p}": q.grad.cpu() for n, m in (("g", st.g), ("d", st.d))
                 for p, q in m.named_parameters()}
        metrics += [{k: float(v) for k, v in step(st, batch).items()} for _ in range(2)]
        launched = (att.flash_attention_cuda.launches - fb, att.flash_attention_bwd_cuda.launches - bb)
        state = {f"{n}.{p}": q.detach().cpu() for n, m in (("g", st.g), ("d", st.d))
                 for p, q in list(m.named_parameters()) + list(m.named_buffers())}
        out[d.type] = metrics, grads, state, launched
        recorded = recorded or st.draws.recorded
        del st
    (m0, g0, s0, _), (m1, g1, s1, launched) = out["cpu"], out["cuda"]
    check(launched[0] > 0 and launched[1] > 0, f"GAN reference: kernels B, C not launched {launched}")
    for a, b in zip(m1, m0):
        check(all(np.isclose(a[k], b[k], rtol=1e-4, atol=1e-6) for k in b),
              f"GAN reference: metrics {a} vs {b}")
    g_top = max(g.abs().max().item() for g in g0.values())
    g_err = max((g1[n] - g).abs().max().item() for n, g in g0.items())
    params = {n for n, _ in g0.items()}
    p_err = max((s1[n] - s0[n]).abs().max().item() for n in params if not n.endswith(ZERO_GRAD))
    z_err = max((s1[n] - s0[n]).abs().max().item() for n in params if n.endswith(ZERO_GRAD))
    b_err = max(((s1[n] - s0[n]).abs().max() / s0[n].abs().max().clamp(min=1e-30)).item()
                for n in s0 if n not in params)
    check(g_err <= 1e-4 * g_top, f"GAN reference: gradients err {g_err}, max {g_top}")
    check(p_err <= 0.05 * 2 * lr and z_err <= 2.1 * 2 * lr,
          f"GAN reference: params err {p_err}, zero-gradient params {z_err}")
    check(b_err <= 1e-4, f"GAN reference: codebook / running statistics rel err {b_err}")
    print(f"GAN reference fp32 small G + D (MRTE head dim 64, use_flash), card vs CPU, 3 steps with "
          f"the CPU's draws replayed: metrics within rtol 1e-4 (G_loss_total "
          f"{[round(m['G_loss_total'], 6) for m in m1]} vs {[round(m['G_loss_total'], 6) for m in m0]}); "
          f"gradients max_abs_err {g_err:.3g} of max {g_top:.3g} (rel 1e-4); params {p_err:.3g} "
          f"(atol {0.05 * 2 * lr:.3g}), zero-gradient params {z_err:.3g} (atol {2.1 * 2 * lr:.3g}); "
          f"codebook and running statistics rel {b_err:.3g} (1e-4); launches fwd {launched[0]} "
          f"bwd {launched[1]}")


def _group(name: str) -> str:
    if "mel_kernel" in name or "mel_bwd" in name:
        return "kernel A"
    if "flash_" in name:
        return "attention B, C"
    if re.search(r"fft", name, re.I):
        return "fft"
    if re.search(r"conv|cudnn|fprop|dgrad|wgrad|implicit", name, re.I):
        return "conv"
    if re.search(r"gemm|xmma|cutlass|cublas|nvjet|sm90_", name):
        return "matmul"
    return "other"


def phase_gan_train(dev: torch.device, card: str, root: str) -> dict:
    """The full-width GAN step (``configs/config_gan.yaml``'s G and D, bf16
    over fp32 masters) through ``run_training`` for 6 steps on one batch of
    ``tools/profile_train.py``'s geometry, as shipped (plain attention) and
    with ``use_flash`` (kernel B's and C's counters set to 0 just before
    and read just after)."""
    from megatts2_tpu_torch import config as c
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.tools.kernel_times import trace_kernels
    from megatts2_tpu_torch.training import (create_gan_state, make_gan_eval_step,
                                             make_gan_train_step, run_training)

    d_cfg, tcfg = c.DiscriminatorConfig(), c.TrainConfig(train_dtype="bfloat16")
    batch = _gan_batch([GAN_TP] * GAN_B, GAN_TP, 512, [512] * GAN_B, 512, 320, SEED + 9)
    res = {}
    for label, flash in (("as shipped, plain attention", False), ("use_flash", True)):
        g_cfg = c.MegaGConfig(mrte=c.MRTEConfig(use_flash=flash))
        t0 = time.perf_counter()
        st = create_gan_state(g_cfg, d_cfg, tcfg, device=dev)
        n_g = sum(p.numel() for p in st.g.parameters())
        n_d = sum(p.numel() for p in st.d.parameters())
        print(f"gan {label}: full-width G {n_g} + D {n_d} fp32 parameters, built in "
              f"{time.perf_counter() - t0:.1f} s")
        step, evaluate = make_gan_train_step(g_cfg, d_cfg, tcfg), make_gan_eval_step(g_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in (att.flash_attention_cuda, att.flash_attention_bwd_cuda):
            fn.launches = fn.tc_launches = 0
        name = "gan_flash" if flash else "gan_plain"
        log_dir = os.path.join(root, "logs")
        run_training(name, st, step, lambda epoch: [batch], max_steps=6, log_dir=log_dir,
                     log_every=1, val_every=6, eval_step=evaluate,
                     valid_loader_factory=lambda epoch: [batch])
        torch.cuda.synchronize()
        launches = {"flash": att.flash_attention_cuda.launches,
                    "flash_tc": att.flash_attention_cuda.tc_launches,
                    "flash_bwd": att.flash_attention_bwd_cuda.launches,
                    "flash_bwd_tc": att.flash_attention_bwd_cuda.tc_launches}
        print(f"gan {label}: launches on this path {launches}")
        if flash:
            check(launches["flash"] > 0 and launches["flash_tc"] > 0 and launches["flash_bwd"] > 0,
                  f"gan use_flash: kernel B, its tensor-core path or kernel C was not launched: {launches}")
            check(launches["flash_bwd_tc"] == launches["flash_bwd"] == 8 * 6,
                  f"gan use_flash: kernel C must take the tensor cores at Dh 256, 8 a step: {launches}")
        else:
            check(sum(launches.values()) == 0, f"gan as shipped: attention kernels launched {launches}")
        with open(os.path.join(log_dir, f"{name}_metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        train = [r for r in rows if "train/G_loss_total" in r]
        val = [r["val/loss_re"] for r in rows if "val/loss_re" in r]
        keys = [k for k in train[0] if k.startswith("train/") and k != "train/host_rss_gb"]
        check(len(train) == 6 and all(np.isfinite(r[k]) for r in train for k in keys),
              f"gan {label}: metrics {train}")
        check(all(r["train/vq_code_usage"] > 0 for r in train), f"gan {label}: dead codebook")
        check(len(val) == 1 and np.isfinite(val[0]), f"gan {label}: eval loss_re {val}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"gan {label}: G_loss_total {[round(r['train/G_loss_total'], 4) for r in train]}, "
              f"D_loss_total {[round(r['train/D_loss_total'], 4) for r in train]}, vq_code_usage "
              f"{[round(r['train/vq_code_usage'], 4) for r in train]}; eval loss_re {val[0]:.4f}")
        ms = _steps_ms(step, st, batch)
        kernels = trace_kernels(lambda: step(st, batch))
        groups = dict.fromkeys(("conv", "matmul", "attention B, C", "other"), 0.0)
        for kname, t in kernels.items():
            groups[_group(kname)] = groups.get(_group(kname), 0.0) + t
        busy = sum(groups.values())
        top = [(kname[:48], round(t, 3)) for kname, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:5]]
        print(f"gan {label}: warm step {ms:.2f} ms (B={GAN_B}, 512 + 512 frames), peak device memory "
              f"{peak:.2f} GiB [{card}]")
        print(f"gan {label}: trace of a warm step (torch.profiler), device ms by kernel group "
              f"{ {k: round(v, 3) for k, v in groups.items()} }, busy {busy:.2f} of {ms:.2f} ms "
              f"({1 - busy / ms:.1%} idle), {len(kernels)} kernel names; top {top} [{card}]")
        res[flash] = {"ms": ms, "peak": peak, "launches": launches, "groups": groups}
        del st, step, evaluate
        torch.cuda.empty_cache()
    print(f"gan: warm step ms, plain attention {res[False]['ms']:.2f}, use_flash {res[True]['ms']:.2f} "
          f"[{card}]")
    return res[True]["launches"]


def _vocoder_batch(B: int, frames: int, seed: int) -> dict:
    """``tools/profile_train.py``'s vocoder batch: ``randn`` crops of frames · 256 samples."""
    return {"wav": np.random.RandomState(seed).randn(B, frames * 256).astype(np.float32)}


def phase_vocoder_reference(dev: torch.device) -> None:
    """Small fp32 vocoder GAN steps on the card (kernel A's forward and
    backward) and on the CPU (plain) from the same seeded weights: 3 with a
    Vocos G, then 1 with a HiFi-GAN G."""
    from megatts2_tpu_torch import config as c
    from megatts2_tpu_torch.ops import mel
    from megatts2_tpu_torch.training import create_vocoder_state, make_vocoder_train_step

    d_cfg = c.WaveDiscConfig(periods=(2, 3), msd_scales=2, mpd_base_ch=4, msd_base_ch=8, max_ch=16)
    lr = 1e-3
    tcfg = c.VocoderTrainConfig(initial_learning_rate=lr, segment_frames=8, train_dtype="float32")
    batch = {"wav": 0.3 * _vocoder_batch(2, 8, SEED + 10)["wav"]}
    for label, g_cfg, steps in (
            ("Vocos", c.VocosConfig(dim=16, intermediate_dim=48, num_layers=2), 3),
            ("HiFi-GAN", c.HiFiGANConfig(upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                                         resblock_dilation_sizes=((1, 3), (1, 2))), 1)):
        runs = []
        for d in (torch.device("cpu"), dev):
            st = create_vocoder_state(g_cfg, d_cfg, tcfg, device=d)
            step = make_vocoder_train_step(g_cfg, d_cfg, tcfg)
            fwd, bwd = mel.mel_spectrogram_cuda.launches, mel.mel_spectrogram_bwd_cuda.launches
            metrics = [{k: float(v) for k, v in step(st, batch).items()}]
            grads = {f"{n}.{p}": q.grad.cpu() for n, m in (("g", st.g), ("d", st.d))
                     for p, q in m.named_parameters()}
            metrics += [{k: float(v) for k, v in step(st, batch).items()} for _ in range(steps - 1)]
            launched = (mel.mel_spectrogram_cuda.launches - fwd, mel.mel_spectrogram_bwd_cuda.launches - bwd)
            params = {f"{n}.{p}": q.detach().cpu() for n, m in (("g", st.g), ("d", st.d))
                      for p, q in m.named_parameters()}
            runs.append((metrics, grads, params, launched))
            del st
        (m0, g0, p0, _), (m1, g1, p1, launched) = runs
        check(launched[0] > 0 and launched[1] > 0,
              f"vocoder reference {label}: kernel A forward/backward not launched {launched}")
        for a, b in zip(m1, m0):
            check(all(np.isclose(a[k], b[k], rtol=1e-4, atol=1e-6) for k in b),
                  f"vocoder reference {label}: metrics {a} vs {b}")
        # gradients: fp32 sums in other orders (cuDNN, kernel A); parameters:
        # Adam moves each by ~lr whatever its gradient's size, so 0.05 of two
        # updates' movement
        g_top = max(g.abs().max().item() for g in g0.values())
        g_err = max((g1[n] - g).abs().max().item() for n, g in g0.items())
        p_err = max((p1[n] - p).abs().max().item() for n, p in p0.items())
        check(g_err <= 1e-4 * g_top, f"vocoder reference {label}: gradients err {g_err}, max {g_top}")
        check(p_err <= 0.05 * 2 * lr, f"vocoder reference {label}: params err {p_err}")
        print(f"vocoder reference fp32 small {label} G + wave D, card vs CPU, {steps} steps: metrics "
              f"within rtol 1e-4 (G_loss_total {[round(m['G_loss_total'], 6) for m in m1]} vs "
              f"{[round(m['G_loss_total'], 6) for m in m0]}); gradients max_abs_err {g_err:.3g} of max "
              f"{g_top:.3g} (rel 1e-4); params {p_err:.3g} (atol {0.05 * 2 * lr:.3g}); kernel A "
              f"launches fwd {launched[0]} bwd {launched[1]}")


def phase_vocoder_train(dev: torch.device, card: str, root: str) -> dict:
    """``configs/config_vocoder.yaml`` as shipped (its values are the
    dataclasses' defaults: Vocos dim 512, intermediate 1536, 8 layers;
    periods 2, 3, 5, 7, 11 and 3 scales; bf16; segment_frames 64) through
    ``run_training`` for 6 steps and an eval, kernel A's counters set to 0
    just before and read just after."""
    from megatts2_tpu_torch import config as c
    from megatts2_tpu_torch.ops import mel
    from megatts2_tpu_torch.tools.kernel_times import trace_kernels
    from megatts2_tpu_torch.training import (create_vocoder_state, make_vocoder_eval_step,
                                             make_vocoder_train_step, run_training)

    g_cfg, d_cfg, tcfg = c.VocosConfig(), c.WaveDiscConfig(), c.VocoderTrainConfig()
    batch = _vocoder_batch(VOC_B, tcfg.segment_frames, 0)
    t0 = time.perf_counter()
    st = create_vocoder_state(g_cfg, d_cfg, tcfg, device=dev)
    n_g = sum(p.numel() for p in st.g.parameters())
    n_d = sum(p.numel() for p in st.d.parameters())
    print(f"vocoder: full-width Vocos G {n_g} + MPD/MSD D {n_d} fp32 parameters, built in "
          f"{time.perf_counter() - t0:.1f} s")
    step, evaluate = make_vocoder_train_step(g_cfg, d_cfg, tcfg), make_vocoder_eval_step(g_cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mel.mel_spectrogram_cuda.launches = mel.mel_spectrogram_bwd_cuda.launches = 0
    log_dir = os.path.join(root, "logs")
    run_training("vocoder", st, step, lambda epoch: [batch], max_steps=6, log_dir=log_dir,
                 log_every=1, val_every=6, eval_step=evaluate, valid_loader_factory=lambda epoch: [batch])
    torch.cuda.synchronize()
    launches = {"mel": mel.mel_spectrogram_cuda.launches, "mel_bwd": mel.mel_spectrogram_bwd_cuda.launches}
    print(f"vocoder: kernel A launches on this path {launches} (6 steps: 2 forward and 1 backward "
          f"each; the eval: 2 forward)")
    check(launches["mel"] > 0 and launches["mel_bwd"] > 0,
          f"vocoder: kernel A's forward or backward was not launched: {launches}")
    with open(os.path.join(log_dir, "vocoder_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if "train/G_loss_total" in r]
    val = [r["val/loss"] for r in rows if "val/loss" in r]
    keys = [k for k in train[0] if k.startswith("train/") and k != "train/host_rss_gb"]
    check(len(train) == 6 and all(np.isfinite(r[k]) for r in train for k in keys),
          f"vocoder: metrics {train}")
    check(len(val) == 1 and np.isfinite(val[0]), f"vocoder: eval loss {val}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"vocoder: G_loss_total {[round(r['train/G_loss_total'], 4) for r in train]}, D_loss_total "
          f"{[round(r['train/D_loss_total'], 4) for r in train]}, G_loss_mel "
          f"{[round(r['train/G_loss_mel'], 4) for r in train]}; eval mel L1 {val[0]:.4f}")
    ms = _steps_ms(step, st, batch)
    kernels = trace_kernels(lambda: step(st, batch))
    groups = dict.fromkeys(("conv", "matmul", "fft", "kernel A", "other"), 0.0)
    for kname, t in kernels.items():
        groups[_group(kname)] = groups.get(_group(kname), 0.0) + t
    busy = sum(groups.values())
    top = [(kname[:48], round(t, 3)) for kname, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]]
    print(f"vocoder: warm step {ms:.2f} ms (B={VOC_B}, {tcfg.segment_frames} frames, "
          f"{VOC_B * tcfg.segment_frames * 256} samples), peak device memory {peak:.2f} GiB [{card}]")
    print(f"vocoder: trace of a warm step (torch.profiler), device ms by kernel group "
          f"{ {k: round(v, 3) for k, v in groups.items()} }, busy {busy:.2f} of {ms:.2f} ms "
          f"({1 - busy / ms:.1%} idle), {len(kernels)} kernel names; top {top} [{card}]")
    del st, step, evaluate
    torch.cuda.empty_cache()
    return launches


PIPE_SPK, PIPE_UTT, PIPE_DURS = 4, 12, (2.5, 6.0)  # the pipeline phase's synthetic corpus
# the pipeline's fits: (stage, shipped config, max_steps, val_check_interval); the
# gan stage resumes to GAN_RESUME, the adm stage is traced (steps 10-12)
PIPE_FITS = (("gan", "configs/config_gan.yaml", 4, 4), ("plm", "configs/config_plm.yaml", 4, 4),
             ("adm", "configs/config_adm.yaml", 14, 14),
             ("vocoder", "configs/config_vocoder.yaml", 4, 4))
GAN_RESUME = 6


# the ADM's extra fit after the shipped ones: use_flash under its adm block and
# train_dtype bfloat16 (the shipped float32 sends B and C to their SIMT route),
# to hold the ADM's bf16 tensor-core route through the CLI
ADM_FLASH_STEPS = 4


def _pipeline_config(shipped: str, out: str, ds: str, steps: int, val: int,
                     use_flash: str = None, train_dtype: str = None) -> str:
    """``shipped`` with only max_steps, val_check_interval,
    log_every_n_steps (1) and ds_path overridden, ``use_flash: true`` under
    the block named ``use_flash`` (``mrte``, ``adm``) and train_dtype when
    asked; written to ``out``."""
    with open(shipped) as f:
        text = f.read()
    for key, value in (("max_steps", steps), ("val_check_interval", val),
                       ("log_every_n_steps", 1), ("ds_path", ds + "/"), ("train_dtype", train_dtype)):
        if value is None:
            continue
        text, n = re.subn(rf"^(\s*){key}:.*$", rf"\g<1>{key}: {value}", text, count=1, flags=re.M)
        check(n == 1, f"{shipped}: no {key} to override")
    if use_flash:
        text, n = re.subn(rf"^(\s*){use_flash}:\n", rf"\g<1>{use_flash}:\n\g<1>  use_flash: true\n",
                          text, count=1, flags=re.M)
        check(n == 1, f"{shipped}: no {use_flash} block")
    with open(out, "w") as f:
        f.write(text)
    return out


def _launches() -> dict:
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.ops import mel

    return {"A": mel.mel_spectrogram_cuda.launches, "A_bwd": mel.mel_spectrogram_bwd_cuda.launches,
            "B": att.flash_attention_cuda.launches, "B_tc": att.flash_attention_cuda.tc_launches,
            "C": att.flash_attention_bwd_cuda.launches,
            "C_tc": att.flash_attention_bwd_cuda.tc_launches}


def _zero_launches() -> None:
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.ops import mel

    mel.mel_spectrogram_cuda.launches = mel.mel_spectrogram_bwd_cuda.launches = 0
    for fn in (att.flash_attention_cuda, att.flash_attention_bwd_cuda):
        fn.launches = fn.tc_launches = 0
    att.flash_attention_cuda.causal_launches = 0


def _pipeline_step(label: str, card: str, fn, log: tuple = None, ckpt_dir: str = None):
    """Run ``fn`` with every kernel counter at 0 and the peak memory reset;
    print the step's line: wall, the loop's steps, median step ms and loader
    wait (``run_training``'s ``loop/`` row in ``log`` = (dir, name)), peak
    memory, the newest checkpoint's MiB and the launches (B split into its
    tensor-core and SIMT routes, and so is C).  Returns (fn's result, launches, loop row)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    loop, extra = None, ""
    if log is not None:
        with open(os.path.join(log[0], f"{log[1]}_metrics.jsonl")) as f:
            loop = [json.loads(line) for line in f if '"loop/steps"' in line][-1]
        extra = (f", {int(loop['loop/steps'])} steps, median step {loop['loop/step_ms_median']:.2f} ms, "
                 f"loader wait median {loop['loop/loader_wait_ms_median']:.3f} ms mean "
                 f"{loop['loop/loader_wait_ms_mean']:.3f} ms a step")
    if ckpt_dir is not None:
        from megatts2_tpu_torch.training.checkpoints import latest_checkpoint

        latest = latest_checkpoint(ckpt_dir)
        extra += f", checkpoint {os.path.basename(latest)} {os.path.getsize(latest) / 2**20:.1f} MiB"
    print(f"pipeline {label}: wall {wall:.2f} s{extra}, peak memory {peak:.2f} GiB, launches A "
          f"{n['A']} A_bwd {n['A_bwd']} B {n['B']} (tensor cores {n['B_tc']}, SIMT "
          f"{n['B'] - n['B_tc']}) C {n['C']} (tensor cores {n['C_tc']}, SIMT {n['C'] - n['C_tc']}) "
          f"[{card}]")
    return out, n, loop


def _metric_rows(log_dir: str, name: str, prefix: str) -> list:
    with open(os.path.join(log_dir, f"{name}_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if any(k.startswith(prefix) for k in r)]


def _path_wrappers() -> dict:
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.ops import mel

    return {"A": mel.mel_spectrogram_cuda, "A_bwd": mel.mel_spectrogram_bwd_cuda,
            "B": att.flash_attention_cuda, "C": att.flash_attention_bwd_cuda}


def _ragged_lens(B: int, T: int, dev: torch.device) -> torch.Tensor:
    """Key lengths that reach the full length, partial tiles and 1."""
    return torch.tensor([max(1, x) for x in ([T, T - 5, T // 3 + 1, 1] * B)[:B]], dtype=torch.int32,
                        device=dev)


def _check_stage1_features(dev: torch.device, ds: str, card: str, phase: str = "pipeline") -> None:
    """Stage 1's stored features (kernel A's mels, stored fp16) against the
    plain mel of the same bucket-padded signals on the card, cut to each
    cut's frames: within ATOL_MEL plus one fp16 ulp of the plain value.
    ``phase`` names the phase in what is printed."""
    from megatts2_tpu_torch.data import CutManifest, FeatureReader
    from megatts2_tpu_torch.ops import mel
    from megatts2_tpu_torch.prepare_ds import SAMPLE_BUCKET
    from megatts2_tpu_torch.utils.audio import load_wav

    reader, worst, worst_abs, frames, n = FeatureReader(), 0.0, 0.0, 0, 0
    for split in ("train", "valid"):
        for cut in CutManifest.load(os.path.join(ds, f"cuts_{split}.jsonl.gz")).cuts:
            y = load_wav(cut.wav_path)
            bucket = -(-y.shape[-1] // SAMPLE_BUCKET) * SAMPLE_BUCKET
            sig = torch.from_numpy(np.pad(y, (0, bucket - y.shape[-1]))).to(dev)
            ref = mel.mel_spectrogram_plain(sig)[: cut.num_frames].cpu().numpy()
            got = reader.read(cut.feats_path, cut.feats_offset, cut.num_frames)
            ulp = np.spacing(np.abs(ref).astype(np.float16)).astype(np.float32)
            excess = float((np.abs(got - ref) - ulp).max())
            check(got.shape == ref.shape and excess <= ATOL_MEL,
                  f"{phase} stage 1 {cut.id}: features {got.shape} vs {ref.shape}, "
                  f"{excess} over one fp16 ulp")
            worst, frames, n = max(worst, excess), frames + cut.num_frames, n + 1
            worst_abs = max(worst_abs, float(np.abs(got - ref).max()))
    print(f"{phase} stage 1 features: {n} cuts, {frames} frames, kernel A's fp16 mels against the "
          f"plain mel of the same padded signals on the card: max_abs_err {worst_abs:.3g}, max excess "
          f"over one fp16 ulp {worst:.3g} (atol {ATOL_MEL}) [{card}]")


def _check_path_shapes(dev: torch.device, shapes: dict, err: dict, card: str,
                       phase: str = "pipeline") -> None:
    """Each kernel against its plain version at every launch signature the
    ``phase`` gave it (the wrappers' ``shapes`` sets), on random inputs, on
    the route the path took, with ragged key lengths where it gave lengths."""
    from megatts2_tpu_torch.ops import attention as att
    from megatts2_tpu_torch.ops import mel

    gen = torch.Generator().manual_seed(SEED + 1)
    worst = dict.fromkeys(shapes, 0.0)
    for B, n in sorted(shapes["A"]):
        y = (torch.randn(B, n, generator=gen) * 0.1).to(dev)
        e = (mel.mel_spectrogram_cuda(y) - mel.mel_spectrogram_plain(y)).abs().max().item()
        check(e <= ATOL_MEL, f"{phase} shape mel ({B}, {n}): err {e}")
        worst["A"] = max(worst["A"], e)
    for B, n in sorted(shapes["A_bwd"]):
        y = (torch.randn(B, n, generator=gen) * 0.1).to(dev)
        g_mel = torch.randn(B, mel.num_frames(n), 80, generator=gen).to(dev)
        ref = mel.mel_spectrogram_bwd_plain(y, g_mel)
        e, top = (mel.mel_spectrogram_bwd_cuda(y, g_mel) - ref).abs().max().item(), ref.abs().max().item()
        check(e <= REL_MEL_BWD * top, f"{phase} shape mel bwd ({B}, {n}): err {e}, max {top}")
        worst["A_bwd"] = max(worst["A_bwd"], e)
    for B, Tq, Tk, H, dh, dtype, causal, tc, has_lens, stats in sorted(shapes["B"], key=str):
        q = torch.randn(B, Tq, H, dh, generator=gen).to(dev, dtype)
        k, v = (torch.randn(B, Tk, H, dh, generator=gen).to(dev, dtype) for _ in range(2))
        lens = _ragged_lens(B, Tk, dev) if has_lens else None
        tc0 = att.flash_attention_cuda.tc_launches
        got = att.flash_attention_cuda(q, k, v, lens, causal, return_stats=stats, simt=not tc)
        ref = att.flash_attention_plain(q, k, v, lens, causal, return_stats=True)
        e = ((got[0] if stats else got).float() - ref[0].float()).abs().max().item()
        em = (got[1] - ref[1]).abs().max().item() if stats else 0.0
        el = ((got[2] - ref[2]).abs() / ref[2]).max().item() if stats else 0.0
        check(att.flash_attention_cuda.tc_launches - tc0 == int(tc)
              and e <= ATOL_ATT[dtype] and em <= ATOL_M and el <= RTOL_L,
              f"{phase} shape flash {(B, Tq, Tk, H, dh)} {dtype} causal={causal}: err {e}, m {em}, l {el}")
        worst["B"] = max(worst["B"], e)
    for B, Tq, Tk, H, dh, dtype, causal, tc, has_lens in sorted(shapes["C"], key=str):
        q, g = (torch.randn(B, Tq, H, dh, generator=gen).to(dev, dtype) for _ in range(2))
        k, v = (torch.randn(B, Tk, H, dh, generator=gen).to(dev, dtype) for _ in range(2))
        lens = _ragged_lens(B, Tk, dev) if has_lens else None
        _, m, l = att.flash_attention_cuda(q, k, v, lens, causal, return_stats=True)
        tc0 = att.flash_attention_bwd_cuda.tc_launches
        got = att.flash_attention_bwd_cuda(q, k, v, lens, causal, g, m, l, simt=not tc)
        ge = _rel_errs(got, att.flash_attention_bwd_plain(q, k, v, lens, causal, g, m, l))
        check(att.flash_attention_bwd_cuda.tc_launches - tc0 == int(tc)
              and all(a <= REL_BWD[dtype] * t for a, t in ge),
              f"{phase} shape flash bwd {(B, Tq, Tk, H, dh)} {dtype} causal={causal}: {ge}")
        worst["C"] = max(worst["C"], *(a for a, _ in ge))
    torch.cuda.synchronize()
    for name, key in (("A", "mel"), ("A_bwd", "mel_bwd"), ("B", "flash"), ("C", "flash_bwd")):
        err[key] = max(err[key], worst[name])
        sigs = [", ".join(map(str, sig[:5])) + (f" {str(sig[5])[6:]}" if len(sig) > 5 else "")
                for sig in sorted(shapes[name], key=str)]
        print(f"{phase} shapes {name}: {len(sigs)} launch signatures held against the plain version, "
              f"max_abs_err {worst[name]:.3g}: ({'), ('.join(sigs)}) [{card}]")


def phase_pipeline(dev: torch.device, card: str, root: str, err: dict) -> dict:
    """Dataset preparation and the training CLI as a user runs them, on the
    card: a synthetic corpus, ``prepare_ds`` stages 0 and 1, ``cli fit`` of
    the gan stage (``use_flash``) and its resume, stage 2 from its
    checkpoint, then ``cli fit`` of plm, adm (traced) and vocoder, each on
    the shipped config at full width, and a short fit of the ADM with
    ``use_flash`` in bf16.  Every launch signature of kernels A,
    B and C on that path is recorded and, after the path, held against the
    plain version (its worst error folded into ``err``); stage 1's stored
    features are held against the plain mel.  Returns each step's
    launches."""
    import shutil

    from megatts2_tpu_torch import cli, prepare_ds
    from megatts2_tpu_torch.config import load_gan_config
    from megatts2_tpu_torch.data import CutManifest
    from megatts2_tpu_torch.tools.synth_corpus import build_corpus

    base = os.path.join(root, "pipeline")
    os.makedirs(base)
    t0 = time.perf_counter()
    wavs, tgs = build_corpus(base, PIPE_SPK, PIPE_UTT, SEED, PIPE_DURS)
    n_utt = PIPE_SPK * PIPE_UTT
    print(f"pipeline corpus: {PIPE_SPK} speakers x {PIPE_UTT} utterances of {PIPE_DURS} s, "
          f"built in {time.perf_counter() - t0:.1f} s")
    ds = os.path.join(base, "ds")
    launches = {}
    wrappers = _path_wrappers()
    for fn in wrappers.values():
        fn.shapes = set()
    out, _, _ = _pipeline_step("stage 0", card, lambda: prepare_ds.main(
        ["--stage", "0", "--wavtxt_path", wavs, "--num_workers", "4"]))
    check(out == {"labs": n_utt}, f"stage 0: {out}")
    out, launches["stage 1"], _ = _pipeline_step("stage 1", card, lambda: prepare_ds.main(
        ["--stage", "1", "--wavtxt_path", wavs, "--text_grid_path", tgs, "--ds_path", ds]))
    check(out["cuts"] == n_utt and launches["stage 1"]["A"] == out["mel_batches"] > 0,
          f"stage 1: {out}, kernel A launches {launches['stage 1']['A']} (one a mel batch)")
    print(f"pipeline stage 1: {out['cuts']} cuts, {out['mel_batches']} mel batches (kernel A at up to "
          f"8 x 32768k samples), max_duration_token {out['max_duration_token']}")

    logs = os.path.join(base, "logs")
    fit_cfgs = {}
    for stage, shipped, steps, val in PIPE_FITS:
        fit_cfgs[stage] = _pipeline_config(shipped, os.path.join(base, f"{stage}.yaml"), ds, steps,
                                           val, use_flash="mrte" if stage == "gan" else None)
    ck = {stage: os.path.join(base, f"ck_{stage}") for stage, *_ in PIPE_FITS}

    def fit(stage, cfg, *extra):
        return lambda: cli.main(["fit", "-c", cfg, "--log_dir", logs, "--ckpt_dir", ck[stage],
                                 *extra])

    st, launches["fit gan"], loop = _pipeline_step("fit gan (use_flash)", card,
                                                   fit("gan", fit_cfgs["gan"]), (logs, "gan"), ck["gan"])
    check(st.step == 4 and loop["loop/steps"] == 4, f"fit gan: step {st.step}")
    val = [r["val/loss_re"] for r in _metric_rows(logs, "gan", "val/")]
    art = sorted(os.listdir(os.path.join(logs, "val_artifacts")))
    check(len(val) == 1 and np.isfinite(val[0]) and art in (["mel_step4.npz"], ["mel_step4.png"]),
          f"fit gan: validation {val}, artifacts {art}")
    n = launches["fit gan"]
    check(n["B"] > 0 and n["B_tc"] > 0 and n["C"] > 0, f"fit gan: B or C not launched {n}")
    del st
    resume_cfg = _pipeline_config("configs/config_gan.yaml", os.path.join(base, "gan_resume.yaml"), ds,
                                  GAN_RESUME, 4, use_flash="mrte")
    st, launches["fit gan resume"], loop = _pipeline_step(
        "fit gan resume", card, fit("gan", resume_cfg), (logs, "gan"), ck["gan"])
    check(st.step == GAN_RESUME and loop["loop/steps"] == GAN_RESUME - 4,
          f"gan resume: step {st.step}, {loop['loop/steps']} steps run")
    train = _metric_rows(logs, "gan", "train/")
    check([r["step"] for r in train] == list(range(1, GAN_RESUME + 1))
          and all(np.isfinite(v) for r in train for v in r.values()), f"fit gan: metrics {train}")
    print(f"pipeline fit gan: G_loss_re {[round(r['train/G_loss_re'], 4) for r in train]}, "
          f"val loss_re {val[0]:.4f}, artifacts {art}")
    del st
    torch.cuda.empty_cache()

    g_ckpt = os.path.join(ck["gan"], f"step_{GAN_RESUME}.ckpt")
    out, launches["stage 2"], _ = _pipeline_step("stage 2", card, lambda: prepare_ds.main(
        ["--stage", "2", "--ds_path", ds, "--generator_ckpt", g_ckpt,
         "--generator_config", fit_cfgs["gan"]]))
    n = launches["stage 2"]
    check(out == {"cuts": n_utt, "batches": -(-n_utt // 8)} and n["B"] > 0,
          f"stage 2: {out}, kernel B launches {n}")
    cut = CutManifest.load(os.path.join(ds, "cuts_train.jsonl.gz"))[0]
    lat = np.load(os.path.join(ds, "latents", cut.speaker, f"{cut.id}.npy"), allow_pickle=True).item()
    hidden = load_gan_config(fit_cfgs["gan"])[0].mrte.hidden_size
    check(lat["tc_latent"].shape == (1, len(cut.phone_tokens), hidden)
          and np.isfinite(lat["tc_latent"]).all()
          and lat["p_code"].shape == (1, 1, -(-sum(cut.duration_tokens) // 8)),
          f"stage 2: latent shapes {lat['tc_latent'].shape}, {lat['p_code'].shape}")
    shutil.rmtree(ck["gan"])

    trace = os.path.join(base, "trace")
    loops = {}
    for stage, _, steps, _ in PIPE_FITS[1:]:
        extra = ["--trace_dir", trace] if stage == "adm" else []
        st, launches[f"fit {stage}"], loops[stage] = _pipeline_step(
            f"fit {stage}" + (" (traced)" if extra else ""), card,
            fit(stage, fit_cfgs[stage], *extra), (logs, stage), ck[stage])
        train = _metric_rows(logs, stage, "train/")
        val = _metric_rows(logs, stage, "val/")
        check(st.step == steps and len(train) == steps and len(val) == 1
              and all(np.isfinite(v) for r in train + val for v in r.values()),
              f"fit {stage}: step {st.step}, metrics {train[-1:]}, {val}")
        key = "train/loss" if stage != "vocoder" else "train/G_loss_mel"
        print(f"pipeline fit {stage}: {key} {[round(r[key], 4) for r in train]}")
        del st
        shutil.rmtree(ck[stage])
        torch.cuda.empty_cache()
    label = "fit adm (use_flash, bf16)"
    cfg = _pipeline_config("configs/config_adm.yaml", os.path.join(base, "adm_flash.yaml"), ds,
                           ADM_FLASH_STEPS, ADM_FLASH_STEPS, use_flash="adm", train_dtype="bfloat16")
    logs_flash, ck["adm_flash"] = os.path.join(base, "logs_adm_flash"), os.path.join(base, "ck_adm_flash")
    st, launches[label], _ = _pipeline_step(
        label, card, lambda: cli.main(["fit", "-c", cfg, "--log_dir", logs_flash, "--ckpt_dir",
                                       ck["adm_flash"]]), (logs_flash, "adm"), ck["adm_flash"])
    train = _metric_rows(logs_flash, "adm", "train/")
    check(st.step == ADM_FLASH_STEPS and len(train) == ADM_FLASH_STEPS
          and all(np.isfinite(v) for r in train for v in r.values()), f"{label}: step {st.step}, {train[-1:]}")
    print(f"pipeline {label}: train/loss {[round(r['train/loss'], 4) for r in train]}")
    del st
    shutil.rmtree(ck["adm_flash"])
    torch.cuda.empty_cache()
    n = launches
    check(n["fit plm"]["B_tc"] > 0 and n["fit plm"]["C"] > 0, f"fit plm: B or C not launched {n['fit plm']}")
    adm = n[label]
    check(adm["B"] > 0 and adm["C"] > 0 and adm["B_tc"] == adm["B"] and adm["C_tc"] == adm["C"],
          f"{label}: B and C must launch, only on the tensor cores: {adm}")
    check(n["fit vocoder"]["A"] > 0 and n["fit vocoder"]["A_bwd"] > 0,
          f"fit vocoder: kernel A not launched {n['fit vocoder']}")
    traces = os.listdir(trace)
    check(traces == ["trace_steps_10-13.json"], f"trace: {traces}")
    size = os.path.getsize(os.path.join(trace, traces[0])) / 2**20
    print(f"pipeline trace: {traces[0]}, {size:.1f} MiB (fit adm, steps 10-12, CPU and CUDA activities)")
    shapes = {name: fn.shapes for name, fn in wrappers.items()}
    for fn in wrappers.values():
        fn.shapes = None
    _check_stage1_features(dev, ds, card)
    _check_path_shapes(dev, shapes, err, card)
    return launches


TOOLS_SPK, TOOLS_UTT = 4, 12  # bench_input_pipeline's corpus in the tools phase
TOOLS_HTTP = (8, 4, 8.0)  # http_bench's requests, clients, offered rps
TOOLS_LOADER_BATCHES, TOOLS_GAN_STEPS, TOOLS_LM_STEPS = 10, 4, 2
# long_train: checkpoints every 4 steps, killed once the log reaches step 6
# (two or more steps past the checkpoint it resumes from, so the log's step
# sequence jumps back, as long_run_summary counts a resume), resumed to 10
LONG_STEPS, LONG_VAL, LONG_KILL = 10, 4, 6


def _numbers(x, skip=()) -> list:
    """The numbers in a record, but for those under a key in ``skip``."""
    if isinstance(x, dict):
        return [v for k, val in x.items() if k not in skip for v in _numbers(val, skip)]
    if isinstance(x, (list, tuple)):
        return [v for val in x for v in _numbers(val, skip)]
    return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) else []


def _tool(label: str, card: str, fn, *args, carded: bool = True, **kwargs) -> tuple:
    """``fn(*args, emit=..., **kwargs)`` with every kernel counter at 0: its
    JSON lines printed under ``label`` and parsed; every number in them
    finite and, when ``carded``, each line naming the card and its power
    limit.  Returns (fn's result, the launches)."""
    lines = []

    def emit(line: str) -> None:
        print(f"tools {label}: {line}")
        lines.append(json.loads(line))

    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    out = fn(*args, emit=emit, **kwargs)
    torch.cuda.synchronize()
    n = _launches()
    print(f"tools {label}: {time.perf_counter() - t0:.1f} s, launches A {n['A']} A_bwd {n['A_bwd']} "
          f"B {n['B']} (tensor cores {n['B_tc']}) C {n['C']} (tensor cores {n['C_tc']}) [{card}]")

    check(lines and all(np.isfinite(v) for rec in lines for v in _numbers(rec)),
          f"tools {label}: records {lines}")
    check(not carded or all(rec.get("device", rec.get("detail", {}).get("device")) == card
                            for rec in lines),
          f"tools {label}: a record without the card's name and power limit")
    torch.cuda.empty_cache()
    return out, n


def phase_tools(dev: torch.device, card: str, root: str, err: dict) -> dict:
    """The measurement tools of ``megatts2_tpu_torch/tools`` driven through
    their functions on the card: ``bench_train`` (all four stages at full
    width), ``profile_train gan`` (top 10), ``http_bench`` at full width,
    ``bench_input_pipeline`` on a 4 x 12 corpus (stages 0 and 1 at 1 and 2
    workers, the loader, loader-fed GAN steps), ``long_train`` on that corpus
    (killed past step LONG_KILL and resumed to LONG_STEPS), then
    ``bench_input_pipeline``'s stage 2 from that run's checkpoint and its
    loader-fed PLM and ADM steps; ``long_run_summary`` of the run's log.
    As in the pipeline phase, every launch signature of kernels A, B and C
    in this process is recorded and, after the tools, held against the
    plain version (its worst error folded into ``err``), and stage 1's
    stored features against the plain mel.  Returns each tool's launches."""
    from megatts2_tpu_torch.tools import (bench_input_pipeline, bench_train, http_bench,
                                          long_run_summary, long_train, profile_train)
    from megatts2_tpu_torch.training.checkpoints import latest_checkpoint

    def positive(recs, *keys):
        vals = [r.get(key, r.get("detail", {}).get(key)) for r in recs for key in keys]
        check(all(isinstance(x, (int, float)) and x > 0 for x in vals), f"tools: {keys} in {recs}")

    launches = {}
    wrappers = _path_wrappers()
    for fn in wrappers.values():
        fn.shapes = set()
    for stage in ("plm", "adm", "vocoder", "gan"):
        if stage in ("plm", "adm"):
            rec, n = _tool(f"bench_train {stage}", card, bench_train.bench_lm, stage, 8, dev)
            positive([rec], "value", "step_ms", "tokens_per_sec")
        elif stage == "vocoder":
            rec, n = _tool("bench_train vocoder", card, bench_train.bench_vocoder, 8, dev)
            positive([rec], "value", "step_ms", "audio_sec_per_sec")
        else:
            rec, n = _tool("bench_train gan", card, bench_train.bench_gan, 8, dev)
            positive([rec], "value", "step_ms", "mel_frames_per_sec", "gflop_per_step")
            mfu = rec["detail"]["mfu"]
            check(0 < mfu < 1, f"bench_train gan: mfu {mfu}")
        launches[f"bench_train {stage}"] = n
    n = launches["bench_train plm"]
    check(n["B"] == n["B_tc"] > 0 and n["C"] == n["C_tc"] > 0,
          f"bench_train plm: B and C must run on the tensor cores: {n}")
    n = launches["bench_train vocoder"]
    check(n["A"] > 0 and n["A_bwd"] > 0, f"bench_train vocoder: kernel A or its backward: {n}")

    recs, launches["profile_train gan"] = _tool(
        "profile_train gan", card, profile_train.profile, "gan", os.path.join(root, "trace_gan"), dev,
        top=10)
    window = recs[0]
    check(len(recs) == 11 and window["busy_ms"] > 0 and 0 <= window["idle_share"] < 1,
          f"profile_train gan: {window}")

    requests, clients, rps = TOOLS_HTTP
    rec, n = _tool("http_bench", card, http_bench.run, requests, clients, rps, device=dev)
    positive([rec], "achieved_rps", "p50_ms", "p90_ms", "p99_ms", "max_ms")
    check(rec["requests"] == requests and n["A"] > 0, f"http_bench: {rec}, launches {n}")
    launches["http_bench"] = n

    base = os.path.join(root, "tools")
    n_files = TOOLS_SPK * TOOLS_UTT
    (wavs, tgs, ds), _ = _tool("corpus", card, bench_input_pipeline.build_corpus, base,
                                  TOOLS_SPK, TOOLS_UTT, device=dev)
    _tool("stage 0", card, bench_input_pipeline.run_stage, 0, wavs, tgs, ds, 1, n_files, device=dev)
    for workers in (1, 2):
        rec, n = _tool(f"stage 1 ({workers} workers)", card, bench_input_pipeline.run_stage, 1,
                          wavs, tgs, ds, workers, n_files, device=dev)
        positive([rec], "files_per_s")
        check(rec["result"]["cuts"] == n_files and n["A"] == rec["result"]["mel_batches"] > 0,
              f"bench_input_pipeline stage 1: {rec}, kernel A launches {n['A']}")
        launches[f"bench_input_pipeline stage 1 ({workers})"] = n
    recs, _ = _tool("loader", card, bench_input_pipeline.bench_loader, ds, TOOLS_LOADER_BATCHES,
                       dev)
    positive(recs, "batches_per_s")
    check([r["native_ring"] for r in recs] == [True, False], f"bench_input_pipeline loader: {recs}")
    rec, launches["bench_input_pipeline gan"] = _tool(
        "gan steps", card, bench_input_pipeline.bench_gan_steps, ds, TOOLS_GAN_STEPS, dev)
    positive([rec], "steps_per_s")

    rec, launches["long_train"] = _tool("long_train", card, long_train.run, base, LONG_STEPS,
                                        LONG_VAL, LONG_KILL, device=dev, log_every=1)
    mpath = os.path.join(base, "logs50k", "gan_metrics.jsonl")
    check(len(rec["launches"]) == 2 and [x["rc"] for x in rec["launches"]] == [-9, 0]
          and rec["killed_at_step"] is not None and long_train.metrics_step(mpath) == LONG_STEPS,
          f"long_train: {rec}")
    summary, _ = _tool("long_run_summary", card, long_run_summary.summarize, mpath, carded=False)
    check(summary["max_step"] == LONG_STEPS and len(summary["resume_events"]) == 1,
          f"long_run_summary: {summary}")

    ckpt = latest_checkpoint(os.path.join(base, "ckpts50k", "gan"))
    rec, launches["bench_input_pipeline stage 2"] = _tool(
        "stage 2", card, bench_input_pipeline.bench_stage2, ds, ckpt, "configs/config_gan.yaml", dev)
    check(rec["result"]["cuts"] == n_files, f"bench_input_pipeline stage 2: {rec}")
    for stage in ("plm", "adm"):
        rec, n = _tool(f"{stage} steps", card, bench_input_pipeline.bench_lm_steps, stage, ds,
                          TOOLS_LM_STEPS, f"configs/config_{stage}.yaml", dev)
        positive([rec], "steps_per_s")
        launches[f"bench_input_pipeline {stage}"] = n
    n = launches["bench_input_pipeline plm"]
    check(n["B_tc"] > 0 and n["C_tc"] > 0, f"bench_input_pipeline plm: B and C on the tensor cores: {n}")
    shapes = {name: fn.shapes for name, fn in wrappers.items()}
    for fn in wrappers.values():
        fn.shapes = None
    _check_stage1_features(dev, ds, card, "tools")
    _check_path_shapes(dev, shapes, err, card, "tools")
    return launches


# the quality phase: train_curve's steps a stage and validation interval
# (one validation and one checkpoint a stage), its corpus of 2 x 8;
# at_scale_stack's 4 x 12 corpus and its steps a stage (gan, plm, adm, vocoder)
QUAL_STEPS, QUAL_UTT = 4, 8
STACK_SPK, STACK_UTT, STACK_STEPS = 4, 12, (4, 2, 2, 2)
# stage 2's stored latents (its own process) against the same batch here:
# cuDNN may pick other fp32 convolution algorithms in another process, and
# its default TF32 rounds their products to 10-bit mantissas (seen on an
# H100: 1.9e-3 and 2.2e-3); the raw weights after 4 steps were 0.18-0.27 off
ATOL_EMA_LATENT = 1e-2
# each tool's record: the JAX tool's keys, and the card's name under "device"
QUAL_KEYS = {
    "train_curve": {"corpus", "steps", "gan", "vocoder", "plm", "adm"},
    "e2e_quality": {"root", "text", "plm_decode", "speaker_f0_hz", "speakers", "n_speakers",
                    "timbre_classification_acc", "mcd_db_mean", "duration_mae_frames_mean",
                    "prompted_in_band_frac", "prompted_differs_frac", "timbre_transfer_ok",
                    "timbre_transfer_ok_threshold"},
    "int8_margins": {"ckpt", "positions", "batches", "margin_logits", "int8_perturbation_logits",
                     "teacher_forced_argmax_agreement", "at_risk_fraction_p99",
                     "at_risk_fraction_2x_p99"},
    "at_scale_stack": {"phase", "total_wall_s", "gan", "plm", "adm", "vocoder"},
    "heldout_eval": {"mode", "train_root", "heldout_root", "design", "speaker_f0_hz", "ckpts",
                     "ceiling_gt_codes", "greedy", "sampled", "duration_mae_frames", "rows",
                     "wall_s"},
}


def _quality_tool(label: str, card: str, main, argv: list) -> tuple:
    """``main(argv)`` with every kernel counter at 0 and its standard output
    captured: each line printed under ``label``, the JSON ones parsed; then
    its wall and launches.  Returns (main's result, the JSON lines, the
    launches, the wall)."""
    import contextlib
    import io

    torch.cuda.synchronize()
    _zero_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _launches()
    recs = []
    for line in buf.getvalue().splitlines():
        print(f"quality {label}: {line}")
        if line.startswith("{"):
            recs.append(json.loads(line))
    print(f"quality {label}: wall {wall:.1f} s, launches A {n['A']} A_bwd {n['A_bwd']} B {n['B']} "
          f"(tensor cores {n['B_tc']}) C {n['C']} (tensor cores {n['C_tc']}) [{card}]")
    torch.cuda.empty_cache()
    return out, recs, n, wall


def _check_quality_record(tool: str, rec: dict, card: str, nan_ok: tuple = ()) -> None:
    """The JAX tool's keys, the card named, every number finite (but those
    under ``nan_ok`` keys)."""
    check(set(rec) == QUAL_KEYS[tool] | {"device"} and rec["device"] == card,
          f"quality {tool}: keys {sorted(rec)} against the JAX tool's {sorted(QUAL_KEYS[tool])}")
    bad = [v for v in _numbers(rec, nan_ok) if not np.isfinite(v)]
    check(not bad, f"quality {tool}: numbers not finite {bad} in {rec}")


def _check_ema_latents(dev: torch.device, stack: str, card: str) -> None:
    """Stage 2 of ``at_scale_stack`` ran from the EMA generator: its first
    batch's stored latents against the best GAN checkpoint's ``g_ema``
    weights (loaded here by ``load_state_dict``, not by the loader) and its
    raw weights, on the same batch on the card."""
    from megatts2_tpu_torch.config import load_gan_config
    from megatts2_tpu_torch.data import CutManifest, GANBatchBuilder
    from megatts2_tpu_torch.models import MegaG
    from megatts2_tpu_torch.prepare_ds import LATENT_BATCH
    from megatts2_tpu_torch.training.checkpoints import (best_checkpoint, load_model_state_dict,
                                                         read_checkpoint)

    ds = os.path.join(stack, "ds")
    obj = read_checkpoint(best_checkpoint(os.path.join(stack, "ckpts50k", "gan")))
    g_cfg = load_gan_config(os.path.join(stack, "gan50k.yaml"))[0]
    raw = load_model_state_dict(MegaG(g_cfg), obj["state_dict"]).to(dev).eval()
    ema = load_model_state_dict(MegaG(g_cfg), obj["state_dict"])
    missing, unexpected = ema.load_state_dict(obj["g_ema"], strict=False)
    ema = ema.to(dev).eval()
    check(not unexpected and not set(missing) & set(dict(ema.named_parameters())),
          f"quality at_scale_stack: g_ema does not name G's parameters: {unexpected}, {missing}")
    moved = sum(not torch.equal(obj["g_ema"][n], p.cpu()) for n, p in raw.named_parameters())
    cuts = CutManifest.load(os.path.join(ds, "cuts_train.jsonl.gz"))
    cuts.cuts.extend(CutManifest.load(os.path.join(ds, "cuts_valid.jsonl.gz")).cuts)
    idxs = sorted(range(len(cuts)), key=lambda i: cuts[i].num_frames)[:LATENT_BATCH]
    b = GANBatchBuilder(cuts, ds)(idxs)
    args = (torch.from_numpy(b["phone_tokens"]).long().to(dev), torch.from_numpy(b["tokens_lens"]).to(dev),
            torch.from_numpy(b["mel_timbres"]).float().to(dev),
            torch.from_numpy(b["mel_targets"]).float().to(dev))
    with torch.no_grad():
        tc_ema, tc_raw = ema.s2_latent(*args)[0].cpu().numpy(), raw.s2_latent(*args)[0].cpu().numpy()
    err_ema = err_raw = 0.0
    for row, i in enumerate(idxs):
        lat = np.load(os.path.join(ds, "latents", cuts[i].speaker, f"{cuts[i].id}.npy"),
                      allow_pickle=True).item()["tc_latent"][0]
        tl = int(b["tokens_lens"][row])
        err_ema = max(err_ema, float(np.abs(lat - tc_ema[row, :tl]).max()))
        err_raw = max(err_raw, float(np.abs(lat - tc_raw[row, :tl]).max()))
    check(moved > 0 and err_ema <= ATOL_EMA_LATENT and 10 * err_ema < err_raw,
          f"quality at_scale_stack: stage 2's latents {err_ema} from g_ema's, {err_raw} from the raw "
          f"G's ({moved} parameters differ)")
    print(f"quality at_scale_stack stage 2: {len(idxs)} cuts' latents against the checkpoint's g_ema "
          f"weights max_abs_err {err_ema:.3g} (atol {ATOL_EMA_LATENT}), against its raw weights "
          f"{err_raw:.3g} ({moved} of {len(obj['g_ema'])} parameters differ) [{card}]")


def phase_quality(dev: torch.device, card: str, root: str, err: dict) -> dict:
    """The six quality tools of ``megatts2_tpu_torch/tools`` through their
    ``main(argv)`` on the card at full width (the shipped configs): in this
    process ``train_curve`` trains every stage (QUAL_STEPS steps) on its 2 x
    QUAL_UTT corpus, ``e2e_quality`` (float and int8) and ``quality_table``
    measure that stack, ``int8_margins`` its PLM; ``at_scale_stack`` trains
    a stack on a STACK_SPK x STACK_UTT corpus with the EMA generator (fits
    and stage 2 as subprocesses) and ``heldout_eval`` evaluates it on two
    held-out speakers.  Every record has the JAX tool's keys and finite
    numbers; stage 2 of the stack read the EMA generator.  As in the
    pipeline phase, every launch signature of kernels A, B and C in this
    process is recorded and, after the tools, held against the plain
    version (its worst error folded into ``err``).  Returns each tool's
    launches."""
    import shutil

    from megatts2_tpu_torch.tools import (at_scale_stack, e2e_quality, heldout_eval, int8_margins,
                                          quality_table, train_curve)

    base = os.path.join(root, "quality")
    curve, stack = os.path.join(base, "curve"), os.path.join(base, "stack")
    launches, walls = {}, {}
    wrappers = _path_wrappers()
    for fn in wrappers.values():
        fn.shapes = set()

    steps = str(QUAL_STEPS)
    rec, recs, launches["train_curve"], walls["train_curve"] = _quality_tool(
        "train_curve", card, train_curve.main,
        ["--stages", "gan,vocoder,plm,adm", "--steps", steps, "--lm_steps", steps,
         "--val_every", steps, "--n_per_spk", str(QUAL_UTT), "--root", curve])
    _check_quality_record("train_curve", rec, card)
    check(rec["gan"]["val/loss_re"][0][0] == QUAL_STEPS and rec["plm"]["val/ac10"][0][0] == QUAL_STEPS,
          f"quality train_curve: {rec}")
    reports = []
    for extra in ([], ["--quant_int8"]):
        label = "e2e_quality" + (" int8" if extra else "")
        rec, _, launches[label], walls[label] = _quality_tool(
            label, card, e2e_quality.main, ["--root", curve, *extra])
        # the MCD of a tail of 8 frames or fewer is NaN, as in JAX: an ADM of
        # QUAL_STEPS steps may give a frame a phone
        _check_quality_record("e2e_quality", rec, card, nan_ok=("mcd_db", "mcd_db_mean"))
        check(rec["n_speakers"] == 2, f"quality {label}: {rec['n_speakers']} speakers")
        reports.append(os.path.join(base, f"{rec['plm_decode']}.json"))
        with open(reports[-1], "w") as f:
            json.dump(rec, f)
    _, _, launches["quality_table"], walls["quality_table"] = _quality_tool(
        "quality_table", card, quality_table.main, reports)
    rec, _, launches["int8_margins"], walls["int8_margins"] = _quality_tool(
        "int8_margins", card, int8_margins.main, ["--train_root", curve, "--n_batches", "2"])
    _check_quality_record("int8_margins", rec, card)
    check(rec["positions"] > 0 and 0 <= rec["teacher_forced_argmax_agreement"] <= 1,
          f"quality int8_margins: {rec}")

    gan_s, plm_s, adm_s, voc_s = map(str, STACK_STEPS)
    rec, recs, launches["at_scale_stack"], walls["at_scale_stack"] = _quality_tool(
        "at_scale_stack", card, at_scale_stack.main,
        ["--root", stack, "--n_speakers", str(STACK_SPK), "--n_per_spk", str(STACK_UTT),
         "--gan_steps", gan_s, "--plm_steps", plm_s, "--adm_steps", adm_s, "--voc_steps", voc_s,
         "--g_ema_decay", "0.999"])
    _check_quality_record("at_scale_stack", rec, card)
    fits = [r for r in recs if r.get("phase", "").endswith("_launch") or r.get("phase") == "stage2"]
    check([r["rc"] for r in fits] == [0] * 5, f"quality at_scale_stack: launches {fits}")
    _check_ema_latents(dev, stack, card)
    rec, _, launches["heldout_eval"], walls["heldout_eval"] = _quality_tool(
        "heldout_eval", card, heldout_eval.main,
        ["--train_root", stack, "--ckpt_root", os.path.join(stack, "ckpts50k"), "--gan_config",
         os.path.join(stack, "gan50k.yaml"), "--out", os.path.join(base, "heldout"),
         "--n_speakers", "2", "--n_seeds", "1"])
    # a tail of 8 frames or fewer has no MCD, as in JAX
    _check_quality_record("heldout_eval", rec, card, nan_ok=("mcd_db",))
    check(len(rec["rows"]) == 2 * len(heldout_eval.TEXTS) * 2, f"quality heldout_eval: {rec['rows']}")

    n = launches
    check(n["train_curve"]["A"] > 0 and n["train_curve"]["A_bwd"] > 0
          and n["train_curve"]["B_tc"] > 0 and n["train_curve"]["C_tc"] > 0,
          f"quality train_curve: A, A's backward (vocoder fit), B and C (PLM fit) {n['train_curve']}")
    for label in ("e2e_quality", "e2e_quality int8", "heldout_eval"):
        check(n[label]["A"] > 0 and n[label]["B_tc"] > 0,
              f"quality {label}: A (mels) and B on the tensor cores (the prompt prefill) {n[label]}")
    check(n["int8_margins"]["B_tc"] > 0, f"quality int8_margins: B on the tensor cores {n['int8_margins']}")
    check(n["at_scale_stack"]["A"] > 0, f"quality at_scale_stack: A (stage 1) {n['at_scale_stack']}")
    print("quality walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + f" [{card}]")
    shapes = {name: fn.shapes for name, fn in wrappers.items()}
    for fn in wrappers.values():
        fn.shapes = None
    _check_stage1_features(dev, os.path.join(curve, "ds"), card, "quality")
    _check_path_shapes(dev, shapes, err, card, "quality")
    shutil.rmtree(base)
    return launches


# the parallel phase: correctness runs of data and tensor parallelism on the
# one card, over gloo (NCCL refuses two ranks on one device): they prove the
# process groups and the collectives on CUDA tensors, not any scaling
PAR_L, PAR_LENS = 256, [256, 256, 240, 200, 180, 128, 96, 32]  # the PLM batch (B=8)
PAR_STEPS, PAR_LR = 2, 1e-4  # warmup 1: the first update has lr 0, the second moves the weights
PAR_DEPTH, PAR_CUTS = 2, 8  # (c): the PLM's layers and max_n_cuts (batches split evenly)
# a bf16 step on N ranks against one process: the ranks' GEMMs see fewer rows
# (another algorithm, another sum order) and a row-parallel layer sums partial
# products rounded to bf16, so a layer's output may move by a bf16 ulp
# (2^-8 = 3.9e-3); the loss, a mean over ~1500 tokens, moves by less
PAR_RTOL_BF16 = 1e-2
PAR_ATOL_AC10 = 1e-2  # top-10 hits that flip at a near tie, over ~1500 targets
# the GAN at (2, 1) runs fp32 (TF32 off): its first step's kmeans (50 Lloyd
# iterations) is discontinuous in its rows, so a bf16 ulp could move a row
# to another code; in fp32 the rows agree to ~1e-6 and the sums to ~1e-5
PAR_RTOL_FP32 = 1e-4
# AdamW's second update (the first at lr > 0) moves a weight by at most
# 1.0013 lr whatever its gradient (|m^|/sqrt(v^) <= 1.0013 at betas (0.9,
# 0.999)), plus the decay's lr wd |w|; where the runs' gradients differ in
# sign (a gradient of bf16 noise, or the key bias's rounding residue) the
# weights may differ by twice that: |dw| <= 2.1 lr.  Being invariant to the
# gradient's scale, the update cannot tell a right reduction from a wrong
# one: the gradients are held directly (PAR_GRAD_*)
PAR_ADAM = 2.1
# the first step's gradients (every run on the initial weights, D's too),
# after the reduction over the data ranks and before the optimizer reads
# them, against the one-process step's: the relative L2 error of each
# parameter tensor (those whose true gradient is 0 apart).  bf16: a rank
# rounds its share of a weight's gradient to bf16 before the sum (2^-9
# relative), and at (1, 2) the activations' partial sums too; measured on
# an H100: 2.2e-3 at (2, 1), 3.7e-2 (the code embedding, whose gradient
# crosses every layer) at (1, 2).  fp32 (TF32 off): other conv algorithms
# at other row counts, ~1e-6.  A reduction that averages where it should
# sum, drops a rank, or a collective's backward that does not reduce, is
# off by half the gradient's norm or more
PAR_GRAD_BF16 = 1e-1
PAR_GRAD_FP32 = 1e-3
# one rank against one process, the same program (mesh (1, 1)): only kernel
# C's atomic fp32 sums may round differently from run to run
PAR_RTOL_RUN = 1e-3


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _par_setup(kind: str, dev: torch.device):
    """(train state, step, global batch) of a parallel-phase run at full
    width: the shipped PLM in bf16, or the shipped G (MRTE ``use_flash``)
    and D in fp32; warmup 1 and lr ``PAR_LR``."""
    import dataclasses

    from megatts2_tpu_torch import config as c
    from megatts2_tpu_torch.training import (create_gan_state, create_plm_state,
                                             make_gan_train_step, make_plm_train_step)

    if kind == "plm":
        cfg, tcfg = c.load_plm_config("configs/config_plm.yaml")
        tcfg = dataclasses.replace(tcfg, warmup_steps=1, initial_learning_rate=PAR_LR, max_steps=100)
        return (create_plm_state(cfg, tcfg, device=dev), make_plm_train_step(cfg, tcfg)[0],
                _plm_batch(cfg, PAR_LENS, PAR_L, SEED + 11))
    g_cfg, d_cfg, tcfg = c.load_gan_config("configs/config_gan.yaml")
    g_cfg = dataclasses.replace(g_cfg, mrte=dataclasses.replace(g_cfg.mrte, use_flash=True))
    tcfg = dataclasses.replace(tcfg, warmup_steps=1, initial_learning_rate=PAR_LR, max_steps=200,
                               train_dtype="float32")
    batch = _gan_batch([GAN_TP] * GAN_B, GAN_TP, 512, [512, 512, 480, 512, 400, 512, 512, 300],
                       512, g_cfg.mrte.phone_vocab_size, SEED + 12)
    return create_gan_state(g_cfg, d_cfg, tcfg, device=dev), make_gan_train_step(g_cfg, d_cfg, tcfg), batch


def _par_modules(state) -> dict:
    return {"model": state.model} if hasattr(state, "model") else {"g": state.g, "d": state.d}


def _par_reference(kind: str, dev: torch.device, path: str) -> dict:
    """The one-process run: PAR_STEPS steps on the global batch; its metrics,
    its modules' state dicts and the first step's gradients (on the host)
    saved to ``path``."""
    state, step, batch = _par_setup(kind, dev)
    modules = _par_modules(state)
    metrics, grads = [], None
    for _ in range(PAR_STEPS):
        metrics.append({k: float(v) for k, v in step(state, batch).items()})
        grads = grads or _par_grads(modules, "cpu")
    torch.save({"metrics": metrics, "grads": grads,
                "state": {name: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                          for name, m in modules.items()}}, path)
    del state
    torch.cuda.empty_cache()
    return metrics


def _par_grads(modules: dict, device) -> dict:
    """The gradients a step left on the modules' parameters, copied to ``device``."""
    return {name: {k: p.grad.detach().to(device, copy=True) for k, p in m.named_parameters()
                   if p.grad is not None} for name, m in modules.items()}


def _par_steps(kind: str, n_model: int, zero: bool, ref: str) -> dict:
    """One rank's run: the state placed at (world / n_model, n_model), its
    rows of PAR_STEPS global batches, then its weights, buffers and first
    step's gradients against the one-process run's (``ref``): the largest
    difference of the parameters (those whose true gradient is 0 apart), of
    the codebook's and the BatchNorms' buffers, each beside the largest
    reference value, and each gradient's relative L2 error.  Records the
    kernels' launch signatures (``_par_signatures``)."""
    from megatts2_tpu_torch.parallel import make_mesh, param_specs, place_train_state, shard_batch

    dev = torch.device("cuda")
    state, step, batch = _par_setup(kind, dev)
    place_train_state(state, make_mesh(n_model), zero=zero)
    _zero_launches()
    wrappers = _path_wrappers()
    for fn in wrappers.values():
        fn.shapes = set()
    metrics, ms, grads = [], [], None
    for _ in range(PAR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append({k: float(v) for k, v in step(state, shard_batch(batch, state.mesh)).items()})
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        grads = grads or _par_grads(_par_modules(state), dev)
    n = _launches()
    signatures = _par_signatures(wrappers)
    saved = torch.load(ref)
    want, want_grads = saved["state"], saved["grads"]
    diff = {"w": 0.0, "w_zero_grad": 0.0, "w_sum": 0.0, "w_n": 0, "vq": 0.0, "vq_ref": 0.0,
            "bn": 0.0, "bn_ref": 0.0, "grads": [], "grad_sq": 0.0, "grad_ref_sq": 0.0}
    for name, module in _par_modules(state).items():
        specs = param_specs(module)
        params = dict(module.named_parameters())
        check(set(want_grads[name]) == set(grads[name]),
              f"parallel {kind}: gradients of other parameters than one process's")
        for k, w in want_grads[name].items():
            g, w = grads[name][k].float(), w.to(dev).float()
            if k in specs:
                w = specs[k].local(w)
            if k.endswith(ZERO_GRAD):
                continue
            if k.endswith("qkv.bias"):  # the fused key bias: true gradient 0
                (gq, _, gv), (wq, _, wv) = g.chunk(3), w.chunk(3)
                g, w = torch.cat([gq, gv]), torch.cat([wq, wv])
            d2, w2 = (g - w).square().sum().item(), w.square().sum().item()
            diff["grads"].append((math.sqrt(d2 / max(w2, 1e-30)), f"{name}.{k}"))
            diff["grad_sq"] += d2
            diff["grad_ref_sq"] += w2
        diff["grads"] = sorted(diff["grads"], reverse=True)[:5]
        for k, v in module.state_dict().items():
            w = want[name][k].to(dev)
            if k in specs:
                w = specs[k].local(w)
            d = (v.float() - w.float()).abs()
            if k in params:
                parts = {"w_zero_grad" if k.endswith(ZERO_GRAD) else "w": d}
                if k.endswith("qkv.bias"):  # the fused key bias: true gradient 0
                    q, kb, vb = d.chunk(3)
                    parts = {"w": torch.cat([q, vb]), "w_zero_grad": kb}
                for key, part in parts.items():
                    diff[key] = max(diff[key], part.max().item())
                diff["w_sum"] += d.sum().item()
                diff["w_n"] += d.numel()
            elif "_codebook." in k:
                diff["vq"] = max(diff["vq"], d.max().item())
                diff["vq_ref"] = max(diff["vq_ref"], w.abs().max().item())
            elif k.endswith((".mean", ".var")):
                diff["bn"] = max(diff["bn"], d.max().item())
                diff["bn_ref"] = max(diff["bn_ref"], w.abs().max().item())
    cb = getattr(getattr(state, "g", None), "vqpe", None)
    return {"kind": kind, "mesh": state.mesh.shape, "zero": zero, "metrics": metrics, "ms": ms,
            "launches": n, "diff": diff, "rank": state.mesh.rank, "shapes": signatures,
            "inited": None if cb is None else float(cb.vq.layers[0]._codebook.inited)}


def _par_signatures(wrappers: dict) -> dict:
    """The launch signatures the wrappers recorded, as JSON (a dtype by its
    name), the recording switched off again."""
    out = {name: [[str(x) if isinstance(x, torch.dtype) else x for x in sig] for sig in fn.shapes]
           for name, fn in wrappers.items()}
    for fn in wrappers.values():
        fn.shapes = None
    return out


def _par_shapes(recs: list) -> dict:
    """The launch signatures of ranks' records, joined, as the wrappers
    record them (for ``_check_path_shapes``)."""
    out = {name: set() for name in ("A", "A_bwd", "B", "C")}
    for rec in recs:
        for name, sigs in rec["shapes"].items():
            out[name] |= {tuple(getattr(torch, x[6:]) if isinstance(x, str) else x for x in sig)
                          for sig in sigs}
    return out


def _par_fit(argv: list) -> dict:
    """One rank's ``cli fit``: its wall, final step, launches and launch
    signatures."""
    from megatts2_tpu_torch import cli

    _zero_launches()
    wrappers = _path_wrappers()
    for fn in wrappers.values():
        fn.shapes = set()
    t0 = time.perf_counter()
    st = cli.main(argv)
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0, "step": st.step, "mesh": st.mesh.shape,
            "launches": _launches(), "shapes": _par_signatures(wrappers)}


def _par_rank(rank: int, world: int, port: int, jobs: list, out_dir: str) -> None:
    """A spawned rank on the one card: joins a gloo group through
    ``maybe_initialize_distributed(backend="gloo")`` and runs ``jobs``
    ([(function name, kwargs)]), writing their records to
    ``<out_dir>/rank<r>.json`` as it goes."""
    import torch.distributed as dist

    from megatts2_tpu_torch.parallel import maybe_initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    check(maybe_initialize_distributed(backend="gloo"), "no process group")
    out = []
    try:
        for fn, kwargs in jobs:
            out.append(globals()[fn](**kwargs))
            with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _par_spawn(world: int, jobs: list, out_dir: str) -> list:
    """``world`` ranks of :func:`_par_rank` on the one card; a rank that
    raises fails the phase.  Returns each rank's records."""
    import torch.multiprocessing as mp

    os.makedirs(out_dir)
    mp.start_processes(_par_rank, args=(world, _free_port(), jobs, out_dir), nprocs=world,
                       start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _par_check_steps(rec: dict, ref: list, card: str) -> None:
    """A rank's run against the one-process run, at the tolerances above."""
    label = (f"{rec['kind']} at ({rec['mesh']['data']}, {rec['mesh']['model']})"
             f"{' --zero_opt' if rec['zero'] else ''} rank {rec['rank']}")
    fp32 = rec["kind"] == "gan"
    rtol = PAR_RTOL_FP32 if fp32 else PAR_RTOL_BF16
    worst = 0.0
    for i, (m, w) in enumerate(zip(rec["metrics"], ref)):
        check(set(m) == set(w), f"parallel {label}: metrics {sorted(m)} vs {sorted(w)}")
        for k, v in w.items():
            err = abs(m[k] - v)
            if k == "ac10":
                check(err <= PAR_ATOL_AC10, f"parallel {label} step {i}: ac10 {m[k]} vs {v}")
            else:
                check(err <= rtol * abs(v) + 1e-6, f"parallel {label} step {i}: {k} {m[k]} vs {v}")
                worst = max(worst, err / max(abs(v), 1e-6))
    d = rec["diff"]
    adam = PAR_ADAM * PAR_LR * (PAR_STEPS - 1)
    check(d["w"] <= adam and d["w_zero_grad"] <= adam,
          f"parallel {label}: weights differ by {d['w']} ({d['w_zero_grad']} zero-gradient), "
          f"bound {adam}")
    grad_tol = PAR_GRAD_FP32 if fp32 else PAR_GRAD_BF16
    grad_all = math.sqrt(d["grad_sq"] / d["grad_ref_sq"])
    check(d["grads"] and d["grads"][0][0] <= grad_tol and grad_all <= grad_tol,
          f"parallel {label}: gradients off one process's by {grad_all:.3e} (relative L2), the "
          f"worst tensors {d['grads']}, tolerance {grad_tol}")
    if fp32:
        check(rec["inited"] == 1.0, f"parallel {label}: codebook not initialised")
        check(d["vq"] <= PAR_RTOL_FP32 * d["vq_ref"] and d["bn"] <= PAR_RTOL_FP32 * d["bn_ref"],
              f"parallel {label}: codebook {d['vq']} of {d['vq_ref']}, BatchNorm {d['bn']} of "
              f"{d['bn_ref']}")
    else:
        n = rec["launches"]
        check(n["B_tc"] > 0 and n["C_tc"] > 0, f"parallel {label}: B or C not launched {n}")
    print(f"parallel {label}: step ms {[round(x, 2) for x in rec['ms']]}, worst metric rel err "
          f"{worst:.3e}, first step's gradients within {grad_all:.3e} relative L2 of one process's, "
          f"worst tensors {[(f'{e:.3e}', k) for e, k in d['grads'][:3]]} (tolerance {grad_tol}), "
          f"weights max |dw| {d['w']:.3e} mean {d['w_sum'] / max(d['w_n'], 1):.3e} "
          f"(zero-gradient {d['w_zero_grad']:.3e}; bound {adam:.1e}), codebook {d['vq']:.3e} of "
          f"{d['vq_ref']:.3e}, BatchNorm {d['bn']:.3e} of {d['bn_ref']:.3e}, launches B "
          f"{rec['launches']['B']} C {rec['launches']['C']} (correctness run over gloo on one "
          f"card, not scaling) [{card}]")


def _loss_rows(log_dir: str, name: str = "plm") -> list:
    return [r for r in _metric_rows(log_dir, name, "train/") if "train/loss" in r]


def _same_losses(a: list, b: list, rtol: float, what: str) -> float:
    check([r["step"] for r in a] == [r["step"] for r in b] and a, f"{what}: steps {a} vs {b}")
    worst = 0.0
    for x, y in zip(a, b):
        for k in ("train/loss", "train/loss_sum"):
            err = abs(x[k] - y[k]) / abs(y[k])
            check(err <= rtol, f"{what}: step {x['step']} {k} {x[k]} vs {y[k]}")
            worst = max(worst, err)
    return worst


def _par_nccl(card: str) -> None:
    """The NCCL branches of ``parallel/collectives.py`` (a CPU tensor goes
    through the card and comes back) on a group of one rank, the only NCCL
    group one card allows: the sum, the gather, the broadcast and the
    gradient reduction of CPU and CUDA tensors in fp32 and bf16, each the
    identity at one rank, on the tensor's device and in its dtype."""
    import torch.distributed as dist

    from megatts2_tpu_torch.parallel import collectives as col

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        check(dist.get_backend(group) == "nccl", f"backend {dist.get_backend(group)}")
        gen = torch.Generator().manual_seed(SEED + 13)
        n = 0
        for device in ("cpu", "cuda"):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(5, 7, generator=gen).to(device, dtype)
                b = x.clone()
                p = torch.nn.Parameter(torch.zeros(5, 7, device=device, dtype=dtype))
                p.grad = x.clone()
                col.reduce_grads([p], group, average=True)
                for what, y in (("all_reduce", col.all_reduce(x, group)),
                                ("gather", col.gather(x, group, 0, 1, dim=1)),
                                ("broadcast_", col.broadcast_(b, group)), ("reduce_grads", p.grad)):
                    check(y.device == x.device and y.dtype == x.dtype and torch.equal(y, x),
                          f"NCCL {what} of a {device} {dtype} tensor: {y.device} {y.dtype}")
                    n += 1
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    print(f"parallel NCCL collectives: {n} checks of the NCCL branches on one rank, each the "
          f"identity on the tensor's device and dtype [{card}]")


def phase_parallel(dev: torch.device, card: str, root: str, err: dict) -> dict:
    """Data and tensor parallelism on the one card (``parallel/``), after
    "pipeline" (its stage-2 dataset): (a) ``torchrun --nproc_per_node 1``
    (NCCL) fits the full-width PLM 3 steps with a checkpoint, a plain
    process resumes it a step, each held against one plain process doing
    the same: at one rank the mesh is (1, 1), so this proves torchrun's
    environment and the NCCL init, and ``--zero_opt`` and every collective
    are no-ops there; the NCCL branches of the collectives run on a group
    of one rank (``_par_nccl``); (b) two ranks (gloo) take the full-width
    PLM step (bf16) at (2, 1) with ZeRO-1 and at (1, 2), and the full-width
    GAN step (fp32, its first step's kmeans) at (2, 1), each against the
    one-process step on the same global batch, gradients included; (c) four
    ranks fit a 2-layer PLM through ``cli fit --n_model 2``, (2, 2), warmup
    1 so that the updates move the losses, against one process.  Every
    kernel launch signature of the ranks is then held against the plain
    version (``_check_path_shapes``).  Returns each run's launches."""
    import shutil

    from megatts2_tpu_torch import cli
    from megatts2_tpu_torch.data import CutManifest, DurationBucketSampler
    from megatts2_tpu_torch.training.checkpoints import latest_checkpoint

    base = os.path.join(root, "parallel")
    os.makedirs(base)
    ds = os.path.join(root, "pipeline", "ds")
    launches, recs = {}, []

    # (a) one NCCL rank under torchrun, then a plain resume
    cfg3 = _pipeline_config("configs/config_plm.yaml", os.path.join(base, "plm3.yaml"), ds, 3, 3)
    cfg4 = _pipeline_config("configs/config_plm.yaml", os.path.join(base, "plm4.yaml"), ds, 4, 4)
    runs = {}
    for label in ("torchrun", "plain"):
        logs, ck = os.path.join(base, f"logs_{label}"), os.path.join(base, f"ck_{label}")
        argv = ["fit", "-c", cfg3, "--stage", "plm", "--zero_opt", "--log_dir", logs, "--ckpt_dir", ck]
        t0 = time.perf_counter()
        if label == "torchrun":
            env = dict(os.environ, PYTHONPATH=os.getcwd())
            proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                   "--nproc_per_node", "1", "-m", "megatts2_tpu_torch.cli", *argv],
                                  capture_output=True, text=True, timeout=600, env=env)
            check(proc.returncode == 0, f"torchrun fit: rc {proc.returncode}\n{proc.stdout[-3000:]}"
                                        f"\n{proc.stderr[-3000:]}")
        else:
            cli.main(argv)
        wall = time.perf_counter() - t0
        check(os.path.basename(latest_checkpoint(ck)) == "step_3.ckpt", f"{label}: no step_3")
        cli.main(["fit", "-c", cfg4, "--stage", "plm", "--log_dir", logs, "--ckpt_dir", ck])
        runs[label] = (wall, _loss_rows(logs))
    worst = _same_losses(runs["torchrun"][1], runs["plain"][1], PAR_RTOL_RUN, "torchrun fit")
    print(f"parallel torchrun fit plm: 1 NCCL rank (mesh (1, 1): --zero_opt and the collectives "
          f"are no-ops), 3 steps + checkpoint in {runs['torchrun'][0]:.1f} s (plain process "
          f"{runs['plain'][0]:.1f} s), resumed a step in a plain process; losses of steps 1-4 "
          f"against the plain run's within {worst:.2e} relative [{card}]")
    shutil.rmtree(os.path.join(base, "ck_torchrun"))
    shutil.rmtree(os.path.join(base, "ck_plain"))
    torch.cuda.empty_cache()
    _par_nccl(card)

    # (b) two gloo ranks against one process on the same global batch
    launches.update(_par_two_ranks(dev, card, base, recs))

    # (c) four gloo ranks, (2, 2), through the CLI, against one process
    cfg = os.path.join(base, "plm_depth2.yaml")
    _pipeline_config("configs/config_plm.yaml", cfg, ds, 3, 3)
    with open(cfg) as f:
        text = f.read()
    for key, value in (("n_layers", PAR_DEPTH), ("max_n_cuts", PAR_CUTS), ("warmup_steps", 1)):
        text, n = re.subn(rf"^(\s*){key}:.*$", rf"\g<1>{key}: {value}", text, count=1, flags=re.M)
        check(n == 1, f"no {key} in the PLM config")
    with open(cfg, "w") as f:
        f.write(text)
    train = CutManifest.load(os.path.join(ds, "cuts_train.jsonl.gz")).filter_duration(2.1, 20)
    plans = []
    for divisor in (1, 2):
        sampler = DurationBucketSampler(train, max_duration_batch=None, max_cuts=PAR_CUTS,
                                        num_buckets=1, batch_divisor=divisor)
        sampler.set_epoch(0)
        plans.append(list(sampler)[:3])
    check(plans[0] == plans[1] and len(plans[0]) == 3, f"(c): batch plans differ {plans}")
    argv = ["fit", "-c", cfg, "--log_dir", os.path.join(base, "logs_c"), "--ckpt_dir",
            os.path.join(base, "ck_c"), "--n_model", "2"]
    t0 = time.perf_counter()
    ranks = _par_spawn(4, [("_par_fit", dict(argv=argv))], os.path.join(base, "ranks4"))
    wall = time.perf_counter() - t0
    cli.main(["fit", "-c", cfg, "--log_dir", os.path.join(base, "logs_c1"), "--ckpt_dir",
              os.path.join(base, "ck_c1")])
    worst = _same_losses(_loss_rows(os.path.join(base, "logs_c")),
                         _loss_rows(os.path.join(base, "logs_c1")), PAR_RTOL_BF16, "(2, 2) fit")
    for r, (rec,) in enumerate(ranks):
        check(rec["step"] == 3 and rec["mesh"] == {"data": 2, "model": 2}, f"(c) rank {r}: {rec}")
        n = rec["launches"]
        check(n["B_tc"] > 0 and n["C_tc"] > 0, f"(c) rank {r}: B or C not launched {n}")
        launches[f"parallel fit (2, 2) rank {r}"] = n
        recs.append(rec)
    print(f"parallel fit plm --n_model 2 on 4 ranks (2, 2), {PAR_DEPTH} layers, warmup 1: {wall:.1f} s "
          f"for 3 steps (a rank's fit {ranks[0][0]['wall_s']:.1f} s), losses within {worst:.2e} "
          f"relative of one process; launches per rank B {[rec['launches']['B'] for (rec,) in ranks]} "
          f"C {[rec['launches']['C'] for (rec,) in ranks]} (correctness run over gloo on one card, not "
          f"scaling) [{card}]")
    shutil.rmtree(base)
    _check_path_shapes(dev, _par_shapes(recs), err, card, "parallel")
    return launches


def _par_two_ranks(dev: torch.device, card: str, base: str, recs: list) -> dict:
    """(b) of the "parallel" phase: the one-process runs, then two spawned
    ranks for each of them, each rank's record checked and added to
    ``recs``.  Returns the runs' launches."""
    refs, launches = {}, {}
    for kind in ("plm", "gan"):
        path = os.path.join(base, f"ref_{kind}.pt")
        refs[kind] = (path, _par_reference(kind, dev, path))
    jobs = [("_par_steps", dict(kind="plm", n_model=1, zero=True, ref=refs["plm"][0])),
            ("_par_steps", dict(kind="plm", n_model=2, zero=False, ref=refs["plm"][0])),
            ("_par_steps", dict(kind="gan", n_model=1, zero=False, ref=refs["gan"][0]))]
    t0 = time.perf_counter()
    ranks = _par_spawn(2, jobs, os.path.join(base, "ranks2"))
    print(f"parallel two ranks: {len(jobs)} runs in {time.perf_counter() - t0:.1f} s [{card}]")
    for rank_recs in ranks:
        for rec in rank_recs:
            _par_check_steps(rec, refs[rec["kind"]][1], card)
            key = f"parallel {rec['kind']} ({rec['mesh']['data']}, {rec['mesh']['model']}) rank {rec['rank']}"
            launches[key] = rec["launches"]
            recs.append(rec)
    for path, _ in refs.values():
        os.remove(path)
    return launches


def _timed(name: str, fn, *args):
    """fn(*args), with the phase's seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    t_start = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda")
    _timed("build", phase_build)
    k = _timed("kernels", phase_kernels, dev, card)
    _timed("kernels (serving head dims, prefill)", phase_kernels_serving, dev, card, k)
    _timed("reference", phase_reference, dev)
    with tempfile.TemporaryDirectory() as root:
        slices = _timed("slice", phase_slice, dev, card, root)
        _timed("serve reference", phase_serve_reference, dev, root)
        serve = _timed("serve", phase_serve, dev, card, root, k)
        pump_launches = _timed("bandwidth", phase_bandwidth, card)
        _timed("train reference", phase_train_reference, dev)
        train = _timed("train", phase_train, dev, card, root)
        _timed("GAN reference", phase_gan_reference, dev)
        gan = _timed("GAN train", phase_gan_train, dev, card, root)
        _timed("vocoder reference", phase_vocoder_reference, dev)
        vocoder = _timed("vocoder train", phase_vocoder_train, dev, card, root)
        pipeline = _timed("pipeline", phase_pipeline, dev, card, root, k["err"])
        tools = _timed("tools", phase_tools, dev, card, root, k["err"])
        quality = _timed("quality", phase_quality, dev, card, root, k["err"])
        parallel = _timed("parallel", phase_parallel, dev, card, root, k["err"])
    adm = train["adm_flash"]
    synth = {name: sum(s[name] for s in slices.values()) for name in ("mel", "flash", "flash_tc")}
    served = {name: sum(s[name] for s in serve.values()) for name in ("mel", "flash", "flash_tc")}

    def _ms(us):
        return None if us is None else us / 1e3

    def piped(key):
        """(launches, by step) of the pipeline, tools and quality phases for one counter."""
        by = {f"pipeline {label}": n[key] for label, n in pipeline.items() if n[key]}
        by.update({f"tools {label}": n[key] for label, n in tools.items() if n[key]})
        by.update({f"quality {label}": n[key] for label, n in quality.items() if n[key]})
        by.update({label: n[key] for label, n in parallel.items() if n[key]})
        return sum(by.values()), by

    def wide(key):
        """Kernel B's or C's times at (3, 70, 2, WIDE_TIMED), fp32 and bf16."""
        return {f"{name}_dh{WIDE_TIMED}_{kind}": val for kind in ("fp32", "bf16")
                for name, val in (("ms", k["ms"][f"{key}_{kind}"][0]),
                                  ("plain_ms", k["ms"][f"{key}_{kind}"][1]),
                                  ("bound_ms", k["bound"][f"{key}_{kind}"][0]),
                                  ("library_ms", k["lib"][f"{key}_{kind}"]))}

    def row(name, source, replaces, key, err_key, launches, shape, **extra):
        ms, plain_ms = k["ms"][key]
        return {"name": name, "route": "cuda", "source": f"megatts2_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": k["err"][err_key],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": k["bound"][key][0],
                "bound_by": k["bound"][key][1], "library_ms": k["lib"][key], "shape": shape,
                "card": card, **extra}

    record = {"kernels": [
        row("mel_spectrogram", "mel.cu", "megatts2_tpu/ops/mel.py:190", "mel", "mel",
            synth["mel"] + served["mel"] + vocoder["mel"] + piped("A")[0],
            "(8, 131000) fp32", library="torch.stft + filterbank matmul + log (composite)",
            launches_by_path={**{label: s["mel"] for label, s in slices.items()},
                              **{f"serve {label}": s["mel"] for label, s in serve.items()},
                              "vocoder": vocoder["mel"], **piped("A")[1]},
            device_ms=_ms(k["split"]["mel"]["device_us"]), host_ms=k["split"]["mel"]["host_us"] / 1e3,
            device_ms_prompt=_ms(k["split"]["mel_prompt"]["device_us"]),
            ms_prompt=k["ms"]["mel_prompt"][0], plain_ms_prompt=k["ms"]["mel_prompt"][1],
            bound_ms_prompt=k["bound"]["mel_prompt"][0], library_ms_prompt=k["lib"]["mel_prompt"]),
        row("mel_spectrogram_bwd", "mel.cu",
            "megatts2_tpu/ops/mel.py:190 (no Pallas backward: JAX differentiates the jnp golden, "
            "megatts2_tpu/ops/mel.py:114-132)", "mel_bwd", "mel_bwd",
            vocoder["mel_bwd"] + piped("A_bwd")[0], "(8, 16384) fp32, g_mel (8, 65, 80)",
            library="autograd backward of torch.stft + filterbank matmul + log",
            launches_by_path={"vocoder": vocoder["mel_bwd"], **piped("A_bwd")[1]},
            device_ms=_ms(k["split"]["mel_bwd"]["device_us"]),
            host_ms=k["split"]["mel_bwd"]["host_us"] / 1e3,
            device_ms_halo=_ms(k["split"]["mel_bwd_halo"]["device_us"]),
            ms_16=k["ms"]["mel_bwd_16"][0], plain_ms_16=k["ms"]["mel_bwd_16"][1],
            bound_ms_16=k["bound"]["mel_bwd_16"][0], library_ms_16=k["lib"]["mel_bwd_16"],
            device_ms_16=_ms(k["split"]["mel_bwd_16"]["device_us"]),
            host_ms_16=k["split"]["mel_bwd_16"]["host_us"] / 1e3,
            device_ms_16_halo=_ms(k["split"]["mel_bwd_16_halo"]["device_us"])),
        row("flash_attention_fwd", "flash_attn_fwd.cu", "megatts2_tpu/ops/attention_pallas.py:111",
            "flash_plm", "flash",
            synth["flash"] + served["flash"] + train["flash"] + adm["B"] + gan["flash"] + piped("B")[0],
            "(8, 1024, 16, 64) bf16 causal, with stats", library="scaled_dot_product_attention",
            launches_by_path={**{label: s["flash"] for label, s in slices.items()},
                              **{f"serve {label}": s["flash"] for label, s in serve.items()},
                              "train": train["flash"], "train adm (use_flash)": adm["B"],
                              "gan": gan["flash"], **piped("B")[1]},
            tc_launches=(synth["flash_tc"] + served["flash_tc"] + train["flash_tc"] + adm["B_tc"]
                         + gan["flash_tc"] + piped("B_tc")[0]),
            causal_launches_serve_prompted=serve["continuous prompted"]["flash_causal"],
            ms_dh96=k["ms"]["dh96"][0], plain_ms_dh96=k["ms"]["dh96"][1],
            bound_ms_dh96=k["bound"]["dh96"][0], library_ms_dh96=k["lib"]["dh96"],
            ms_simt_dh96=k["simt"]["dh96"], device_ms_dh96=_ms(k["split"]["dh96"]["device_us"]),
            device_ms_simt_dh96=_ms(k["split"]["dh96_simt"]["device_us"]),
            host_ms_dh96=k["split"]["dh96"]["host_us"] / 1e3,
            **{f"{key}_serve_mrte": val for key, val in k["serve_mrte"].items()},
            ms_prefill_2048=k["ms"]["prefill_2048"][0], plain_ms_prefill_2048=k["ms"]["prefill_2048"][1],
            bound_ms_prefill_2048=k["bound"]["prefill_2048"][0],
            library_ms_prefill_2048=k["lib"]["prefill_2048"],
            ms_simt=k["simt"]["flash_plm"],
            tflops=k["tflops"]["flash_plm"], device_ms=_ms(k["split"]["flash_plm"]["device_us"]),
            host_ms=k["split"]["flash_plm"]["host_us"] / 1e3,
            ms_mrte=k["ms"]["flash"][0], plain_ms_mrte=k["ms"]["flash"][1],
            bound_ms_mrte=k["bound"]["flash_mrte"][0], library_ms_mrte=k["lib"]["flash_mrte"],
            ms_simt_mrte=k["simt"]["flash_mrte"], device_ms_mrte=_ms(k["split"]["flash_mrte"]["device_us"]),
            device_ms_simt_mrte=_ms(k["split"]["flash_mrte_simt"]["device_us"]),
            host_ms_mrte=k["split"]["flash_mrte"]["host_us"] / 1e3,
            ms_prefill_256=k["ms"]["prefill_256"][0], ms_simt_prefill_256=k["simt"]["prefill_256"],
            library_ms_prefill_256=k["lib"]["prefill_256"], **wide("wide")),
        row("flash_attention_bwd", "flash_attn_bwd.cu", "megatts2_tpu/ops/attention_pallas.py:161",
            "flash_bwd", "flash_bwd", train["flash_bwd"] + adm["C"] + gan["flash_bwd"] + piped("C")[0],
            "(8, 1024, 16, 64) bf16 causal", library="scaled_dot_product_attention backward",
            launches_by_path={"train": train["flash_bwd"], "train adm (use_flash)": adm["C"],
                              "gan": gan["flash_bwd"], **piped("C")[1]},
            tc_launches=train["flash_bwd_tc"] + adm["C_tc"] + gan["flash_bwd_tc"] + piped("C_tc")[0],
            ms_simt=k["simt"]["flash_bwd"], tflops=k["tflops"]["flash_bwd"],
            device_ms=_ms(k["split"]["flash_bwd_plm"]["device_us"]),
            host_ms=k["split"]["flash_bwd_plm"]["host_us"] / 1e3,
            ms_mrte=k["ms"]["flash_bwd_mrte"][0], plain_ms_mrte=k["ms"]["flash_bwd_mrte"][1],
            bound_ms_mrte=k["bound"]["flash_bwd_mrte"][0],
            library_ms_mrte=k["lib"]["flash_bwd_mrte"], ms_simt_mrte=k["simt"]["flash_bwd_mrte"],
            device_ms_mrte=_ms(k["split"]["flash_bwd_mrte"]["device_us"]),
            device_ms_simt_mrte=_ms(k["split"]["flash_bwd_mrte_simt"]["device_us"]),
            host_ms_mrte=k["split"]["flash_bwd_mrte"]["host_us"] / 1e3,
            ms_dh96=k["ms"]["bwd_dh96"][0], plain_ms_dh96=k["ms"]["bwd_dh96"][1],
            bound_ms_dh96=k["bound"]["bwd_dh96"][0], library_ms_dh96=k["lib"]["bwd_dh96"],
            ms_simt_dh96=k["simt"]["bwd_dh96"], device_ms_dh96=_ms(k["split"]["bwd_dh96"]["device_us"]),
            device_ms_simt_dh96=_ms(k["split"]["bwd_dh96_simt"]["device_us"]),
            host_ms_dh96=k["split"]["bwd_dh96"]["host_us"] / 1e3, **wide("bwd_wide")),
        row("pump", "pump.cu", "tools/bw_ceiling.py:154", "pump", "pump", pump_launches,
            f"{PUMP_SHAPE} int8 x {PUMP_STEPS} passes",
            library=f"{PUMP_STEPS} x torch.sum(W.view(int32), dtype=int64)",
            copy_ms=k["lib"]["pump_copy"]),
    ]}
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
