"""Input-pipeline benchmark at corpus scale (port of ``tools/bench_input_pipeline.py``).

    python -m megatts2_tpu_torch.tools.bench_input_pipeline --root DIR \\
        [--n_speakers 50 --n_per_spk 200] [--workers 1,4] [--gan_steps 60] [--device cuda]

Generates a synthetic corpus of ``--n_speakers × --n_per_spk`` utterances
(default 50×200 = 10k utterances, 8.9 h of audio; the files byte for byte
those of the JAX tool for the same seed and sizes), drives the port's
offline pipeline (``prepare_ds`` stages 0+1; stage 1's mels through kernel
A on the card) through its entry point, then benchmarks the training-side
input path:

* stage-0/1 throughput (files/s) at each ``--workers`` setting;
* ``GANBatchBuilder`` batches/s, the native reader's prefetch ring against
  pure numpy (a native reader that does not build raises: no fallback);
* ``--gan_steps N``: loader-fed full-size GAN train steps/s on the device;
* ``--stage2_ckpt``: stage-2 latent extraction through ``prepare_ds``
  from the port's G ``.ckpt``;
* ``--plm_steps``, ``--adm_steps``: loader-fed full-size PLM and ADM steps
  on the stage-2 latents (``configs/config_plm.yaml``: kernels B and C).

Prints one JSON line per measurement, each with the card's name and power
limit.  Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable

import numpy as np

from ..training.lm_trainers import train_device
from .bench_train import sync
from .bw_ceiling import card_name


def build_corpus(root: str, n_speakers: int, n_per_spk: int, seed: int = 0,
                 dur_s: float = 3.2, device="cuda", emit: Callable = print) -> tuple:
    """Harmonic-stack corpus: speaker f0s spread over 85–300 Hz, constant
    duration, one formant envelope a speaker; returns (wavs, textgrids, ds)."""
    from ..utils.audio import save_wav

    wavs = os.path.join(root, "wavs")
    tgs = os.path.join(root, "textgrids")
    ds = os.path.join(root, "ds")
    os.makedirs(ds, exist_ok=True)
    words = ["hello", "world", "nice", "day", "of", "speech"]
    rng = np.random.RandomState(seed)
    sr = 16000
    n = int(dur_s * sr)
    t = np.arange(n) / sr
    t0 = time.time()
    total = 0
    for spk_i in range(n_speakers):
        spk = f"spk{spk_i:03d}"
        os.makedirs(os.path.join(wavs, spk), exist_ok=True)
        os.makedirs(os.path.join(tgs, spk), exist_ok=True)
        f0_base = 85.0 * (300.0 / 85.0) ** (spk_i / max(n_speakers - 1, 1))
        seg = dur_s / len(words)
        iv = "".join(
            f"""        intervals [{j+1}]:
            xmin = {j*seg}
            xmax = {(j+1)*seg}
            text = "{w}"
"""
            for j, w in enumerate(words)
        )
        tg_body = (
            'File type = "ooTextFile"\nObject class = "TextGrid"\n'
            f"xmin = 0\nxmax = {dur_s}\ntiers? <exists>\nsize = 1\nitem []:\n"
            "    item [1]:\n"
            '        class = "IntervalTier"\n        name = "phones"\n'
            f"        xmin = 0\n        xmax = {dur_s}\n"
            f"        intervals: size = {len(words)}\n" + iv
        )
        # a per-speaker formant envelope (two resonance peaks, spread over
        # speakers by a low-discrepancy sequence): pitch is prosody (the VQ
        # codes), timbre the spectral envelope (the MRTE), so speakers that
        # differed only by f0 could not show timbre transfer
        F1 = 300.0 + 550.0 * ((spk_i * 0.6180339887) % 1.0)
        F2 = 1200.0 + 1800.0 * ((spk_i * 0.3819660113 + 0.25) % 1.0)

        def env(f):
            return (0.08 + np.exp(-((f - F1) ** 2) / (2 * 140.0 ** 2))
                    + 0.8 * np.exp(-((f - F2) ** 2) / (2 * 260.0 ** 2)))

        for i in range(n_per_spk):
            f0 = f0_base * (1 + 0.05 * rng.rand())
            n_harm = max(3, int(3800.0 / f0))
            y = sum(
                (env(h * f0) / np.sqrt(h))
                * np.sin(2 * np.pi * f0 * h * t + rng.rand() * 6.28)
                for h in range(1, n_harm + 1)
            )
            y *= 0.5 + 0.5 * np.sin(2 * np.pi * (2 + rng.rand()) * t) ** 2
            y = (y + 0.01 * rng.randn(n)).astype(np.float32)
            y /= np.abs(y).max() + 1e-6
            uid = f"{spk}_u{i}"
            save_wav(os.path.join(wavs, spk, uid + ".wav"), y)
            with open(os.path.join(wavs, spk, uid + ".txt"), "w") as f:
                f.write(" ".join(words))
            with open(os.path.join(tgs, spk, uid + ".TextGrid"), "w") as f:
                f.write(tg_body)
            total += 1
    dt = time.time() - t0
    emit(json.dumps({
        "bench": "corpus_gen", "utterances": total,
        "audio_hours": round(total * dur_s / 3600, 2),
        "wall_s": round(dt, 1), "files_per_s": round(total / dt, 1),
        "device": card_name(train_device(device)),
    }))
    return wavs, tgs, ds


def run_stage(stage: int, wavs: str, tgs: str, ds: str, workers: int, n_files: int,
              generator_ckpt: str = "", device="cuda", emit: Callable = print) -> dict:
    """``prepare_ds --stage`` through its entry point; returns its record
    (``result``: what the stage counted)."""
    from ..prepare_ds import main as prep_main

    argv = ["--stage", str(stage), "--wavtxt_path", wavs, "--text_grid_path", tgs,
            "--ds_path", ds, "--num_workers", str(workers), "--device", str(device)]
    if generator_ckpt:
        argv += ["--generator_ckpt", generator_ckpt, "--generator_config", "configs/config_gan.yaml"]
    t0 = time.time()
    out = prep_main(argv)
    dt = time.time() - t0
    rec = {"bench": f"prepare_ds_stage{stage}", "workers": workers, "files": n_files,
           "wall_s": round(dt, 1), "files_per_s": round(n_files / dt, 1), "result": out,
           "device": card_name(train_device(device))}
    emit(json.dumps(rec))
    return rec


def bench_loader(ds: str, n_batches: int = 50, device="cuda", emit: Callable = print) -> list:
    """GANBatchBuilder batches/s: the native prefetch ring, then pure numpy."""
    from ..data import CutManifest, DataLoader, DurationBucketSampler
    from ..data.datasets import GANBatchBuilder

    card = card_name(train_device(device))
    manifest = CutManifest.load(os.path.join(ds, "cuts_train.jsonl.gz"))
    records = []
    for use_native in (True, False):
        builder = GANBatchBuilder(manifest, ds, use_native=use_native)
        sampler = DurationBucketSampler(manifest, max_duration_batch=8 * 3.2 + 0.1, num_buckets=1,
                                        seed=0)
        loader = DataLoader(sampler, builder, prefetch=2)
        it = iter(loader)
        batch = next(it)  # warm (mmap open, ring alloc)
        nbytes = sum(v.nbytes for v in batch.values())
        t0 = time.time()
        got = 0
        for batch in it:
            got += 1
            if got >= n_batches:
                break
        dt = time.time() - t0
        rec = {"bench": "gan_batch_builder", "native_ring": builder.native is not None,
               "batches": got, "batch_mb": round(nbytes / 1e6, 2),
               "batches_per_s": round(got / dt, 2), "mb_per_s": round(got * nbytes / 1e6 / dt, 1),
               "device": card}
        emit(json.dumps(rec))
        records.append(rec)
    return records


def _epochs(loader, first_it, n: int):
    """``n`` batches from ``first_it``, then from fresh epochs of ``loader``."""
    done, it = 0, first_it
    while done < n:
        for batch in it:
            yield batch
            done += 1
            if done >= n:
                return
        it = iter(loader)


def _loader_fed(name: str, step: Callable, state, loader, it, steps: int, warmup: int,
                key: str, device, note: str, emit: Callable) -> dict:
    """Warm ``warmup`` steps, then time ``steps`` loader-fed steps (the host's
    loader, the upload and the device step) to a synchronisation."""
    for batch in _epochs(loader, it, warmup):
        m = step(state, batch)
    float(m[key])
    sync(device)
    t0 = time.time()
    done = 0
    for batch in _epochs(loader, iter(loader), steps):
        m = step(state, batch)
        done += 1
    float(m[key])
    sync(device)
    dt = time.time() - t0
    rec = {"bench": f"{name}_loader_fed_steps", "steps": done, "steps_per_s": round(done / dt, 2),
           "wall_s": round(dt, 1), "note": note, "device": card_name(device)}
    emit(json.dumps(rec))
    return rec


def bench_gan_steps(ds: str, steps: int, device="cuda", g_cfg=None, d_cfg=None,
                    emit: Callable = print) -> dict:
    """Loader-fed full-size GAN train steps/s on the device (bf16), batches
    of up to 40 s of audio (B=12 on this corpus) from the native reader."""
    from .. import config as c
    from ..data import CutManifest, DataLoader, DurationBucketSampler
    from ..data.datasets import GANBatchBuilder
    from ..training import create_gan_state, make_gan_train_step

    device = train_device(device)
    manifest = CutManifest.load(os.path.join(ds, "cuts_train.jsonl.gz"))
    builder = GANBatchBuilder(manifest, ds, use_native=True)
    sampler = DurationBucketSampler(manifest, max_duration_batch=40.0, num_buckets=1, seed=0)
    g_cfg, d_cfg = g_cfg or c.MegaGConfig(), d_cfg or c.DiscriminatorConfig()
    tcfg = c.TrainConfig(train_dtype="bfloat16", max_steps=600_000)
    loader = DataLoader(sampler, builder, prefetch=4)
    it = iter(loader)
    first = next(it)
    state = create_gan_state(g_cfg, d_cfg, tcfg, device=device)
    step = make_gan_train_step(g_cfg, d_cfg, tcfg)
    float(step(state, first)["G_loss_total"])
    # the timbre concat's length varies by batch (same-speaker draws), so
    # warm over several batches before timing, as the JAX tool does
    return _loader_fed("gan", step, state, loader, it, steps, min(40, steps), "G_loss_total",
                       device, "full-size config, loader + upload + device step", emit)


def bench_stage2(ds: str, generator_ckpt: str, generator_config: str, device="cuda",
                 emit: Callable = print) -> dict:
    """Stage-2 latent extraction (latents/s) through ``prepare_ds --stage 2``:
    batched ``s2_latent`` (B=8, length-sorted buckets) and per-cut .npy writes."""
    from ..data import CutManifest
    from ..prepare_ds import main as prep_main

    n = len(CutManifest.load(os.path.join(ds, "cuts_train.jsonl.gz"))) + len(
        CutManifest.load(os.path.join(ds, "cuts_valid.jsonl.gz")))
    t0 = time.time()
    out = prep_main(["--stage", "2", "--ds_path", ds, "--generator_ckpt", generator_ckpt,
                     "--generator_config", generator_config, "--device", str(device)])
    dt = time.time() - t0
    rec = {"bench": "prepare_ds_stage2", "latents": n, "wall_s": round(dt, 1),
           "latents_per_s": round(n / dt, 1), "result": out,
           "device": card_name(train_device(device))}
    emit(json.dumps(rec))
    return rec


def bench_lm_steps(stage: str, ds: str, steps: int, config: str, device="cuda",
                   emit: Callable = print) -> dict:
    """Loader-fed PLM or ADM train steps/s on the stage-2 latents, at the
    config's model (the PLM's prompt-prefix assembly is the host path most
    likely to lag at 50 speakers × 200 utterances)."""
    from ..config import load_adm_config, load_plm_config
    from ..data import CutManifest, DataLoader, DurationBucketSampler
    from ..data.datasets import ADMBatchBuilder, PLMBatchBuilder
    from ..training import (create_adm_state, create_plm_state, make_adm_train_step,
                            make_plm_train_step)

    device = train_device(device)
    manifest = CutManifest.load(os.path.join(ds, "cuts_train.jsonl.gz"))
    if stage == "plm":
        cfg, tcfg = load_plm_config(config)
        builder = PLMBatchBuilder(manifest, ds, vq_bins=cfg.vq_bins)
        sampler = DurationBucketSampler(manifest, max_duration_batch=None, max_cuts=8,
                                        num_buckets=1, seed=0)
    else:
        cfg, tcfg = load_adm_config(config)
        builder = ADMBatchBuilder(manifest, ds, max_duration_token=cfg.max_duration_token)
        sampler = DurationBucketSampler(manifest, max_duration_batch=200.0, num_buckets=1, seed=0)
    loader = DataLoader(sampler, builder, prefetch=4)
    it = iter(loader)
    first = next(it)
    if stage == "plm":
        state = create_plm_state(cfg, tcfg, device=device)
        step = make_plm_train_step(cfg, tcfg)[0]
    else:
        state = create_adm_state(cfg, tcfg, device=device)
        step = make_adm_train_step(cfg, tcfg)[0]
    float(step(state, first)["loss"])
    return _loader_fed(stage, step, state, loader, it, steps, min(30, steps), "loss", device,
                       "full-size config, real stage-2 latents, loader + upload + device step", emit)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--n_speakers", type=int, default=50)
    ap.add_argument("--n_per_spk", type=int, default=200)
    ap.add_argument("--workers", default="1,4",
                    help="stage-1 worker counts to sweep (each is a full "
                         "re-run of the stage — keep the list short)")
    ap.add_argument("--skip_gen", action="store_true",
                    help="corpus already generated under --root")
    ap.add_argument("--skip_prep", action="store_true")
    ap.add_argument("--loader_batches", type=int, default=50)
    ap.add_argument("--gan_steps", type=int, default=0,
                    help=">0: loader-fed full-size GAN steps on the device")
    ap.add_argument("--skip_loader", action="store_true")
    ap.add_argument("--stage2_ckpt", default="",
                    help="the port's G .ckpt: run and time stage-2 latent extraction "
                         "over the corpus")
    ap.add_argument("--stage2_config", default="configs/config_gan.yaml")
    ap.add_argument("--plm_steps", type=int, default=0,
                    help=">0: loader-fed full-size PLM steps from the "
                         "stage-2 latents (needs --stage2_ckpt or a prior run)")
    ap.add_argument("--adm_steps", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    train_device(args.device)
    wavs = os.path.join(args.root, "wavs")
    tgs = os.path.join(args.root, "textgrids")
    ds = os.path.join(args.root, "ds")
    n_files = args.n_speakers * args.n_per_spk
    if not args.skip_gen:
        wavs, tgs, ds = build_corpus(args.root, args.n_speakers, args.n_per_spk,
                                     device=args.device)
    if not args.skip_prep:
        run_stage(0, wavs, tgs, ds, 1, n_files, device=args.device)
        for w in [int(w) for w in args.workers.split(",")]:
            run_stage(1, wavs, tgs, ds, w, n_files, device=args.device)
    if not args.skip_loader:
        bench_loader(ds, args.loader_batches, args.device)
    if args.gan_steps:
        bench_gan_steps(ds, args.gan_steps, args.device)
    if args.stage2_ckpt:
        bench_stage2(ds, args.stage2_ckpt, args.stage2_config, args.device)
    if args.plm_steps:
        bench_lm_steps("plm", ds, args.plm_steps, "configs/config_plm.yaml", args.device)
    if args.adm_steps:
        bench_lm_steps("adm", ds, args.adm_steps, "configs/config_adm.yaml", args.device)


if __name__ == "__main__":
    main()
