"""Train every stage at corpus scale through the training CLI (port of
``tools/at_scale_stack.py``).

    python -m megatts2_tpu_torch.tools.at_scale_stack --root DIR [--device cuda]

Builds ``bench_input_pipeline``'s corpus (50 speakers × 200 utterances
by default; the files byte for byte those of the JAX tool), prepares
stages 0 and 1 on the device, then fits every stage with ``python -m
megatts2_tpu_torch.cli fit`` as a subprocess, in the layout
``heldout_eval`` reads::

    {root}/gan50k.yaml {root}/plm.yaml {root}/adm.yaml {root}/vocoder.yaml
    {root}/ckpts50k/{gan,plm,adm,vocoder}   (top-k checkpoints + scores.json)
    {root}/logs50k/{stage}_metrics.jsonl

The GAN trains with ``g_ema_decay`` (0.999 by default): validation, top-k
selection and the generator loader all use the EMA weights, so stage 2
(``python -m megatts2_tpu_torch.prepare_ds --stage 2`` from the GAN's best
checkpoint) extracts the EMA generator's latents.  A stage whose metrics
log already reached its budget is skipped, and a fit that dies is
launched again (up to 4 times; the CLI resumes from its latest
checkpoint), so the tool can be run again after an interruption.
Prints one JSON line a phase and a summary, each with the card's name
and power limit under ``device``.  Runs on the card unless given
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

from .long_train import ROOT, metrics_step as metrics_last_step

CONFIGS = ROOT / "configs"  # the shipped stage configs


def write_stage_config(root: str, stage: str, out_name: str, steps: int, val_every: int,
                       data_overrides: dict, trainer_overrides: dict,
                       configs: Path = CONFIGS) -> str:
    """``configs/config_<stage>.yaml`` with the trainer section and the data
    settings replaced, written to ``root/out_name``; returns its path."""
    from ..config import yaml_dump, yaml_load

    with open(os.path.join(configs, f"config_{stage}.yaml")) as f:
        cfg = yaml_load(f.read())
    cfg["trainer"] = {"max_steps": steps, "log_every_n_steps": 100,
                      "val_check_interval": val_every, **trainer_overrides}
    cfg.setdefault("data", {}).update({"ds_path": os.path.join(root, "ds") + "/", **data_overrides})
    path = os.path.join(root, out_name)
    with open(path, "w") as f:
        f.write(yaml_dump(cfg))
    return path


def fit(root: str, stage: str, cfg_path: str, steps: int, device="cuda",
        log: Callable = print) -> None:
    """``cli fit`` of ``stage`` as a subprocess until its metrics log
    reaches ``steps``, launched again after a crash up to 4 times in all."""
    log_dir = os.path.join(root, "logs50k")
    mpath = os.path.join(log_dir, f"{stage}_metrics.jsonl")
    if metrics_last_step(mpath) >= steps:
        log(phase=f"{stage}_skip", reason="metrics already at budget")
        return
    cmd = [sys.executable, "-m", "megatts2_tpu_torch.cli", "fit", "-c", cfg_path, "--stage", stage,
           "--log_dir", log_dir, "--ckpt_dir", os.path.join(root, "ckpts50k", stage),
           "--device", str(device)]
    t0 = time.time()
    attempts = 0
    while metrics_last_step(mpath) < steps and attempts < 4:
        attempts += 1
        with open(os.path.join(root, f"fit_{stage}_{attempts}.log"), "wb") as lf:
            rc = subprocess.call(cmd, stdout=lf, stderr=subprocess.STDOUT, cwd=ROOT)
        log(phase=f"{stage}_launch", attempt=attempts, rc=rc, reached=metrics_last_step(mpath),
            wall_s=round(time.time() - t0, 1))
        if rc == 0:
            break
    if metrics_last_step(mpath) < steps * 0.99:
        raise RuntimeError(f"{stage} did not reach its budget; see {root}/fit_{stage}_*.log")


def run(root: str, n_speakers: int = 50, n_per_spk: int = 200, gan_steps: int = 30_000,
        plm_steps: int = 14_000, adm_steps: int = 24_000, voc_steps: int = 10_000,
        g_ema_decay: float = 0.999, stages: str = "gan,stage2,plm,adm,vocoder", device="cuda",
        configs: Path = CONFIGS, emit: Callable = print) -> dict:
    """Corpus, prep and every stage of ``stages``; returns the summary it prints."""
    from ..training.checkpoints import best_checkpoint
    from ..training.lm_trainers import train_device
    from .bw_ceiling import card_name

    card = card_name(train_device(device))

    def log(**kw) -> None:
        emit(json.dumps({**kw, "device": card}))

    stages = stages.split(",")
    root = os.path.abspath(root)  # the subprocesses run from the checkout
    ds = os.path.join(root, "ds")
    t_all = time.time()

    # ---- corpus and prep stages 0 and 1 (stage 1's mels on the device) ----
    if not os.path.exists(os.path.join(ds, "cuts_train.jsonl.gz")):
        from .bench_input_pipeline import build_corpus
        from .long_train import prep

        t0 = time.time()
        build_corpus(root, n_speakers, n_per_spk, device=device, emit=emit)
        log(phase="corpus", wall_s=round(time.time() - t0, 1))
        t0 = time.time()
        prep(root, device, workers=4)
        log(phase="prep01", wall_s=round(time.time() - t0, 1))

    # ---- GAN with EMA, the JAX tool's batch geometry ----
    gan_cfg = write_stage_config(
        root, "gan", "gan50k.yaml", gan_steps, 2000,
        {"min_duration": 1.0, "max_duration_batch": 40, "max_timbre_frames": 512},
        {"g_ema_decay": g_ema_decay}, configs)
    if "gan" in stages:
        fit(root, "gan", gan_cfg, gan_steps, device, log)

    # ---- stage 2: latents of the best (EMA) generator ----
    if "stage2" in stages and not os.path.isdir(os.path.join(ds, "latents")):
        ck = best_checkpoint(os.path.join(root, "ckpts50k", "gan"))
        if not ck:
            raise FileNotFoundError("stage 2 needs a trained GAN checkpoint")
        t0 = time.time()
        with open(os.path.join(root, "fit_stage2.log"), "wb") as lf:
            rc = subprocess.call(
                [sys.executable, "-m", "megatts2_tpu_torch.prepare_ds", "--stage", "2",
                 "--ds_path", ds, "--generator_ckpt", ck, "--generator_config", gan_cfg,
                 "--device", str(device)],
                stdout=lf, stderr=subprocess.STDOUT, cwd=ROOT)
        log(phase="stage2", rc=rc, ckpt=ck, wall_s=round(time.time() - t0, 1))
        if rc != 0:
            raise RuntimeError(f"stage 2 failed; see {root}/fit_stage2.log")

    # ---- PLM, ADM and vocoder at the JAX tool's geometries ----
    if "plm" in stages:
        cfg = write_stage_config(root, "plm", "plm.yaml", plm_steps, 1000, {"max_n_cuts": 8}, {},
                                 configs)
        fit(root, "plm", cfg, plm_steps, device, log)
    if "adm" in stages:
        cfg = write_stage_config(root, "adm", "adm.yaml", adm_steps, 2000,
                                 {"max_duration_batch": 200}, {}, configs)
        fit(root, "adm", cfg, adm_steps, device, log)
    if "vocoder" in stages:
        cfg = write_stage_config(root, "vocoder", "vocoder.yaml", voc_steps, 1000,
                                 {"batch_size": 16}, {}, configs)
        fit(root, "vocoder", cfg, voc_steps, device, log)

    # ---- the curves ----
    out = {"phase": "summary", "total_wall_s": round(time.time() - t_all, 1)}
    for stage, keys in (("gan", ("val/loss_re",)), ("plm", ("val/loss", "val/ac10")),
                        ("adm", ("val/loss",)), ("vocoder", ("val/loss",))):
        mpath = os.path.join(root, "logs50k", f"{stage}_metrics.jsonl")
        if not os.path.exists(mpath):
            continue
        with open(mpath) as f:
            rows = [json.loads(line) for line in f]
        out[stage] = {k: [(r["step"], round(r[k], 4)) for r in rows if k in r] for k in keys}
        sps = [r["train/steps_per_sec"] for r in rows if "train/steps_per_sec" in r]
        if sps:
            out[stage]["steps_per_sec_median"] = round(float(sorted(sps)[len(sps) // 2]), 2)
    log(**out)
    return {**out, "device": card}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="/tmp/pipe10k")
    ap.add_argument("--n_speakers", type=int, default=50)
    ap.add_argument("--n_per_spk", type=int, default=200)
    ap.add_argument("--gan_steps", type=int, default=30_000)
    ap.add_argument("--plm_steps", type=int, default=14_000)
    ap.add_argument("--adm_steps", type=int, default=24_000)
    ap.add_argument("--voc_steps", type=int, default=10_000)
    ap.add_argument("--g_ema_decay", type=float, default=0.999)
    ap.add_argument("--stages", default="gan,stage2,plm,adm,vocoder")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.root, a.n_speakers, a.n_per_spk, a.gan_steps, a.plm_steps, a.adm_steps,
               a.voc_steps, a.g_ema_decay, a.stages, a.device)


if __name__ == "__main__":
    main()
