"""Quality signal: train the full-size stages on a synthetic corpus and
record their validation curves (port of ``tools/train_curve.py``).

    python -m megatts2_tpu_torch.tools.train_curve --stages gan,vocoder,plm,adm \\
        --steps 2000 --lm_steps 1000 --root DIR [--device cuda]

Builds a structured 2-speaker corpus (harmonic stacks with an AM
envelope, one f0 an utterance, so mels are learnable; the files byte for
byte those of the JAX tool), runs ``prepare_ds`` stages 0 and 1, then
``cli fit`` in this process on the shipped ``configs/config_<stage>.yaml``
with only the trainer section and the JAX tool's data settings changed,
and prints the train and validation curves of each stage.  The PLM and
ADM train on stage-2 latents extracted from the GAN's latest checkpoint.
Configs are written in the YAML subset the port reads.  Prints one JSON
line with the JAX tool's keys and the card's name and power limit under
``device``.  Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path
from typing import Callable

import numpy as np

CONFIGS = Path(__file__).resolve().parents[2] / "configs"  # the shipped stage configs


def build_corpus(root: str, n_per_spk: int = 24, seed: int = 0) -> tuple:
    """Two speakers (f0 near 110 and 220 Hz) of ``n_per_spk`` 3.2 s
    utterances of the same six words; returns (wavs, textgrids, ds)."""
    from ..utils.audio import save_wav

    wavs = os.path.join(root, "wavs")
    tgs = os.path.join(root, "textgrids")
    ds = os.path.join(root, "ds")
    os.makedirs(ds, exist_ok=True)
    words = ["hello", "world", "nice", "day", "of", "speech"]
    rng = np.random.RandomState(seed)
    sr = 16000
    for spk_i, spk in enumerate(("spkA", "spkB")):
        os.makedirs(os.path.join(wavs, spk), exist_ok=True)
        os.makedirs(os.path.join(tgs, spk), exist_ok=True)
        for i in range(n_per_spk):
            # one duration, as the JAX tool's corpus: one batch shape
            dur_s = 3.2
            n = int(dur_s * sr)
            t = np.arange(n) / sr
            f0 = 110 * (spk_i + 1) * (1 + 0.3 * rng.rand())
            # harmonic stack with an AM envelope: learnable structure
            y = sum(
                (0.4 / h) * np.sin(2 * np.pi * f0 * h * t + rng.rand() * 6.28)
                for h in range(1, 6)
            )
            y *= 0.5 + 0.5 * np.sin(2 * np.pi * (2 + rng.rand()) * t) ** 2
            y = (y + 0.01 * rng.randn(n)).astype(np.float32)
            y /= np.abs(y).max() + 1e-6
            uid = f"{spk}_u{i}"
            save_wav(os.path.join(wavs, spk, uid + ".wav"), y)
            with open(os.path.join(wavs, spk, uid + ".txt"), "w") as f:
                f.write(" ".join(words))
            seg = dur_s / len(words)
            iv = "".join(
                f"""        intervals [{j+1}]:
            xmin = {j*seg}
            xmax = {(j+1)*seg}
            text = "{w}"
"""
                for j, w in enumerate(words)
            )
            with open(os.path.join(tgs, spk, uid + ".TextGrid"), "w") as f:
                f.write(
                    'File type = "ooTextFile"\nObject class = "TextGrid"\n'
                    f"xmin = 0\nxmax = {dur_s}\ntiers? <exists>\nsize = 1\nitem []:\n"
                    "    item [1]:\n"
                    '        class = "IntervalTier"\n        name = "phones"\n'
                    f"        xmin = 0\n        xmax = {dur_s}\n"
                    f"        intervals: size = {len(words)}\n" + iv
                )
    return wavs, tgs, ds


def _curve(log_dir: str, name: str, keys: tuple) -> dict:
    path = os.path.join(log_dir, f"{name}_metrics.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return {k: [(r["step"], round(r[k], 4)) for r in rows if k in r] for k in keys}


def run(root: str = None, steps: int = 2000, lm_steps: int = 0, stages: str = "gan",
        val_every: int = 200, n_per_spk: int = 24, n_speakers: int = 2, device="cuda",
        configs: Path = CONFIGS, emit: Callable = print) -> dict:
    """Corpus, prep, the fits of ``stages``; returns the record it prints.
    ``configs`` holds the ``config_<stage>.yaml`` files the fits start from."""
    from .. import cli, prepare_ds
    from ..config import yaml_dump, yaml_load
    from ..training.checkpoints import latest_checkpoint
    from ..training.lm_trainers import train_device
    from .bw_ceiling import card_name

    dev = train_device(device)
    card = card_name(dev)
    stages = stages.split(",")
    root = root or tempfile.mkdtemp(prefix="megatts_curve_")
    if n_speakers != 2:
        from .bench_input_pipeline import build_corpus as build_scaled

        wavs, tgs, ds = build_scaled(root, n_speakers, n_per_spk, device=dev, emit=emit)
    else:
        wavs, tgs, ds = build_corpus(root, n_per_spk)

    prepare_ds.main(["--stage", "0", "--wavtxt_path", wavs, "--num_workers", "2"])
    prepare_ds.main(["--stage", "1", "--wavtxt_path", wavs, "--text_grid_path", tgs,
                     "--ds_path", ds, "--test_set_ratio", "0.125", "--device", str(device)])

    log_dir = os.path.join(root, "logs")
    report = {"corpus": root, "steps": steps}

    def fit(stage: str, n_steps: int, data_overrides: dict) -> None:
        with open(os.path.join(configs, f"config_{stage}.yaml")) as f:
            cfg = yaml_load(f.read())
        cfg["trainer"] = {"max_steps": n_steps, "log_every_n_steps": 50,
                          "val_check_interval": val_every}
        cfg.setdefault("data", {}).update({"ds_path": ds + "/", "min_duration": 1.0,
                                           **data_overrides})
        cfg_path = os.path.join(root, f"{stage}.yaml")
        with open(cfg_path, "w") as f:
            f.write(yaml_dump(cfg))
        cli.main(["fit", "-c", cfg_path, "--stage", stage, "--log_dir", log_dir,
                  "--ckpt_dir", os.path.join(root, "ckpts", stage), "--device", str(device)])

    if "gan" in stages:
        # the JAX tool's data settings: batches of up to 40 s, timbre
        # prompts of up to 512 frames
        fit("gan", steps, {"max_duration_batch": 40, "max_timbre_frames": 512})
        report["gan"] = _curve(log_dir, "gan", ("train/G_loss_re", "val/loss_re"))

    if "vocoder" in stages:
        # the manifests carry wav_path: no GAN checkpoint is needed
        fit("vocoder", lm_steps or steps, {"batch_size": 8})
        report["vocoder"] = _curve(log_dir, "vocoder",
                                   ("train/G_loss_mel", "train/D_loss_total", "val/loss"))

    if "plm" in stages or "adm" in stages:
        ck = latest_checkpoint(os.path.join(root, "ckpts", "gan"))
        if not ck:
            raise FileNotFoundError("PLM/ADM curves need a trained GAN checkpoint (run gan first)")
        prepare_ds.main(["--stage", "2", "--ds_path", ds, "--generator_ckpt", ck,
                         "--generator_config", os.path.join(root, "gan.yaml"),
                         "--device", str(device)])
        n_lm = lm_steps or steps
        if "plm" in stages:
            fit("plm", n_lm, {"max_n_cuts": 4})
            report["plm"] = _curve(log_dir, "plm", ("train/loss", "val/loss", "val/ac10"))
        if "adm" in stages:
            fit("adm", n_lm, {"max_duration_batch": 200})
            report["adm"] = _curve(log_dir, "adm", ("train/loss", "val/loss"))

    report["device"] = card
    emit(json.dumps(report))
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000, help="GAN steps")
    ap.add_argument("--lm_steps", type=int, default=0,
                    help="PLM/ADM/vocoder steps (0 = --steps)")
    ap.add_argument("--stages", default="gan",
                    help="comma list from {gan,plm,adm,vocoder}; plm/adm run "
                         "stage-2 extraction off the trained GAN ckpt")
    ap.add_argument("--val_every", type=int, default=200)
    ap.add_argument("--n_per_spk", type=int, default=24)
    ap.add_argument("--n_speakers", type=int, default=2,
                    help=">2 uses the scaled corpus generator "
                         "(bench_input_pipeline.build_corpus, log-spread f0s)")
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.root, a.steps, a.lm_steps, a.stages, a.val_every, a.n_per_spk, a.n_speakers,
               a.device)


if __name__ == "__main__":
    main()
