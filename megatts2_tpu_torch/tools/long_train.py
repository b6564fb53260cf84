"""Long GAN training run at corpus scale, with a mid-run kill and resume
(port of ``tools/long_train.py``).

    python -m megatts2_tpu_torch.tools.long_train --root DIR --steps 50000 --kill_at 20000 [--device cuda]

Drives the port's product path end to end on a corpus under ``--root``
(``bench_input_pipeline``'s, 10k utterances by default there):
``prepare_ds`` stages 0+1, then ``python -m megatts2_tpu_torch.cli fit
--stage gan`` as a subprocess for ``--steps`` steps on
``configs/config_gan.yaml`` with only the trainer and data sections cut
(logging every 100 steps, validating and checkpointing every
``--val_every``; batches of up to 40 s, timbre prompts of up to 512
frames).  The config is written in the YAML subset the port reads.  With
``--kill_at``, the trainer is SIGKILLed the first time its metrics log
crosses that step (the log is polled every ``POLL_S`` seconds) and
launched again with the same command; the CLI resumes from
``latest_checkpoint``, so the append-mode log shows the curve across the
kill.  Prints one JSON line per phase and a summary; every line carries
the card's name and power limit.  Runs on the card unless given
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

from ..config import yaml_dump
from ..training.lm_trainers import train_device
from .bw_ceiling import card_name

ROOT = Path(__file__).resolve().parents[2]  # the checkout: the subprocess's working directory
POLL_S = 0.1  # a read of a few hundred KB of log: cheap, and a short run is killed on time
SHIPPED = ROOT / "configs" / "config_gan.yaml"


def prep(root: str, device="cuda", workers: int = 4) -> str:
    """``prepare_ds`` stages 0 and 1 over ``root``'s wavs and textgrids."""
    from ..prepare_ds import main as prep_main

    wavs, tgs, ds = (os.path.join(root, d) for d in ("wavs", "textgrids", "ds"))
    prep_main(["--stage", "0", "--wavtxt_path", wavs, "--num_workers", str(workers)])
    prep_main(["--stage", "1", "--wavtxt_path", wavs, "--text_grid_path", tgs, "--ds_path", ds,
               "--num_workers", str(workers), "--device", str(device)])
    return ds


def write_config(root: str, ds: str, steps: int, val_every: int, shipped: str = str(SHIPPED),
                 log_every: int = 100) -> str:
    """``shipped`` with only the trainer and data sections cut; the path."""
    from ..config import yaml_load

    with open(shipped) as f:
        cfg = yaml_load(f.read())
    cfg["trainer"] = {"max_steps": steps, "log_every_n_steps": log_every,
                      "val_check_interval": val_every}
    # batches of up to 40 s (B=12 on the 3.2 s corpus) and a 512-frame
    # timbre cap: the JAX tool's device geometry
    cfg.setdefault("data", {}).update({"ds_path": ds + "/", "min_duration": 1.0,
                                       "max_duration_batch": 40, "max_timbre_frames": 512})
    path = os.path.join(root, "gan50k.yaml")
    with open(path, "w") as f:
        f.write(yaml_dump(cfg))
    return path


def metrics_step(path: str) -> int:
    """Last logged step in a metrics jsonl (0 if absent or empty); a line
    that is being written is skipped."""
    if not os.path.exists(path):
        return 0
    last = 0
    with open(path) as f:
        for line in f:
            try:
                last = max(last, json.loads(line)["step"])
            except (json.JSONDecodeError, KeyError):
                pass
    return last


def run(root: str, steps: int = 50_000, val_every: int = 2_000, kill_at: int = 0,
        skip_prep: bool = False, device="cuda", shipped: str = str(SHIPPED), log_every: int = 100,
        emit: Callable = print) -> dict:
    """Prep, train with the kill and resume, summarize; returns the summary."""
    card = card_name(train_device(device))
    root = os.path.abspath(root)  # the trainer runs from the checkout

    def out(rec: dict) -> None:
        emit(json.dumps({**rec, "device": card}))

    ds = os.path.join(root, "ds")
    if not skip_prep:
        t0 = time.time()
        ds = prep(root, device)
        out({"phase": "prep01", "wall_s": round(time.time() - t0, 1)})
    cfg_path = write_config(root, ds, steps, val_every, shipped, log_every)
    log_dir = os.path.join(root, "logs50k")
    ckpt_dir = os.path.join(root, "ckpts50k", "gan")
    mpath = os.path.join(log_dir, "gan_metrics.jsonl")
    cmd = [sys.executable, "-m", "megatts2_tpu_torch.cli", "fit", "-c", cfg_path, "--stage", "gan",
           "--log_dir", log_dir, "--ckpt_dir", ckpt_dir, "--device", str(device)]

    launches = []
    killed_at: Optional[int] = None
    t_start = time.time()
    while metrics_step(mpath) < steps:
        t0 = time.time()
        with open(os.path.join(root, f"fit_{len(launches)}.log"), "wb") as lf:
            proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT, cwd=ROOT)
            try:
                while proc.poll() is None:
                    time.sleep(POLL_S)
                    step = metrics_step(mpath)
                    if kill_at and killed_at is None and step >= kill_at:
                        proc.send_signal(signal.SIGKILL)
                        proc.wait()
                        killed_at = step
                        out({"phase": "killed", "at_step": step})
                        break
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        launches.append({"rc": proc.returncode, "wall_s": round(time.time() - t0, 1),
                         "reached_step": metrics_step(mpath)})
        out({"phase": "launch_done", **launches[-1]})
        if proc.returncode == 0:
            break  # normal completion (max_steps reached)
        if proc.returncode != -signal.SIGKILL:
            out({"phase": "abort", "rc": proc.returncode})
            break

    rows = []
    if os.path.exists(mpath):
        with open(mpath) as f:
            rows = [json.loads(line) for line in f]
    val = [(r["step"], round(r["val/loss_re"], 4)) for r in rows if "val/loss_re" in r]
    tr = [(r["step"], round(r["train/G_loss_re"], 4)) for r in rows if "train/G_loss_re" in r]
    sps = sorted(r["train/steps_per_sec"] for r in rows if "train/steps_per_sec" in r)
    best = min(val, key=lambda x: x[1]) if val else None
    summary = {"phase": "summary", "total_wall_s": round(time.time() - t_start, 1),
               "launches": launches, "killed_at_step": killed_at, "val_curve": val,
               "train_curve_every_1k": tr[9::10], "best_val_loss_re": best,
               "steps_per_sec_median": round(float(sps[len(sps) // 2]), 2) if sps else None}
    out(summary)
    return {**summary, "device": card}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--steps", type=int, default=50_000)
    ap.add_argument("--val_every", type=int, default=2_000)
    ap.add_argument("--kill_at", type=int, default=0,
                    help=">0: SIGKILL the trainer once the log crosses this "
                         "step, then relaunch (resume evidence)")
    ap.add_argument("--skip_prep", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.root, a.steps, a.val_every, a.kill_at, a.skip_prep, a.device)


if __name__ == "__main__":
    main()
