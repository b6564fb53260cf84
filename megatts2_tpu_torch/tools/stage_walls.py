"""Stage walls of the full-width float synthesis slice on the card.

    python megatts2_tpu_torch/tools/stage_walls.py [--root DIR] [--runs N]

Builds the slice ``chip_smoke.py`` drives first (``MegaGConfig`` with
``use_flash`` under the MRTE, ``MegaPLMConfig()``,
``MegaADMConfig(tc_emb_dim=512)``, Vocos; seeded random weights; bf16),
runs ``Megatts.synthesize_batch`` at B=8, Tp=64, Tm=512 and 512 frames
once cold and ``--runs`` times warm, and prints one JSON line: each
stage's median and range of wall ms (the device synchronised at each stage
boundary, ``synthesize(stage_times=...)``), the batch walls, the card's
name and power limit, and ``package``, the tree that ran.  ``--root``
imports ``megatts2_tpu_torch`` from another checkout (an older tree
unpacked beside this one), so two versions are timed by one script on one
card; run them in turns (A, B, B, A) in one call.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]  # the checkout that holds this file
TEXT = " ".join(["hello world"] * 16)  # 63 phones → Tp 64


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT), help="checkout whose megatts2_tpu_torch to time")
    ap.add_argument("--runs", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    if not torch.cuda.is_available():
        raise SystemExit("stage_walls: needs a CUDA device")
    import megatts2_tpu_torch
    from megatts2_tpu_torch import config as c
    from megatts2_tpu_torch import models as m
    from megatts2_tpu_torch.ops import mel_spectrogram
    from megatts2_tpu_torch.tools.bw_ceiling import card_name

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    g, plm, adm, voc = (m.init_random_(mod, gen) for mod in (
        m.MegaG(c.MegaGConfig(mrte=c.MRTEConfig(use_flash=True))), m.MegaPLM(c.MegaPLMConfig()),
        m.MegaADM(c.MegaADMConfig(tc_emb_dim=512)), m.Vocos(c.VocosConfig())))
    with tempfile.NamedTemporaryFile("w", suffix=".txt") as sym:
        sym.write("".join(f"{s} {i}\n" for i, s in enumerate(["<eps>", "_", "-", "hello", "world"])))
        sym.flush()
        tts = m.Megatts(g, plm, adm, voc, sym.name, max_frames=512, dtype=torch.bfloat16, device=dev)
    sig = torch.randn(8, 131000, generator=torch.Generator().manual_seed(0)) * 0.1
    mels = mel_spectrogram(sig.to(dev))
    stages: dict = {}
    walls = []
    for i in range(args.runs + 1):
        times: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.synthesize_batch([TEXT] * 8, mels, stage_times=times)
        torch.cuda.synchronize()
        if i:  # the first run is cold
            walls.append((time.perf_counter() - t0) * 1e3)
            for k, v in times.items():
                stages.setdefault(k, []).append(v * 1e3)
    print(json.dumps({
        "package": megatts2_tpu_torch.__file__, "runs": args.runs,
        "stage_ms": {k: {"median": statistics.median(v), "min": min(v), "max": max(v)}
                     for k, v in stages.items()},
        "batch_ms": {"median": statistics.median(walls), "min": min(walls), "max": max(walls)},
        "card": card_name(dev)}), flush=True)


if __name__ == "__main__":
    main()
