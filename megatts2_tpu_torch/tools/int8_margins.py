"""int8 decode-flip risk on trained PLM weights (port of ``tools/int8_margins.py``).

    python -m megatts2_tpu_torch.tools.int8_margins --train_root DIR [--n_batches 8] [--device cuda]

A teacher-forced bf16 forward of the trained PLM (the best checkpoint
under ``<ckpt_root>/plm``) over ``PLMBatchBuilder`` batches of the
validation cuts, once with the float weights and once with a copy whose
Linear layers ``quantize_`` made int8 (the serving path's weights):

* margins: top-1 minus top-2 logit of the float forward at every
  position whose target is not EOS, as percentiles;
* the int8 perturbation: the largest |logits_q - logits| over the
  vocabulary at each such position, as percentiles;
* teacher-forced argmax agreement of the two on the same trajectory;
* at-risk fractions: positions whose float margin is under the p99
  perturbation (and under twice it).

Under the shipped ``use_flash`` the forward launches kernel B causally
on the card.  Prints one JSON line with the JAX tool's keys and the
card's name and power limit under ``device``.  Runs on the card unless
given ``--device cpu`` (or ``--cpu``).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Callable

import numpy as np
import torch


@torch.no_grad()
def run(train_root: str, ds: str = None, ckpt_root: str = None, n_batches: int = 8,
        batch_cuts: int = 8, device="cuda", report: str = None, emit: Callable = print) -> dict:
    """The margins of the PLM trained under ``train_root``; returns the
    record it prints (and writes to ``report`` when given)."""
    from ..data import CutManifest, DurationBucketSampler, PLMBatchBuilder
    from ..models.pretrained import plm_from_pretrained
    from ..quantization.weight_only import quantize_
    from ..training.checkpoints import best_checkpoint
    from ..training.lm_trainers import train_device
    from .bw_ceiling import card_name

    dev = train_device(device)
    card = card_name(dev)
    ds = ds or os.path.join(train_root, "ds")
    ck = best_checkpoint(os.path.join(ckpt_root or os.path.join(train_root, "ckpts"), "plm"))
    cfg, model = plm_from_pretrained(ck, os.path.join(train_root, "plm.yaml"))
    model = model.to(dev).eval()
    # quantize_ works in place: the int8 model is a copy, the float one stays float
    model_q = quantize_(copy.deepcopy(model), 8)

    manifest = CutManifest.load(os.path.join(ds, "cuts_valid.jsonl.gz"))
    builder = PLMBatchBuilder(manifest, ds, vq_bins=cfg.vq_bins, seed=7)
    sampler = DurationBucketSampler(manifest, max_duration_batch=None, max_cuts=batch_cuts,
                                    num_buckets=1, seed=7)

    # bf16 compute over the stored weights in both, as the serving decode
    # computes: the comparison is like for like
    def forward(m, tc, codes, lens):
        logits, target = m(tc, codes, lens, dtype=torch.bfloat16)
        return logits.float().cpu().numpy(), target.cpu().numpy()

    margins, perturbs, agrees, valid_n = [], [], 0, 0
    batches = 0
    for idx in sampler:
        if batches >= n_batches:
            break
        batch = builder(idx)
        tc = torch.from_numpy(batch["tc_latents"]).float().to(dev)
        codes = torch.from_numpy(batch["p_codes"]).long().to(dev)
        lens = torch.from_numpy(np.asarray(batch["lens"])).to(dev)
        logits, target = forward(model, tc, codes, lens)
        logits_q, _ = forward(model_q, tc, codes, lens)
        valid = target != cfg.eos_id  # (B, T)
        top2 = np.partition(logits, -2, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]  # (B, T) top1 - top2
        pert = np.abs(logits_q - logits).max(axis=-1)  # (B, T) worst coordinate
        agree = logits.argmax(-1) == logits_q.argmax(-1)
        margins.append(margin[valid])
        perturbs.append(pert[valid])
        agrees += int(agree[valid].sum())
        valid_n += int(valid.sum())
        batches += 1

    margins = np.concatenate(margins)
    perturbs = np.concatenate(perturbs)
    pert_p99 = float(np.percentile(perturbs, 99))
    out = {
        "ckpt": ck,
        "positions": int(valid_n),
        "batches": batches,
        "margin_logits": {
            "p1": round(float(np.percentile(margins, 1)), 3),
            "p5": round(float(np.percentile(margins, 5)), 3),
            "p50": round(float(np.percentile(margins, 50)), 3),
            "p95": round(float(np.percentile(margins, 95)), 3),
        },
        "int8_perturbation_logits": {
            "p50": round(float(np.percentile(perturbs, 50)), 4),
            "p99": round(pert_p99, 4),
            "max": round(float(perturbs.max()), 4),
        },
        "teacher_forced_argmax_agreement": round(agrees / max(valid_n, 1), 5),
        # a float margin below the p99 perturbation: a flip is plausible
        "at_risk_fraction_p99": round(float((margins < pert_p99).mean()), 5),
        "at_risk_fraction_2x_p99": round(float((margins < 2 * pert_p99).mean()), 5),
        "device": card,
    }
    line = json.dumps(out)
    emit(line)
    if report:
        with open(report, "w") as f:
            f.write(line + "\n")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train_root", default="/tmp/r5train")
    ap.add_argument("--ds", default=None, help="default: <train_root>/ds")
    ap.add_argument("--ckpt_root", default=None,
                    help="default: <train_root>/ckpts (at_scale_stack "
                         "writes ckpts50k)")
    ap.add_argument("--n_batches", type=int, default=8)
    ap.add_argument("--batch_cuts", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--report", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.train_root, a.ds, a.ckpt_root, a.n_batches, a.batch_cuts,
               "cpu" if a.cpu else a.device, a.report)


if __name__ == "__main__":
    main()
