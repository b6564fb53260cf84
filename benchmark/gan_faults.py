"""Faults planted under the GAN cell's timed path, to show that its check
catches them (``faults.py`` holds those of the other cells): the tests run
each at test size, and this script reads them on the chip at the cell's
own size.

    python3 benchmark/gan_faults.py --workload gan-train.fit-b64 --fault <name> --seeds 1,2

* ``state_unchanged``: a step computes and applies both updates, then
  puts G's and D's weights and statistics back.
* ``frozen_codebook``: a step puts the codebook's statistics back after
  its update, the rest of it as it was.
* ``shifted_codes``: the codebook takes, for each latent, the code after
  its nearest (the rest of the step consistent with it).
* ``half_batch``: a step trains on the batch's first half of rows, with
  those rows' draws (the codebook's sample rows folded into its latents).

One JSON line a seed: the readings of the check and ``correct`` as
``harness.judge`` decides a run under the cell's limits.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

NAMES = ("state_unchanged", "frozen_codebook", "shifted_codes", "half_batch")


@contextlib.contextmanager
def planted(name: str):
    import torch

    from megatts2_tpu_torch import training

    if name not in NAMES:
        raise ValueError(f"no fault named {name!r}")
    if name == "shifted_codes":
        from megatts2_tpu_torch.quantization import vq

        scores = vq._scores
        vq._scores = lambda x, embed: scores(x, embed).roll(1, dims=-1)
        try:
            yield
        finally:
            vq._scores = scores
        return
    make = training.make_gan_train_step
    if name == "half_batch":
        def halved(g_cfg, d_cfg, tcfg):
            real = make(g_cfg, d_cfg, tcfg)

            def step(state, batch):
                B, T = batch["mel_targets"].shape[:2]
                rows = B // 2
                replay = state.draws.replay
                if replay is not None:  # the rows' masks; sample rows among their latents
                    n = rows * -(-T // g_cfg.vqpe.stride)
                    replay["masks"] = [m[:rows] for m in replay["masks"]]
                    replay["indices"] = [i % n for i in replay["indices"]]
                return real(state, {k: v[:rows] for k, v in batch.items()})
            return step

        training.make_gan_train_step = halved
        try:
            yield
        finally:
            training.make_gan_train_step = make
        return

    def kept(state):
        if name == "state_unchanged":
            return [m.state_dict() for m in (state.g, state.d)], (state.g, state.d)
        cb = state.g.vqpe.vq.layers[0]._codebook
        return [cb.state_dict()], (cb,)

    def wrap(real):
        def step(state, batch):
            saved, modules = kept(state)
            saved = [{k: v.detach().clone() for k, v in sd.items()} for sd in saved]
            metrics = real(state, batch)
            with torch.no_grad():
                for m, sd in zip(modules, saved):
                    m.load_state_dict(sd)
            return metrics
        return step

    training.make_gan_train_step = lambda *a, **k: wrap(make(*a, **k))
    try:
        yield
    finally:
        training.make_gan_train_step = make


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=NAMES)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell, cfg, traffic = harness.load_cell(bench, args.workload)
    limits = harness.load_limits(args.workload)
    runner = harness.load_runner(traffic["runner"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = harness.Context(cell, cfg, traffic, seed, args.seconds, False, limits=limits)
        with planted(args.fault):
            rec = runner.run(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "program": rec["readings"], "correct": harness.judge(rec["checks"]),
                          "notes": rec["notes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
