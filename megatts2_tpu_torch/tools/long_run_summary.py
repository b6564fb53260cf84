"""Summarize a long-run GAN metrics jsonl (``tools/long_train.py``'s; port
of ``tools/long_run_summary.py``, plain JSON, no device).

    python -m megatts2_tpu_torch.tools.long_run_summary DIR/logs50k/gan_metrics.jsonl

Prints one JSON line: the validation curve, the best validation mel L1,
the median steps/s, and the resume evidence: every point where the
append-mode log's step sequence jumps backwards is a kill and restore (the
CLI restored the latest checkpoint and logged again the steps after it).
"""
from __future__ import annotations

import json
import sys
from typing import Callable


def summarize(path: str, emit: Callable = print) -> dict:
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    # the logging cadence, inferred from the data (not assumed): the modal
    # positive step delta between consecutive rows of the same metric
    deltas: dict = {}
    prev_s = None
    for r in rows:
        if "train/steps_per_sec" in r:
            if prev_s is not None and r["step"] > prev_s:
                d = r["step"] - prev_s
                deltas[d] = deltas.get(d, 0) + 1
            prev_s = r["step"]
    cadence = max(deltas, key=deltas.get) if deltas else 0
    resumes = []  # once per backwards jump in the append-only log
    last = 0
    prev = 0
    for r in rows:
        s = r["step"]
        if s < prev and "train/steps_per_sec" in r:
            # the first row logged again sits one cadence past the restore point
            resumes.append({"restored_to": s - cadence, "killed_after": last})
        prev = s
        last = max(last, s)

    # the effective curve: the last value logged at each step (a resume overwrites)
    by_step: dict = {}
    for r in rows:
        by_step.setdefault(r["step"], {}).update(r)
    val = [(s, round(d["val/loss_re"], 4)) for s, d in sorted(by_step.items())
           if "val/loss_re" in d]
    tr = [(s, round(d["train/G_loss_re"], 4)) for s, d in sorted(by_step.items())
          if "train/G_loss_re" in d]
    sps = sorted(d["train/steps_per_sec"] for d in by_step.values()
                 if "train/steps_per_sec" in d)
    wall = rows[-1]["time"] - rows[0]["time"]
    best = min(val, key=lambda x: x[1]) if val else None
    rec = {
        "max_step": last,
        "resume_events": resumes,
        "best_val_loss_re": best,
        "val_curve": val,
        "train_loss_re_every_2k": tr[19::20],
        "steps_per_sec_median": round(sps[len(sps) // 2], 1) if sps else None,
        "total_wall_s": round(wall, 1),
    }
    emit(json.dumps(rec))
    return rec


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: python -m megatts2_tpu_torch.tools.long_run_summary METRICS.jsonl")
    return summarize(argv[0])


if __name__ == "__main__":
    main()
