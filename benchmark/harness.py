"""The benchmark's core: one run of one cell.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

Everything that belongs to one configuration, traffic mix or metric is
found by name:

* the cell, its configuration and the metrics in ``BENCHMARK.json``;
* the configuration's sizes in the file its entry names;
* the traffic mix in ``benchmark/traffic/<traffic>.json``, whose
  ``runner`` names the module of ``benchmark/runners/`` that runs it;
* each metric's reader in ``benchmark/metrics/<metric>.py``, a function
  ``read(rec)`` of the runner's record that returns a number or None; a
  metric split by the end-to-end metric it moves (``idle_share.train``)
  may share the reader of its stem (``idle_share.py``).

A runner's ``run(ctx)`` builds the system under test from the port
(``megatts2_tpu_torch``), warms up the cell's shapes, measures for
``ctx.seconds``, reads the memory peak, frees the port's state, judges
the outputs against ``benchmark/reference.py`` and returns a record
(a dict).  This module checks the device before anything runs, and after
the window that no module of JAX or of the JAX package was loaded; then
it prints the checks on standard error and the result as the last line
of standard output.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "megatts2_tpu")


# ---------------------------------------------------------------- lookup


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"benchmark: no {what} named {name!r} in BENCHMARK.json")


def load_cell(bench: dict, workload: str, root: Path = ROOT):
    """(cell, configuration dict, traffic dict) of ``workload``."""
    cell = find(bench["workloads"], workload, "workload")
    entry = find(bench["configs"], cell["config"], "config")
    with open(root / entry["file"]) as f:
        cfg = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, cfg, traffic


def load_limits(workload: str, root: Path = ROOT) -> Dict[str, float]:
    """The limit of each number compared in the cell: ``benchmark/limits/<cell>.json``."""
    with open(root / "benchmark" / "limits" / f"{workload}.json") as f:
        return json.load(f)["limits"]


def load_runner(name: str):
    return importlib.import_module(f"benchmark.runners.{name}")


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """``benchmark/metrics/<metric>.py``, or else the file of the longest
    stem of the name, cut at a dot (``idle_share.train`` → ``idle_share.py``)."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        path = root / "benchmark" / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    raise SystemExit(f"benchmark: no reader for the metric {metric!r} in benchmark/metrics/")


def load_reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of the metric's file (:func:`reader_path`)."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(f"benchmark_metric__{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, section: str, workload: str) -> List[dict]:
    """The metrics of ``section`` that this cell reports: those that list
    it under ``workloads``, and those that list no cells."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def read_metrics(bench: dict, section: str, workload: str, rec: dict,
                 root: Path = ROOT) -> Dict[str, dict]:
    out = {}
    for m in metrics_of(bench, section, workload):
        value = load_reader(m["name"], root)(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ---------------------------------------------------------------- seeds


def sub_seed(seed: int, *path) -> int:
    """A 63-bit seed for one use of the run's seed (``path`` names the use)."""
    words = [int(seed) % 2**32, int(seed) // 2**32 % 2**32]
    words += [sum(ord(ch) * 131**i for i, ch in enumerate(str(p))) % 2**32 for p in path]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *path) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *path))


# ---------------------------------------------------------------- spans


class Spans:
    """Host-clock intervals of named phases (``perf_counter_ns``), kept only
    when enabled; nested names are fine, each interval is its own."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.items: List[tuple] = []

    def add(self, name: str, t0: int, t1: int) -> None:
        if self.enabled:
            self.items.append((name, t0, t1))

    def wrap(self, fn: Callable, name: str) -> Callable:
        if not self.enabled:
            return fn

        def wrapped(*a, **k):
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **k)
            finally:
                self.items.append((name, t0, time.perf_counter_ns()))

        return wrapped

    def total_s(self, name: str, lo: int = 0, hi: int = 2**63) -> float:
        return sum(min(t1, hi) - max(t0, lo) for n, t0, t1 in self.items
                   if n == name and t1 > lo and t0 < hi) / 1e9


class Tap:
    """Replaces ``obj.attr`` with a wrapper that hands each call's result
    to ``on_result`` (and times it under ``name`` in ``spans``); ``restore``
    puts the original back."""

    def __init__(self, obj, attr: str, on_result: Optional[Callable], spans: Spans,
                 name: Optional[str] = None):
        self.obj, self.attr = obj, attr
        self.orig = getattr(obj, attr)
        had = attr in getattr(obj, "__dict__", {})
        self.saved = obj.__dict__[attr] if had else None
        self.had = had
        inner = spans.wrap(self.orig, name or attr)

        def tapped(*a, **k):
            out = inner(*a, **k)
            if on_result is not None:
                on_result(out, *a, **k)
            return out

        setattr(obj, attr, tapped)

    def restore(self) -> None:
        if self.had:
            setattr(self.obj, self.attr, self.saved)
        else:
            delattr(self.obj, self.attr)


# ---------------------------------------------------------------- the run


@dataclass
class Context:
    """What a runner gets: the cell and its files' contents, the run's
    arguments, the device and the process's start time."""
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = field(default_factory=time.perf_counter)
    work_dir: Path = ROOT / "build" / "benchmark"
    limits: Dict[str, float] = field(default_factory=dict)

    def sync(self) -> None:
        if self.device.startswith("cuda"):
            import torch
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        if self.device.startswith("cuda"):
            import torch
            return int(torch.cuda.max_memory_allocated())
        return 0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_record(ctx: "Context") -> dict:
    if not ctx.device.startswith("cuda"):  # the tests' runs on the CPU
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": ctx.cell["chips"]}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def format_checks(checks: Dict[str, dict]) -> List[str]:
    return [f"check {k} {v['value']!r} limit {v['limit']!r} {'ok' if v['value'] <= v['limit'] else 'FAIL'}"
            for k, v in checks.items()]


def compared(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """The numbers the cell compares, each beside its limit (a number not
    read is infinite, so it fails)."""
    return {k: {"value": readings.get(k, float("inf")), "limit": v} for k, v in limits.items()}


def judge(checks: Dict[str, dict]) -> bool:
    """Correct when every number compared is finite and within its limit."""
    return bool(checks) and all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                                for v in checks.values())


def run_cell(bench: dict, ctx: Context, root: Path = ROOT):
    """Everything of a run after the look for the card: the runner's run,
    the look for JAX, the metrics of the run's kind.  → (the result's
    dict, the runner's record); (None, record) when JAX was loaded."""
    ctx.work_dir.mkdir(parents=True, exist_ok=True)
    rec = load_runner(ctx.traffic["runner"]).run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return None, rec
    name = ctx.cell["name"]
    section = "per_layer" if ctx.trace else "end_to_end"
    device = {**card_record(ctx), "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": judge(rec["checks"]), "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": read_metrics(bench, section, name, rec, root)}
    if ctx.trace:
        device.update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
    out["device"] = device
    if ctx.trace:
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = rec["checks"]  # last: each number compared beside its limit
    return out, rec


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    bench = load_benchmark()
    cell, cfg, traffic = load_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"benchmark: {args.workload} seed {args.seed} on {power_limit()}", file=sys.stderr)
    ctx = Context(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace),
                  t_start=t_start, limits=load_limits(args.workload))
    out, rec = run_cell(bench, ctx)
    if out is None:
        return 3
    for line in rec.get("notes", []):
        print(line, file=sys.stderr)
    for line in format_checks(rec["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
