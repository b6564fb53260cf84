"""One run of a cell with the port's tracer on, read by the span metrics.

    python3 benchmark/span_probe.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The runners of ``benchmark/runners/`` do not turn the port's tracer on, so
the readers under ``benchmark/metrics/`` that no declared metric uses yet
(those of the port's spans) find nothing in their records.  This script
runs the cell as ``benchmark/run.py`` does, with the tracer
(``megatts2_tpu_torch/utils/tracing.py``) on from the start; the spans of
set-up and warm-up are dropped at the runner's first synchronisation, and
those of the window are drained when the traced slice is reduced, where
they also name the idle gaps (beside the runner's own phases) and
:func:`program_spans.by_span` counts the device ops inside them.  The last
line of standard output is ``run.py``'s result with, under ``metrics``,
every undeclared reader that found something, under ``program`` the
window's spans summed by name, and ``by_span``.  Set beside ``run.py``'s
runs of the same seeds, it measures what the tracer costs when on.
"""
import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD, "triton_cache"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(BUILD, "torch_extensions"))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark import program_spans as P  # noqa: E402
from benchmark import trace as T  # noqa: E402


def undeclared_readers(bench: dict) -> list:
    """Names of the readers under ``benchmark/metrics/`` that no metric of
    ``bench`` resolves to."""
    used = {harness.reader_path(m["name"]) for section in ("end_to_end", "per_layer")
            for m in bench[section]}
    return sorted(p.stem for p in (harness.ROOT / "benchmark" / "metrics").glob("*.py")
                  if p not in used)


def main(argv) -> int:
    from megatts2_tpu_torch.utils import tracing

    args = harness.parse(argv)
    bench = harness.load_benchmark()
    cell, cfg, traffic = harness.load_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"span_probe: the cell needs {cell['chips']} CUDA device(s)", file=sys.stderr)
        return 2
    program = {"spans": [], "slice_ns": None}

    class ProbeContext(harness.Context):
        synced = False

        def sync(self) -> None:
            super().sync()
            if not self.synced:  # the runner's first: set-up and warm-up end here
                self.synced = True
                tracing.drain()

    class ProbeSlice(T.Slice):
        def result(self, phases_ns):
            spans = tracing.drain()
            program["spans"] = [list(s) for s in spans]
            program["slice_ns"] = [int(self.t_enter * 1e9), int(self.t_exit * 1e9)]
            seen, summarize = {}, T.summarize

            def keep_ops(ops, t0, t1, phases):  # the ops as Slice.result maps them
                seen["ops"] = ops
                return summarize(ops, t0, t1, phases)

            T.summarize = keep_ops
            try:
                out = super().result(list(phases_ns) + [s[:3] for s in spans])
            finally:
                T.summarize = summarize
            at = [(n, (a - self.h0) / 1e9, (b - self.h0) / 1e9, k) for n, a, b, k in spans]
            out["by_span"] = P.by_span(seen["ops"], at, out["window_s"])
            return out

    runner = harness.load_runner(traffic["runner"])
    runner.Slice = ProbeSlice
    tracing.enable()
    print(f"span_probe: {args.workload} seed {args.seed} on {harness.power_limit()}",
          file=sys.stderr)
    ctx = ProbeContext(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace),
                       t_start=T_START, limits=harness.load_limits(args.workload))
    out, rec = harness.run_cell(bench, ctx)
    if out is None:
        return 3
    if not args.trace:  # the window's spans: no slice drained them
        program["spans"] = [list(s) for s in tracing.drain()]
    rec["program"] = program
    for name in undeclared_readers(bench) if args.trace else []:
        value = harness.load_reader(name)(rec)
        if value is not None:
            out["metrics"][name] = {"value": float(value)}
    by_name = {}
    for name, t0, t1, n in program["spans"]:
        acc = by_name.setdefault(name, {"count": 0, "host_s": 0.0, "n": 0})
        acc["count"] += 1
        acc["host_s"] += (t1 - t0) / 1e9
        acc["n"] += n
    out["program"] = {"spans": by_name, "slice_ns": program["slice_ns"]}
    if args.trace:
        out["by_span"] = rec["trace"]["by_span"]
    for line in rec.get("notes", []) + harness.format_checks(rec["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
