"""The port's own spans (``megatts2_tpu_torch/utils/tracing.py``) in a run's
record, and the device ops that ran inside them.

A run that turns the port's tracer on over the window keeps what it drained
as ``rec["program"]``: ``spans`` (``[name, t0_ns, t1_ns, n]`` on
``time.perf_counter_ns``, the benchmark's clock) and ``slice_ns`` (the
traced slice as the host clocked it, the profiler's own start and stop
included; None without one).  :func:`by_span` adds, for each
span name, the device ops of the traced slice that started inside its spans
(``rec["trace"]["by_span"]``).  The metrics ``decode_step_*`` and
``batch_copy_ms`` read them; a record without them reads nothing.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from .trace import busy_union


def by_span(ops: List[Tuple[str, float, float]], spans: List[Tuple[str, float, float, int]],
            window_s: float) -> Dict[str, dict]:
    """Per span name, over its spans lying wholly inside the slice [0,
    ``window_s``] (seconds on the host clock, as :func:`trace.summarize`'s
    ops): ``spans``, their host seconds, their summed ``n``, the device
    ``ops`` whose start falls inside one, and ``busy_s``, the union of those
    ops' intervals, summed over the spans."""
    out: Dict[str, dict] = {}
    intervals = sorted((s, e) for _, s, e in ops)
    starts = [s for s, _ in intervals]
    for name, t0, t1, n in spans:
        if t0 < 0 or t1 > window_s:
            continue
        inside = intervals[bisect.bisect_left(starts, t0): bisect.bisect_right(starts, t1)]
        acc = out.setdefault(name, {"spans": 0, "host_s": 0.0, "n": 0, "ops": 0, "busy_s": 0.0})
        acc["spans"] += 1
        acc["host_s"] += t1 - t0
        acc["n"] += n
        acc["ops"] += len(inside)
        acc["busy_s"] += busy_union(inside)[0]
    return out


def outside_slice(rec: dict, name: str) -> List[Tuple[int, int, int]]:
    """``(t0_ns, t1_ns, n)`` of the program's spans ``name`` that do not
    overlap the traced slice, where launches run at the host's own pace."""
    prog = rec.get("program")
    if not prog:
        return []
    lo, hi = prog.get("slice_ns") or (0, 0)
    return [(t0, t1, n) for s, t0, t1, n in prog["spans"]
            if s == name and (t1 <= lo or t0 >= hi)]


def host_ms_per_unit(rec: dict, name: str) -> Optional[float]:
    """Host ms of the spans ``name`` outside the slice over their summed ``n``."""
    got = outside_slice(rec, name)
    units = sum(n for _, _, n in got)
    return 1e-6 * sum(t1 - t0 for t0, t1, _ in got) / units if units else None


def host_ms_per_span(rec: dict, name: str) -> Optional[float]:
    """Mean host ms of the spans ``name`` outside the slice."""
    got = outside_slice(rec, name)
    return 1e-6 * sum(t1 - t0 for t0, t1, _ in got) / len(got) if got else None


def in_slice_per_unit(rec: dict, name: str, key: str) -> Optional[float]:
    """``by_span``'s ``key`` of the spans ``name`` inside the slice over their ``n``."""
    got = rec.get("trace", {}).get("by_span", {}).get(name)
    return got[key] / got["n"] if got and got["n"] else None
