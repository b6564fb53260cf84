"""The device trace of a slice of the measured window (``--trace 1``).

``torch.profiler`` records the device's kernels, copies and sets (CUDA
activity only, so the host pays little) from the slice's start to its end.
The slice's start and end are host-clock instants after a synchronisation;
a marker kernel launched at the start ties the device's timeline to the
host clock, so the window is the slice as the host measured it, and
device time before the first op or after the last one counts as idle (the
repair of ``tools/profile_train.summarize``, whose window ran from the
first device op to the last).  Idle gaps are named by the host phase
(``harness.Spans``) that was running at their middle.
"""
from __future__ import annotations

import collections
import time
from typing import List, Tuple

MARKER_CYCLES = 1000
TOP = 10


def busy_union(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, the gaps between covered stretches) of intervals."""
    busy, end, gaps = 0.0, None, []
    for s, e in sorted(spans):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def summarize(ops: List[Tuple[str, float, float]], t0: float, t1: float,
              phases: List[Tuple[str, float, float]]) -> dict:
    """Reduce device ops ``(name, start, end)`` (seconds, host clock) to the
    window [t0, t1]: busy and window seconds, the top ops by time, the
    longest idle gaps by host phase, and every op's total and count."""
    inside = [(n, max(s, t0), min(e, t1)) for n, s, e in ops if e > t0 and s < t1]
    busy, gaps = busy_union([(s, e) for _, s, e in inside])
    if inside:
        first, last = min(s for _, s, _ in inside), max(e for _, _, e in inside)
        gaps = [(t0, first)] + gaps + [(last, t1)]
    else:
        gaps = [(t0, t1)]
    tot, cnt = collections.Counter(), collections.Counter()
    for n, s, e in inside:
        tot[n] += e - s
        cnt[n] += 1
    idle = collections.Counter()
    for s, e in gaps:
        if e > s:
            idle[phase_at(phases, (s + e) / 2)] += e - s
    return {"busy_s": busy, "window_s": t1 - t0,
            "device_ops": [[n[:120], v] for n, v in tot.most_common(TOP)],
            "idle_gaps": [[n, v] for n, v in idle.most_common(TOP)],
            "op_s": dict(tot), "op_count": dict(cnt)}


def phase_at(phases: List[Tuple[str, float, float]], t: float) -> str:
    """The innermost (latest-starting) phase running at ``t``."""
    best = None
    for n, s, e in phases:
        if s <= t <= e and (best is None or s > best[1]):
            best = (n, s)
    return best[0] if best else "between phases"


class Slice:
    """Profile the device from ``start`` to ``stop``; ``result`` is
    :func:`summarize`'s dict with ``phases`` given in host ns."""

    def __init__(self):
        self.prof = None
        self.h0 = self.h1 = None
        self.t_enter = self.t_exit = 0.0

    @property
    def span_s(self) -> float:
        """Host seconds from before the profiler starts to after it stops,
        its own costs included: the part of the window the slice took."""
        return self.t_exit - self.t_enter

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.t_enter = time.perf_counter()
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.h0 = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.h1 = time.perf_counter_ns()
        self.prof.__exit__(None, None, None)
        self.t_exit = time.perf_counter()

    def result(self, phases_ns: List[Tuple[str, int, int]]) -> dict:
        from torch.autograd import DeviceType

        ops = [(e.name, e.time_range.start, e.time_range.end) for e in self.prof.events()
               if e.device_type == DeviceType.CUDA]
        marker = [s for n, s, _ in ops if "spin" in n.lower() or "sleep" in n.lower()]
        if not marker:
            raise RuntimeError("trace: the marker kernel is not in the device trace")
        k0 = min(marker)  # µs on the profiler's clock, launched at host h0
        to_host = lambda us: (us - k0) / 1e6  # noqa: E731  seconds after h0
        ops = [(n, to_host(s), to_host(e)) for n, s, e in ops]
        window = (self.h1 - self.h0) / 1e9
        phases = [(n, (a - self.h0) / 1e9, (b - self.h0) / 1e9) for n, a, b in phases_ns]
        return summarize(ops, 0.0, window, phases)


def kernel_time(trace: dict, *fragments: str) -> Tuple[float, int]:
    """(seconds, launches) of the device ops whose names hold any fragment."""
    s = sum(v for n, v in trace["op_s"].items() if any(f in n for f in fragments))
    c = sum(v for n, v in trace["op_count"].items() if any(f in n for f in fragments))
    return s, c
