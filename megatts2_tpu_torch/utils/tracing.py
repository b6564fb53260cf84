"""The port's tracer: named host-clock spans, off by default.

* ``span(name, n=0)`` — a context manager, one interval of the host's
  work; ``n`` carries its unit count (decode steps, requests, bytes).
* ``record(name, t0_ns, t1_ns, n=0)`` — an interval that does not nest in
  the caller's code, such as a request's wait in the queue.

Off (the default), ``span`` returns one shared no-op object after a single
check of a module flag, and ``record`` returns at once: no allocation, no
clock read.  ``enable()`` turns it on, ``disable()`` off.  On, spans are
taken on ``time.perf_counter_ns``, the clock of the benchmark's host phases
(``benchmark/harness.py`` ``Spans``, the traced slice of
``benchmark/trace.py``), and while a ``torch.profiler`` is recording, each
span also enters ``torch.profiler.record_function(name)``, so it sits
beside the kernels in a Chrome trace taken with CPU activity
(``run_training(trace_dir=...)``, ``cli fit --trace_dir``).  No span
synchronises the device: a span is the host's time, and the device may run
behind it.

Two readers, neither of which clears what the other holds:

* the buffer: the newest ``BUFFER`` spans ``(name, t0_ns, t1_ns, n)``;
  ``drain()`` returns them and empties it (the benchmark's traced runs);
* a :class:`Tally`, opened by ``tally(prefix, keep)`` and fed while open:
  each name's count and last ``keep`` durations, for the names that start
  with ``prefix`` (the ``loop/`` row of ``run_training``, ``GET /metrics``
  of ``serve --http``).

A lock guards both, so the serving engine's thread and the HTTP handlers
may record at once.

Span names, each one interval a call (never one a decode step):

* synthesis (``models/megatts.py`` ``synthesize``): ``synth.mrte``,
  ``synth.adm``, ``synth.plm``, ``synth.decoder``, ``synth.vocoder``
  (recorded at the stage clock's marks, so without a ``record_function``);
  ``adm.decode`` and ``plm.decode`` around the KV-cached loops (``n`` = T
  steps), ``plm.prefill`` around a prompt's prefill (``n`` = its length);
* training (``training/lm_trainers.py``): ``train.batch_to_device`` (``n`` =
  bytes handed over), ``train.forward``, ``train.backward`` (with the
  gradients' reduction on a mesh), ``train.optimizer``; the loop
  (``training/train_loop.py``, which turns the tracer on for its run):
  ``loop.loader_wait``, ``loop.step``;
* the serving engine (``continuous.py``): ``engine.admit`` (``n`` =
  requests), ``engine.tick`` (``n`` = codes a slot), ``engine.emit``
  (``n`` = chunks), and per request ``engine.queue_wait`` (submission to
  admission) and ``engine.first_chunk`` (submission to its first chunk on
  the host).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

BUFFER = 1 << 16  # spans kept for drain()
RECENT = 1024  # durations a tally keeps per name by default

Span = Tuple[str, int, int, int]  # (name, t0_ns, t1_ns, n)

_on = False
_profiler = None  # torch.autograd.profiler, imported by enable()
_lock = threading.Lock()
_spans: "collections.deque[Span]" = collections.deque(maxlen=BUFFER)
_tallies: List["Tally"] = []


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "n", "t0", "rf")

    def __init__(self, name: str, n: int):
        self.name, self.n, self.rf = name, n, None

    def __enter__(self):
        if getattr(_profiler, "_is_profiler_enabled", False):
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _add(self.name, self.t0, t1, self.n)
        return False


def _add(name: str, t0: int, t1: int, n: int) -> None:
    with _lock:
        _spans.append((name, t0, t1, n))
        for t in _tallies:
            if name.startswith(t.prefix):
                t._add(name, t1 - t0)


def span(name: str, n: int = 0):
    """A context manager timing the host's work under ``name``."""
    if not _on:
        return _NO_SPAN
    return _Span(name, n)


def record(name: str, t0_ns: int, t1_ns: int, n: int = 0) -> None:
    """An interval on ``time.perf_counter_ns``'s clock, taken by the caller."""
    if _on:
        _add(name, t0_ns, t1_ns, n)


def enable() -> None:
    global _on, _profiler
    import torch.autograd.profiler as profiler

    _profiler = profiler
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> List[Span]:
    """The buffered spans, oldest first; the buffer is emptied."""
    with _lock:
        spans = list(_spans)
        _spans.clear()
    return spans


class Tally:
    """Each span name's count and its last ``keep`` durations (all of them
    with ``keep`` None), over the spans whose names start with ``prefix``
    (a string or a tuple of them) recorded while it is open."""

    def __init__(self, prefix: Union[str, Tuple[str, ...]], keep: Optional[int]):
        self.prefix, self.keep = prefix, keep
        self._count: Dict[str, int] = {}
        self._ns: Dict[str, collections.deque] = {}

    def _add(self, name: str, ns: int) -> None:  # under _lock
        self._count[name] = self._count.get(name, 0) + 1
        d = self._ns.get(name)
        if d is None:
            d = self._ns[name] = collections.deque(maxlen=self.keep)
        d.append(ns)

    def durations_ms(self, name: str, last: Optional[int] = None) -> List[float]:
        """The kept durations of ``name`` in ms, oldest first; with ``last``
        only the newest ``last`` of them."""
        with _lock:
            d = self._ns.get(name, ())
            ns = list(d) if last is None else list(itertools.islice(reversed(d), last))[::-1]
        return [x / 1e6 for x in ns]

    def summary(self) -> Dict[str, dict]:
        """Per name: its ``count``, and ``mean_ms``, ``p50_ms``, ``p95_ms``
        of its kept durations."""
        with _lock:
            got = {k: (self._count[k], sorted(d)) for k, d in self._ns.items()}
        return {k: {"count": c, "mean_ms": sum(d) / len(d) / 1e6, "p50_ms": _quantile(d, 0.5) / 1e6,
                    "p95_ms": _quantile(d, 0.95) / 1e6}
                for k, (c, d) in sorted(got.items())}

    def close(self) -> None:
        with _lock:
            if self in _tallies:
                _tallies.remove(self)

    def __enter__(self) -> "Tally":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def tally(prefix: Union[str, Tuple[str, ...]], keep: Optional[int] = RECENT) -> Tally:
    """Open a :class:`Tally` of the spans named ``prefix…`` from now until
    it is closed (``close()``, or the end of a ``with`` block)."""
    t = Tally(prefix, keep)
    with _lock:
        _tallies.append(t)
    return t


def _quantile(xs: List[float], q: float) -> float:
    """Linear interpolation between order statistics (numpy's default)."""
    pos = (len(xs) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
