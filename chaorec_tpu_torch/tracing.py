"""Spans and counters of the trainer and the ranking, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` records (the benchmark's
traced window, the CLI's ``--profile_dir`` epoch); there is no other switch.
Off, ``span`` checks the profiler's flag and returns a shared null context,
and ``count`` checks it and returns: nothing is made or recorded.

On, a span is a ``record_function`` range on the profiler's own timeline,
the clock of the card's kernels, so a trace names what the host was doing
in each idle stretch of the card by the span it was in. It also keeps, by
name: calls, host time, host self time (less what its child spans cover),
the enclosing span's name and, once the process has started CUDA, a pair of
timing events on the current stream. A span's device time is the stream's
time from the span's first operation to its last, waits for the host
included. Spans nest on one process-wide stack: autograd's backward on the
card runs on the engine's thread while the calling thread waits in it, so
the nesting stays sequential.

Counters are host integers, never read from the device. ``snapshot``
synchronizes the device once and returns every span's aggregates, the
counters and the kernel wrappers' ``launches`` (``ops.kernel_wrappers``);
``reset`` clears the spans and the counters.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Totals:
    """One span name's aggregates."""

    __slots__ = ("calls", "host_ns", "self_ns", "parent", "events", "device_ms")

    def __init__(self, parent: Optional[str]):
        self.calls = self.host_ns = self.self_ns = 0
        self.parent = parent
        self.events: List = []  # (start, end) timing events not read yet
        self.device_ms: Optional[float] = None


class _Recorder:
    def __init__(self):
        self.totals: Dict[str, _Totals] = {}
        self.counters: Dict[str, int] = {}
        self.stack: List[_Span] = []
        self.pool: List[torch.cuda.Event] = []  # read events, recorded again

    def event(self) -> torch.cuda.Event:
        ev = self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def read_events(self) -> None:
        pending = [t for t in self.totals.values() if t.events]
        if not pending:
            return
        torch.cuda.synchronize()
        for t in pending:
            t.device_ms = (t.device_ms or 0.0) + sum(a.elapsed_time(b) for a, b in t.events)
            for pair in t.events:
                self.pool.extend(pair)
            t.events.clear()


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "range", "ev0", "child_ns", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = record_function(self.name)
        self.range.__enter__()
        self.ev0 = _REC.event() if torch.cuda.is_initialized() else None
        self.child_ns = 0
        _REC.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        stack = _REC.stack
        stack.pop()
        tot = _REC.totals.get(self.name)
        if tot is None:
            tot = _REC.totals[self.name] = _Totals(stack[-1].name if stack else None)
        tot.calls += 1
        tot.host_ns += dur
        tot.self_ns += dur - self.child_ns
        if stack:
            stack[-1].child_ns += dur
        if self.ev0 is not None:
            tot.events.append((self.ev0, _REC.event()))
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager: the span ``name`` while a profiler records, else
    a shared null context."""
    if not _profiling():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds the host integer ``n`` to counter ``name`` while a profiler
    records."""
    if _profiling():
        _REC.counters[name] = _REC.counters.get(name, 0) + n


def snapshot() -> Dict:
    """{"spans": {name: {calls, host_ms, host_self_ms, device_ms (None
    where no event was recorded, as on the CPU), parent}}, "counters":
    {name: n}, "launches": {kernel wrapper: launches}} since the last
    ``reset``; synchronizes the device once when it has events to read."""
    from chaorec_tpu_torch.ops import kernel_wrappers

    _REC.read_events()
    return {"spans": {n: {"calls": t.calls, "host_ms": t.host_ns * 1e-6,
                          "host_self_ms": t.self_ns * 1e-6, "device_ms": t.device_ms,
                          "parent": t.parent} for n, t in _REC.totals.items()},
            "counters": dict(_REC.counters),
            "launches": {f.__name__: f.launches for f in kernel_wrappers()}}


def reset() -> None:
    """Clears the spans and the counters (their events go back to the pool)."""
    for t in _REC.totals.values():
        for pair in t.events:
            _REC.pool.extend(pair)
    _REC.totals.clear()
    _REC.counters.clear()
