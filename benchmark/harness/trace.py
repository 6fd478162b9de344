"""The traced window: ``torch.profiler`` over the CPU and the card, reduced to
what the per-layer metrics read.

- ``busy_s``: the seconds in which a kernel, copy or memset ran on the card,
  the union of their intervals inside the window;
- ``window_s``: the length of the window's own range (``WINDOW``), which
  ends after a device synchronize, so every operation queued in it lies
  inside it;
- ``op_seconds``: device seconds by operation name;
- ``gaps``: the longest stretches with nothing on the card, each named by
  what the host was doing at its middle: the innermost of the benchmark's
  ranges, then the innermost host operation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np

WINDOW = "bench.window"
RANGE_PREFIX = "bench."  # the benchmark's own ranges
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_KINDS = {"cpu_op", "cuda_runtime", "cuda_driver", "python_function", "cpu_instant_event"}
NAME_CHARS = 160  # a name in ``breakdown`` is cut to this many characters


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    op_seconds: Dict[str, float]
    op_counts: Dict[str, int]
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def seconds_where(self, pred: Callable[[str], bool]) -> float:
        return sum(s for n, s in self.op_seconds.items() if pred(n))

    def count_where(self, pred: Callable[[str], bool]) -> int:
        return sum(c for n, c in self.op_counts.items() if pred(n))

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in self.gaps[:top]]}


def profiler(device_type: str):
    """A started profiler over the CPU and, on the card, CUDA."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _events(prof):
    """(device [(start_ns, end_ns, name)], host [(start_ns, end_ns, name,
    is_range)]) of a stopped profiler."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        ann = _is_annotation(e, name)
        if e.device_type() == DeviceType.CUDA:
            if not ann:
                dev.append((start, end, name))
        else:
            host.append((start, end, name, ann))
    return dev, host


def _is_annotation(e, name: str) -> bool:
    """Whether ``e`` is a ``record_function`` range (on the host, or its
    mirror on the card), not an operation: by its activity type where the
    event has one (torch 2.13), else by its flag and name."""
    if hasattr(e, "activity_type"):
        return e.activity_type() not in DEVICE_KINDS | HOST_KINDS
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or name.startswith(RANGE_PREFIX)


def summarize(prof, gaps: int = 10) -> TraceSummary:
    """The window's reduction of a stopped profiler's trace."""
    return reduce(*_events(prof), gaps=gaps)


def reduce(dev, host, gaps: int = 10) -> TraceSummary:
    """The window's reduction of device operations [(start_ns, end_ns,
    name)] and host events [(start_ns, end_ns, name, is_range)]; raises
    when there is no window range or no device operation inside it."""
    wins = [(s, e) for s, e, n, _ in host if n == WINDOW]
    if not wins:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = wins[-1]
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    if not dev:
        raise RuntimeError("the profiler recorded no operation on the card in the window")
    op_s, op_n = {}, {}
    for s, e, n in dev:
        op_s[n] = op_s.get(n, 0.0) + (e - s) * 1e-9
        op_n[n] = op_n.get(n, 0) + 1
    iv = np.array([(s, e) for s, e, _ in dev], dtype=np.int64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > reach[:-1]  # an interval that starts after all before it ended
    starts = iv[new, 0]
    ends = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    busy = float((ends - starts).sum()) * 1e-9
    holes = np.stack([np.append(w0, ends), np.append(starts, w1)], 1)
    holes = holes[holes[:, 1] > holes[:, 0]]
    longest = holes[np.argsort(holes[:, 0] - holes[:, 1], kind="stable")[:gaps]]
    spans = np.array([(s, e) for s, e, _, _ in host], dtype=np.int64).reshape(-1, 2)
    is_range = np.array([r for _, _, _, r in host], dtype=bool)
    names = [n for _, _, n, _ in host]
    is_range &= np.array([n != WINDOW for n in names], dtype=bool).reshape(is_range.shape)
    is_op = ~np.array([r for _, _, _, r in host], dtype=bool)
    return TraceSummary((w1 - w0) * 1e-9, busy, op_s, op_n,
                        [(_host_at(spans, is_range, is_op, names, (a + b) // 2),
                          (b - a) * 1e-9) for a, b in longest])


def _host_at(spans: np.ndarray, is_range: np.ndarray, is_op: np.ndarray, names: List[str],
             t: int) -> str:
    """What the host was doing at ``t``: the innermost benchmark range and
    the innermost host operation that cover it."""
    cover = (spans[:, 0] <= t) & (spans[:, 1] >= t)
    length = spans[:, 1] - spans[:, 0]

    def innermost(mask):
        idx = np.flatnonzero(mask)
        return names[idx[np.argmin(length[idx])]] if idx.size else None

    where = innermost(cover & is_range) or WINDOW
    op = innermost(cover & is_op)
    return f"{where} > {op or '(no host op)'}"
