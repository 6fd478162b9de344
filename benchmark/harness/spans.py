"""The program's own spans and counters of a traced run
(``chaorec_tpu_torch.tracing``), on the profiler's clock.

One snapshot is taken a run (``snapshot``: the first reader takes it, the
others read the same) and the program's spans and counters are cleared
after it, so a second run in one process starts from none. A program
without ``tracing`` gives no snapshot, and every reader then returns None.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

_last = (None, None)  # (the run's ctx, its snapshot)


def say(metric: str, why: str) -> None:
    print(f"{metric}: {why}", file=sys.stderr)


def snapshot(ctx) -> Optional[Dict]:
    global _last
    if _last[0] is not ctx:
        try:
            from chaorec_tpu_torch import tracing
        except ImportError:
            _last = (ctx, None)
        else:
            snap = tracing.snapshot()
            tracing.reset()
            _last = (ctx, snap)
    return _last[1]


def device_ms(ctx, span: str) -> Optional[float]:
    """The device ms summed over the span's calls; None on the CPU, where
    the span never ran, or where the program has no spans."""
    snap = snapshot(ctx)
    return None if snap is None else snap["spans"].get(span, {}).get("device_ms")


def count(ctx, name: str) -> Optional[int]:
    """The program's counter ``name``; None where the program has no
    counters."""
    snap = snapshot(ctx)
    return None if snap is None else snap["counters"].get(name, 0)


def per_unit(ctx, metric: str, span: str, counter: str, unit: str) -> Optional[float]:
    """The device ms of ``span`` over the program's ``counter``, which must
    equal the window's own count of ``unit``; else None, with why on
    standard error."""
    ms = device_ms(ctx, span)
    if ms is None:
        say(metric, f"no device time of the program's span {span!r} (no such span, none on "
                    "the CPU, or a program without chaorec_tpu_torch.tracing)")
        return None
    n, want = count(ctx, counter), ctx.win.units.get(unit, 0)
    if not n or n != want:
        say(metric, f"the program's {counter} {n} differs from the window's {unit} {want}")
        return None
    return ms / n
