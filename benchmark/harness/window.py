"""The measured window: all the work over all the time, closed by a device
synchronize.

A rate is the units of work done inside the window over the window's
seconds by the host's clock, from ``start`` to ``stop``. ``stop``
synchronizes the device first, so work queued in the window counts its
time, and nothing done in the window (a stall included) is left out.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class Window:
    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sync = sync or (lambda: None)
        self.t0 = self.t1 = None
        self.units = {}

    def start(self) -> "Window":
        self.sync()
        self.t0 = time.perf_counter()
        return self

    def add(self, **units) -> None:
        for k, v in units.items():
            self.units[k] = self.units.get(k, 0) + v

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def stop(self) -> float:
        self.sync()
        self.t1 = time.perf_counter()
        return self.seconds

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def rate(self, unit: str) -> float:
        """``unit``s a second over the whole window."""
        return self.units.get(unit, 0) / self.seconds
