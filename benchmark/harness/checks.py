"""The numbers behind ``correct``: each a gap between what the program made
and what the plain reference works out, held to its limit.

- ``rel_gap``: |a - b| / |b|;
- ``leaf_norm_gap``: the worst leaf's gap between the program's norm and
  the reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger; leaves whose reference gradient norm is under
  a thousandth of the median leaf's are left out (they move under Adam by
  round-off alone);
- ``leaf_diff_gap``: the same with the norm of the difference of the two
  tensors in the numerator, which sees direction (a flipped sign) where a
  gap of norms cannot.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional

import torch

ROUND_OFF_SHARE = 1e-3


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in leaves.items()}


def counted_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    """The leaves compared: those whose reference gradient is not nought to
    rounding, by a rule on its norm against the median leaf's."""
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= ROUND_OFF_SHARE * med]


def leaf_norm_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> float:
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def leaf_diff_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  leaves: List[str]) -> float:
    ref_n = norms({k: ref[k] for k in leaves})
    med = statistics.median(ref_n.values())
    diff = norms({k: prog[k] - ref[k] for k in leaves})
    return max(diff[k] / max(ref_n[k], med) for k in leaves)


class Report:
    """Named numbers, each beside its limit; ``ok`` when every number is
    finite and at most its limit (a number with no limit fails)."""

    def __init__(self, limits: Dict[str, Dict]):
        self.limits = limits
        self.values: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        self.values[name] = float(value)

    def limit(self, name: str) -> Optional[float]:
        entry = self.limits.get(name)
        return None if entry is None else float(entry["limit"])

    def passed(self, name: str) -> bool:
        v, lim = self.values[name], self.limit(name)
        return lim is not None and v == v and v <= lim

    @property
    def ok(self) -> bool:
        return bool(self.values) and all(self.passed(n) for n in self.values)

    def as_dict(self) -> Dict[str, Dict]:
        return {n: {"value": v, "limit": self.limit(n)} for n, v in self.values.items()}

    def print_lines(self, stream=None) -> None:
        stream = stream or sys.stderr
        for n, v in self.values.items():
            print(f"check {n}: {v!r} limit {self.limit(n)!r} "
                  f"{'ok' if self.passed(n) else 'FAIL'}", file=stream, flush=True)
