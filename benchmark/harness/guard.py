"""The import guard: a run of the port must not load JAX or the JAX package.

Compared by whole top-level names (the part before the first dot), so
``chaorec_tpu_torch`` is not ``chaorec_tpu``.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "chaorec_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


class ForbiddenImport(RuntimeError):
    pass


def check(where: str) -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"{where}: sys.modules holds {found[:20]}")
