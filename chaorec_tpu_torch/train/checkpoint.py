"""Checkpoint/resume for training runs.

Counterpart of ``chaorec_tpu/train/checkpoint.py`` in the layout of its
``np.savez`` fallback: one directory a step, ``step_<n>/state.pt`` (the
state by ``torch.save``) and ``step_<n>/metrics.json`` (the early-stopping
metrics, str keys). A step is written into a temporary directory and
renamed once complete, so a process killed mid-write leaves no torn newest
step: ``latest_step`` sees only complete ones (orbax gives the JAX package
the same). The last ``max_to_keep`` steps are kept.

The state is stored as plain containers of tensors (dicts with str keys,
lists for tuples and named tuples, None) and read back with
``torch.load(..., weights_only=True)``. ``restore(step, like)`` puts the
stored leaves into the live structure ``like``, as the JAX package's
``restore(step, like)`` does: each leaf goes to the device of ``like``'s
leaf, and a leaf count, shape or dtype that differs raises the JAX
package's schema error.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from chaorec_tpu_torch.params import _rebuilt

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


def _plain(tree: Any) -> Any:
    """``tree`` as plain containers of detached tensors."""
    if isinstance(tree, dict):
        return {str(k): _plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_plain(v) for v in tree]
    if tree is None:
        return None
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"a checkpoint leaf must be a tensor or None, not {type(tree).__name__}")
    return tree.detach()


def _fill(like: Any, stored: Any, path: str = "") -> Any:
    """``stored``'s leaves in ``like``'s structure, each on the device of
    ``like``'s leaf; a structure, shape or dtype that differs raises
    ``ValueError`` naming the first such leaf."""
    if isinstance(like, dict):
        if not isinstance(stored, dict) or set(stored) != {str(k) for k in like}:
            raise ValueError(f"{path or 'root'}: keys differ")
        return {k: _fill(v, stored[str(k)], f"{path}/{k}") for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        if not isinstance(stored, list) or len(stored) != len(like):
            raise ValueError(f"{path or 'root'}: {len(like)} entries expected")
        return _rebuilt(like, [_fill(v, s, f"{path}/{i}")
                               for i, (v, s) in enumerate(zip(like, stored))])
    if like is None:
        if stored is not None:
            raise ValueError(f"{path}: None expected")
        return None
    if not isinstance(stored, torch.Tensor):
        raise ValueError(f"{path}: a tensor expected")
    if stored.shape != like.shape or stored.dtype != like.dtype:
        raise ValueError(f"{path}: stored {stored.dtype}{list(stored.shape)}, "
                         f"live {like.dtype}{list(like.shape)}")
    return stored.to(like.device)


class CheckpointManager:
    """Step-indexed checkpoints under ``directory`` (one subdirectory a step)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _steps(self) -> List[int]:
        """The complete steps, ascending: ``step_<n>`` directories that hold
        the state (a temporary directory's name is not of that form)."""
        steps = []
        for name in os.listdir(self.directory):
            head, _, num = name.partition("_")
            if head == "step" and num.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, STATE_FILE)):
                steps.append(int(num))
        return sorted(steps)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Dict[str, Any], metrics: Optional[Dict] = None) -> None:
        final = self.step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_plain(tree), os.path.join(tmp, STATE_FILE))
        if metrics is not None:
            with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                json.dump(metrics, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def restore(self, step: int, like: Dict[str, Any],
                map_location: Optional[torch.device | str] = None
                ) -> Tuple[Dict[str, Any], Optional[Dict]]:
        """(state in ``like``'s structure, metrics or None). The file is read
        onto ``map_location`` (default: where it was written)."""
        d = self.step_dir(step)
        try:
            stored = torch.load(os.path.join(d, STATE_FILE), weights_only=True,
                                map_location=map_location)
            tree = _fill(like, stored)
        except (ValueError, RuntimeError, EOFError, pickle.UnpicklingError) as e:
            raise RuntimeError(
                f"checkpoint at {self.directory} (step {step}) does not match the current "
                "optimizer/state schema — restart with a fresh --checkpoint_dir or delete "
                "the stale checkpoint") from e
        metrics = None
        mpath = os.path.join(d, METRICS_FILE)
        if os.path.exists(mpath):
            with open(mpath) as f:
                metrics = json.load(f)
        return tree, metrics

    def _gc(self) -> None:
        for s in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
