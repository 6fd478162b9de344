"""Carry params and model state between numpy, devices and the port's tensors.

``from_numpy`` turns the JAX package's ``init_params`` output (after
``np.asarray`` on each leaf), a state tuple such as CF_Diff's ``(lt_hist,
lt_count)`` or a single state array such as DGCF's routing scores into
tensors on ``device``; ``to_numpy`` goes back. A model initialised in one
package then computes the same thing in both. ``clone_to`` copies params or
state to a device (the trainer's host copy of the best epoch, and back to
the card for export). ``load_frozen`` puts another package's frozen
construction-time tensors (MMGCN's and MVGAE's, which their builders draw
from a seed and no optimizer steps) in place of a model's own. Dicts,
tuples (named ones too: DiffMM's rebuilt graphs) and lists are walked;
their structure is kept. bf16 leaves (``--relaxed_precision bf16`` tables)
keep their dtype and bits.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _rebuilt(tree, items):
    """A tuple, named tuple or list of ``tree``'s type holding ``items``."""
    if hasattr(tree, "_fields"):
        return type(tree)(*items)
    return type(tree)(items)


def from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return _rebuilt(tree, [from_numpy(v, device) for v in tree])
    if tree is None:
        return None
    # np.array copies, so the tensor owns its memory and is writable
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        # JAX's bf16 arrays (ml_dtypes) are foreign to torch.from_numpy; the
        # bits go across as uint16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return _rebuilt(tree, [to_numpy(v) for v in tree])
    if tree is None:
        return None
    return tree.detach().cpu().numpy()


def clone_to(tree: Any, device: torch.device | str) -> Any:
    """A detached copy of every tensor of ``tree`` on ``device`` (a copy even
    where the tensor is on ``device`` already)."""
    if isinstance(tree, dict):
        return {k: clone_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return _rebuilt(tree, [clone_to(v, device) for v in tree])
    if tree is None:
        return None
    return tree.detach().to(device, copy=True)


def load_frozen(model: Any, tensors: Any) -> None:
    """Set each of ``model.frozen`` (the names of its frozen construction-time
    attributes) from ``tensors`` ({name: array or tensor}, e.g. the JAX
    model's attributes of those names), float32 on the model's device; each
    keeps its shape."""
    if set(tensors) != set(model.frozen):
        raise ValueError(f"{model.name} freezes {sorted(model.frozen)}, given {sorted(tensors)}")
    for name in model.frozen:
        t = from_numpy(tensors[name], model.device).to(torch.float32)
        if t.shape != getattr(model, name).shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the model's "
                             f"{tuple(getattr(model, name).shape)}")
        setattr(model, name, t)
