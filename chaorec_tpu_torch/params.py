"""Carry params and model state between numpy and the port's tensors.

``from_numpy`` turns the JAX package's ``init_params`` output (after
``np.asarray`` on each leaf) or a state tuple such as CF_Diff's
``(lt_hist, lt_count)`` into tensors on ``device``; ``to_numpy`` goes back.
A model initialised in one package then computes the same thing in both.
Dicts, tuples and lists are walked; their structure is kept.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    # np.array copies, so the tensor owns its memory and is writable
    return torch.from_numpy(np.array(tree)).to(device)


def to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if tree is None:
        return None
    return tree.detach().cpu().numpy()
