"""Model registry: each builder turns ``(cfg, dataset, device)`` into a model.

Counterpart of ``chaorec_tpu/models/__init__.py``: the same 54 names, each
registered by its builder in ``models/builders.py``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from chaorec_tpu_torch.config import Config
from chaorec_tpu_torch.data.loading import RecDataset
from chaorec_tpu_torch.models.base import Params, RecModel  # noqa: F401

Builder = Callable[[Config, RecDataset, torch.device], RecModel]
MODEL_REGISTRY: Dict[str, Builder] = {}


def register_model(name: str):
    def deco(builder: Builder) -> Builder:
        MODEL_REGISTRY[name] = builder
        return builder
    return deco


def build_model(cfg: Config, dataset: RecDataset,
                device: torch.device | str = "cuda") -> RecModel:
    # Imported here so that the builders' modules register themselves.
    import chaorec_tpu_torch.models.builders  # noqa: F401

    if cfg.Model not in MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model {cfg.Model!r}. Registered: {sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[cfg.Model](cfg, dataset, torch.device(device))
