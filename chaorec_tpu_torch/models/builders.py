"""Builders wiring Config + RecDataset into model instances.

Counterpart of ``chaorec_tpu/models/builders.py``; each builder keeps the
constructor arguments of its JAX counterpart.
"""

from __future__ import annotations

import torch

from chaorec_tpu_torch.config import Config
from chaorec_tpu_torch.data.loading import RecDataset, dense_interactions
from chaorec_tpu_torch.models import register_model
from chaorec_tpu_torch.models.cf_diff import CF_Diff


@register_model("CF_Diff")
def _cf_diff(cfg: Config, ds: RecDataset, device: torch.device) -> CF_Diff:
    # The reference's grid also has ``dims``, which CAM_AE never reads.
    return CF_Diff(
        ds.num_user, ds.num_item,
        torch.from_numpy(dense_interactions(ds)).to(device),
        cfg.noise_scale, cfg.noise_min, cfg.noise_max, cfg.steps,
    )
