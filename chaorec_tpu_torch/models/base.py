"""Model protocol.

Counterpart of ``chaorec_tpu/models/base.py``. A model is an object that
holds its hyperparameters and its data buffers (tensors on one device);
its methods are functions of an explicit params dict of tensors:

- ``init_params(generator) -> params`` (made on the generator's device)
- ``init_state(device)`` for stateful models, else None
- ``embeddings(params) -> (user_emb, item_emb)`` when ``rank_mode`` is
  "embeddings"
- ``score_users(params, user_ids) -> (n, num_item)`` scores before masking
  when ``rank_mode`` is "scores"
- ``loss_stateful(params, state, batch, generator) -> (loss, new_state)``
  for stateful models; the loss is differentiable in ``params``, the new
  state is not

``trainer_mode`` names the batches the trainer feeds: "user_rows" for
models that train on whole interaction rows of shuffled users (the
diffusion and VAE models), "bpr" for (user, positive, negative) triples.

``mask_value`` is what seen items are set to before ranking: 1e-6 in the
reference's embedding models, -inf in the diffusion models. Item ids inside
a model are 0-based. The JAX package's pytree flattening has no
counterpart: it exists only to share XLA compiles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Batch:
    """One training batch of a "user_rows" model: user ids (B,) and their
    row weights (B,), by which every loss is a weighted mean. The JAX
    package's positives, negatives and batch index wait for the BPR models."""

    users: torch.Tensor
    weights: torch.Tensor


class RecModel:
    name: str = "RecModel"
    rank_mode: str = "embeddings"
    stateful: bool = False
    trainer_mode: str = "bpr"
    mask_value: float = 1e-6

    def __init__(self, num_user: int, num_item: int):
        self.num_user = num_user
        self.num_item = num_item

    def init_params(self, generator: torch.Generator) -> Params:
        raise NotImplementedError

    def init_state(self, device: torch.device | str = "cpu") -> Optional[object]:
        return None

    def embeddings(self, params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        """(user_emb, item_emb) used for full-catalog scoring."""
        raise NotImplementedError

    def score_users(self, params: Params, user_ids: torch.Tensor) -> torch.Tensor:
        """(len(user_ids), num_item) ranking scores (pre-masking)."""
        raise NotImplementedError

    def loss_stateful(self, params: Params, state, batch: Batch,
                      generator: torch.Generator) -> Tuple[torch.Tensor, object]:
        """(loss, new_state) of a stateful model on one batch."""
        raise NotImplementedError
