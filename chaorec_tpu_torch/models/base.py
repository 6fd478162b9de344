"""Model protocol.

Counterpart of ``chaorec_tpu/models/base.py``. A model is an object that
holds its hyperparameters and its data buffers (tensors on one device);
its methods are functions of an explicit params dict of tensors:

- ``init_params(generator) -> params`` (made on the generator's device)
- ``init_state(device, generator)`` for stateful models, else None (a
  state with random entries, such as DualVAE's caches, draws them from
  ``generator``)
- ``embeddings(params) -> (user_emb, item_emb)`` when ``rank_mode`` is
  "embeddings"
- ``score_users(params, user_ids) -> (n, num_item)`` scores before masking
  when ``rank_mode`` is "scores"; a stateful model that ranks by its state
  (DualVAE's cached latents) has ``score_users_stateful(params, state,
  user_ids)`` instead (``eval/ranking.scorer`` picks it)
- ``loss_stateful(params, state, batch, generator) -> (loss, new_state)``
  for stateful models; the loss is differentiable in ``params``, the new
  state is not
- ``loss(params, batch, generator) -> loss`` for the others
- ``pre_epoch(params, epoch)``: work at the start of each epoch (graph
  pruning, operator rebuilds), counted as training time
- ``table_params``: names of large tables whose gradient is nonzero on the
  batch's rows only (trainable raw feature tables). The trainer gathers
  ``table_rows(batch)`` of each, differentiates
  ``loss_tables(dense_params, gathered_rows, batch, generator)`` (the same
  math as ``loss``) and steps each table with the row-sparse Adam
  (``ops/indexed_adam.py``), so no dense table gradient exists

``epoch0_params``: names of params whose gradient is real on each epoch's
batch 0 only (the rebuild-gated branch, ``train/loop.py``); the trainer
steps them with a zero gradient on every other batch.
``frozen_state_epoch``: the model builds its state on batch 0 of each epoch
and reads it detached on the later batches.

``dp_split``: under a mesh with dp > 1, each dp rank steps on its slice of
a batch's rows, its loss scaled by the slice's share of the batch's weight
(``parallel/mesh.py``). Declared only where the halves' scaled losses,
gradients and draws sum to the whole batch's (tests/test_torch_mesh.py):
a loss of weighted means over rows and of draws not shaped by the batch; a
summed term divides by ``Batch.share``. Every other model takes the whole
batch on every dp rank.

``needs_int_items``: the trainer draws each "bpr" row a second item from
outside the user's history, ``Batch.int_items`` (MCLN's "interest"
items), after its negative.

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
    """One training batch: user ids (B,) and their row weights (B,), by
    which every loss is a weighted mean; for "bpr" models also each row's
    positive and negative item (B,), 0-based, and for a model that
    ``needs_int_items`` a second item from outside the user's history.
    ``index`` is the batch's position in its epoch. A "user_rows" batch
    has no items. ``share``: set on a dp rank's slice of a batch, the
    slice's share of the batch's weight (``parallel/mesh.split_rows``)."""

    users: torch.Tensor
    weights: torch.Tensor
    pos_items: Optional[torch.Tensor] = None
    neg_items: Optional[torch.Tensor] = None
    index: int = 0
    int_items: Optional[torch.Tensor] = None
    share: Optional[torch.Tensor] = None


class RecModel:
    name: str = "RecModel"
    rank_mode: str = "embeddings"
    stateful: bool = False
    trainer_mode: str = "bpr"
    mask_value: float = 1e-6
    needs_int_items: bool = False
    epoch0_params: Tuple[str, ...] = ()
    frozen_state_epoch: bool = False
    dp_split: bool = False

    def __init__(self, num_user: int, num_item: int):
        self.num_user = num_user
        self.num_item = num_item

    def init_params(self, generator: torch.Generator) -> Params:
        raise NotImplementedError

    def init_state(self, device: torch.device | str = "cpu",
                   generator: Optional[torch.Generator] = None) -> Optional[object]:
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

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def pre_epoch(self, params: Params, epoch: int) -> None:
        return None

    table_params: Tuple[str, ...] = ()

    def table_rows(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """{table name: (B',) rows of it that this batch's loss reads}."""
        raise NotImplementedError

    def loss_tables(self, dense_params: Params, table_rows_vals: Dict[str, torch.Tensor],
                    batch: Batch, generator: torch.Generator) -> torch.Tensor:
        """``loss`` with each table's rows given already gathered
        (``table_rows_vals[name] = params[name][table_rows(batch)[name]]``)."""
        raise NotImplementedError
