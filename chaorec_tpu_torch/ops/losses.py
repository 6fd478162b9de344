"""Loss primitives with the reference's numerics.

Counterpart of ``chaorec_tpu/ops/losses.py``. Kept from the reference on
purpose:

- BPR adds ``1e-5`` inside the log of the sigmoid difference
  (Model/LightGCN.py:108); ``eps=0`` gives the plain form (Model/BPR.py:58);
- regularization is a mean (not a sum) of squared embeddings times
  ``reg_weight`` (Model/LightGCN.py:112-121);
- every reduction is a weighted mean, so a short or padded batch gives the
  reference's per-batch mean.

``catalog_logsumexp`` goes through the streaming logsumexp kernels
(``ops/streaming_lse.py``) on the card. ``info_nce`` is in-batch (B x B
logits), a plain ``logsumexp`` in both packages.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from chaorec_tpu_torch.ops.streaming_lse import streaming_logsumexp


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rows scaled to unit L2 norm, with a finite gradient at zero rows:
    ``x * rsqrt(sum(x^2) + eps)``."""
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def safe_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Row norms with a finite gradient at zero rows: sqrt(sum(x^2) + eps)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def cosine_rows(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity, safe at zero rows."""
    return torch.sum(a * b, dim=-1) / (safe_norm(a) * safe_norm(b) + eps)


def masked_mean(x: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the rows with weight 1 (``weights`` in {0, 1}; None: all)."""
    if weights is None:
        return torch.mean(x)
    return torch.sum(x * weights) / torch.clamp(torch.sum(weights), min=1.0)


def unshare(term: torch.Tensor, share: Optional[torch.Tensor]) -> torch.Tensor:
    """A loss term summed (not averaged) over a batch's rows, on a dp
    rank's slice of the batch (``share`` set, ``Batch.share``) divided by
    the slice's share of the batch's weight: the trainer scales the
    slice's loss by that share (``parallel/mesh.py``), which gives the
    summed term back whole. A slice of weight 0 sums to 0 and stays 0."""
    if share is None:
        return term
    return term / torch.where(share > 0, share, torch.ones_like(share))


def bpr_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
             weights: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """-mean(log(sigmoid(pos - neg) + eps)) (Model/LightGCN.py:97-110)."""
    return -masked_mean(torch.log(torch.sigmoid(pos_scores - neg_scores) + eps), weights)


def emb_l2_reg(reg_weight: float, embeddings: Sequence[torch.Tensor],
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """reg_weight * sum over tensors of mean(e^2) (Model/LightGCN.py:112-121),
    the mean over the rows with weight 1."""
    total = 0.0
    for e in embeddings:
        sq = torch.mean(e ** 2, dim=-1) if e.dim() > 1 else e ** 2
        total = total + masked_mean(sq, weights)
    return reg_weight * total


def info_nce(view1: torch.Tensor, view2: torch.Tensor, temperature: float,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """InfoNCE with in-batch negatives over L2-normalized views
    (Model/SimGCL.py:16-31): the positive of a row is the same row of the
    other view, its negatives every row of view2; a weighted mean over the
    rows."""
    v1, v2 = l2norm(view1), l2norm(view2)
    pos = torch.sum(v1 * v2, dim=1) / temperature
    log_denom = torch.logsumexp((v1 @ v2.t()) / temperature, dim=1)
    return -masked_mean(pos - log_denom, weights)


def catalog_logsumexp(q: torch.Tensor, k: torch.Tensor,
                      temperature: float = 1.0) -> torch.Tensor:
    """logsumexp(q @ k.T / temperature, axis=-1) (B,) for full-catalog
    contrastive denominators. q is divided by the temperature first (so the
    gradients stay exact), then ``streaming_logsumexp`` takes it: the CUDA
    kernels for a card's tensors, whatever the size, the plain version on
    the CPU."""
    return streaming_logsumexp(q / temperature, k)
