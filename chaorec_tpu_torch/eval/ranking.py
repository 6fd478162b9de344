"""Full-catalog ranking: score, mask seen items, then top-k.

Counterpart of ``chaorec_tpu/eval/ranking.py`` (``gene_ranklist``,
``mask_and_topk`` and ``mask_and_topk_dense``). Users are scored in chunks
over every item: embedding models by their (user, item) tables, bf16
inputs with float32 products and sums (``gene_ranklist``, as the JAX
package scores them), score-mode models by ``scorer``: ``score_users``,
or ``score_users_stateful`` with the model's state for a stateful model
that has it, as the JAX trainer and export choose (``rank_from_scores``).
Each user's seen items are set to the model's ``mask_value`` (1e-6 in the
reference's embedding models, -inf in the diffusion models); ``torch.topk``
keeps the best ``topk``; ids become global (0-based item id + num_user),
as in the reference's rank lists.

``mask_rows`` is the one masking function of the port: the trainer's
evaluation and ``serve.export_artifact`` both go through it. The JAX
package's dense-mask variant exists because a scatter is slow on the TPU;
on the card the scatter into one sentinel column is a single small kernel,
so the port keeps one path.
"""

from __future__ import annotations

from typing import Optional

import torch

from chaorec_tpu_torch import tracing
from chaorec_tpu_torch.ops.mxu import bdot


def mask_rows(scores: torch.Tensor, hist: torch.Tensor, value: float) -> torch.Tensor:
    """``scores`` (n, I) with ``scores[r, hist[r, j]] = value``; entries of
    ``hist`` equal to I (padding) are ignored: they index one extra
    sentinel column, sliced off again."""
    n, num_item = scores.shape
    wide = torch.cat([scores, scores.new_empty((n, 1))], dim=1)
    wide.scatter_(1, hist.to(torch.long), value)
    return wide[:, :num_item]


def mask_and_topk(scores: torch.Tensor, hist: torch.Tensor, topk: int, num_user: int,
                  mask_value: float = 1e-6) -> torch.Tensor:
    """(n, topk) int64 global item ids of the best unseen items per row of
    ``scores`` (n, I); ``hist`` (n, H) holds 0-based seen items padded with I."""
    with tracing.span("eval.select"):
        _, idx = torch.topk(mask_rows(scores, hist, mask_value), topk, dim=1)
        return idx + num_user


def scorer(model, params, state=None):
    """``score_fn(user_ids) -> (n, num_item)`` of a score-mode model: its
    ``score_users_stateful`` with ``state`` when it is stateful and has one
    (DualVAE ranks by its cached latents), else its ``score_users``."""
    if getattr(model, "stateful", False) and hasattr(model, "score_users_stateful"):
        return lambda ids: model.score_users_stateful(params, state, ids)
    return lambda ids: model.score_users(params, ids)


@torch.no_grad()
def rank_from_scores(model, params, history: torch.Tensor, topk: int = 50,
                     user_chunk: int = 4096, state=None,
                     users: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(num_user, topk) global item ids for every user of a score-mode
    model (with its ``state``, see ``scorer``), ``user_chunk`` users at a
    time, or for the ids ``users`` only; ``history`` (U, H) is the padded
    history table on the model's device."""
    if users is None:
        users = torch.arange(history.shape[0], device=history.device)
    n = users.shape[0]
    topk = min(topk, model.num_item)
    score_fn = scorer(model, params, state)
    outs = []
    for start in range(0, n, user_chunk):
        ids = users[start:start + user_chunk]
        tracing.count("eval.chunks")
        tracing.count("eval.users", ids.shape[0])
        with tracing.span("eval.score"):
            scores = score_fn(ids)
        outs.append(mask_and_topk(scores, history[ids], topk, model.num_user,
                                  float(model.mask_value)))
    return torch.cat(outs)


@torch.no_grad()
def gene_ranklist(user_emb: torch.Tensor, item_emb: torch.Tensor, history: torch.Tensor,
                  num_user: int, topk: int = 50, user_chunk: int = 4096) -> torch.Tensor:
    """(U, topk) global item ids of every user's best unseen items, from
    the embedding tables (U, D) and (I, D); seen items (``history``, the
    padded (U, H) table on the same device) score 1e-6, as in the
    reference (Model/BPR.py:81-83)."""
    topk = min(topk, item_emb.shape[0])
    items_t = item_emb.to(torch.bfloat16).t()
    outs = []
    for start in range(0, user_emb.shape[0], user_chunk):
        end = min(start + user_chunk, user_emb.shape[0])
        tracing.count("eval.chunks")
        tracing.count("eval.users", end - start)
        with tracing.span("eval.score"):
            scores = bdot(user_emb[start:end].to(torch.bfloat16), items_t)
        outs.append(mask_and_topk(scores, history[start:end], topk, num_user, 1e-6))
    return torch.cat(outs)
