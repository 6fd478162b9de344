"""The combined linear-propagation operator of the linear GCN models.

Counterpart of ``chaorec_tpu/ops/linear_prop.py``. LightGCN's final
embedding is a weighted sum of adjacency powers applied to the ego
embeddings, ``E_final = sum_k w_k A^k E_0``: linear in E_0, with a graph
that does not change. So the operator ``M = sum_k w_k A^k`` is built once
per model, and a training step needs only the batch's rows of it:

  final_u[b] = M_uu[b] @ E_u + M_ui[b] @ E_i
  final_i[b] = M_iu[b] @ E_u + M_ii[b] @ E_i

With ``A = [[0, R], [R^T, 0]]`` the powers alternate between the diagonal
blocks (even k) and the off-diagonal ones (odd k):

  A^k = [[P_k, Q_k], [Q'_k, S_k]],  A^{k+1} = [[R Q'_k, R S_k], [R^T P_k, R^T Q_k]]

so each layer of ``build_weighted_op`` takes the two products of the
blocks that are not zero, in float32 on R's device, and frees the
previous power as it goes. A product with a zero block is zero, and A^1's
blocks are R and R^T themselves, so the sums equal those of the JAX
package's four products a layer. This is a plain large product outside
any Pallas kernel in the JAX package too, so ``torch.mm`` computes it.

The blocks are stored in bf16 (``store_bf16``, the JAX package's default)
or float32. A product with a table casts the table to the block's dtype
and goes through ``ops/mxu.bdot``: bf16 products summed in float32, whose
backward rounds the table's gradient to that dtype, as JAX's transpose
does; with float32 blocks a plain float32 product. M is a constant: no
gradient flows into it.

Memory: U^2 + I^2 + 2 U I entries; ``fits_linear_op`` gates the build.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from chaorec_tpu_torch.ops.mxu import bdot


@dataclass(frozen=True)
class CombinedLinearOp:
    """The four blocks of M = sum_k w_k A^k, each row-gatherable."""

    m_uu: torch.Tensor  # (U, U)
    m_ui: torch.Tensor  # (U, I)
    m_iu: torch.Tensor  # (I, U)
    m_ii: torch.Tensor  # (I, I)

    @property
    def nbytes(self) -> int:
        return sum(m.numel() * m.element_size() for m in (self.m_uu, self.m_ui, self.m_iu,
                                                         self.m_ii))

    def user_rows(self, rows: torch.Tensor, user_emb: torch.Tensor,
                  item_emb: torch.Tensor) -> torch.Tensor:
        """final_user[rows] (B, D) float32, without the full table."""
        return _rows_matmul(self.m_uu[rows], self.m_ui[rows], user_emb, item_emb)

    def item_rows(self, rows: torch.Tensor, user_emb: torch.Tensor,
                  item_emb: torch.Tensor) -> torch.Tensor:
        """final_item[rows] (B, D) float32."""
        return _rows_matmul(self.m_iu[rows], self.m_ii[rows], user_emb, item_emb)

    def full(self, user_emb: torch.Tensor, item_emb: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(final_user (U, D), final_item (I, D)), float32."""
        return (_rows_matmul(self.m_uu, self.m_ui, user_emb, item_emb),
                _rows_matmul(self.m_iu, self.m_ii, user_emb, item_emb))


def _rows_matmul(mu: torch.Tensor, mi: torch.Tensor, user_emb: torch.Tensor,
                 item_emb: torch.Tensor) -> torch.Tensor:
    dt = mu.dtype
    return bdot(mu, user_emb.to(dt)) + bdot(mi, item_emb.to(dt))


def fits_linear_op(num_user: int, num_item: int, max_entries: int = 2_200_000_000) -> bool:
    """Whether M's (U + I)^2 entries are at most ``max_entries``."""
    n = num_user * num_user + num_item * num_item + 2 * num_user * num_item
    return n <= max_entries


@torch.no_grad()
def build_weighted_op(dense_r: torch.Tensor, layer_weights: Sequence[float],
                      store_bf16: bool = True) -> CombinedLinearOp:
    """M = sum_k layer_weights[k] A^k on R's device, summed in float32.

    ``layer_weights[0]`` weighs the identity (ego) layer: LightGCN's uniform
    mean over layers 0..L, SimGCL's and XSimGCL's mean over layers 1..L."""
    num_user, num_item = dense_r.shape
    dev = dense_r.device
    r = dense_r.to(torch.float32)
    w0 = float(layer_weights[0])
    # acc = [M_uu, M_ui, M_iu, M_ii], as w0 * A^0 = w0 * I
    acc = [w0 * torch.eye(num_user, dtype=torch.float32, device=dev),
           torch.zeros((num_user, num_item), dtype=torch.float32, device=dev),
           torch.zeros((num_item, num_user), dtype=torch.float32, device=dev),
           w0 * torch.eye(num_item, dtype=torch.float32, device=dev)]
    # the current power's two blocks that are not zero: (P, S) at even k,
    # (Q, Q') at odd k. From (a, b) the next power's are (R b, R^T a):
    # (R Q', R^T Q) = (P, S), and (R S, R^T P) = (Q, Q').
    cur = None
    for k, wk in enumerate(layer_weights[1:], start=1):
        if k == 1:
            cur = (r, r.t())  # R I and R^T I
        else:
            a, b = cur
            cur = None  # the previous power is freed as the new one is made
            x = torch.mm(r, b)
            del b
            cur = (x, torch.mm(r.t(), a))
            del a, x
        for slot, block in zip((0, 3) if k % 2 == 0 else (1, 2), cur):
            acc[slot].add_(block, alpha=float(wk))
    del cur, r
    dt = torch.bfloat16 if store_bf16 else torch.float32
    out = []
    while acc:  # cast and free one float32 block at a time
        out.append(acc.pop(0).to(dt))
    return CombinedLinearOp(*out)


def lightgcn_weights(n_layers: int) -> list:
    """LightGCN's layer combination: the uniform mean over layers 0..n."""
    return [1.0 / (n_layers + 1)] * (n_layers + 1)


def build_combined_op(dense_r: torch.Tensor, n_layers: int,
                      store_bf16: bool = True) -> CombinedLinearOp:
    """LightGCN's operator: ``build_weighted_op`` at ``lightgcn_weights``."""
    return build_weighted_op(dense_r, lightgcn_weights(n_layers), store_bf16)
