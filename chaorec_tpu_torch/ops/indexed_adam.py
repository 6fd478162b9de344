"""Row-sparse Adam for large feature tables: dense-Adam math, no dense gradient.

Counterpart of ``chaorec_tpu/ops/indexed_adam.py``. Some multimodal models
train their raw modality feature tables (the reference's
``nn.Embedding.from_pretrained(freeze=False)``, Model/FREEDOM.py:52-57):
an (num_item, 4096) parameter whose gradient is nonzero on the ~2B rows a
batch touches. ``row_adam_update`` computes the step that dense Adam takes
on the scattered gradient,

    m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2,
    p = p - lr (m / bc1) / (sqrt(v / bc2) + eps)      (g zero off the rows)

from the gathered rows alone: one elementwise sweep correct for every
row with zero gradient, then a fix-up of the batch rows from values
gathered before the sweep, with duplicate rows' gradients summed first.
Storage may be bf16 (``--relaxed_precision bf16``); the math is fp32 and
only the stored values round.

``table_adam_update`` is what the trainer calls. A CPU table takes
``row_adam_update``; a CUDA table goes through ``ops/row_adam.py``'s
kernel, in place, in fp32 or bf16 storage and at any D. The JAX package's
routing of bf16 tables and D % 128 != 0 to XLA is a limit of the TPU's
compiler and does not apply here.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from chaorec_tpu_torch.ops.row_adam import fused_row_adam, prepare_sorted_rows


class TableOptState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


def init_table_state(table: torch.Tensor) -> TableOptState:
    return TableOptState(torch.zeros_like(table), torch.zeros_like(table))


def table_adam_update(table: torch.Tensor, state: TableOptState, rows: torch.Tensor,
                      g_rows: torch.Tensor, count: torch.Tensor, lr: float,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                      ) -> Tuple[torch.Tensor, TableOptState]:
    """One Adam step of ``table`` for the gradient ``g_rows`` (B, D) of
    ``table[rows]`` (duplicates allowed); ``count`` is the step count after
    this update. Rows >= N are padding, skipped (the kernel's sentinel:
    a mesh rank's ids of rows another rank owns). Returns the new (table,
    state): on the card the same tensors, updated in place by the kernel."""
    if table.device.type == "cpu":
        keep = rows < table.shape[0]
        return row_adam_update(table, state, rows[keep], g_rows[keep], count, lr, b1, b2, eps)
    if table.device.type != "cuda":
        raise ValueError(f"table_adam_update runs on cpu or cuda, got {table.device}")
    r_s, g_s = prepare_sorted_rows(rows, g_rows, table.shape[0])
    fused_row_adam(table, state.m, state.v, r_s, g_s, count, lr, b1, b2, eps)
    return table, state


def row_adam_update(table: torch.Tensor, state: TableOptState, rows: torch.Tensor,
                    g_rows: torch.Tensor, count: torch.Tensor, lr: float,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                    ) -> Tuple[torch.Tensor, TableOptState]:
    """One exact Adam step on a table with row-sparse gradients; the plain
    version, on any device. Returns new tensors; the inputs are unchanged."""
    m, v = state
    store = table.dtype
    g_rows = g_rows.float()
    c = count.to(torch.float32)
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c
    rows = rows.to(torch.int64)

    # the touched rows before the sweep, in fp32
    m_rows = m[rows].float()
    v_rows = v[rows].float()
    p_rows = table[rows].float()

    # (A) the zero-gradient step, for every row
    m32 = b1 * m.float()
    v32 = b2 * v.float()
    table = (table.float() - lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)).to(store)
    m = m32.to(store)
    v = v32.to(store)

    # (B) the batch rows, with their duplicates' gradients summed: every
    # sorted position carries its row's total, so the writes agree
    order = torch.argsort(rows, stable=True)
    r_sorted = rows[order]
    first = torch.ones_like(r_sorted, dtype=torch.bool)
    first[1:] = r_sorted[1:] != r_sorted[:-1]
    seg = torch.cumsum(first, 0) - 1
    g_sum = torch.zeros_like(g_rows).index_add_(0, seg, g_rows[order])[seg]
    m_new = b1 * m_rows[order] + (1.0 - b1) * g_sum
    v_new = b2 * v_rows[order] + (1.0 - b2) * g_sum ** 2
    p_new = p_rows[order] - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    m[r_sorted] = m_new.to(store)
    v[r_sorted] = v_new.to(store)
    table[r_sorted] = p_new.to(store)
    return table, TableOptState(m, v)
