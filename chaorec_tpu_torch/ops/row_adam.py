"""Fused row-sparse Adam: one exact, in-place Adam step on a large table.

Counterpart of ``chaorec_tpu/ops/pallas_row_adam.py``. Its Pallas TPU
kernel (``_kernel``, launched by ``fused_row_adam``) becomes the CUDA C++
kernel ``csrc/row_adam.cu``. For an (N, D) table p with Adam moments m and
v, given B rows sorted ascending and deduplicated (padding rows carry a
sentinel id >= N) and their summed gradients g (B, D), every element gets

    m = b1 m + [row in batch] (1 - b1) g
    v = b2 v + [row in batch] (1 - b2) g^2
    p = p - lr (m / bc1) / (sqrt(v / bc2) + eps)

with bc1 = 1 - b1^count, bc2 = 1 - b2^count. That is dense Adam on the
scattered gradient, without the dense gradient. Storage is fp32 or bf16;
the math is fp32 either way.

``prepare_sorted_rows`` turns a batch's raw rows (duplicates allowed) and
their gradients into that form. The tensor's device picks the path of
``fused_row_adam``:

- a CPU tensor takes ``row_adam_reference``, the plain PyTorch version;
- a CUDA tensor launches the kernel, or raises. There is no fallback.

Both update p, m and v in place (the JAX package's version returns new
arrays; in place saves a copy of the table per step). ``count`` is an int32
tensor on the table's device, read there, so a step needs no host sync.
``fused_row_adam.launches`` counts kernel launches; CPU calls count nothing.
The kernel's grid is ``tile_rows`` rows a block (``launch_grid``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from chaorec_tpu_torch import kernels

STORAGE_DTYPES = (torch.float32, torch.bfloat16)
MAX_TILE_ROWS = 512  # csrc/row_adam.cu's shared row -> slot map
TILE_BYTES = 16384  # of each of p, m and v a block sweeps, about
FEW_WAVES = 4  # a grid of fewer waves of resident blocks is cut into whole waves


def prepare_sorted_rows(rows: torch.Tensor, g_rows: torch.Tensor,
                        n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows_sorted int32 (B,), g_agg fp32 (B, D)): the distinct rows of
    ``rows`` ascending, each with the sum of its gradients, then sentinel
    rows ``n`` with zero gradient up to B entries.

    The shapes are static and nothing is read back to the host:
    ``torch.unique`` would size its output from the data and so wait for
    the device every step. Sorting gives each distinct row a segment id
    (its rank among the distinct rows); the segment's rows and summed
    gradients are scattered to that position."""
    b = rows.shape[0]
    order = torch.argsort(rows, stable=True)
    r_sorted = rows[order].to(torch.int64)
    first = torch.ones_like(r_sorted, dtype=torch.bool)
    first[1:] = r_sorted[1:] != r_sorted[:-1]
    seg = torch.cumsum(first, 0) - 1
    rows_out = torch.full((b,), n, dtype=torch.int64, device=rows.device)
    rows_out.scatter_(0, seg, r_sorted)  # every position of a segment writes its row
    g_out = torch.zeros((b, g_rows.shape[1]), dtype=torch.float32, device=rows.device)
    g_out.index_add_(0, seg, g_rows[order].float())
    return rows_out.to(torch.int32), g_out


def row_adam_reference(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                       rows_sorted: torch.Tensor, g_agg: torch.Tensor,
                       count: torch.Tensor, lr: float, b1: float = 0.9,
                       b2: float = 0.999, eps: float = 1e-8) -> None:
    """Plain PyTorch version of the kernel, in place, on any device."""
    n = table.shape[0]
    c = count.to(torch.float32)
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c
    valid = rows_sorted < n
    idx = torch.where(valid, rows_sorted, 0).to(torch.int64)
    g_dense = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
    g_dense.index_add_(0, idx, g_agg.float() * valid[:, None])
    hit = torch.zeros((n, 1), dtype=torch.bool, device=table.device)
    hit[idx[valid]] = True
    m32 = b1 * m.float()
    v32 = b2 * v.float()
    m32 = torch.where(hit, m32 + (1.0 - b1) * g_dense, m32)
    v32 = torch.where(hit, v32 + (1.0 - b2) * (g_dense * g_dense), v32)
    p32 = table.float() - lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
    table.copy_(p32)
    m.copy_(m32)
    v.copy_(v32)


# ---------------------------------------------------------------------------
# CUDA kernel


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = kernels.load("row_adam")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chaorec_row_adam.argtypes = [ptr] * 6 + [ctypes.c_longlong] + [i32] * 4 + [f32] * 6 + [ptr]
    lib.chaorec_row_adam_blocks_per_sm.argtypes = [ptr] * 4 + [i32] * 2 + [ptr]
    for fn in (lib.chaorec_row_adam, lib.chaorec_row_adam_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


def tile_rows(n: int, d: int, elem_bytes: int, sm_count: int, blocks_per_sm: int) -> int:
    """Rows a block of the kernel sweeps: the whole rows of about
    TILE_BYTES of each table (1 to MAX_TILE_ROWS). Where that grid would
    take fewer than FEW_WAVES waves of the card's ``sm_count`` x
    ``blocks_per_sm`` resident blocks, the height is set so that the grid
    fills the nearest whole number of waves (at least one): a narrow table
    still fills the card, and no wave runs mostly empty."""
    rows = max(1, min(MAX_TILE_ROWS, TILE_BYTES // (d * elem_bytes)))
    slots = sm_count * blocks_per_sm
    blocks = -(-n // rows)
    if blocks < FEW_WAVES * slots:
        waves = max(1, round(blocks / slots))
        rows = max(1, min(MAX_TILE_ROWS, -(-n // (waves * slots))))
    return rows


def launch_grid(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                g_agg: torch.Tensor) -> Tuple[int, int, int]:
    """(rows a block, blocks, blocks an SM holds) of the kernel's launch on
    these CUDA tables, on the current device: ``tile_rows`` with the
    occupancy of the kernel instance the tables take."""
    resident = ctypes.c_int(0)
    err = _lib().chaorec_row_adam_blocks_per_sm(
        table.data_ptr(), m.data_ptr(), v.data_ptr(), g_agg.data_ptr(), table.shape[1],
        int(table.dtype == torch.bfloat16), ctypes.byref(resident))
    if err != 0:
        raise RuntimeError(f"occupancy query of the row_adam kernel failed: cudaError {err}")
    n, d = table.shape
    rows = tile_rows(n, d, table.element_size(), kernels.sm_count(table.device.index),
                     resident.value)
    return rows, -(-n // rows), resident.value


def check_args(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               rows_sorted: torch.Tensor, g_agg: torch.Tensor,
               count: torch.Tensor) -> None:
    """What the kernel takes; raises on anything else. Any D, any
    alignment (the kernel picks 16-byte vectors where it can)."""
    if table.dim() != 2 or table.shape[0] < 1 or table.shape[1] < 1:
        raise ValueError(f"table must be a non-empty (N, D), got {tuple(table.shape)}")
    if table.dtype not in STORAGE_DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    for name, t in (("m", m), ("v", v)):
        if t.shape != table.shape or t.dtype != table.dtype:
            raise ValueError(f"{name} must match the table: {t.dtype} {tuple(t.shape)}")
    if rows_sorted.dim() != 1 or rows_sorted.dtype != torch.int32 or rows_sorted.numel() < 1:
        raise ValueError(f"rows_sorted must be a non-empty int32 (B,), got "
                         f"{rows_sorted.dtype} {tuple(rows_sorted.shape)}")
    if g_agg.dtype != torch.float32 or g_agg.shape != (rows_sorted.shape[0], table.shape[1]):
        raise ValueError(f"g_agg must be float32 (B, D) = {(rows_sorted.shape[0], table.shape[1])}, "
                         f"got {g_agg.dtype} {tuple(g_agg.shape)}")
    if count.numel() != 1 or count.dtype != torch.int32:
        raise ValueError(f"count must be one int32, got {count.dtype} {tuple(count.shape)}")
    for name, t in (("table", table), ("m", m), ("v", v), ("rows_sorted", rows_sorted),
                    ("g_agg", g_agg), ("count", count)):
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, the table on {table.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_row_adam(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                   rows_sorted: torch.Tensor, g_agg: torch.Tensor, count: torch.Tensor,
                   lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam step on ``table`` (N, D) and its moments ``m``, ``v``, in
    place, for the rows ``rows_sorted`` (int32 (B,), ascending, distinct,
    padded with ids >= N) with summed gradients ``g_agg`` (float32 (B, D));
    ``count`` (one int32) is the step count after this update."""
    if table.device.type == "cpu":
        row_adam_reference(table, m, v, rows_sorted, g_agg, count, lr, b1, b2, eps)
        return
    if table.device.type != "cuda":
        raise ValueError(f"fused_row_adam runs on cpu or cuda, got {table.device}")
    check_args(table, m, v, rows_sorted, g_agg, count)
    n, d = table.shape
    with torch.cuda.device(table.device):
        rows = launch_grid(table, m, v, g_agg)[0]
        err = _lib().chaorec_row_adam(
            table.data_ptr(), m.data_ptr(), v.data_ptr(), rows_sorted.data_ptr(),
            g_agg.data_ptr(), count.data_ptr(), n, d, rows_sorted.shape[0],
            int(table.dtype == torch.bfloat16), rows, lr, b1, b2, 1.0 - b1, 1.0 - b2, eps,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_row_adam kernel launch failed: cudaError {err}")
    fused_row_adam.launches += 1


fused_row_adam.launches = 0
