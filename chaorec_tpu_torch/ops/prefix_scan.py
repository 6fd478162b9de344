"""Inclusive prefix sum down the rows of an (M, D) tensor.

Counterpart of ``chaorec_tpu/ops/pallas_scan.py``. Its Pallas TPU kernel
(``_cumsum_kernel``, launched by ``chunked_cumsum``) becomes the CUDA C++
kernel ``csrc/prefix_scan.cu``: ``out[r] = sum_{i <= r} x[i]`` in fp32 for
fp32 or bf16 x, in one launch that reads x once and writes out once. Tiles
of rows hand their running total on by a look-back summed in a fixed
forward order, so a second run gives the same bits.

``prefix_cumsum`` is what the segment sums of ``ops/ell.py`` call. The
tensor's device picks the path:

- a CPU tensor takes ``prefix_cumsum_reference``, the plain version;
- a CUDA tensor launches the kernel, or raises. There is no fallback and no
  gate: the TPU's opt-in ``use_pallas_scan`` is not ported, nor its 512-row
  blocks and zero padding (the kernel bounds the ragged edges itself).

``prefix_cumsum.launches`` counts kernel launches (one per call: a memset of
the call's scratch, then the kernel); CPU calls count nothing.

``kernel_order`` is the kernel's fp32 summation order written in numpy, bit
for bit the kernel's (tests/test_torch_prefix_scan.py holds the card to it):
``prefix_cumsum_kernel_order`` runs it on a host tensor, so that a CPU step
can share every prefix rounding with a card step (chip_smoke.py phase 46).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from chaorec_tpu_torch import kernels

# The kernel's constants (csrc/prefix_scan.cu)
THREADS = 256  # threads of a block: row groups x units of a column tile
RUN_ROWS = 16  # most rows of a thread's run
MAX_UNITS = 16  # most units (4 columns, or 1 on the scalar path) of a column tile
VEC = 4  # columns of a unit on the vector path


class TileLayout(NamedTuple):
    """How the kernel cuts an (m, d) input: tiles of ``tile_rows`` rows by a
    column tile of ``tile_units`` units, ``groups`` row groups a block, each
    a run of ``run_rows`` rows; ``scratch_words`` four-byte words of
    scratch (a tile's aggregate and inclusive prefix, fp32 vectors of d a
    row tile, then the tile counter)."""

    vec: bool
    units: int
    col_tiles: int
    tile_units: int
    groups: int
    tile_rows: int
    run_rows: int
    row_tiles: int
    tiles: int
    scratch_words: int


def prefix_cumsum_reference(v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the fp32 inclusive prefix along dim 0."""
    return torch.cumsum(v.float(), dim=0)


@functools.cache
def _kernel_fn():
    fn = kernels.load("prefix_scan").chaorec_prefix_scan
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr, i32, ptr, ptr, i64, i64, i32, i32, i32, i64, i64, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def tile_layout(m: int, d: int, vec: bool, tile_rows: Optional[int] = None) -> TileLayout:
    """The kernel's tiles for an (m, d) input: column tiles of at most
    ``MAX_UNITS`` units, as even as they can be, and (unless ``tile_rows``
    is given, which only tests do) the tallest tile a block's registers
    hold: ``groups x RUN_ROWS`` rows."""
    units = d // VEC if vec else d
    col_tiles = -(-units // MAX_UNITS)
    tile_units = -(-units // col_tiles)
    groups = THREADS // tile_units
    if tile_rows is None:
        tile_rows = groups * RUN_ROWS
    if not 1 <= tile_rows <= groups * RUN_ROWS:
        raise ValueError(f"tile_rows must be in [1, {groups * RUN_ROWS}], got {tile_rows}")
    row_tiles = -(-m // tile_rows)
    tiles = row_tiles * col_tiles
    return TileLayout(vec, units, col_tiles, tile_units, groups, tile_rows,
                      -(-tile_rows // groups), row_tiles, tiles, 2 * row_tiles * d + 1)


def kernel_order(x: np.ndarray, lay: TileLayout) -> np.ndarray:
    """csrc/prefix_scan.cu's fp32 summation order, in numpy: each group's
    run scanned in order, the run totals scanned over the groups
    (Hillis-Steele), the carry as the serial running total of the tiles'
    aggregates, out = (carry + the groups before) + the run's prefix. The
    columns are independent, so column tiles do not change it."""
    m, d = x.shape
    g, run, rows, tiles = lay.groups, lay.run_rows, lay.tile_rows, lay.row_tiles
    r = np.arange(m)
    blocks = np.zeros((tiles, g, run, d), np.float32)
    blocks[r // rows, r % rows // run, r % rows % run] = x
    incl = np.cumsum(blocks, axis=2, dtype=np.float32)
    part = incl[:, :, -1].copy()
    off = 1
    while off < g:
        part[:, off:] = part[:, off:] + part[:, :-off]
        off *= 2
    before = np.concatenate([np.zeros_like(part[:, :1]), part[:, :-1]], axis=1)
    carry = np.zeros((tiles, d), np.float32)
    total = part[0, -1]
    for i in range(1, tiles):
        carry[i] = np.float32(0) + total
        total = carry[i] + part[i, -1]
    out = (carry[:, None, :] + before)[:, :, None, :] + incl
    return out.reshape(tiles, g * run, d)[:, :rows].reshape(-1, d)[:m]


def prefix_cumsum_kernel_order(v: torch.Tensor, out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """``prefix_cumsum`` of v in the kernel's summation order, taken on the
    host (``kernel_order`` at the layout the kernel takes for a contiguous,
    aligned v of v's shape), on v's device; written into ``out`` when it is
    given."""
    m = v.shape[0]
    x = v.detach().float().cpu().reshape(m, -1).numpy()
    d = x.shape[1]
    got = torch.from_numpy(kernel_order(x, tile_layout(m, d, d % VEC == 0)))
    got = got.reshape(v.shape).to(v.device)
    return got if out is None else out.copy_(got)


def vector_path(v: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel takes 4-column units for ``v`` and ``out``: D a
    multiple of 4, out 16-byte aligned and v aligned to its 4 elements
    (``cs[1:]`` of ops/ell.py lies 4 D bytes into its allocation)."""
    d = v.numel() // v.shape[0]
    return (d % VEC == 0 and out.data_ptr() % 16 == 0
            and v.data_ptr() % (VEC * v.element_size()) == 0)


def check_args(v: torch.Tensor, out: torch.Tensor) -> None:
    """What the kernel takes; raises on anything else."""
    if v.dim() not in (1, 2) or v.numel() == 0:
        raise ValueError(f"v must be a non-empty (M,) or (M, D), got {tuple(v.shape)}")
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"v must be float32 or bfloat16, got {v.dtype}")
    if out.shape != v.shape or out.dtype != torch.float32:
        raise ValueError(f"out must be float32 {tuple(v.shape)}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    for name, t in (("v", v), ("out", out)):
        if t.device != v.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {v.device}")


def prefix_cumsum(v: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fp32 inclusive prefix of ``v`` (M, D) or (M,) along dim 0, written
    into ``out`` (contiguous float32 of v's shape) when it is given."""
    if v.device.type == "cpu":
        if out is None:
            return prefix_cumsum_reference(v)
        return torch.cumsum(v.float(), dim=0, out=out)
    if v.device.type != "cuda":
        raise ValueError(f"prefix_cumsum runs on cpu or cuda, got {v.device}")
    return _launch(v, out)


def _launch(v: torch.Tensor, out: Optional[torch.Tensor] = None,
            tile_rows: Optional[int] = None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors; ``tile_rows`` other than
    the layout's own is for tests, which use it to make many tiles."""
    dev = v.device
    if out is None:
        out = torch.empty(v.shape, dtype=torch.float32, device=dev)
    check_args(v, out)
    m = v.shape[0]
    d = v.numel() // m
    lay = tile_layout(m, d, vector_path(v, out), tile_rows)
    scratch = torch.empty(lay.scratch_words, dtype=torch.int32, device=dev)
    err = _kernel_fn()(v.data_ptr(), int(v.dtype == torch.bfloat16), out.data_ptr(),
                       scratch.data_ptr(), lay.scratch_words, m, d, int(lay.vec), lay.col_tiles,
                       lay.tile_rows, lay.row_tiles, dev.index,
                       torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"prefix_cumsum kernel launch failed: cudaError {err}")
    prefix_cumsum.launches += 1
    return out


prefix_cumsum.launches = 0
