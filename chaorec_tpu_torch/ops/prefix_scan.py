"""Inclusive prefix sum down the rows of an (M, D) tensor.

Counterpart of ``chaorec_tpu/ops/pallas_scan.py``. Its Pallas TPU kernel
(``_cumsum_kernel``, launched by ``chunked_cumsum``) becomes the CUDA C++
kernel ``csrc/prefix_scan.cu``: ``out[r] = sum_{i <= r} x[i]`` in fp32 for
fp32 or bf16 x, in three passes (chunk totals, their carries, the chunk
scans) with no atomics, so a second run gives the same bits.

``prefix_cumsum`` is what the segment sums of ``ops/ell.py`` call. The
tensor's device picks the path:

- a CPU tensor takes ``prefix_cumsum_reference``, the plain version;
- a CUDA tensor launches the kernel, or raises. There is no fallback and no
  gate: the TPU's opt-in ``use_pallas_scan`` is not ported, nor its 512-row
  blocks and zero padding (the kernel bounds the ragged edges itself).

``prefix_cumsum.launches`` counts kernel launches (one per call; a call runs
the kernel's three passes); CPU calls count nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from chaorec_tpu_torch import kernels

THREADS = 256  # block of the chunk passes, and the widest column tile
BLOCKS_PER_SM = 4  # rows are cut into about this many chunks per SM and column tile
MIN_BLOCK_ELEMS = 4096  # but a chunk holds at least this many elements of a tile


def prefix_cumsum_reference(v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the fp32 inclusive prefix along dim 0."""
    return torch.cumsum(v.float(), dim=0)


@functools.cache
def _kernel_fn():
    fn = kernels.load("prefix_scan").chaorec_prefix_scan
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ctypes.c_int, ptr, ptr, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunk_layout(m: int, d: int, sm_count: int) -> Tuple[int, int, int]:
    """(rows per chunk, chunks, row groups per block) of the kernel's grid
    for an (m, d) input: about ``BLOCKS_PER_SM`` blocks per SM, each of at
    least ``MIN_BLOCK_ELEMS`` elements of its column tile."""
    width = min(d, THREADS)
    tiles = -(-d // width)
    target = max(1, BLOCKS_PER_SM * sm_count // tiles)
    chunk_rows = max(-(-m // target), -(-MIN_BLOCK_ELEMS // width))
    return chunk_rows, -(-m // chunk_rows), THREADS // width


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
    if out is None:
        out = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    check_args(v, out)
    m = v.shape[0]
    d = v.numel() // m
    chunk_rows, chunks, groups = chunk_layout(m, d, _sm_count(v.device.index))
    part = torch.empty(chunks * groups * d, dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        err = _kernel_fn()(v.data_ptr(), int(v.dtype == torch.bfloat16), out.data_ptr(),
                           part.data_ptr(), m, d, chunk_rows, chunks,
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"prefix_cumsum kernel launch failed: cudaError {err}")
    prefix_cumsum.launches += 1
    return out


prefix_cumsum.launches = 0
