"""Streaming logsumexp(q @ k.T) over a full catalog, and its gradients.

Counterpart of ``chaorec_tpu/ops/pallas_lse.py``. Its three Pallas TPU
kernels (the forward ``_fwd_kernel`` and the backward pair ``_dq_kernel``,
``_dk_kernel``) become the CUDA C++ kernels of ``csrc/streaming_lse.cu``:

    lse[b] = log sum_j exp(q_b . k_j)                        (B,)
    dq[b]  = g_b sum_j exp(q_b . k_j - lse_b) k_j            (B, E)
    dk[j]  = sum_b exp(q_b . k_j - lse_b) g_b q_b            (N, E)

for q (B, E) and k (N, E), E up to 256, summed in fp32. The (B, N) logits
never reach device memory. A temperature belongs in q (``q / tau``), as in
the JAX package, so the gradients stay exact.

``streaming_logsumexp`` is differentiable in q and k. The tensors' device
picks the path:

- CPU tensors take ``streaming_logsumexp_reference``, the plain PyTorch
  version (its autograd is the oracle of the backward kernels);
- CUDA tensors go through a ``torch.autograd.Function`` that launches the
  forward kernel and saves (q, k, lse); its backward launches the dq
  kernel, and the dk kernel only when k needs a gradient (NCL's
  centroids do not). Gradients come back in the inputs' dtypes. There is
  no size gate and no fallback: a build or launch error raises.

Each wrapper counts its launches in ``.launches`` (one per call; a call
runs the kernel and its short combine pass, which dk skips when B is not
split). At E = 64 with q and k 16-byte aligned (``takes_e64``) all three
run one tile engine (``lse_fwd64_kernel``, laid out by ``forward_splits``;
``lse_bwd64_kernel``, laid out by ``backward_splits``); at other widths
the generic kernels (laid out by ``catalog_splits``). The
TPU layout (``n_valid``, ``_pad_rows``, ``TILE_B``/``TILE_N``) is not
ported: the kernels mask the ragged edges themselves. The TPU's size gate
``use_pallas_lse`` is not ported either.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from chaorec_tpu_torch import kernels

TILE = 64  # rows of a q tile and of a k tile in the kernels
MAX_E = 256
BLOCKS_PER_SM = 4  # the generic forward and dq split the catalog to about this many blocks per SM
# The E = 64 engine (lse_fwd64_kernel, lse_bwd64_kernel): a block keeps
# ENGINE_ROWS rows of one side (forward and dq: q, dk: k) and streams the
# other in TILE-row tiles, split across blocks. One SM holds
# FWD_BLOCKS_PER_SM forward blocks (68 KB of shared memory each); dq and dk
# split to about BWD_BLOCKS_PER_SM blocks per SM (105 KB each).
ENGINE_E, ENGINE_ROWS, FWD_BLOCKS_PER_SM, BWD_BLOCKS_PER_SM = 64, 128, 2, 2


def streaming_logsumexp_reference(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: logsumexp(q @ k.T, -1) in fp32, on any device."""
    return torch.logsumexp(q.float() @ k.float().T, dim=-1)


# ---------------------------------------------------------------------------
# CUDA kernels


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = kernels.load("streaming_lse")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.chaorec_lse_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.chaorec_lse_dq.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.chaorec_lse_dk.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.chaorec_lse_fwd64_blocks_per_sm.argtypes = [ptr]
    for fn in (lib.chaorec_lse_fwd, lib.chaorec_lse_dq, lib.chaorec_lse_dk,
               lib.chaorec_lse_fwd64_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


def catalog_splits(b: int, n: int, sm_count: int) -> Tuple[int, int]:
    """(splits, tiles per split) of the catalog's 64-row tiles for the
    generic forward and dq grids: enough splits that (B / 64) row tiles times the
    splits give about ``BLOCKS_PER_SM`` blocks per SM, each split non-empty."""
    row_tiles, col_tiles = -(-b // TILE), -(-n // TILE)
    splits = min(col_tiles, max(1, -(-BLOCKS_PER_SM * sm_count // row_tiles)))
    per = -(-col_tiles // splits)
    return -(-col_tiles // per), per


def backward_splits(rows: int, streamed: int, sm_count: int) -> Tuple[int, int]:
    """(splits, tiles per split) of the streamed side's TILE-row tiles for
    the E = 64 backward kernels, whose blocks keep ENGINE_ROWS ``rows``
    each: about BWD_BLOCKS_PER_SM blocks per SM in all, each split
    non-empty. dq keeps q and streams k (the catalog), dk keeps k and
    streams q."""
    row_tiles, col_tiles = -(-rows // ENGINE_ROWS), -(-streamed // TILE)
    splits = min(col_tiles, max(1, int(BWD_BLOCKS_PER_SM * sm_count / row_tiles + 0.5)))
    per = -(-col_tiles // splits)
    return -(-col_tiles // per), per


@functools.lru_cache(maxsize=None)
def forward_splits(b: int, n: int, sm_count: int) -> Tuple[int, int]:
    """(splits, tiles per split) of the catalog's TILE-row tiles for
    lse_fwd64_kernel, whose blocks keep ENGINE_ROWS q rows each. The grid
    is one wave (at most FWD_BLOCKS_PER_SM blocks on an SM, unless B alone
    needs more). Of those layouts, the one whose busiest SM computes the
    fewest tiles (tiles per split x its blocks, where one block counts as
    two: its 4 warps keep the SM's FMA pipes half busy), then the one with
    the fewest blocks on that SM (each stages its q rows once)."""
    row_tiles, col_tiles = -(-b // ENGINE_ROWS), -(-n // TILE)
    best = None
    for per in range(1, col_tiles + 1):
        splits = -(-col_tiles // per)
        on_sm = -(-row_tiles * splits // sm_count)
        if on_sm > FWD_BLOCKS_PER_SM and per < col_tiles:
            continue
        key = (per * max(on_sm, 2), on_sm)
        if best is None or key < best[0]:
            best = (key, splits, per)
    return best[1], best[2]


def takes_e64(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the C entry points run the E = 64 engine (E 64, q and k
    16-byte aligned for its cp.async copies); else their generic kernels."""
    return q.shape[1] == ENGINE_E and q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0


def forward_layout(q: torch.Tensor, k: torch.Tensor, sm_count: int) -> Tuple[str, int, int]:
    """(kernel, splits, tiles per split) of the forward at q and k, as the C
    entry point routes it: lse_fwd64_kernel where ``takes_e64``, else the
    generic lse_fwd_kernel."""
    b, n = q.shape[0], k.shape[0]
    if takes_e64(q, k):
        return ("lse_fwd64_kernel", *forward_splits(b, n, sm_count))
    return ("lse_fwd_kernel", *catalog_splits(b, n, sm_count))


def fwd64_blocks_per_sm() -> int:
    """Blocks of lse_fwd64_kernel one SM of the current card holds at once
    (the CUDA occupancy calculator, after its shared memory is allowed)."""
    blocks = ctypes.c_int(0)
    err = _lib().chaorec_lse_fwd64_blocks_per_sm(ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query of lse_fwd64_kernel failed: cudaError {err}")
    return blocks.value


def check_args(q: torch.Tensor, k: torch.Tensor) -> None:
    """What the kernels take; raises on anything else."""
    if q.dim() != 2 or k.dim() != 2 or q.shape[1] != k.shape[1]:
        raise ValueError(f"q (B, E) and k (N, E) must share E, got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    b, e = q.shape
    if b < 1 or k.shape[0] < 1 or not 1 <= e <= MAX_E:
        raise ValueError(f"need B >= 1, N >= 1 and 1 <= E <= {MAX_E}, got B {b}, "
                         f"N {k.shape[0]}, E {e}")
    if k.device != q.device:
        raise ValueError(f"q is on {q.device}, k on {k.device}")


def _check_kernel_args(q: torch.Tensor, k: torch.Tensor, *rows: torch.Tensor) -> None:
    """``check_args``, and every tensor a contiguous float32 one on q's
    device; ``rows`` (lse and g) each of shape (B,)."""
    check_args(q, k)
    for t in (q, k, *rows):
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"expected a contiguous float32 tensor on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    for t in rows:
        if t.shape != (q.shape[0],):
            raise ValueError(f"lse and g must be ({q.shape[0]},), got {tuple(t.shape)}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def streaming_lse_fwd(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """lse (B,) fp32 of contiguous fp32 CUDA q (B, E) and k (N, E)."""
    _check_kernel_args(q, k)
    dev = q.device
    b, e = q.shape
    n = k.shape[0]
    _, splits, per = forward_layout(q, k, kernels.sm_count(dev.index))
    part = torch.empty((2, splits, b), dtype=torch.float32, device=dev)
    lse = torch.empty(b, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().chaorec_lse_fwd(q.data_ptr(), k.data_ptr(), part[0].data_ptr(),
                                     part[1].data_ptr(), lse.data_ptr(), b, n, e, splits, per,
                                     _stream())
    _raise_on(err, "streaming_lse_fwd")
    streaming_lse_fwd.launches += 1
    return lse


def streaming_lse_dq(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """dq (B, E) fp32: g[:, None] * softmax(q k^T - lse) @ k."""
    _check_kernel_args(q, k, lse, g)
    dev = q.device
    b, e = q.shape
    n = k.shape[0]
    sms = kernels.sm_count(dev.index)
    splits, per = backward_splits(b, n, sms) if takes_e64(q, k) else catalog_splits(b, n, sms)
    part = torch.empty((splits, b, e), dtype=torch.float32, device=dev)
    dq = torch.empty((b, e), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().chaorec_lse_dq(q.data_ptr(), k.data_ptr(), lse.data_ptr(), g.data_ptr(),
                                    part.data_ptr(), dq.data_ptr(), b, n, e, splits, per,
                                    _stream())
    _raise_on(err, "streaming_lse_dq")
    streaming_lse_dq.launches += 1
    return dq


def streaming_lse_dk(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """dk (N, E) fp32: (softmax(q k^T - lse) * g[:, None])^T @ q."""
    _check_kernel_args(q, k, lse, g)
    dev = q.device
    b, e = q.shape
    n = k.shape[0]
    if takes_e64(q, k):
        splits, per = backward_splits(n, b, kernels.sm_count(dev.index))
    else:  # the generic kernel walks all of B in one block
        splits, per = 1, -(-b // TILE)
    dk = torch.empty((n, e), dtype=torch.float32, device=dev)
    # one split writes dk directly
    part = torch.empty((splits, n, e), dtype=torch.float32, device=dev) if splits > 1 else dk
    with torch.cuda.device(dev):
        err = _lib().chaorec_lse_dk(q.data_ptr(), k.data_ptr(), lse.data_ptr(), g.data_ptr(),
                                    part.data_ptr(), dk.data_ptr(), b, n, e, splits, per,
                                    _stream())
    _raise_on(err, "streaming_lse_dk")
    streaming_lse_dk.launches += 1
    return dk


streaming_lse_fwd.launches = 0
streaming_lse_dq.launches = 0
streaming_lse_dk.launches = 0


class _StreamingLSE(torch.autograd.Function):
    """The kernels under one autograd node, as the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, q, k):
        lse = streaming_lse_fwd(q, k)
        ctx.save_for_backward(q, k, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        q, k, lse = ctx.saved_tensors
        g = g.float().contiguous()
        dq = streaming_lse_dq(q, k, lse, g) if ctx.needs_input_grad[0] else None
        dk = streaming_lse_dk(q, k, lse, g) if ctx.needs_input_grad[1] else None
        return dq, dk


def streaming_logsumexp(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """logsumexp(q @ k.T, axis=-1) (B,) fp32 without the (B, N) logits in
    device memory; differentiable in q and k."""
    if q.device.type == "cpu" and k.device.type == "cpu":
        return streaming_logsumexp_reference(q, k)
    check_args(q, k)
    if q.device.type != "cuda":
        raise ValueError(f"streaming_logsumexp runs on cpu or cuda, got {q.device}")
    # .float() is autograd's cast: the gradients come back in q's and k's dtypes
    return _StreamingLSE.apply(q.float().contiguous(), k.float().contiguous())
