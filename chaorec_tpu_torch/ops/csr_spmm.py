"""Weighted gather-sum over the rows of a CSR graph, and its gradient.

    out[r] = sum over the edges e of row r, in the row's stored order, of
             w[e] * x[src[e]]                                   (n_rows, D)

in fp32: each product rounded to fp32, added to a running fp32 total that
starts at 0, one edge after another. The segment graph
(``graphs/norm_adj.py``) sums its propagation with it, forward and
backward. Its CSRs (``norm_adj.build_csr``) store each row's edges in the
order the deterministic ``index_add_`` (and the gather's backward,
``index_put_`` with accumulate) adds them: the stable sort of the
destinations over the message positions. So the sums are that scatter's
bits.

Replaces no TPU kernel: the JAX package's segment and ELL sums are XLA's.
``csr_spmm`` is the wrapper of the CUDA C++ kernel ``csrc/csr_spmm.cu``:

- a CPU tensor takes ``csr_spmm_reference``, the plain version (a gather
  and ``index_add_`` in the CSR's order);
- a CUDA tensor launches the kernel, or raises. There is no fallback.

``csr_spmm.launches`` counts kernel launches (one a call with a row to
write), and each launch adds 1 to the tracing counter ``graph.csr_spmm``.
``csr_apply`` is the differentiable form: the forward sums over one CSR,
the input's gradient over its transpose.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from chaorec_tpu_torch import kernels, tracing


@dataclass(frozen=True)
class Csr:
    """A graph's edges grouped by output row, rows longest first (the
    kernel's launch order): slot t sums edges [ptr[t], ptr[t + 1]) of
    ``src`` and ``w``, in their stored order, into output row ``rows[t]``."""

    n_rows: int  # output rows
    n_src: int  # rows of the gathered input
    ptr: torch.Tensor  # (n_rows + 1,) int32, rising from 0
    rows: torch.Tensor  # (n_rows,) int32, each output row once, by falling degree
    src: torch.Tensor  # (E,) int32 input rows
    w: torch.Tensor  # (E,) float32 weights


def csr_spmm_reference(x: torch.Tensor, csr: Csr) -> torch.Tensor:
    """Plain PyTorch version on any device: the gathered, weighted rows
    added by ``index_add_`` in the CSR's order (on the CPU, and on the card
    under the deterministic mode, one message after another)."""
    dst = torch.repeat_interleave(csr.rows.long(), csr.ptr.diff().long())
    out = torch.zeros((csr.n_rows, x.shape[1]), dtype=torch.float32, device=x.device)
    return out.index_add_(0, dst, csr.w[:, None] * x.float()[csr.src.long()])


@functools.cache
def _kernel_fn():
    fn = kernels.load("csr_spmm").chaorec_csr_spmm
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def check_args(x: torch.Tensor, csr: Csr) -> None:
    """What the kernel takes; raises on anything else."""
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"x must be (n_src, D) with D >= 1, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[0] != csr.n_src:
        raise ValueError(f"x has {x.shape[0]} rows, the CSR gathers from {csr.n_src}")
    for name in ("ptr", "rows", "src", "w"):
        if getattr(csr, name).device != x.device:
            raise ValueError(f"the CSR's {name} is on {getattr(csr, name).device}, x on "
                             f"{x.device}")


def csr_spmm(x: torch.Tensor, csr: Csr) -> torch.Tensor:
    """(csr.n_rows, D) float32: each row's weighted sum of ``x``'s rows
    (float32 or bfloat16, contiguous, ``csr.n_src`` rows)."""
    check_args(x, csr)
    if x.device.type == "cpu":
        return csr_spmm_reference(x, csr)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmm runs on cpu or cuda, got {x.device}")
    dev = x.device
    out = torch.empty((csr.n_rows, x.shape[1]), dtype=torch.float32, device=dev)
    if csr.n_rows == 0:
        return out
    err = _kernel_fn()(x.data_ptr(), int(x.dtype == torch.bfloat16), csr.ptr.data_ptr(),
                       csr.rows.data_ptr(), csr.src.data_ptr(), csr.w.data_ptr(),
                       out.data_ptr(), csr.n_rows, x.shape[1], dev.index,
                       torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"csr_spmm kernel launch failed: cudaError {err}")
    csr_spmm.launches += 1
    tracing.count("graph.csr_spmm")
    return out


csr_spmm.launches = 0


class _CsrSum(torch.autograd.Function):
    """``csr_spmm`` over ``fwd``, its input's gradient over ``bwd`` (the
    transposed edges, in the order the gather's backward adds them)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, bf16):
        ctx.bwd = bwd
        x = x.contiguous()
        return csr_spmm(x.to(torch.bfloat16) if bf16 else x, fwd)

    @staticmethod
    def backward(ctx, g):
        return csr_spmm(g.float().contiguous(), ctx.bwd), None, None, None


def csr_apply(x: torch.Tensor, fwd: Csr, bwd: Csr, bf16: bool = False) -> torch.Tensor:
    """Differentiable ``csr_spmm(x, fwd)``; with ``bf16`` the input is read
    rounded to bf16 and its gradient passes unrounded."""
    return _CsrSum.apply(x, fwd, bwd, bf16)
