"""Fused small-head attention: ``softmax(q k^T / sqrt(dh)) v``.

Counterpart of ``chaorec_tpu/ops/pallas_attn.py``, whose Pallas TPU kernel
``_fwd_kernel`` (launched by ``_mha_fwd_raw``) becomes the CUDA C++ kernel
``csrc/fused_mha.cu``. Built for CF_Diff's CAM_AE: 1034 scalar tokens at
d_model 16 and 4 heads, so d_head 4. The kernel streams keys through an
online softmax and never stores the (B, h, Lq, Lk) scores, which for an
export chunk of 4096 users would be 70 GB.

Layout is the JAX package's: q (B, h, Lq, dh), k and v (B, h, Lk, dh),
float32. The tensor's device picks the path:

- a CPU tensor takes ``mha_reference``, the plain PyTorch version;
- a CUDA tensor launches the kernel, or raises. There is no fallback.

Not yet ported: the in-kernel attention-weight dropout (``keep_prob < 1``)
and the backward kernel ``_bwd_kernel``; both come with CF_Diff training.
Until then ``fused_mha`` raises for ``keep_prob < 1``, and on CUDA when
autograd would need a gradient.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from chaorec_tpu_torch import kernels

SUPPORTED_DH = (4,)  # d_head values csrc/fused_mha.cu is instantiated for


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: materializes the (B, h, Lq, Lk) scores."""
    dh = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dh)
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", a, v)


@functools.cache
def _kernel_fn():
    fn = kernels.load("fused_mha").chaorec_mha_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, h, L, dh), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (float4 rows)")
    b, h, lq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != dh:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "do not match (B, h, Lq, dh) / (B, h, Lk, dh)"
        )
    if lq < 1 or k.shape[2] < 1 or b * h < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if dh not in SUPPORTED_DH:
        raise ValueError(f"d_head {dh} not built; the kernel has {SUPPORTED_DH}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    _check(q, k, v)
    b, h, lq, dh = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, lq, k.shape[2], dh, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mha kernel launch failed: cudaError {err}")
    fused_mha.launches += 1
    return out


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int,
              keep_prob: float = 1.0) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) @ v for q (B, h, Lq, dh), k, v (B, h, Lk, dh).

    ``seed`` will key the dropout stream; it is unused while only
    ``keep_prob == 1.0`` is supported. ``fused_mha.launches`` counts the
    kernel launches in this process (CPU calls do not count)."""
    if keep_prob != 1.0:
        raise NotImplementedError("attention dropout (keep_prob < 1) is not ported yet")
    if q.device.type == "cpu":
        return mha_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_mha runs on cpu or cuda, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the fused_mha backward kernel is not ported yet")
    return _launch(q, k, v)


fused_mha.launches = 0
