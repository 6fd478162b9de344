"""Fused small-head attention with dropout: ``(softmax(q k^T / sqrt(dh)) * D) v``.

Counterpart of ``chaorec_tpu/ops/pallas_attn.py``. Its two Pallas TPU
kernels become CUDA C++ kernels: ``_fwd_kernel`` (launched by
``_mha_fwd_raw``) is ``csrc/fused_mha.cu``, and ``_bwd_kernel`` (launched
by ``_mha_bwd_raw``) is ``csrc/fused_mha_bwd.cu``. ``fused_mha`` joins
them in a ``torch.autograd.Function``, the counterpart of the JAX
package's ``custom_vjp``. Built for CF_Diff's CAM_AE: 1034 scalar tokens
at d_model 16 and 4 heads, so d_head 4. The kernels stream keys through
an online softmax and never store the (B, h, Lq, Lk) scores, which for an
export chunk of 4096 users would be 70 GB.

Dropout (``keep_prob < 1``) keeps each attention weight with probability
``keep_prob`` and scales it by ``1 / keep_prob``. The keep bit of weight
(g, i, j), with g = batch * heads + head, is a function of (seed, g, i, j)
alone: Philox4x32-10 with counter (j // 4, i, g, 0) and key (seed mod 2^32,
seed >> 32), word j % 4, kept when below ``keep_prob * 2^32``
(``csrc/philox.cuh``). ``philox4x32`` computes the same function with torch
int64 operations, so the plain version ``mha_reference`` draws the very
mask the kernels draw, and autograd of the plain version is the oracle of
the backward kernel, dropout included. The TPU kernel's hardware PRNG
stream is not reproduced: the two packages agree in distribution only.

Layout is the JAX package's: q (B, h, Lq, dh), k and v (B, h, Lk, dh),
float32. The tensor's device picks the path:

- a CPU tensor takes ``mha_reference``, the plain PyTorch version, and
  autograd differentiates it;
- a CUDA tensor launches the kernels, or raises. There is no fallback.

``fused_mha.launches`` counts forward kernel launches and
``fused_mha_bwd.launches`` backward ones (one per backward call, which
launches the dq kernel and then the dk/dv kernel); CPU calls count nothing.
The backward draws each keep bit once, in its dq kernel, and hands the
bits to its dk/dv kernel packed in a scratch (``pack_keep_bits``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import torch

from chaorec_tpu_torch import kernels

SUPPORTED_DH = (4,)  # d_head values the kernels are instantiated for

Seed = Union[int, torch.Tensor]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Philox4x32 key increments
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * b`` for ``a`` and the entries of
    ``b`` in [0, 2^32). The 64-bit product would overflow int64, so ``a`` is
    split into 16-bit halves and every partial product stays below 2^49."""
    t = (a & 0xFFFF) * b
    u = (a >> 16) * b + (t >> 16)
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32(c0, c1, c2, c3, k0, k1) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors (or ints) holding 32-bit words; they
    broadcast against each other. Returns the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def keep_threshold(keep_prob: float) -> int:
    """A weight is kept when its 32-bit Philox word is below this."""
    return min(int(keep_prob * 2.0 ** 32), 2 ** 32 - 1)


def dropout_mask(seed: Seed, n_groups: int, lq: int, lk: int, keep_prob: float,
                 first_group: int = 0,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """(n_groups, lq, lk) bool keep mask of groups ``first_group`` onwards,
    bit for bit the one the kernels draw."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(())
    arange = functools.partial(torch.arange, dtype=torch.int64, device=device)
    n4 = -(-lk // 4)
    words = philox4x32(arange(n4)[None, None, :], arange(lq)[None, :, None],
                       arange(first_group, first_group + n_groups)[:, None, None],
                       0, seed & _MASK32, (seed >> 32) & _MASK32)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    return bits.reshape(n_groups, lq, 4 * n4)[..., :lk] < keep_threshold(keep_prob)


def pack_keep_bits(mask: torch.Tensor) -> torch.Tensor:
    """(G, Lq, Lk) bool keep mask as (G, Lq, ceil(Lk / 32)) int32 words:
    bit j % 32 of word j // 32 is key j, bits past Lk are 0. The layout of
    the keep bits ``csrc/fused_mha_bwd.cu`` passes from its dq kernel to
    its dk/dv kernel."""
    g, lq, lk = mask.shape
    nw = -(-lk // 32)
    padded = torch.zeros((g, lq, 32 * nw), dtype=torch.int64, device=mask.device)
    padded[..., :lk] = mask
    weights = 2 ** torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (padded.view(g, lq, nw, 32) * weights).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  seed: Optional[Seed] = None, keep_prob: float = 1.0,
                  first_group: int = 0) -> torch.Tensor:
    """Plain PyTorch version: materializes the (B, h, Lq, Lk) scores and, for
    ``keep_prob < 1``, the kernels' mask. ``first_group`` is the group index
    of q[0, 0], for a slice of a larger batch."""
    b, h, lq, dh = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dh)
    a = torch.softmax(s, dim=-1)
    if keep_prob < 1.0:
        if seed is None:
            raise ValueError("dropout (keep_prob < 1) needs a seed")
        keep = dropout_mask(seed, b * h, lq, k.shape[2], keep_prob, first_group,
                            q.device).view(a.shape)
        a = torch.where(keep, a * (1.0 / keep_prob), torch.zeros((), dtype=a.dtype,
                                                                  device=a.device))
    return torch.einsum("bhqk,bhkd->bhqd", a, v)


def mha_reference_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, seed: Optional[Seed] = None,
                        keep_prob: float = 1.0, first_group: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward: autograd of ``mha_reference``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = mha_reference(*leaves, seed, keep_prob, first_group)
        return torch.autograd.grad(out, leaves, dout)


# ---------------------------------------------------------------------------
# CUDA kernels


@functools.cache
def _fwd_fn():
    fn = kernels.load("fused_mha").chaorec_mha_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = kernels.load("fused_mha_bwd").chaorec_mha_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q on {like.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be (B, h, L, dh), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (float4 rows)")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **q_like: torch.Tensor) -> None:
    """What the kernels take; ``q_like`` tensors (out, dout) must match q."""
    for name, t in (("q", q), ("k", k), ("v", v), *q_like.items()):
        _check_rows(name, t, q)
    b, h, lq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != dh:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "do not match (B, h, Lq, dh) / (B, h, Lk, dh)"
        )
    for name, t in q_like.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must have q's shape {tuple(q.shape)}")
    if lq < 1 or k.shape[2] < 1 or b * h < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if dh not in SUPPORTED_DH:
        raise ValueError(f"d_head {dh} not built; the kernels have {SUPPORTED_DH}")


def _seed_tensor(seed: Seed, device: torch.device) -> torch.Tensor:
    """The seed as one int64 on ``device``, which the kernels read there."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError(f"seed must be one int64, got {seed.dtype} {tuple(seed.shape)}")
        return seed.reshape(1).to(device).contiguous()
    return torch.tensor([seed], dtype=torch.int64, device=device)


def _dropout_args(seed_t: Optional[torch.Tensor], keep_prob: float):
    if keep_prob == 1.0:
        return 0, None, 0, 1.0
    return 1, seed_t.data_ptr(), keep_threshold(keep_prob), 1.0 / keep_prob


def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                seed_t: Optional[torch.Tensor], keep_prob: float,
                with_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    _check(q, k, v)
    b, h, lq, dh = q.shape
    out = torch.empty_like(q)
    lse = q.new_empty((b, h, lq)) if with_lse else None
    with torch.cuda.device(q.device):
        err = _fwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b * h, lq, k.shape[2], dh, *_dropout_args(seed_t, keep_prob),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mha kernel launch failed: cudaError {err}")
    fused_mha.launches += 1
    return out, lse


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                seed: Optional[Seed], keep_prob: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Launches ``csrc/fused_mha_bwd.cu``: (dq, dk, dv) and, below keep 1,
    the keep bits its dq kernel drew and its dk/dv kernel read, in
    ``pack_keep_bits``'s layout (None at keep 1)."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_mha_bwd runs on cuda only, got {q.device}")
    _check(q, k, v, out=out, dout=dout)
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if lse.shape != (b, h, lq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, h, lq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    seed_t = _seed_tensor(seed, q.device) if keep_prob < 1.0 else None
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)  # scratch: dO . O per query row
    bits = (q.new_empty((b * h, lq, -(-lk // 32)), dtype=torch.int32)
            if keep_prob < 1.0 else None)
    with torch.cuda.device(q.device):
        err = _bwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), None if bits is None else bits.data_ptr(),
            b * h, lq, lk, dh, *_dropout_args(seed_t, keep_prob),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mha_bwd kernel launch failed: cudaError {err}")
    fused_mha_bwd.launches += 1
    return dq, dk, dv, bits


def fused_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                  seed: Optional[Seed], keep_prob: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``fused_mha`` for the cotangent ``dout``, given the
    forward's ``out`` and ``lse`` (B, h, Lq), all on the card: launches
    ``csrc/fused_mha_bwd.cu``, whose dq kernel draws the forward's mask once
    into a scratch of (B h, Lq, ceil(Lk / 32)) int32 words that its dk/dv
    kernel reads. Only ``_FusedMHA`` calls it; on the CPU autograd
    differentiates ``mha_reference``, and ``mha_reference_grads`` is the
    plain version."""
    return _launch_bwd(q, k, v, out, dout, lse, seed, keep_prob)[:3]


class _FusedMHA(torch.autograd.Function):
    """Forward kernel, saving what the backward kernel reads."""

    @staticmethod
    def forward(ctx, q, k, v, seed_t, keep_prob):
        out, lse = _launch_fwd(q, k, v, seed_t, keep_prob, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, seed_t)
        ctx.keep_prob = keep_prob
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seed_t = ctx.saved_tensors
        dq, dk, dv = fused_mha_bwd(q, k, v, out, dout.contiguous(), lse, seed_t,
                                   ctx.keep_prob)
        return dq, dk, dv, None, None


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: Seed,
              keep_prob: float = 1.0) -> torch.Tensor:
    """(softmax(q k^T / sqrt(dh)) * D) @ v for q (B, h, Lq, dh), k, v
    (B, h, Lk, dh), with D the dropout mask of ``seed`` at ``keep_prob``.

    ``seed`` is an int or a one-element int64 tensor (on the card, a tensor
    made there needs no host sync); it is unused at ``keep_prob == 1``.
    Gradients flow to q, k and v."""
    if not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"keep_prob must be in (0, 1], got {keep_prob}")
    if q.device.type == "cpu":
        return mha_reference(q, k, v, seed, keep_prob)
    if q.device.type != "cuda":
        raise ValueError(f"fused_mha runs on cpu or cuda, got {q.device}")
    seed_t = _seed_tensor(seed, q.device) if keep_prob < 1.0 else None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FusedMHA.apply(q, k, v, seed_t, keep_prob)
    return _launch_fwd(q, k, v, seed_t, keep_prob, with_lse=False)[0]


fused_mha.launches = 0
fused_mha_bwd.launches = 0
