"""bf16 matrix products with float32 results.

Counterpart of ``chaorec_tpu/ops/mxu.py:bdot`` and of the JAX package's
``jnp.dot(a_bf16, b_bf16, preferred_element_type=jnp.float32)``: products
of bf16 values, summed and returned in float32. ``torch.matmul`` of two
bf16 tensors would round its result to bf16.

- On the CPU, ``a.float() @ b.float()``: a product of two bf16 values is
  exact in float32, so this is the JAX package's arithmetic up to the
  order of the sums.
- On the card, ``torch.mm(a, b, out_dtype=torch.float32)``: the tensor
  cores' bf16 products with a float32 result. It has no autograd formula,
  so ``_Bf16MatMul`` gives it one: each gradient is the float32 product of
  the float32 cotangent with the other operand, rounded to that input's
  dtype, as JAX's transpose of the product rounds it.
"""

from __future__ import annotations

import torch


class _Bf16MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (g @ b.float().t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = (a.float().t() @ g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a @ b`` of two 2-D bf16 tensors (float32 tensors are
    multiplied as they are)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"bdot takes two bf16 or two float32 tensors, got {a.dtype}, {b.dtype}")
    if a.device.type == "cuda":
        return _Bf16MatMul.apply(a, b)
    return a.float() @ b.float()
