"""The card's published peaks and the operation counts the metrics divide by.

NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit: 67 TFLOP/s in
float32 outside the tensor cores, 989 TFLOP/s in bf16, 3.35 TB/s of HBM.

``lse_bound`` is ``chip_smoke.py:lse_bound``'s arithmetic, rewritten here: a
K2 call's least time, the larger of its operations over the fp32 peak and
its bytes (each input read once, each output written once) over the memory
rate. ``*_flops`` count a training step's model work, whatever implements
it: products over the edge list, the catalog logsumexp, the BPR scores.
"""

from __future__ import annotations

from typing import Tuple

PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS
             ) -> Tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lse_bound(b: int, n: int, e: int, kernel: str) -> Tuple[float, str]:
    """Bound of one K2 kernel over q (b, e) and k (n, e): the logits take
    2 e flops each and dq's or dk's product 2 e more (exps not counted);
    q and k are read once, lse and g (b,) once each by the backward, and
    the output written once."""
    flops = (2 if kernel == "fwd" else 4) * b * n * e
    nbytes = 4 * (b * e + n * e + {"fwd": b, "dq": 2 * b + b * e, "dk": 2 * b + n * e}[kernel])
    return bound_ms(flops, nbytes)


def k2_call_bound_ms(b: int, n: int, e: int) -> float:
    """One contrastive term's K2 work in a step: forward, dq and dk."""
    return sum(lse_bound(b, n, e, k)[0] for k in ("fwd", "dq", "dk"))


def propagation_flops(n_edges: float, dim: int, n_layers: int) -> float:
    """A graph's mean-of-layers propagation, forward and backward: each
    layer is two products over the edge list (users and items), 2 flops
    an edge and a column each; the backward is the same two products."""
    return 2 * n_layers * 2 * (2 * n_edges * dim)


def contrast_flops(b: int, n: int, e: int) -> float:
    """One catalog logsumexp's model work: the logits forward and the two
    gradient products (dq, dk), 2 b n e each."""
    return 3 * 2 * b * n * e


def bpr_flops(b: int, dim: int) -> float:
    """The positive and negative scores of a batch, forward and backward."""
    return 3 * 2 * (2 * b * dim)
