"""Plain PyTorch pieces of the references: the normalized graph, products
at a stated precision, the trainer's draws worked out again from the seed,
BPR, and Adam written out.

Imports torch and numpy only. Every sum is a float32 ``index_add`` or
``@`` with TF32 off unless a precision says otherwise; a precision is a
dtype name:

- "float32": as is;
- "bfloat16": rounded to bf16 (kept in float32);
- "float8_e4m3fn": scaled by its largest magnitude over 448 and rounded to
  fp8 e4m3 (the control's step below bf16);
- "tf32": only for products (``matmul``), which then run with TF32 on.

``LOWER`` is the step below each, which the control takes.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

LOWER = {"float32": "bfloat16", "bfloat16": "float8_e4m3fn", "matmul_fp32": "tf32"}
FP8_MAX = 448.0
GRAPH_EPS = 1e-7


def round_to(x: torch.Tensor, dtype: Optional[str]) -> torch.Tensor:
    if dtype in (None, "float32", "tf32"):
        return x
    if dtype == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    if dtype == "float8_e4m3fn":
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    raise ValueError(f"no rounding to {dtype!r}")


class _Round(torch.autograd.Function):
    """x rounded to ``fwd`` forward; the gradient rounded to ``bwd``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return round_to(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.bwd), None, None


def rounded(x: torch.Tensor, fwd: Optional[str], bwd: Optional[str] = None) -> torch.Tensor:
    return _Round.apply(x, fwd, bwd)


@contextlib.contextmanager
def matmul_precision(dtype: str):
    """Products at float32 with TF32 off, or with TF32 on for "tf32"."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = dtype == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


@dataclass
class Precision:
    """What each part of a step computes in: the main graph's inputs, its
    weights and its input gradients; the views' inputs; the contrast's
    products; the ranking scores; the metric sums."""

    graph_in: str
    graph_w: str
    graph_grad: Optional[str]
    views_in: str
    contrast: str
    scores: str
    metric_sums: str

    @staticmethod
    def stated(precision: Dict, dense: bool, lower: bool = False) -> "Precision":
        """The configuration's precision on the dense or the segment graph;
        with ``lower``, each one step below (the control)."""
        def step(d):
            return LOWER[d] if lower else d

        graph = precision.get("graph", "float32")
        return Precision(
            graph_in=step(graph),
            graph_w=step(graph) if dense else "float32",
            graph_grad=step(graph) if dense else None,
            views_in=step(precision.get("views", "float32")),
            contrast=LOWER["matmul_fp32"] if lower else "float32",
            scores=step(precision.get("scores", "bfloat16")),
            metric_sums=step(precision.get("metric_sums", "float32")))


@dataclass
class Graph:
    """The symmetric-normalized bipartite graph of the train edges: each
    edge weighs (d_u + eps)^-1/2 (d_i + eps)^-1/2, in float32."""

    num_user: int
    num_item: int
    users: torch.Tensor  # (E,) int64, the edges sorted by user (stably)
    items: torch.Tensor
    w: torch.Tensor  # (E,) float32
    dense: bool

    @staticmethod
    def build(edges: np.ndarray, num_user: int, num_item: int, device,
              dense_threshold: int) -> "Graph":
        order = np.argsort(edges[:, 0], kind="stable")
        e = edges[order].astype(np.int64)
        du = np.bincount(e[:, 0], minlength=num_user).astype(np.float32)
        di = np.bincount(e[:, 1], minlength=num_item).astype(np.float32)
        w = (np.float32(1.0) / np.sqrt((du[e[:, 0]] + np.float32(GRAPH_EPS))
                                       * (di[e[:, 1]] + np.float32(GRAPH_EPS)))).astype(np.float32)
        return Graph(num_user, num_item, torch.from_numpy(e[:, 0]).to(device),
                     torch.from_numpy(e[:, 1]).to(device), torch.from_numpy(w).to(device),
                     num_user * num_item <= dense_threshold)

    def hop(self, xu: torch.Tensor, xi: torch.Tensor, w: torch.Tensor, x_in: str,
            grad: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum over a user's edges of w xi[item], sum over an item's edges
        of w xu[user]): each side's input rounded to ``x_in`` (its gradient
        to ``grad``), float32 sums."""
        ri, ru = rounded(xi, x_in, grad), rounded(xu, x_in, grad)
        new_u = torch.zeros((self.num_user, xi.shape[1]), device=xi.device).index_add(
            0, self.users, w[:, None] * ri[self.items])
        new_i = torch.zeros((self.num_item, xu.shape[1]), device=xu.device).index_add(
            0, self.items, w[:, None] * ru[self.users])
        return new_u, new_i

    def main_hop(self, prec: Precision):
        w = round_to(self.w, prec.graph_w)
        return lambda xu, xi: self.hop(xu, xi, w, prec.graph_in, prec.graph_grad)

    def kept_weights(self, keep: torch.Tensor) -> torch.Tensor:
        """Each edge's weight with the degrees counted over the kept edges
        (0 for a dropped one)."""
        du = torch.zeros(self.num_user, device=keep.device).index_add(0, self.users, keep)
        di = torch.zeros(self.num_item, device=keep.device).index_add(0, self.items, keep)
        return keep * torch.rsqrt((du[self.users] + GRAPH_EPS) * (di[self.items] + GRAPH_EPS))


def mean_of_layers(xu, xi, hop, n_layers: int):
    acc_u, acc_i, cu, ci = xu, xi, xu, xi
    for _ in range(n_layers):
        cu, ci = hop(cu, ci)
        acc_u, acc_i = acc_u + cu, acc_i + ci
    s = 1.0 / (n_layers + 1)
    return acc_u * s, acc_i * s


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)


def weighted_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def bpr(pos: torch.Tensor, neg: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return -weighted_mean(torch.log(torch.sigmoid(pos - neg) + eps), w)


def l2_rows(reg_weight: float, rows, w: torch.Tensor) -> torch.Tensor:
    return reg_weight * sum(weighted_mean(torch.mean(e ** 2, dim=-1), w) for e in rows)


@dataclass
class StepRows:
    users: torch.Tensor
    pos: torch.Tensor
    neg: torch.Tensor
    weights: torch.Tensor
    keeps: List[torch.Tensor]


class Draws:
    """The trainer's random stream worked out again from its seed: one
    permutation of the train edges an epoch, then for each step one
    negative a row (the first of ``neg_candidates`` uniform items outside
    the user's history, else the last) and the model's own draws (SGL: its
    two views' keep masks over the user-sorted edges)."""

    def __init__(self, seed: int, edges: torch.Tensor, hist: torch.Tensor, num_item: int,
                 batch_size: int, neg_candidates: int, keep_draws: int = 0,
                 keep_prob: float = 1.0):
        self.gen = torch.Generator(edges.device).manual_seed(seed)
        self.edges, self.hist, self.num_item = edges, hist, num_item
        self.bs, self.k = batch_size, neg_candidates
        self.keep_draws, self.keep_prob = keep_draws, keep_prob
        self.perm = torch.randperm(edges.shape[0], generator=self.gen, device=edges.device)

    def step(self, b: int) -> StepRows:
        rows = self.edges[self.perm[b * self.bs:(b + 1) * self.bs]]
        users = rows[:, 0]
        cand = torch.randint(0, self.num_item, (users.shape[0], self.k), generator=self.gen,
                             device=users.device, dtype=self.hist.dtype)
        seen = (cand[:, :, None] == self.hist[users][:, None, :]).any(dim=2)
        valid = ~seen
        first = torch.argmax(valid.to(torch.uint8), dim=1)
        pick = torch.where(valid.any(dim=1), first, self.k - 1)
        neg = torch.gather(cand, 1, pick[:, None])[:, 0].to(torch.int64)
        e = self.edges.shape[0]
        keeps = [(torch.rand(e, generator=self.gen, device=users.device) < self.keep_prob).float()
                 for _ in range(self.keep_draws)]
        return StepRows(users.long(), rows[:, 1].long(), neg,
                        torch.ones(users.shape[0], device=users.device), keeps)


class Adam:
    """torch.optim.Adam's update written out (betas, eps, no weight decay)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            out[k] = p - (self.lr / c1) * self.m[k] / denom
        return out

    def denominators(self) -> Dict[str, torch.Tensor]:
        """sqrt(v_hat) of each param after the last step (Adam's eps left out)."""
        c2 = 1 - self.b2 ** self.t
        return {k: v.sqrt() / math.sqrt(c2) for k, v in self.v.items()}
