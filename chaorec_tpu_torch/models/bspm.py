"""BSPM: the blurring-sharpening process model, which trains nothing.

Counterpart of ``chaorec_tpu/models/bspm.py`` (reference: Model/BSPM.py and
the single pass of train_and_evaluate.py:285-303, 532-552):

- the ideal low-pass filter of a 256-factor SVD of the (U+I)^2 normalized
  adjacency, in item space: ``D_i^-1/2 B B^T D_i^1/2`` with B the top-128
  invariant subspace of the Gram ``C = R^T R`` of the normalized R (the
  eigenvectors of ``[[0, R], [R^T, 0]]`` come in pairs, see the JAX
  module's docstring);
- blur: one product with C (Model/BSPM.py:144);
- sharpen: ``K_s`` Euler steps of ``dy/dt = -y C`` over ``[0, T_s]``
  from ``idl_beta * idl + blur`` (``ops/ode.odeint_euler``);
- ``TrainFreeTrainer``: score once, evaluate once, log the metric tables.

The spectral build is one-time work. Up to 20000 items B comes from the
host's ARPACK (``scipy.sparse.linalg.eigsh``, k = q, ``which="LA"``, tol
1e-7) on the fetched Gram, as in the JAX package. Its start vector is drawn
from the seed with numpy: ARPACK's own draw advances from one call to the
next in a process, so two builds on one seed would part in the last bits.
The subspace is the same whatever the start. Above 20000 items B is the
randomized SVD of R (``ops/svd.py``, oversample 128, 8 power iterations).
``_SPECTRAL_CACHE`` holds one dataset's (C, B), keyed by the device, the
shape, q and two moments of R, so the grid's combos build it once.
``CHAOREC_BSPM_DTYPE=float64`` runs the whole model in float64 (the JAX
package's control of the float32 numerics).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from chaorec_tpu_torch.models.base import Params, RecModel
from chaorec_tpu_torch.ops.ode import odeint_euler
from chaorec_tpu_torch.ops.svd import randomized_svd

EIGSH_MAX_ITEMS = 20000  # above this many items, the randomized SVD instead of eigsh
_SPECTRAL_CACHE: dict = {}


def compute_dtype() -> torch.dtype:
    """float64 under ``CHAOREC_BSPM_DTYPE=float64``, else float32."""
    return (torch.float64 if os.environ.get("CHAOREC_BSPM_DTYPE") == "float64"
            else torch.float32)


class BSPM(RecModel):
    name = "BSPM"
    rank_mode = "scores"
    factor_dim = 128  # = the reference's 256 factors of L (the pairing argument)

    def __init__(self, num_user: int, num_item: int, dense_r: torch.Tensor,
                 item_deg: torch.Tensor, k_s, t_s, k_b, t_b, idl_beta, seed: int):
        super().__init__(num_user, num_item)
        dt = compute_dtype()
        self.device = dense_r.device
        self.k_s = int(k_s)
        self.t_s = float(t_s)
        self.k_b = int(k_b)
        self.t_b = float(t_b)
        self.idl_beta = idl_beta
        self.r = dense_r.to(dt)  # the normalized R (U, I)
        q = min(self.factor_dim, min(num_user, num_item) - 1)
        # the device too: a CPU build and a card build of one dataset in one
        # process must not share tensors
        key = (str(self.device), num_user, num_item, q, float(torch.sum(self.r)),
               float(torch.sum(self.r * self.r)))
        self.build_seconds = 0.0  # the spectral build's; 0 when the cache had it
        if key in _SPECTRAL_CACHE:
            self.c, self.b = _SPECTRAL_CACHE[key]
        else:
            t0 = time.perf_counter()
            self.c = self.r.T @ self.r  # (I, I)
            if num_item <= EIGSH_MAX_ITEMS:
                from scipy.sparse.linalg import eigsh

                v0 = np.random.default_rng(seed).standard_normal(num_item)
                gram = self.c.cpu().numpy()
                _, evecs = eigsh(gram, k=q, which="LA", tol=1e-7, maxiter=10000,
                                 v0=v0.astype(gram.dtype))
                self.b = torch.from_numpy(evecs).to(self.device, dt)
            else:
                gen = torch.Generator(self.device).manual_seed(seed)
                self.b = randomized_svd(gen, self.r, q, oversample=128,
                                        power_iters=8)[2].to(dt)  # (I, q)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.build_seconds = time.perf_counter() - t0
            _SPECTRAL_CACHE.clear()  # at most one dataset's factors
            _SPECTRAL_CACHE[key] = (self.c, self.b)
        d = (item_deg.to(self.device) + 1e-7) ** -0.5
        self.d_inv_sqrt = d  # the diagonal of D_i^-1/2
        self.d_sqrt = 1.0 / d

    def init_params(self, generator: torch.Generator) -> Params:
        return {}

    def score_users(self, params: Params, user_ids: torch.Tensor) -> torch.Tensor:
        rows = self.r[user_ids]  # (C, I)
        idl = ((rows * self.d_inv_sqrt[None, :]) @ self.b) @ self.b.T
        idl = idl * self.d_sqrt[None, :]
        y0 = self.idl_beta * idl + rows @ self.c
        return odeint_euler(lambda t, y: -(y @ self.c), y0, 0.0, self.t_s, self.k_s)

    def embeddings(self, params: Params):
        raise NotImplementedError("BSPM ranks by score_users")


class TrainFreeTrainer:
    """One pass that trains nothing: score, evaluate once and log the
    Validation and Test tables (train_and_evaluate.py:532-552). It builds no
    optimizer (BSPM has no params) and keeps no weights, so the CLI exports
    nothing, as the JAX CLI does."""

    def __init__(self, model: RecModel, dataset, cfg):
        from chaorec_tpu_torch.train.loop import Trainer

        self._inner = Trainer(model, dataset, cfg)

    def run(self):
        from chaorec_tpu_torch.train.loop import log_metrics

        val_metrics, test_metrics, _ = self._inner.evaluate({})
        log_metrics("Validation Metrics:", val_metrics)
        log_metrics("Test Metrics:", test_metrics)
        return test_metrics


BSPM.trainer_cls = TrainFreeTrainer
