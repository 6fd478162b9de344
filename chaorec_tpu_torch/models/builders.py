"""Builders wiring Config + RecDataset into model instances.

Counterpart of ``chaorec_tpu/models/builders.py``; each builder keeps the
constructor arguments of its JAX counterpart.
"""

from __future__ import annotations

from typing import Tuple

import torch

from chaorec_tpu_torch.config import Config
from chaorec_tpu_torch.data.loading import RecDataset, dense_interactions
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph, build_norm_adj
from chaorec_tpu_torch.models import register_model
from chaorec_tpu_torch.models.cf_diff import CF_Diff
from chaorec_tpu_torch.models.dccf import DCCF
from chaorec_tpu_torch.models.dgcf import DGCF
from chaorec_tpu_torch.models.freedom import FREEDOM
from chaorec_tpu_torch.models.mgat import MGAT
from chaorec_tpu_torch.models.ncl import NCL
from chaorec_tpu_torch.models.sgl import SGL


def _ui_graph(cfg: Config, ds: RecDataset, device: torch.device) -> BipartiteGraph:
    """The normalized user-item graph: dense while U * I is at most
    ``cfg.dense_prop_threshold``, R in ``cfg.graph_compute_dtype``."""
    return build_norm_adj(ds.train_edges, ds.num_user, ds.num_item, device,
                          dense_threshold=cfg.dense_prop_threshold,
                          compute_dtype=cfg.graph_compute_dtype)


def _feats(ds: RecDataset, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    if ds.v_feat is None or ds.t_feat is None:
        raise ValueError(f"dataset {ds.name} has no modality features; load with "
                         "has_v/has_t or enable synthetic_features")
    return (torch.from_numpy(ds.v_feat).to(device, torch.float32),
            torch.from_numpy(ds.t_feat).to(device, torch.float32))


@register_model("CF_Diff")
def _cf_diff(cfg: Config, ds: RecDataset, device: torch.device) -> CF_Diff:
    # The reference's grid also has ``dims``, which CAM_AE never reads.
    return CF_Diff(
        ds.num_user, ds.num_item,
        torch.from_numpy(dense_interactions(ds)).to(device),
        cfg.noise_scale, cfg.noise_min, cfg.noise_max, cfg.steps,
    )


@register_model("FREEDOM")
def _freedom(cfg: Config, ds: RecDataset, device: torch.device) -> FREEDOM:
    # main.py:287-289: FREEDOM(..., dim_E, feature_embedding, reg_weight,
    #   dropout, n_layers, mm_layers, ii_topk, *lambda_coeff*, device): the
    # reference passes lambda_coeff into the mm_image_weight slot.
    v, t = _feats(ds, device)
    return FREEDOM(
        ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t,
        cfg.dim_E, cfg.feature_embed, cfg.reg_weight, cfg.dropout,
        cfg.n_layers, cfg.mm_layers, cfg.ii_topk,
        mm_image_weight=cfg.lambda_coeff,
    )


@register_model("SGL")
def _sgl(cfg: Config, ds: RecDataset, device: torch.device) -> SGL:
    # main.py:302-303: SGL(..., dim_E, reg_weight, n_layers, aggr_mode, ssl_temp,
    #   ssl_alpha, device): ssl_alpha is the SSL loss weight
    return SGL(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device),
               cfg.dim_E, cfg.reg_weight, cfg.n_layers, cfg.ssl_temp, cfg.ssl_alpha)


@register_model("NCL")
def _ncl(cfg: Config, ds: RecDataset, device: torch.device) -> NCL:
    # main.py:305-306: NCL(..., dim_E, reg_weight, n_layers, aggr_mode, ssl_temp,
    #   ssl_alpha, device)
    return NCL(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device),
               cfg.dim_E, cfg.reg_weight, cfg.n_layers, cfg.ssl_temp, cfg.ssl_alpha)


@register_model("DCCF")
def _dccf(cfg: Config, ds: RecDataset, device: torch.device) -> DCCF:
    # main.py:325-326: DCCF(..., dim_E, reg_weight, n_layers, ssl_temp,
    #   ssl_alpha, n_intents, cen_reg, device)
    return DCCF(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), cfg.dim_E,
                cfg.reg_weight, cfg.n_layers, cfg.ssl_temp, cfg.ssl_alpha, cfg.n_intents,
                cfg.cen_reg)


@register_model("DGCF")
def _dgcf(cfg: Config, ds: RecDataset, device: torch.device) -> DGCF:
    # main.py:274-275: DGCF(..., dim_E, reg_weight, corDecay, n_factors,
    #   n_iterations, n_layers, aggr_mode, device)
    return DGCF(ds.num_user, ds.num_item, ds.train_edges, cfg.dim_E, cfg.reg_weight,
                cfg.corDecay, cfg.n_factors, cfg.n_iterations, cfg.n_layers, device)


@register_model("MGAT")
def _mgat(cfg: Config, ds: RecDataset, device: torch.device) -> MGAT:
    # main.py:292-293: MGAT(..., dim_E, reg_weight, device)
    v, t = _feats(ds, device)
    return MGAT(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
                cfg.reg_weight)
