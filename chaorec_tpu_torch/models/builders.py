"""Builders wiring Config + RecDataset into model instances.

Counterpart of ``chaorec_tpu/models/builders.py``; each builder keeps the
constructor arguments of its JAX counterpart.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from chaorec_tpu_torch.config import Config
from chaorec_tpu_torch.data.loading import RecDataset, dense_interactions
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph, build_norm_adj
from chaorec_tpu_torch.models import register_model
from chaorec_tpu_torch.models.adagcl import AdaGCL
from chaorec_tpu_torch.models.bm3 import BM3
from chaorec_tpu_torch.models.bpr import BPRMF
from chaorec_tpu_torch.models.bspm import BSPM
from chaorec_tpu_torch.models.cf_diff import CF_Diff
from chaorec_tpu_torch.models.cohesion import COHESION
from chaorec_tpu_torch.models.dccf import DCCF
from chaorec_tpu_torch.models.ddrec import DDRec
from chaorec_tpu_torch.models.dgcf import DGCF
from chaorec_tpu_torch.models.dhcf import DHCF
from chaorec_tpu_torch.models.diffmm import DiffMM
from chaorec_tpu_torch.models.diffrec import DiffRec
from chaorec_tpu_torch.models.dragon import DRAGON
from chaorec_tpu_torch.models.dualgnn import DualGNN
from chaorec_tpu_torch.models.dualvae import DualVAE
from chaorec_tpu_torch.models.fkan_gcf import FKAN_GCF
from chaorec_tpu_torch.models.freedom import FREEDOM
from chaorec_tpu_torch.models.gformer import GFormer
from chaorec_tpu_torch.models.grade import Grade
from chaorec_tpu_torch.models.graphaug import GraphAug
from chaorec_tpu_torch.models.grcn import GRCN
from chaorec_tpu_torch.models.gume import GUME
from chaorec_tpu_torch.models.hccf import HCCF
from chaorec_tpu_torch.models.lattice import LATTICE
from chaorec_tpu_torch.models.layergcn import LayerGCN
from chaorec_tpu_torch.models.lgmrec import LGMRec
from chaorec_tpu_torch.models.lightgcl import LightGCL
from chaorec_tpu_torch.models.lightgcn import LightGCN
from chaorec_tpu_torch.models.lightgode import LightGODE
from chaorec_tpu_torch.models.lightgt import LightGT
from chaorec_tpu_torch.models.macridvae import MacridVAE
from chaorec_tpu_torch.models.mcln import MCLN
from chaorec_tpu_torch.models.mentor import MENTOR
from chaorec_tpu_torch.models.mgat import MGAT
from chaorec_tpu_torch.models.mgcl import MGCL
from chaorec_tpu_torch.models.mgcn import MGCN
from chaorec_tpu_torch.models.mhrec import MHRec, mhrec_hyperedges
from chaorec_tpu_torch.models.micro import MICRO
from chaorec_tpu_torch.models.mmgcl import MMGCL
from chaorec_tpu_torch.models.mmgcn import MMGCN
from chaorec_tpu_torch.models.mmssl import MMSSL
from chaorec_tpu_torch.models.multvae import MultVAE
from chaorec_tpu_torch.models.mvgae import MVGAE
from chaorec_tpu_torch.models.ncl import NCL
from chaorec_tpu_torch.models.ngcf import NGCF
from chaorec_tpu_torch.models.powerec import POWERec
from chaorec_tpu_torch.models.selfcf import SelfCF
from chaorec_tpu_torch.models.sgl import SGL
from chaorec_tpu_torch.models.simgcl import SimGCL
from chaorec_tpu_torch.models.slmrec import SLMRec
from chaorec_tpu_torch.models.smore import SMORE
from chaorec_tpu_torch.models.vbpr import VBPR
from chaorec_tpu_torch.models.vgcl import VGCL
from chaorec_tpu_torch.models.xsimgcl import XSimGCL
from chaorec_tpu_torch.ops.linear_prop import (CombinedLinearOp, build_weighted_op,
                                               fits_linear_op, lightgcn_weights)
from chaorec_tpu_torch.ops.svd import randomized_svd


def _ui_graph(cfg: Config, ds: RecDataset, device: torch.device,
              use_dense: Optional[bool] = None, bf16_dense_budget: int = 0) -> BipartiteGraph:
    """The normalized user-item graph in ``cfg.graph_compute_dtype``: dense
    while U * I is at most ``cfg.dense_prop_threshold`` (raised to
    ``bf16_dense_budget`` at bfloat16, where the dense R is half the bytes),
    unless ``use_dense`` says otherwise (False: the JAX builders'
    ``force_sparse``)."""
    thr = cfg.dense_prop_threshold
    if bf16_dense_budget and cfg.graph_compute_dtype == "bfloat16":
        thr = max(thr, bf16_dense_budget)
    return build_norm_adj(ds.train_edges, ds.num_user, ds.num_item, device,
                          use_dense=use_dense, dense_threshold=thr,
                          compute_dtype=cfg.graph_compute_dtype)


def _maybe_op(cfg: Config, ds: RecDataset, graph: BipartiteGraph,
              layer_weights: Sequence[float]) -> Optional[CombinedLinearOp]:
    """The combined linear operator, on R's device, when ``use_linear_op``
    (default on), the graph is dense and M's entries fit."""
    if cfg.get("use_linear_op", True) and graph.use_dense and fits_linear_op(
            ds.num_user, ds.num_item):
        return build_weighted_op(graph.dense_r, layer_weights,
                                 store_bf16=cfg.graph_compute_dtype == "bfloat16")
    return None


def _feats(ds: RecDataset, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    if ds.v_feat is None or ds.t_feat is None:
        raise ValueError(f"dataset {ds.name} has no modality features; load with "
                         "has_v/has_t or enable synthetic_features")
    return (torch.from_numpy(ds.v_feat).to(device, torch.float32),
            torch.from_numpy(ds.t_feat).to(device, torch.float32))


def _dense_x(ds: RecDataset, device: torch.device) -> torch.Tensor:
    """The dense (U, I) 0/1 interaction matrix on ``device``."""
    return torch.from_numpy(dense_interactions(ds)).to(device)


@register_model("CF_Diff")
def _cf_diff(cfg: Config, ds: RecDataset, device: torch.device) -> CF_Diff:
    # The reference's grid also has ``dims``, which CAM_AE never reads.
    return CF_Diff(ds.num_user, ds.num_item, _dense_x(ds, device),
                   cfg.noise_scale, cfg.noise_min, cfg.noise_max, cfg.steps)


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


@register_model("LATTICE")
def _lattice(cfg: Config, ds: RecDataset, device: torch.device) -> LATTICE:
    # main.py:276-279: LATTICE(..., dim_E, feature_embedding, reg_weight, n_layers, mm_layers,
    #   ii_topk, aggr_mode, lambda_coeff, device); the dense bf16 U-I graph up to 8e8 cells
    v, t = _feats(ds, device)
    return LATTICE(ds.num_user, ds.num_item,
                   _ui_graph(cfg, ds, device, bf16_dense_budget=int(8e8)), v, t,
                   cfg.dim_E, cfg.feature_embed, cfg.reg_weight, cfg.n_layers, cfg.mm_layers,
                   cfg.ii_topk, cfg.lambda_coeff, compute_dtype=cfg.graph_compute_dtype)


@register_model("MICRO")
def _micro(cfg: Config, ds: RecDataset, device: torch.device) -> MICRO:
    # main.py:294-296: MICRO(..., dim_E, n_layers, reg_weight, ii_topk, mm_layers, ssl_temp,
    #   lambda_coeff, ssl_alpha, aggr_mode, device); the U-I graph is sparse
    v, t = _feats(ds, device)
    return MICRO(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device, use_dense=False), v, t,
                 cfg.dim_E, cfg.n_layers, cfg.reg_weight, cfg.ii_topk, cfg.mm_layers,
                 cfg.ssl_temp, cfg.lambda_coeff, cfg.ssl_alpha,
                 compute_dtype=cfg.graph_compute_dtype)


@register_model("MMSSL")
def _mmssl(cfg: Config, ds: RecDataset, device: torch.device) -> MMSSL:
    # main.py:331-332: MMSSL(..., dim_E, reg_weight, ssl_alpha, ssl_temp, G_rate, mm_layers,
    #   device)
    v, t = _feats(ds, device)
    return MMSSL(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), _dense_x(ds, device),
                 v, t, cfg.dim_E, cfg.reg_weight, cfg.ssl_alpha, cfg.ssl_temp, cfg.G_rate,
                 cfg.mm_layers, batch_size=cfg.batch_size)


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


@register_model("BPR")
def _bpr(cfg: Config, ds: RecDataset, device: torch.device) -> BPRMF:
    # main.py:264: BPRMF(num_user, num_item, user_item_dict, dim_E, reg_weight, device)
    return BPRMF(ds.num_user, ds.num_item, cfg.dim_E, cfg.reg_weight, device)


@register_model("LightGCN")
def _lightgcn(cfg: Config, ds: RecDataset, device: torch.device) -> LightGCN:
    # main.py:269-270: LightGCN(..., dim_E, reg_weight, n_layers, aggr_mode, device)
    graph = _ui_graph(cfg, ds, device)
    op = _maybe_op(cfg, ds, graph, lightgcn_weights(cfg.n_layers))
    return LightGCN(ds.num_user, ds.num_item, graph, cfg.dim_E, cfg.reg_weight, cfg.n_layers,
                    linear_op=op)


@register_model("NGCF")
def _ngcf(cfg: Config, ds: RecDataset, device: torch.device) -> NGCF:
    # main.py:267-268: NGCF(..., dim_E, reg_weight, dropout, n_layers, aggr_mode, device)
    return NGCF(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), cfg.dim_E,
                cfg.reg_weight, cfg.dropout, cfg.n_layers)


@register_model("SimGCL")
def _simgcl(cfg: Config, ds: RecDataset, device: torch.device) -> SimGCL:
    # main.py:335-336: SimGCL(..., dim_E, reg_weight, n_layers, ssl_temp, ssl_alpha, device)
    graph = _ui_graph(cfg, ds, device)
    n = cfg.n_layers
    op = _maybe_op(cfg, ds, graph, [0.0] + [1.0 / n] * n)
    return SimGCL(ds.num_user, ds.num_item, graph, cfg.dim_E, cfg.reg_weight, n,
                  cfg.ssl_temp, cfg.ssl_alpha, linear_op=op)


@register_model("XSimGCL")
def _xsimgcl(cfg: Config, ds: RecDataset, device: torch.device) -> XSimGCL:
    # main.py:337-338: XSimGCL(..., dim_E, reg_weight, n_layers, ssl_temp, ssl_alpha, device)
    graph = _ui_graph(cfg, ds, device)
    n = cfg.n_layers
    op = _maybe_op(cfg, ds, graph, [0.0] + [1.0 / n] * n)
    return XSimGCL(ds.num_user, ds.num_item, graph, cfg.dim_E, cfg.reg_weight, n,
                   cfg.ssl_temp, cfg.ssl_alpha, linear_op=op)


@register_model("LayerGCN")
def _layergcn(cfg: Config, ds: RecDataset, device: torch.device) -> LayerGCN:
    # main.py:323-324: LayerGCN(..., dim_E, reg_weight, n_layers, dropout, device); the
    # graph is dense whatever its size, as the JAX package's ``_layergcn`` makes it
    graph = build_norm_adj(ds.train_edges, ds.num_user, ds.num_item, device, use_dense=True,
                           compute_dtype=cfg.graph_compute_dtype)
    return LayerGCN(ds.num_user, ds.num_item, graph, cfg.dim_E, cfg.reg_weight,
                    cfg.n_layers, cfg.dropout)


@register_model("MultVAE")
def _multvae(cfg: Config, ds: RecDataset, device: torch.device) -> MultVAE:
    # main.py:304: MultVAE(num_user, num_item, train_data, dict, dim_E, reg_weight, device)
    return MultVAE(ds.num_user, ds.num_item, _dense_x(ds, device), cfg.dim_E, cfg.reg_weight)


@register_model("MacridVAE")
def _macridvae(cfg: Config, ds: RecDataset, device: torch.device) -> MacridVAE:
    # main.py:307-308: MacridVAE(num_user, num_item, train_data, dict, dim_E, reg_weight,
    #   device)
    return MacridVAE(ds.num_user, ds.num_item, _dense_x(ds, device), cfg.dim_E,
                     cfg.reg_weight)


@register_model("DualVAE")
def _dualvae(cfg: Config, ds: RecDataset, device: torch.device) -> DualVAE:
    # main.py:329-330: DualVAE(..., dim_E, reg_weight (the KL weight), ssl_alpha (the
    #   contrastive weight), device)
    return DualVAE(ds.num_user, ds.num_item, _dense_x(ds, device), cfg.reg_weight,
                   cfg.ssl_alpha)


@register_model("DiffRec")
def _diffrec(cfg: Config, ds: RecDataset, device: torch.device) -> DiffRec:
    # main.py:370-371: DiffRec(num_user, num_item, dict, noise_scale, noise_min,
    #   noise_max, steps, dims, learning_rate, device)
    return DiffRec(ds.num_user, ds.num_item, _dense_x(ds, device), cfg.noise_scale,
                   cfg.noise_min, cfg.noise_max, cfg.steps, cfg.dims,
                   sample_compute_dtype=cfg.graph_compute_dtype)


@register_model("DHCF")
def _dhcf(cfg: Config, ds: RecDataset, device: torch.device) -> DHCF:
    # main.py:358-359: DHCF(..., dim_E, reg_weight, n_layers, dropout, device); the
    # frozen DJconv weights are drawn from seed + 7, as the JAX package's _dhcf draws
    # them from PRNGKey(seed + 7)
    return DHCF(ds.num_user, ds.num_item, _dense_x(ds, device), cfg.dim_E, cfg.reg_weight,
                cfg.n_layers, cfg.dropout, cfg.seed)


@register_model("LightGODE")
def _lightgode(cfg: Config, ds: RecDataset, device: torch.device) -> LightGODE:
    # main.py:356-357: LightGODE(..., dim_E, gamma, t, device)
    return LightGODE(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), cfg.dim_E,
                     cfg.gamma, cfg.t)


@register_model("SelfCF")
def _selfcf(cfg: Config, ds: RecDataset, device: torch.device) -> SelfCF:
    # main.py:344-345: SelfCF(..., dim_E, reg_weight, n_layers, dropout, device)
    return SelfCF(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), cfg.dim_E,
                  cfg.reg_weight, cfg.n_layers, cfg.dropout)


@register_model("FKAN_GCF")
def _fkan_gcf(cfg: Config, ds: RecDataset, device: torch.device) -> FKAN_GCF:
    # main.py:351-353: FKAN_GCF(..., dim_E, reg_weight, n_layers, node_dropout,
    #   message_dropout, grid_size, device)
    return FKAN_GCF(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), cfg.dim_E,
                    cfg.reg_weight, cfg.n_layers, cfg.node_dropout, cfg.message_dropout,
                    cfg.grid_size)


@register_model("MCLN")
def _mcln(cfg: Config, ds: RecDataset, device: torch.device) -> MCLN:
    # main.py:354-355: MCLN(..., dim_E, reg_weight, n_layers, n_mca, device)
    v, t = _feats(ds, device)
    return MCLN(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
                cfg.reg_weight, cfg.n_layers, cfg.n_mca)


@register_model("BSPM")
def _bspm(cfg: Config, ds: RecDataset, device: torch.device) -> BSPM:
    # main.py:368-369: BSPM(..., K_s, T_s, K_b, K_s(!), idl_beta, device): the
    # reference passes K_s into the T_b slot. The spectral build's random
    # draws come from seed + 11, as the JAX builder's PRNGKey(seed + 11).
    graph = build_norm_adj(ds.train_edges, ds.num_user, ds.num_item, device, use_dense=True,
                           eps=1e-7)
    di = np.bincount(np.asarray(ds.train_edges)[:, 1], minlength=ds.num_item)
    return BSPM(ds.num_user, ds.num_item, graph.dense_r,
                torch.from_numpy(di.astype(np.float32)), cfg.K_s, cfg.T_s, cfg.K_b, cfg.K_s,
                cfg.idl_beta, cfg.seed + 11)


@register_model("GFormer")
def _gformer(cfg: Config, ds: RecDataset, device: torch.device) -> GFormer:
    # main.py:363-364: GFormer(num_user, num_item, train_data, dict, dim_E,
    #   reg_weight, n_layers, pnn_layer, *ssl_alpha* (-> the ssl_reg slot), b2,
    #   ctra, device)
    return GFormer(ds.num_user, ds.num_item, ds.train_edges, cfg.dim_E, cfg.reg_weight,
                   cfg.n_layers, cfg.pnn_layer, cfg.ssl_alpha, cfg.b2, cfg.ctra,
                   seed=cfg.seed, device=device)


@register_model("HCCF")
def _hccf(cfg: Config, ds: RecDataset, device: torch.device) -> HCCF:
    # main.py:311-313: HCCF(..., dim_E, reg_weight, n_layers, aggr_mode,
    #   ssl_alpha, ssl_temp, keepRate, leaky, mult, device)
    return HCCF(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), cfg.dim_E,
                cfg.reg_weight, cfg.n_layers, cfg.ssl_alpha, cfg.ssl_temp, cfg.keepRate,
                cfg.leaky, cfg.mult)


@register_model("LightGCL")
def _lightgcl(cfg: Config, ds: RecDataset, device: torch.device) -> LightGCL:
    # main.py:309-310: LightGCL(..., dim_E, reg_weight, n_layers, aggr_mode, ssl_alpha,
    #   ssl_temp, device). The SVD is of R as stored, in graph_compute_dtype (bf16
    #   by default), cast to float32 after that rounding, as the JAX builder takes it.
    graph = build_norm_adj(ds.train_edges, ds.num_user, ds.num_item, device, use_dense=True,
                           compute_dtype=cfg.graph_compute_dtype, eps=0.0)
    u, s, v = randomized_svd(torch.Generator(device).manual_seed(cfg.seed),
                             graph.dense_r.to(torch.float32), LightGCL.q)
    return LightGCL(ds.num_user, ds.num_item, graph, cfg.dim_E, cfg.reg_weight, cfg.n_layers,
                    cfg.ssl_alpha, cfg.ssl_temp, svd_u_s=u * s[None, :],
                    svd_v_s=v * s[None, :], svd_ut=u.T.contiguous(), svd_vt=v.T.contiguous())


@register_model("VGCL")
def _vgcl(cfg: Config, ds: RecDataset, device: torch.device) -> VGCL:
    # main.py:333-334: VGCL(..., dim_E, reg_weight, n_layers, ssl_temp, ssl_alpha, device)
    return VGCL(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), cfg.dim_E,
                cfg.reg_weight, cfg.n_layers, cfg.ssl_temp, cfg.ssl_alpha)


@register_model("GraphAug")
def _graphaug(cfg: Config, ds: RecDataset, device: torch.device) -> GraphAug:
    # main.py:339-341: GraphAug(..., dim_E, reg_weight, n_layers, ssl_temp, ssl_alpha,
    #   device): ssl_alpha is the contrast's weight
    return GraphAug(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), cfg.dim_E,
                    cfg.reg_weight, cfg.n_layers, cfg.ssl_temp, cfg.ssl_alpha)


@register_model("AdaGCL")
def _adagcl(cfg: Config, ds: RecDataset, device: torch.device) -> AdaGCL:
    # main.py:327-328: AdaGCL(..., dim_E, reg_weight, n_layers, ssl_temp, ssl_alpha, device);
    # the frozen embedding copy is drawn from seed + 41, as the JAX builder's
    # PRNGKey(seed + 41)
    return AdaGCL(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), cfg.dim_E,
                  cfg.reg_weight, cfg.n_layers, cfg.ssl_temp, cfg.ssl_alpha, cfg.seed)


@register_model("Grade")
def _grade(cfg: Config, ds: RecDataset, device: torch.device) -> Grade:
    # main.py:365-367: Grade(..., dim_E, reg_weight, n_layers, ssl_temp, ssl_alpha,
    #   ssl_temp2, noise_alpha, device)
    v, t = _feats(ds, device)
    return Grade(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
                 cfg.reg_weight, cfg.n_layers, cfg.ssl_temp, cfg.ssl_alpha, cfg.ssl_temp2,
                 cfg.noise_alpha)


@register_model("VBPR")
def _vbpr(cfg: Config, ds: RecDataset, device: torch.device) -> VBPR:
    # main.py:265-266: VBPR(num_user, num_item, dict, v_feat, dim_E, feature_embedding,
    #   reg_weight, device)
    v, _ = _feats(ds, device)
    return VBPR(ds.num_user, ds.num_item, v, cfg.dim_E, cfg.feature_embed, cfg.reg_weight)


@register_model("BM3")
def _bm3(cfg: Config, ds: RecDataset, device: torch.device) -> BM3:
    # main.py:282-283: BM3(..., dim_E, feature_embedding, reg_weight, dropout, n_layers,
    #   cl_weight, aggr_mode, device)
    v, t = _feats(ds, device)
    return BM3(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
               cfg.feature_embed, cfg.reg_weight, cfg.dropout, cfg.n_layers, cfg.cl_weight)


@register_model("SLMRec")
def _slmrec(cfg: Config, ds: RecDataset, device: torch.device) -> SLMRec:
    # main.py:290-291: SLMRec(..., dim_E, n_layers, ssl_temp, ssl_alpha, device)
    v, t = _feats(ds, device)
    return SLMRec(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
                  cfg.n_layers, cfg.ssl_temp, cfg.ssl_alpha)


@register_model("MGCL")
def _mgcl(cfg: Config, ds: RecDataset, device: torch.device) -> MGCL:
    # main.py:314-315: MGCL(..., dim_E, reg_weight, n_layers, aggr_mode, ssl_temp,
    #   ssl_alpha, device)
    v, t = _feats(ds, device)
    return MGCL(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
                cfg.reg_weight, cfg.n_layers, cfg.ssl_temp, cfg.ssl_alpha)


@register_model("MMGCL")
def _mmgcl(cfg: Config, ds: RecDataset, device: torch.device) -> MMGCL:
    # main.py:297-298: MMGCL(..., dim_E, reg_weight, n_layers, ssl_alpha, ssl_temp,
    #   dropout, device)
    v, t = _feats(ds, device)
    return MMGCL(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
                 cfg.reg_weight, cfg.n_layers, cfg.ssl_alpha, cfg.ssl_temp, cfg.dropout)


@register_model("LGMRec")
def _lgmrec(cfg: Config, ds: RecDataset, device: torch.device) -> LGMRec:
    # main.py:342-343: LGMRec(..., dim_E, reg_weight, n_layers, ssl_alpha, device)
    v, t = _feats(ds, device)
    return LGMRec(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
                  cfg.reg_weight, cfg.n_layers, cfg.ssl_alpha)


@register_model("MMGCN")
def _mmgcn(cfg: Config, ds: RecDataset, device: torch.device) -> MMGCN:
    # main.py:261-263: MMGCN(..., dim_E, reg_weight, aggr_mode, 'False', True, device);
    # the frozen tensors are drawn from seed + 21, as the JAX builder's
    # PRNGKey(seed + 21)
    v, t = _feats(ds, device)
    return MMGCN(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
                 cfg.reg_weight, cfg.seed)


@register_model("MVGAE")
def _mvgae(cfg: Config, ds: RecDataset, device: torch.device) -> MVGAE:
    # main.py:321-322: MVGAE(..., dim_E, reg_weight, n_layers, device); the frozen
    # tensors are drawn from seed + 31, as the JAX builder's PRNGKey(seed + 31)
    v, t = _feats(ds, device)
    return MVGAE(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
                 cfg.reg_weight, cfg.n_layers, cfg.seed)


@register_model("POWERec")
def _powerec(cfg: Config, ds: RecDataset, device: torch.device) -> POWERec:
    # main.py:318-320: POWERec(..., dim_E, reg_weight, n_layers, prompt_num, neg_weight,
    #   dropout, device)
    v, t = _feats(ds, device)
    return POWERec(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
                   cfg.reg_weight, cfg.n_layers, cfg.prompt_num, cfg.neg_weight, cfg.dropout)


@register_model("MENTOR")
def _mentor(cfg: Config, ds: RecDataset, device: torch.device) -> MENTOR:
    # main.py:346-348: MENTOR(..., dim_E, mm_layers, reg_weight, ssl_temp, dropout,
    #   align_weight, mask_weight_g, mask_weight_f, device)
    v, t = _feats(ds, device)
    return MENTOR(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
                  cfg.mm_layers, cfg.reg_weight, cfg.ssl_temp, cfg.dropout, cfg.align_weight,
                  cfg.mask_weight_g, cfg.mask_weight_f)


@register_model("DDRec")
def _ddrec(cfg: Config, ds: RecDataset, device: torch.device) -> DDRec:
    # main.py:299-301: DDRec(..., dim_E, feature_embedding, reg_weight, n_layers, ssl_temp,
    #   ssl_alpha, threshold, aggr_mode, device)
    v, t = _feats(ds, device)
    return DDRec(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), v, t, cfg.dim_E,
                 cfg.feature_embed, cfg.reg_weight, cfg.n_layers, cfg.ssl_temp, cfg.ssl_alpha,
                 cfg.threshold)


@register_model("MGCN")
def _mgcn(cfg: Config, ds: RecDataset, device: torch.device) -> MGCN:
    # main.py:316-317: MGCN(..., dim_E, reg_weight, n_layers, aggr_mode, ssl_temp, ssl_alpha,
    #   device): n_layers and n_ui_layers are fixed inside; the U-I graph is sparse
    v, t = _feats(ds, device)
    return MGCN(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device, use_dense=False), v, t,
                cfg.dim_E, cfg.reg_weight, cfg.ssl_temp, cfg.ssl_alpha)


@register_model("SMORE")
def _smore(cfg: Config, ds: RecDataset, device: torch.device) -> SMORE:
    # main.py:377-378: SMORE(..., dim_E, reg_weight, n_ui_layers, ii_topk, dropout, dataset,
    #   device); the U-I graph is sparse
    v, t = _feats(ds, device)
    return SMORE(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device, use_dense=False), v, t,
                 cfg.dim_E, cfg.reg_weight, cfg.n_ui_layers, cfg.ii_topk, cfg.dropout)


@register_model("GUME")
def _gume(cfg: Config, ds: RecDataset, device: torch.device) -> GUME:
    # main.py:379-380: GUME(..., dim_E, n_layers, n_ui_layers, um_loss, vt_loss, dataset,
    #   device)
    v, t = _feats(ds, device)
    return GUME(ds.num_user, ds.num_item, ds.train_edges, v, t, cfg.dim_E, cfg.n_layers,
                cfg.n_ui_layers, cfg.um_loss, cfg.vt_loss,
                compute_dtype=cfg.graph_compute_dtype, device=device)


@register_model("GRCN")
def _grcn(cfg: Config, ds: RecDataset, device: torch.device) -> GRCN:
    # main.py:271-273: GRCN(..., dim_E, feature_embedding, reg_weight, dropout, n_iterations,
    #   aggr_mode, device): the routing n_iterations changes nothing (models/grcn.py); GRCN
    #   reads the edge list only, so its graph has no dense R
    v, t = _feats(ds, device)
    return GRCN(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device, use_dense=False), v, t,
                cfg.dim_E, cfg.feature_embed, cfg.reg_weight, cfg.dropout)


@register_model("DualGNN")
def _dualgnn(cfg: Config, ds: RecDataset, device: torch.device) -> DualGNN:
    # main.py:280-281: DualGNN(..., dim_E, feature_embedding, reg_weight, uu_topk, aggr_mode,
    #   device)
    v, t = _feats(ds, device)
    return DualGNN(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), ds.train_edges, v, t,
                   cfg.dim_E, cfg.feature_embed, cfg.reg_weight, cfg.uu_topk)


@register_model("DRAGON")
def _dragon(cfg: Config, ds: RecDataset, device: torch.device) -> DRAGON:
    # main.py:284-286: DRAGON(..., dim_E, feature_embedding, reg_weight, n_layers, ii_topk,
    #   uu_topk, lambda_coeff (-> mm_image_weight), aggr_mode, device)
    v, t = _feats(ds, device)
    return DRAGON(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), ds.train_edges, v, t,
                  cfg.dim_E, cfg.feature_embed, cfg.reg_weight, cfg.n_layers, cfg.ii_topk,
                  cfg.uu_topk, mm_image_weight=cfg.lambda_coeff)


@register_model("COHESION")
def _cohesion(cfg: Config, ds: RecDataset, device: torch.device) -> COHESION:
    # main.py:381-383: COHESION(..., dim_E, reg_weight, dropout, n_layers, mm_layers, ii_topk,
    #   mm_image_weight, device)
    v, t = _feats(ds, device)
    return COHESION(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), ds.train_edges, v, t,
                    cfg.dim_E, cfg.reg_weight, cfg.dropout, cfg.n_layers, cfg.mm_layers,
                    cfg.ii_topk, cfg.mm_image_weight)


@register_model("LightGT")
def _lightgt(cfg: Config, ds: RecDataset, device: torch.device) -> LightGT:
    # main.py:349-350: LightGT(num_user, num_item, train_data, dict, v_feat, t_feat, dim_E,
    #   reg_weight, n_layers, device)
    v, t = _feats(ds, device)
    return LightGT(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device),
                   torch.from_numpy(ds.history.values).to(device), v, t, cfg.dim_E,
                   cfg.reg_weight, cfg.n_layers, seed=cfg.seed)


@register_model("DiffMM")
def _diffmm(cfg: Config, ds: RecDataset, device: torch.device) -> DiffMM:
    # main.py:360-362: DiffMM(num_user, num_item, train_data, dict, v_feat, t_feat, dim_E,
    #   reg_weight, n_layers, ssl_alpha, ssl_temp, ris_lambda, e_loss, rebuild_k, device)
    v, t = _feats(ds, device)
    return DiffMM(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), _dense_x(ds, device),
                  v, t, cfg.dim_E, cfg.reg_weight, cfg.n_layers, cfg.ssl_alpha, cfg.ssl_temp,
                  cfg.ris_lambda, cfg.e_loss, cfg.rebuild_k,
                  sample_compute_dtype=cfg.graph_compute_dtype)


@register_model("MHRec")
def _mhrec(cfg: Config, ds: RecDataset, device: torch.device) -> MHRec:
    # main.py:374-376: MHRec(num_user, num_item, train_data, dict, v_feat, t_feat, dim_E,
    #   reg_weight, ii_topk, uu_topk, num_hypernodes, n_layers, h_layers, ssl_temp, ssl_alpha,
    #   beta1, beta2, device)
    v, t = _feats(ds, device)
    hv, ht = mhrec_hyperedges(cfg, ds, v, t, device)
    return MHRec(ds.num_user, ds.num_item, _ui_graph(cfg, ds, device), torch.from_numpy(hv),
                 torch.from_numpy(ht), v, t, cfg.dim_E, cfg.reg_weight, cfg.ii_topk, cfg.uu_topk,
                 cfg.num_hypernodes, cfg.n_layers, cfg.h_layers, cfg.ssl_temp, cfg.ssl_alpha,
                 cfg.beta1, cfg.beta2, sample_compute_dtype=cfg.graph_compute_dtype)
