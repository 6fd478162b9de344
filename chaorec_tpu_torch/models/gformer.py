"""GFormer: a masked graph-transformer autoencoder, and its trainer.

Counterpart of ``chaorec_tpu/models/gformer.py`` (reference:
Model/GFormer.py, its loop at train_and_evaluate.py:245-258):

- the anchor-set positional encoding: 32 random anchors (numpy
  ``default_rng(seed).choice``), their BFS distances over the interaction
  graph (scipy's ``dijkstra(unweighted=True)``), kernel 1/(d+1), 0 when
  unreachable (Model/GFormer.py:493-526). Host numpy, so both packages hold
  the same values;
- the PNN layer (Model/GFormer.py:152-181) with the reference's reshape
  quirk: the (i, a) "self feature" is ``x[(i A + a) % N]`` (``scramble``).
  The layer is a linear map of an (N, A, 2E) concatenation, then a mean
  over A; the mean commutes with the map, so the port maps the means, an
  (N, 2E) table, and never holds the (N, A, 2E) one;
- the edge-level graph transformer (GTLayer, Model/GFormer.py:184-231): 4
  heads, per-edge q.k clipped to [-10, 10], exp times the edge's ``valid``,
  normalized by its destination row's sum + 1e-8;
- the sampled graphs (``candidate_edges``, ``mask_subgraphs``; every 10
  steps, train_and_evaluate.py:245-252): the PNN embedding's attention
  over the graph, 1% random edges and self loops drives an encoder graph
  (90% of the edges by inverse attention, + self loops, sym-normalized), a
  decoder graph (the dropped edges, resamples, self loops, deduped) and two
  10% graphs (by attention + 0.001 and by inverse attention);
- the train forward (Model/GFormer.py:531-574) and the eval forward on the
  plain normalized graph with no PNN and no decoder (Model/GFormer.py:
  645-650);
- the loss (Model/GFormer.py:612-643): BPR without a sigmoid; an auxiliary
  BPR on the sub stream whose negatives come from the MAIN stream, over a
  hard-coded 1024; the reg over 5 of the 7 embeddings the reference passes;
  the contrast: the mean over the batch's unique users (and positive items)
  of the logsumexp of their row against their own table (q and k are rows
  of one table, so dq and dk both reach it), the users against the item
  table, and ctra times a plain logsumexp over the last axis of the sub and
  cmp streams' product.

The three full-catalog terms go through ``ops/losses.catalog_logsumexp``:
the streaming logsumexp kernels on the card (forward, dq and dk, three of
each a step). Every segment sum is taken in a fixed order
(``ops/ell.SegmentBags``), and so is the gradient of every gather of a
node table at the edges' ends (``ops/ell.bag_gather``): the bags of the
sampled graphs, by destination and by source, are built on the host,
where the sampler makes the edges, once per resample, and serve its 10
steps. The JAX package pads each graph to a fixed capacity so that
``jit`` compiles once; the port holds each at its own length, and takes
the JAX package's padded graphs as well (a padded edge weighs 0 or is not
``valid``, so the sums are the same).

``GFormerTrainer`` trains with Adam after ``clip_by_global_norm`` at 20
(train_and_evaluate.py:256), resampling on the host every ``fix_steps``
batches from a numpy generator seeded ``seed + 7``; the negatives, the
per-epoch evaluation, early stopping and the log lines are the standard
trainer's. Like the JAX one it keeps no weights of its own, so the CLI
exports nothing for GFormer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.ell import SegmentBags, bag_gather, bag_sum, segment_bags
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import catalog_logsumexp, masked_mean


@dataclass(frozen=True)
class EdgeList:
    """One graph's directed edges on the device: each edge's destination
    ``rows``, source ``cols``, weight ``w`` (None: unweighted) and 0/1
    ``valid`` (None: every edge), and the fixed-order sums over ``rows``
    (``bags``) and, for a graph that is differentiated, over ``cols``
    (``col_bags``: the gradient of a gather of the sources)."""

    rows: torch.Tensor
    cols: torch.Tensor
    w: Optional[torch.Tensor]
    valid: Optional[torch.Tensor]
    bags: SegmentBags
    col_bags: Optional[SegmentBags] = None

    @staticmethod
    def build(rows: np.ndarray, cols: np.ndarray, n: int, device: torch.device | str,
              w: Optional[np.ndarray] = None, valid: Optional[np.ndarray] = None,
              trained: bool = True) -> "EdgeList":
        def t(a, dtype):
            return None if a is None else torch.from_numpy(np.array(a)).to(device, dtype)

        rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
        entries = np.arange(rows.shape[0])
        return EdgeList(t(rows, torch.int64), t(cols, torch.int64), t(w, torch.float32),
                        t(valid, torch.float32), segment_bags(rows, entries, n, device),
                        segment_bags(cols, entries, n, device) if trained else None)


class GFGraphs(NamedTuple):
    """One group's sampled graphs: encoder (weighted), decoder (valid),
    sub and cmp (both)."""

    enc: EdgeList
    dec: EdgeList
    sub: EdgeList
    cmp: EdgeList


GRAPH_FIELDS = {"enc": ("enc_rows", "enc_cols", "enc_w", None),
                "dec": ("dec_rows", "dec_cols", None, "dec_valid"),
                "sub": ("sub_rows", "sub_cols", "sub_w", "sub_valid"),
                "cmp": ("cmp_rows", "cmp_cols", "cmp_w", "cmp_valid")}


def graphs_from_arrays(arrays: Dict[str, np.ndarray], n: int,
                       device: torch.device | str) -> GFGraphs:
    """``GFGraphs`` on ``device`` from numpy arrays named as the JAX
    package's ``GFGraphs`` fields (``enc_rows``, ..., ``cmp_valid``), at
    their own lengths or padded."""
    def one(r, c, w, v):
        return EdgeList.build(arrays[r], arrays[c], n, device,
                              None if w is None else arrays[w], None if v is None else arrays[v])

    return GFGraphs(**{name: one(*fields) for name, fields in GRAPH_FIELDS.items()})


# ----------------------------------------------------------------------
# The host sampler: numpy on both sides of the device's attention


def gumbel_topk_choice(rng: np.random.Generator, n: int, k: int, p: np.ndarray) -> np.ndarray:
    """Weighted sampling without replacement by the Gumbel top-k trick (the
    distribution of ``choice(replace=False, p=p)``)."""
    logp = np.log(np.maximum(p, 1e-30))
    gumbel = -np.log(-np.log(rng.random(n) + 1e-30) + 1e-30)
    return np.argpartition(-(logp + gumbel), k - 1)[:k] if k < n else np.arange(n)


def sym_norm(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Each edge's rowsum^-1/2 at both ends (0 at an empty row), float32."""
    rowsum = np.bincount(rows, minlength=n).astype(np.float64)
    d = np.where(rowsum > 0, rowsum, 1.0) ** -0.5
    d = np.where(rowsum > 0, d, 0.0)
    return (d[rows] * d[cols]).astype(np.float32)


def sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` of a 1-D integer array, by a sort: numpy's own
    takes a hash-based route for integers in its newer releases, several
    times slower at a resample's million keys."""
    s = np.sort(a)
    keep = np.empty(s.shape[0], bool)
    keep[:1] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def candidate_edges(rng: np.random.Generator, base_rows: np.ndarray, base_cols: np.ndarray,
                    n: int, n_add: int):
    """(rows, cols) int32, deduped and sorted: the graph's edges, ``n_add``
    random ones each way (rows and columns drawn independently from the
    edges' ends, the reference's quirk) and self loops (Model/GFormer.py:
    116-131)."""
    add_r = rng.choice(base_rows, size=n_add)
    add_c = rng.choice(base_cols, size=n_add)
    loops = np.arange(n, dtype=np.int32)
    new_r = np.concatenate([add_r, add_c, loops, base_rows]).astype(np.int64)
    new_c = np.concatenate([add_c, add_r, loops, base_cols]).astype(np.int64)
    uniq = sorted_unique(new_r * n + new_c)
    return (uniq // n).astype(np.int32), (uniq % n).astype(np.int32)


def mask_subgraphs(att: np.ndarray, er: np.ndarray, ec: np.ndarray, n: int,
                   rng: np.random.Generator, keep_rate: float = 0.9, re_rate: float = 0.8,
                   ext_rate: float = 0.5, sub_rate: float = 0.1) -> Dict[str, np.ndarray]:
    """RandomMaskSubgraphs (Model/GFormer.py:234-394) on the candidate
    edges (er, ec) given their attention ``att`` (summed over heads): the
    encoder, decoder, sub and cmp graphs as numpy arrays named as the JAX
    package's ``GFGraphs`` fields, each at its own length. The rates are the
    reference's (keepRate, reRate, ext, sub; Model/GFormer.py:404-412)."""
    e_adj = len(er)
    att = np.minimum(np.asarray(att, np.float64), 3.0)  # att_f[att_f > 3] = 3
    inv = 1.0 / np.exp(att + 1e-8)
    p_inv = inv / inv.sum()
    loops = np.arange(n, dtype=np.int32)

    # encoder: 90% of the edges by inverse attention, + self loops
    keep_idx = np.sort(gumbel_topk_choice(rng, e_adj, int(e_adj * keep_rate), p_inv))
    enc_r = np.concatenate([loops, er[keep_idx]])
    enc_c = np.concatenate([loops, ec[keep_idx]])

    # decoder: the dropped edges, ext/reRate resamples and self loops, deduped
    drop = np.ones(e_adj, bool)
    drop[keep_idx] = False
    drop_r, drop_c = er[drop], ec[drop]
    ext_r = rng.choice(enc_r, size=int(len(drop_r) * ext_rate))
    ext_c = rng.choice(enc_c, size=int(len(drop_c) * ext_rate))
    tmp_r = np.concatenate([ext_r, drop_r])
    tmp_c = np.concatenate([ext_c, drop_c])
    n_re = int(e_adj * re_rate)
    res_r = rng.choice(tmp_r, size=n_re) if len(tmp_r) else tmp_r
    res_c = rng.choice(tmp_c, size=n_re) if len(tmp_c) else tmp_c
    d_r = np.concatenate([res_r, res_c, np.arange(n), enc_r]).astype(np.int64)
    d_c = np.concatenate([res_c, res_r, np.arange(n), enc_c]).astype(np.int64)
    uniq_d = sorted_unique(d_r * n + d_c)
    dr = (uniq_d // n).astype(np.int32)

    # sub and cmp: 10% samples (Model/GFormer.py:254-310)
    sub_n = int(e_adj * sub_rate)
    p_sub = att + 0.001
    p_sub = p_sub / p_sub.sum()
    si = np.sort(gumbel_topk_choice(rng, e_adj, sub_n, p_sub))
    ci = np.sort(gumbel_topk_choice(rng, e_adj, sub_n, p_inv))
    out = {"enc_rows": enc_r, "enc_cols": enc_c, "enc_w": sym_norm(enc_r, enc_c, n),
           "dec_rows": dr, "dec_cols": (uniq_d % n).astype(np.int32),
           "dec_valid": np.ones(len(dr), np.float32)}
    for name, idx in (("sub", si), ("cmp", ci)):
        rr = np.concatenate([loops, er[idx]])
        cc = np.concatenate([loops, ec[idx]])
        out.update({f"{name}_rows": rr, f"{name}_cols": cc, f"{name}_w": sym_norm(rr, cc, n),
                    f"{name}_valid": np.ones(len(rr), np.float32)})
    return out


# ----------------------------------------------------------------------


class GFormer(RecModel):
    name = "GFormer"
    gtw = 0.1  # Model/GFormer.py:410
    anchor_set_num = 32
    head = 4
    add_rate = 0.01  # the sampler's other rates are mask_subgraphs' defaults
    fix_steps = 10  # train_and_evaluate.py:246

    def __init__(self, num_user: int, num_item: int, train_edges: np.ndarray, dim_E: int,
                 reg_weight: float, n_layers: int, pnn_layer: int, ssl_reg: float, b2: float,
                 ctra: float, seed: int = 0, device: torch.device | str = "cpu"):
        super().__init__(num_user, num_item)
        import scipy.sparse as sp
        from scipy.sparse.csgraph import dijkstra

        self.device = torch.device(device)
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.pnn_layer = pnn_layer
        self.ssl_reg = ssl_reg
        self.b2 = b2
        self.ctra = ctra
        n = num_user + num_item
        self.num_nodes = n

        edges = np.asarray(train_edges)
        rows = np.concatenate([edges[:, 0], edges[:, 1] + num_user])
        cols = np.concatenate([edges[:, 1] + num_user, edges[:, 0]])
        d = (np.bincount(rows, minlength=n).astype(np.float64) + 1e-7) ** -0.5
        self.base_rows_np = rows.astype(np.int32)
        self.base_cols_np = cols.astype(np.int32)
        self.adj = EdgeList.build(rows, cols, n, self.device, trained=False,
                                  w=(d[rows] * d[cols]).astype(np.float32))

        # the anchor sets' shortest paths (Model/GFormer.py:493-521), scipy's BFS
        anchors = np.random.default_rng(seed).choice(
            n, size=min(self.anchor_set_num, n), replace=False)
        g = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n))
        dist = dijkstra(g, indices=anchors, unweighted=True)
        a = len(anchors)
        self.anchors_np = anchors
        self.dists_np = np.where(np.isfinite(dist), 1.0 / (dist + 1.0), 0.0).astype(np.float32)
        # the reference's repeat/reshape "self feature" scramble
        self.scramble_np = (np.arange(n)[:, None] * a + np.arange(a)[None]) % n
        self.anchor_ids = torch.from_numpy(anchors).to(self.device, torch.int64)
        self.dists = torch.from_numpy(self.dists_np).to(self.device)  # (A, N)
        self.scramble = torch.from_numpy(self.scramble_np.reshape(-1)).to(self.device)
        self.scramble_offsets = torch.arange(0, n * a, a, device=self.device)

    def init_params(self, generator: torch.Generator) -> Params:
        e = self.dim_E
        p = {"u_emb": xavier_uniform(generator, (self.num_user, e)),
             "i_emb": xavier_uniform(generator, (self.num_item, e)),
             "gt_q": xavier_uniform(generator, (e, e)),
             "gt_k": xavier_uniform(generator, (e, e)),
             "gt_v": xavier_uniform(generator, (e, e))}
        # the sampler's own PNN (LocalGraph.pnn, Model/GFormer.py:40)
        p["smp_pnn_w"], p["smp_pnn_b"] = torch_linear_init(generator, e, 2 * e)
        for layer in range(self.pnn_layer):
            p[f"pnn_w{layer}"], p[f"pnn_b{layer}"] = torch_linear_init(generator, e, 2 * e)
        return p

    def _ego(self, params: Params) -> torch.Tensor:
        return torch.cat([params["u_emb"], params["i_emb"]], dim=0)

    def _gt(self, params: Params, g: EdgeList, x: torch.Tensor):
        """GTLayer (Model/GFormer.py:184-231): (the (N, E) messages, each
        edge's (E, heads) normalized attention); an edge that is not valid
        weighs 0."""
        h = self.head
        dh = self.dim_E // h
        x_src = self._src(g, x)
        q = (bag_gather(x, g.rows, g.bags) @ params["gt_q"]).reshape(-1, h, dh)
        k = (x_src @ params["gt_k"]).reshape(-1, h, dh)
        v = (x_src @ params["gt_v"]).reshape(-1, h, dh)
        exp_att = torch.exp(torch.clamp(torch.sum(q * k, dim=-1), -10.0, 10.0))
        if g.valid is not None:
            exp_att = exp_att * g.valid[:, None]
        att = exp_att / (bag_gather(bag_sum(exp_att, g.rows, g.bags), g.rows, g.bags) + 1e-8)
        return bag_sum((att[..., None] * v).reshape(-1, self.dim_E), g.rows, g.bags), att

    @staticmethod
    def _src(g: EdgeList, x: torch.Tensor) -> torch.Tensor:
        """x at each edge's source; its gradient summed per source row in a
        fixed order where the graph has them (``col_bags``)."""
        return x[g.cols] if g.col_bags is None else bag_gather(x, g.cols, g.col_bags)

    def _gcn(self, g: EdgeList, x: torch.Tensor) -> torch.Tensor:
        return bag_sum(g.w[:, None] * self._src(g, x), g.rows, g.bags)

    def _pnn(self, w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """PNNLayer (Model/GFormer.py:152-181): the mean over the anchors of
        a linear map of [distance x anchor row, scrambled self row], taken
        as the map of the two means."""
        a = self.anchor_ids.shape[0]
        messages = (self.dists.T @ x[self.anchor_ids]) / a  # (N, E)
        self_feat = torch.nn.functional.embedding_bag(self.scramble, x, self.scramble_offsets,
                                                      mode="mean")
        return torch.cat([messages, self_feat], dim=-1) @ w.T + b

    @torch.no_grad()
    def sampler_att(self, params: Params, g: EdgeList) -> torch.Tensor:
        """LocalGraph.forward (Model/GFormer.py:116-149): each edge's GT
        attention on the sampler's PNN embedding, summed over the heads."""
        emb = self._pnn(params["smp_pnn_w"], params["smp_pnn_b"], self._ego(params))
        return torch.sum(self._gt(params, g, emb)[1], dim=-1)

    def forward_train(self, params: Params, g: GFGraphs):
        ego = self._ego(params)
        c_sum = ego + self.gtw * self._gt(params, g.cmp, ego)[0]
        s_sum = ego + self.gtw * self._gt(params, g.sub, ego)[0]
        total = last = ego
        for _ in range(self.n_layers):
            e1 = self._gcn(g.enc, last)
            s_sum = s_sum + self._gcn(g.sub, last)
            c_sum = c_sum + self._gcn(g.cmp, last)
            total = total + e1
            last = e1
        for layer in range(self.pnn_layer):
            last = self._pnn(params[f"pnn_w{layer}"], params[f"pnn_b{layer}"], last)
            total = total + last
        total = total + self._gt(params, g.dec, last)[0]
        return total[:self.num_user], total[self.num_user:], c_sum, s_sum

    def embeddings(self, params: Params):
        """The eval forward: the plain normalized graph, no PNN, no decoder."""
        total = last = self._ego(params)
        for _ in range(self.n_layers):
            last = self._gcn(self.adj, last)
            total = total + last
        return total[:self.num_user], total[self.num_user:]

    @staticmethod
    def _contrast_uniq(nodes: torch.Tensor, emb: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
        """The mean over the batch's unique valid nodes of log sum_j
        exp(e_n . e_j) (Model/GFormer.py:597-603)."""
        valid = weights > 0
        order = torch.argsort(nodes * 2 + (~valid).to(nodes.dtype), stable=True)
        sn, sv = nodes[order], valid[order]
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=sn.device), sn[1:] != sn[:-1]])
        m = (first & sv).float()
        lse = catalog_logsumexp(emb[sn], emb)
        return torch.sum(lse * m) / torch.clamp(torch.sum(m), min=1.0)

    def loss_graphs(self, params: Params, batch: Batch, g: GFGraphs) -> torch.Tensor:
        u_g, i_g, c_all, s_all = self.forward_train(params, g)
        anc = u_g[batch.users]
        pos = i_g[batch.pos_items]
        neg = i_g[batch.neg_items]
        anc2 = s_all[:self.num_user][batch.users]
        pos2 = s_all[self.num_user:][batch.pos_items]
        w = batch.weights

        bpr = masked_mean(-torch.sum(anc * pos, dim=-1), w)  # eq13
        pos2_s = torch.sum(anc2 * pos2, dim=1)
        neg2_s = torch.sum(anc2 * neg, dim=1)  # the negatives of the MAIN stream (quirk)
        bpr2 = -masked_mean(torch.log(torch.sigmoid(pos2_s - neg2_s) + 1e-5), w) / 1024.0
        reg = self.reg_weight * sum(masked_mean(torch.mean(e ** 2, -1), w)
                                    for e in (anc, pos, neg, anc2, pos2))
        contrast = (self._contrast_uniq(batch.users, u_g, w)
                    + self._contrast_uniq(batch.pos_items, i_g, w)) * self.ssl_reg
        contrast = contrast + masked_mean(catalog_logsumexp(u_g[batch.users], i_g), w)
        nce = masked_mean(torch.logsumexp(s_all[batch.users] * c_all[batch.users], dim=-1), w)
        return bpr + reg + contrast + self.ctra * nce + self.b2 * bpr2


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         whole: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on ``grads``, in place: when their
    global L2 norm is at least ``max_norm``, each becomes ``g / norm *
    max_norm`` (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``).
    ``whole``: the gradients the norm is taken over, where ``grads`` are a
    mesh rank's rows of them (default ``grads``). Returns the norm (a
    0-dim tensor; no host sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in (grads if whole is None else whole)))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


class GFormerTrainer:
    """Epochs in groups of ``fix_steps`` batches: the host samples the
    group's graphs from the current params, then each batch takes one Adam
    step after the global-norm clip (train_and_evaluate.py:245-258). The
    standard ``Trainer`` underneath draws the shuffles and negatives,
    evaluates, stops early and logs; this class keeps no weights of its
    own."""

    max_grad_norm = 20.0  # train_and_evaluate.py:256

    def __init__(self, model: GFormer, dataset, cfg):
        from chaorec_tpu_torch.train.loop import Trainer

        self._base = base = Trainer(model, dataset, cfg)
        self.model = model
        self.cfg = cfg
        self.np_rng = np.random.default_rng(cfg.seed + 7)
        self.n_add = int(len(model.base_rows_np) * model.add_rate)
        base.train_epoch = self.train_epoch

    def sample_arrays(self, params: Params) -> Dict[str, np.ndarray]:
        """LocalGraph and RandomMaskSubgraphs: the candidate edges and the
        masks on the host, their attention on the model's device; the
        graphs as numpy arrays (``mask_subgraphs``)."""
        m = self.model
        n = m.num_nodes
        er, ec = candidate_edges(self.np_rng, m.base_rows_np, m.base_cols_np, n, self.n_add)
        att = m.sampler_att(params, EdgeList.build(er, ec, n, m.device, trained=False))
        att = att.cpu().numpy()
        return mask_subgraphs(att, er, ec, n, self.np_rng)

    def sample_graphs(self, params: Params) -> GFGraphs:
        """``sample_arrays`` as graphs on the model's device."""
        return graphs_from_arrays(self.sample_arrays(params), self.model.num_nodes,
                                  self.model.device)

    def train_step(self, params: Params, optimizer: torch.optim.Optimizer, batch: Batch,
                   graphs: GFGraphs) -> torch.Tensor:
        """One clipped Adam step on a batch with its negatives; returns the loss."""
        store = self._base.store_for(params)
        optimizer.zero_grad(set_to_none=True)
        loss = self.model.loss_graphs(params, batch, graphs)
        loss.backward()
        grads = {k: p.grad for k, p in store.shards.items() if p.grad is not None}
        clip_by_global_norm_(list(grads.values()), self.max_grad_norm,
                             [store.gather(k, g) for k, g in grads.items()])
        optimizer.step()
        store.full()
        return loss

    def train_epoch(self, params: Params, optimizer: torch.optim.Optimizer) -> float:
        from chaorec_tpu_torch.data.sampling import make_edge_batches
        from chaorec_tpu_torch.train.loop import deterministic_mode

        base, fs = self._base, self.model.fix_steps
        losses = []
        with deterministic_mode():
            batches = make_edge_batches(base.generator, base.edges, int(self.cfg.batch_size))
            for start in range(0, len(batches), fs):
                graphs = self.sample_graphs(params)
                for batch in batches[start:start + fs]:
                    loss = self.train_step(params, optimizer, base.bpr_batch(batch), graphs)
                    losses.append(loss.detach())
        return float(torch.stack(losses).sum())

    def run(self):
        return self._base.run()


GFormer.trainer_cls = GFormerTrainer
