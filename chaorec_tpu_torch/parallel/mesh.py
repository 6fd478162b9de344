"""Device-mesh training and ranking: dp (batch rows) x mp (param rows).

Counterpart of ``chaorec_tpu/parallel/mesh.py``. The JAX package names a
layout and lets GSPMD insert the collectives; torch has no such compiler,
so the port states its collectives, and keeps one device's math:

- **mp shards storage, not compute.** ``shard_params`` keeps, on each rank,
  its rows of every param the JAX rule shards (``shard_rule``: two or more
  dims, rows divisible by mp, at least 8 mp rows); the optimizers over
  ``ShardedParams.shards`` keep their moments of those rows only.
  ``ShardedParams.full`` all-gathers the shards over the mp group into the
  full tensors the model reads, and every rank of the group computes the
  whole step; the gather's backward gives each rank its own rows of the
  gradient, with no collective. A run with dp = 1 thus computes what one
  device computes, bit for bit. Row-sparse tables (``table_params``) are
  never gathered whole during training: ``table_rows`` builds a batch's
  rows with one all_reduce, each rank filling the rows it owns.
- **dp splits a batch's rows** for a model that declares ``dp_split``:
  every rank draws the whole batch (the same shuffles, negatives and
  in-loss draws, so the generators stay in step), ``shard_batch`` keeps its
  dp slice and its share w_r / W of the batch's weight, the trainer scales
  the loss by that share and ``reduce_grads`` sums the gradients over the
  dp group. A weighted mean over rows then sums to the full batch's up to
  the order of the sum; a summed term divides by ``Batch.share`` first.
  Every other model takes the whole batch on every dp rank.
- **Ranking splits the users over the whole world** (``sharded_rank``,
  ``sharded_rank_scores``): each rank ranks its users against the
  replicated item side with ``eval/ranking.py``'s functions, and the rank
  lists are all-gathered to every rank, so every rank computes the same
  metrics and stops early on the same epoch.

Rank r sits at (dp index r // mp, mp index r % mp). Backends: NCCL when
every rank owns a card (at most as many ranks a host as cards); gloo when
ranks share a card or run on the CPU. Gloo is given host copies of CUDA
tensors. Only all_gather and all_reduce are used; gathers move raw bytes,
so any dtype crosses exactly.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from chaorec_tpu_torch.eval.ranking import gene_ranklist, rank_from_scores
from chaorec_tpu_torch.models.base import Batch, Params

AXES = ("dp", "mp")


def shard_rule(shape: Tuple[int, ...], mp: int) -> bool:
    """Whether a param of ``shape`` is row-sharded over an mp of ``mp``:
    the JAX package's rule (``shard_params``), two or more dims, rows
    divisible by mp and at least 8 mp rows."""
    return mp > 1 and len(shape) >= 2 and shape[0] % mp == 0 and shape[0] >= 8 * mp


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """(dp, mp) of the CLI's ``--mesh_shape``, e.g. "dp=4,mp=2"; an axis
    left out is 1."""
    parts = dict(p.split("=") for p in spec.replace(" ", "").split(",") if p)
    unknown = set(parts) - set(AXES)
    if unknown:
        raise ValueError(f"--mesh_shape {spec!r}: unknown axes {sorted(unknown)}; "
                         f"the axes are {AXES}")
    dp, mp = int(parts.get("dp", 1)), int(parts.get("mp", 1))
    if dp < 1 or mp < 1:
        raise ValueError(f"--mesh_shape {spec!r}: axes must be at least 1")
    return dp, mp


@dataclasses.dataclass
class Mesh:
    """A (dp, mp) mesh and this process's place in it; with no backend, the
    one-process mesh, where every collective is the identity."""

    dp: int = 1
    mp: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    dp_group: object = None
    mp_group: object = None

    @property
    def world(self) -> int:
        return self.dp * self.mp

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp

    @property
    def spec(self) -> str:
        return f"dp={self.dp},mp={self.mp}"

    def describe(self) -> str:
        """The mesh, this rank's place and the backend, for the log."""
        how = {None: "no process group", "nccl": "NCCL: every rank owns a card",
               "gloo": "gloo: ranks share a card or run on the CPU"}[self.backend]
        if self.backend == "gloo" and self.device.type == "cuda":
            how += ", given host copies"
        return (f"mesh {self.spec}: rank {self.rank} of {self.world} (dp {self.dp_index}, mp "
                f"{self.mp_index}) on {self.device}; backend {how}")

    def _group(self, axis: str):
        """(process group, size) of ``axis``: "dp", "mp" or "world"."""
        return {"dp": (self.dp_group, self.dp), "mp": (self.mp_group, self.mp),
                "world": (None, self.world)}[axis]

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend reads it: gloo takes host copies."""
        return t.cpu() if self.backend == "gloo" else t

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The members' ``x`` (equal shapes) stacked along dim 0, in rank
        order; a 0-dim ``x`` gives one entry a member. Bytes cross, so every
        dtype arrives exactly."""
        group, n = self._group(axis)
        if n == 1:
            return x
        x = x.detach().contiguous()
        shape = x.shape if x.dim() else (1,)
        raw = self._wire(x.reshape(-1).view(torch.uint8))
        parts = [torch.empty_like(raw) for _ in range(n)]
        dist.all_gather(parts, raw, group=group)
        return torch.cat(parts).to(self.device).view(x.dtype).view(n * shape[0], *shape[1:])

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of the members' ``x`` (a new tensor); every member gets
        the same bits."""
        group, n = self._group(axis)
        if n == 1:
            return x
        t = self._wire(x.detach()).clone()
        dist.all_reduce(t, group=group)
        return t.to(self.device)

    def all_reduce_(self, tensors: List[torch.Tensor], axis: str) -> None:
        """Each of ``tensors`` replaced in place by its sum over ``axis``:
        one all_reduce a dtype, over the tensors laid end to end."""
        if self._group(axis)[1] == 1:
            return
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = self.all_reduce(torch.cat([t.reshape(-1) for t in ts]), axis)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view(t.shape))


def make_mesh(n: int, mp: Optional[int] = None) -> Mesh:
    """The (n // mp, mp) mesh shape over ``n`` ranks, unjoined; ``mp``
    defaults to 2 on an even n >= 2, else 1, as the JAX package's."""
    if mp is None:
        mp = 2 if n % 2 == 0 and n >= 2 else 1
    if n % mp:
        raise ValueError(f"{n} ranks do not split into mp={mp}")
    return Mesh(dp=n // mp, mp=mp)


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when every rank of a host owns a card, gloo when ranks share a
    card (NCCL refuses two ranks on one device) or run on the CPU."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@functools.cache
def _groups(dp: int, mp: int) -> Tuple[object, object]:
    """This rank's (dp group, mp group) of the joined world, made once a
    process (``new_group`` is collective: every rank makes every group, in
    one order)."""
    rank = dist.get_rank()
    mine = [None, None]
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(dp)])
        if rank % mp == m:
            mine[0] = g
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            mine[1] = g
    return mine[0], mine[1]


def world_mesh(spec: str, device: torch.device | str) -> Mesh:
    """The mesh ``spec`` over the world this process has joined (a world
    of one when it has joined none). Raises when the world's size is not
    dp x mp."""
    dp, mp = parse_mesh_spec(spec)
    device = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != dp * mp:
        raise ValueError(f"--mesh_shape {spec} needs {dp * mp} ranks, the world has {world}")
    if not dist.is_initialized():
        return Mesh(device=device)
    dp_group, mp_group = _groups(dp, mp)
    return Mesh(dp=dp, mp=mp, rank=dist.get_rank(), device=device,
                backend=dist.get_backend(), dp_group=dp_group, mp_group=mp_group)


def init_mesh(spec: str, device: torch.device | str, init_method: str = "env://") -> Mesh:
    """Joins the world torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, and ``MASTER_ADDR``/``MASTER_PORT`` for ``env://``, or
    ``init_method`` a ``file://`` store) and returns its mesh. The backend
    is chosen from the ranks a host runs (``LOCAL_WORLD_SIZE``, else the
    world) and the cards it has (``Mesh.describe`` names it)."""
    dp, mp = parse_mesh_spec(spec)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != dp * mp:
        raise ValueError(f"--mesh_shape {spec} needs {dp * mp} ranks, WORLD_SIZE is {world}")
    device = torch.device(device)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(device, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return world_mesh(spec, device)


def close_mesh() -> None:
    """Leaves the world ``init_mesh`` joined."""
    if dist.is_initialized():
        _groups.cache_clear()
        dist.destroy_process_group()


class _GatherRows(torch.autograd.Function):
    """Forward: the mp group's shards stacked into the full tensor.
    Backward: this rank's rows of the full gradient (every rank of the
    group computed the same one), with no collective."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.rows = (mesh.mp_index * shard.shape[0], shard.shape[0])
        return mesh.all_gather(shard, "mp")

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        first, n = ctx.rows
        return grad[first:first + n], None


class ShardedParams:
    """A model's params on a mesh. ``shards``: what the optimizers step,
    in the params' order (each rank's rows of a sharded param, the others
    whole); ``view``: what the model reads (``full``'s gathers; sharded
    tables are absent from it, see ``table_rows``). On a one-process mesh,
    or where mp is 1, ``shards`` and ``view`` are the params dict itself."""

    def __init__(self, params: Params, mesh: Mesh, tables: Iterable[str] = ()):
        self.mesh = mesh
        self.tables = tuple(tables)
        self.rows: Dict[str, Tuple[int, int]] = {}  # sharded name -> (first row, rows)
        if not any(shard_rule(tuple(v.shape), mesh.mp) for v in params.values()):
            self.shards = self.view = params
            return
        self.shards = {}
        for k, v in params.items():
            if shard_rule(tuple(v.shape), mesh.mp):
                n = v.shape[0] // mesh.mp
                self.rows[k] = (mesh.mp_index * n, n)
                v = v.detach()[mesh.mp_index * n:(mesh.mp_index + 1) * n].clone() \
                    .requires_grad_(v.requires_grad)
            self.shards[k] = v
        self.view = {}
        self.full()

    def full(self) -> Params:
        """``view`` with every sharded param gathered anew from the current
        shards (differentiable); returns ``view``."""
        if self.rows:
            with torch.enable_grad():
                for k, v in self.shards.items():
                    if k not in self.rows:
                        self.view[k] = v
                    elif k not in self.tables:
                        self.view[k] = _GatherRows.apply(v, self.mesh)
        return self.view

    def set(self, name: str, t: torch.Tensor) -> None:
        """``name``'s stored tensor replaced (a table stepped on the CPU)."""
        self.shards[name] = t
        if name not in self.rows:
            self.view[name] = t

    def reduce_grads(self) -> None:
        """Every shard's gradient summed over the dp group."""
        self.mesh.all_reduce_([p.grad for p in self.shards.values() if p.grad is not None],
                              "dp")

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t``, a tensor shaped as ``name``'s shard (the shard, its
        moments), gathered to the full rows; as it is where ``name`` is not
        sharded."""
        return self.mesh.all_gather(t, "mp") if name in self.rows else t

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``full`` (a copy) where ``name`` is sharded."""
        if name not in self.rows:
            return full
        first, n = self.rows[name]
        return full[first:first + n].clone()

    def full_shape(self, name: str) -> Tuple[int, ...]:
        shape = tuple(self.shards[name].shape)
        return (shape[0] * self.mesh.mp,) + shape[1:] if name in self.rows else shape

    def name_of(self, t: torch.Tensor) -> str:
        """The name of the stored tensor ``t``."""
        return next(k for k, v in self.shards.items() if v is t)

    def gather_host(self) -> Params:
        """Every param whole, detached, on the host (exports, final params)."""
        return {k: self.gather(k, v.detach()).to("cpu", copy=True) for k, v in self.shards.items()}

    def table_rows(self, name: str, rows: torch.Tensor) -> torch.Tensor:
        """``table[rows]`` of the table ``name``: where it is sharded, one
        all_reduce over the mp group of each rank's own rows and -0.0
        elsewhere (x + -0.0 is x for every x, so the sum is exact)."""
        t = self.shards[name]
        if name not in self.rows:
            return t[rows]
        first, n = self.rows[name]
        local = rows - first
        own = (local >= 0) & (local < n)
        vals = t[local.clamp(0, n - 1)].float()
        vals = torch.where(own[:, None], vals, torch.full_like(vals, -0.0))
        return self.mesh.all_reduce(vals, "mp").to(t.dtype)

    def owned_rows(self, name: str, rows: torch.Tensor) -> torch.Tensor:
        """``rows`` as ids into this rank's shard of ``name``: a row another
        rank owns becomes the shard's row count, which the row-sparse Adam
        skips (the kernel's padding id)."""
        if name not in self.rows:
            return rows
        first, n = self.rows[name]
        local = rows - first
        return torch.where((local >= 0) & (local < n), local, torch.full_like(local, n))

    def digest(self) -> str:
        """sha256 of the params every rank holds whole (the replicated ones)."""
        h = hashlib.sha256()
        for k, v in self.shards.items():
            if k not in self.rows:
                h.update(k.encode())
                h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())
        return h.hexdigest()


def shard_params(params: Params, mesh: Mesh, tables: Iterable[str] = ()) -> ShardedParams:
    """``params`` on ``mesh``: row-sharded over mp by ``shard_rule``, the
    rest replicated; ``tables`` are the model's row-sparse tables."""
    return ShardedParams(params, mesh, tables)


def split_rows(batch: Batch, parts: int, index: int) -> Tuple[Batch, torch.Tensor]:
    """(the ``index``-th of ``parts`` row slices of ``batch``, with
    ``share`` its share w_r / W of the batch's weight; that share)."""
    def part(t):
        return None if t is None else t.tensor_split(parts)[index]

    w = batch.weights
    share = part(w).sum() / w.sum()
    return dataclasses.replace(
        batch, users=part(batch.users), weights=part(w), pos_items=part(batch.pos_items),
        neg_items=part(batch.neg_items), int_items=part(batch.int_items), share=share), share


def shard_batch(batch: Batch, mesh: Mesh) -> Tuple[Batch, torch.Tensor]:
    """This rank's dp slice of a batch drawn whole (the mp ranks of a dp
    group take the same rows) and its share of the batch's weight."""
    return split_rows(batch, mesh.dp, mesh.dp_index)


def _user_slice(mesh: Mesh, u: int) -> Tuple[int, int]:
    """(first, rows) of this rank's users when ``u`` users, padded to a
    multiple of the world, are split over it."""
    per = -(-u // mesh.world)
    return mesh.rank * per, per


def _padded_rows(t: torch.Tensor, first: int, n: int, fill) -> torch.Tensor:
    """Rows [first, first + n) of ``t``, those past its end ``fill``."""
    rows = t[first:first + n]
    if rows.shape[0] < n:
        pad = torch.full((n - rows.shape[0],) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                         device=t.device)
        rows = torch.cat([rows, pad])
    return rows


@torch.no_grad()
def sharded_rank(user_emb: torch.Tensor, item_emb: torch.Tensor, history: torch.Tensor,
                 num_user: int, topk: int, mesh: Mesh, user_chunk: int = 4096) -> torch.Tensor:
    """``gene_ranklist`` with the users split over the whole world (padded
    as the JAX function pads them: zero rows, histories of the sentinel)
    and the item table replicated; every rank gets all the rank lists."""
    u = user_emb.shape[0]
    first, n = _user_slice(mesh, u)
    mine = gene_ranklist(_padded_rows(user_emb, first, n, 0), item_emb,
                         _padded_rows(history, first, n, item_emb.shape[0]), num_user, topk,
                         user_chunk)
    return mesh.all_gather(mine, "world")[:u]


@torch.no_grad()
def sharded_rank_scores(model, params: Params, history: torch.Tensor, num_user: int,
                        topk: int, mesh: Mesh, state=None,
                        user_chunk: int = 4096) -> torch.Tensor:
    """``rank_from_scores`` with the users split over the whole world:
    each rank scores its users with the model's ``score_users`` (or
    ``score_users_stateful`` with ``state``), masks and takes its top-k;
    the (U, I) scores exist only a chunk at a time. Padding users are user
    0, as in the JAX function; every rank gets all the rank lists.
    ``num_user`` is the model's, kept from the JAX function's signature."""
    u = history.shape[0]
    first, n = _user_slice(mesh, u)
    ids = _padded_rows(torch.arange(u, device=history.device), first, n, 0)
    mine = rank_from_scores(model, params, history, topk, user_chunk, state, users=ids)
    return mesh.all_gather(mine, "world")[:u]


def rank_report(mesh: Mesh, values: Dict[str, float]) -> List[Dict[str, float]]:
    """Each rank's ``values`` (the same keys on every rank), in rank order,
    gathered to every rank."""
    keys = list(values)
    mine = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64,
                        device=mesh.device)
    rows = mesh.all_gather(mine[None], "world").cpu().tolist()
    return [dict(zip(keys, row)) for row in rows]
