"""Tensor, expert and data parallelism over `torch.distributed`.

Counterpart of `repro/sharding.py` and of the serving parts of
`repro/launch/mesh.py` (`make_serving_mesh`, `replica_submeshes`,
`dispatch_groups`). The reference shards over a JAX mesh; here each rank
is a process holding its own slice of the weights, and a `ShardGroup`
(its rank, the group's size, the process group and the device) is what
the model code receives where the reference reads the mesh:

* the cold path of the hybrid FFN splits by whole groups when the plan's
  groups divide the ranks (`cold_range`), and otherwise runs replicated;
  the hot prefix splits as the storage plane prices it (`hot_range`);
  one fp32 all-reduce per layer joins the partial outputs and the ranks'
  cluster ids are gathered in rank order (`core/sparse_ffn.py`);
* attention splits by heads when the heads and the kv heads divide the
  ranks, with one fp32 all-reduce after `wo` (`models/blocks.py`);
* moe splits by whole experts under `moe_shard_mode == "ep"` and by
  each expert's neurons under "tp" (`models/moe.py`);
* the embedding splits by vocab rows and the head by vocab columns when
  the ranks divide the padded vocabulary (`vocab_range`); the logits
  are gathered whole on every rank (`models/dense.py`);
* mamba2 (ssm) splits each layer by whole heads (`wz` / `wx` / `gn` /
  `wo` by their d_inner columns or rows, `wdt`, `A_log`, `D`, `dt_bias`
  by heads) when the heads divide the ranks; its gated norm over the
  whole d_inner sums the ranks' squares (`ShardGroup.reduce_stat`);
* the RG-LRU block (hybrid) splits by channels of the LRU width
  (`w_in` / `w_gate` / the conv / the gates by channels, `w_out` by
  rows) when the ranks divide it; the recurrence is per channel;
* the encdec's self and cross attention split by heads as above, its
  encoder FFNs as the prefill FFN (`dense_ranges`) and its decoder FFNs
  as a decode step's;
* dp replicas each run on their own group of ranks (`replica_groups`),
  and the ranks that share a tp index across replicas form the data
  groups (`data_groups`) over which training sums its gradients.

Every split region is entered through `ShardGroup.copy_in` (the
identity forward, an fp32 all-reduce of the gradient backward) and left
through `reduce_out` (an fp32 all-reduce forward, the identity
backward), so a train step over ranks gives each rank the gradient of
its slices and the whole gradient of every replicated parameter.
`gather_vocab` joins the vocab columns in rank order; its backward takes
the rank's own columns, since every rank computes the same loss from the
gathered logits. `reduce_stat` sums a statistic every rank's slice reads
(mamba2's sum of squares): an fp32 all-reduce forward and backward. A
whole (replicated) leaf that only a split region reads enters it through
`copy_in` too, so its gradient sums the ranks' parts.

`placements` says, leaf path by leaf path in the reference's parameter
tree, which part of each leaf a rank holds; the modules size and draw
their slices from it, and `bridge` cuts and gathers trees by it.

A group of size 1 takes the single-device code path and makes no
collective call. `spawn` starts the ranks of one host as processes
(gloo, a `file://` rendezvous in a fresh temporary directory, a timeout
on every collective and on the join), so several runs of it never
contend for a port.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["ShardGroup", "LOCAL", "NeuronRows", "ShardLayout", "hot_range",
           "cold_range", "ffn_ranges", "shard_layout", "vocab_range",
           "placements", "places_under", "cut_shape", "stacked",
           "replica_groups", "data_groups", "grid", "replica_cfg",
           "init_world", "spawn"]

# seconds a collective may wait for its peers before it raises
COLLECTIVE_TIMEOUT_S = 300.0


# --------------------------------------------------------------- groups ----

@dataclass
class ShardGroup:
    """One rank's view of a group of ranks: its rank in the group (None
    when this process is not a member), the group's size, the
    `torch.distributed` process group, the device its tensors live on
    and the global ranks of the group in group order. `calls` counts
    the collectives it made (a plain counter: nothing waits on the
    device for it)."""
    rank: Optional[int]
    size: int
    group: object = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    ranks: tuple = (0,)
    calls: int = 0

    @property
    def member(self) -> bool:
        return self.rank is not None

    def all_reduce_f32(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of `y` over the group, in fp32, cast back to y's dtype
        (the reference's psum of an fp32 cast)."""
        if self.size == 1:
            return y
        t = y.to(torch.float32, copy=True)
        dist.all_reduce(t, group=self.group)
        self.calls += 1
        return t.to(y.dtype)

    def all_gather_cols(self, t: torch.Tensor) -> torch.Tensor:
        """Each rank's (..., c) tensor joined along the last dim in rank
        order -> (..., size * c), gathered in fp32 (exact for fp16 and
        bf16) and cast back to t's dtype."""
        if self.size == 1:
            return t
        f = t.to(torch.float32).contiguous()
        parts = [torch.empty_like(f) for _ in range(self.size)]
        dist.all_gather(parts, f, group=self.group)
        self.calls += 1
        return torch.cat(parts, dim=-1).to(t.dtype)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """x at the entry of a split region: the identity forward; the
        backward sums the ranks' partial gradients in fp32."""
        return _CopyIn.apply(x, self) if _records(self, x) else x

    def reduce_out(self, y: torch.Tensor) -> torch.Tensor:
        """The ranks' partial y summed in fp32 (`all_reduce_f32`) at the
        exit of a split region; the backward passes the gradient on."""
        return _ReduceOut.apply(y, self) if _records(self, y) else \
            self.all_reduce_f32(y)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The ranks' vocab columns of the logits joined in rank order;
        the backward keeps this rank's columns of the gradient (every
        rank computes the same loss from the whole logits, so no sum)."""
        return _GatherVocab.apply(logits, self) \
            if _records(self, logits) else self.all_gather_cols(logits)

    def reduce_stat(self, s: torch.Tensor) -> torch.Tensor:
        """The ranks' partial statistic `s` summed in fp32, a sum every
        rank's slice then reads (mamba2's gated norm over the split
        d_inner); the backward sums the ranks' gradients of it the same
        way, since each rank's slice contributes its own part."""
        return _ReduceStat.apply(s, self) if _records(self, s) else \
            self.all_reduce_f32(s)

    def all_gather_ids(self, idx: torch.Tensor) -> torch.Tensor:
        """Each rank's (g, ...) ids stacked in rank order -> (size * g,
        ...), gathered on the host (the ids are read there anyway) and
        returned on idx's device."""
        if self.size == 1:
            return idx
        t = idx.cpu()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        self.calls += 1
        return torch.cat(parts).to(idx.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """t from the group's rank `src` to every rank, in place."""
        if self.size == 1:
            return t
        dist.broadcast(t, src=self.ranks[src], group=self.group)
        self.calls += 1
        return t

    def gather_objects(self, obj, dst: int = 0):
        """Each rank's picklable object, in rank order, on the group's
        rank `dst`; None on the other ranks."""
        if self.size == 1:
            return [obj]
        box = [None] * self.size if self.rank == dst else None
        dist.gather_object(obj, box, dst=self.ranks[dst], group=self.group)
        self.calls += 1
        return box

    def broadcast_object(self, obj, src: int = 0):
        """A picklable object from the group's rank `src` to every rank
        (the other ranks pass None)."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[src],
                                   group=self.group)
        self.calls += 1
        return box[0]


def _records(shard: ShardGroup, t: torch.Tensor) -> bool:
    """True when a collective on t needs its autograd function: a group
    of several ranks and a tensor autograd is recording (a serve step,
    under no_grad, calls the raw collective)."""
    return shard.size > 1 and torch.is_grad_enabled() and t.requires_grad


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.all_reduce_f32(g.contiguous()), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, shard):
        return shard.all_reduce_f32(y)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceStat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, shard):
        ctx.shard = shard
        return shard.all_reduce_f32(s)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.all_reduce_f32(g.contiguous()), None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.rank, ctx.cols = shard.rank, x.shape[-1]
        return shard.all_gather_cols(x)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.cols
        return g[..., lo:lo + ctx.cols].contiguous(), None


# the group of one rank: the single-device path, no collective
LOCAL = ShardGroup(0, 1)


def replica_groups(world: ShardGroup, dp: int, tp: int) -> list:
    """One ShardGroup per dp replica, replica r on the ranks [r*tp,
    (r+1)*tp) of `world` (the counterpart of `replica_submeshes`: each
    replica keeps its own row of ranks). Every rank of `world` must call
    this, in the same order, since creating a group is collective; a
    rank outside replica r gets that replica's group with rank None."""
    _fills(world, dp, tp)
    out = []
    me = _me(world)
    for r in range(dp):
        ranks = tuple(world.ranks[r * tp:(r + 1) * tp])
        pg = dist.new_group(list(ranks), backend="gloo",
                            timeout=_timeout()) if tp > 1 else None
        out.append(ShardGroup(ranks.index(me) if me in ranks else None,
                              tp, pg, world.device, ranks))
    return out


def data_groups(world: ShardGroup, dp: int, tp: int) -> list:
    """One ShardGroup per tp index j: the ranks {r*tp + j} of the dp
    replicas, over which training sums its gradients (the columns of
    the grid whose rows `replica_groups` gives). Every rank of `world`
    must call this, in the same order."""
    _fills(world, dp, tp)
    out = []
    me = _me(world)
    for j in range(tp):
        ranks = tuple(world.ranks[r * tp + j] for r in range(dp))
        pg = dist.new_group(list(ranks), backend="gloo",
                            timeout=_timeout()) if dp > 1 else None
        out.append(ShardGroup(ranks.index(me) if me in ranks else None,
                              dp, pg, world.device, ranks))
    return out


def grid(world: ShardGroup, dp: int, tp: int) -> tuple:
    """(this rank's replica group, its data group) of the dp x tp grid
    over `world`'s dp*tp ranks: replica r on ranks [r*tp, (r+1)*tp).
    Every rank that created `world` calls; one that is no member of it
    gets groups it is no member of (rank None)."""
    rows = replica_groups(world, dp, tp)
    cols = data_groups(world, dp, tp)
    if not world.member:
        return rows[0], cols[0]
    return rows[world.rank // tp], cols[world.rank % tp]


def _fills(world: ShardGroup, dp: int, tp: int):
    if dp * tp != world.size:
        raise ValueError(f"dp={dp} x tp={tp} does not fill a world of "
                         f"{world.size} ranks")


def _me(world: ShardGroup):
    """This process's global rank, None when it is no member of world."""
    return world.ranks[world.rank] if world.member else None


def replica_cfg(cfg, dp: int):
    """cfg as one of dp data-parallel replicas runs it: the moe
    dispatch's token groups split over the replicas (each replica
    routes its rows of the global batch in `moe_dispatch_groups // dp`
    groups of the global capacity, as `launch/mesh.py::dispatch_groups`
    derives the groups from the mesh). Raises when dp does not divide
    the groups."""
    if dp == 1 or not cfg.num_experts:
        return cfg
    G = max(cfg.moe_dispatch_groups, 1)
    if G % dp:
        raise ValueError(f"{cfg.name}: moe_dispatch_groups={G} does not "
                         f"split over dp={dp} replicas")
    return cfg.replace(moe_dispatch_groups=G // dp)


# ----------------------------------------------------------- the layout ----

def hot_range(n_hot: int, rank: int, n: int) -> tuple:
    """The hot neurons rank owns: i with (i*n)//n_hot == rank, the split
    the storage plane prices (`FFNStorageView.owner_of`)."""
    return (-(-rank * n_hot // n), -(-(rank + 1) * n_hot // n))


def cold_split(plan, n: int) -> bool:
    """True when the plan's groups divide the ranks: each rank then owns
    G/n whole groups of the cold region (`_use_shard_map`)."""
    return n > 1 and plan.groups % n == 0


def cold_range(plan, n_neurons: int, rank: int, n: int) -> tuple:
    """The cold neurons rank computes: its G/n whole groups when they
    divide the ranks, else the whole cold region (replicated)."""
    n_hot = plan.n_hot
    if not cold_split(plan, n):
        return (n_hot, n_neurons)
    width = (n_neurons - n_hot) // plan.groups * (plan.groups // n)
    return (n_hot + rank * width, n_hot + (rank + 1) * width)


def ffn_ranges(plan, n_neurons: int, rank: int, n: int) -> list:
    """The global neuron ranges rank computes in a decode step under
    `plan`: its hot slice and its cold slice."""
    return [hot_range(plan.n_hot, rank, n),
            cold_range(plan, n_neurons, rank, n)]


def dense_ranges(plan, n_neurons: int, rank: int, n: int) -> list:
    """The rank's slice of the dense (prefill) FFN: the hot slice of
    `plan` and an n-th of its cold region, a subset of the ranges the
    rank holds for that plan."""
    n_hot = plan.n_hot
    n_cold = n_neurons - n_hot
    return [hot_range(n_hot, rank, n),
            (n_hot + rank * n_cold // n, n_hot + (rank + 1) * n_cold // n)]


def _merge(ranges) -> list:
    out = []
    for lo, hi in sorted(r for r in ranges if r[1] > r[0]):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


class NeuronRows:
    """The rows of a layer's (N, R, D) FFN bundle that one rank holds:
    sorted, disjoint global ranges, stored back to back in the rank's
    local tensor. Every range a decode step of the plan's buckets
    computes lies inside one of them, so `local(lo, hi)` is a view.
    `dense` is the rank's slice of the prefill FFN."""

    def __init__(self, ranges, n_neurons: int, dense):
        self.ranges = _merge(ranges)
        self.n_neurons = n_neurons
        self.dense = [r for r in dense if r[1] > r[0]]
        self.starts = np.cumsum([0] + [hi - lo for lo, hi in self.ranges])

    @property
    def ids(self) -> np.ndarray:
        """The global ids of the local rows, in order."""
        return np.concatenate([np.arange(lo, hi) for lo, hi in self.ranges]
                              or [np.zeros(0, np.int64)])

    def local(self, lo: int, hi: int) -> slice:
        """The local rows of global rows [lo, hi)."""
        for (a, b), s in zip(self.ranges, self.starts):
            if a <= lo and hi <= b:
                return slice(int(s + lo - a), int(s + hi - a))
        if hi <= lo:
            return slice(0, 0)
        raise ValueError(f"rows [{lo}, {hi}) are not held by this rank "
                         f"(it holds {self.ranges})")


@dataclass(frozen=True)
class ShardLayout:
    """What one rank holds of the model: its attention heads (all of them
    unless both head counts divide the ranks), its vocab rows of the
    embedding and columns of the head, its FFN rows (dense, vlm, hybrid,
    encdec's decoder; `enc_ffn` for encdec's encoder), its routed
    experts, each expert's neuron rows and its shared rows (moe), its
    mamba2 heads (ssm) and its LRU channels (hybrid)."""
    heads: tuple            # (first q head, q heads, first kv head, kv heads)
    ffn: Optional[NeuronRows] = None
    experts: tuple = (0, 0)  # (first expert, experts)
    shared: tuple = (0, 0)   # shared-expert rows [lo, hi)
    vocab: tuple = (0, 0)    # vocab rows [lo, hi) of embed, columns of head
    expert_rows: tuple = (0, 0)  # each held expert's neuron rows [lo, hi)
    ssm_heads: tuple = (0, 0)    # (first mamba2 head, heads)
    channels: tuple = (0, 0)     # RG-LRU channels [lo, hi)
    enc_ffn: Optional[NeuronRows] = None

    @property
    def enc(self) -> "ShardLayout":
        """The layout an encdec encoder layer is built at: its FFN rows
        are `enc_ffn`."""
        return dataclasses.replace(self, ffn=self.enc_ffn)


def attention_sharded(cfg, n: int) -> bool:
    """Heads split over n ranks when both head counts divide n (the
    plane's `_attn_frac` rule); otherwise attention is replicated."""
    return n > 1 and cfg.num_heads % n == 0 and cfg.num_kv_heads % n == 0


def expert_parallel(cfg, n: int) -> bool:
    """Whole experts split over n ranks: moe_shard_mode 'ep' and E % n
    == 0 (`_use_ep_shard_map`)."""
    return n > 1 and cfg.moe_shard_mode == "ep" and \
        cfg.num_experts % n == 0


def neuron_parallel(cfg, n: int) -> bool:
    """Each expert's d_ff rows split over n ranks: moe_shard_mode 'tp'
    (the reference's `experts` spec P(None, 'model', None, None))."""
    return n > 1 and cfg.num_experts > 0 and cfg.moe_shard_mode == "tp"


def vocab_range(cfg, rank: int, n: int) -> tuple:
    """The vocab rows of the embedding (and columns of the head) that
    rank holds: an n-th of the padded vocabulary when n divides it, else
    all of it (the reference's `_filter_spec` replicates a dim the axis
    does not divide)."""
    V = cfg.vocab_padded
    if n > 1 and V % n == 0:
        return (rank * V // n, (rank + 1) * V // n)
    return (0, V)


def _moe_layout(cfg, plan, rank: int, n: int, heads, vocab) -> ShardLayout:
    E, f = cfg.num_experts, cfg.d_ff
    S = cfg.num_shared_experts * f
    experts, rows, shared = (0, E), (0, f), (0, S)
    if expert_parallel(cfg, n):
        experts = (rank * E // n, E // n)
        shared = hot_range(S, rank, n)
    elif neuron_parallel(cfg, n):
        if f % n:
            raise ValueError(f"{cfg.name}: d_ff={f} does not split over "
                             f"{n} ranks")
        cs = getattr(plan, "cluster_size", 0)
        if cfg.moe_intra_expert and plan is not None and (f // n) % cs:
            raise ValueError(
                f"{cfg.name}: each rank's {f // n} rows of an expert are "
                f"not whole clusters of {cs}; the two-level trace counts "
                f"whole clusters per rank")
        rows = (rank * f // n, (rank + 1) * f // n)
        shared = hot_range(S, rank, n)
    return ShardLayout(heads, experts=experts, shared=shared, vocab=vocab,
                       expert_rows=rows)


def ssm_range(cfg, rank: int, n: int) -> tuple:
    """(first head, heads) of mamba2's heads rank holds: an n-th when n
    divides them, else all of them (the layer replicates)."""
    h = cfg.ssm_heads
    if n > 1 and h % n == 0:
        return (rank * h // n, h // n)
    return (0, h)


def channel_range(cfg, rank: int, n: int) -> tuple:
    """The RG-LRU channels [lo, hi) rank holds: an n-th of the LRU width
    (d_model) when n divides it, else all of it."""
    d = cfg.d_model
    if n > 1 and d % n == 0:
        return (rank * d // n, (rank + 1) * d // n)
    return (0, d)


def _ffn_rows(cfg, plan, rank: int, n: int) -> tuple:
    """(the FFN rows a decode layer holds, those of a prefill-only FFN):
    with `plan` (an ExecutionPlan, or one HybridPlan for every batch)
    the union over its bucket plans of the rows a decode step computes
    (`ffn_ranges`) and the prefill's, and the prefill's alone; without
    one, the rank's n-th of the N rows for both."""
    N = cfg.d_ff
    if plan is None:
        dense = [hot_range(N, rank, n)]
        rows = NeuronRows(dense, N, dense)
        return rows, rows
    plans = list(plan.plans.values()) if hasattr(plan, "plans") else [plan]
    first = plan.plan_for_batch(1) if hasattr(plan, "plans") else plan
    ranges = [r for p in plans for r in ffn_ranges(p, N, rank, n)]
    dense = dense_ranges(first, N, rank, n)
    return NeuronRows(ranges + dense, N, dense), NeuronRows(dense, N, dense)


def shard_layout(cfg, plan, rank: int, n: int) -> ShardLayout:
    """Rank `rank` of `n`'s slice of `cfg`'s model: the counterpart of
    the reference's param specs filtered by `_filter_spec` (a dim that n
    does not divide replicates). Served with `plan` (an ExecutionPlan,
    or a HybridPlan used at every batch), its FFN rows are the union,
    over every bucket plan, of the rows a decode step computes
    (`ffn_ranges`), so each bucket's hot and cold slices are views of
    the local bundle; an FFN that only ever runs dense (encdec's
    encoder) holds the prefill's rows; for training (plan None) both
    are the rank's n-th of the N rows. The vocab splits as `vocab_range`
    gives it; moe experts split by whole experts ('ep') or by each
    expert's rows ('tp', `neuron_parallel`); mamba2 by whole heads
    (`ssm_range`), the RG-LRU by channels (`channel_range`)."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if attention_sharded(cfg, n):
        heads = (rank * h // n, h // n, rank * kv // n, kv // n)
    else:
        heads = (0, h, 0, kv)
    vocab = vocab_range(cfg, rank, n)
    if cfg.num_experts:
        return _moe_layout(cfg, plan, rank, n, heads, vocab)
    if cfg.family == "ssm":
        return ShardLayout(heads, vocab=vocab,
                           ssm_heads=ssm_range(cfg, rank, n))
    rows, enc = _ffn_rows(cfg, plan, rank, n)
    hybrid, encdec = cfg.family == "hybrid", cfg.family == "encdec"
    return ShardLayout(heads, ffn=rows, vocab=vocab,
                       channels=channel_range(cfg, rank, n) if hybrid
                       else (0, 0), enc_ffn=enc if encdec else None)


# ------------------------------------------------------------ placements ----

# the top-level keys of the reference's trees whose leaves stack a layer
# (or group) axis first
STACKED = ("layers", "groups", "enc_layers", "dec_layers")


def stacked(keys: tuple) -> bool:
    """True when the leaf at `keys` stacks a layer axis first."""
    return keys[0] in STACKED


def _under(prefix: tuple, places: dict) -> dict:
    return {prefix + k: v for k, v in places.items()}


def _attn_places(cfg, heads) -> dict:
    q0, nq, k0, nk = heads
    dh, A = cfg.d_head, slice(None)
    out = {(k,): (A, slice(lo * dh, (lo + m) * dh))
           for k, (lo, m) in (("wq", (q0, nq)), ("wk", (k0, nk)),
                              ("wv", (k0, nk)))}
    out["wo", ] = (slice(q0 * dh, (q0 + nq) * dh),)
    return out


def _ffn_places(rows: NeuronRows) -> dict:
    ids = rows.ids
    out = {(k,): (ids,) for k in ("w", "wq", "wsc", "wout")}
    out["pred", "B"] = (slice(None), ids)
    return out


def _ssm_places(cfg, layout: ShardLayout) -> dict:
    """mamba2's layer leaves: d_inner columns of whole heads (wz, wx,
    gn, wo's rows), the heads' columns of wdt and their A_log / D /
    dt_bias; wB, wC and the conv stay whole (a split region reads them,
    through `copy_in`)."""
    h0, nh = layout.ssm_heads
    p, A = cfg.ssm_head_dim, slice(None)
    cols, heads = slice(h0 * p, (h0 + nh) * p), slice(h0, h0 + nh)
    out = {("wz",): (A, cols), ("wx",): (A, cols), ("wdt",): (A, heads),
           ("gn",): (cols,), ("wo",): (cols,)}
    for k in ("A_log", "D", "dt_bias"):
        out[k, ] = (heads,)
    return out


def _rec_places(cfg, layout: ShardLayout) -> dict:
    """An RG-LRU block's leaves: the LRU channels of w_in / w_gate's
    columns, the conv, the gates and w_out's rows, and its FFN rows."""
    ch, A = slice(*layout.channels), slice(None)
    out = {("w_in",): (A, ch), ("w_gate",): (A, ch), ("conv_w",): (A, ch),
           ("conv_b",): (ch,), ("w_out",): (ch,)}
    for k in ("w_r", "b_r", "w_i", "b_i", "lam"):
        out["lru", k] = (ch,)
    return {**out, **_under(("ffn",), _ffn_places(layout.ffn))}


def _block_places(cfg, layout: ShardLayout, kind: str) -> dict:
    if kind == "rec":
        return _rec_places(cfg, layout)
    return {**_under(("attn",), _attn_places(cfg, layout.heads)),
            **_under(("ffn",), _ffn_places(layout.ffn))}


def placements(cfg, layout: ShardLayout) -> dict:
    """{leaf path: index} of the leaves in the reference's tree of `cfg`'s
    family that `layout`'s rank holds a slice of: its part of the whole
    leaf is whole[index], an index being a tuple of slices and 1-D id
    arrays over the leaf's leading dims. Stacked leaves' indices leave
    out the layer axis (`stacked`); the leaves not named stay whole."""
    vocab, A = slice(*layout.vocab), slice(None)
    out = {("embed",): (vocab,), ("lm_head",): (A, vocab)}
    attn = _attn_places(cfg, layout.heads)
    if cfg.family == "ssm":
        out.update(_under(("layers",), _ssm_places(cfg, layout)))
    elif cfg.family == "hybrid":
        period = len(cfg.block_pattern)
        n_groups = cfg.num_layers // period
        for i, kind in enumerate(cfg.block_pattern):
            out.update(_under(("groups", f"b{i}"),
                              _block_places(cfg, layout, kind)))
        for j, kind in enumerate(
                cfg.block_pattern[:cfg.num_layers - n_groups * period]):
            out.update(_under((f"rem{j}",), _block_places(cfg, layout, kind)))
    elif cfg.family == "encdec":
        out.update(_under(("enc_layers", "attn"), attn))
        out.update(_under(("enc_layers", "ffn"), _ffn_places(layout.enc_ffn)))
        for k in ("attn", "xattn"):
            out.update(_under(("dec_layers", k), attn))
        out.update(_under(("dec_layers", "ffn"), _ffn_places(layout.ffn)))
    else:
        out.update(_under(("layers", "attn"), attn))
        if cfg.num_experts:
            e0, ne = layout.experts
            out["layers", "moe", "experts"] = (slice(e0, e0 + ne),
                                               slice(*layout.expert_rows))
            out["layers", "moe", "shared", "w"] = (slice(*layout.shared),)
        else:
            out.update(_under(("layers", "ffn"), _ffn_places(layout.ffn)))
    return out


def places_under(places: dict, prefix: tuple) -> dict:
    """The entries of `placements` below `prefix`, keyed by the rest of
    their path (the leaves of one module)."""
    k = len(prefix)
    return {p[k:]: v for p, v in places.items() if p[:k] == prefix}


def cut_shape(shape, index) -> tuple:
    """The shape of whole[index] for a whole leaf of `shape` (index as
    `placements` gives it; None keeps the whole shape)."""
    out = list(shape)
    for d, i in enumerate(index or ()):
        out[d] = len(range(*i.indices(shape[d]))) \
            if isinstance(i, slice) else len(i)
    return tuple(out)


# -------------------------------------------------------------- launch ----

def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)


def init_world(rank: int, world: int, init_method: str,
               device=None) -> ShardGroup:
    """Join a gloo group of `world` ranks at `init_method` (`file://`
    path or `tcp://host:port`) as `rank`; the world's ShardGroup."""
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world, timeout=_timeout())
    return ShardGroup(rank, world, dist.group.WORLD,
                      torch.device(device or "cpu"), tuple(range(world)))


def _rank_main(fn, rank, world, init_method, device, threads, results,
               args):
    """One spawned rank: join the world, run fn(world_group, *args) and
    report ("ok", rank, result) or ("error", rank, traceback)."""
    # ranks of one host meet on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if threads:
        torch.set_num_threads(threads)
    try:
        shard = init_world(rank, world, init_method, device)
        out = fn(shard, *args)
        dist.destroy_process_group()
        results.put(("ok", rank, out))
    except Exception:
        results.put(("error", rank, traceback.format_exc()))
        raise


def spawn(fn, world: int, *args, device=None, timeout: float = 600.0,
          threads: Optional[int] = 1) -> list:
    """Run fn(shard, *args) on `world` ranks, each a fresh process (the
    `spawn` start method) in one gloo group on `device` (default cpu;
    the ranks may share one CUDA card). Returns each rank's result, in
    rank order. A rank that raises or dies, or a run past `timeout`
    seconds, ends every rank and raises here. `fn` and `args` are
    pickled: fn must be a module-level function; `threads` caps each
    rank's intra-op threads (None leaves torch's default)."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_dist_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, init, device, threads, results,
                               args))
             for r in range(world)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world:
            try:
                kind, rank, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       f"result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} "
                                       f"ran past {timeout} s")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                   f"failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
