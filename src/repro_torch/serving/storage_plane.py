"""Storage plane of the serving stack (DESIGN.md §2).

Everything below the activation trace lives here: the segmented
NeuronCache, the bundled ColdStore, the analytic compute/I-O pricing at
deployment-size constants (TimingProfile), the neuron-cluster pipeline
simulator, and the single-I/O-thread PrefetchExecutor that overlaps
next-layer miss fetches with current-layer pricing (paper §4.3: compute
of one matrix overlaps I/O of the next).

The plane's public surface is deliberately narrow:

    plane.step(trace, plan, batch, ctx) -> TokenStats

where `trace` is the real per-layer activation trace produced by the
data plane: (G, kc) selected cold-cluster ids per layer for the dense
families, (E,) kept-dispatch expert counts for MoE (or the two-level
(E, 1+ncc) intra-expert form). The orchestrator (serving/engine.py)
never touches cache/coldstore internals.

This is the port's copy of `repro/serving/storage_plane.py`, its logic
unchanged. Everything family-specific (the flat neuron space, the
bundled weight tensors, the trace -> neuron-id mapping and shard
ownership) lives in a storage view: `FFNStorageView` for dense and vlm,
`MoEStorageView` for moe. Bundles are read from the port's model as
numpy arrays.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np

from repro_torch import obs
from repro_torch.core.cache import NeuronCache
from repro_torch.core.clusters import HybridPlan
from repro_torch.core.coldstore import ColdStore
from repro_torch.core.io_model import StorageModel, UFS40
from repro_torch.core.pipeline import ClusterTask, PrefetchExecutor, \
    simulate_pipeline
from repro_torch.core.planner import HardwareProfile
from repro_torch.quant.quantize import bundle_nbytes
from repro_torch.quant.storage import plan_storage_dtype


# ----------------------------------------------------- family views ----

class FFNStorageView:
    """Dense-family (dense / vlm backbone) neuron space: the bundled
    (N, R, D) FFN tensor, N = cfg.d_ff, clusters of
    sparse_ffn.cluster_size neurons after the hot-first permutation."""

    def __init__(self, cfg):
        from repro_torch.core.sparse_ffn import ffn_rows
        self.cfg = cfg
        self.n_neurons = cfg.d_ff
        self.cluster_size = cfg.sparse_ffn.cluster_size
        self.rows = ffn_rows(cfg.activation)

    def bundles(self, model):
        """Per-layer (N, R, D) bundles as host numpy arrays (fp32)."""
        return [layer.ffn.w.detach().float().cpu().numpy()
                for layer in model.layers]

    def deploy_neurons(self, timing) -> float:
        """Deployment-size flat neuron count per layer (streamed once
        during prefill; the dense-everything compute unit)."""
        return timing.d_ff

    def deploy_prefill_neurons(self, timing) -> float:
        """Per-token FFN compute neurons during prefill."""
        return timing.d_ff

    def trace_cold_ids(self, trace_l, plan: HybridPlan):
        """Map one layer's (G, kc) group-relative cluster trace to
        global cold neuron ids (hot-first permuted space). The
        *stepped* plan's hot prefix anchors the mapping — the trace's
        cluster ids are relative to it, not to the batch-1 plan's."""
        cs, N = self.cluster_size, self.n_neurons
        n_hot = plan.n_hot
        tr = np.asarray(trace_l)
        if tr.ndim < 2:
            tr = tr.reshape(1, -1)
        G = tr.shape[0]
        nc_g = max((N - n_hot) // cs // G, 1)
        glob = tr.reshape(G, -1) + np.arange(G)[:, None] * nc_g
        ids = np.unique(glob.reshape(-1))
        cold = (n_hot
                + (ids[:, None] * cs + np.arange(cs)[None]).reshape(-1))
        return cold[cold < N]

    def hot_ids(self, trace_l, plan: HybridPlan):
        """The stepped plan's hot set — streamed through the LRU by
        systems without a pinned hot region (spec.pinned_hot=False)."""
        return np.arange(plan.n_hot)

    def warm_cold_ids(self, n_hot: int, count: int):
        """Most-frequent cold ids (hot-first space: the cold region
        starts right after the plane's pinned prefix) used to pre-warm
        each shard's cold cache."""
        return np.arange(n_hot, min(n_hot + count, self.n_neurons))

    def owner_of(self, ids, plan: HybridPlan, n_shards: int):
        """Owning device shard per neuron id, following the plan's
        compute sharding: the cold region splits by *group* (each
        device owns G/n whole groups — `_cold_path_shard_map`'s
        layout) and the hot prefix splits uniformly. Without a plan
        (or when groups don't divide), cluster-strided round-robin."""
        ids = np.asarray(ids)
        n, cs, N = n_shards, self.cluster_size, self.n_neurons
        owner = (ids // cs) % n
        if plan is not None and plan.groups >= n and plan.groups % n == 0:
            G = plan.groups
            width = max((N - plan.n_hot) // G, 1)
            g_loc = G // n
            owner = np.where(
                ids >= plan.n_hot,
                np.minimum((ids - plan.n_hot) // width, G - 1) // g_loc,
                (ids * n) // max(plan.n_hot, 1))
        return owner


class MoEStorageView:
    """MoE flat neuron space [shared experts | routed experts], each
    routed expert a contiguous f-row block.

    Whole-expert mode (cfg.moe_intra_expert=False): one cluster per
    routed expert (cluster_size = d_ff); the trace is the per-layer
    kept-dispatch counts (E,), and an expert with count > 0 fetches its
    d_ff neuron bundles.

    Two-level mode: each expert's rows are hot-first (prepare_params
    applied the plan's per-expert permutation, so flat id == physical
    row) and the cluster unit is sparse_ffn.cluster_size. The trace is
    (E, 1+ncc): column 0 the kept-dispatch counts, columns 1.. the real
    activation counts per cold cluster; only the activated experts'
    active cold clusters pay cold-store I/O, every expert's hot prefix
    (and the shared experts) is pinned via the plan's n_pinned.

    Shard ownership is expert-parallel: shard s owns ceil(E/n)
    contiguous routed-expert blocks plus a uniform share of the shared
    prefix."""

    def __init__(self, cfg):
        from repro_torch.core.sparse_ffn import ffn_rows
        self.cfg = cfg
        self.f = cfg.d_ff
        self.E = cfg.num_experts
        self.n_shared = cfg.num_shared_experts
        self.S = cfg.num_shared_experts * cfg.d_ff
        self.n_neurons = cfg.moe_flat_neurons
        self.intra = bool(cfg.moe_intra_expert)
        self.cluster_size = cfg.sparse_ffn.cluster_size if self.intra \
            else cfg.d_ff
        self.rows = ffn_rows(cfg.activation)

    def bundles(self, model):
        """Per-layer [shared | routed] (N, R, D) bundles as host numpy
        arrays (fp32), copied to the host before the widening."""
        out = []
        for layer in model.layers:
            moe = layer.moe
            ex = moe.experts.detach().cpu().float().numpy()
            E, f, R, D = ex.shape
            flat = ex.reshape(E * f, R, D)
            if moe.shared is not None:
                sh = moe.shared.detach().cpu().float().numpy()
                flat = np.concatenate([sh, flat], axis=0)
            out.append(flat)
        return out

    def deploy_neurons(self, timing) -> float:
        # timing.d_ff is the deployment per-expert width; the expert
        # count is the data plane's (only widths rescale, like layers)
        return timing.d_ff * (self.n_shared + self.E)

    def deploy_prefill_neurons(self, timing) -> float:
        # per-token prefill compute: shared + routed top-k experts
        return timing.d_ff * (self.n_shared + self.cfg.experts_per_token)

    def _expert_hot(self, plan: HybridPlan) -> int:
        return plan.n_expert_hot if plan is not None else 0

    def trace_cold_ids(self, trace_l, plan: HybridPlan):
        """Flat cold neuron ids for one layer's trace. A trace whose
        shape disagrees with the stepped plan (wrong expert count, wrong
        cold-cluster count for the plan's n_expert_hot) raises: the data
        plane and the plan disagree about the neuron space, and dropping
        ids would hide it as under-priced I/O."""
        tr = np.asarray(trace_l)
        S, f, E, cs = self.S, self.f, self.E, self.cluster_size
        n_hot_e = self._expert_hot(plan)
        if n_hot_e:
            ncc = (f - n_hot_e) // cs
            if tr.shape != (E, 1 + ncc):
                raise ValueError(
                    f"two-level MoE trace shape {tr.shape} does not "
                    f"match the stepped plan: expected (E, 1+ncc) = "
                    f"({E}, {1 + ncc}) for n_expert_hot={n_hot_e}, "
                    f"cluster_size={cs}, d_ff={f}")
            act_e, act_c = np.nonzero(tr[:, 1:] > 0)
            ids = (S + act_e[:, None] * f + n_hot_e
                   + act_c[:, None] * cs
                   + np.arange(cs)[None]).reshape(-1)
        else:
            counts = tr.reshape(-1)
            if counts.shape[0] != E:
                raise ValueError(
                    f"MoE expert trace has {counts.shape[0]} entries "
                    f"for {E} experts — the trace and the plan "
                    f"disagree about the expert space")
            act = np.nonzero(counts > 0)[0]
            ids = (S + act[:, None] * f
                   + np.arange(f)[None]).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_neurons):
            raise ValueError(
                f"MoE trace maps outside the flat neuron space "
                f"[0, {self.n_neurons}) — ids span "
                f"[{ids.min()}, {ids.max()}]")
        return ids

    def hot_ids(self, trace_l, plan: HybridPlan):
        """The stepped hot set for systems without a pinned region: the
        shared prefix plus, in two-level mode, the hot rows of the
        experts the trace shows activated."""
        n_hot_e = self._expert_hot(plan)
        if not n_hot_e:
            return np.arange(self.S)
        tr = np.asarray(trace_l)
        act = np.nonzero(tr[:, 0] > 0)[0]
        hot = (self.S + act[:, None] * self.f
               + np.arange(n_hot_e)[None]).reshape(-1)
        return np.concatenate([np.arange(self.S), hot])

    def warm_cold_ids(self, n_hot: int, count: int):
        """Pre-warm ids for the cold caches. Whole-expert mode is flat
        after the shared prefix, as the dense view; two-level mode
        interleaves experts offset-major (the first cold cluster of every
        expert is more frequent than any second one)."""
        if not self.intra:
            return np.arange(n_hot, min(n_hot + count, self.n_neurons))
        # the per-expert pinned width, from the plane's pinned prefix
        # (n_hot = S + E*n_hot_e, possibly capacity-capped)
        n_hot_e = max((n_hot - self.S) // max(self.E, 1), 0)
        offs = np.arange(self.f - n_hot_e)
        grid = (self.S + np.arange(self.E)[None, :] * self.f + n_hot_e
                + offs[:, None])                    # (n_cold_e, E)
        return grid.reshape(-1)[:count]

    def owner_of(self, ids, plan: HybridPlan, n_shards: int):
        """Owning shard per flat id: contiguous expert blocks of ceil(E/n)
        experts, the last clamped when E does not divide, and a uniform
        split of the shared prefix."""
        ids = np.asarray(ids)
        n, S = n_shards, self.S
        e_loc = max(-(-self.E // n), 1)             # ceil: clamped blocks
        expert = (ids - S) // self.f
        return np.where(
            ids >= S,
            np.minimum(expert // e_loc, n - 1),
            (ids * n) // max(S, 1))


_VIEW_FAMILIES = {"dense": FFNStorageView, "vlm": FFNStorageView,
                  "moe": MoEStorageView}


def make_storage_view(cfg):
    """Family-keyed storage view (the plane half of the serving
    family registry — serving/families.py holds the data-plane half)."""
    if cfg.family not in _VIEW_FAMILIES:
        raise ValueError(
            f"no storage view for family {cfg.family!r}; "
            f"storable families: {sorted(_VIEW_FAMILIES)}")
    return _VIEW_FAMILIES[cfg.family](cfg)


@dataclass(frozen=True)
class TimingProfile:
    """Cost constants for the storage plane.

    The engine's data plane runs the (reduced) model for real; the
    storage plane prices compute and I/O at the *deployment-size*
    model's constants so compute/I-O ratios land in the paper's regime
    (e.g. bamboo-7b FP16: 24KB Gate-Up-Down bundles — exactly §4.4).
    Defaults derive from the engine's own config.
    """
    d_model: int
    d_ff: int
    num_heads: int
    num_kv_heads: int
    d_head: int
    num_layers: int
    rows: int = 3
    itemsize: int = 2

    @classmethod
    def from_config(cls, cfg, rows):
        return cls(d_model=cfg.d_model, d_ff=cfg.d_ff,
                   num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                   d_head=cfg.d_head, num_layers=cfg.num_layers, rows=rows)

    @property
    def bundle_bytes(self):
        return self.rows * self.d_model * self.itemsize


@dataclass
class ShardStats:
    """Per-device slice of one decode step's storage accounting."""
    compute_s: float
    io_s: float
    effective_s: float
    cache_hit_rate: float
    n_miss: int


@dataclass
class TokenStats:
    compute_s: float       # critical-path (max-over-shards) compute
    io_s: float            # raw (unpipelined) I/O demand, worst shard
    effective_s: float     # after pipeline composition, max over shards
    cache_hit_rate: float  # aggregate over every shard's cache
    n_miss: int            # summed across shards
    batch: int
    n_shards: int = 1
    io_total_s: float = 0.0   # summed raw demand (aggregate traffic)
    shards: list = None       # per-shard ShardStats when n_shards > 1
    # 'data'-axis row that produced this step. Each replica owns a
    # whole StoragePlane (per-replica caches/channels are the same
    # per-shard machinery at dp granularity), so the plane itself
    # never sets this; the routing engine annotates it when merging
    # per-replica timelines into one ServeReport (DESIGN.md §5).
    replica: int = 0


class StoragePlane:
    """Cache + cold store + pipeline pricing behind one `step()` call."""

    def __init__(self, cfg, params, plan, *, spec, storage: StorageModel
                 = UFS40, offload_ratio: float = 0.5,
                 hw: HardwareProfile = None, timing: TimingProfile = None,
                 n_compute_workers: int = 4, prefetch: bool = True,
                 n_shards: int = 1, n_replicas: int = 1, view=None):
        self.cfg = cfg
        self.spec = spec
        self.hw = hw or plan.hardware
        self.n_workers = n_compute_workers
        self.offload_ratio = offload_ratio
        # Data-parallel accounting (DESIGN.md §5/§9): the host memory
        # budget is one per machine, not one per replica — a plane that
        # serves one of n_replicas 'data'-axis rows gets a 1/n share of
        # the resident-neuron budget, the same way the 'model' axis
        # splits each cache below. Total residency across replicas
        # therefore never exceeds the single-engine budget.
        self.n_replicas = max(int(n_replicas), 1)
        # Tensor-parallel accounting: device s owns the contiguous
        # neuron slice [s*N/n, (s+1)*N/n) — the same row split the mesh
        # 'model' axis applies to the bundled FFN tensor — with its own
        # NeuronCache slice and its own storage channel.
        self.n_shards = max(int(n_shards), 1)

        # family view: flat neuron space, bundles, trace mapping,
        # shard ownership (FFNStorageView / MoEStorageView)
        self.view = view or make_storage_view(cfg)
        self.cs = self.view.cluster_size
        N = self.view.n_neurons
        self.N = N
        self.timing = timing or TimingProfile.from_config(
            cfg, self.view.rows)
        # scale factors: storage-plane costs priced at deployment size
        # while traces come from the (possibly reduced) data-plane model
        self.neuron_scale = self.view.deploy_neurons(self.timing) / N
        self.layer_scale = self.timing.num_layers / cfg.num_layers
        bundles = self.view.bundles(params)
        # Storage-dtype pricing (§7.6 + §4.4): the plan declares how
        # cold bundles live on the slow tier; every byte count below —
        # cold-store reads, cache residency, prefill streaming — prices
        # the declared dtype at deployment-size constants. fp16 keeps
        # the legacy unpadded rows*d_model*itemsize accounting exactly.
        self.storage_dtype = plan_storage_dtype(plan)
        qb = bundle_nbytes(self.timing.d_model, self.storage_dtype,
                           rows=self.timing.rows,
                           itemsize=self.timing.itemsize)
        self.coldstore = ColdStore(bundles, storage=storage,
                                   two_phase=spec.two_phase,
                                   block_size=24576 if spec.use_bundling
                                   else 4096,
                                   bundle_bytes_override=qb,
                                   count_scale=self.neuron_scale)
        self.bundle_bytes = self.coldstore.bundle_bytes()

        # memory budget: resident = (1-offload)*N neurons per layer.
        # With a pinned hot region (§4.2, PowerInfer-2) the budget splits
        # between hot prefix and cold LRU (hot may not starve cold below
        # its per-token working set). Baseline systems stream *all*
        # activated neurons (hot included) through one LRU cache, with
        # bundling-redundancy derating (spec.cache_efficiency).
        resident = int(N * (1.0 - offload_ratio)) // self.n_replicas
        plan1 = plan.plan_for_batch(1)
        # Quantized cold bundles stretch the same host-byte budget over
        # fp_bytes/q_bytes x more cold neurons (~3-4x at int4-mixed);
        # the pinned hot prefix stays fp on the NPU, so only the cold
        # LRU scales — capped at the neurons that actually exist.
        ratio = self.timing.bundle_bytes / self.bundle_bytes
        if spec.pinned_hot:
            hot_cap = (resident // 2) // self.cs * self.cs
            # two-level MoE plans pin every expert's hot prefix
            # (plan.n_pinned), not just the per-step computed hot
            self.n_hot = min(plan1.resident_hot, max(hot_cap, self.cs))
            cold_per_layer = min(
                int(max(resident - self.n_hot, self.cs) * ratio),
                max(N - self.n_hot, self.cs))
            cold_capacity = cold_per_layer * cfg.num_layers
        else:
            self.n_hot = 0
            cold_capacity = min(
                int(max(int(resident * spec.cache_efficiency),
                        self.cs) * ratio), N) * cfg.num_layers
        # the hot prefix is pinned (fixed region); the LRU capacity below
        # is entirely the cold region. One segmented cache *per device
        # shard*, each a 1/n miniature of the single-device cache:
        # ownership follows the compute sharding (every device owns its
        # share of the hot prefix plus its own cold groups — see
        # _split_by_owner), so cold traffic splits uniformly and so
        # does capacity. Per-device miss traffic shrinks with the mesh
        # instead of replicating the whole LRU.
        self.caches = [
            NeuronCache(cfg.num_layers, N, self.cs,
                        capacity_neurons=max(
                            cold_capacity // self.n_shards, self.cs),
                        hot_fraction=0.0,
                        bytes_per_neuron=self.bundle_bytes)
            for _ in range(self.n_shards)]
        # warm each shard's cold cache with its most-frequent cold
        # slice (the family view orders the cold space — flat after
        # the pinned prefix for dense/whole-expert, expert-interleaved
        # for two-level MoE)
        per_layer = cold_capacity // cfg.num_layers
        for l in range(cfg.num_layers):
            ids = self.view.warm_cold_ids(self.n_hot, per_layer)
            for s, part in enumerate(self._split_by_owner(ids, plan1)):
                self.caches[s].admit_cold(l, list(part))
        for c in self.caches:
            c.stats.reset()
        self.coldstore.reset_stats()
        # ONE I/O thread (single UFS command queue, §4.3): layer l+1's
        # misses are fetched while layer l is being priced. The thread
        # is non-daemon, so tie its shutdown to this plane's lifetime —
        # engines are created freely in benchmarks and must not
        # accumulate idle executors.
        self.prefetcher = PrefetchExecutor() if prefetch else None
        if self.prefetcher is not None:
            self._finalizer = weakref.finalize(
                self, PrefetchExecutor.shutdown, self.prefetcher)

    # ------------------------------------------------- shard ownership ----
    @property
    def cache(self):
        """Shard 0's cache — the whole cache when n_shards == 1."""
        return self.caches[0]

    @property
    def resident_capacity_neurons(self) -> int:
        """Modeled resident footprint of this plane in neurons: the
        pinned hot prefix across every layer plus each shard's cold
        LRU capacity. Replica budgeting (DESIGN.md §9) guarantees the
        sum over a routed engine's replicas stays within one engine's
        budget."""
        return self.n_hot * self.cfg.num_layers \
            + sum(c.capacity for c in self.caches)

    def _split_by_owner(self, neuron_ids, plan: HybridPlan = None):
        """Partition global neuron ids by owning device shard,
        following the compute sharding the family view declares —
        dense: the plan's G/n cold groups per device + uniform hot
        split (`_cold_path_shard_map`'s layout, so per-step cold
        traffic is balanced by construction); moe: E/n contiguous
        routed experts per device (`_moe_ep_shard_map`'s layout).
        Bucket switches move the hot/cold boundary, so a neuron near
        it can migrate shards and miss once in its new cache — the
        modeled cost of the resharding collective the mesh pays on an
        executable swap."""
        ids = np.asarray(neuron_ids)
        n = self.n_shards
        if n == 1:
            return [ids]
        owner = self.view.owner_of(ids, plan, n)
        return [ids[owner == s] for s in range(n)]

    # ---------------------------------------------------- timing model ----
    def _ffn_flops_token(self, plan: HybridPlan):
        t = self.timing
        per_neuron = 2 * t.rows * t.d_model
        hot = plan.n_hot * self.neuron_scale * per_neuron
        cold = plan.total_cold * self.neuron_scale * per_neuron
        return hot, cold

    def _attn_flops_token(self, ctx_len: float):
        t = self.timing
        return 4 * t.num_heads * t.d_head * ctx_len \
            + 4 * t.d_model * (t.num_heads + 2 * t.num_kv_heads) * t.d_head

    def _attn_frac(self) -> float:
        """Attention's per-device share: heads shard over 'model' when
        they divide (the KV arena's layout); otherwise replicated."""
        if self.n_shards > 1 and self.timing.num_heads % self.n_shards == 0 \
                and self.timing.num_kv_heads % self.n_shards == 0:
            return 1.0 / self.n_shards
        return 1.0

    def _compute_time(self, plan: HybridPlan, batch: int, ctx_len: float,
                      shard_frac: float = 1.0):
        """Per-device compute seconds: FFN flops scale with the device's
        neuron-slice fraction, attention with the head split."""
        hot_f, cold_f = self._ffn_flops_token(plan)
        hot_f, cold_f = hot_f * shard_frac, cold_f * shard_frac
        L = self.timing.num_layers
        attn = self._attn_flops_token(ctx_len) * L * batch \
            * (self._attn_frac() if shard_frac < 1.0 else 1.0)
        if self.spec.hybrid_engines:
            # hot on the dense engine, cold on the sparse path, overlapped
            t_ffn = max(hot_f / self.hw.dense_engine_flops,
                        cold_f / self.hw.sparse_engine_flops) * L * batch
        elif self.spec.use_predictor:
            t_ffn = (hot_f + cold_f) / self.hw.sparse_engine_flops * L * batch
        else:
            # dense everything (llama.cpp): every flat neuron (all
            # experts, for moe) on the sparse engine
            t_ffn = (self.view.deploy_neurons(self.timing) * shard_frac
                     * 2 * self.timing.rows * self.timing.d_model) \
                / self.hw.sparse_engine_flops * L * batch
        return t_ffn + attn / self.hw.dense_engine_flops

    def prefill_cost(self, prompt_len: int, batch: int = 1) -> float:
        """Modeled prefill seconds (§4.1.1: NPU-centric dense prefill;
        every non-resident layer slice streams once at sequential
        bandwidth, overlapped with dense compute). Each device streams
        and computes only its neuron slice (for moe: its expert slice
        streams, but per-token compute touches only shared + top-k)."""
        t = self.timing
        flat = self.view.deploy_neurons(t)
        n_off = int(flat * self.offload_ratio) // self.n_shards
        io = self.coldstore.storage.read_time(
            n_off * self.bundle_bytes * t.num_layers, 524288, random=False)
        ffn = self.view.deploy_prefill_neurons(t) * 2 * t.rows * t.d_model \
            / self.n_shards
        attn = self._attn_flops_token(prompt_len / 2.0) * self._attn_frac()
        comp = (ffn + attn) * t.num_layers * prompt_len * batch \
            / self.hw.dense_engine_flops
        return max(io, comp)

    # ------------------------------------------------------- pricing ----
    def _fetch_shard(self, l: int, misses) -> float:
        """Cold-store I/O for one shard's misses in one layer. Returns
        modeled seconds on that shard's storage channel."""
        spec = self.spec
        if not len(misses):
            return 0.0
        misses = list(misses)
        if spec.use_bundling:
            gate_active = np.random.default_rng(l).random(
                len(misses)) < 0.8 if spec.two_phase else None
            return self.coldstore.price(l, misses, gate_active).io_time
        # unbundled: R scattered 4KB-class reads per neuron
        # (paper §4.4 — this is what bundling removes)
        R = self.timing.rows
        per = self.bundle_bytes // R
        nbytes = int(per * len(misses) * R * self.neuron_scale)
        io_l = self.coldstore.storage.read_time(
            nbytes, min(4096, per), random=True)
        self.coldstore.total_bytes += nbytes
        self.coldstore.total_io_time += io_l
        return io_l

    def _fetch_layer(self, l: int, misses_per_shard) -> list:
        """One layer's miss fetches, every shard (runs as one job on
        the I/O thread when prefetch is on). Returns per-shard modeled
        seconds — each device has its own storage channel, so the times
        are independent even though the modeled fetches run serially."""
        return [self._fetch_shard(l, m) for m in misses_per_shard]

    def _trace_neuron_ids(self, trace_l, plan: HybridPlan):
        """Map one layer's activation trace to global cold neuron ids
        — the family view interprets its own trace shape against the
        *stepped* plan (dense: (G, kc) group-relative cluster ids;
        moe: (E,) kept-dispatch counts or the two-level (E, 1+ncc)
        form). A trace that disagrees with the plan's shape raises
        instead of silently under-pricing."""
        return self.view.trace_cold_ids(trace_l, plan)

    def step(self, trace, plan: HybridPlan, batch: int,
             ctx_len: float) -> TokenStats:
        """Price one decode step given the real cluster trace
        `trace` (L, G, kc) from the data plane.

        With n_shards > 1 every phase is per-device: each shard looks
        up its own cache slice, fetches its own misses on its own
        channel, and runs its own cluster pipeline over its share of
        the compute; the step's effective time is the slowest shard
        (the psum barrier at each layer's output keeps devices in
        lock-step at layer granularity)."""
        with obs.span("plane.step"):
            S = self.n_shards
            comp_shard = self._compute_time(plan, batch, ctx_len,
                                            shard_frac=1.0 / S)
            base = [(c.stats.hits, c.stats.misses) for c in self.caches]
            with obs.span("plane.lookup"):
                per_layer = self._lookup(trace, plan)
            with obs.span("plane.price"):
                tasks, io_raw = self._price(per_layer, comp_shard)
            with obs.span("plane.simulate"):
                return self._simulate(tasks, io_raw, comp_shard, base,
                                      batch)

    def _lookup(self, trace, plan: HybridPlan) -> list:
        """Phase 1 — cache lookups, strictly in layer order (the LRU
        state sequence is part of the modeled behavior), shard-split.
        Per layer: (ids per shard, misses per shard)."""
        spec = self.spec
        per_layer = []
        for l in range(self.cfg.num_layers):
            if spec.use_predictor:
                cold_ids = self._trace_neuron_ids(trace[l], plan)
                if spec.pinned_hot:
                    neuron_ids = cold_ids       # hot prefix pinned: no I/O
                else:
                    # activated set = hot set + selected cold, all
                    # streamed through the single cache
                    neuron_ids = np.concatenate(
                        [self.view.hot_ids(trace[l], plan), cold_ids])
            else:
                neuron_ids = np.arange(self.N)       # dense: everything
            parts = self._split_by_owner(neuron_ids, plan)
            misses_ps, n_ids_ps = [], []
            for s, part in enumerate(parts):
                if spec.use_cache:
                    _, misses = self.caches[s].lookup_cold(l, part)
                    self.caches[s].admit_cold(l, misses)
                else:
                    misses = list(part)
                misses_ps.append(misses)
                n_ids_ps.append(len(part))
            per_layer.append((n_ids_ps, misses_ps))
        return per_layer

    def _price(self, per_layer: list, comp_shard: float):
        """Phase 2 — fetch + price. With the prefetcher, layer l+1's
        misses are submitted to the I/O thread before layer l's fetch
        is consumed, so real data movement overlaps pricing; the
        modeled per-layer I/O times are identical either way. Returns
        (cluster tasks per shard, raw I/O seconds per shard)."""
        L, S, cs = self.cfg.num_layers, self.n_shards, self.cs
        futures = {}
        if self.prefetcher is not None:
            futures[0] = self.prefetcher.submit(
                self._fetch_layer, 0, per_layer[0][1])
        tasks = [[] for _ in range(S)]
        io_raw = [0.0] * S
        comp_per_matrix = comp_shard / L
        for l in range(L):
            n_ids_ps, misses_ps = per_layer[l]
            if self.prefetcher is not None:
                if l + 1 < L:
                    futures[l + 1] = self.prefetcher.submit(
                        self._fetch_layer, l + 1, per_layer[l + 1][1])
                with obs.span("plane.io_wait"):
                    io_ps = futures.pop(l).result()
            else:
                io_ps = self._fetch_layer(l, misses_ps)
            for s in range(S):
                # price the trace's L_reduced layers at deployment depth
                io_l = io_ps[s] * self.layer_scale
                io_raw[s] += io_l
                n_miss_clusters = max(len(misses_ps[s]) // cs, 0)
                n_clusters = max(n_ids_ps[s] // cs, 1)
                comp_c = comp_per_matrix / n_clusters
                io_c = io_l / max(n_miss_clusters, 1) if io_l else 0.0
                for c in range(n_clusters):
                    tasks[s].append(ClusterTask(
                        l, c, comp_c,
                        io_c if c < n_miss_clusters else 0.0))
        return tasks, io_raw

    def _simulate(self, tasks, io_raw, comp_shard: float, base: list,
                  batch: int) -> TokenStats:
        """Phase 3 — each shard's cluster pipeline and cache counts; the
        step's TokenStats."""
        spec, S = self.spec, self.n_shards
        shards = []
        for s in range(S):
            if spec.pipeline == "none":
                eff_s = comp_shard + io_raw[s]
            else:
                eff_s = simulate_pipeline(tasks[s], n_compute=self.n_workers,
                                          policy=spec.pipeline).makespan
            d_hits = self.caches[s].stats.hits - base[s][0]
            d_miss = self.caches[s].stats.misses - base[s][1]
            seen = d_hits + d_miss
            shards.append(ShardStats(
                compute_s=comp_shard, io_s=io_raw[s], effective_s=eff_s,
                cache_hit_rate=1.0 if seen == 0 else d_hits / seen,
                n_miss=d_miss))
        tot_hits = sum(self.caches[s].stats.hits - base[s][0]
                       for s in range(S))
        tot_miss = sum(sh.n_miss for sh in shards)
        seen = tot_hits + tot_miss
        return TokenStats(
            compute_s=comp_shard,
            io_s=max(sh.io_s for sh in shards),
            effective_s=max(sh.effective_s for sh in shards),
            cache_hit_rate=1.0 if seen == 0 else float(tot_hits / seen),
            n_miss=tot_miss, batch=batch, n_shards=S,
            io_total_s=float(sum(sh.io_s for sh in shards)),
            shards=shards if S > 1 else None)

    def close(self):
        if self.prefetcher is not None:
            self.prefetcher.shutdown()
            self.prefetcher = None
