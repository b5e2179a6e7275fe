"""PowerInfer-2 serving engine — the thin orchestrator.

Counterpart of `repro/serving/engine.py`, its mesh a group of ranks
(`repro_torch.parallel`). Three layers:

* **Data plane** — numerically real: one decode step per batch bucket
  (core/adaptation.BucketedDecoder), on a CUDA card one captured CUDA
  graph per bucket, runs the hybrid hot/cold FFN and returns, besides
  logits, the per-layer cold-cluster selections (the activation trace).
* **Storage plane** (serving/storage_plane.py) — the trace drives the
  segmented NeuronCache and the bundled ColdStore; I/O time comes from
  the StorageModel and per-token effective latency from the
  neuron-cluster pipeline simulator. These latencies are *modeled*.
* **Scheduler** (serving/scheduler.py) — request-level continuous
  batching: admission queue, per-step admission up to the decoder's next
  bucket boundary, prefill-on-admit, completion.

submit()/step()/run_until_drained() drive requests through the slot
KV arena; generate() is the static-batch wrapper over the same loop.

The engine runs on the model's device. A step feeds the bucket's graph
through static device buffers (tokens, live mask, the arena's views) and
copies its outputs out; sampling and the two host reads (the sampled
tokens, the trace) stay outside the graph.

Data parallel on one device (`dp=N`): the engine becomes a replica
router over N ordinary dp=1 engines, the reference's meshless replicas.
Each has its own scheduler, KV arena, storage plane (a 1/N share of the
resident neuron cache), generator seeded with the same seed, modeled
clock and decode steps, its CUDA graphs and their memory pool included:
a captured graph binds to one engine's arena and buffers. The replicas
share the model's weights and nothing captured. The step with the
earliest next event on the shared timeline runs next.

Tensor / expert parallel (`shard`, a ShardGroup of n > 1 ranks, each
process holding its rank's slice of the model): every rank runs the same
scheduler and storage plane (`n_shards = n`), which stay identical since
they see the same submits and the same gathered trace; rank 0 of the
group samples each step's tokens and broadcasts them, so the ranks
cannot drift apart. Gloo collectives cannot be captured, so such an
engine steps eagerly (`graph_policy` says why).

dp x tp/ep (`dp=N` with a `shard` of N*tp ranks): every rank holds the
router and every replica's scheduler and storage plane; replica r's
steps run on ranks [r*tp, (r+1)*tp) (`parallel.replica_groups`), whose
first rank then broadcasts the step's tokens and trace to the world, so
every rank's copy of replica r (a mirror on the other ranks: scheduler,
plane and clock without a data plane) and every router agree.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adaptation import BucketedDecoder, bucket_for, \
    stepped_plan
from repro_torch.core.baselines import SystemSpec, POWERINFER2
from repro_torch.core.io_model import StorageModel, UFS40
from repro_torch.core.planner import ExecutionPlan, HardwareProfile
from repro_torch.models import dense
from repro_torch.models.kv_cache import KVSlotArena
from repro_torch.models.modules import dtype_of
from repro_torch.parallel import replica_groups
from repro_torch.serving.families import serving_family
from repro_torch.serving.sampler import sample_tokens
from repro_torch.serving.scheduler import BatchScheduler, ReplicaRouter
from repro_torch.serving.storage_plane import StoragePlane, TimingProfile, \
    TokenStats

__all__ = ["ServeEngine", "GenerationResult", "ServeReport", "StepResult",
           "TimingProfile", "TokenStats"]


def _percentiles(lat: np.ndarray) -> dict:
    """Latency percentile summary; empty input yields zeros."""
    if lat.size == 0:
        return {"mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
    return {"mean": float(lat.mean()),
            "p50": float(np.percentile(lat, 50)),
            "p90": float(np.percentile(lat, 90)),
            "p99": float(np.percentile(lat, 99))}


@dataclass
class GenerationResult:
    tokens: np.ndarray                 # (B, new)
    stats: list                        # TokenStats per step
    wall_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        total = sum(s.effective_s for s in self.stats)
        n = sum(s.batch for s in self.stats)
        return n / total if total else 0.0

    def latency_percentiles(self):
        return _percentiles(np.array([s.effective_s for s in self.stats]))


@dataclass
class StepResult:
    """Outcome of one continuous-batching decode step."""
    stats: TokenStats
    tokens: dict                       # uid -> generated token
    admitted: list = field(default_factory=list)
    finished: list = field(default_factory=list)
    replica: int = 0                   # the replica that stepped
    t_s: float = 0.0                   # that replica's clock after the step


@dataclass
class ServeReport:
    """Aggregate serving metrics over a drained request stream. Times
    are on the modeled clock: `throughput_tok_s` is the span-based rate,
    `tokens_per_s` the sum-of-step-latency (pipeline) rate."""
    stats: list                        # TokenStats per step
    requests: list                     # finished Requests
    span_s: float = 0.0                # drained span on the modeled clock

    @property
    def total_tokens(self) -> int:
        return sum(s.batch for s in self.stats)

    @property
    def tokens_per_s(self) -> float:
        total = sum(s.effective_s for s in self.stats)
        return self.total_tokens / total if total else 0.0

    @property
    def throughput_tok_s(self) -> float:
        return self.total_tokens / self.span_s if self.span_s else 0.0

    def ttft(self) -> np.ndarray:
        """TTFT over requests that produced a first token (a request
        cancelled before its first token is left out)."""
        return np.array([r.ttft for r in self.requests
                         if r.ttft is not None])

    def token_latencies(self) -> np.ndarray:
        """Per-token effective latency: every token generated in a step
        experienced that step's effective seconds."""
        out = []
        for s in self.stats:
            out.extend([s.effective_s] * s.batch)
        return np.array(out)

    def latency_percentiles(self):
        return _percentiles(self.token_latencies())


class ServeEngine:
    """Single-device continuous-batching engine for every registered
    serving family (dense, vlm, moe).

    `model` is the family's model (`DenseModel`, or `MoEModel` for moe),
    its weights already prepared for `plan` (permuted hot-first,
    quantized); the engine runs on its device.
    `cuda_graphs`: None captures each bucket's decode step in a CUDA
    graph on a CUDA device and runs it eagerly on the CPU; False runs it
    eagerly on either; True on the CPU raises. `dp` > 1 routes requests
    over that many replicas (module docstring); `n_replicas` is the
    replica count a replica's storage plane divides its cache by.
    `shard`: the ShardGroup this rank serves in (module docstring);
    `model` is then the rank's slice. `publish` is set by a dp x tp
    engine for each replica: (the world's group, the rank) its steps'
    tokens and trace are broadcast from."""

    def __init__(self, cfg: ModelConfig, model, plan: ExecutionPlan,
                 spec: SystemSpec = POWERINFER2,
                 storage: StorageModel = UFS40,
                 offload_ratio: float = 0.5,
                 hw: HardwareProfile = None,
                 timing: TimingProfile = None,
                 n_compute_workers: int = 4,
                 seed: int = 0,
                 buckets: tuple = None,
                 ctx_budget: int = None,
                 eos_id: int = None,
                 temperature: float = 0.8,
                 prefetch: bool = True,
                 backend: str = None,
                 cuda_graphs: Optional[bool] = None,
                 dp: int = None,
                 n_replicas: int = 1,
                 shard=None,
                 publish: tuple = None):
        self.family = serving_family(cfg)
        if backend not in (None, "jnp", "pallas"):
            raise ValueError(f"unknown cold-path backend {backend!r}; "
                             f"expected 'jnp' or 'pallas'")
        # the moe cold path is expert dispatch, not a cluster gather: no
        # kernel serves it, so 'pallas' raises instead of quietly
        # running the plain path under its name
        if backend is not None and backend not in self.family.backends:
            raise ValueError(
                f"backend={backend!r} is the dense-family fused cold-path "
                f"kernel; the {cfg.family} family's cold path is expert "
                f"dispatch (models/moe.py) and has no {backend} backend "
                f"yet")
        if cfg.num_experts and cfg.moe_dispatch_groups != 1:
            # the reference's meshless engine dispatches in one group
            # whatever the config says (its groups follow the mesh); the
            # port's model reads its own config, so it must say one
            raise ValueError(
                f"{cfg.name}: moe_dispatch_groups="
                f"{cfg.moe_dispatch_groups}; one device serves one "
                f"dispatch group (moe_dispatch_groups=1)")
        self.backend = backend
        self.cfg = cfg
        self.plan = plan
        self.spec = spec
        self.model = model
        self.device = model.device
        self.buckets = tuple(buckets) if buckets else tuple(range(1, 65))
        self.replicas = self.router = None
        self.shard = shard
        self._publish = publish
        n_data = 1 if dp is None else int(dp)
        if n_data < 1:
            raise ValueError(f"dp={dp}: at least one replica")
        if n_data > 1:
            if shard is not None and shard.size > 1:
                if shard.size % n_data:
                    raise ValueError(f"dp={n_data} does not divide the "
                                     f"{shard.size} ranks")
                tp = shard.size // n_data
                groups = replica_groups(shard, n_data, tp)
                sources = [(shard, r * tp) for r in range(n_data)]
            else:
                groups, sources = [shard] * n_data, [None] * n_data
            self.replicas = [
                ServeEngine(cfg, model, plan, spec=spec, storage=storage,
                            offload_ratio=offload_ratio, hw=hw,
                            timing=timing,
                            n_compute_workers=n_compute_workers, seed=seed,
                            buckets=buckets, ctx_budget=ctx_budget,
                            eos_id=eos_id, temperature=temperature,
                            prefetch=prefetch, backend=backend,
                            cuda_graphs=cuda_graphs, n_replicas=n_data,
                            shard=groups[r], publish=sources[r])
                for r in range(n_data)]
            self.router = ReplicaRouter([r.sched for r in self.replicas])
            self.sched = self.router
            own = [r for r in self.replicas if r.decoder is not None]
            self.cuda_graphs = own[0].cuda_graphs
            self.graph_policy = own[0].graph_policy
            self.arena = self.decoder = self.storage = None
            self.ctx_budget = ctx_budget
            self.clock_s = 0.0             # max over replica clocks
            return
        n_shards = 1 if shard is None else shard.size
        # a mirror copies a replica served on other ranks: its scheduler,
        # plane and clock, fed the tokens and trace those ranks publish
        self.mirror = shard is not None and not shard.member
        on_cuda = self.device.type == "cuda"
        if cuda_graphs and n_shards > 1:
            raise ValueError(
                f"cuda_graphs=True over {n_shards} gloo ranks: a gloo "
                f"collective cannot be captured in a CUDA graph")
        if cuda_graphs and not on_cuda:
            raise ValueError(f"cuda_graphs=True needs a CUDA device; the "
                             f"model is on {self.device}")
        if n_shards > 1:
            self.cuda_graphs = False
            self.graph_policy = (f"eager: gloo collectives between the "
                                 f"{n_shards} ranks cannot be captured")
        else:
            self.cuda_graphs = on_cuda if cuda_graphs is None \
                else cuda_graphs
            self.graph_policy = "one CUDA graph per decode bucket" \
                if self.cuda_graphs else "eager"

        # ---- storage plane ----
        self.storage = StoragePlane(
            cfg, model, plan, spec=spec, storage=storage,
            offload_ratio=offload_ratio, hw=hw, timing=timing,
            n_compute_workers=n_compute_workers, prefetch=prefetch,
            n_shards=n_shards, n_replicas=n_replicas)
        self.sched = BatchScheduler(eos_id=eos_id)
        self.ctx_budget = ctx_budget
        self.clock_s = 0.0                 # modeled serving clock
        self.arena: Optional[KVSlotArena] = None
        if self.mirror:
            self.decoder = None
            return

        # ---- data plane ----
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        step_fn = self.family.make_decode_step(cfg, shard=shard)
        # the decoder reaches the engine's buffers through a weak
        # reference: no cycle keeps a dropped engine's device memory
        engine = weakref.ref(self)
        self.decoder = BucketedDecoder(
            plan_source=plan,
            make_step=lambda p: (lambda m, t, c, a: step_fn(m, t, c, p, a)),
            buckets=self.buckets, backend=backend, graphs=self.cuda_graphs,
            inputs=lambda n: engine()._step_inputs(n))

        # ---- KV slots ----
        # the step's static inputs (max_slots rows) and the next-token
        # logits (the arena's capacity); a bucket of n slots reads [:n]
        self._tokens = torch.zeros((self.max_slots, 1), dtype=torch.int32,
                                   device=self.device)
        self._mask = torch.zeros((self.max_slots,), dtype=torch.bool,
                                 device=self.device)
        self._last_store = None            # (arena capacity, V)
        self._last = None                  # its view (n_slots, V)
        self._temperature = temperature

    def close(self):
        """Release the storage plane's I/O thread (also runs at GC) and
        the captured graphs, of every replica."""
        if self.replicas is not None:
            for r in self.replicas:
                r.close()
            return
        if self.decoder is not None:
            self.decoder.drop_graphs()
        self.storage.close()

    # ----------------------------------------------- storage plane view ----
    # a replica-routed engine shows replica 0's (all are configured alike)
    @property
    def _plane_owner(self):
        return self.replicas[0] if self.replicas is not None else self

    @property
    def cache(self):
        return self._plane_owner.storage.cache

    @property
    def coldstore(self):
        return self._plane_owner.storage.coldstore

    @property
    def timing(self):
        return self._plane_owner.storage.timing

    @property
    def hw(self):
        return self._plane_owner.storage.hw

    @property
    def max_slots(self) -> int:
        return self.buckets[-1]

    # --------------------------------------------------- load reporting ----
    @property
    def load(self) -> int:
        """Outstanding requests (queued + running), over every replica."""
        return self.sched.load

    def next_event_time(self) -> Optional[float]:
        """When this engine's next decode event completes work on the
        modeled clock: its clock while a batch is running, else the head
        arrival it would jump to; None when drained. A replica-routed
        engine reports its earliest replica's (the one `step` runs)."""
        if self.replicas is not None:
            times = [t for t in (r.next_event_time() for r in self.replicas)
                     if t is not None]
            return min(times, default=None)
        if not self.sched.has_work:
            return None
        if self.sched.running:
            return self.clock_s
        nxt = self.sched.next_arrival()
        return max(self.clock_s, nxt) if nxt is not None else self.clock_s

    # ------------------------------------------------------- admission ----
    def submit(self, prompt, max_new: int = 32,
               arrival_time: float = None) -> int:
        """Enqueue one request (prompt: (S,) token ids). Returns uid.

        A replica-routed engine picks the least-loaded replica (FIFO
        tiebreak) and returns a router-global uid; a request arrives by
        default at the shared clock (the latest replica's)."""
        if self.replicas is not None:
            r = self.router.pick_replica()
            local = self.replicas[r].submit(
                prompt, max_new,
                self.clock_s if arrival_time is None else arrival_time)
            return self.router.bind(r, local)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] == 0:
            raise ValueError("empty prompt: at least one token required")
        if arrival_time is None:
            arrival_time = self.clock_s
        need = prompt.shape[0] + max_new
        if self.arena is not None and need > self.arena.max_len:
            raise ValueError(
                f"request needs {need} KV positions but the arena was "
                f"sized for {self.arena.max_len}; raise ctx_budget")
        req = self.sched.submit(prompt, max_new, arrival_time)
        return req.uid

    def _ensure_arena(self, n_slots: int, min_len: int, reach: int):
        """Make the arena hold a bucket of n_slots. It is allocated at
        `reach` rows, the bucket that all submitted work could fill (at
        least n_slots), and grows (at least doubling, at most to
        max_slots) only when a bucket passes its capacity."""
        cfg = self.cfg
        if self.arena is None:
            T = max(self.ctx_budget or 0, min_len)
            self.arena = KVSlotArena(cfg.num_layers, n_slots, T,
                                     self.model.kv_heads, cfg.d_head,
                                     dtype_of(cfg.param_dtype), self.device,
                                     capacity=reach)
            self._last_store = torch.zeros(
                (reach, cfg.vocab_padded),
                dtype=dtype_of(cfg.compute_dtype), device=self.device)
            self._last = self._last_store[:n_slots]
            return
        if min_len > self.arena.max_len:
            raise ValueError(
                f"admitted request needs {min_len} KV positions but the "
                f"arena was sized for {self.arena.max_len}; raise "
                f"ctx_budget")
        if n_slots > self.arena.capacity:
            self._grow(bucket_for(
                min(max(reach, 2 * self.arena.capacity), self.max_slots),
                self.decoder.buckets))
        if self.arena.n_slots != n_slots:
            order = list(self.sched.running)
            rows = self.arena.rows_for(order)
            self.arena.resize(n_slots, order)
            # move the per-slot logits the same way
            k = len(rows)
            if k:
                idx = torch.tensor(rows, dtype=torch.long,
                                   device=self.device)
                self._last_store[:k] = self._last_store.index_select(0, idx)
            self._last_store[k:n_slots] = 0
            self._last = self._last_store[:n_slots]

    def _grow(self, capacity: int):
        """Move the arena and the logits to `capacity` rows; every graph
        read the old storage, so they all go."""
        self.arena.grow(capacity)
        last = self._last_store.new_zeros((capacity,
                                           self._last_store.shape[1]))
        last[:self.arena.n_slots] = self._last
        self._last_store, self._last = last, last[:self.arena.n_slots]
        self.decoder.drop_graphs()

    def prewarm(self):
        """Build every bucket's decode step now and, on a graphed engine,
        capture each one, on an arena grown to max_slots rows, in every
        replica. The arena comes from the first step: serve one first (on
        each replica)."""
        if self.replicas is not None:
            for r in self.replicas:
                r.prewarm()
            return
        if self.mirror:
            return
        if self.arena is None:
            raise RuntimeError("no KV arena yet: serve a step first")
        if self.arena.capacity < self.max_slots:
            self._grow(self.max_slots)
        self.decoder.prewarm()

    def _step_inputs(self, n_slots: int):
        """The static inputs of an n_slots bucket's decode step: (model,
        tokens (n, 1), the arena's views, live mask (n,))."""
        if self.arena is None:
            raise RuntimeError("no KV arena yet: serve a step first")
        return (self.model, self._tokens[:n_slots],
                self.arena.view(n_slots), self._mask[:n_slots])

    def _admit(self, reqs: list):
        """Prefill-on-admit: joint prefill per prompt-length group,
        then write each request's KV row into a free slot (a mirror only
        advances its clock and admits)."""
        i = 0
        while i < len(reqs):
            group = [reqs[i]]
            i += 1
            while i < len(reqs) and reqs[i].prompt_len == group[0].prompt_len:
                group.append(reqs[i])
                i += 1
            self.clock_s += self.storage.prefill_cost(group[0].prompt_len,
                                                      len(group))
            if self.mirror:
                for req in group:
                    self.sched.admit(req, self.clock_s)
                continue
            tokens = torch.from_numpy(
                np.stack([r.prompt for r in group]).astype(np.int32)).to(
                    self.device)
            # the model's own layers (dense FFN or MoE) run the prompt
            logits, cache = dense.prefill(self.model, tokens,
                                          max_len=self.arena.max_len,
                                          shard=self.shard)
            for j, req in enumerate(group):
                self.sched.admit(req, self.clock_s)
                self.arena.alloc(req.uid)
                row = {
                    "k": cache["k"][:, j:j + 1],
                    "v": cache["v"][:, j:j + 1],
                    "kv_pos": cache["kv_pos"][j:j + 1],
                    "length": cache["length"][j:j + 1],
                }
                slot = self.arena.write(req.uid, row)
                self._last[slot] = logits[j, -1]

    # ------------------------------------------------------ decode loop ----
    def _next_replica(self) -> Optional[int]:
        """The replica with work whose next event is earliest: its clock,
        or the head arrival it would jump to when idle (ties -> lowest
        index)."""
        best, best_t = None, None
        for i, rep in enumerate(self.replicas):
            if not rep.sched.has_work:
                continue
            t = rep.clock_s
            if not rep.sched.running:
                nxt = rep.sched.next_arrival()
                if nxt is not None and nxt > t:
                    t = nxt
            if best is None or t < best_t:
                best, best_t = i, t
        return best

    @torch.no_grad()
    def step(self) -> Optional[StepResult]:
        """One continuous-batching step: admit -> (resize at bucket
        boundary) -> sample+decode -> price -> complete. A replica-routed
        engine steps the replica whose next event is earliest."""
        if self.replicas is not None:
            i = self._next_replica()
            if i is None:
                return None
            rep = self.replicas[i]
            r = rep.step()
            if r is None:
                return None
            self.clock_s = max(e.clock_s for e in self.replicas)
            self.router.batch_history.append(self.router.batch_size)
            r.stats.replica = i
            g = self.router.to_global
            return StepResult(
                stats=r.stats,
                tokens={g(i, u): t for u, t in r.tokens.items()},
                admitted=[g(i, u) for u in r.admitted],
                finished=[g(i, u) for u in r.finished],
                replica=i, t_s=rep.clock_s)
        sched = self.sched
        if not sched.has_work:
            return None
        # idle engine: jump the modeled clock to the next arrival
        if not sched.running:
            nxt = sched.next_arrival()
            if nxt is not None and nxt > self.clock_s:
                self.clock_s = nxt
        room = self.max_slots - len(sched.running)
        admits = sched.pop_admissible(self.clock_s, room)
        n_active = len(sched.running) + len(admits)
        if n_active == 0:
            return None
        if self.mirror:
            if admits:
                self._admit(admits)
            plan_b = stepped_plan(self.plan, n_active, self.buckets,
                                  self.backend)
            toks, trace = self._publish[0].broadcast_object(
                None, src=self._publish[1])
        else:
            plan_b, toks, trace = self._decode(admits, n_active)
            if self._publish is not None:
                self._publish[0].broadcast_object((toks, trace),
                                                  src=self._publish[1])

        ctx = float(np.mean([sched.sequences[u].prompt_len
                             + sched.sequences[u].n_generated
                             for u in sched.running]))
        st = self.storage.step(trace, plan_b, n_active, ctx)
        self.clock_s += st.effective_s

        tok_map = {u: int(t) for u, t in zip(sched.running, toks)}
        for u in sched.running:
            req = sched.sequences[u]
            if req.first_token_time is None:
                req.first_token_time = self.clock_s
        done = sched.step(tok_map)
        for u in done:
            sched.sequences[u].finish_time = self.clock_s
            if not self.mirror:
                self.arena.release(u)
        return StepResult(stats=st, tokens=tok_map,
                          admitted=[r.uid for r in admits], finished=done,
                          t_s=self.clock_s)

    def _decode(self, admits: list, n_active: int):
        """The data plane's half of a step: size the arena, admit (prefill)
        `admits`, sample a token for every running request (rank 0 of a
        group, broadcast to the rest) and run the bucket's decode step.
        Returns (the stepped plan, the tokens in running order, the
        trace as numpy)."""
        sched = self.sched
        # the KV arena tracks the decoder's bucket table: one resize per
        # boundary crossing. Its length is fixed at creation, so size it
        # for everything already submitted, and its rows for the bucket
        # all of that could fill.
        buckets = self.buckets
        b = bucket_for(n_active, buckets)
        need = [r.prompt_len + r.max_new for r in admits]
        if self.arena is None:
            need += [sched.sequences[u].prompt_len
                     + sched.sequences[u].max_new for u in sched.queue]
        reach = bucket_for(min(n_active + len(sched.queue), self.max_slots),
                           buckets)
        self._ensure_arena(b, max(need, default=0), reach)
        if admits:
            self._admit(admits)
        n_slots = self.arena.n_slots

        plan_b, step_fn = self.decoder.executable_for(n_active)
        rows = self.arena.rows_for(sched.running)
        if self.shard is None or self.shard.rank == 0:
            idx = torch.tensor(rows, dtype=torch.long, device=self.device)
            toks = sample_tokens(self._last.index_select(0, idx),
                                 self._temperature,
                                 generator=self.generator).cpu()
        else:
            toks = torch.empty((len(rows),), dtype=torch.int32)
        if self.shard is not None:
            self.shard.broadcast(toks)
        toks = toks.numpy()
        feed = np.zeros((n_slots,), np.int32)
        feed[rows] = toks
        mask = np.zeros((n_slots,), bool)
        mask[rows] = True
        tokens, live = self._tokens[:n_slots], self._mask[:n_slots]
        tokens.copy_(torch.from_numpy(feed)[:, None])
        live.copy_(torch.from_numpy(mask))
        logits, _, cidx = step_fn(self.model, tokens, self.arena.cache, live)
        # a graph's outputs are overwritten by the next replay: copy out
        self._last.copy_(logits[:, 0])
        return plan_b, toks, cidx.cpu().numpy()

    def cancel(self, uids):
        """Force-finish requests. Running requests release their KV slot
        immediately; still-queued requests are dequeued, finish with no
        tokens and keep `first_token_time` None. A replica-routed engine
        cancels on the owning replica."""
        if self.replicas is not None:
            for uid in list(uids):
                r, local = self.router.locate(uid)
                was_running = local in self.replicas[r].sched.running
                self.replicas[r].cancel([local])
                if was_running:      # a decay event on the merged timeline
                    self.router.batch_history.append(
                        self.router.batch_size)
            return
        for uid in list(uids):
            if uid in self.sched.running:
                self.sched.finish(uid, self.clock_s)
                if not self.mirror:
                    self.arena.release(uid)
            elif not self.sched.sequences[uid].finished:
                self.sched.finish(uid, self.clock_s)   # queued: no slot yet

    def run_until_drained(self, max_steps: int = 100000) -> ServeReport:
        """Step until queue and batch are empty. The report covers every
        request finished so far.

        A replica-routed engine merges every replica's TokenStats onto
        the shared timeline (by each step's completion time, then
        replica) and reports the drained makespan as `span_s`; requests
        come back in global-uid order."""
        if self.replicas is not None:
            log = []
            for _ in range(max_steps):
                r = self.step()
                if r is None:
                    break
                log.append((r.t_s, r.replica, r.stats))
            log.sort(key=lambda e: (e[0], e[1]))
            reqs = [self.router.request(u) for u in self.router.assignment]
            return ServeReport(
                stats=[s for _, _, s in log],
                requests=[q for q in reqs if q.finished],
                span_s=max(r.clock_s for r in self.replicas))
        stats = []
        for _ in range(max_steps):
            r = self.step()
            if r is None:
                break
            stats.append(r.stats)
        return ServeReport(stats=stats,
                           requests=[r for r in
                                     self.sched.sequences.values()
                                     if r.finished],
                           span_s=self.clock_s)

    # ---------------------------------------------- compatibility API ----
    def generate(self, prompt_tokens, max_new: int = 32,
                 temperature: float = 0.8,
                 completion_schedule: Optional[dict] = None,
                 eos_id: Optional[int] = None) -> GenerationResult:
        """Static-batch wrapper over the continuous loop: submit B
        requests at the current clock, drain, return (B, max_new)
        tokens (-1 past a request's end).

        completion_schedule: {step: n_finish} cancels the first n_finish
        still-running sequences after that step (Fig 13's Best-of-N
        batch decay, deterministically). eos_id ends a sequence at that
        token for this call (None: no EOS)."""
        prompt = np.asarray(prompt_tokens)
        B, S = prompt.shape
        if self.replicas is not None:
            raise ValueError(
                "generate() is the static-batch path; a replica-routed "
                "engine serves via submit()/run_until_drained()")
        if self.sched.has_work:
            raise RuntimeError("generate() requires an idle engine (drain "
                               "submitted work first)")
        # wall_s is an observability stat, never fed back into the
        # modeled clock or any scheduling decision
        t_wall = time.perf_counter()  # repro: ignore[wall-clock]
        old_temp, old_eos = self._temperature, self.sched.eos_id
        self._temperature = temperature
        self.sched.eos_id = eos_id
        # static batch wants an exact-length arena
        if self.arena is not None and self.arena.max_len != S + max_new \
                and self.ctx_budget is None:
            self.arena = None
            self.decoder.drop_graphs()     # they read the old arena
        uids = [self.submit(prompt[i], max_new) for i in range(B)]
        stats = []
        step_i = 0
        try:
            while self.sched.has_work:
                r = self.step()
                if r is None:
                    break
                stats.append(r.stats)
                if completion_schedule and step_i in completion_schedule:
                    still = [u for u in uids if u in self.sched.running]
                    self.cancel(still[: completion_schedule[step_i]])
                step_i += 1
        finally:
            self._temperature, self.sched.eos_id = old_temp, old_eos
        tokens = np.full((B, max_new), -1, np.int32)
        for i, u in enumerate(uids):
            gen = self.sched.sequences[u].generated
            tokens[i, :len(gen)] = gen
        wall_s = time.perf_counter() - t_wall  # repro: ignore[wall-clock]
        return GenerationResult(tokens=tokens, stats=stats, wall_s=wall_s)
