"""PowerInfer-2 serving engine — the thin orchestrator, single device.

Counterpart of `repro/serving/engine.py` at dp=1 with no mesh. Three
layers:

* **Data plane** — numerically real: one decode callable per batch
  bucket (core/adaptation.BucketedDecoder) runs the hybrid hot/cold FFN
  and returns, besides logits, the per-layer cold-cluster selections
  (the activation trace).
* **Storage plane** (serving/storage_plane.py) — the trace drives the
  segmented NeuronCache and the bundled ColdStore; I/O time comes from
  the StorageModel and per-token effective latency from the
  neuron-cluster pipeline simulator. These latencies are *modeled*.
* **Scheduler** (serving/scheduler.py) — request-level continuous
  batching: admission queue, per-step admission up to the decoder's next
  bucket boundary, prefill-on-admit, completion.

submit()/step()/run_until_drained() drive requests through the slot
KV arena; generate() is the static-batch wrapper over the same loop.
The engine runs on the model's device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adaptation import BucketedDecoder, bucket_for
from repro_torch.core.baselines import SystemSpec, POWERINFER2
from repro_torch.core.io_model import StorageModel, UFS40
from repro_torch.core.planner import ExecutionPlan, HardwareProfile
from repro_torch.models import dense
from repro_torch.models.kv_cache import KVSlotArena
from repro_torch.models.modules import dtype_of
from repro_torch.serving.families import serving_family
from repro_torch.serving.sampler import sample_tokens
from repro_torch.serving.scheduler import BatchScheduler
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
    t_s: float = 0.0                   # modeled clock after the step


@dataclass
class ServeReport:
    """Aggregate serving metrics over a drained request stream. Times
    are on the modeled clock."""
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


class ServeEngine:
    """Single-device continuous-batching engine for the dense family.

    `model` is the port's DenseModel (its weights already permuted
    hot-first to match `plan`); the engine runs on its device."""

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
                 backend: str = None):
        self.family = serving_family(cfg)
        if backend not in (None, "jnp", "pallas"):
            raise ValueError(f"unknown cold-path backend {backend!r}; "
                             f"expected 'jnp' or 'pallas'")
        self.backend = backend
        self.cfg = cfg
        self.plan = plan
        self.spec = spec
        self.model = model
        self.device = model.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        # ---- data plane ----
        step_fn = self.family.make_decode_step(cfg)
        self.decoder = BucketedDecoder(
            plan_source=plan,
            make_step=lambda p: (lambda m, t, c, a: step_fn(m, t, c, p, a)),
            buckets=tuple(buckets) if buckets else tuple(range(1, 65)),
            backend=backend)

        # ---- storage plane ----
        self.storage = StoragePlane(
            cfg, model, plan, spec=spec, storage=storage,
            offload_ratio=offload_ratio, hw=hw, timing=timing,
            n_compute_workers=n_compute_workers, prefetch=prefetch)

        # ---- scheduler + KV slots ----
        self.sched = BatchScheduler(eos_id=eos_id)
        self.arena: Optional[KVSlotArena] = None
        self._last = None                  # (n_slots, V) next-token logits
        self._temperature = temperature
        self.ctx_budget = ctx_budget
        self.clock_s = 0.0                 # modeled serving clock

    def close(self):
        """Release the storage plane's I/O thread (also runs at GC)."""
        self.storage.close()

    @property
    def max_slots(self) -> int:
        return self.decoder.buckets[-1]

    # ------------------------------------------------------- admission ----
    def submit(self, prompt, max_new: int = 32,
               arrival_time: float = None) -> int:
        """Enqueue one request (prompt: (S,) token ids). Returns uid."""
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

    def _ensure_arena(self, n_slots: int, min_len: int):
        cfg = self.cfg
        if self.arena is None:
            T = max(self.ctx_budget or 0, min_len)
            self.arena = KVSlotArena(cfg.num_layers, n_slots, T,
                                     cfg.num_kv_heads, cfg.d_head,
                                     dtype_of(cfg.param_dtype), self.device)
            self._last = torch.zeros((n_slots, cfg.vocab_padded),
                                     dtype=dtype_of(cfg.compute_dtype),
                                     device=self.device)
        elif min_len > self.arena.max_len:
            raise ValueError(
                f"admitted request needs {min_len} KV positions but the "
                f"arena was sized for {self.arena.max_len}; raise "
                f"ctx_budget")
        elif self.arena.n_slots != n_slots:
            order = list(self.sched.running)
            rows = self.arena.rows_for(order)
            self.arena.resize(n_slots, order)
            # gather the per-slot logits the same way
            last = torch.zeros((n_slots,) + tuple(self._last.shape[1:]),
                               dtype=self._last.dtype, device=self.device)
            if rows:
                idx = torch.tensor(rows, dtype=torch.long,
                                   device=self.device)
                last[:len(rows)] = self._last.index_select(0, idx)
            self._last = last

    def _admit(self, reqs: list):
        """Prefill-on-admit: joint prefill per prompt-length group,
        then write each request's KV row into a free slot."""
        i = 0
        while i < len(reqs):
            group = [reqs[i]]
            i += 1
            while i < len(reqs) and reqs[i].prompt_len == group[0].prompt_len:
                group.append(reqs[i])
                i += 1
            tokens = torch.from_numpy(
                np.stack([r.prompt for r in group]).astype(np.int32)).to(
                    self.device)
            logits, cache = dense.prefill(self.model, tokens,
                                          max_len=self.arena.max_len)
            self.clock_s += self.storage.prefill_cost(group[0].prompt_len,
                                                      len(group))
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
    @torch.no_grad()
    def step(self) -> Optional[StepResult]:
        """One continuous-batching step: admit -> (resize at bucket
        boundary) -> sample+decode -> price -> complete."""
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
        # the KV arena tracks the decoder's bucket table: one resize per
        # boundary crossing. Its length is fixed at creation, so size it
        # for everything already submitted.
        b = bucket_for(n_active, self.decoder.buckets)
        need = [r.prompt_len + r.max_new for r in admits]
        if self.arena is None:
            need += [sched.sequences[u].prompt_len
                     + sched.sequences[u].max_new for u in sched.queue]
        self._ensure_arena(b, max(need, default=0))
        if admits:
            self._admit(admits)
        n_slots = self.arena.n_slots

        plan_b, step_fn = self.decoder.executable_for(n_active)
        rows = self.arena.rows_for(sched.running)
        idx = torch.tensor(rows, dtype=torch.long, device=self.device)
        toks_active = sample_tokens(self._last.index_select(0, idx),
                                    self._temperature,
                                    generator=self.generator)
        feed = np.zeros((n_slots,), np.int32)
        feed[rows] = toks_active.cpu().numpy()
        mask = np.zeros((n_slots,), bool)
        mask[rows] = True
        logits, cache, cidx = step_fn(
            self.model, torch.from_numpy(feed)[:, None].to(self.device),
            self.arena.cache, torch.from_numpy(mask).to(self.device))
        self.arena.cache = cache
        self._last = logits[:, 0]

        ctx = float(np.mean([sched.sequences[u].prompt_len
                             + sched.sequences[u].n_generated
                             for u in sched.running]))
        st = self.storage.step(cidx.cpu().numpy(), plan_b, n_active, ctx)
        self.clock_s += st.effective_s

        tok_map = {u: int(feed[s])
                   for u, s in zip(sched.running, rows)}
        for u in sched.running:
            req = sched.sequences[u]
            if req.first_token_time is None:
                req.first_token_time = self.clock_s
        done = sched.step(tok_map)
        for u in done:
            sched.sequences[u].finish_time = self.clock_s
            self.arena.release(u)
        return StepResult(stats=st, tokens=tok_map,
                          admitted=[r.uid for r in admits], finished=done,
                          t_s=self.clock_s)

    def cancel(self, uids):
        """Force-finish requests. Running requests release their KV slot
        immediately; still-queued requests are dequeued, finish with no
        tokens and keep `first_token_time` None."""
        for uid in list(uids):
            if uid in self.sched.running:
                self.sched.finish(uid, self.clock_s)
                self.arena.release(uid)
            elif not self.sched.sequences[uid].finished:
                self.sched.finish(uid, self.clock_s)   # queued: no slot yet

    def run_until_drained(self, max_steps: int = 100000) -> ServeReport:
        """Step until queue and batch are empty. The report covers every
        request finished so far."""
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
                 temperature: float = 0.8) -> GenerationResult:
        """Static-batch wrapper over the continuous loop: submit B
        requests at the current clock, drain, return (B, max_new)
        tokens (-1 past a request's end)."""
        prompt = np.asarray(prompt_tokens)
        B, S = prompt.shape
        if self.sched.has_work:
            raise RuntimeError("generate() requires an idle engine (drain "
                               "submitted work first)")
        # wall_s is an observability stat, never fed back into the
        # modeled clock or any scheduling decision
        t_wall = time.perf_counter()
        old_temp = self._temperature
        self._temperature = temperature
        # static batch wants an exact-length arena
        if self.arena is not None and self.arena.max_len != S + max_new \
                and self.ctx_budget is None:
            self.arena = None
        uids = [self.submit(prompt[i], max_new) for i in range(B)]
        try:
            stats = self.run_until_drained().stats
        finally:
            self._temperature = old_temp
        tokens = np.full((B, max_new), -1, np.int32)
        for i, u in enumerate(uids):
            gen = self.sched.sequences[u].generated
            tokens[i, :len(gen)] = gen
        return GenerationResult(tokens=tokens, stats=stats,
                                wall_s=time.perf_counter() - t_wall)
