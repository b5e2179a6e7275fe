"""Serving one cell through the port, and what the harness records.

The engine is built through the port's public path
(`serving.families.serving_family`: make_model, build_plan,
prepare_params; then `serving.engine.ServeEngine`) with the benchmark's
weights loaded into the model. A closed loop of clients drives
`ServeEngine.submit` / `ServeEngine.step`: each client sends its next
request the moment its last one finishes. The harness keeps its own
clock (`time.perf_counter`) for every request: when it was due, when
each of its tokens came out of a step, when it finished. The engine's
`clock_s` is the storage plane's modeled phone clock and no speed
metric reads it.

It also wraps `engine.storage.step`, as a spy: each step's cluster-id
trace, plan, batch and mean context go to the plain reference, the
TokenStats it returns are checked against a replay of the pricing, and
its host seconds are the storage plane's time."""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.traffic import Stream
from portbench.weights import load_into, make_weights

TOKEN_STATS = ("compute_s", "io_s", "effective_s", "cache_hit_rate",
               "n_miss", "batch")
CLOCK = time.perf_counter
FIRST_TOKEN_WAIT_S = 60.0      # past the window, for first tokens still due


@dataclass
class Step:
    """One engine step as the harness saw it."""
    index: int
    t0: float
    t1: float
    uids: list                 # live rows, in the order they were fed
    admitted: list
    finished: list
    trace: np.ndarray = None   # (L, G, kc) cluster ids
    plan: tuple = None         # the stepped plan: (n_hot, kc, cs, groups)
    batch: int = 0
    ctx: float = 0.0
    stats: dict = None         # the plane's TokenStats fields
    plane_s: float = 0.0       # host seconds in the storage plane
    launches: int = 0          # fused_cold_ffn calls the step made
    rows: int = 0              # the bucket's rows the decode step ran


@dataclass
class Run:
    """Everything one run recorded; the metric readers and the judge
    read it."""
    cell: dict
    seed: int
    peaks: dict = None         # the card's (peaks.py), None off the table
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)
    steps: list = field(default_factory=list)
    requests: dict = field(default_factory=dict)     # uid -> Request
    profile: dict = None       # the traced sub-window (devtrace.read)
    gc_s: float = 0.0          # host seconds in Python's collector, window
    memory_peak_bytes: int = 0

    @property
    def model(self) -> dict:
        return self.cell["config"]["model"]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def window_steps(self) -> list:
        t0, t1 = self.window
        return [s for s in self.steps if s.t0 >= t0 and s.t1 <= t1]

    def due_in_window(self) -> list:
        t0, t1 = self.window
        return [r for r in self.requests.values()
                if r.due is not None and t0 <= r.due < t1]


def port_config(m: dict):
    from repro_torch.configs.base import ModelConfig, SparseFFNConfig
    kw = dict(m)
    kw["sparse_ffn"] = SparseFFNConfig(**m["sparse_ffn"])
    return ModelConfig(**kw)


def cell_bucket(clients: int) -> int:
    """The one decode bucket a closed loop of `clients` serves: every
    step admits first, so each runs with every client's request live.
    The engine is given this bucket alone, and warms and captures no
    other shape."""
    from repro_torch.core.adaptation import DEFAULT_BUCKETS, bucket_for
    return bucket_for(clients, DEFAULT_BUCKETS)


def build_engine(cell: dict, seed: int, device):
    """The port's engine over the benchmark's weights, through the
    serving family's public path."""
    from repro_torch.core.planner import PHONE
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.families import serving_family
    conf, mix = cell["config"], cell["traffic"]
    m, sv = conf["model"], conf["serving"]
    cfg = port_config(m)
    fam = serving_family(cfg)
    model = fam.make_model(cfg, device, seed=None)
    load_into(model, make_weights(m, seed, device))
    hw = {"PHONE": PHONE}[sv["hardware"]]
    plan = fam.build_plan(cfg, None, hw=hw, backend=sv["backend"],
                          storage_dtype=sv["storage_dtype"])
    model = fam.prepare_params(model, plan)
    return ServeEngine(cfg, model, plan,
                       buckets=(cell_bucket(mix["clients"]),),
                       ctx_budget=mix["ctx_budget"], temperature=0.0,
                       backend=sv["backend"], cuda_graphs=None,
                       offload_ratio=sv["offload_ratio"], seed=0)


class ClosedLoop:
    """`clients` clients, each with one request outstanding: a request
    that finishes frees its client, which sends the stream's next one at
    once (while `open`)."""

    def __init__(self, engine, stream: Stream, run: Run, clients: int,
                 sync=lambda: None):
        self.engine, self.stream, self.run = engine, stream, run
        self.clients, self.sync = clients, sync
        self.open = True
        self._pending = None           # the spy's record of this step
        self._spy_storage()

    def _spy_storage(self):
        from repro_torch.kernels import ops
        price = self.engine.storage.step

        def spy(trace, plan, batch, ctx):
            t0 = CLOCK()
            st = price(trace, plan, batch, ctx)
            self._pending = dict(
                trace=np.array(trace), batch=int(batch), ctx=float(ctx),
                plan=(plan.n_hot, plan.clusters_per_group,
                      plan.cluster_size, plan.groups),
                stats={k: getattr(st, k) for k in TOKEN_STATS},
                plane_s=CLOCK() - t0)
            return st
        self.engine.storage.step = spy
        self._launches = lambda: ops.fused_cold_ffn.launches

    def submit(self, now: float):
        req = self.stream.next()
        req.due = now
        req.uid = self.engine.submit(req.prompt, req.max_new)
        self.run.requests[req.uid] = req

    def start(self):
        now = CLOCK()
        for _ in range(self.clients):
            self.submit(now)

    def step(self) -> Step:
        n0 = self._launches()
        t0 = CLOCK()
        r = self.engine.step()
        t1 = CLOCK()
        if r is None:
            raise RuntimeError("the engine had no work in a closed loop")
        s = Step(index=len(self.run.steps), t0=t0, t1=t1,
                 uids=list(r.tokens), admitted=list(r.admitted),
                 finished=list(r.finished), launches=self._launches() - n0,
                 rows=self.engine.arena.n_slots, **self._pending)
        self._pending = None
        self.run.steps.append(s)
        for uid, tok in r.tokens.items():
            req = self.run.requests[uid]
            req.tokens.append(int(tok))
            req.token_times.append(t1)
            req.token_steps.append(s.index)
        for uid in r.finished:
            self.run.requests[uid].done = t1
            if self.open:
                self.submit(t1)
        return s


def serve(engine, cell: dict, run: Run, seconds: float, profile_s: float,
          sync, profiler=None):
    """Warm up, measure `seconds`, then (traced runs) profile
    `profile_s` more seconds, then serve on until every request due in
    the window has its first token. Returns the loop."""
    mix = cell["traffic"]
    stream = Stream(mix, cell["config"]["model"]["vocab_size"], run.seed)
    loop = ClosedLoop(engine, stream, run, mix["clients"], sync)
    loop.start()
    loop.step()                      # builds the arena at the cell's size
    engine.prewarm()                 # captures the bucket's graph
    warm = mix["warmup"]
    n_done = 0
    while n_done < warm["finished"] or len(run.steps) < warm["steps"]:
        n_done += len(loop.step().finished)
    sync()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    gc_t = [0.0, 0.0]                # seconds in Python's collector, start

    def on_gc(phase, info):
        if phase == "start":
            gc_t[1] = CLOCK()
        else:
            gc_t[0] += CLOCK() - gc_t[1]
    gc.callbacks.append(on_gc)
    t_open = CLOCK()
    while True:
        s = loop.step()
        if s.t1 - t_open >= seconds:
            break
    gc.callbacks.remove(on_gc)
    run.window, run.gc_s = (t_open, s.t1), gc_t[0]
    if profiler is not None:
        run.profile = profiler(loop, profile_s)
    due = run.due_in_window()
    give_up = CLOCK() + FIRST_TOKEN_WAIT_S
    while any(not r.tokens for r in due) and CLOCK() < give_up:
        loop.step()
    loop.open = False
    return loop
