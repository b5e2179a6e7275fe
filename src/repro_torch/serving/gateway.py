"""Fleet front door: a serving gateway over many engines.

The port's copy of `repro/serving/gateway.py`, its dispatch logic
unchanged; only `local_fleet` differs: it builds the port's engines.

The gateway load-balances requests over a fleet of backends, each a
complete serving stack, with the policies a real front door needs:

* **weighted least-loaded dispatch** — each backend reports its
  outstanding load (`ServeEngine.load`, the scheduler's queued +
  running count) and carries a throughput `weight`; the gateway routes
  to the eligible backend minimising load/weight (FIFO tiebreak, so an
  idle fleet round-robins deterministically).
* **per-backend max-concurrency caps** — a backend at its cap is
  skipped (requests queue at the gateway), so one slow engine never
  accumulates the whole fleet's backlog.
* **health / heartbeat probes** — a fleet clock event every
  `heartbeat_s` probes each backend; a dead backend is detected at
  probe time, its in-flight requests are recalled and redispatched
  elsewhere (retries counted), and a later successful probe rejoins it
  through the circuit breaker's half-open canary.
* **circuit breaker** (closed/open/half-open) — dispatch failures trip
  a per-backend breaker after `failure_threshold` consecutive
  failures; an open breaker rejects dispatch until `open_timeout_s` of
  fleet-clock time has passed, then admits `half_open_probes` canary
  requests whose completion closes it (failure reopens it).
* **response LRU** — completed responses are cached keyed on the
  *canonicalized* request (prompt token bytes + max_new); a hit
  replays the recorded token stream with zero decode work.
* **token streaming passthrough** — every decoded token is forwarded
  to the request's event stream the moment its backend step completes;
  `stream()` yields (t_s, token) events live while driving the fleet,
  and `AsyncGateway` exposes the same as an async iterator.

The **fleet clock** is modeled the way the engine models the device
clock: every backend advances its own modeled clock; the gateway is an
event-driven simulator that always processes the earliest next event —
a control event (heartbeat, injected loss/rejoin), a pending dispatch,
or the earliest backend's decode step — so a run is deterministic and
replayable.

Backends implement the narrow `BackendHandle` surface (submit / step /
cancel / load / next_event_time / close).

A request whose every dispatch attempt fails (all breakers open, every
backend lost or draining) surfaces a *typed* rejection — it lands in
`FleetReport.rejected` with a reason, never hangs the drain loop — and
an empty-fleet report is well-formed zeros (no division by zero).
"""
from __future__ import annotations

import heapq
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

import numpy as np

__all__ = ["FleetGateway", "AsyncGateway", "EngineBackend", "Backend",
           "CircuitBreaker", "ResponseLRU", "FleetReport",
           "RejectedRequest", "BackendUnavailable", "canonical_key",
           "CLOSED", "OPEN", "HALF_OPEN"]

# breaker states (str constants: cheap to assert on and to serialize)
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class BackendUnavailable(RuntimeError):
    """Raised by a backend handle when a dispatch cannot land (the
    modeled host is down or refusing work)."""


def canonical_key(prompt, max_new: int) -> tuple:
    """Canonicalized request identity for the response LRU: the prompt
    as int32 token bytes plus the generation budget — list vs array vs
    dtype never splits the cache."""
    toks = np.asarray(prompt, np.int32).reshape(-1)
    return (toks.tobytes(), int(max_new))


# ---------------------------------------------------- circuit breaker ----

class CircuitBreaker:
    """Closed/open/half-open breaker on the fleet clock.

    Closed: dispatch allowed; `failure_threshold` *consecutive*
    failures trip it open. Open: dispatch refused until
    `open_timeout_s` of fleet time passes, then the next `allow()`
    moves it half-open. Half-open: up to `half_open_probes` canary
    requests may be in flight; a canary completing closes the breaker,
    a failure reopens it (restarting the timeout)."""

    def __init__(self, failure_threshold: int = 3,
                 open_timeout_s: float = 0.05,
                 half_open_probes: int = 1):
        self.failure_threshold = int(failure_threshold)
        self.open_timeout_s = float(open_timeout_s)
        self.half_open_probes = int(half_open_probes)
        self.state = CLOSED
        self.failures = 0              # consecutive, resets on success
        self.opened_at = 0.0
        self.probes_inflight = 0

    def allow(self, now: float) -> bool:
        """May a request be dispatched now? Open -> half-open happens
        here (time-driven), so callers never special-case the timer."""
        if self.state == OPEN:
            if now - self.opened_at >= self.open_timeout_s:
                self.state = HALF_OPEN
                self.probes_inflight = 0
            else:
                return False
        if self.state == HALF_OPEN:
            return self.probes_inflight < self.half_open_probes
        return True

    def on_dispatch(self):
        if self.state == HALF_OPEN:
            self.probes_inflight += 1

    def record_success(self):
        if self.state == HALF_OPEN:
            self.probes_inflight = max(0, self.probes_inflight - 1)
            self.state = CLOSED
        self.failures = 0

    def record_failure(self, now: float):
        if self.state == HALF_OPEN:
            self.probes_inflight = max(0, self.probes_inflight - 1)
            self.trip(now)
            return
        self.failures += 1
        if self.failures >= self.failure_threshold:
            self.trip(now)

    def trip(self, now: float):
        """Force-open (heartbeat loss detection skips the count)."""
        self.state = OPEN
        self.opened_at = now
        self.failures = 0


# ------------------------------------------------------- response LRU ----

class ResponseLRU:
    """Bounded LRU of completed responses keyed on the canonicalized
    request. `capacity=0` disables caching entirely."""

    def __init__(self, capacity: int = 128):
        self.capacity = int(capacity)
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        if not self.capacity:       # disabled: no hit/miss accounting
            return None
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key, tokens: list):
        if not self.capacity:
            return
        self._d[key] = list(tokens)
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)


# ---------------------------------------------------- backend handles ----

class BackendHandle:
    """The narrow surface the gateway needs from one serving backend.

    `EngineBackend` implements it over an in-process ServeEngine; a
    multi-host deployment implements the same six calls over RPC and
    plugs into the unchanged dispatch logic."""

    def submit(self, prompt, max_new: int, arrival_time: float) -> int:
        raise NotImplementedError

    def step(self):
        raise NotImplementedError

    def cancel(self, local_uids):
        raise NotImplementedError

    @property
    def load(self) -> int:
        raise NotImplementedError

    def next_event_time(self) -> Optional[float]:
        raise NotImplementedError

    def close(self):
        pass


class EngineBackend(BackendHandle):
    """In-process replica: one full ServeEngine behind the handle.

    `lost` models the host dying: submits raise BackendUnavailable and
    the engine produces no further events until `restore()`. The
    engine object survives a loss (it is a simulation of a process
    that died); `recall()` cancels whatever was in flight so the
    gateway can redispatch it and a later rejoin starts clean."""

    def __init__(self, engine):
        self.engine = engine
        self.lost = False

    def submit(self, prompt, max_new: int, arrival_time: float) -> int:
        if self.lost:
            raise BackendUnavailable("backend is down")
        return self.engine.submit(prompt, max_new,
                                  arrival_time=arrival_time)

    def step(self):
        if self.lost:
            return None
        return self.engine.step()

    def cancel(self, local_uids):
        self.engine.cancel(local_uids)

    @property
    def load(self) -> int:
        return self.engine.load

    def next_event_time(self) -> Optional[float]:
        if self.lost:
            return None                # a dead host emits no events
        return self.engine.next_event_time()

    def close(self):
        self.engine.close()


@dataclass
class Backend:
    """One fleet member: a handle plus the gateway's routing state."""
    handle: BackendHandle
    weight: float = 1.0                # relative throughput (>=, >0)
    max_concurrency: int = 8           # outstanding dispatches cap
    breaker: CircuitBreaker = field(default_factory=CircuitBreaker)
    alive: bool = True                 # last heartbeat verdict
    draining: bool = False             # finish in-flight, take no new
    inflight: dict = field(default_factory=dict)   # local uid -> gw uid
    n_dispatched: int = 0
    n_completed: int = 0
    n_steps: int = 0

    def eligible(self, now: float) -> bool:
        """May a new request land here right now?"""
        return (self.alive and not self.draining
                and len(self.inflight) < self.max_concurrency
                and self.breaker.allow(now))

    def score(self) -> float:
        """Weighted load: reported outstanding work over throughput
        weight — the least-loaded policy's ordering key."""
        return self.handle.load / max(self.weight, 1e-9)


# ------------------------------------------------------ request state ----

@dataclass
class GatewayRequest:
    """One request through the gateway's lifecycle."""
    uid: int
    prompt: np.ndarray
    max_new: int
    arrival_time: float
    key: tuple = None
    backend: Optional[int] = None      # current backend index
    tokens: list = field(default_factory=list)
    events: list = field(default_factory=list)     # (t_s, token) stream
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    cache_hit: bool = False
    retries: int = 0                   # redispatches after a failure
    attempts: int = 0                  # dispatch attempts consumed
    epoch: int = 0                     # bumped on recall: stream restarts
    done: bool = False
    rejected: bool = False
    reject_reason: str = ""

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time


@dataclass
class RejectedRequest:
    """Typed rejection: the request surfaced an error instead of
    hanging — every dispatch attempt hit an open breaker / lost or
    draining backend, or the fleet was empty."""
    uid: int
    reason: str
    attempts: int
    t_s: float


@dataclass
class FleetReport:
    """Aggregate fleet metrics over a drained request stream. All
    denominators are guarded: an empty fleet (or a stream rejected
    wholesale) reports zeros, never a ZeroDivisionError."""
    n_submitted: int = 0
    n_completed: int = 0               # includes cache hits
    n_rejected: int = 0
    n_retries: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    total_tokens: int = 0
    span_s: float = 0.0
    ttft_hit: np.ndarray = None        # TTFT over cache-hit requests
    ttft_miss: np.ndarray = None       # TTFT over decoded requests
    rejected: list = field(default_factory=list)   # RejectedRequest
    per_backend: list = field(default_factory=list)

    @property
    def throughput_tok_s(self) -> float:
        return self.total_tokens / self.span_s if self.span_s else 0.0

    @property
    def drained(self) -> bool:
        """Every submitted request surfaced an outcome (completion or
        typed rejection) — the no-drops invariant the soak asserts."""
        return self.n_completed + self.n_rejected == self.n_submitted

    def ttft_percentiles(self, which: str = "miss") -> dict:
        arr = self.ttft_hit if which == "hit" else self.ttft_miss
        if arr is None or arr.size == 0:
            return {"mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {"mean": float(arr.mean()),
                "p50": float(np.percentile(arr, 50)),
                "p90": float(np.percentile(arr, 90)),
                "p99": float(np.percentile(arr, 99))}


# ------------------------------------------------------- the gateway ----

class FleetGateway:
    """Event-driven front door over a fleet of serving backends.

    submit() -> uid enqueues on the fleet clock; step() advances the
    fleet by one event (control event, dispatch round, or one decode
    step on the earliest backend); run_until_drained() loops until
    every request has an outcome and returns a FleetReport. stream()
    yields one request's tokens live while driving the fleet."""

    def __init__(self, backends, *, heartbeat_s: float = 0.05,
                 cache_capacity: int = 128, max_attempts: int = 8,
                 retry_backoff_s: float = 0.02):
        self.backends: list[Backend] = [
            b if isinstance(b, Backend) else Backend(handle=b)
            for b in backends]
        self.heartbeat_s = float(heartbeat_s)
        self.max_attempts = int(max_attempts)
        self.retry_backoff_s = float(retry_backoff_s)
        self.cache = ResponseLRU(cache_capacity)
        self.clock_s = 0.0             # latest processed fleet event
        self.requests: dict[int, GatewayRequest] = {}
        self.pending: deque[int] = deque()     # gw uids awaiting dispatch
        self._ready_t: dict[int, float] = {}   # uid -> not-before time
        self._next_uid = 0
        self._fifo = deque(range(len(self.backends)))  # dispatch tiebreak
        self._events: list = []        # heap of (t, seq, fn)
        self._eseq = 0
        self.n_retries = 0
        self.rejected: list[RejectedRequest] = []
        self._on_token: list[Callable] = []    # streaming passthrough
        if self.backends and self.heartbeat_s > 0:
            self.at(self.heartbeat_s, self._heartbeat)

    # ------------------------------------------------- fleet events ----
    def at(self, t: float, fn: Callable):
        """Schedule a control event on the fleet clock (heartbeats,
        injected loss/rejoin, drains — anything scenario-shaped)."""
        heapq.heappush(self._events, (float(t), self._eseq, fn))
        self._eseq += 1

    def _heartbeat(self):
        """Probe every backend; detect losses (recall + redispatch
        in-flight work) and rejoins (breaker to half-open via its
        timer; `alive` flips back so dispatch may resume)."""
        now = self.clock_s
        for i, b in enumerate(self.backends):
            lost = getattr(b.handle, "lost", False)
            if lost and b.alive:
                b.alive = False
                b.breaker.trip(now)
                self._recall(i, now)
            elif not lost and not b.alive:
                b.alive = True         # rejoined: breaker still gates
        self.at(now + self.heartbeat_s, self._heartbeat)

    def _recall(self, i: int, now: float):
        """Pull a dead backend's in-flight requests back to the
        gateway queue; the backend's own state is cancelled so a
        rejoin starts clean. Partial streams restart from scratch on
        the new backend (the retry is a fresh decode)."""
        b = self.backends[i]
        if not b.inflight:
            return
        locals_, gw_uids = list(b.inflight), list(b.inflight.values())
        b.inflight.clear()
        b.handle.cancel(locals_)
        for uid in gw_uids:
            req = self.requests[uid]
            req.backend = None
            req.retries += 1
            req.epoch += 1
            req.tokens.clear()
            req.events.clear()
            req.first_token_time = None
            self.n_retries += 1
            self._ready_t[uid] = now
            self.pending.appendleft(uid)       # recalled work goes first

    # ---------------------------------------------------- admission ----
    def on_token(self, fn: Callable):
        """Register a streaming-passthrough callback
        fn(uid, token, t_s) invoked the moment a token is decoded (or
        replayed from cache)."""
        self._on_token.append(fn)

    def submit(self, prompt, max_new: int = 32,
               arrival_time: float = None) -> int:
        """Enqueue one request on the fleet clock; returns the gateway
        uid. A response-LRU hit completes immediately at arrival (zero
        decode work, the cached token stream replayed); an empty fleet
        rejects immediately (typed, never a hang)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if arrival_time is None:
            arrival_time = self.clock_s
        uid = self._next_uid
        self._next_uid += 1
        req = GatewayRequest(uid=uid, prompt=prompt, max_new=int(max_new),
                             arrival_time=float(arrival_time),
                             key=canonical_key(prompt, max_new))
        self.requests[uid] = req
        if not self.backends:
            self._reject(req, "empty_fleet", at=req.arrival_time)
            return uid
        cached = self.cache.get(req.key)
        if cached is not None:
            req.cache_hit = True
            req.tokens = list(cached)
            t = req.arrival_time
            req.events = [(t, tok) for tok in cached]
            req.first_token_time = t if cached else None
            req.finish_time = t
            req.done = True
            for fn in self._on_token:
                for tok in cached:
                    fn(uid, tok, t)
            return uid
        self._ready_t[uid] = req.arrival_time
        self.pending.append(uid)
        return uid

    def _reject(self, req: GatewayRequest, reason: str, at: float):
        req.done = True
        req.rejected = True
        req.reject_reason = reason
        req.finish_time = at
        self.rejected.append(RejectedRequest(req.uid, reason,
                                             req.attempts, at))

    # ----------------------------------------------------- dispatch ----
    def _pick_backend(self, now: float) -> Optional[int]:
        """Weighted least-loaded over eligible backends; FIFO
        tiebreak (least recently picked wins), so an idle homogeneous
        fleet round-robins deterministically."""
        best, best_score = None, None
        for i in self._fifo:
            b = self.backends[i]
            if not b.eligible(now):
                continue
            s = b.score()
            if best is None or s < best_score:
                best, best_score = i, s
        return best

    def _any_recoverable(self, now: float) -> bool:
        """Could some backend *become* eligible without gateway
        action? True while any live non-draining backend exists —
        its cap frees as work completes, its breaker half-opens on
        the fleet clock. Lost backends don't count (their rejoin is
        an external event the retry budget bounds the wait for)."""
        return any(b.alive and not b.draining for b in self.backends)

    def _dispatch_ready(self):
        """Dispatch every pending request that has arrived and has an
        eligible backend. Requests blocked only by concurrency caps
        stay queued for free (capacity frees via backend events);
        requests facing a fleet with no live backends consume a
        dispatch attempt and back off — a bounded budget, so the
        all-breakers-open case terminates in a typed rejection."""
        now = self.clock_s
        progressed = True
        while progressed and self.pending:
            progressed = False
            for _ in range(len(self.pending)):
                uid = self.pending.popleft()
                req = self.requests[uid]
                if self._ready_t[uid] > now:
                    self.pending.append(uid)
                    continue
                i = self._pick_backend(now)
                if i is None:
                    if self._any_recoverable(now):
                        # caps/breaker-timers will free up on their own
                        self.pending.append(uid)
                        continue
                    req.attempts += 1
                    if req.attempts >= self.max_attempts:
                        self._reject(req, "no_backend_available", at=now)
                        self._ready_t.pop(uid, None)
                    else:
                        self._ready_t[uid] = now + self.retry_backoff_s
                        self.pending.append(uid)
                        self.at(self._ready_t[uid], lambda: None)
                    continue
                b = self.backends[i]
                req.attempts += 1
                try:
                    local = b.handle.submit(req.prompt, req.max_new, now)
                except BackendUnavailable:
                    b.alive = False
                    b.breaker.record_failure(now)
                    self._recall(i, now)
                    req.retries += 1
                    self.n_retries += 1
                    self.pending.appendleft(uid)
                    progressed = True
                    continue
                b.breaker.on_dispatch()
                b.inflight[local] = uid
                b.n_dispatched += 1
                req.backend = i
                self._ready_t.pop(uid, None)
                self._fifo.remove(i)
                self._fifo.append(i)
                progressed = True

    # -------------------------------------------------- fleet clock ----
    def _wake_time(self) -> float:
        """Earliest *future* time gateway-side state changes on its
        own: a scheduled control event, a pending request's backoff
        expiry, or an open breaker's half-open transition (only
        relevant while requests are waiting). Strictly greater than
        the current clock, or +inf."""
        inf = float("inf")
        t = self._events[0][0] if self._events else inf
        for uid in self.pending:
            rt = self._ready_t[uid]
            if rt > self.clock_s:
                t = min(t, rt)
        if self.pending:
            for b in self.backends:
                if b.alive and not b.draining and b.breaker.state == OPEN:
                    rt = b.breaker.opened_at + b.breaker.open_timeout_s
                    if rt > self.clock_s:
                        t = min(t, rt)
        return t

    def _earliest_backend(self) -> Optional[int]:
        best, best_t = None, None
        for i, b in enumerate(self.backends):
            t = b.handle.next_event_time()
            if t is None:
                continue
            if best is None or t < best_t:
                best, best_t = i, t
        return best

    @property
    def has_work(self) -> bool:
        return any(not r.done for r in self.requests.values())

    def _harvest(self, i: int):
        """Step backend `i` once and forward its tokens/completions
        into the gateway's request state (the streaming passthrough
        moment)."""
        b = self.backends[i]
        r = b.handle.step()
        if r is None:
            return
        b.n_steps += 1
        # NOTE: the fleet clock does NOT jump to r.t_s (the step's
        # completion on the backend's own clock) — backends decode
        # concurrently, so the fleet clock tracks event *starts* and
        # stays <= every backend frontier; jumping it to a completion
        # would leapfrog pending arrivals past the other (idle)
        # backends and serialize the whole fleet behind one step.
        for local, tok in r.tokens.items():
            uid = b.inflight.get(local)
            if uid is None:
                continue
            req = self.requests[uid]
            req.tokens.append(int(tok))
            req.events.append((r.t_s, int(tok)))
            if req.first_token_time is None:
                req.first_token_time = r.t_s
            for fn in self._on_token:
                fn(uid, int(tok), r.t_s)
        for local in r.finished:
            uid = b.inflight.pop(local, None)
            if uid is None:
                continue
            req = self.requests[uid]
            req.done = True
            req.finish_time = r.t_s
            b.n_completed += 1
            b.breaker.record_success()
            self.cache.put(req.key, req.tokens)

    def step(self) -> bool:
        """Advance the fleet by one event: run due control events,
        dispatch what can land now, then either step the earliest-due
        backend or jump the clock to the next wake time. Returns
        False when fully drained (every request has an outcome and no
        backend holds work)."""
        if not self.has_work:
            return False
        while self._events and self._events[0][0] <= self.clock_s:
            _, _, fn = heapq.heappop(self._events)
            fn()
        self._dispatch_ready()
        t_wake = self._wake_time()
        i = self._earliest_backend()
        if i is not None:
            t_b = max(self.backends[i].handle.next_event_time(),
                      self.clock_s)
            if t_b <= t_wake:
                self.clock_s = t_b
                self._harvest(i)
                return True
        if t_wake != float("inf"):
            self.clock_s = t_wake
            return True
        # Nothing will ever wake us: no backend events, no control
        # events, no timers. Recall work hung on lost backends (the
        # no-heartbeat degenerate case) and reject what still cannot
        # land — a typed outcome beats a silent hang.
        for j, b in enumerate(self.backends):
            if getattr(b.handle, "lost", False) and b.inflight:
                b.alive = False
                self._recall(j, self.clock_s)
        self._dispatch_ready()
        if self._wake_time() == float("inf") \
                and self._earliest_backend() is None:
            for uid in list(self.pending):
                self._reject(self.requests[uid], "fleet_stalled",
                             at=self.clock_s)
                self._ready_t.pop(uid, None)
            self.pending.clear()
        return self.has_work

    # ------------------------------------------------ fleet control ----
    def fail_backend(self, i: int, at: float = None):
        """Model backend `i`'s host dying at fleet time `at` (now if
        None): submits start failing immediately; in-flight work hangs
        until the next heartbeat detects the loss and recalls it."""
        if at is None or at <= self.clock_s:
            self.backends[i].handle.lost = True
        else:
            self.at(at, lambda: setattr(self.backends[i].handle,
                                        "lost", True))

    def restore_backend(self, i: int, at: float = None):
        """Model the host coming back; the next heartbeat flips
        `alive` and the breaker's half-open canary readmits it."""
        if at is None or at <= self.clock_s:
            self.backends[i].handle.lost = False
        else:
            self.at(at, lambda: setattr(self.backends[i].handle,
                                        "lost", False))

    def drain_backend(self, i: int, at: float = None):
        """Draining: the backend finishes its in-flight requests and
        receives no new dispatches (rolling restarts without drops)."""
        if at is None or at <= self.clock_s:
            self.backends[i].draining = True
        else:
            self.at(at, lambda: setattr(self.backends[i], "draining",
                                        True))

    def undrain_backend(self, i: int):
        self.backends[i].draining = False

    # ----------------------------------------------------- draining ----
    def run_until_drained(self, max_events: int = 1000000) -> FleetReport:
        for _ in range(max_events):
            if not self.step():
                break
        return self.report()

    def stream(self, uid: int) -> Iterator[tuple]:
        """Drive the fleet until request `uid` finishes, yielding its
        (t_s, token) events as they are produced — the streaming
        passthrough, on the modeled clock. Cached responses replay
        instantly; rejected requests raise BackendUnavailable with
        the typed reason."""
        req = self.requests[uid]
        sent, epoch = 0, req.epoch
        while True:
            if req.epoch != epoch:     # recalled: the retry restarts
                sent, epoch = 0, req.epoch
            while sent < len(req.events):
                yield req.events[sent]
                sent += 1
            if req.done:
                break
            if not self.step():
                break
        if req.rejected:
            raise BackendUnavailable(
                f"request {uid} rejected: {req.reject_reason} "
                f"after {req.attempts} attempts")

    def report(self) -> FleetReport:
        reqs = list(self.requests.values())
        done = [r for r in reqs if r.done and not r.rejected]
        # span: the latest completion on any backend's timeline — the
        # fleet clock itself only tracks event starts (see _harvest)
        span = max([self.clock_s]
                   + [r.finish_time for r in reqs
                      if r.finish_time is not None])
        ttft_hit = np.array([r.ttft for r in done
                             if r.cache_hit and r.ttft is not None])
        ttft_miss = np.array([r.ttft for r in done
                              if not r.cache_hit and r.ttft is not None])
        per_backend = [
            {"weight": b.weight, "dispatched": b.n_dispatched,
             "completed": b.n_completed, "steps": b.n_steps,
             "breaker": b.breaker.state, "alive": b.alive,
             "draining": b.draining}
            for b in self.backends]
        return FleetReport(
            n_submitted=len(reqs),
            n_completed=len(done),
            n_rejected=len(self.rejected),
            n_retries=self.n_retries,
            cache_hits=self.cache.hits,
            cache_misses=self.cache.misses,
            total_tokens=sum(len(r.tokens) for r in done),
            span_s=span,
            ttft_hit=ttft_hit, ttft_miss=ttft_miss,
            rejected=list(self.rejected),
            per_backend=per_backend)

    def close(self):
        for b in self.backends:
            b.handle.close()


# ------------------------------------------------------ fleet builder ----

def local_fleet(cfg, model, plan, n: int, *, weights=None,
                max_concurrency: int = 8, share_jit: bool = True,
                **engine_kwargs) -> list:
    """`n` in-process ServeEngine replicas of the port behind
    EngineBackend handles, all serving the one `model` (its weights are
    shared, never copied). Each engine keeps its own scheduler, KV
    arena, storage plane, generator, clock and decode steps with their
    CUDA graphs: a captured graph binds to one engine's buffers, so
    nothing captured is shared. `share_jit` is kept for the reference's
    API and changes nothing: the one thing the engines share beyond the
    weights is the process-wide kernel library. The engine import is
    lazy, so this module imports without it."""
    if weights is not None and len(weights) != n:
        raise ValueError(
            f"weights has {len(weights)} entries for {n} engines")
    from repro_torch.serving.engine import ServeEngine
    engines = [ServeEngine(cfg, model, plan, **engine_kwargs)
               for _ in range(n)]
    weights = weights or [1.0] * n
    return [Backend(handle=EngineBackend(e), weight=float(w),
                    max_concurrency=max_concurrency)
            for e, w in zip(engines, weights)]


# ------------------------------------------------------- async facade ----

class AsyncGateway:
    """Asyncio front door over a FleetGateway: concurrent client
    coroutines await generations while one driver coroutine advances
    the fleet clock. The modeled clock still does the timing — the
    event loop only provides the concurrency surface a network server
    would mount (llm-farm's FastAPI /ask endpoint, made local)."""

    def __init__(self, gateway: FleetGateway):
        self.gw = gateway
        self._driving = False

    async def _drive(self):
        import asyncio
        if self._driving:
            return
        self._driving = True
        try:
            while self.gw.has_work:
                if not self.gw.step():
                    break
                await asyncio.sleep(0)     # yield to waiting clients
        finally:
            self._driving = False

    async def generate(self, prompt, max_new: int = 32,
                       arrival_time: float = None) -> list:
        """Submit and await the full token list (typed rejection
        raises BackendUnavailable)."""
        out = [tok async for tok in self.stream(prompt, max_new,
                                                arrival_time)]
        return out

    async def stream(self, prompt, max_new: int = 32,
                     arrival_time: float = None):
        """Async token iterator: yields each token as its backend
        step completes (or instantly on a response-LRU hit)."""
        import asyncio
        uid = self.gw.submit(prompt, max_new, arrival_time)
        req = self.gw.requests[uid]
        driver = asyncio.ensure_future(self._drive())
        sent, epoch = 0, req.epoch
        try:
            while True:
                if req.epoch != epoch:
                    sent, epoch = 0, req.epoch
                while sent < len(req.events):
                    yield req.events[sent][1]
                    sent += 1
                if req.done:
                    break
                if driver.done():
                    driver.result()    # crashed driver raises here
                await asyncio.sleep(0)
        finally:
            if req.done and not self.gw.has_work:
                await driver
            elif driver.done():
                driver.result()
        if req.rejected:
            raise BackendUnavailable(
                f"request {uid} rejected: {req.reject_reason}")
