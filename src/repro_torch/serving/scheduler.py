"""Request-level continuous-batching scheduler (DESIGN.md §4) and the
data-parallel replica router above it (DESIGN.md §5).

`BatchScheduler` tracks the full request lifecycle — queued (submitted,
not yet admitted), running (owns a KV slot, decoding), finished — and
the resulting effective-batch-size timeline that drives the dynamic
CPU/NPU adaptation (paper §4.1.3, Fig 13). Unlike the seed's passive
bookkeeping, requests can now *join* a running batch: `submit()`
enqueues, the engine admits per step up to the decoder's next bucket
boundary, so `batch_history` traces both growth and decay.

`ReplicaRouter` shards a request stream over the mesh's 'data' axis:
one `BatchScheduler` per replica, submits routed least-loaded with a
FIFO tiebreak, global uids mapped onto per-replica local uids. FIFO
head-of-line blocking is *per replica*: a not-yet-arrived head on one
replica never starves an arrived request on another.

All times are in the engine's modeled clock (seconds of effective
latency), not wall time.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Request:
    """One generation request through its whole lifecycle."""
    uid: int
    prompt_len: int
    max_new: int
    prompt: Optional[np.ndarray] = None    # (S,) int32; None for legacy add()
    arrival_time: float = 0.0
    generated: list = field(default_factory=list)
    finished: bool = False
    # modeled-clock timestamps, filled by the engine
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time


# Backwards-compatible name: the seed called these Sequences.
Sequence = Request


class BatchScheduler:
    """Admission queue + active set + batch-size timeline."""

    def __init__(self, eos_id: Optional[int] = None):
        self.eos_id = eos_id
        self.sequences: dict[int, Request] = {}
        self.queue: deque[int] = deque()        # submitted, not admitted
        self.running: list[int] = []            # admission order
        self._next_uid = 0
        self.batch_history: list[int] = []

    # ------------------------------------------------------ lifecycle ----
    def submit(self, prompt, max_new: int,
               arrival_time: float = 0.0) -> Request:
        """Enqueue a request for admission (continuous batching)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        req = Request(self._next_uid, int(prompt.shape[0]), max_new,
                      prompt=prompt, arrival_time=arrival_time)
        self._next_uid += 1
        self.sequences[req.uid] = req
        self.queue.append(req.uid)
        return req

    def add(self, prompt_len: int, max_new: int) -> Request:
        """Legacy static-batch entry: immediately running, no prompt."""
        req = Request(self._next_uid, prompt_len, max_new)
        self._next_uid += 1
        self.sequences[req.uid] = req
        self.running.append(req.uid)
        return req

    def pop_admissible(self, now: float, limit: int) -> list:
        """Dequeue up to `limit` requests that have arrived by `now`
        (FIFO; no reordering past the head — arrival order is part of
        the modeled workload)."""
        out = []
        while self.queue and len(out) < limit:
            req = self.sequences[self.queue[0]]
            if req.arrival_time > now:
                break
            self.queue.popleft()
            out.append(req)
        return out

    def admit(self, req: Request, now: float = 0.0):
        req.admit_time = now
        self.running.append(req.uid)

    def finish(self, uid: int, now: float = 0.0):
        """Force-finish (cancellation / Best-of-N early stop).

        Removing a *running* request is a batch-decay event that
        happens between step() calls, so it must land on the
        batch-size timeline the CPU/NPU adaptation consumes —
        otherwise the recorded history skips straight from the
        pre-cancel size to whatever the next step() appends. Dequeuing
        a still-queued request changes no live batch, so it records
        nothing."""
        req = self.sequences[uid]
        if not req.finished:
            req.finished = True
            req.finish_time = now
        if uid in self.running:
            self.running.remove(uid)
            self.batch_history.append(self.batch_size)
        elif uid in self.queue:
            self.queue.remove(uid)

    def next_arrival(self) -> Optional[float]:
        if not self.queue:
            return None
        return self.sequences[self.queue[0]].arrival_time

    # ----------------------------------------------------- properties ----
    @property
    def active(self) -> list:
        return [self.sequences[u] for u in self.running]

    @property
    def batch_size(self) -> int:
        return len(self.running)

    @property
    def load(self) -> int:
        """Outstanding work: submitted-but-unfinished requests — the
        load this scheduler *reports* upward (the replica router and
        the fleet gateway both route on it)."""
        return len(self.queue) + len(self.running)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.running)

    # ----------------------------------------------------------- step ----
    def step(self, tokens_by_uid: dict):
        """Record one generated token per active sequence; mark EOS /
        length completions. Returns uids that finished this step."""
        done = []
        for uid, tok in tokens_by_uid.items():
            seq = self.sequences[uid]
            seq.generated.append(int(tok))
            if ((self.eos_id is not None and int(tok) == self.eos_id)
                    or seq.n_generated >= seq.max_new):
                seq.finished = True
                done.append(uid)
        for uid in done:
            if uid in self.running:
                self.running.remove(uid)
        self.batch_history.append(self.batch_size)
        return done


# ----------------------------------------------------- replica routing ----

class ReplicaRouter:
    """Routes a request stream over per-replica BatchSchedulers
    (DESIGN.md §5 — the mesh's 'data' axis made real).

    Policy: least outstanding load (queued + running), ties broken
    FIFO over replicas (the replica assigned least recently wins), so
    an empty stream round-robins deterministically. The router owns
    the global-uid namespace — per-replica schedulers keep minting
    their own local uids, exactly as an independent single-replica
    engine would, which is what makes the dp=N engine token-identical
    to N independent dp=1 engines fed the routed sub-streams.

    It also quacks enough like a BatchScheduler (`sequences`,
    `has_work`, `batch_size`, `batch_history`) for report/benchmark
    consumers to stay replica-agnostic; `batch_history` is the merged
    timeline the owning engine appends to after every replica step
    (total running across replicas, on the shared modeled clock).
    """

    def __init__(self, schedulers):
        self.scheds: list[BatchScheduler] = list(schedulers)
        if not self.scheds:
            raise ValueError("ReplicaRouter needs at least one scheduler")
        self.assignment: dict[int, tuple] = {}   # global uid -> (r, local)
        self._global_of: dict[tuple, int] = {}   # (r, local) -> global uid
        self._next_uid = 0
        self._fifo = deque(range(len(self.scheds)))
        self.batch_history: list[int] = []

    # ------------------------------------------------------- routing ----
    def load_of(self, r: int) -> int:
        """Outstanding load: submitted-but-unfinished requests."""
        return self.scheds[r].load

    def pick_replica(self) -> int:
        """Least-loaded replica; FIFO tiebreak (least recently
        assigned). Pure read — the tiebreak queue rotates only when
        the routed submit actually lands (`bind`), so a submit that
        fails validation downstream leaves the deterministic routing
        order untouched."""
        best, best_load = None, None
        for r in self._fifo:
            load = self.load_of(r)
            if best is None or load < best_load:
                best, best_load = r, load
        return best

    def bind(self, replica: int, local_uid: int) -> int:
        """Register a routed submit; returns the global uid. Moves the
        replica to the back of the FIFO tiebreak queue."""
        uid = self._next_uid
        self._next_uid += 1
        self.assignment[uid] = (replica, local_uid)
        self._global_of[(replica, local_uid)] = uid
        self._fifo.remove(replica)
        self._fifo.append(replica)
        return uid

    def locate(self, uid: int) -> tuple:
        """Global uid -> (replica index, replica-local uid)."""
        return self.assignment[uid]

    def to_global(self, replica: int, local_uid: int) -> int:
        return self._global_of[(replica, local_uid)]

    def request(self, uid: int) -> Request:
        r, local = self.assignment[uid]
        return self.scheds[r].sequences[local]

    # ------------------------------------- scheduler-compatible views ----
    @property
    def sequences(self) -> dict:
        """Global-uid view of every routed request (submission order)."""
        return {uid: self.scheds[r].sequences[local]
                for uid, (r, local) in self.assignment.items()}

    @property
    def has_work(self) -> bool:
        return any(s.has_work for s in self.scheds)

    @property
    def load(self) -> int:
        """Fleet-facing load report: outstanding work summed over
        every replica (same contract as BatchScheduler.load)."""
        return sum(s.load for s in self.scheds)

    @property
    def batch_size(self) -> int:
        return sum(len(s.running) for s in self.scheds)

    @property
    def running(self) -> list:
        """Global uids currently decoding, replica-major order."""
        return [self._global_of[(r, u)]
                for r, s in enumerate(self.scheds) for u in s.running]
