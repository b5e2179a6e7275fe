"""The port's fleet gateway (`repro_torch.serving.gateway`) against the
JAX package's (`repro.serving.gateway`).

Each scenario of the reference's gateway tests (tests/test_gateway.py:
breaker, response LRU, weighted dispatch, concurrency caps, heartbeat
loss and rejoin, typed rejection, draining, streaming, the deterministic
fleet clock, AsyncGateway) runs once through each gateway over scripted
stub backends and must observe the same things, FleetReport included.
Then real engines: `local_fleet` over reduced smollm-135m (fp32) on the
same weights gives the reference fleet's tokens and report with a member
lost and restored mid-stream, a resubmitted prompt is a response-LRU
hit, and the port's `build_fleet` and CLI serve streams on the CPU. The
same fleet run and `build_fleet(2)` on reduced deepseek-moe-16b (the moe
family) as well.
"""
import asyncio
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.planner import PHONE as JPHONE, build_plan as jbuild_plan
from repro.models import dense as jdense
from repro.serving import gateway as jgw
from repro.serving.engine import StepResult as JStepResult
from repro.serving.families import _dense_prepare, serving_family
from repro.serving.storage_plane import TokenStats as JTokenStats
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.core.planner import PHONE, build_moe_plan, build_plan
from repro_torch.serving import gateway as tgw
from repro_torch.serving.engine import StepResult as TStepResult
from repro_torch.serving.storage_plane import TokenStats as TTokenStats


def _stub_class(gw, step_result, token_stats):
    class StubBackend(gw.BackendHandle):
        """Scripted backend: each request decodes `max_new` tokens, one
        per step of `step_s` modeled seconds, FIFO one at a time."""

        def __init__(self, step_s=0.01, tokens=(1, 2, 3, 4, 5, 6, 7, 8)):
            self.step_s = step_s
            self.toks = list(tokens)
            self.clock_s = 0.0
            self.queue = []                # [local uid, max_new, done]
            self._uid = 0
            self.lost = False
            self.n_submits = 0

        def submit(self, prompt, max_new, arrival_time):
            if self.lost:
                raise gw.BackendUnavailable("down")
            uid = self._uid
            self._uid += 1
            self.n_submits += 1
            self.clock_s = max(self.clock_s, arrival_time)
            self.queue.append([uid, int(max_new), 0])
            return uid

        def step(self):
            if self.lost or not self.queue:
                return None
            uid, max_new, n = self.queue[0]
            self.clock_s += self.step_s
            self.queue[0][2] = n + 1
            fin = []
            if n + 1 >= max_new:
                self.queue.pop(0)
                fin = [uid]
            st = token_stats(compute_s=self.step_s, io_s=0.0,
                             effective_s=self.step_s, cache_hit_rate=1.0,
                             n_miss=0, batch=1)
            return step_result(stats=st, tokens={uid: self.toks[n]},
                               finished=fin, t_s=self.clock_s)

        def cancel(self, local_uids):
            self.queue = [q for q in self.queue
                          if q[0] not in set(local_uids)]

        @property
        def load(self):
            return len(self.queue)

        def next_event_time(self):
            if self.lost or not self.queue:
                return None
            return self.clock_s + self.step_s
    return StubBackend


SIDES = {
    "jax": SimpleNamespace(gw=jgw, Stub=_stub_class(jgw, JStepResult,
                                                    JTokenStats)),
    "torch": SimpleNamespace(gw=tgw, Stub=_stub_class(tgw, TStepResult,
                                                      TTokenStats)),
}


def _report(rep) -> dict:
    """A FleetReport as plain values (arrays as lists)."""
    out = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)}
    for k in ("ttft_hit", "ttft_miss"):
        out[k] = None if out[k] is None else out[k].tolist()
    out["rejected"] = [dataclasses.asdict(r) for r in rep.rejected]
    out.update(throughput_tok_s=rep.throughput_tok_s, drained=rep.drained,
               ttft_hit_pct=rep.ttft_percentiles("hit"),
               ttft_miss_pct=rep.ttft_percentiles("miss"))
    return out


def _gw(m, n=2, **kw):
    kw.setdefault("heartbeat_s", 0.005)
    kw.setdefault("cache_capacity", 0)
    return m.gw.FleetGateway([m.Stub() for _ in range(n)], **kw)


# --------------------------------------------------------- scenarios ----
# each takes one side and returns what it observed; the reference's own
# assertions hold inside, on both sides

def breaker(m):
    g = m.gw
    br = g.CircuitBreaker(failure_threshold=3, open_timeout_s=1.0)
    states = [br.state, br.allow(0.0)]
    br.record_failure(0.0)
    br.record_failure(0.0)
    br.record_success()
    br.record_failure(0.1)
    br.record_failure(0.1)
    states.append(br.state)
    br.record_failure(0.2)
    states += [br.state, br.allow(0.5)]
    assert states == [g.CLOSED, True, g.CLOSED, g.OPEN, False]
    br = g.CircuitBreaker(failure_threshold=1, open_timeout_s=1.0,
                          half_open_probes=1)
    br.record_failure(0.0)
    states += [br.state, br.allow(1.5), br.state]
    br.on_dispatch()
    states.append(br.allow(1.6))
    br.record_success()
    states.append(br.state)
    br.record_failure(2.0)
    states += [br.allow(3.5), br.state]
    br.on_dispatch()
    br.record_failure(3.6)
    states += [br.state, br.opened_at]
    assert states[-2:] == [g.OPEN, 3.6]
    return states


def response_lru(m):
    g = m.gw
    lru = g.ResponseLRU(capacity=2)
    ka = g.canonical_key([1, 2, 3], 4)
    keys = [ka == g.canonical_key(np.array([1, 2, 3], np.int64), 4),
            ka != g.canonical_key([1, 2, 3], 5)]
    lru.put(ka, [7, 8])
    kb = g.canonical_key([9], 4)
    lru.put(kb, [1])
    got = [lru.get(ka)]
    lru.put(g.canonical_key([5], 4), [2])
    got += [lru.get(kb), lru.get(ka), lru.hits, lru.misses]
    off = g.ResponseLRU(capacity=0)
    off.put(ka, [7])
    got += [off.get(ka), len(off), off.hits, off.misses]
    assert all(keys) and got == [[7, 8], None, [7, 8], 2, 1, None, 0, 0, 0]
    return keys, got


def weighted_dispatch(m):
    g = m.gw
    gw = g.FleetGateway([g.Backend(handle=m.Stub(), weight=2.0,
                                   max_concurrency=64),
                         g.Backend(handle=m.Stub(), weight=1.0,
                                   max_concurrency=64)],
                        heartbeat_s=0.0, cache_capacity=0)
    for i in range(12):
        gw.submit([i], max_new=2, arrival_time=0.0)
    rep = gw.run_until_drained()
    d = [b["dispatched"] for b in rep.per_backend]
    assert rep.drained and d == [8, 4]
    return _report(rep)


def concurrency_cap(m):
    g = m.gw
    gw = g.FleetGateway([g.Backend(handle=m.Stub(), max_concurrency=2)],
                        heartbeat_s=0.0, cache_capacity=0)
    uids = [gw.submit([i], max_new=2, arrival_time=0.0) for i in range(5)]
    gw.step()
    first = (len(gw.backends[0].inflight), len(gw.pending))
    rep = gw.run_until_drained()
    attempts = [gw.requests[u].attempts for u in uids]
    assert first == (2, 3) and attempts == [1] * 5
    return first, attempts, _report(rep)


def round_robin(m):
    gw = _gw(m, 3, heartbeat_s=0.0)
    order = []
    for i in range(6):
        gw.submit([i], max_new=1, arrival_time=float(i))
        gw.run_until_drained()
        order.append([b.n_dispatched for b in gw.backends])
    assert order[-1] == [2, 2, 2]
    return order


def dispatch_failure(m):
    gw = _gw(m, 2, heartbeat_s=0.0)
    gw.backends[0].handle.lost = True
    uid = gw.submit([1], max_new=2, arrival_time=0.0)
    rep = gw.run_until_drained()
    out = (gw.requests[uid].retries, gw.backends[0].alive,
           gw.backends[1].n_completed)
    assert out[0] >= 1 and not out[1] and out[2] == 1
    return out, _report(rep)


def heartbeat_loss_rejoin(m):
    g = m.gw
    gw = g.FleetGateway(
        [g.Backend(handle=m.Stub(), max_concurrency=4,
                   breaker=g.CircuitBreaker(open_timeout_s=0.02))
         for _ in range(2)], heartbeat_s=0.01, cache_capacity=0)
    for i in range(4):
        gw.submit([i], max_new=4, arrival_time=0.0)
    while not gw.backends[1].inflight:
        assert gw.step()
    lost = list(gw.backends[1].inflight.values())
    gw.backends[1].handle.lost = True
    gw.restore_backend(1, at=0.05)
    for i in range(6):
        gw.submit([10 + i], max_new=4, arrival_time=0.06 + 0.01 * i)
    rep = gw.run_until_drained()
    b1 = gw.backends[1]
    assert rep.drained and rep.n_rejected == 0 and rep.n_retries >= 1
    assert b1.alive and b1.breaker.state == g.CLOSED and b1.n_completed
    return lost, b1.breaker.state, b1.n_completed, _report(rep)


def typed_rejection(m):
    gw = _gw(m, 2, max_attempts=3, retry_backoff_s=0.001)
    gw.backends[0].handle.lost = True
    gw.backends[1].handle.lost = True
    uid = gw.submit([1], max_new=4, arrival_time=0.0)
    rep = gw.run_until_drained(max_events=10000)
    with pytest.raises(m.gw.BackendUnavailable,
                       match="no_backend_available") as e:
        list(gw.stream(uid))
    assert rep.n_rejected == 1 and rep.rejected[0].attempts == 3
    return str(e.value), _report(rep)


def empty_fleet(m):
    gw = m.gw.FleetGateway([], heartbeat_s=0.01)
    gw.submit([1, 2], max_new=4)
    rep = gw.run_until_drained()
    assert rep.rejected[0].reason == "empty_fleet"
    return _report(rep), _report(m.gw.FleetReport())


def stalled_guard(m):
    gw = m.gw.FleetGateway([m.Stub(), m.Stub()], heartbeat_s=0.0,
                           cache_capacity=0, max_attempts=2,
                           retry_backoff_s=0.001)
    for i in range(2):
        gw.submit([i], max_new=4, arrival_time=0.0)
    gw.step()
    gw.backends[0].handle.lost = True
    gw.backends[1].handle.lost = True
    rep = gw.run_until_drained(max_events=10000)
    assert rep.drained and rep.n_rejected == 2
    return _report(rep)


def draining(m):
    gw = _gw(m, 2, heartbeat_s=0.0)
    for i in range(4):
        gw.submit([i], max_new=3, arrival_time=0.0)
    while not gw.backends[1].inflight:
        gw.step()
    before = gw.backends[1].n_dispatched
    gw.drain_backend(1)
    for i in range(4):
        gw.submit([10 + i], max_new=3, arrival_time=gw.clock_s)
    rep = gw.run_until_drained()
    during = gw.backends[1].n_dispatched
    gw.undrain_backend(1)
    gw.submit([99], max_new=1, arrival_time=gw.clock_s)
    gw.run_until_drained()
    assert during == before and gw.backends[1].n_dispatched == before + 1
    return before, _report(rep), _report(gw.report())


def lru_hit_ttft(m):
    gw = m.gw.FleetGateway([m.Stub()], heartbeat_s=0.0, cache_capacity=8)
    u1 = gw.submit([5, 6], max_new=3, arrival_time=0.0)
    gw.run_until_drained()
    n = gw.backends[0].handle.n_submits
    u2 = gw.submit([5, 6], max_new=3, arrival_time=1.0)
    rep = gw.run_until_drained()
    assert gw.requests[u2].cache_hit and gw.requests[u2].tokens == \
        gw.requests[u1].tokens and gw.backends[0].handle.n_submits == n
    assert float(rep.ttft_hit[0]) == 0.0 < float(rep.ttft_miss[0])
    return _report(rep)


def streaming(m):
    gw = m.gw.FleetGateway([m.Stub(step_s=0.01)], heartbeat_s=0.0,
                           cache_capacity=8)
    seen = []
    gw.on_token(lambda uid, tok, t: seen.append((uid, tok, t)))
    uid = gw.submit([1], max_new=4, arrival_time=0.0)
    out = list(gw.stream(uid))
    uid2 = gw.submit([1], max_new=4, arrival_time=gw.clock_s)
    again = list(gw.stream(uid2))
    assert [t for _, t in out] == [t for _, t in again] == [1, 2, 3, 4]
    return out, again, seen, _report(gw.report())


def deterministic_clock(m):
    def once():
        gw = _gw(m, 3, heartbeat_s=0.004)
        rng = np.random.default_rng(7)
        arr = np.cumsum(rng.exponential(0.003, 10))
        for i, t in enumerate(arr):
            gw.submit([i % 4], max_new=3, arrival_time=float(t))
        gw.fail_backend(2, at=float(arr[3]))
        gw.restore_backend(2, at=float(arr[3]) + 0.05)
        return _report(gw.run_until_drained())
    a = once()
    assert a == once()
    return a


def async_gateway(m):
    g = m.gw
    gw = g.FleetGateway([m.Stub(), m.Stub()], heartbeat_s=0.0,
                        cache_capacity=8)
    agw = g.AsyncGateway(gw)

    async def main():
        toks = []

        async def consume():
            async for tok in agw.stream([9], max_new=3):
                toks.append(tok)
        a, b, _ = await asyncio.gather(agw.generate([1], max_new=4),
                                       agw.generate([2], max_new=2),
                                       consume())
        return a, b, toks
    out = asyncio.run(main())
    assert out == ([1, 2, 3, 4], [1, 2], [1, 2, 3])
    rep = _report(gw.report())

    async def rejected():
        gw.backends[0].handle.lost = True
        gw.backends[1].handle.lost = True
        await agw.generate([3], max_new=2)
    with pytest.raises(g.BackendUnavailable) as e:
        asyncio.run(rejected())

    crashed = g.FleetGateway([m.Stub()], heartbeat_s=0.0)

    def boom():
        raise RuntimeError("driver crashed")
    crashed.step = boom
    with pytest.raises(RuntimeError, match="driver crashed"):
        asyncio.run(g.AsyncGateway(crashed).generate([1], max_new=4))
    return out, rep, str(e.value)


def fleet_weights_mismatch(m):
    with pytest.raises(ValueError, match="weights") as e:
        m.gw.local_fleet(None, None, None, n=2, weights=[1.0])
    return str(e.value)


SCENARIOS = [breaker, response_lru, weighted_dispatch, concurrency_cap,
             round_robin, dispatch_failure, heartbeat_loss_rejoin,
             typed_rejection, empty_fleet, stalled_guard, draining,
             lru_hit_ttft, streaming, deterministic_clock, async_gateway,
             fleet_weights_mismatch]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_gateway_scenario_matches_reference(scenario):
    assert scenario(SIDES["torch"]) == scenario(SIDES["jax"])


def test_gateway_names_match_reference():
    assert tgw.__all__ == jgw.__all__
    for name in jgw.__all__:
        assert hasattr(tgw, name)
    assert [f.name for f in dataclasses.fields(tgw.FleetReport)] == \
        [f.name for f in dataclasses.fields(jgw.FleetReport)]


# ------------------------------------------------------ real engines ----

ENGINE_KW = dict(seed=0, buckets=(1, 2, 4), ctx_budget=32, temperature=0.0,
                 offload_ratio=0.5)
N_REQ = 8


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("smollm-135m").reduced()
    tcfg = tget_config("smollm-135m").reduced()
    params = jdense.make_model(jcfg).init(jax.random.key(4))
    jplan = jbuild_plan(jcfg, hw=JPHONE)
    params = _dense_prepare(params, jplan)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, jplan, tcfg, tree, build_plan(tcfg, hw=PHONE)


def _fleet_run(gw, vocab):
    """N_REQ staggered requests, backend 1 lost at 1 ms and restored at
    3 ms, then the first prompt resubmitted (a response-LRU hit)."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, 12).astype(np.int32)
               for _ in range(N_REQ)]
    arrivals = np.cumsum(rng.exponential(2e-4, N_REQ))
    uids = [gw.submit(p, max_new=5, arrival_time=float(t))
            for p, t in zip(prompts, arrivals)]
    gw.fail_backend(1, at=1e-3)
    gw.restore_backend(1, at=3e-3)
    rep = gw.run_until_drained()
    steps = sum(b.n_steps for b in gw.backends)
    hit = gw.submit(prompts[0], max_new=5, arrival_time=gw.clock_s)
    rep2 = gw.run_until_drained()
    req = gw.requests
    assert req[hit].cache_hit and req[hit].tokens == req[uids[0]].tokens
    assert sum(b.n_steps for b in gw.backends) == steps
    return dict(tokens=[list(req[u].tokens) for u in uids],
                backend_of=[req[u].backend for u in uids],
                retries=[req[u].retries for u in uids],
                report=_report(rep), after_hit=_report(rep2))


@pytest.fixture(scope="module")
def fleet_runs(weights):
    jcfg, params, jplan, tcfg, tree, tplan = weights
    out = []
    for gw_mod, cfg, model, plan in (
            (jgw, jcfg, params, jplan),
            (tgw, tcfg, params_from_numpy(tree, tcfg, device="cpu"), tplan)):
        gw = gw_mod.FleetGateway(
            gw_mod.local_fleet(cfg, model, plan, 2, backend="pallas",
                               **ENGINE_KW),
            heartbeat_s=5e-4, cache_capacity=8)
        out.append(_fleet_run(gw, cfg.vocab_size))
        gw.close()
    return out


@pytest.mark.parametrize("key", ["tokens", "backend_of", "retries",
                                 "report", "after_hit"])
def test_engine_fleet_matches_reference(fleet_runs, key):
    jrun, trun = fleet_runs
    assert trun[key] == jrun[key]


def test_engine_fleet_survives_the_loss(fleet_runs):
    _, trun = fleet_runs
    rep = trun["report"]
    assert rep["drained"] and rep["n_completed"] == N_REQ
    assert rep["n_rejected"] == 0 and rep["n_retries"] >= 1
    assert all(len(t) == 5 for t in trun["tokens"])
    assert all(b["completed"] for b in rep["per_backend"])


def test_local_fleet_engines_share_the_model_only(weights):
    _, _, _, tcfg, tree, tplan = weights
    model = params_from_numpy(tree, tcfg, device="cpu")
    a, b = (x.handle.engine for x in tgw.local_fleet(
        tcfg, model, tplan, 2, **ENGINE_KW))
    assert a.model is b.model is model
    assert a.decoder is not b.decoder and a.storage is not b.storage
    assert a.arena is None and b.arena is None
    a.close()
    b.close()


def test_build_fleet_is_local_fleet_over_the_seeded_model():
    """build_fleet on the CPU serves the tokens of local_fleet over the
    model that make_model draws from the same seed."""
    from repro_torch.launch.serve import build_fleet
    from repro_torch.serving.families import serving_family
    tcfg = tget_config("smollm-135m").reduced()
    fam = serving_family(tcfg)
    plan = fam.build_plan(tcfg, hw=PHONE)
    model = fam.prepare_params(fam.make_model(tcfg, device="cpu", seed=0),
                               plan)
    runs = []
    for gw in (build_fleet("smollm-135m", 2, device="cpu",
                           engine_kwargs=dict(temperature=0.0,
                                              buckets=(1, 2, 4)),
                           heartbeat_s=5e-4, cache_capacity=8)[0],
               tgw.FleetGateway(tgw.local_fleet(
                   tcfg, model, plan, 2, seed=0, temperature=0.0,
                   buckets=(1, 2, 4)), heartbeat_s=5e-4, cache_capacity=8)):
        runs.append(_fleet_run(gw, tcfg.vocab_size))
        gw.close()
    assert runs[0] == runs[1]


@pytest.mark.parametrize("flags,want", [
    (["--dp", "2"], ["dp=2", "modeled serve:", "modeled ttft ms: mean",
                     "p90", "16 tokens on cpu"]),
    (["--fleet", "2"], ["fleet=2", "modeled fleet serve:", "4/4 completed",
                        "per-backend [2, 2] completed", "16 tokens on cpu"]),
    (["--family", "vlm"], ["arch=qwen2-vl-2b", "modeled decode:"]),
])
def test_serve_cli_streams(capsys, flags, want):
    from repro_torch.launch.serve import main
    main(["--reduced", "--device", "cpu", "--bon", "4", "--max-new", "4",
          "--temperature", "0", *flags])
    out = capsys.readouterr().out
    for w in want:
        assert w in out, (w, out)


def test_serve_cli_fleet_excludes_dp(capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit):
        main(["--reduced", "--device", "cpu", "--fleet", "2", "--dp", "2"])
    assert "--dp doesn't apply" in capsys.readouterr().err


# ---------------------------------------------------------------- moe ----

@pytest.fixture(scope="module")
def moe_fleet_runs():
    """`_fleet_run` through both gateways over two reduced
    deepseek-moe-16b engines on the same weights."""
    jcfg = jget_config("deepseek-moe-16b").reduced()
    tcfg = tget_config("deepseek-moe-16b").reduced()
    fam = serving_family(jcfg)
    jplan = fam.build_plan(jcfg, hw=JPHONE)
    params = fam.prepare_params(fam.make_model(jcfg).init(
        jax.random.key(4)), jplan)
    tree = jax.tree.map(np.asarray, params)
    out = []
    for gw_mod, cfg, model, plan in (
            (jgw, jcfg, params, jplan),
            (tgw, tcfg, params_from_numpy(tree, tcfg, device="cpu"),
             build_moe_plan(tcfg, hw=PHONE))):
        gw = gw_mod.FleetGateway(
            gw_mod.local_fleet(cfg, model, plan, 2, **ENGINE_KW),
            heartbeat_s=5e-4, cache_capacity=8)
        out.append(_fleet_run(gw, cfg.vocab_size))
        gw.close()
    return out


@pytest.mark.parametrize("key", ["tokens", "backend_of", "retries",
                                 "report", "after_hit"])
def test_engine_fleet_moe_matches_reference(moe_fleet_runs, key):
    jrun, trun = moe_fleet_runs
    assert trun[key] == jrun[key]
    if key == "report":
        assert trun[key]["n_completed"] == N_REQ


def test_build_fleet_moe_is_local_fleet_over_the_seeded_model():
    from repro_torch.launch.serve import build_fleet
    from repro_torch.serving.families import serving_family as tfamily
    tcfg = tget_config("deepseek-moe-16b").reduced()
    fam = tfamily(tcfg)
    plan = fam.build_plan(tcfg, hw=PHONE)
    model = fam.prepare_params(fam.make_model(tcfg, device="cpu", seed=0),
                               plan)
    runs = []
    for gw in (build_fleet("deepseek-moe-16b", 2, device="cpu",
                           engine_kwargs=dict(temperature=0.0,
                                              buckets=(1, 2, 4)),
                           heartbeat_s=5e-4, cache_capacity=8)[0],
               tgw.FleetGateway(tgw.local_fleet(
                   tcfg, model, plan, 2, seed=0, temperature=0.0,
                   buckets=(1, 2, 4)), heartbeat_s=5e-4, cache_capacity=8)):
        runs.append(_fleet_run(gw, tcfg.vocab_size))
        gw.close()
    assert runs[0] == runs[1]
