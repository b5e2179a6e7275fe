"""The port's replica-routed engine (`ServeEngine(..., dp=2)`) against the
JAX package's meshless dp=2 engine, on the same reduced smollm-135m
weights (fp32), plan and buckets (1, 2, 4), greedy. One staggered stream
of six requests, with a running request of replica 1 cancelled mid-way,
is served by both; the routed replica of every uid, the tokens, the
merged ServeReport (span, span throughput, TTFT, latency percentiles),
the load and next event time after every step, and the cancel's routing
must be identical. The port's dp=2 must also give the tokens of two
independent port dp=1 engines fed the streams the router gave each
replica (the reference's golden). Exact equality throughout: both
engines price the same traces with the same float64 host arithmetic.
The same stream and report through both dp=2 engines on reduced
deepseek-moe-16b (the moe family, (L, E) expert-count traces) must be
identical too.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.planner import PHONE as JPHONE, build_plan as jbuild_plan
from repro.models import dense as jdense
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.families import _dense_prepare, serving_family
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.core.planner import PHONE, build_moe_plan, build_plan
from repro_torch.serving.engine import ServeEngine as TEngine

BUCKETS = (1, 2, 4)
KW = dict(buckets=BUCKETS, temperature=0.0, seed=0, ctx_budget=40)
# (prompt length, max_new, arrival on the modeled clock)
STREAM = [(8, 6, 0.0), (8, 5, 0.0), (12, 4, 2e-4), (8, 7, 3e-4),
          (10, 3, 5e-4), (8, 4, 1.0)]
CANCEL_AFTER = 4          # steps before the cancel of a running request


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("smollm-135m").reduced()
    tcfg = tget_config("smollm-135m").reduced()
    params = jdense.make_model(jcfg).init(jax.random.key(2))
    jplan = jbuild_plan(jcfg, hw=JPHONE)
    params = _dense_prepare(params, jplan)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, jplan, tcfg, tree, build_plan(tcfg, hw=PHONE)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, s).astype(np.int32) for s, _, _ in STREAM]


def _serve(e, prompts):
    """STREAM through engine e, cancelling after CANCEL_AFTER steps the
    first running request of replica 1. Returns what the comparison
    reads."""
    seen = [(e.load, e.next_event_time())]
    uids = [e.submit(p, max_new=m, arrival_time=t)
            for p, (_, m, t) in zip(prompts, STREAM)]
    seen.append((e.load, e.next_event_time()))
    steps, cancelled = [], None
    while True:
        if len(steps) == CANCEL_AFTER:
            local = e.replicas[1].sched.running[0]
            cancelled = e.router.to_global(1, local)
            e.cancel([cancelled])
            seen.append((e.load, e.next_event_time()))
        r = e.step()
        if r is None:
            break
        steps.append((r.replica, r.t_s, sorted(r.tokens.items()),
                      r.admitted, r.finished))
        seen.append((e.load, e.next_event_time()))
    reqs = e.sched.sequences
    return dict(
        uids=uids, assignment=dict(e.router.assignment), steps=steps,
        seen=seen, cancelled=cancelled,
        tokens={u: list(reqs[u].generated) for u in uids},
        times={u: (reqs[u].first_token_time, reqs[u].finish_time)
               for u in uids},
        history=list(e.sched.batch_history), clock=e.clock_s)


def _report(r):
    return dict(stats=[dataclasses.asdict(s) for s in r.stats],
                uids=[q.uid for q in r.requests], span_s=r.span_s,
                total_tokens=r.total_tokens, tokens_per_s=r.tokens_per_s,
                throughput_tok_s=r.throughput_tok_s,
                ttft=r.ttft().tolist(), latency=r.latency_percentiles())


@pytest.fixture(scope="module")
def runs(weights):
    """(reference run, port run, reference report, port report): the
    stream through each dp=2 engine, then the same prompts again at the
    shared clock through run_until_drained's merged report."""
    jcfg, params, jplan, tcfg, tree, tplan = weights
    je = JEngine(jcfg, params, jplan, dp=2, **KW)
    te = TEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"), tplan,
                 dp=2, **KW)
    prompts = _prompts(jcfg.vocab_size)
    out = []
    for e in (je, te):
        run = _serve(e, prompts)
        for p, (_, m, t) in zip(prompts, STREAM):
            e.submit(p, max_new=m, arrival_time=e.clock_s + t)
        out.append((run, _report(e.run_until_drained())))
    je.close()
    te.close()
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.parametrize("key", ["assignment", "uids", "tokens", "steps",
                                 "times", "history", "clock"])
def test_dp2_matches_reference(runs, key):
    jrun, trun, _, _ = runs
    assert trun[key] == jrun[key]


def test_dp2_uses_both_replicas(runs):
    _, trun, _, _ = runs
    assert {r for r, _ in trun["assignment"].values()} == {0, 1}
    assert {s[0] for s in trun["steps"]} == {0, 1}


def test_dp2_load_and_next_event_time_match_reference(runs):
    jrun, trun, _, _ = runs
    assert trun["seen"] == jrun["seen"]
    assert trun["seen"][0] == (0, None) and trun["seen"][-1] == (0, None)
    assert trun["seen"][1][0] == len(STREAM)


def test_dp2_cancel_routes_to_the_owning_replica(runs):
    jrun, trun, _, _ = runs
    u = trun["cancelled"]
    assert u == jrun["cancelled"] and trun["assignment"][u][0] == 1
    m = STREAM[u][1]
    assert 0 < len(trun["tokens"][u]) < m
    assert all(len(t) == STREAM[v][1] for v, t in trun["tokens"].items()
               if v != u)


@pytest.mark.parametrize("key", ["stats", "uids", "span_s", "total_tokens",
                                 "tokens_per_s", "throughput_tok_s", "ttft",
                                 "latency"])
def test_dp2_report_matches_reference(runs, key):
    _, _, jrep, trep = runs
    assert trep[key] == jrep[key]


def test_dp2_report_merges_both_timelines(runs):
    _, _, _, trep = runs
    assert {s["replica"] for s in trep["stats"]} == {0, 1}
    assert trep["throughput_tok_s"] > 0
    assert trep["total_tokens"] == sum(m for _, m, _ in STREAM)


def test_dp2_equals_two_routed_dp1_engines(weights, runs):
    """The golden: each replica decodes the tokens an independent dp=1
    engine gives on the sub-stream the router sent it (no cancel here,
    so the streams are whole). The dp=1 engine's storage plane holds a
    replica's half share of the resident cache, or its modeled clock,
    and with it the step that admits a later arrival, could differ."""
    _, _, _, tcfg, tree, tplan = weights
    prompts = _prompts(tcfg.vocab_size)
    model = params_from_numpy(tree, tcfg, device="cpu")
    dp = TEngine(tcfg, model, tplan, dp=2, **KW)
    uids = [dp.submit(p, max_new=m, arrival_time=t)
            for p, (_, m, t) in zip(prompts, STREAM)]
    dp.run_until_drained()
    got = {u: list(dp.sched.sequences[u].generated) for u in uids}
    assignment = dict(dp.router.assignment)
    dp.close()
    want = {}
    for r in (0, 1):
        one = TEngine(tcfg, model, tplan, n_replicas=2, **KW)
        local = {one.submit(prompts[g], max_new=STREAM[g][1],
                            arrival_time=STREAM[g][2]): g
                 for g, (rep, _) in sorted(assignment.items()) if rep == r}
        one.run_until_drained()
        want.update({g: list(one.sched.sequences[u].generated)
                     for u, g in local.items()})
        one.close()
    assert got == want


def test_dp2_replicas_share_the_model_and_nothing_else(weights):
    """Each replica has its own scheduler, arena buffers, storage plane
    (a half share of the resident cache, the reference's) and decode
    steps, over one model; the engine's plane views are replica 0's."""
    jcfg, params, jplan, tcfg, tree, tplan = weights
    te = TEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"), tplan,
                 dp=2, **KW)
    je = JEngine(jcfg, params, jplan, dp=2, **KW)
    a, b = te.replicas
    assert a.model is b.model is te.model
    for x, y in ((a.sched, b.sched), (a.storage, b.storage),
                 (a.decoder, b.decoder), (a.generator, b.generator)):
        assert x is not y
    assert a._tokens.data_ptr() != b._tokens.data_ptr()
    assert te.cache.capacity == je.cache.capacity == a.cache.capacity
    one = TEngine(tcfg, te.model, tplan, **KW)
    assert a.storage.n_replicas == 2 and one.storage.n_replicas == 1
    assert te.cache.capacity < one.cache.capacity
    for attr in ("timing", "hw"):
        assert dataclasses.asdict(getattr(te, attr)) == \
            dataclasses.asdict(getattr(je, attr))
    assert te.max_slots == je.max_slots == BUCKETS[-1]
    assert te.coldstore.bundle_bytes() == je.coldstore.bundle_bytes()
    with pytest.raises(ValueError, match="replica-routed"):
        te.generate(np.zeros((2, 4), np.int32), max_new=2)
    with pytest.raises(ValueError, match="at least one replica"):
        TEngine(tcfg, te.model, tplan, dp=0, **KW)
    for e in (te, je, one):
        e.close()


# ---------------------------------------------------------------- moe ----

@pytest.fixture(scope="module")
def moe_runs():
    """The stream and the merged report through both dp=2 engines on
    reduced deepseek-moe-16b, as `runs` does for smollm-135m."""
    jcfg = jget_config("deepseek-moe-16b").reduced()
    tcfg = tget_config("deepseek-moe-16b").reduced()
    fam = serving_family(jcfg)
    jplan = fam.build_plan(jcfg, hw=JPHONE)
    params = fam.prepare_params(fam.make_model(jcfg).init(
        jax.random.key(2)), jplan)
    tree = jax.tree.map(np.asarray, params)
    tplan = build_moe_plan(tcfg, hw=PHONE)
    prompts = _prompts(jcfg.vocab_size)
    out = []
    for e in (JEngine(jcfg, params, jplan, dp=2, **KW),
              TEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"),
                      tplan, dp=2, **KW)):
        run = _serve(e, prompts)
        for p, (_, m, t) in zip(prompts, STREAM):
            e.submit(p, max_new=m, arrival_time=e.clock_s + t)
        out.append((run, _report(e.run_until_drained())))
        e.close()
    return out


@pytest.mark.parametrize("key", ["assignment", "uids", "tokens", "steps",
                                 "seen", "cancelled", "times", "history",
                                 "clock", "report"])
def test_dp2_moe_matches_reference(moe_runs, key):
    (jrun, jrep), (trun, trep) = moe_runs
    want, got = (jrep, trep) if key == "report" else (jrun[key], trun[key])
    assert got == want
    if key == "assignment":
        assert {r for r, _ in got.values()} == {0, 1}
