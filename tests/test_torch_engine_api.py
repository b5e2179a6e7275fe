"""The dp=1 engine's API against the JAX package's engine, on the same
reduced smollm-135m weights (fp32), plan and buckets (1, 2, 4), greedy:
one stream at each storage model (UFS 4.0, UFS 3.1, host DMA) gives
identical TokenStats, TTFTs, token latencies, percentiles and
throughput, and identical load / next_event_time after every step;
Best-of-N batch decay through generate(completion_schedule=, eos_id=)
gives the reference's tokens, batch sizes and decoder switches; the
storage models and their derates are the reference's; the cold
store's `price` counts what the reference's `fetch` counts. Exact
equality throughout: both engines price the same traces with the same
float64 host arithmetic.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import io_model as jio
from repro.core.planner import PHONE as JPHONE, build_plan as jbuild_plan
from repro.models import dense as jdense
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.families import _dense_prepare
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.core import io_model as tio
from repro_torch.core.planner import PHONE, build_plan
from repro_torch.serving.engine import ServeEngine as TEngine

BUCKETS = (1, 2, 4)
STORAGES = ("UFS40", "UFS31", "HOST_DMA")
# (prompt length, max_new, arrival on the modeled clock): the last one
# arrives after the engine has drained, so it exercises the idle jump
STREAM = [(8, 6, 0.0), (8, 5, 2e-4), (12, 4, 5e-4), (8, 3, 1.0)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("smollm-135m").reduced()
    tcfg = tget_config("smollm-135m").reduced()
    params = jdense.make_model(jcfg).init(jax.random.key(1))
    jplan = jbuild_plan(jcfg, hw=JPHONE)
    params = _dense_prepare(params, jplan)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, jplan, tcfg, tree, build_plan(tcfg, hw=PHONE)


@pytest.fixture(scope="module")
def engines(weights):
    """(JAX engine, port engine) per storage model. The JAX engines share
    one table of jitted steps and prefills, as the reference's own
    meshless replicas do, so each step is traced once."""
    jcfg, params, jplan, tcfg, tree, tplan = weights
    built = {}

    def get(name):
        if name not in built:
            kw = dict(buckets=BUCKETS, temperature=0.0, seed=0,
                      backend="pallas")
            je = JEngine(jcfg, params, jplan, storage=getattr(jio, name),
                         **kw)
            if built:
                first = next(iter(built.values()))[0]
                je.decoder._cache = first.decoder._cache
                je._prefill_fns = first._prefill_fns
            te = TEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"),
                         tplan, storage=getattr(tio, name), **kw)
            built[name] = (je, te)
        return built[name]
    yield get
    for je, te in built.values():
        je.close()
        te.close()


def _stats(stats):
    return [dataclasses.asdict(s) for s in stats]


def _report(r):
    return (_stats(r.stats), r.span_s, r.total_tokens, r.tokens_per_s,
            r.throughput_tok_s, r.ttft().tolist(),
            r.token_latencies().tolist(), r.latency_percentiles())


def test_storage_models_match_reference():
    for name in STORAGES:
        t, j = getattr(tio, name), getattr(jio, name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for core in ("big", "mid", "little"):
            assert dataclasses.asdict(tio.with_core(t, core)) == \
                dataclasses.asdict(jio.with_core(j, core))
        for n in (0, 1, 2, 5, 9):
            tq = tio.with_queue_contention(t, n)
            assert dataclasses.asdict(tq) == \
                dataclasses.asdict(jio.with_queue_contention(j, n))
            for bs in (4096, 24576, 10 ** 6):
                assert tq.read_time(1 << 20, bs, True) == \
                    jio.with_queue_contention(j, n).read_time(1 << 20, bs,
                                                              True)


@pytest.mark.parametrize("storage", STORAGES)
def test_engine_api_matches_jax(engines, weights, storage):
    je, te = engines(storage)
    assert te.storage.coldstore.storage.name == getattr(tio, storage).name
    for attr in ("timing", "hw"):
        assert dataclasses.asdict(getattr(te, attr)) == \
            dataclasses.asdict(getattr(je, attr))
    assert te.cache.capacity == je.cache.capacity
    assert te.coldstore.bundle_bytes() == je.coldstore.bundle_bytes()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, weights[0].vocab_size, s).astype(np.int32)
               for s, _, _ in STREAM]
    out = []
    for e in (je, te):
        seen = [(e.load, e.next_event_time())]
        uids = [e.submit(p, max_new=m, arrival_time=t)
                for p, (_, m, t) in zip(prompts, STREAM)]
        seen.append((e.load, e.next_event_time()))
        stats = []
        while (r := e.step()) is not None:
            stats.append(r.stats)
            seen.append((e.load, e.next_event_time()))
        gen = [e.sched.sequences[u].generated for u in uids]
        # the same stream again, through run_until_drained's report
        for p, (_, m, t) in zip(prompts, STREAM):
            e.submit(p, max_new=m, arrival_time=e.clock_s + t)
        out.append((seen, _stats(stats), gen, _report(e.run_until_drained())))
    assert out[1] == out[0]
    seen, _, gen, rep = out[1]
    assert seen[0] == (0, None) and seen[-1] == (0, None)
    assert [len(g) for g in gen] == [m for _, m, _ in STREAM]
    assert rep[4] > 0 and len(rep[5]) == 2 * len(STREAM)


def test_best_of_n_decay_matches_jax(engines, weights):
    """Four samples of one prompt, cancelled one by one after steps 3, 6
    and 9, and an EOS token taken from the run without one: the batch
    decays 4 -> 1 down the bucket ladder, and the tokens, batch sizes
    and decoder switches are the reference's."""
    je, te = engines("UFS40")
    prompt = np.repeat(np.random.default_rng(5).integers(
        0, weights[0].vocab_size, (1, 10)).astype(np.int32), 4, axis=0)
    prompt[:, -1] = np.arange(4)           # four different samples
    sched = {3: 1, 6: 1, 9: 1}
    eos = None
    for _ in range(2):                     # without an EOS, then with one
        kw = dict(completion_schedule=sched, eos_id=eos)
        res, switches = [], []
        for e in (je, te):
            before = e.decoder.switches
            res.append(e.generate(prompt, max_new=12, temperature=0.0, **kw))
            switches.append(e.decoder.switches - before)
        jr, tr = res
        np.testing.assert_array_equal(tr.tokens, jr.tokens)
        assert _stats(tr.stats) == _stats(jr.stats)
        assert switches[1] == switches[0] >= 2
        batches = [s.batch for s in tr.stats]
        assert batches[0] == 4 and batches[-1] == 1
        assert sorted(batches, reverse=True) == batches
        assert te.sched.eos_id is None       # restored after the call
        if eos is None:
            assert 4 in batches and 2 in batches
            eos = int(tr.tokens[3, 4])
    # row 3, never cancelled, ended at the EOS
    row = tr.tokens[3].tolist()
    assert row[row.index(eos) + 1:] == [-1] * (11 - row.index(eos))


def test_serve_cli_on_host_dma(capsys):
    from repro_torch.launch.serve import main
    main(["--reduced", "--device", "cpu", "--backend", "pallas", "--bon",
          "3", "--max-new", "4", "--temperature", "0", "--host-dma"])
    out = capsys.readouterr().out
    assert "storage=host-dma" in out and "modeled decode:" in out
    assert "12 tokens on cpu" in out


def test_arena_grows_under_live_requests_like_jax(engines, weights):
    """Requests submitted while others decode: the arena starts at the
    one-slot bucket and grows under live requests when the batch
    passes it (rows and logits kept); tokens and TokenStats stay the
    reference engine's."""
    jcfg, params, jplan, tcfg, tree, tplan = weights
    # a fresh reference engine (its storage plane cold, as the port's)
    # on the fixture's table of jitted steps
    je = JEngine(jcfg, params, jplan, buckets=BUCKETS, temperature=0.0,
                 seed=0, backend="pallas", ctx_budget=24)
    warm = engines("UFS40")[0]
    je.decoder._cache = warm.decoder._cache
    je._prefill_fns = warm._prefill_fns
    te = TEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"), tplan,
                 buckets=BUCKETS, temperature=0.0, seed=0, backend="pallas",
                 ctx_budget=24)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size, s).astype(np.int32)
               for s in (8, 8, 12)]
    out, caps = [], []
    for e in (je, te):
        uids, stats, k = [e.submit(prompts[0], max_new=7)], [], 0
        while True:
            if k == 2:
                uids += [e.submit(p, max_new=4) for p in prompts[1:]]
            r = e.step()
            if r is None:
                break
            stats.append(r.stats)
            if e is te:
                caps.append(te.arena.capacity)
            k += 1
        out.append(([e.sched.sequences[u].generated for u in uids],
                    _stats(stats)))
    je.close()
    te.close()
    assert out[1] == out[0]
    assert caps[:2] == [1, 1] and caps[2:] == [4] * (len(caps) - 2)
    assert max(s["batch"] for s in out[1][1]) == 3


def test_arena_capacity_follows_the_batch_and_prewarm(weights):
    """generate() at B=1 holds a one-slot arena; a larger batch grows it
    to its bucket, a smaller one keeps it; prewarm builds every bucket's
    step on an arena grown to max_slots, and the tokens stay those of a
    fresh engine."""
    _, _, _, tcfg, tree, tplan = weights

    def engine():
        return TEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"),
                       tplan, buckets=BUCKETS, temperature=0.0, seed=0,
                       backend="pallas")
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, tcfg.vocab_size, (3, 8)).astype(np.int32)
    te = engine()
    with pytest.raises(RuntimeError, match="serve a step first"):
        te.prewarm()
    got, caps = [], []
    for rows in ([0], [0, 1, 2], [1]):
        got.append(te.generate(prompts[rows], max_new=5,
                               temperature=0.0).tokens)
        caps.append(te.arena.capacity)
    te.prewarm()
    assert te.arena.capacity == 4 and set(te.decoder.live_plans()) == \
        set(BUCKETS)
    got.append(te.generate(prompts[[1]], max_new=5, temperature=0.0).tokens)
    te.close()
    assert caps == [1, 4, 4]
    for rows, toks in zip(([0], [0, 1, 2], [1], [1]), got):
        fresh = engine()
        np.testing.assert_array_equal(
            toks, fresh.generate(prompts[rows], max_new=5,
                                 temperature=0.0).tokens)
        fresh.close()


@pytest.mark.parametrize("two_phase", [False, True])
@pytest.mark.parametrize("storage", STORAGES)
def test_cold_store_price_matches_reference_fetch(storage, two_phase):
    """price() gives the reference fetch()'s bytes, ops and modeled
    seconds, and the same running totals, without copying rows out."""
    from repro.core.coldstore import ColdStore as JStore
    from repro_torch.core.coldstore import ColdStore as TStore
    rng = np.random.default_rng(3)
    bundles = [rng.standard_normal((64, 3, 16)).astype(np.float32)
               for _ in range(2)]
    kw = dict(two_phase=two_phase, block_size=4096,
              bundle_bytes_override=24576, count_scale=2.5)
    j = JStore(bundles, storage=getattr(jio, storage), **kw)
    t = TStore(bundles, storage=getattr(tio, storage), **kw)
    for layer in (0, 1, 1):
        ids = rng.choice(64, 20, replace=False)
        gate = rng.random(20) < 0.8
        a = j.fetch(layer, ids, gate)
        b = t.price(layer, ids, gate)
        assert b.rows is None and a.rows.shape == (20, 3, 16)
        assert (b.nbytes, b.io_time, b.n_ops) == (a.nbytes, a.io_time,
                                                  a.n_ops)
    assert (t.total_fetches, t.total_bytes, t.total_io_time) == \
        (j.total_fetches, j.total_bytes, j.total_io_time)
