"""ServeEngine parity: the port's engine and the JAX package's, on the
same reduced smollm-135m weights (fp32) and the same plan
(build_plan(..., hw=PHONE) on both sides), buckets (1, 2, 4), serve a
staggered stream of 3 requests at temperature 0. Tokens, request
timestamps and every TokenStats field must be identical, through
run_until_drained and through generate, on both cold-path backends.
The JAX engines are built once per module.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.planner import PHONE as JPHONE, build_plan as jbuild_plan
from repro.models import dense as jdense
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.families import _dense_prepare
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.core.planner import PHONE, build_plan
from repro_torch.serving.engine import ServeEngine as TEngine

BUCKETS = (1, 2, 4)
# (prompt length, max_new, arrival on the modeled clock)
STREAM = [(8, 6, 0.0), (8, 5, 2e-4), (12, 4, 5e-4)]


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
    jcfg, params, jplan, tcfg, tree, tplan = weights
    built = {}

    def get(backend):
        if backend not in built:
            kw = dict(buckets=BUCKETS, temperature=0.0, seed=0,
                      backend=backend)
            je = JEngine(jcfg, params, jplan, **kw)
            te = TEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"),
                         tplan, **kw)
            built[backend] = (je, te)
        return built[backend]
    yield get
    for je, te in built.values():
        je.close()
        te.close()


def _stats(stats):
    return [dataclasses.asdict(s) for s in stats]


def _serve(engine, prompts):
    uids = [engine.submit(p, max_new=m, arrival_time=t)
            for p, (_, m, t) in zip(prompts, STREAM)]
    rep = engine.run_until_drained()
    seqs = engine.sched.sequences
    reqs = [(seqs[u].generated, seqs[u].admit_time, seqs[u].first_token_time,
             seqs[u].finish_time) for u in uids]
    return rep, reqs


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_engine_stream_matches_jax(engines, weights, backend):
    je, te = engines(backend)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, weights[0].vocab_size, s).astype(np.int32)
               for s, _, _ in STREAM]
    jrep, jreqs = _serve(je, prompts)
    trep, treqs = _serve(te, prompts)
    assert treqs == jreqs
    for (gen, *_), (_, m, _) in zip(treqs, STREAM):
        assert len(gen) == m
    assert _stats(trep.stats) == _stats(jrep.stats)
    assert trep.span_s == jrep.span_s
    # the stream really grew and shrank the batch across buckets
    hist = te.sched.batch_history
    assert hist == je.sched.batch_history
    assert max(hist) == 3 and hist[0] < 3
    assert te.decoder.live_plans().keys() == {1, 2, 4}


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_engine_generate_matches_jax(engines, weights, backend):
    je, te = engines(backend)
    prompt = np.random.default_rng(3).integers(
        0, weights[0].vocab_size, (2, 10)).astype(np.int32)
    jres = je.generate(prompt, max_new=5, temperature=0.0)
    tres = te.generate(prompt, max_new=5, temperature=0.0)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    assert _stats(tres.stats) == _stats(jres.stats)
