"""`serving/sampler.py::sequence_logprob` and the four examples of the port
(`examples_torch/`) on the CPU, against the JAX package.

* `sequence_logprob` within 1e-6 of the reference's on the same logits.
* Each example's `main(device="cpu")` runs and returns its numbers.
* The numbers that no random draw decides equal the reference's:
  - quickstart: the plan table (`build_plan` on the PHONE profile);
  - best_of_n: the batch timeline (4 -> 1 as the staggered budgets run
    out) and the executable swaps, against the reference's engine run of
    its own example;
  - offloaded_serving: the (tok/s, TTFT, hit rate, I/O share) row of two
    (system, storage) pairs, the port's engine holding the reference
    engine's weights (as tests/test_torch_engine.py hands them over);
  - plan_and_inspect: on the reference's weights and the same numpy
    batches, the activation counts equal but for (token, neuron) pairs
    flagged by `kernels/ref.py::near_threshold`, the plan tables, the
    slow / fast tier sizing and the plan's round trip.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.serving.sampler import sequence_logprob

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"


@pytest.fixture(autouse=True)
def _two_threads():
    """Each example's CPU run on two intra-op threads: torch's default,
    one per core, oversubscribes a host that runs the suite's parallel
    workers, where quickstart's training slowed some fortyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _example(name):
    """The module examples_torch/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B,S,V", [(4, 16, 512), (2, 7, 1000)])
def test_sequence_logprob_matches_reference(B, S, V):
    from repro.serving.sampler import sequence_logprob as jsequence_logprob
    rng = np.random.default_rng(B * S)
    logits = (rng.standard_normal((B, S, V)) * 3).astype(np.float32)
    toks = rng.integers(0, V, (B, S)).astype(np.int32)
    want = np.asarray(jsequence_logprob(jnp.asarray(logits),
                                        jnp.asarray(toks)))
    got = sequence_logprob(torch.from_numpy(logits), torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    half = sequence_logprob(torch.from_numpy(logits).to(torch.bfloat16),
                            torch.from_numpy(toks))
    assert half.dtype == torch.float32


def test_quickstart_runs_and_plans_as_the_reference():
    from repro.configs import get_config
    from repro.core.planner import PHONE, build_plan
    out = _example("quickstart").main(device="cpu")
    assert len(out["losses"]) == 60 and out["losses"][-1] < out["losses"][0]
    assert out["tokens"].shape == (2, 16) and (out["tokens"] >= 0).all()
    plan = build_plan(get_config("smollm-135m").reduced(), hw=PHONE)
    assert out["plan"] == {b: (p.n_hot, p.total_cold)
                           for b, p in sorted(plan.plans.items())}


def test_best_of_n_timeline_and_swaps_match_reference():
    from repro.launch.serve import build_engine
    out = _example("best_of_n").main(device="cpu")
    engine, cfg = build_engine("smollm-135m", reduced=True, offload=0.5,
                               ctx_budget=32, temperature=1.0)
    base = np.random.default_rng(1).integers(0, cfg.vocab_size, 16) \
        .astype(np.int32)
    for n in (4, 8, 12, 16):
        engine.submit(base, max_new=n)
    rep = engine.run_until_drained()
    want = [s.batch for s in rep.stats]
    assert want[0] == 4 and want[-1] == 1
    assert out["batches"] == want
    assert out["switches"] == engine.decoder.switches
    assert out["scores"].shape == (4,) and np.isfinite(out["scores"]).all()
    assert out["best"] == int(np.argmax(out["scores"]))
    engine.close()


def test_offloaded_serving_rows_match_reference():
    """main() runs every row; two rows equal the reference engine's on
    the same weights and the same plan (the reference's PHONE plan: the
    port's engines plan on the paper's phone, the reference example's on
    its own default profile)."""
    from repro.configs import get_config as jget_config
    from repro.core import baselines as jbaselines
    from repro.core import io_model as jio
    from repro.core.planner import PHONE as JPHONE, build_plan as jbuild_plan
    from repro.models import dense as jdense
    from repro.serving.engine import ServeEngine as JEngine
    from repro.serving.families import _dense_prepare
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core import baselines, io_model
    from repro_torch.core.planner import PHONE, build_plan
    from repro_torch.serving.engine import ServeEngine
    ex = _example("offloaded_serving")
    rows = ex.main(device="cpu")
    assert len(rows) == 9
    jcfg = jget_config("smollm-135m").reduced()
    tcfg = get_config("smollm-135m").reduced()
    jplan = jbuild_plan(jcfg, hw=JPHONE)
    params = _dense_prepare(jdense.make_model(jcfg).init(jax.random.key(0)),
                            jplan)
    tree = jax.tree.map(np.asarray, params)
    plan = build_plan(tcfg, hw=PHONE)
    kw = dict(ex.ENGINE)
    kw["offload_ratio"] = kw.pop("offload")
    for spec, storage in (("LLMFLASH", "UFS31"), ("POWERINFER2",
                                                  "HOST_DMA")):
        jengine = JEngine(jcfg, params, jplan, seed=0,
                          spec=getattr(jbaselines, spec),
                          storage=getattr(jio, storage), **kw)
        engine = ServeEngine(tcfg, params_from_numpy(tree, tcfg, "cpu"),
                             plan, seed=0, spec=getattr(baselines, spec),
                             storage=getattr(io_model, storage), **kw)
        want = ex.serve_row(jengine, jcfg)
        assert ex.serve_row(engine, tcfg) == want
        jengine.close()
        engine.close()


def test_plan_and_inspect_matches_reference():
    from repro.configs import get_config
    from repro.core import planner as jplanner
    from repro.models.dense import make_model
    from repro_torch.core.planner import profile_ffn_inputs
    from repro_torch.bridge import params_from_numpy
    from test_torch_planner import _flags
    ex = _example("plan_and_inspect")
    assert ex.main(device="cpu")["round_trip"]
    cfg = ex.relu_config()
    jcfg = get_config("smollm-135m").reduced().replace(activation="relu2")
    jcfg = jcfg.replace(sparse_ffn=dataclasses.replace(jcfg.sparse_ffn,
                                                       mode="relu"))
    params = make_model(jcfg).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    out = ex.main(device="cpu", params=tree)
    batches = ex.batches(cfg)
    jcounts, jn = jplanner.profile_activations(
        params, jcfg, [jnp.asarray(b) for b in batches])
    assert out["n_tok"] == jn == 8 * 4 * 128
    diff = np.abs(out["counts"] - jcounts)
    if diff.any():
        X, _ = profile_ffn_inputs(params_from_numpy(tree, cfg, "cpu"), cfg,
                                  [torch.from_numpy(b) for b in batches])
        jX, _ = jplanner.profile_ffn_inputs(
            params, jcfg, [jnp.asarray(b) for b in batches])
        flags = _flags(np.asarray(jX), X.numpy(), tree["layers"]["ffn"]["w"],
                       cfg).sum(1)
        assert (diff <= flags).all() and (diff[flags == 0] == 0).all()
    freqs = (jcounts / jn).astype(np.float32)
    plan = jplanner.build_plan(jcfg, freqs, hw=jplanner.PHONE)
    assert out["plan"] == {b: (p.n_hot, p.total_cold)
                           for b, p in sorted(plan.plans.items())}
    tier = lambda bw: dataclasses.replace(jplanner.PHONE, seq_bw=bw)
    assert out["hot32"] == (
        jplanner.build_plan(jcfg, freqs, hw=tier(5e7)).plans[32].n_hot,
        jplanner.build_plan(jcfg, freqs, hw=tier(50e9)).plans[32].n_hot)
    assert out["round_trip"]
