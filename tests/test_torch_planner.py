"""The offline planner's profiling half, the predictor's initializer, the
kernel calibration and the synthetic corpus in the port, against the JAX
package on the same numpy weights and tokens (reduced configs, fp32).

* `ffn_activation_counts` (CATS and relu) and `profile_activations` on
  smollm-135m, its relu2/relu variant, qwen3-14b (qk-norm, its norm
  weights drawn at random) and the qwen2-vl-2b backbone: counts and
  n_tokens identical, except (token, neuron) pairs whose fp64 |h| lies
  within the flagged distance of the threshold (`near_threshold`: the
  dot's fp32 rounding plus the measured difference of the two FFN
  inputs); `profile_ffn_inputs`: X within 1e-5 of its scale, H
  identical but for flagged pairs.
* `calibrate_predictor`: A@B and the scores on held-out x within 1e-5
  relative of the reference's new params (the port writes the module in
  place), also when the predictor rank exceeds min(D, N) (padding);
  `predictor_quality` within 1e-6.
* `build_engine(profile=True)`: the reference's plan from the port's
  profiling tokens (neuron_order, HybridPlans) and the reference
  engine's greedy tokens.
* `SyntheticTokens` batches bit-identical; `KernelCalibration` rows,
  bench JSON and `hardware(PHONE)` field for field the reference's, and
  `hardware()` without a base raises.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import io_model as jio
from repro.core import planner as jplanner
from repro.core import predictor as jpredictor
from repro.data import pipeline as jpipeline
from repro.serving import families as jfamilies
from repro.serving.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import io_model as tio
from repro_torch.core import planner as tplanner
from repro_torch.core import predictor as tpredictor
from repro_torch.data import pipeline as tpipeline
from repro_torch.kernels.ref import near_threshold
from repro_torch.launch import serve as tserve
from repro_torch.models.blocks import FFN
from repro_torch.serving import families as tfamilies
from test_torch_archs import _norms_at_random


def _relu(cfg):
    """The relu2 / relu-mode variant of a config (tests/test_planner.py's
    relu_model)."""
    return cfg.replace(activation="relu2", sparse_ffn=dataclasses.replace(
        cfg.sparse_ffn, mode="relu"))


ARCHS = {
    "smollm-135m": ("smollm-135m", lambda c: c),
    "smollm-135m-relu": ("smollm-135m", _relu),
    "qwen3-14b": ("qwen3-14b", lambda c: c),
    "qwen2-vl-2b": ("qwen2-vl-2b", lambda c: c),
}


def _batches(cfg, seed=0, n=2, shape=(2, 32)):
    data = tpipeline.SyntheticTokens(tpipeline.DataConfig(
        cfg.vocab_size, shape[1], shape[0], seed=seed))
    return [data.batch()["tokens"] for _ in range(n)]


class Case:
    """One reduced config: the reference's params (jnp) and the port's
    model (CPU) on the same numpy weights, and the profiling tokens."""

    def __init__(self, name, seed=0, **sparse):
        arch, variant = ARCHS[name]
        self.jcfg = variant(jconfigs.get_config(arch).reduced())
        self.tcfg = variant(tconfigs.get_config(arch).reduced())
        if sparse:
            self.jcfg = self.jcfg.replace(sparse_ffn=dataclasses.replace(
                self.jcfg.sparse_ffn, **sparse))
            self.tcfg = self.tcfg.replace(sparse_ffn=dataclasses.replace(
                self.tcfg.sparse_ffn, **sparse))
        jfam = jfamilies.serving_family(self.jcfg)
        params = jfam.make_model(self.jcfg).init(jax.random.key(seed))
        # every norm weight at random (the reference inits them to zero),
        # so qk-norm and the (1 + w) scales are exercised
        self.tree = _norms_at_random(params, seed + 1)
        self.params = jax.tree.map(jnp.asarray, self.tree)
        self.tokens = _batches(self.tcfg, seed)

    def model(self):
        return params_from_numpy(self.tree, self.tcfg, device="cpu")

    def jtokens(self):
        return [jnp.asarray(t) for t in self.tokens]


@pytest.fixture(scope="module")
def cases():
    built = {}

    def get(name, **sparse):
        key = (name, tuple(sorted(sparse.items())))
        if key not in built:
            built[key] = Case(name, **sparse)
        return built[key]
    return get


def _flags(X_ref, X_port, ffn_w, cfg):
    """(L, T, N) flags of every layer (`near_threshold` on the
    reference's X, with the measured per-layer input difference)."""
    out = []
    for l in range(X_ref.shape[0]):
        dx = float(np.abs(X_port[l] - X_ref[l]).max())
        out.append(near_threshold(
            torch.from_numpy(np.array(X_ref[l])),
            torch.from_numpy(np.array(ffn_w[l])),
            cfg.activation, cfg.sparse_ffn.mode, dx=dx).numpy())
    return np.stack(out)


# -------------------------------------------------------- profiling ----

@pytest.mark.parametrize("mode", ["cats", "relu"])
def test_ffn_activation_counts_match_reference(mode):
    rng = np.random.default_rng(3)
    act = "silu" if mode == "cats" else "relu2"
    x = (rng.standard_normal((3, 5, 48)) * 0.8).astype(np.float32)
    w = (rng.standard_normal((96, 3, 48)) / np.sqrt(48)).astype(np.float32)
    if mode == "relu":
        w[::7, 0] = 0.0                 # exact zeros: g = 0 is inactive
    got = tplanner.ffn_activation_counts(torch.from_numpy(w),
                                         torch.from_numpy(x), act, mode)
    want = np.asarray(jplanner.ffn_activation_counts(
        {"w": jnp.asarray(w)}, jnp.asarray(x), act, mode))
    flags = near_threshold(torch.from_numpy(x), torch.from_numpy(w),
                                    act, mode).numpy().sum(0)
    assert got.shape == (96,) and got.dtype == torch.int64
    diff = np.abs(got.numpy() - want)
    assert (diff <= flags).all()
    assert (diff[flags == 0] == 0).all()
    if mode == "relu":
        assert (got.numpy()[::7] == 0).all()


@pytest.mark.parametrize("mode", ["cats", "relu"])
def test_near_threshold_flags_knife_edges(mode):
    """The gate g = w0 + w1 (x = [1, 1, 0, ...], u = 1): a pair whose
    |h| sits on the threshold (two products cancelling to it) is
    flagged, one 1e-3 past it is not unless a measured input difference
    of 1e-2 widens the band, and ones far away never are."""
    act = "silu" if mode == "cats" else "relu2"
    edge = 0.18325553790911997 if mode == "cats" else 0.0   # |h| = tau
    x = torch.zeros(1, 8)
    x[0, :2] = 1.0
    w = torch.zeros(4, 3, 8)
    w[:, 0, 0] = 1.0
    w[:, 0, 1] = torch.tensor([edge, edge + 1e-3, 3.0, -3.0]) - 1.0
    w[:, 1, 0] = 1.0
    flags = near_threshold(x, w, act, mode)
    assert flags.tolist() == [[True, False, False, False]]
    wide = near_threshold(x, w, act, mode, dx=1e-2)
    assert wide.tolist() == [[True, True, False, False]]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_profile_activations_match_reference(cases, name):
    c = cases(name)
    counts, n_tok = tplanner.profile_activations(c.model(), c.tcfg,
                                                 c.tokens)
    jcounts, jn = jplanner.profile_activations(c.params, c.jcfg,
                                               c.jtokens())
    assert n_tok == jn == 2 * 2 * 32
    assert counts.dtype == np.int64 and counts.shape == jcounts.shape == \
        (c.tcfg.num_layers, c.tcfg.d_ff)
    X, _ = tplanner.profile_ffn_inputs(c.model(), c.tcfg, c.tokens)
    jX, _ = jplanner.profile_ffn_inputs(c.params, c.jcfg, c.jtokens())
    flags = _flags(np.asarray(jX), X.numpy(), c.tree["layers"]["ffn"]["w"],
                   c.tcfg).sum(1)
    diff = np.abs(counts - jcounts)
    assert (diff <= flags).all()
    assert (diff[flags == 0] == 0).all()
    assert 0 < counts.sum() < counts.size * n_tok


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_profile_ffn_inputs_match_reference(cases, name):
    c = cases(name)
    X, H = tplanner.profile_ffn_inputs(c.model(), c.tcfg, c.tokens)
    jX, jH = (np.asarray(a) for a in
              jplanner.profile_ffn_inputs(c.params, c.jcfg, c.jtokens()))
    L, T = c.tcfg.num_layers, 2 * 2 * 32
    assert X.shape == (L, T, c.tcfg.d_model) and X.dtype == torch.float32
    assert H.shape == (L, T, c.tcfg.d_ff) and H.dtype == torch.bool
    np.testing.assert_allclose(X.numpy(), jX, rtol=0,
                               atol=1e-5 * np.abs(jX).max())
    flags = _flags(jX, X.numpy(), c.tree["layers"]["ffn"]["w"], c.tcfg)
    assert not (H.numpy() != jH)[~flags].any()


# -------------------------------------------------------- calibration ----

def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("name,rank", [("smollm-135m", None),
                                       ("smollm-135m-relu", None),
                                       ("smollm-135m", 300)],
                         ids=["cats", "relu", "rank-past-min-D-N"])
def test_calibrate_predictor_matches_reference(cases, name, rank):
    """The reference returns new params; the port writes the same
    predictor into its module in place (same tensors, new values)."""
    c = cases(name, **({} if rank is None else {"predictor_rank": rank}))
    model = c.model()
    held = np.random.default_rng(4).standard_normal(
        (16, c.tcfg.d_model)).astype(np.float32)
    before = [(l.ffn.pred_A, l.ffn.pred_B) for l in model.layers]
    out = tplanner.calibrate_predictor(model, c.tcfg, c.tokens)
    assert out is model
    jparams = jplanner.calibrate_predictor(c.params, c.jcfg, c.jtokens())
    jpred = jparams["layers"]["ffn"]["pred"]
    r = c.tcfg.sparse_ffn.predictor_rank
    for l, layer in enumerate(model.layers):
        A, B = layer.ffn.pred_A, layer.ffn.pred_B
        assert A is before[l][0] and B is before[l][1]
        assert A.shape == (c.tcfg.d_model, r) and A.dtype == torch.float32
        jA, jB = np.asarray(jpred["A"][l]), np.asarray(jpred["B"][l])
        P = A.double().numpy() @ B.double().numpy()
        assert _rel(P, jA.astype(np.float64) @ jB) <= 1e-5
        s = tpredictor.predict_scores(A, B, torch.from_numpy(held)).numpy()
        js = np.asarray(jpredictor.predict_scores(
            {"A": jA, "B": jB}, jnp.asarray(held)))
        assert _rel(s, js) <= 1e-5
        if rank is not None:         # padded past min(D, N)
            m = min(c.tcfg.d_model, c.tcfg.d_ff)
            assert not A[:, m:].any() and not B[m:].any()


@pytest.mark.parametrize("name", ["smollm-135m", "smollm-135m-relu"])
def test_predictor_quality_matches_reference(cases, name):
    c = cases(name)
    model = c.model()
    q0 = tplanner.predictor_quality(model, c.tcfg, c.tokens)
    assert abs(q0 - jplanner.predictor_quality(
        c.params, c.jcfg, c.jtokens())) <= 1e-6
    tplanner.calibrate_predictor(model, c.tcfg, c.tokens)
    jparams = jplanner.calibrate_predictor(c.params, c.jcfg, c.jtokens())
    q1 = tplanner.predictor_quality(model, c.tcfg, c.tokens)
    assert abs(q1 - jplanner.predictor_quality(
        jparams, c.jcfg, c.jtokens())) <= 1e-6
    assert q1 > q0


def test_ridge_truncation_equals_svd_truncation():
    """The port truncates through the Gram matrix's eigendecomposition;
    the product equals numpy's SVD truncation, wide and tall, rank
    deficient included."""
    rng = np.random.default_rng(5)
    for shape, r in (((40, 90), 6), ((90, 40), 6), ((40, 90), 40)):
        W = rng.standard_normal(shape)
        if r == 40:
            W = W[:, :10] @ rng.standard_normal((10, shape[1]))
        U, S, Vt = tplanner._truncate(torch.from_numpy(W), r)
        u, s, vt = np.linalg.svd(W, full_matrices=False)
        got = ((U * S) @ Vt).numpy()
        assert np.isfinite(Vt.numpy()).all()
        assert _rel(got, (u[:, :r] * s[:r]) @ vt[:r]) <= 1e-12


# ------------------------------------------------ predictor and init ----

def test_predictor_init_and_proba():
    g = torch.Generator().manual_seed(3)
    A, B = tpredictor.init_predictor(48, 96, 8, torch.float32, g, "cpu")
    assert A.shape == (48, 8) and B.shape == (8, 96)
    assert A.abs().max() <= 2.0 / np.sqrt(48) and \
        B.abs().max() <= 2.0 / np.sqrt(8)
    x = np.random.default_rng(6).standard_normal((5, 48)).astype(np.float32)
    got = tpredictor.predict_proba(A, B, torch.from_numpy(x)).numpy()
    want = np.asarray(jpredictor.predict_proba(
        {"A": A.numpy(), "B": B.numpy()}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # FFN.init_weights draws w, then the predictor through init_predictor
    cfg = tconfigs.get_config("smollm-135m").reduced()
    ffn = FFN(cfg, torch.float32, "cpu")
    ffn.init_weights(torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(2)
    from repro_torch.models.modules import dense_init
    dense_init(tuple(ffn.w.shape), torch.float32, g, "cpu")
    A, B = tpredictor.init_predictor(cfg.d_model, cfg.d_ff,
                                     cfg.sparse_ffn.predictor_rank,
                                     torch.float32, g, "cpu")
    assert torch.equal(ffn.pred_A, A) and torch.equal(ffn.pred_B, B)


# ------------------------------------------------------ the entry point ----

def test_build_engine_profile_matches_reference(cases, monkeypatch):
    """build_engine(profile=True) on the reference's weights profiles the
    reference's counts (but for flagged pairs) and serves the reference's
    plan from those counts: its neuron_order and HybridPlans, and the
    reference engine's greedy tokens on that plan."""
    c = cases("smollm-135m")
    fam = tfamilies.serving_family(c.tcfg)
    bridged = dataclasses.replace(
        fam, make_model=lambda cfg, device, seed: params_from_numpy(
            c.tree, cfg, device))
    monkeypatch.setattr(tserve, "serving_family", lambda cfg: bridged)
    kw = dict(buckets=(2,), temperature=0.0, seed=0)
    engine, cfg = tserve.build_engine("smollm-135m", reduced=True,
                                      profile=True, device="cpu", **kw)
    batches = tserve.profile_batches(cfg, "cpu", 0)
    assert [tuple(b.shape) for b in batches] == [(4, 64)] * 4
    jbatches = [jnp.asarray(b.numpy()) for b in batches]
    counts, n_tok = tplanner.profile_activations(c.model(), cfg, batches)
    jcounts, _ = jplanner.profile_activations(c.params, c.jcfg, jbatches)
    X, _ = tplanner.profile_ffn_inputs(c.model(), cfg, batches)
    jX, _ = jplanner.profile_ffn_inputs(c.params, c.jcfg, jbatches)
    flags = _flags(np.asarray(jX), X.numpy(), c.tree["layers"]["ffn"]["w"],
                   cfg).sum(1)
    assert (np.abs(counts - jcounts) <= flags).all()
    jplan = jplanner.build_plan(c.jcfg, (counts / n_tok).astype(np.float32),
                                hw=jplanner.PHONE)
    np.testing.assert_array_equal(engine.plan.neuron_order,
                                  jplan.neuron_order)
    assert {b: dataclasses.asdict(p) for b, p in engine.plan.plans.items()} \
        == {b: dataclasses.asdict(p) for b, p in jplan.plans.items()}
    np.testing.assert_array_equal(engine.plan.frequencies, jplan.frequencies)
    jengine = JEngine(c.jcfg, jfamilies.serving_family(c.jcfg).prepare_params(
        c.params, jplan), jplan, **kw)
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    got = engine.generate(prompt, max_new=5, temperature=0.0)
    want = jengine.generate(prompt, max_new=5, temperature=0.0)
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()
    engine.close()
    jengine.close()


def test_build_engine_unprofiled_and_moe_skip_profiling(monkeypatch):
    """Without profile the plan is the synthetic one; a moe config is not
    profiled even when asked (the router is its predictor)."""
    calls = []
    inner = tserve.profile_activations
    monkeypatch.setattr(tserve, "profile_activations",
                        lambda *a: calls.append(a[1].name) or inner(*a))
    engine, cfg = tserve.build_engine("smollm-135m", device="cpu")
    want = tplanner.build_plan(cfg, hw=tplanner.PHONE)
    np.testing.assert_array_equal(engine.plan.neuron_order, want.neuron_order)
    engine.close()
    engine, _ = tserve.build_engine("deepseek-moe-16b", device="cpu",
                                    profile=True)
    engine.close()
    assert calls == []


# --------------------------------------------------------- the corpus ----

@pytest.mark.parametrize("dc", [dict(vocab_size=512, seq_len=32,
                                     batch_size=2),
                                dict(vocab_size=49152, seq_len=64,
                                     batch_size=4, seed=3, zipf_a=1.1,
                                     ngram_repeat=0.5)])
def test_synthetic_tokens_bit_identical(dc):
    t = tpipeline.SyntheticTokens(tpipeline.DataConfig(**dc))
    j = jpipeline.SyntheticTokens(jpipeline.DataConfig(**dc))
    for _, tb, jb in zip(range(3), t, j):
        assert tb.keys() == jb.keys()
        for k in tb:
            assert tb[k].dtype == jb[k].dtype == np.int32
            np.testing.assert_array_equal(tb[k], jb[k])
    on = tpipeline.shard_batch(t.batch(), "cpu")
    assert on["tokens"].dtype == torch.int32 and \
        on["tokens"].shape == (dc["batch_size"], dc["seq_len"])


# ---------------------------------------------------- kernel calibration ----

ROWS = [dict(dense_flops=2e9, t_dense_s=1e-3, cold_flops=3e8,
             t_pallas_cold_s=2e-4, gather_bytes=5e7, source="card, 700 W"),
        dict(dense_flops=6e10, t_dense_s=4e-3, cold_flops=9e9,
             t_pallas_cold_s=8e-4, gather_bytes=9e8)]


def test_kernel_calibration_matches_reference(tmp_path):
    for rows in (ROWS, ROWS[1:], []):
        t = tio.KernelCalibration.from_rows(rows)
        j = jio.KernelCalibration.from_rows(rows)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    path = "benchmarks/baselines/BENCH_kernels.json"
    assert dataclasses.asdict(tio.KernelCalibration.from_bench_json(path)) \
        == dataclasses.asdict(jio.KernelCalibration.from_bench_json(path))
    # a JSON the port writes loads in the reference, and back
    cal = tio.KernelCalibration.from_rows(ROWS)
    out = tmp_path / "cal.json"
    out.write_text(json.dumps({"calibration": dataclasses.asdict(cal)}))
    assert dataclasses.asdict(jio.KernelCalibration.from_bench_json(out)) \
        == dataclasses.asdict(tio.KernelCalibration.from_bench_json(out))
    hw = cal.hardware(tplanner.PHONE)
    jhw = jio.KernelCalibration(**dataclasses.asdict(cal)).hardware(
        jplanner.PHONE)
    assert dataclasses.asdict(hw) == dataclasses.asdict(jhw)
    assert hw.name == "snapdragon-8gen3+kernels[card, 700 W]"


def test_kernel_calibration_hardware_needs_a_base():
    """The reference defaults to its TPU profile; the port's
    HardwareProfile has no default device, so hardware() raises."""
    cal = tio.KernelCalibration.from_rows(ROWS)
    with pytest.raises(TypeError):
        cal.hardware()
    with pytest.raises(TypeError, match="base"):
        cal.hardware(None)
