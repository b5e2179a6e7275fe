"""The moe family in the port (`repro_torch.models.moe`, the MoE plan,
storage view and quantization, the engine) against the JAX package.

The same numpy inputs go through both packages:

* `_capacity` over a sweep; `moe_dispatch` on the reference's dispatch
  scenarios (tests/test_moe_dispatch.py: fully tied gates, exact
  overflow drops, combine inverting dispatch, dropped tokens combining
  to zero, dead rows consuming no capacity) and on random gates: tope,
  slot and keep identical, topv within 1e-6;
* `apply_moe_ffn` on the reduced deepseek-moe-16b, grok-1-314b and
  turbosparse-mixtral-47b, with and without a two-level plan, with an
  active mask, in one and in two dispatch groups: y within 1e-4, aux
  within 1e-6, traces identical;
* `build_moe_plan`, `moe_synthetic_frequencies` and `permute_moe_params`
  field for field over the configs of the reference's plan sweep
  (tests/test_moe_intra_expert.py), and their raises;
* `MoEStorageView` (bundles, trace_cold_ids, hot_ids, warm_cold_ids,
  owner_of, the raises) and `_quantize_moe` (bit-identical at int8 and
  int4-mixed, shared experts untouched);
* the engine against the reference engine on the three reduced moe
  configs (and deepseek at int8), greedy: tokens, per-step (L, E) or
  (L, E, 1+ncc) traces and every TokenStats field identical; the norm
  weights are drawn at random (the reference inits them to zero);
* a reference moe checkpoint loading bit for bit, the pallas backend
  raising, and `--family moe` on the CLI.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.ckpt import save_checkpoint
from repro.core.planner import (
    PHONE as JPHONE, build_moe_plan as jbuild_moe_plan,
    moe_synthetic_frequencies as jmoe_freqs,
    permute_moe_params as jpermute_moe)
from repro.models import moe as jmoe
from repro.serving import families as jfamilies
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.storage_plane import MoEStorageView as JView
from repro_torch import configs as tconfigs
from repro_torch.bridge import load_checkpoint, params_from_numpy
from repro_torch.core.clusters import HybridPlan
from repro_torch.core.planner import (
    PHONE, build_moe_plan, moe_synthetic_frequencies, permute_moe_params)
from repro_torch.models import moe as tmoe
from repro_torch.quant.storage import quantize_plan_params
from repro_torch.serving import families as tfamilies
from repro_torch.serving.engine import ServeEngine as TEngine
from repro_torch.serving.storage_plane import MoEStorageView as TView

MOE_ARCHS = ["deepseek-moe-16b", "grok-1-314b", "turbosparse-mixtral-47b"]


def _cfgs(arch, **kw):
    return (jconfigs.get_config(arch).reduced().replace(**kw),
            tconfigs.get_config(arch).reduced().replace(**kw))


def _eq(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


# ----------------------------------------------------------- dispatch ----

@pytest.mark.parametrize("factor", [0.01, 0.5, 1.0, 1.25, 2.0, 8.0])
def test_capacity_matches_reference(factor):
    for T, k, E in itertools.product((1, 2, 7, 8, 33, 300, 4096),
                                     (1, 2, 6, 16), (1, 4, 8, 64, 128)):
        assert tmoe._capacity(T, k, E, factor) == \
            jmoe._capacity(T, k, E, factor)


def _dispatch_both(gates, k, C, active=None):
    j = jmoe.moe_dispatch(jnp.asarray(gates), k, C,
                          None if active is None else jnp.asarray(active))
    t = tmoe.moe_dispatch(torch.from_numpy(gates), k, C,
                          None if active is None else torch.from_numpy(
                              active))
    return j, t


def _softmax(a):
    e = np.exp(a - a.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("T,E,k,C", [(12, 4, 2, 2), (32, 4, 2, 3),
                                     (16, 64, 6, 8), (64, 8, 2, 8),
                                     (5, 8, 2, 8), (300, 64, 6, 40)])
@pytest.mark.parametrize("masked", [False, True])
def test_dispatch_random_gates_match_reference(T, E, k, C, masked):
    rng = np.random.default_rng(T * E + k)
    gates = _softmax(rng.standard_normal((T, E)) * 2)
    active = (rng.random(T) > 0.3) if masked else None
    (jt, jv, js, jk), (tt, tv, ts, tk) = _dispatch_both(gates, k, C, active)
    _eq((jt, js, jk), (tt, ts, tk))
    assert tt.dtype == ts.dtype == torch.int32 and tk.dtype == torch.bool
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


def test_tied_gates_give_the_reference_slots():
    """Every gate tied: top-k takes the lowest expert ids, capacity
    keeps the first C tokens per expert (the reference's test)."""
    T, E, k, C = 12, 4, 2, 2
    gates = np.full((T, E), 1.0 / E, np.float32)
    j, t = _dispatch_both(gates, k, C)
    _eq(j, t)
    t2 = tmoe.moe_dispatch(torch.from_numpy(gates), k, C)
    _eq([x.numpy() for x in t], t2)
    tope, _, slot, keep = (x.numpy() for x in t)
    assert (tope == np.array([0, 1])).all()
    for e in range(E):
        kept = sorted(i for i in range(T) for s in range(k)
                      if tope[i, s] == e and keep[i, s])
        routed = sorted(i for i in range(T) for s in range(k)
                        if tope[i, s] == e)
        assert kept == routed[:C]
    assert len(set(slot[keep].tolist())) == int(keep.sum())


def test_drop_count_is_exactly_overflow():
    T, E, k, C = 32, 4, 2, 3
    gates = _softmax(np.random.default_rng(0).standard_normal((T, E)))
    j, t = _dispatch_both(gates, k, C)
    _eq((j[0], j[2], j[3]), (t[0], t[2], t[3]))
    tope, keep = t[0].numpy(), t[3].numpy()
    routed = np.bincount(tope.reshape(-1), minlength=E)
    kept = np.bincount(tope.reshape(-1), weights=keep.reshape(-1),
                       minlength=E).astype(int)
    np.testing.assert_array_equal(kept, np.minimum(routed, C))


def _group_both(cfg_pair, x, router, C, active=None):
    jcfg, tcfg = cfg_pair
    j = jmoe._dispatch_group(jnp.asarray(x), jnp.asarray(router), jcfg, C,
                             None if active is None else jnp.asarray(active))
    t = tmoe._dispatch_group(torch.from_numpy(x), torch.from_numpy(router),
                             tcfg, C, None if active is None
                             else torch.from_numpy(active))
    return j, t


def test_combine_inverts_dispatch_for_kept_tokens():
    cfgs = _cfgs("deepseek-moe-16b", moe_capacity_factor=8.0)
    tcfg = cfgs[1]
    T, D = 6, tcfg.d_model
    C = tmoe._capacity(T, tcfg.experts_per_token, tcfg.num_experts,
                       tcfg.moe_capacity_factor)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, D)).astype(np.float32)
    router = (rng.standard_normal((D, tcfg.num_experts)) * 0.1).astype(
        np.float32)
    (jbuf, jmeta, jaux, jcnt), (buf, meta, aux, cnt) = _group_both(
        cfgs, x, router, C)
    assert bool(meta[1].all())
    y = tmoe._combine_group(buf.reshape(-1, D), *meta)
    np.testing.assert_allclose(y.numpy(), x, atol=1e-5, rtol=1e-5)
    jy = jmoe._combine_group(jbuf.reshape(-1, D), *jmeta)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert int(cnt.sum()) == T * tcfg.experts_per_token
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)


def test_dropped_tokens_combine_to_zero():
    cfgs = _cfgs("deepseek-moe-16b")
    T, D = 24, cfgs[1].d_model
    x = np.ones((T, D), np.float32)
    router = np.zeros((D, cfgs[1].num_experts), np.float32)
    (jbuf, jmeta, _, jcnt), (buf, meta, _, cnt) = _group_both(
        cfgs, x, router, 1)
    y = tmoe._combine_group(buf.reshape(-1, D), *meta).numpy()
    np.testing.assert_array_equal(
        y, np.asarray(jmoe._combine_group(jbuf.reshape(-1, D), *jmeta)))
    dropped = ~meta[1].numpy().any(axis=1)
    assert dropped.any()
    np.testing.assert_array_equal(y[dropped], 0.0)
    assert int(cnt.sum()) == int(meta[1].sum())
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_dead_rows_never_consume_capacity():
    """Dead rows interleaved before live ones: the live rows keep the
    slots of a dispatch over the live rows alone, in both packages."""
    E, k, C = 4, 2, 2
    rng = np.random.default_rng(3)
    live = _softmax(rng.standard_normal((8, E)))
    dead = _softmax(rng.standard_normal((8, E)) * 3.0)
    gates = np.stack([dead, live], 1).reshape(16, E)
    active = np.tile(np.array([False, True]), 8)
    jm, tm = _dispatch_both(gates, k, C, active)
    _eq((jm[0], jm[2], jm[3]), (tm[0], tm[2], tm[3]))
    tl = tmoe.moe_dispatch(torch.from_numpy(live), k, C)
    rows = np.arange(1, 16, 2)
    for a, b in ((tm[3], tl[3]), (tm[2], tl[2]), (tm[0], tl[0])):
        np.testing.assert_array_equal(a.numpy()[rows], b.numpy())
    assert not tm[3].numpy()[::2].any()


# ------------------------------------------------------ apply_moe_ffn ----

@pytest.fixture(scope="module")
def moe_weights():
    """arch -> (jcfg, tcfg, reference params, numpy tree, port model) of
    the reduced config, the reference's random init."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg, tcfg = _cfgs(arch)
            params = jmoe.make_model(jcfg).init(jax.random.key(3))
            tree = jax.tree.map(np.asarray, params)
            built[arch] = (jcfg, tcfg, params, tree,
                           params_from_numpy(tree, tcfg, device="cpu"))
        return built[arch]
    return get


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("T", [4, 40])
def test_apply_moe_ffn_matches_reference(moe_weights, arch, two_level, G,
                                         T):
    """Layer 0's MoE over T rows (T 40 overflows capacity) with a third
    of them dead, in G dispatch groups, with and without a two-level
    plan (the config's moe_intra_expert set to match)."""
    jcfg0, tcfg0, params, tree, model = moe_weights(arch)
    kw = dict(moe_dispatch_groups=G, moe_intra_expert=two_level)
    jcfg, tcfg = jcfg0.replace(**kw), tcfg0.replace(**kw)
    rng = np.random.default_rng(T + G)
    # x at 0.1 of unit rms: the reference's init makes the FFN output
    # grow with |x|^2 (about 1e3 at unit rms), so this keeps y near 1
    x = (rng.standard_normal((T, tcfg.d_model)) * 0.1).astype(np.float32)
    active = rng.random(T) > 0.33
    tplan = build_moe_plan(tcfg, hw=PHONE).plan_for_batch(T) \
        if two_level else None
    jplan = jbuild_moe_plan(jcfg, hw=JPHONE).plan_for_batch(T) \
        if two_level else None
    if two_level:
        assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
        assert tplan.n_expert_hot > 0
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["moe"])
    jy, jaux, jtr = jmoe.apply_moe_ffn(jp, jnp.asarray(x), jcfg, plan=jplan,
                                       active_mask=jnp.asarray(active),
                                       collect_trace=True)
    ty, taux, ttr = tmoe.apply_moe_ffn(
        model.layers[0].moe, torch.from_numpy(x), tcfg, plan=tplan,
        active_mask=torch.from_numpy(active), collect_trace=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)
    assert ttr.dtype == torch.int32
    np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
    E = tcfg.num_experts
    if two_level:
        ncc = (tcfg.d_ff - tplan.n_expert_hot) // tplan.cluster_size
        assert ttr.shape == (E, 1 + ncc)
    else:
        assert ttr.shape == (E,)
    y2, aux2 = tmoe.apply_moe_ffn(model.layers[0].moe, torch.from_numpy(x),
                                  tcfg, plan=tplan,
                                  active_mask=torch.from_numpy(active))
    assert torch.equal(y2, ty) and torch.equal(aux2, taux)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_prefill_match_reference(moe_weights, arch):
    jcfg, tcfg, params, tree, model = moe_weights(arch)
    jm = jmoe.make_model(jcfg)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    jl = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    tl = tmoe.forward(model, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(tokens)}, max_len=10)
    tl, tc = tmoe.prefill(model, torch.from_numpy(tokens), max_len=10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-4, rtol=1e-4)
    for key in ("kv_pos", "length"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_step_matches_reference(moe_weights, arch):
    """Three greedy decode steps after a prefill, a dead row in the
    batch: logits within 1e-4, traces identical, the plan the family's
    (two-level for turbosparse)."""
    jcfg, tcfg, params, tree, model = moe_weights(arch)
    jm = jmoe.make_model(jcfg)
    B, S, T = 3, 5, 9
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jplan = jbuild_moe_plan(jcfg, hw=JPHONE).plan_for_batch(B)
    tplan = build_moe_plan(tcfg, hw=PHONE).plan_for_batch(B)
    assert tplan.n_expert_hot == jplan.n_expert_hot
    assert (tplan.n_expert_hot > 0) == tcfg.moe_intra_expert
    active = np.array([True, False, True])
    jstep = jmoe.make_decode_step(jcfg, collect_indices=True)
    tstep = tmoe.make_decode_step(tcfg, collect_indices=True)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(tokens)}, max_len=T)
    tl, tc = tmoe.prefill(model, torch.from_numpy(tokens), max_len=T)
    for _ in range(3):
        nxt = np.asarray(jl[:, -1].argmax(-1), np.int32)[:, None]
        jl, jc, jtr = jstep(params, jnp.asarray(nxt), jc, jplan,
                            jnp.asarray(active))
        tl, tc, ttr = tstep(model, torch.from_numpy(nxt), tc, tplan,
                            torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        assert ttr.shape[:2] == (tcfg.num_layers, tcfg.num_experts)


# ------------------------------------------------------------- planner ----

PLAN_CFGS = list(itertools.product(
    [(1, 1), (2, 1), (4, 2), (6, 3), (8, 2)], (0, 1), (2, 16),
    (False, True)))


def _plan_cfgs(E, k, s, m, intra):
    jb, tb = _cfgs("deepseek-moe-16b")
    cs = tb.sparse_ffn.cluster_size
    kw = dict(num_experts=E, experts_per_token=k, num_shared_experts=s,
              d_ff=cs * m, moe_intra_expert=intra)
    return jb.replace(**kw), tb.replace(**kw)


def _plan_dict(p):
    return dict(arch=p.arch, n_neurons=p.n_neurons,
                cluster_size=p.cluster_size,
                neuron_order=np.asarray(p.neuron_order).tolist(),
                frequencies=np.asarray(p.frequencies).tolist(),
                plans={b: dataclasses.asdict(v) for b, v in p.plans.items()},
                hardware=dataclasses.asdict(p.hardware))


@pytest.mark.parametrize("E_k,s,m,intra", PLAN_CFGS, ids=lambda v: str(v))
def test_build_moe_plan_matches_reference(E_k, s, m, intra):
    jcfg, tcfg = _plan_cfgs(*E_k, s, m, intra)
    for sd in ("fp16", "int4-mixed"):
        assert _plan_dict(build_moe_plan(tcfg, hw=PHONE, storage_dtype=sd)) \
            == _plan_dict(jbuild_moe_plan(jcfg, hw=JPHONE, storage_dtype=sd))
    if intra:
        np.testing.assert_array_equal(moe_synthetic_frequencies(tcfg, 4),
                                      jmoe_freqs(jcfg, 4))


def test_family_plans_match_reference():
    for arch in MOE_ARCHS:
        jcfg, tcfg = _cfgs(arch)
        for sd in ("fp16", "int8"):
            t = tfamilies.serving_family(tcfg).build_plan(
                tcfg, hw=PHONE, storage_dtype=sd)
            j = jfamilies.serving_family(jcfg).build_plan(
                jcfg, hw=JPHONE, storage_dtype=sd)
            assert _plan_dict(t) == _plan_dict(j)


def test_moe_plan_raises_as_reference():
    jb, tb = _cfgs("deepseek-moe-16b")
    cs = tb.sparse_ffn.cluster_size
    cases = [
        (dict(d_ff=cs * 2 + 1, moe_intra_expert=True), None, "multiple of"),
        (dict(moe_intra_expert=True), np.ones((tb.num_layers, 7),
                                              np.float32), "L, E\\*f"),
        (dict(num_experts=0), None, "not a MoE config"),
    ]
    for kw, freqs, match in cases:
        for fn, cfg, hw in ((build_moe_plan, tb, PHONE),
                            (jbuild_moe_plan, jb, JPHONE)):
            with pytest.raises(ValueError, match=match):
                fn(cfg.replace(**kw), freqs, hw=hw)


def test_permute_moe_params_matches_reference(moe_weights):
    jcfg, tcfg, params, tree, _ = moe_weights("turbosparse-mixtral-47b")
    plan = build_moe_plan(tcfg, hw=PHONE)
    jplan = jbuild_moe_plan(jcfg, hw=JPHONE)
    np.testing.assert_array_equal(plan.neuron_order, jplan.neuron_order)
    model = params_from_numpy(tree, tcfg, device="cpu")
    shared = [layer.moe.shared.clone() for layer in model.layers]
    assert permute_moe_params(model, plan.neuron_order) is model
    want = np.asarray(jpermute_moe(params, jplan.neuron_order)
                      ["layers"]["moe"]["experts"])
    for l, layer in enumerate(model.layers):
        np.testing.assert_array_equal(layer.moe.experts.numpy(), want[l])
        assert torch.equal(layer.moe.shared, shared[l])
    assert not np.array_equal(want, tree["layers"]["moe"]["experts"])


# --------------------------------------------------- storage view ----

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_storage_view_matches_reference(moe_weights, arch):
    jcfg, tcfg, params, tree, model = moe_weights(arch)
    jv, tv = JView(jcfg), TView(tcfg)
    for a in ("f", "E", "n_shared", "S", "n_neurons", "intra",
              "cluster_size", "rows"):
        assert getattr(tv, a) == getattr(jv, a), a
    for a, b in zip(tv.bundles(model), jv.bundles(params)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    plan = build_moe_plan(tcfg, hw=PHONE)
    rng = np.random.default_rng(8)
    for b, p in plan.plans.items():
        if p.n_expert_hot:
            ncc = (tcfg.d_ff - p.n_expert_hot) // p.cluster_size
            tr = rng.integers(0, 3, (tcfg.num_experts, 1 + ncc))
        else:
            tr = rng.integers(0, 3, (tcfg.num_experts,))
        for fn in ("trace_cold_ids", "hot_ids"):
            np.testing.assert_array_equal(getattr(tv, fn)(tr, p),
                                          getattr(jv, fn)(tr, p))
        for n_hot, count in ((p.resident_hot, 100), (p.n_hot, 10 ** 6)):
            np.testing.assert_array_equal(tv.warm_cold_ids(n_hot, count),
                                          jv.warm_cold_ids(n_hot, count))
        ids = np.arange(tv.n_neurons)
        for n in (1, 2, 3, 4):
            np.testing.assert_array_equal(tv.owner_of(ids, p, n),
                                          jv.owner_of(ids, p, n))
    timing = type("T", (), {"d_ff": 1408})
    assert tv.deploy_neurons(timing) == jv.deploy_neurons(timing)
    assert tv.deploy_prefill_neurons(timing) == \
        jv.deploy_prefill_neurons(timing)


def test_storage_view_raises_as_reference():
    jcfg, tcfg = _cfgs("turbosparse-mixtral-47b")
    p2 = build_moe_plan(tcfg, hw=PHONE).plan_for_batch(1)
    p1 = HybridPlan(n_hot=tcfg.d_ff, k_cold=tcfg.d_ff,
                    cluster_size=tcfg.d_ff)
    E = tcfg.num_experts
    bad = [(np.zeros((E, 2), np.int32), p2, "two-level MoE trace shape"),
           (np.zeros((E + 1,), np.int32), p1, "entries for"),
           (np.zeros((E,), np.int32), p1, None)]
    msgs = []
    for v in (TView(tcfg), JView(jcfg)):
        got = []
        for tr, p, match in bad:
            if match is None:
                assert v.trace_cold_ids(tr, p).size == 0
                continue
            with pytest.raises(ValueError, match=match) as e:
                v.trace_cold_ids(tr, p)
            got.append(str(e.value))
        v.n_neurons = 1                          # ids past the flat space
        with pytest.raises(ValueError, match="outside the flat") as e:
            v.trace_cold_ids(np.ones((E,), np.int32), p1)
        msgs.append(got + [str(e.value)])
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------- quantization ----

@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "turbosparse-mixtral-47b"])
@pytest.mark.parametrize("sd", ["int8", "int4-mixed"])
def test_quantize_moe_bit_identical(moe_weights, arch, sd):
    jcfg, tcfg, params, tree, _ = moe_weights(arch)
    jplan = jbuild_moe_plan(jcfg, hw=JPHONE, storage_dtype=sd)
    tplan = build_moe_plan(tcfg, hw=PHONE, storage_dtype=sd)
    want = jax.tree.map(np.asarray, jfamilies.serving_family(jcfg)
                        .prepare_params(params, jplan))
    model = params_from_numpy(tree, tcfg, device="cpu")
    got = tfamilies.serving_family(tcfg).prepare_params(model, tplan)
    assert got is model
    for l, layer in enumerate(model.layers):
        np.testing.assert_array_equal(layer.moe.experts.numpy(),
                                      want["layers"]["moe"]["experts"][l])
        np.testing.assert_array_equal(layer.moe.shared.numpy(),
                                      tree["layers"]["moe"]["shared"]["w"][l])
        np.testing.assert_array_equal(layer.moe.router.numpy(),
                                      tree["layers"]["moe"]["router"][l])
    # the quantized rows really changed, and an fp16 plan is the identity
    assert not np.array_equal(want["layers"]["moe"]["experts"],
                              tree["layers"]["moe"]["experts"])
    fp = params_from_numpy(tree, tcfg, device="cpu")
    quantize_plan_params(fp, build_moe_plan(tcfg, hw=PHONE))
    np.testing.assert_array_equal(fp.layers[0].moe.experts.numpy(),
                                  tree["layers"]["moe"]["experts"][0])


# -------------------------------------------------------------- engine ----

def _norms_at_random(tree, seed):
    rng = np.random.default_rng(seed)

    def draw(a):
        return (rng.standard_normal(a.shape) * 0.2).astype(a.dtype)
    tree = dict(tree, out_norm=draw(tree["out_norm"]))
    tree["layers"] = dict(tree["layers"], ln1=draw(tree["layers"]["ln1"]),
                          ln2=draw(tree["layers"]["ln2"]))
    return tree


@pytest.fixture(scope="module")
def served_weights():
    built = {}

    def get(arch, sd):
        if (arch, sd) not in built:
            jcfg, tcfg = _cfgs(arch)
            jfam = jfamilies.serving_family(jcfg)
            params = jfam.make_model(jcfg).init(jax.random.key(7))
            jplan = jfam.build_plan(jcfg, hw=JPHONE, storage_dtype=sd)
            tree = _norms_at_random(jax.tree.map(
                np.asarray, jfam.prepare_params(params, jplan)), 8)
            built[arch, sd] = (jcfg, tcfg, jplan, tree)
        return built[arch, sd]
    return get


def _recorded(engine):
    traces = []
    price = engine.storage.step

    def record(trace, *a, **k):
        traces.append(np.asarray(trace).tolist())
        return price(trace, *a, **k)
    engine.storage.step = record
    return traces


ENGINE_CASES = [(a, "fp16") for a in MOE_ARCHS] + \
    [("deepseek-moe-16b", "int8")]


@pytest.mark.parametrize("arch,sd", ENGINE_CASES, ids=lambda v: str(v))
def test_engine_matches_reference(served_weights, arch, sd):
    """generate() of 3 prompts with one sample cancelled after step 1
    (a dead lane in the bucket of 4), then a staggered stream through
    submit/run_until_drained, through both engines."""
    jcfg, tcfg, jplan, tree = served_weights(arch, sd)
    tplan = tfamilies.serving_family(tcfg).build_plan(
        tcfg, hw=PHONE, storage_dtype=sd)
    assert _plan_dict(tplan) == _plan_dict(jplan)
    model = params_from_numpy(tree, tcfg, device="cpu")   # prepared
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    stream = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
              for n in (6, 9, 6)]
    kw = dict(buckets=(1, 2, 4), temperature=0.0, seed=0)
    out = []
    for e in (JEngine(jcfg, jax.tree.map(jnp.asarray, tree), jplan, **kw),
              TEngine(tcfg, model, tplan, **kw)):
        traces = _recorded(e)
        res = e.generate(prompt, max_new=5, temperature=0.0,
                         completion_schedule={1: 1})
        for i, p in enumerate(stream):
            e.submit(p, max_new=4, arrival_time=e.clock_s + i * 1e-3)
        rep = e.run_until_drained()
        out.append((res.tokens.tolist(), traces,
                    [dataclasses.asdict(s) for s in res.stats + rep.stats],
                    [list(r.generated) for r in rep.requests],
                    rep.span_s))
        e.close()
    for a, b in zip(out[1], out[0]):
        assert a == b
    shapes = {np.array(t).shape for t in out[1][1]}
    L, E = tcfg.num_layers, tcfg.num_experts
    if tcfg.moe_intra_expert:
        assert {s[:2] for s in shapes} == {(L, E)} and \
            all(len(s) == 3 for s in shapes)
    else:
        assert shapes == {(L, E)}
    assert [s["batch"] for s in out[1][2]][:3] == [3, 3, 2]


def test_engine_refuses_pallas_and_grouped_dispatch():
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    fam = tfamilies.serving_family(tcfg)
    assert fam.backends == ("jnp",)
    assert tfamilies.serving_family(
        tconfigs.get_config("smollm-135m")).backends == ("jnp", "pallas")
    plan = fam.build_plan(tcfg, hw=PHONE)
    model = fam.make_model(tcfg, device="cpu", seed=0)
    msgs = []
    for eng, cfg in ((TEngine, tcfg), (JEngine, jcfg)):
        with pytest.raises(ValueError, match="no pallas backend") as e:
            eng(cfg, model, plan, backend="pallas")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="no pallas backend"):
        TEngine(tcfg, model, plan, backend="pallas", dp=2)
    for build in (fam.build_plan, jfamilies.serving_family(jcfg).build_plan):
        with pytest.raises(ValueError, match="expert dispatch"):
            build(tcfg, hw=PHONE, backend="pallas")
    with pytest.raises(ValueError, match="one dispatch group"):
        TEngine(tcfg.replace(moe_dispatch_groups=2), model, plan)


def test_build_engine_serves_moe_on_the_cpu():
    """build_engine draws the seeded model and the family's plan: the
    tokens of a ServeEngine over the same model, and 'pallas' raises."""
    from repro_torch.launch.serve import build_engine
    tcfg = tconfigs.get_config("turbosparse-mixtral-47b").reduced()
    fam = tfamilies.serving_family(tcfg)
    plan = fam.build_plan(tcfg, hw=PHONE)
    model = fam.prepare_params(fam.make_model(tcfg, device="cpu", seed=0),
                               plan)
    prompt = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    got = []
    for e in (build_engine("turbosparse-mixtral-47b", device="cpu",
                           temperature=0.0)[0],
              TEngine(tcfg, model, plan, temperature=0.0, offload_ratio=0.5,
                      seed=0)):
        got.append(e.generate(prompt, max_new=4, temperature=0.0)
                   .tokens.tolist())
        e.close()
    assert got[0] == got[1]
    with pytest.raises(ValueError, match="expert dispatch"):
        build_engine("deepseek-moe-16b", device="cpu", backend="pallas")


# ---------------------------------------------------------- checkpoint ----

def _bits(t):
    return t.detach().view(torch.int16).numpy()


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "turbosparse-mixtral-47b"])
def test_moe_checkpoint_loads_bit_for_bit(tmp_path, arch):
    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16",
                       compute_dtype="bfloat16")
    params = jmoe.make_model(jcfg).init(jax.random.key(5))
    save_checkpoint(str(tmp_path), params)
    tree = jax.tree.map(np.asarray, params)
    want = tree["layers"]["moe"]
    for model in (load_checkpoint(str(tmp_path), tcfg, device="cpu"),
                  params_from_numpy(tree, tcfg, device="cpu")):
        assert isinstance(model, tmoe.MoEModel)
        for l, layer in enumerate(model.layers):
            for got, a in ((layer.moe.router, want["router"][l]),
                           (layer.moe.experts, want["experts"][l]),
                           (layer.moe.shared, want["shared"]["w"][l])):
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(_bits(got), a.view(np.int16))
        np.testing.assert_array_equal(_bits(model.embed),
                                      tree["embed"].view(np.int16))


def test_moe_tree_without_experts_raises():
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    tree = jax.tree.map(np.asarray, jmoe.make_model(jcfg).init(
        jax.random.key(1)))
    del tree["layers"]["moe"]["experts"]
    with pytest.raises(KeyError, match="layers__moe__experts"):
        params_from_numpy(tree, tcfg, device="cpu")


# ------------------------------------------------------------------ CLI ----

@pytest.mark.parametrize("flags,want", [
    (["--family", "moe"], ["arch=deepseek-moe-16b", "modeled decode:",
                           "8 tokens on cpu"]),
    (["--arch", "turbosparse-mixtral-47b", "--storage-dtype", "int8"],
     ["arch=turbosparse-mixtral-47b", "storage_dtype=int8"]),
    (["--arch", "grok-1-314b", "--dp", "2"], ["arch=grok-1-314b", "dp=2",
                                              "8 tokens on cpu"]),
    (["--family", "moe", "--fleet", "2"], ["fleet=2", "2/2 completed"]),
], ids=["family", "turbosparse-int8", "grok-dp2", "fleet2"])
def test_serve_cli_moe(capsys, flags, want):
    from repro_torch.launch.serve import main
    main(["--reduced", "--device", "cpu", "--bon", "2", "--max-new", "4",
          "--temperature", "0", *flags])
    out = capsys.readouterr().out
    for w in want:
        assert w in out, (w, out)


def test_serve_cli_moe_refuses_pallas():
    from repro_torch.launch.serve import main
    with pytest.raises(ValueError, match="expert dispatch"):
        main(["--reduced", "--device", "cpu", "--family", "moe",
              "--backend", "pallas", "--max-new", "2"])
