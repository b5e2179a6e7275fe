"""The dense archs beyond smollm-135m and the vlm family, against the JAX
package.

* The config registry: every one of the 13 configs equals the
  reference's field by field, `reduced()` included.
* Serving: for each newly servable config (qwen3-14b with qk-norm,
  llama3-405b, nemotron-4-15b and bamboo-7b in relu mode,
  mistral-7b-silu, qwen2-vl-2b through the dense plane), reduced (fp32),
  the port's engine on the reference's numpy weights gives the reference
  engine's greedy tokens, bit-identical (L, G, kc) cluster-id traces and
  equal TokenStats, under both cold-path backends; at int8 storage for
  one relu arch (bamboo-7b) and one CATS arch (qwen3-14b) too. The norm
  weights are drawn at random (the reference inits them to zero, the
  identity), so qk-norm is exercised.
* qk-norm weights cross through `params_from_numpy` and
  `load_checkpoint`, bf16 bit for bit.
* vlm: `mrope_angles` within 1e-6 and `models/vlm.py`'s prefill and
  decode logits within 1e-4 of the reference's (fp32), the decode under
  the hybrid FFN with ids identical between the two backends.
* Families the port does not serve raise, as the reference's registry
  does for what it does not serve; the three moe configs serve through
  the moe family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.ckpt import save_checkpoint
from repro.core.planner import PHONE as JPHONE, build_plan as jbuild_plan
from repro.models import attention as jatt
from repro.models import dense as jdense
from repro.models import vlm as jvlm
from repro.serving import families as jfamilies
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.families import _dense_prepare
from repro_torch import configs as tconfigs
from repro_torch.bridge import load_checkpoint, params_from_numpy
from repro_torch.core.planner import PHONE, build_plan
from repro_torch.models import attention as tatt
from repro_torch.models import vlm as tvlm
from repro_torch.serving import families as tfamilies
from repro_torch.serving.engine import ServeEngine as TEngine

ARCHS = sorted(jconfigs.list_archs())
SERVED = ["qwen3-14b", "llama3-405b", "nemotron-4-15b", "bamboo-7b",
          "mistral-7b-silu", "qwen2-vl-2b"]
MOE = ["deepseek-moe-16b", "grok-1-314b", "turbosparse-mixtral-47b"]
UNSERVED = ["mamba2-130m", "recurrentgemma-9b", "seamless-m4t-large-v2"]


# ----------------------------------------------------------- registry ----

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert type(t).__module__.startswith("repro_torch.")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    for prop in ("vocab_padded", "attention_free", "subquadratic",
                 "moe_flat_neurons"):
        assert getattr(t, prop) == getattr(j, prop)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_registry_lists_match_reference():
    assert len(ARCHS) == 13
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert {k: dataclasses.asdict(v)
            for k, v in tconfigs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}


def test_served_families_match_reference():
    assert tfamilies.default_archs() == {"dense": "smollm-135m",
                                         "moe": "deepseek-moe-16b",
                                         "vlm": "qwen2-vl-2b"}
    ref = jfamilies.default_archs()
    assert {f: ref[f] for f in tfamilies.servable_families()} == \
        tfamilies.default_archs()
    for arch in SERVED:
        cfg = tconfigs.get_config(arch)
        assert tfamilies.serving_family(cfg).family == cfg.family


@pytest.mark.parametrize("arch", UNSERVED)
def test_unserved_families_raise(arch):
    cfg = tconfigs.get_config(arch).reduced()
    with pytest.raises(ValueError, match="not servable"):
        tfamilies.serving_family(cfg)


@pytest.mark.parametrize("arch", MOE)
def test_moe_archs_served(arch):
    """The moe configs serve through the moe family, as the reference's
    do, with the plain path only (tests/test_torch_moe.py holds them
    against the reference)."""
    cfg = tconfigs.get_config(arch).reduced()
    fam = tfamilies.serving_family(cfg)
    ref = jfamilies.serving_family(jconfigs.get_config(arch).reduced())
    assert fam.family == ref.family == "moe"
    assert fam.backends == ref.backends == ("jnp",)
    assert fam.default_arch == ref.default_arch


# ------------------------------------------------------------ serving ----

def _norms_at_random(params, seed):
    """The tree with every norm weight (ln1, ln2, out_norm, qk) drawn at
    random: the reference inits them to zero."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, params)

    def draw(a):
        return (rng.standard_normal(a.shape) * 0.2).astype(a.dtype)
    tree["out_norm"] = draw(tree["out_norm"])
    lt = tree["layers"]
    for k in ("ln1", "ln2"):
        lt[k] = draw(lt[k])
    if "qk" in lt["attn"]:
        lt["attn"]["qk"] = {k: draw(v) for k, v in lt["attn"]["qk"].items()}
    return tree


@pytest.fixture(scope="module")
def reference_weights():
    built = {}

    def get(arch, sd):
        if (arch, sd) not in built:
            jcfg = jconfigs.get_config(arch).reduced()
            jfam = jfamilies.serving_family(jcfg)
            params = jfam.make_model(jcfg).init(jax.random.key(7))
            jplan = jbuild_plan(jcfg, hw=JPHONE, storage_dtype=sd)
            tree = _norms_at_random(_dense_prepare(params, jplan), 8)
            built[arch, sd] = (jcfg, jplan, tree)
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


CASES = [(a, b, "fp16") for a in SERVED for b in ("jnp", "pallas")] + \
    [(a, b, "int8") for a in ("bamboo-7b", "qwen3-14b")
     for b in ("jnp", "pallas")]


@pytest.mark.parametrize("arch,backend,sd", CASES,
                         ids=lambda v: str(v))
def test_engine_matches_reference(reference_weights, arch, backend, sd):
    jcfg, jplan, tree = reference_weights(arch, sd)
    tcfg = tconfigs.get_config(arch).reduced()
    tplan = build_plan(tcfg, hw=PHONE, storage_dtype=sd)
    assert {b: dataclasses.asdict(p) for b, p in tplan.plans.items()} == \
        {b: dataclasses.asdict(p) for b, p in jplan.plans.items()}
    prompt = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    kw = dict(buckets=(2,), temperature=0.0, seed=0, backend=backend)
    out = []
    for e in (JEngine(jcfg, jax.tree.map(jnp.asarray, tree), jplan, **kw),
              TEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"),
                      tplan, **kw)):
        traces = _recorded(e)
        res = e.generate(prompt, max_new=5, temperature=0.0)
        out.append((res.tokens.tolist(), traces,
                     [dataclasses.asdict(s) for s in res.stats]))
        e.close()
    assert out[1][0] == out[0][0]
    assert out[1][1] == out[0][1]
    assert out[1][2] == out[0][2]
    L, G = tcfg.num_layers, tplan.plan_for_batch(2).groups
    assert np.array(out[1][1]).shape[:3] == (5, L, G)


# ------------------------------------------------------------- qk-norm ----

def test_qk_norm_matches_reference():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    wq, wk = (rng.standard_normal(16).astype(np.float32) * 0.3
              for _ in range(2))
    tq, tk = tatt.maybe_qk_norm(*(torch.from_numpy(a) for a in
                                  (q, k, wq, wk)), 1e-5)
    jq, jk = jatt.maybe_qk_norm(jnp.asarray(q), jnp.asarray(k),
                                {"q_norm": jnp.asarray(wq),
                                 "k_norm": jnp.asarray(wk)}, 1e-5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
    assert tatt.maybe_qk_norm(tq, tk, None, None, 1e-5) == (tq, tk)


def _bits(t):
    return t.detach().view(torch.int16).numpy()


def test_qk_leaves_cross_bit_for_bit(tmp_path):
    """bf16 qwen3 weights with the qk-norm leaves drawn at random, through
    params_from_numpy and through a checkpoint the reference saved."""
    jcfg = jconfigs.get_config("qwen3-14b").reduced().replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    tcfg = tconfigs.get_config("qwen3-14b").reduced().replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    params = jdense.make_model(jcfg).init(jax.random.key(5))
    rng = np.random.default_rng(6)
    params["layers"]["attn"]["qk"] = {
        k: jnp.asarray(rng.standard_normal(v.shape) * 0.3, jnp.bfloat16)
        for k, v in params["layers"]["attn"]["qk"].items()}
    save_checkpoint(str(tmp_path), params)
    tree = jax.tree.map(np.asarray, params)
    want = tree["layers"]["attn"]["qk"]
    for model in (params_from_numpy(tree, tcfg, device="cpu"),
                  load_checkpoint(str(tmp_path), tcfg, device="cpu")):
        for l, layer in enumerate(model.layers):
            for k in ("q_norm", "k_norm"):
                got = getattr(layer.attn, k)
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(_bits(got),
                                              want[k][l].view(np.int16))
    plain = params_from_numpy(
        jax.tree.map(np.asarray, jdense.make_model(
            jcfg.replace(qk_norm=False)).init(jax.random.key(5))),
        tcfg.replace(qk_norm=False), device="cpu")
    assert plain.layers[0].attn.q_norm is None
    with pytest.raises(KeyError, match="qk"):
        params_from_numpy(jax.tree.map(np.asarray, jdense.make_model(
            jcfg.replace(qk_norm=False)).init(jax.random.key(5))),
            tcfg, device="cpu")


# ----------------------------------------------------------------- vlm ----

def test_mrope_angles_and_positions_match_reference():
    jcfg = jconfigs.get_config("qwen2-vl-2b")
    tcfg = tconfigs.get_config("qwen2-vl-2b")
    for n_img, n_text in ((1024, 16), (16, 5), (10, 3)):
        tp = tvlm.build_positions(tcfg, 2, n_img, n_text)
        jp = jvlm.build_positions(jcfg, 2, n_img, n_text)
        assert tp.dtype == torch.int32
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        ta = tatt.mrope_angles(tp, tcfg.mrope_sections, tcfg.rope_theta)
        ja = jatt.mrope_angles(jp, jcfg.mrope_sections, jcfg.rope_theta)
        assert ta.shape == (2, n_img + n_text, tcfg.d_head // 2)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                                   atol=1e-6)


def test_ragged_last_kv_chunk_matches_one_chunk():
    """A kv length that kv_block does not divide (a vlm prefill of 1,024
    patches and 16 text tokens) runs in a shorter last chunk."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 20, n, 16)).astype(np.float32)
               for n in (4, 2, 2))
    t = tatt.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True, kv_block=8)
    j = jatt.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=True, q_block=20, kv_block=20)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def vlm_weights():
    jcfg = jconfigs.get_config("qwen2-vl-2b").reduced()
    tcfg = tconfigs.get_config("qwen2-vl-2b").reduced()
    jmodel = jvlm.make_model(jcfg)
    jplan = jbuild_plan(jcfg, hw=JPHONE)
    params = _dense_prepare(jmodel.init(jax.random.key(11)), jplan)
    tree = _norms_at_random(params, 12)
    return jcfg, tcfg, jmodel, jplan, tree


def test_vlm_forward_matches_reference(vlm_weights):
    jcfg, tcfg, jmodel, _, tree = vlm_weights
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    patches = rng.standard_normal((2, jcfg.num_image_tokens, jcfg.d_model)
                                  ).astype(np.float32) * 0.1
    jl = jmodel.forward(jax.tree.map(jnp.asarray, tree),
                        {"tokens": tokens, "patch_embeds": patches})
    tl = tvlm.forward(params_from_numpy(tree, tcfg, device="cpu"),
                      torch.from_numpy(tokens), torch.from_numpy(patches))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture(scope="module")
def vlm_decode(vlm_weights):
    """Per backend: prefill of 16 patches and 6 text tokens, then 4
    decode steps of the reference's greedy tokens under the hybrid FFN
    at M-RoPE positions, through both packages. Returns backend -> list
    of (port logits, reference logits, port ids, port length, reference
    length), the prefill first (ids None)."""
    jcfg, tcfg, jmodel, jplan, tree = vlm_weights
    B, S, T = 2, 6, 16 + 6 + 4
    rng = np.random.default_rng(14)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, jcfg.num_image_tokens, jcfg.d_model)
                                  ).astype(np.float32) * 0.1
    jparams = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(tree, tcfg, device="cpu")
    step = tvlm.make_decode_step(tcfg, collect_indices=True)
    out = {}
    for backend in ("jnp", "pallas"):
        jp = dataclasses.replace(jplan.plan_for_batch(B), backend=backend)
        tp = dataclasses.replace(build_plan(tcfg, hw=PHONE).plan_for_batch(B),
                                 backend=backend)
        jl, jc = jmodel.prefill(jparams, {"tokens": tokens,
                                          "patch_embeds": patches}, max_len=T)
        tl, tc = tvlm.prefill(model, torch.from_numpy(tokens),
                              torch.from_numpy(patches), max_len=T)
        rows = [(tl.numpy(), np.asarray(jl), None, None, None)]
        for _ in range(4):
            nxt = np.asarray(jl[:, -1].argmax(-1), np.int32)[:, None]
            jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt), jc, jp)
            tl, tc, ids = step(model, torch.from_numpy(nxt), tc, tp)
            rows.append((tl.numpy(), np.asarray(jl), ids.numpy(),
                         tc["length"].numpy().copy(),
                         np.asarray(jc["length"])))
        out[backend] = (rows, tp)
    return out


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_vlm_prefill_and_decode_match_reference(vlm_decode, backend):
    rows, tp = vlm_decode[backend]
    for tl, jl, ids, tlen, jlen in rows:
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        if ids is not None:
            assert ids.shape == (2, tp.groups,           # (L, G, kc)
                                 tp.k_cold // tp.cluster_size)
            np.testing.assert_array_equal(tlen, jlen)


def test_vlm_decode_ids_agree_between_backends(vlm_decode):
    ids = {b: [r[2] for r in rows[1:]] for b, (rows, _) in vlm_decode.items()}
    for a, b in zip(ids["jnp"], ids["pallas"]):
        np.testing.assert_array_equal(a, b)
