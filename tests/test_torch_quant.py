"""Quantized cold storage in the port against the JAX package, on the
same numpy inputs: byte accounting, the exact top-k outlier mask, the
int8 / int4-mixed bundle quantizers (bit-identical codes, scales,
outliers and roundtrip, tie-heavy bf16 weights included), the per-tensor
group-wise, per-channel and mixed int4 schemes and the int8 KV helpers
(bit-identical at fp32, bf16 and fp16, all-zero rows and tied
magnitudes included; `quant_error` and `kv_quant_error` within 1e-6),
the plan at
every storage dtype, the quant mode of fused_cold_ffn (its plain
version against the Pallas kernel in interpret mode: ids identical, y
within the reference's 2e-4 / 5e-2) and the engine on reduced smollm
(greedy tokens and every TokenStats field identical, both backends).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.planner import PHONE as JPHONE, build_plan as jbuild_plan, \
    hot_io_cap as jhot_io_cap
from repro.core.sparse_ffn import _gather_quant as jgather_quant
from repro.kernels import ops as jops
from repro.models import dense as jdense
from repro.quant import quantize as jq
from repro.quant import storage as js
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.families import _dense_prepare as jprepare
from repro_torch.bridge import _tensor, params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.core.planner import PHONE, build_plan, hot_io_cap
from repro_torch.core.sparse_ffn import _gather_quant
from repro_torch.kernels import ops as tops
from repro_torch.models.dense import make_model
from repro_torch.quant import quantize as tq
from repro_torch.quant import storage as ts
from repro_torch.serving.engine import ServeEngine as TEngine
from repro_torch.serving.families import _dense_prepare

SDS = ("int8", "int4-mixed")


def _t(a):
    return _tensor(np.asarray(a))


def _assert_same(t, j, name):
    """Bit-identical: same dtype width, same bits."""
    j = np.asarray(j)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
        j = j.view(np.int16)
    np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


# ------------------------------------------------------- accounting ----

@pytest.mark.parametrize("sd", ("fp16",) + SDS)
@pytest.mark.parametrize("d,rows,itemsize", [(576, 3, 2), (4096, 3, 2),
                                             (256, 2, 4), (100, 3, 2)])
def test_bundle_nbytes_matches_reference(sd, d, rows, itemsize):
    for align in (4096, 0, 512):
        assert tq.bundle_nbytes(d, sd, rows=rows, itemsize=itemsize,
                                align=align) == \
            jq.bundle_nbytes(d, sd, rows=rows, itemsize=itemsize,
                             align=align)
    assert tq.bundle_nbytes_int4(d, rows == 3, outlier_frac=0.03) == \
        jq.bundle_nbytes_int4(d, rows == 3, outlier_frac=0.03)
    with pytest.raises(ValueError, match="unknown storage dtype"):
        tq.bundle_nbytes(d, "int3")


@pytest.mark.parametrize("sd", ("fp16",) + SDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_plan_and_io_cap_match_reference(sd, reduced):
    jcfg, tcfg = jget_config("smollm-135m"), tget_config("smollm-135m")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert hot_io_cap(tcfg, PHONE, sd) == jhot_io_cap(jcfg, JPHONE, sd)
    tp = build_plan(tcfg, hw=PHONE, backend="pallas", storage_dtype=sd)
    jp = jbuild_plan(jcfg, hw=JPHONE, backend="pallas", storage_dtype=sd)
    assert {b: dataclasses.asdict(p) for b, p in tp.plans.items()} == \
        {b: dataclasses.asdict(p) for b, p in jp.plans.items()}
    np.testing.assert_array_equal(tp.neuron_order, jp.neuron_order)
    assert ts.plan_storage_dtype(tp) == js.plan_storage_dtype(jp) == sd
    assert ts.quant_boundary(tp) == js.quant_boundary(jp)
    if not reduced:
        # the full-width cold path: 64 hot neurons, 23 clusters of 64
        for p in tp.plans.values():
            assert (p.n_hot, p.cluster_size, p.groups,
                    p.clusters_per_group) == (64, 64, 1, 1)


def test_storage_dtype_checks_match_reference():
    for sd in ("fp16",) + SDS:
        assert ts.check_storage_dtype(sd) == js.check_storage_dtype(sd)
    for mod in (ts, js):
        with pytest.raises(ValueError, match="unknown storage dtype"):
            mod.check_storage_dtype("int2")
    with pytest.raises(ValueError, match="identity"):
        ts.quantize_bundles(torch.zeros(2, 3), "fp16")


# ----------------------------------------------------- quantizers ----

def _weights(kind, shape, seed):
    """(jnp, torch) of one weight tensor with the same bits. 'ties' draws
    bf16 weights from seven values of four magnitudes, so |w| ties
    constantly and the outlier mask's tie order decides."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        w = rng.choice(np.array([-0.25, -0.125, 0.03125, 0.125, 0.25,
                                 0.5, -0.5], np.float32), size=shape)
    else:
        w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    dt = jnp.float32 if kind == "fp32" else jnp.bfloat16
    wj = jnp.asarray(w, dt)
    return wj, _t(np.asarray(wj))


def test_exact_topk_mask_ties_match_reference():
    wj, wt = _weights("ties", (6, 40), seed=3)
    for k in (1, 7, 50, 240):
        mj = jq.exact_topk_mask(jnp.abs(wj.astype(jnp.float32)), k)
        mt = tq.exact_topk_mask(wt.float().abs(), k)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        assert int(mt.sum()) == k


@pytest.mark.parametrize("kind", ["fp32", "bf16", "ties"])
@pytest.mark.parametrize("sd", SDS)
def test_quantize_bundles_bit_identical(sd, kind):
    """(L, N, R, D) stack with per-layer budgets (batch_dims=1), as the
    reference's _quantize_ffn quantizes."""
    wj, wt = _weights(kind, (2, 96, 3, 40), seed=5)
    qj = js.quantize_bundles(wj, sd, batch_dims=1)
    qt = ts.quantize_bundles(wt, sd, batch_dims=1)
    assert set(qt) == set(qj)
    for k in qj:
        _assert_same(qt[k], qj[k], k)
    _assert_same(ts.dequantize_bundles(qt), js.dequantize_bundles(qj),
                 "dequantized")
    if sd == "int4-mixed":
        k = int(round(96 * 3 * 40 * js.OUTLIER_FRAC))
        assert [int((qt["wout"][l] != 0).sum()) for l in range(2)] == [k, k]


# ------------------------------------------- per-tensor int4 and KV ----

DTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "fp16": jnp.float16}


def _tensor_pair(dtype, shape, seed, ties=False):
    """(jnp, torch) of one tensor with the same bits at `dtype`, its
    second row along the first axis all zero (the scale floor) and, with
    `ties`, values of four magnitudes only (the outlier mask's tie
    order decides)."""
    rng = np.random.default_rng(seed)
    if ties:
        w = rng.choice(np.array([-0.5, -0.25, 0.125, 0.25, 0.5, 1.0, -1.0],
                                np.float32), size=shape)
    else:
        w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    w[1] = 0.0
    wj = jnp.asarray(w, DTYPES[dtype])
    return wj, _t(np.asarray(wj))


def _same_tree(t, j, name):
    assert set(t) == set(j), name
    for k in j:
        if isinstance(j[k], dict):
            _same_tree(t[k], j[k], f"{name}.{k}")
        elif isinstance(j[k], int):
            assert t[k] == j[k], f"{name}.{k}"
        else:
            _assert_same(t[k], j[k], f"{name}.{k}")


SCHEMES = {
    "group32": (lambda m, w: m.quantize_groupwise_int4(w),
                lambda m, q: m.dequantize_groupwise_int4(q)),
    "group16": (lambda m, w: m.quantize_groupwise_int4(w, group=16),
                lambda m, q: m.dequantize_groupwise_int4(q)),
    "per_channel": (lambda m, w: m.quantize_per_channel_int4(w),
                    lambda m, q: m.dequantize_per_channel_int4(q)),
    "mixed": (lambda m, w: m.quantize_mixed(w),
              lambda m, q: m.dequantize_mixed(q)),
    "mixed5": (lambda m, w: m.quantize_mixed(w, outlier_frac=0.05),
               lambda m, q: m.dequantize_mixed(q)),
}


@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_per_tensor_scheme_bit_identical(scheme, dtype, ties):
    """Codes, scales, outlier masks, fp16 outliers and the dequantized
    weights of each int4 scheme equal the reference's bit for bit, an
    all-zero row and a (2, 5, 64) stack included."""
    quant, dequant = SCHEMES[scheme]
    for shape in ((6, 64), (2, 5, 64)):
        wj, wt = _tensor_pair(dtype, shape, seed=len(scheme), ties=ties)
        qj, qt = quant(jq, wj), quant(tq, wt)
        _same_tree(qt, qj, scheme)
        _assert_same(dequant(tq, qt), dequant(jq, qj), f"{scheme} dequant")
    if scheme.startswith("mixed"):
        frac = 0.05 if scheme == "mixed5" else 0.01
        assert int(qt["outlier_mask"].sum()) == max(1, int(
            wt.numel() * frac))


def test_groupwise_needs_whole_groups():
    for mod, w in ((jq, jnp.zeros((3, 40))), (tq, torch.zeros(3, 40))):
        with pytest.raises(ValueError, match="multiple of group=32"):
            mod.quantize_groupwise_int4(w)
    assert tq.quantize_groupwise_int4(torch.zeros(3, 40), group=8)[
        "q"].shape == (3, 40)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scheme", ["group32", "per_channel", "mixed"])
def test_quant_error_matches_reference(scheme, dtype):
    wj, wt = _tensor_pair(dtype, (8, 96), seed=7)
    kw = {"outlier_frac": 0.02} if scheme == "mixed" else {}
    got = tq.quant_error(wt, scheme, **kw)
    want = jq.quant_error(wj, scheme, **kw)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
    assert tq.quant_error(np.array(wj, np.float32), scheme, **kw) == \
        pytest.approx(want, rel=1e-6, abs=1e-6)
    with pytest.raises(ValueError):
        tq.quant_error(wt, "int3")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kv_helpers_bit_identical(dtype):
    """int8 KV codes and per-(token, head) scales, an all-zero vector's
    floor included; the roundtrip error within 1e-6."""
    kvj, kvt = _tensor_pair(dtype, (2, 7, 3, 16), seed=8)
    qj, qt = jq.quantize_kv(kvj), tq.quantize_kv(kvt)
    _same_tree(qt, qj, "kv")
    assert qt["scale"].shape == (2, 7, 3, 1) and qt["q"].dtype == torch.int8
    assert float(qt["scale"][1].min()) == np.float32(1e-8)
    _assert_same(tq.dequantize_kv(qt), jq.dequantize_kv(qj), "kv dequant")
    assert tq.kv_quant_error(kvt) == pytest.approx(
        jq.kv_quant_error(kvj), rel=1e-6, abs=1e-6)


@pytest.fixture(scope="module")
def reduced_params():
    """The reference's reduced smollm configs and fp32 weights (before
    the hot-first permutation)."""
    jcfg = jget_config("smollm-135m").reduced()
    tcfg = tget_config("smollm-135m").reduced()
    params = jdense.make_model(jcfg).init(jax.random.key(2))
    return jcfg, tcfg, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sd", SDS)
def test_quantize_plan_params_bit_identical(reduced_params, sd, dtype):
    """The port's prepare (permute, then quantize) gives the reference's
    w (hot rows fp, cold rows the roundtrip), wq, wsc and wout."""
    jcfg, tcfg, params = reduced_params
    jcfg = jcfg.replace(param_dtype=dtype)
    tcfg = tcfg.replace(param_dtype=dtype)
    if dtype == "bfloat16":
        params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    jplan = jbuild_plan(jcfg, hw=JPHONE, storage_dtype=sd)
    tplan = build_plan(tcfg, hw=PHONE, storage_dtype=sd)
    jout = jax.tree.map(np.asarray, jprepare(params, jplan))
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    model = _dense_prepare(model, tplan)
    jffn = jout["layers"]["ffn"]
    for l, layer in enumerate(model.layers):
        for k in ("w", "wq", "wsc", "wout"):
            t = getattr(layer.ffn, k)
            if k not in jffn:
                assert t is None
                continue
            _assert_same(t, jffn[k][l], f"layer {l} {k}")
    # the hot prefix stays full precision
    n_q = ts.quant_boundary(tplan)
    w0 = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu")
    from repro_torch.core.planner import permute_ffn_params
    w0 = permute_ffn_params(w0, tplan.neuron_order)
    assert torch.equal(w0.layers[0].ffn.w[:n_q], model.layers[0].ffn.w[:n_q])


def test_fp16_storage_is_the_identity(reduced_params):
    _, tcfg, _ = reduced_params
    model = make_model(tcfg, device="cpu", seed=0)
    w = model.layers[0].ffn.w.clone()
    plan = build_plan(tcfg, hw=PHONE)
    model = ts.quantize_plan_params(model, plan)
    assert torch.equal(model.layers[0].ffn.w, w)
    assert model.layers[0].ffn.quant is None


@pytest.mark.parametrize("sd", SDS)
def test_gather_quant_bit_identical(sd):
    wj, wt = _weights("bf16", (2, 5, 8, 3, 24), seed=9)
    qj = js.quantize_bundles(wj, sd)
    qt = ts.quantize_bundles(wt, sd)
    cidx = np.array([[4, 0, 2], [1, 3, 0]], np.int32)
    dj = jgather_quant(qj["wq"], qj["wsc"], qj.get("wout"), jnp.asarray(cidx))
    dt = _gather_quant(qt["wq"], qt["wsc"], qt.get("wout"),
                       torch.from_numpy(cidx))
    _assert_same(dt, dj, "gathered")


# ------------------------------------------- fused kernel, quant mode ----

ACTS = [("silu", 3), ("relu2", 3), ("gelu", 2), ("geglu", 3)]
# (B, D, r, cs, G, nc_g, kc)
SHAPES = [(2, 64, 16, 32, 1, 8, 3), (4, 128, 16, 64, 2, 4, 2),
          (1, 64, 8, 32, 3, 4, 4)]


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-4, rtol=2e-4)


def _quant_case(sd, B, D, r, cs, G, nc_g, R, dtype, seed, mask=None,
                act="silu", mode="cats", kc=1):
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(rng.standard_normal((B, D)) * 0.5, jdt)
    wc = jnp.asarray(rng.standard_normal((G, nc_g, cs, R, D)) * 0.1, jdt)
    A = jnp.asarray(rng.standard_normal((D, r)) * 0.3, jdt)
    Bp = jnp.asarray(rng.standard_normal((r, G * nc_g * cs)) * 0.3, jdt)
    q = {k: np.asarray(v) for k, v in js.quantize_bundles(wc, sd).items()}
    jm = None if mask is None else jnp.asarray(mask)
    yj, ij = jops.fused_cold_ffn(x, wc, A, Bp, activation=act, mode=mode,
                                 kc=kc, active_mask=jm, interpret=True,
                                 **{k: jnp.asarray(v) for k, v in q.items()})
    tm = None if mask is None else torch.from_numpy(mask)
    yt, it = tops.fused_cold_ffn(
        _t(x), _t(wc), _t(A), _t(Bp), activation=act, mode=mode, kc=kc,
        active_mask=tm, **{k: _t(v) for k, v in q.items()})
    return (np.asarray(yj, np.float32), np.asarray(ij)), \
        (yt.float().numpy(), it.numpy())


@pytest.mark.parametrize("sd", SDS)
@pytest.mark.parametrize("act,R", ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_cold_ffn_quant_matches_jax(sd, act, R, shape):
    B, D, r, cs, G, nc_g, kc = shape
    (yj, ij), (yt, it) = _quant_case(sd, B, D, r, cs, G, nc_g, R, "float32",
                                     seed=B * D + cs, act=act, kc=kc)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(yt, yj, **_tol("float32"))


@pytest.mark.parametrize("sd", SDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dead", ["none", "some"])
def test_fused_cold_ffn_quant_dtypes_and_dead_rows(sd, dtype, dead):
    mask = None if dead == "none" else np.array([True, False, True, False])
    (yj, ij), (yt, it) = _quant_case(sd, 4, 128, 16, 32, 2, 4, 3, dtype,
                                     seed=21, mask=mask, kc=2)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(yt, yj, **_tol(dtype))


def test_fused_cold_ffn_quant_plain_version_reads_codes_not_wc():
    """In quant mode the plain version computes from the codes: wc's
    values do not matter, only its shape."""
    B, D, r, cs, G, nc_g, R = 2, 64, 8, 32, 1, 4, 3
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, wc, A, Bp = f(B, D), f(G, nc_g, cs, R, D) * 0.1, f(D, r), f(r, 128)
    q = ts.quantize_bundles(wc, "int4-mixed")
    kw = dict(activation="silu", mode="cats", kc=2, **q)
    y1, i1 = tops.fused_cold_ffn(x, wc, A, Bp, **kw)
    y2, i2 = tops.fused_cold_ffn(x, torch.zeros_like(wc), A, Bp, **kw)
    assert torch.equal(y1, y2) and torch.equal(i1, i2)


# ---------------------------------------------------------- engine ----

BUCKETS = (1, 2, 4)
STREAM = [(8, 6, 0.0), (8, 5, 2e-4), (12, 4, 5e-4)]


@pytest.fixture(scope="module")
def quant_engines(reduced_params):
    jcfg, tcfg, params = reduced_params
    built = {}

    def get(sd, backend):
        if (sd, backend) not in built:
            jplan = jbuild_plan(jcfg, hw=JPHONE, storage_dtype=sd)
            jp = jprepare(params, jplan)
            tree = jax.tree.map(np.asarray, jp)
            tplan = build_plan(tcfg, hw=PHONE, storage_dtype=sd)
            kw = dict(buckets=BUCKETS, temperature=0.0, seed=0,
                      backend=backend)
            je = JEngine(jcfg, jp, jplan, **kw)
            te = TEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"),
                         tplan, **kw)
            built[(sd, backend)] = (je, te)
        return built[(sd, backend)]
    yield get
    for je, te in built.values():
        je.close()
        te.close()


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("sd", SDS)
def test_engine_quant_stream_matches_jax(quant_engines, reduced_params, sd,
                                         backend):
    je, te = quant_engines(sd, backend)
    assert te.storage.storage_dtype == sd
    assert te.storage.bundle_bytes == je.storage.bundle_bytes
    rng = np.random.default_rng(7)
    vocab = reduced_params[0].vocab_size
    prompts = [rng.integers(0, vocab, s).astype(np.int32)
               for s, _, _ in STREAM]
    reps, gens = [], []
    for e in (je, te):
        uids = [e.submit(p, max_new=m, arrival_time=t)
                for p, (_, m, t) in zip(prompts, STREAM)]
        reps.append(e.run_until_drained())
        gens.append([e.sched.sequences[u].generated for u in uids])
    assert gens[1] == gens[0]
    assert [len(g) for g in gens[1]] == [m for _, m, _ in STREAM]
    assert [dataclasses.asdict(s) for s in reps[1].stats] == \
        [dataclasses.asdict(s) for s in reps[0].stats]
    assert te.sched.batch_history == je.sched.batch_history
