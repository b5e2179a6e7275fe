"""The ssm, hybrid and encdec families (mamba2-130m, recurrentgemma-9b,
seamless-m4t-large-v2) and the sliding-window ring cache, against the
JAX package on the same numpy inputs and weights, reduced configs in
fp32, on the CPU.

* Core functions: `segsum` and `ssd_step` within 1e-6; `ssd_chunked`
  (with and without `init_state`), `causal_conv` with a tail,
  `rglru_full` (with and without `init_h`) and `rglru_step` within 1e-5.
  `rglru_full` scans by doubling, the reference by
  `jax.lax.associative_scan`: the products and sums associate in another
  order, a few fp32 roundings per step. The properties of
  tests/test_ssm_rglru.py on the port: chunked equals sequential, the
  chunk size does not change the result, a step continues the chunked
  state, scan equals step, |y| stays bounded over 2,048 steps.
* Each family: forward logits (no plan, and a `backend='pallas'` plan
  whose reference kernel runs in interpret mode), prefill logits and
  every cache tensor, then 32 greedy decode steps with and without the
  plan: tokens identical, logits within 1e-4 (the sums of the layer
  stack run in another order; the scan as above).
* Decode equals forward for the three configs, as
  tests/test_decode_consistency.py holds the reference.
* The ring: recurrentgemma-9b with local_window 16, smollm-135m and
  seamless with sliding_window 16, prefill 32 then decode 32 (the ring
  wraps twice), against the reference and against the port's forward;
  an unaligned ring prefill raises in both packages.
* `build_model` and `Model.init_cache` give the reference's cache
  layout for every family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_batch
from repro import configs as jconfigs
from repro.core.clusters import make_plan as jmake_plan
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.model import build_model as jbuild_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.clusters import make_plan
from repro_torch.models import rglru, ssm
from repro_torch.models.model import build_model, wrap

FAMILIES = ["mamba2-130m", "recurrentgemma-9b", "seamless-m4t-large-v2"]
TOL = 1e-4
N_DEC = 32


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------- core (SSD) ----

def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32),
            (-np.abs(rng.standard_normal((b, s, h))) * 0.3).astype(np.float32),
            (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32),
            (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32))


def test_segsum_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 3, 7)).astype(np.float32)
    got, want = ssm.segsum(_t(x)).numpy(), np.asarray(jssm.segsum(x))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    ss = ssm.segsum(torch.ones(4)).numpy()
    assert np.isneginf(ss[0, 1]) and ss[3, 0] == 3.0
    np.testing.assert_array_equal(np.diag(ss), 0.0)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunked_matches_reference(chunk, init):
    X, A, B, C = _ssd_inputs(2, 32, 3, 8, 16, seed=chunk)
    st = (np.random.default_rng(1).standard_normal((2, 3, 8, 16)) * 0.5
          ).astype(np.float32) if init else None
    Y, f = ssm.ssd_chunked(_t(X), _t(A), _t(B), _t(C), chunk,
                           None if st is None else _t(st))
    jY, jf = jssm.ssd_chunked(X, A, B, C, chunk, st)
    _close(Y, jY, 1e-5)
    _close(f, jf, 1e-5)


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(2)
    b, h, p, n = 2, 3, 8, 16
    args = [rng.standard_normal(s).astype(np.float32) for s in
            ((b, h, p, n), (b, h, p), (b, h), (b, h), (b, n), (b, n))]
    args[2] = -np.abs(args[2])
    s2, y = ssm.ssd_step(*map(_t, args))
    js, jy = jssm.ssd_step(*args)
    _close(s2, js, 1e-6)
    _close(y, jy, 1e-6)


@pytest.mark.parametrize("b,s,h,p,n", [(1, 16, 1, 4, 8), (2, 32, 3, 8, 16),
                                       (3, 64, 4, 8, 8)])
def test_ssd_chunked_equals_sequential(b, s, h, p, n):
    X, A, B, C = map(_t, _ssd_inputs(b, s, h, p, n, seed=s * h + p))
    Y, fs = ssm.ssd_chunked(X, A, B, C, chunk=16)
    st, ys = torch.zeros((b, h, p, n)), []
    for t in range(s):
        st = st * torch.exp(A[:, t])[..., None, None] \
            + torch.einsum("bhp,bn->bhpn", X[:, t], B[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", st, C[:, t]))
    np.testing.assert_allclose(Y.numpy(), torch.stack(ys, 1).numpy(),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(fs.numpy(), st.numpy(), atol=1e-4, rtol=1e-3)


def test_ssd_chunk_size_invariance():
    X, A, B, C = map(_t, _ssd_inputs(2, 64, 2, 8, 16, seed=0))
    Y16, f16 = ssm.ssd_chunked(X, A, B, C, 16)
    Y64, f64 = ssm.ssd_chunked(X, A, B, C, 64)
    np.testing.assert_allclose(Y16.numpy(), Y64.numpy(), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(f16.numpy(), f64.numpy(), atol=1e-4,
                               rtol=1e-3)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.ssd_chunked(X[:, :40], A[:, :40], B[:, :40], C[:, :40], 16)


def test_ssd_step_continues_chunked():
    """The state of a chunked prefill continues exactly through steps (X
    already dt-scaled, so dt = 1)."""
    b, s, h, p, n = 1, 32, 2, 8, 16
    X, A, B, C = map(_t, _ssd_inputs(b, s + 4, h, p, n, seed=1))
    Yfull, _ = ssm.ssd_chunked(X, A, B, C, chunk=4)
    _, state = ssm.ssd_chunked(X[:, :s], A[:, :s], B[:, :s], C[:, :s], 16)
    outs = []
    for t in range(s, s + 4):
        state, y = ssm.ssd_step(state, X[:, t], A[:, t], torch.ones((b, h)),
                                B[:, t], C[:, t])
        outs.append(y)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               Yfull[:, s:].numpy(), atol=1e-4, rtol=1e-3)


def test_causal_conv_matches_reference_and_streams():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    w = (rng.standard_normal((4, 8)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(8) * 0.1).astype(np.float32)
    tail = rng.standard_normal((2, 3, 8)).astype(np.float32)
    for t in (None, tail):
        y, nt = ssm.causal_conv(_t(x), _t(w), _t(bias),
                                None if t is None else _t(t))
        jy, jt = jssm.causal_conv(x, w, bias, t)
        _close(y, jy, 1e-5)
        _close(nt, jt, 0.0)
    y_full, _ = ssm.causal_conv(_t(x), _t(w), _t(bias))
    y1, t1 = ssm.causal_conv(_t(x[:, :8]), _t(w), _t(bias))
    y2, _ = ssm.causal_conv(_t(x[:, 8:]), _t(w), _t(bias), t1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-5, rtol=1e-5)


# -------------------------------------------------------- core (RG-LRU) ----

class _Cfg:
    rglru_c = 8.0


def _lru(d, seed):
    rng = np.random.default_rng(seed)
    p = {k: (rng.standard_normal(d) * 0.5).astype(np.float32)
         for k in ("w_r", "b_r", "w_i", "b_i")}
    p["lam"] = (0.7 + rng.standard_normal(d) * 0.1).astype(np.float32)
    m = rglru.LRU(d, torch.float32, "cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(m, k).copy_(_t(v))
    return p, m


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("s", [1, 7, 32, 100])
def test_rglru_full_matches_reference(s, init):
    p, m = _lru(16, s)
    rng = np.random.default_rng(s + 1)
    x = (rng.standard_normal((2, s, 16)) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32) if init else None
    y, h = rglru.rglru_full(m, _t(x), _Cfg, None if h0 is None else _t(h0))
    jy, jh = jrglru.rglru_full(p, x, _Cfg, h0)
    _close(y, jy, 1e-5)
    _close(h, jh, 1e-5)


def test_rglru_step_matches_reference():
    p, m = _lru(16, 0)
    rng = np.random.default_rng(4)
    x, h = (rng.standard_normal((3, 16)).astype(np.float32) for _ in "xh")
    y, h2 = rglru.rglru_step(m, _t(x), _Cfg, _t(h))
    jy, jh = jrglru.rglru_step(p, x, _Cfg, h)
    _close(y, jy, 1e-6)
    _close(h2, jh, 1e-6)


@pytest.mark.parametrize("b,s,d", [(1, 8, 16), (2, 32, 64), (3, 33, 16)])
def test_rglru_scan_equals_step(b, s, d):
    p, m = _lru(d, b + s)
    x = _t(np.random.default_rng(b + s).standard_normal((b, s, d)) * 0.5)
    y_full, h_final = rglru.rglru_full(m, x, _Cfg)
    h, ys = torch.zeros((b, d)), []
    for t in range(s):
        y, h = rglru.rglru_step(m, x[:, t], _Cfg, h)
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_full.numpy(),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(h.numpy(), h_final.numpy(), atol=1e-4,
                               rtol=1e-3)


def test_rglru_stability():
    """|a_t| < 1 by construction: 2,048 steps stay bounded."""
    _, m = _lru(32, 9)
    y, _ = rglru.rglru_full(m, torch.randn((1, 2048, 32),
                                           generator=torch.Generator()
                                           .manual_seed(9)), _Cfg)
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) < 100.0


# ------------------------------------------------------------ families ----

def _perturbed(params, seed=0):
    """The reference's init as numpy, each constant leaf (zero norms,
    biases, A_log, D, dt_bias, lam) moved by N(0, 0.1) so that every
    weight reaches the output."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if a.size > 1 and np.all(a == a.flat[0]):
            a = (a + rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a
    return jax.tree.map(move, params)


class Pair:
    """One reduced config in both packages on the same numpy weights."""

    def __init__(self, arch, cfg_fn=lambda c: c):
        self.jcfg = cfg_fn(jconfigs.get_config(arch).reduced())
        self.tcfg = cfg_fn(tconfigs.get_config(arch).reduced())
        self.jm = jbuild_model(self.jcfg)
        tree = _perturbed(self.jm.init(jax.random.key(0)))
        self.params = jax.tree.map(jnp.asarray, tree)
        self.model = wrap(params_from_numpy(tree, self.tcfg, device="cpu"))

    def plans(self, backend):
        """(reference plan, port plan) of the config's sparse FFN, or
        (None, None) without one."""
        s = self.jcfg.sparse_ffn
        if backend is None or not s.enabled:
            return None, None
        args = (self.jcfg.d_ff, s.hot_ratio, s.cold_active_ratio,
                s.cluster_size)
        return (jmake_plan(*args, backend=backend),
                make_plan(*args, backend=backend))

    def batch(self, B, S, seed=0):
        jb = tiny_batch(self.jcfg, B, S, seed=seed)
        return jb, {k: torch.from_numpy(v) for k, v in jb.items()}


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    return Pair(request.param)


@pytest.mark.parametrize("backend", [None, "pallas"])
def test_forward_matches_reference(pair, backend):
    jp, tp = pair.plans(backend)
    jb, tb = pair.batch(2, 32)
    want = jax.jit(lambda p, b: pair.jm.forward(p, b, jp))(pair.params, jb)
    got = pair.model.forward(pair.model.module, tb, tp)
    assert got.shape == want.shape
    _close(got, want)


def _greedy(pair, backend, B=2, S=32, n=N_DEC):
    """Prefill S tokens, then n greedy decode steps in both packages:
    logits, tokens and the prefill cache compared at every step."""
    jp, tp = pair.plans(backend)
    jb, tb = pair.batch(B, S, seed=1)
    T = S + n
    jlog, jcache = jax.jit(lambda p, b: pair.jm.prefill(p, b, max_len=T))(
        pair.params, jb)
    m = pair.model
    tlog, tcache = m.prefill(m.module, tb, T)
    _close(tlog, jlog)
    assert sorted(tcache) == sorted(jcache)
    for k, v in jcache.items():
        assert tuple(tcache[k].shape) == v.shape, k
        if v.dtype == jnp.int32:
            np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(v))
        else:
            _close(tcache[k], v)
    jstep = jax.jit(lambda p, t, c: pair.jm.decode_step(p, t, c, jp))
    for _ in range(n):
        jt = np.asarray(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
        tt = tlog[:, -1].argmax(-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tt.numpy(), jt)
        jlog, jcache = jstep(pair.params, jnp.asarray(jt), jcache)
        tlog, tcache = m.decode_step(m.module, tt, tcache, tp)
        _close(tlog, jlog)
    for k, v in jcache.items():
        if v.dtype == jnp.int32:
            np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(v))
        else:
            _close(tcache[k], v)


@pytest.mark.parametrize("backend", [None, "pallas"])
def test_prefill_and_greedy_decode_match_reference(pair, backend):
    _greedy(pair, backend)


def _decode_vs_forward(model, tb, half):
    """prefill(half) + decode of the rest against forward: the logits at
    positions half .. S-2, as tests/test_decode_consistency.py."""
    S = tb["tokens"].shape[1]
    full = model.forward(model.module, tb)
    _, cache = model.prefill(model.module, dict(tb, tokens=tb["tokens"][
        :, :half]), S)
    outs = []
    for t in range(half, S):
        lg, cache = model.decode_step(model.module, tb["tokens"][:, t:t + 1],
                                      cache)
        outs.append(lg)
    return torch.cat(outs[:-1], 1), full[:, half:-1]


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    cfg = tconfigs.get_config(arch).reduced()
    model = build_model(cfg, device="cpu", seed=0)
    tb = {k: torch.from_numpy(v) for k, v in tiny_batch(cfg, 2, 64).items()}
    dec, ref = _decode_vs_forward(model, tb, 32)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), atol=5e-3,
                               rtol=1e-3)


# ---------------------------------------------------------------- ring ----

RING = {"recurrentgemma-9b": lambda c: c.replace(local_window=16),
        "smollm-135m": lambda c: c.replace(sliding_window=16),
        "seamless-m4t-large-v2": lambda c: c.replace(sliding_window=16)}


@pytest.mark.parametrize("arch", sorted(RING))
def test_ring_wrap_matches_reference_and_forward(arch):
    """A window of 16: prefill 32 keeps the last 16 tokens in the ring,
    32 decode steps wrap it twice."""
    pair = Pair(arch, RING[arch])
    _greedy(pair, "pallas")
    _, tb = pair.batch(2, 64, seed=2)
    dec, ref = _decode_vs_forward(pair.model, tb, 32)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), atol=5e-3,
                               rtol=1e-3)
    _, cache = pair.model.prefill(pair.model.module, dict(
        tb, tokens=tb["tokens"][:, :32]), 64)
    kv_pos = cache["kv_pos"].numpy()
    assert kv_pos.shape == (2, 16)
    np.testing.assert_array_equal(kv_pos, np.tile(np.arange(16, 32), (2, 1)))


@pytest.mark.parametrize("arch", sorted(RING))
def test_unaligned_ring_prefill_raises(arch):
    """A prompt longer than the window and not a multiple of it: the
    reference asserts, the port raises."""
    pair = Pair(arch, RING[arch])
    jb, tb = pair.batch(1, 20)
    with pytest.raises(AssertionError):
        pair.jm.prefill(pair.params, jb)
    with pytest.raises(ValueError, match="window"):
        pair.model.prefill(pair.model.module, tb)


def test_short_ring_prefill_pads():
    """Shorter than the local window: the ring keeps every token, the
    other slots empty (kv_pos -1), as the reference's."""
    pair = Pair("recurrentgemma-9b", RING["recurrentgemma-9b"])
    jb, tb = pair.batch(2, 10)
    _, jc = pair.jm.prefill(pair.params, jb)
    _, tc = pair.model.prefill(pair.model.module, tb)
    np.testing.assert_array_equal(tc["kv_pos"].numpy(),
                                  np.asarray(jc["kv_pos"]))
    _close(tc["attn_k"], jc["attn_k"])


# ----------------------------------------------------------- the API ----

@pytest.mark.parametrize("arch", FAMILIES + ["smollm-135m", "qwen2-vl-2b",
                                             "deepseek-moe-16b"])
def test_init_cache_layout_matches_reference(arch):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    want = jbuild_model(jcfg).init_cache(3, 40)
    got = build_model(tcfg, device="cpu", seed=None).init_cache(3, 40)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("seq_len,window", [(64, 16), (16, 16), (8, 16),
                                            (64, 0), (None, 16)])
def test_init_ring_cache_sizes_by_window(seq_len, window):
    """A window shorter than seq_len (or seq_len None) gives the
    reference's ring of `window` slots, else its full cache of
    `seq_len`."""
    from repro.models import kv_cache as jkv
    from repro_torch.models.kv_cache import init_ring_cache
    got = init_ring_cache(2, 3, seq_len, window, 2, 4, torch.float32, "cpu")
    ring = seq_len is None or (window and window < seq_len)
    want = jkv.init_ring_cache(2, 3, window, 2, 4, jnp.float32) if ring \
        else jkv.init_full_cache(2, 3, seq_len, 2, 4, jnp.float32)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("arch", FAMILIES + ["smollm-135m", "qwen2-vl-2b",
                                             "deepseek-moe-16b",
                                             "turbosparse-mixtral-47b"])
def test_model_tree_covers_every_parameter(arch):
    """The one layout walk that loads, saves and shards weights reaches
    every parameter of the module exactly once."""
    from repro_torch.bridge import model_tree
    model = build_model(tconfigs.get_config(arch).reduced(), device="cpu",
                        seed=None).module
    seen = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            seen.extend(id(t) for t in
                        (node if isinstance(node, list) else [node]))
    walk(model_tree(model))
    assert sorted(seen) == sorted(id(p) for p in model.parameters())


def test_params_from_numpy_refuses_a_tree_walk_that_misses(monkeypatch):
    import repro_torch.bridge as bridge
    cfg = tconfigs.get_config("mamba2-130m").reduced()
    tree = bridge.params_to_numpy(build_model(cfg, device="cpu").module).tree
    full = bridge.model_tree
    monkeypatch.setattr(bridge, "model_tree", lambda m: {
        k: v for k, v in full(m).items() if k != "out_norm"})
    with pytest.raises(AssertionError, match="out_norm"):
        bridge.params_from_numpy(tree, cfg, device="cpu")


def test_build_model_builds_every_family():
    from repro_torch.models import encdec
    kinds = {"mamba2-130m": ssm.SSMModel,
             "recurrentgemma-9b": rglru.HybridModel,
             "seamless-m4t-large-v2": encdec.EncDecModel}
    for arch, kind in kinds.items():
        cfg = tconfigs.get_config(arch).reduced()
        m = build_model(cfg, device="cpu", seed=0)
        assert type(m.module) is kind and m.cfg is cfg
        assert not any(p.requires_grad for p in m.module.parameters())
        assert dataclasses.is_dataclass(m)
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg.replace(family="nope"), device="cpu")


def test_hybrid_layer_order_is_group_major():
    """38 layers: 12 groups of (rec, rec, attn), then 2 rec."""
    cfg = tconfigs.get_config("recurrentgemma-9b")
    kinds = rglru.layer_kinds(cfg)
    assert len(kinds) == 38 and kinds[:3] == ("rec", "rec", "attn")
    assert kinds[36:] == ("rec", "rec") and kinds.count("attn") == 12
    assert rglru.layout(cfg) == jrglru._layout(jconfigs.get_config(
        "recurrentgemma-9b"))
