"""The training path of the port (`repro_torch.optim.adamw`,
`train.steps`, `models.model`, `launch.train`) against the JAX package,
on the same numpy weights and batches, reduced configs in fp32 unless
marked, on the CPU.

* AdamW: the reference's three substrate tests (a quadratic falls below
  1e-2, bf16 moments keep their dtype, a 1e9 gradient leaves the
  parameters finite); one update on the same numpy params and grads as
  the reference's, in fp32, in bf16 and with bf16 moments (fp32 within
  a few ulps of the update's operands, bf16 within one bf16 ulp: the
  global norm sums in another order, so the clip scale may differ in
  its last bit); a leaf
  whose gradient is None decays bit for bit as the reference's
  zero-gradient leaf.
* `lm_loss` within 1e-6 relative (0 on an all-masked batch) and
  `make_loss_fn`'s vlm label padding.
* One train step of every config of ASSIGNED_ARCHS (the dense, vlm, moe,
  ssm, hybrid and encdec families) plus bamboo-7b and
  turbosparse-mixtral-47b: the loss within 1e-5
  relative; every gradient leaf within 2e-5 of the leaf's max |g|;
  AdamW's m within 2e-5 and v within 1e-4 of their leaf's max; every
  parameter within 8 fp32 ulps of |p_old| + |p_new| plus lr times the
  most its step-1 Adam direction g'/(|g'| + eps) moves while the clipped
  gradient g' moves by the element's measured difference. Each
  package's g' is read back from its own first moment (m = (1 - b1) g'
  after step 1), so the clip scale each computed in fp32 and its
  rounding of g' are measured, not modelled. That term stays below
  1e-3 * lr except at the elements whose |g'| sits within that rounding
  of zero (or of eps): they are counted (under 0.1%) and held to 2 * lr.
* The padded-vocab logits mask under autograd, in fp32 and bf16; the
  moe dispatch's tied gates and dropped entries under autograd.
* Ten steps on the synthetic corpus track the reference's losses within
  1e-5 relative; remat gives bit-identical gradients in the vlm, ssm,
  hybrid and encdec families; `train()` meets the reference's 0.8x bar;
  `add_modal_inputs` draws the encdec frames and the vlm patches as the
  reference does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_batch
from repro import configs as jconfigs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild_model
from repro.optim.adamw import AdamW as JAdamW
from repro.train.steps import lm_loss as jlm_loss
from repro.train.steps import make_loss_fn as jmake_loss_fn
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, shard_batch
from repro_torch.launch.train import train
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model, wrap
from repro_torch.optim.adamw import AdamW
from repro_torch.train.steps import (
    lm_loss, loss_and_grads, make_loss_fn, make_train_step)

TRAIN_ARCHS = ["nemotron-4-15b", "llama3-405b", "grok-1-314b", "smollm-135m",
               "qwen2-vl-2b", "qwen3-14b", "deepseek-moe-16b", "bamboo-7b",
               "turbosparse-mixtral-47b", "mamba2-130m", "recurrentgemma-9b",
               "seamless-m4t-large-v2"]
LR = 1e-3


def _leaves(tree):
    """[(key path, numpy leaf)] in jax's order; bf16 as uint16 bits."""
    out = []
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        out.append((tuple(k.key for k in path), a))
    return out


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _bf16(bits):
    """uint16 bits -> fp32 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


# ------------------------------------------------------------- AdamW ----

def test_adamw_reduces_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(100):
        params, state = opt.update({"w": 2.0 * params["w"]}, state, params)
    assert float(params["w"].square().sum()) < 1e-2


def test_adamw_bf16_moments_dtype():
    opt = AdamW(moment_dtype="bfloat16")
    params = {"w": torch.zeros((4, 4))}
    st = opt.init(params)
    assert st["m"]["w"].dtype == torch.bfloat16
    p2, st2 = opt.update({"w": torch.ones((4, 4))}, st, params)
    assert st2["m"]["w"].dtype == torch.bfloat16
    assert p2["w"].dtype == params["w"].dtype
    assert st2["step"].dtype == torch.int32 and int(st2["step"]) == 1


def test_grad_clip_bounds_update():
    opt = AdamW(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros((2,))}
    p2, _ = opt.update({"w": torch.tensor([1e9, -1e9])}, opt.init(params),
                       params)
    assert bool(torch.isfinite(p2["w"]).all())


def _update_case(dtype, moment_dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (64, 32), "b": (7,), "c": (3, 5, 4)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-9, 0, s)
             ).astype(np.float32) for k, s in shapes.items()}
    jdt = jnp.dtype(dtype)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p.items()}
    jg = {k: jnp.asarray(v).astype(jdt) for k, v in g.items()}
    tdt = getattr(torch, dtype)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}
    tg = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
    return jp, jg, tp, tg


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


@pytest.mark.parametrize("dtype,moment_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("float32", "bfloat16")])
def test_adamw_update_matches_reference(dtype, moment_dtype):
    """One update from the same params, grads and state (random moments
    at step 3, so the bias corrections are exercised): fp32 within a few
    ulps of the update's operands (8 of |p_old| + |p_new| for a
    parameter, the sum of five roundings and a pow; 4 of |m_old| + |g|
    and |v_old| + g^2 for the moments), bf16 parameters and moments
    within one bf16 ulp."""
    jp, jg, tp, tg = _update_case(dtype, moment_dtype)
    rng = np.random.default_rng(2)
    mdt = getattr(torch, moment_dtype)
    state = {n: {k: np.abs(rng.standard_normal(v.shape)).astype(np.float32)
                 * 10.0 ** rng.integers(-12, -2, v.shape).astype(np.float32)
                 for k, v in tp.items()} for n in ("m", "v")}
    state["m"] = {k: v * rng.choice([-1, 1], v.shape).astype(np.float32)
                  for k, v in state["m"].items()}
    js = {n: {k: jnp.asarray(v).astype(jnp.dtype(moment_dtype))
              for k, v in state[n].items()} for n in ("m", "v")}
    ts = {n: {k: torch.from_numpy(v).to(mdt) for k, v in state[n].items()}
          for n in ("m", "v")}
    js["step"] = jnp.asarray(3, jnp.int32)
    ts["step"] = torch.tensor(3, dtype=torch.int32)
    lr = 1e-2
    jopt = JAdamW(lr=lr, moment_dtype=moment_dtype)
    topt = AdamW(lr=lr, moment_dtype=moment_dtype)
    before = {"p": jp, "m": js["m"], "v": js["v"]}
    jp, js = jopt.update(jg, js, jp)
    tp, ts = topt.update(tg, ts, tp)
    assert int(ts["step"]) == int(js["step"]) == 4
    for name, got, want in (("p", tp, jp), ("m", ts["m"], js["m"]),
                            ("v", ts["v"], js["v"])):
        for k in want:
            a, b = _np(got[k]), np.asarray(want[k])
            if b.dtype.name == "bfloat16":
                d = np.abs(a.astype(np.int32) - b.view(np.uint16))
                assert d.max() <= 1, (name, k)     # one bf16 ulp
                continue
            assert a.dtype == b.dtype
            g = np.abs(np.asarray(jg[k], np.float32))
            old = np.abs(np.asarray(before[name][k], np.float32))
            scale, n_ulp = {"p": (old + np.abs(b), 8), "m": (old + g, 4),
                            "v": (old + g * g, 4)}[name]
            np.testing.assert_array_less(np.abs(a - b),
                                         n_ulp * np.spacing(scale) + 1e-38,
                                         err_msg=f"{name} {k}")


def test_none_grad_decays_as_reference_zero_grad():
    """A leaf with no gradient (the predictor at plan=None) decays as the
    reference's zero gradient: bit for bit, also its moments."""
    jp, jg, tp, tg = _update_case("float32", "float32", seed=1)
    jg["b"] = jnp.zeros_like(jg["b"])
    tg["b"] = None
    jopt, topt = JAdamW(lr=1e-2), AdamW(lr=1e-2)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        jp, js = jopt.update(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
    np.testing.assert_array_equal(tp["b"].numpy(), np.asarray(jp["b"]))
    np.testing.assert_array_equal(ts["v"]["b"].numpy(), 0.0)
    assert not np.array_equal(tp["b"].numpy(), _update_case(
        "float32", "float32", seed=1)[2]["b"].numpy())     # it decayed


# ------------------------------------------------------------ the loss ----

@pytest.mark.parametrize("masked", ["none", "some", "all"])
def test_lm_loss_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    if masked == "some":
        labels[0, :3] = -1
    elif masked == "all":
        labels[:] = -1
    want = float(jlm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(lm_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    if masked == "all":
        assert got == 0.0


def test_make_loss_fn_pads_vlm_labels(monkeypatch):
    """Labels shorter than the logits are padded with -1 at the front,
    so only the text positions count (the reference's vlm rule)."""
    import repro_torch.train.steps as steps
    seen = {}

    def spy(logits, labels):
        seen["labels"] = labels
        return lm_loss(logits, labels)
    monkeypatch.setattr(steps, "lm_loss", spy)
    model = steps.Model(module=None,
                        forward=lambda module, batch: torch.zeros((2, 7, 4)),
                        prefill=None, decode_step=None)
    make_loss_fn(model)({"labels": torch.tensor([[1, 2, 3]] * 2)})
    assert seen["labels"].tolist() == [[-1, -1, -1, -1, 1, 2, 3]] * 2


# ------------------------------------------------- one step per family ----

class Step:
    """One train step of a reduced config, the reference's and the
    port's, from the same numpy weights and batch."""

    def __init__(self, arch, cfg_fn=lambda c: c, lr=LR):
        self.jcfg = cfg_fn(jconfigs.get_config(arch).reduced())
        self.tcfg = cfg_fn(tconfigs.get_config(arch).reduced())
        jm = jbuild_model(self.jcfg)
        params = jm.init(jax.random.key(0))
        self.batch = tiny_batch(self.jcfg, 2, 32, with_labels=True)
        opt = JAdamW(lr=lr)
        loss_fn = jmake_loss_fn(jm)

        def ref(p, s, b):
            # make_train_step's body, returning the gradient too
            loss, g = jax.value_and_grad(loss_fn)(p, b)
            p2, s2 = opt.update(g, s, p)
            return loss, g, p2, s2
        self.p0 = _leaves(params)
        out = jax.jit(ref)(params, opt.init(params), self.batch)
        self.jloss = float(out[0])
        self.jg, self.jp, self.jm, self.jv = (
            _leaves(out[1]), _leaves(out[2]), _leaves(out[3]["m"]),
            _leaves(out[3]["v"]))
        tree = jax.tree.map(np.asarray, params)
        self.model = wrap(params_from_numpy(tree, self.tcfg, device="cpu"))
        tb = {k: torch.from_numpy(v) for k, v in self.batch.items()}
        w = self.model.params()
        loss, grads = loss_and_grads(self.model, w, tb)
        self.tg = params_to_numpy(self.model.module, grads)
        topt = AdamW(lr=lr)
        state = topt.init(w)
        w, state, m = make_train_step(self.model, topt)(w, state, tb)
        self.tloss, self.step_loss = float(loss), float(m["loss"])
        self.tp = params_to_numpy(self.model.module)
        self.tm = params_to_numpy(self.model.module, state["m"]).tree
        self.tv = params_to_numpy(self.model.module, state["v"]).tree
        self.lr = lr


def _adam_sensitivity(g, dg, eps=1e-8):
    """The most step 1's Adam direction f(g) = g/(|g| + eps) moves while
    the clipped gradient g moves by up to dg (elementwise): the
    parameter moves lr times this."""
    f = lambda x: x / (np.abs(x) + eps)
    return np.maximum(np.abs(f(g + dg) - f(g)), np.abs(f(g - dg) - f(g)))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_reference(arch):
    s = Step(arch)
    assert s.tloss == s.step_loss
    assert s.tloss == pytest.approx(s.jloss, rel=1e-5)
    worst = 0.0
    for keys, g in s.jg:
        got = _at(s.tg.tree, keys)
        assert got.shape == g.shape, keys
        gmax = max(float(np.abs(g).max()), 1e-30)
        err = float(np.abs(got - g).max())
        worst = max(worst, err / gmax)
        assert err <= 2e-5 * gmax, (keys, err / gmax)
    # each package's clipped gradient g' as it applied it, from its first
    # moment m = (1 - b1) * g' (fp32 constant, m = 0 before step 1)
    c = float(np.float32(1 - JAdamW().b1))
    flagged = total = 0
    for (keys, p0), (_, p1), (_, m), (_, v) in zip(s.p0, s.jp, s.jm, s.jv):
        dg = np.abs(_at(s.tm, keys) - m).astype(np.float64) / c
        sens = _adam_sensitivity(m.astype(np.float64) / c, dg)
        ulps = 8 * np.spacing(np.abs(p0) + np.abs(p1)) + 1e-38
        near = sens > 1e-3             # |g'| within rounding of zero
        got = _at(s.tp.tree, keys)
        diff = np.abs(got - p1)
        np.testing.assert_array_less(diff, s.lr * sens + ulps,
                                     err_msg=str(keys))
        assert (diff[~near] < 1e-3 * s.lr + ulps[~near]).all(), keys
        assert (diff[near] < 2 * s.lr + ulps[near]).all(), keys
        flagged += int(near.sum())
        total += m.size
        for want, mine, rel in ((m, s.tm, 2e-5), (v, s.tv, 1e-4)):
            err = np.abs(_at(mine, keys) - want).max()
            assert err <= rel * max(np.abs(want).max(), 1e-30), keys
    print(f"{arch}: loss {s.tloss:.6f} vs {s.jloss:.6f}; worst gradient "
          f"{worst:.2e} of its leaf's max; {flagged} of {total} elements "
          f"within rounding of zero")
    assert flagged < total // 1000


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_vocab_mask_under_autograd(dtype):
    """vocab 300 padded to 512: lm_logits writes -1e30 into the padding
    columns in place; the loss and gradients stay the reference's (the
    padding gets no probability, its head rows only weight decay)."""
    def cfg_fn(c):
        return c.replace(vocab_size=300, param_dtype=dtype,
                         compute_dtype=dtype)
    s = Step("smollm-135m", cfg_fn)
    assert s.tcfg.vocab_padded == 512
    rel = 1e-5 if dtype == "float32" else 1e-2
    assert s.tloss == pytest.approx(s.jloss, rel=rel)
    g_embed = dict(s.jg)[("embed",)]
    got = _at(s.tg.tree, ("embed",))
    if dtype == "bfloat16":
        got, g_embed = _bf16(got), _bf16(g_embed)
    assert (got[300:] == 0).all() and (g_embed[300:] == 0).all()
    tol = 2e-5 if dtype == "float32" else 5e-2
    assert np.abs(got - g_embed).max() <= tol * np.abs(g_embed).max()


def _moe_ffn(cfg, seed):
    """A reduced moe layer's FFN weights as numpy, all gates tied (zero
    router) so top-k ties and capacity drops decide the dispatch."""
    rng = np.random.default_rng(seed)
    E, f, D = cfg.num_experts, cfg.d_ff, cfg.d_model
    p = {"router": np.zeros((D, E), np.float32),
         "experts": (rng.standard_normal((E, f, 3, D)) * 0.05
                     ).astype(np.float32),
         "shared": {"w": (rng.standard_normal((f, 3, D)) * 0.05
                          ).astype(np.float32)}}
    return p


def test_moe_ties_and_drops_under_autograd():
    """Tied gates take the lowest expert ids and entries past capacity
    are dropped (0 * x into slot 0) with grad enabled: y and the
    gradients of x, the router, the experts and the shared expert within
    2e-5 of the reference's jax.grad; x rows whose every entry was
    dropped get only the shared expert's gradient."""
    jcfg = jconfigs.get_config("deepseek-moe-16b").reduced()
    tcfg = tconfigs.get_config("deepseek-moe-16b").reduced()
    p = _moe_ffn(jcfg, 0)
    rng = np.random.default_rng(1)
    T = 48
    x = (rng.standard_normal((T, jcfg.d_model))).astype(np.float32)
    ct = rng.standard_normal((T, jcfg.d_model)).astype(np.float32)

    def jloss(params, x):
        y, _ = jmoe.apply_moe_ffn(params, x, jcfg)
        return (y * ct).sum()
    jp = jax.tree.map(jnp.asarray, p)
    jval, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    moe = tmoe.MoEFFN(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        moe.router.copy_(torch.from_numpy(p["router"]))
        moe.experts.copy_(torch.from_numpy(p["experts"]))
        moe.shared.copy_(torch.from_numpy(p["shared"]["w"]))
    moe.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = tmoe.apply_moe_ffn(moe, tx, tcfg)
    val = (y * torch.from_numpy(ct)).sum()
    grads = torch.autograd.grad(val, [tx, moe.router, moe.experts,
                                      moe.shared])
    assert float(val.detach()) == pytest.approx(float(jval), rel=1e-5)
    want = [jgx, jgp["router"], jgp["experts"], jgp["shared"]["w"]]
    for got, w in zip(grads, want):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= 2e-5 * np.abs(w).max()
    tope, _, _, keep = tmoe.moe_dispatch(
        torch.full((T, 4), 0.25), tcfg.experts_per_token,
        tmoe._capacity(T, tcfg.experts_per_token, 4,
                       tcfg.moe_capacity_factor))
    assert (tope == torch.tensor([0, 1], dtype=torch.int32)).all()
    dropped = ~keep.any(dim=1)
    assert 0 < int(dropped.sum()) < T
    # a fully dropped row's gradient is the shared expert's alone
    xs = torch.from_numpy(x[dropped.numpy()]).requires_grad_(True)
    from repro_torch.core.sparse_ffn import ffn_dense
    ys = ffn_dense(moe.shared, xs, tcfg.activation)
    gs, = torch.autograd.grad((ys * torch.from_numpy(
        ct[dropped.numpy()])).sum(), xs)
    np.testing.assert_allclose(grads[0][dropped].numpy(), gs.numpy(),
                               rtol=1e-5, atol=1e-6)


# -------------------------------------------------- trajectory, remat ----

def test_loss_trajectory_tracks_reference():
    """Ten steps of reduced smollm-135m on SyntheticTokens seed 0 (lr
    2e-3, batch 4, seq 32) from the same numpy weights: every loss within
    1e-5 relative of the reference's."""
    jcfg = jconfigs.get_config("smollm-135m").reduced()
    tcfg = tconfigs.get_config("smollm-135m").reduced()
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.key(0))
    model = wrap(params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                   device="cpu"))
    opt, topt = JAdamW(lr=2e-3), AdamW(lr=2e-3)
    step = jax.jit(jmake_train_step(jm, opt))
    tstep = make_train_step(model, topt)
    st, w = opt.init(params), model.params()
    tst = topt.init(w)
    jdata = JSyntheticTokens(JDataConfig(jcfg.vocab_size, 32, 4, seed=0))
    tdata = SyntheticTokens(DataConfig(tcfg.vocab_size, 32, 4, seed=0))
    jl, tl = [], []
    for _ in range(10):
        jb, tb = jdata.batch(), tdata.batch()
        np.testing.assert_array_equal(jb["tokens"], tb["tokens"])
        params, st, m = step(params, st, jb)
        w, tst, mm = tstep(w, tst, shard_batch(tb, "cpu"))
        jl.append(float(m["loss"]))
        tl.append(float(mm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "mamba2-130m",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_remat_gives_identical_gradients(arch):
    """cfg.remat recomputes each layer in the backward pass
    (torch.utils.checkpoint): the same gradients, bit for bit."""
    cfg = tconfigs.get_config(arch).reduced()
    batch = {k: torch.from_numpy(v) for k, v in
             tiny_batch(cfg, 2, 16, with_labels=True).items()}
    out = []
    for remat in (False, True):
        model = build_model(cfg.replace(remat=remat), device="cpu", seed=3)
        loss, grads = loss_and_grads(model, model.params(), batch)
        out.append((loss, grads))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        if g0[k] is None:
            assert g1[k] is None, k
        else:
            assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "qwen2-vl-2b",
                                  "smollm-135m"])
def test_modal_inputs_match_reference(arch):
    """The stub frontends' inputs from the same numpy Generator: the same
    keys and the same bits as the reference's `add_modal_inputs`."""
    from repro.launch.train import add_modal_inputs as jadd
    from repro_torch.launch.train import add_modal_inputs
    cfg = tconfigs.get_config(arch).reduced()
    base = {"tokens": np.zeros((3, 8), np.int32)}
    want = jadd(dict(base), jconfigs.get_config(arch).reduced(),
                np.random.default_rng(5))
    got = add_modal_inputs(dict(base), cfg, np.random.default_rng(5))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_train_meets_reference_bar():
    """The reference's test_train_loss_decreases on the port."""
    model, losses = train("smollm-135m", steps=30, batch_size=4, seq_len=32,
                          reduced=True, lr=2e-3, log_every=0, device="cpu")
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    assert not any(p.requires_grad for p in model.module.parameters())


def test_train_takes_reference_weights():
    """train(params=...) starts from a numpy tree: its first loss is the
    reference's first loss from the same weights."""
    jcfg = jconfigs.get_config("deepseek-moe-16b").reduced()
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.key(4))
    _, jloss = jax.jit(jmake_train_step(jm, JAdamW(lr=2e-3)))(
        params, JAdamW(lr=2e-3).init(params),
        JSyntheticTokens(JDataConfig(jcfg.vocab_size, 16, 2, seed=4)).batch()
    )[::2]
    _, losses = train("deepseek-moe-16b", steps=1, batch_size=2, seq_len=16,
                      lr=2e-3, log_every=0, seed=4, device="cpu",
                      params=jax.tree.map(np.asarray, params))
    assert losses[0] == pytest.approx(float(jloss["loss"]), rel=1e-5)


def test_build_model_dispatches_families():
    from repro_torch.models.dense import DenseModel
    from repro_torch.models.moe import MoEModel
    for arch, kind in (("smollm-135m", DenseModel), ("qwen2-vl-2b",
                       DenseModel), ("deepseek-moe-16b", MoEModel)):
        cfg = tconfigs.get_config(arch).reduced()
        m = build_model(cfg, device="cpu", seed=0)
        assert type(m.module) is kind and m.cfg is cfg
        assert not any(p.requires_grad for p in m.module.parameters())
    assert dataclasses.is_dataclass(m)
