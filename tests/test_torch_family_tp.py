"""The ssm, hybrid and encdec families over ranks (gloo ranks on the CPU,
`repro_torch.parallel.spawn`) against the JAX package's single-device
model on the same numpy weights, reduced configs in fp32.

* Reduced mamba2-130m (16 heads: split at tp 2 and 4), recurrentgemma-9b
  (LRU width 256 split by channels; one kv head, so its attention stays
  whole) and seamless-m4t-large-v2 (4 heads and 2 kv heads: attention
  split at tp 2, whole at tp 4; the untied head split by vocab columns)
  at tp 2 and 4: forward logits within 1e-5 of max |logit| of the
  reference's, prefill logits likewise, then 8 greedy decode steps with
  tokens identical to the reference's and logits within 1e-5 of max
  |logit|, and every step's gathered cluster ids identical to one
  rank's. The hybrid and encdec decode under two plans: the `jnp`
  backend with groups=2 (dividing tp 2, not tp 4: the cold path then
  runs whole on every rank) and the `pallas` backend with groups=4
  (dividing both; on the CPU `fused_cold_ffn` runs its plain version).
* The golden recipe of tests/test_distributed.py:75 for each family at
  dp=2 x tp=2 and dp=2 x tp=4: the loss within 1e-5 relative of the
  reference's `make_train_step` loss, every gathered gradient within
  1e-4 of its max |g|.
* mamba2's gated norm over a split d_inner alone: forward and gradients
  over ranks equal to one rank's, and the same test fails when the
  statistic's backward is made the identity.
* A rank's slice drawn from a seed equals, bit for bit, its part of the
  whole model drawn from that seed.
* The spawned ranks import neither jax nor the JAX package.

The reference's constant leaves (norms, biases, A_log, D, dt_bias, lam)
are moved off their init values so that every leaf reaches the output.
The rank functions import only the port; the JAX package is imported
inside the fixture, so a spawned rank never loads it.
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import gather_params, params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.core.clusters import make_plan
from repro_torch.data.pipeline import shard_batch
from repro_torch.models import ssm
from repro_torch.models.model import build_model, wrap
from repro_torch.parallel import (
    ShardGroup, grid, placements, places_under, replica_groups,
    shard_layout, spawn)
from repro_torch.train.steps import loss_and_grads
from test_torch_train_tp import _foreign, _leaves, sub_world

FAMILIES = ["mamba2-130m", "recurrentgemma-9b", "seamless-m4t-large-v2"]
TPS = [2, 4]
GRIDS = [(2, 2), (2, 4)]
N_DEC = 8
S_PROMPT = 32
# (backend, groups) of the decode plans of the families with an FFN
PLANS = [("jnp", 2), ("pallas", 4)]


def _cases(cfg):
    """The decode cases of cfg: (name, backend, groups); (dense, None,
    None) decodes without a plan."""
    if not cfg.d_ff:
        return [("dense", None, None)]
    return [(f"{b}-g{g}", b, g) for b, g in PLANS]


def _plan(cfg, backend, groups):
    if backend is None:
        return None
    s = cfg.sparse_ffn
    return make_plan(cfg.d_ff, s.hot_ratio, s.cold_active_ratio,
                     s.cluster_size, groups=groups, backend=backend)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _decode(model, batch, plan, forward=True):
    """Forward logits (with `forward`, else None), prefill logits, then
    N_DEC greedy steps: (forward, [prefill, step logits...], tokens
    (N_DEC, B), ids per step or None)."""
    m = model
    tb = _tensors(batch)
    fwd = None
    if forward:
        with torch.no_grad():
            fwd = m.forward(m.module, tb).numpy()
    logits, cache = m.prefill(m.module, tb, S_PROMPT + N_DEC)
    outs, toks, ids = [logits.numpy()], [], []
    for _ in range(N_DEC):
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok[:, 0].numpy())
        if m.cfg.family == "ssm":
            logits, cache = m.decode_step(m.module, tok, cache, plan)
        else:
            logits, cache, cidx = m.decode_step(m.module, tok, cache, plan,
                                                collect_indices=True)
            ids.append(None if cidx is None else cidx.numpy())
        outs.append(logits.numpy())
    return fwd, outs, np.stack(toks), ids or None


# ---------------------------------------------------------------- ranks ----

def _serve_cases(groups, arch, tree, batch):
    """Every decode case of `arch` on ranks [0, n), n in TPS."""
    out = {}
    cfg = tget_config(arch).reduced()
    for n, g in groups.items():
        if not g.member:
            continue
        for i, (name, backend, n_groups) in enumerate(_cases(cfg)):
            plan = _plan(cfg, backend, n_groups)
            model = wrap(params_from_numpy(tree, cfg, "cpu", shard=g,
                                           plan=plan), g)
            # the forward runs no plan: once per (family, n)
            out[n, name] = _decode(model, batch, plan, forward=i == 0)
    return out


def _norm_case(g, y, gn, c):
    """mamba2's gated norm on this rank's heads' columns of y: (its
    columns, out, d y, d gn) of the loss sum(out * c) summed over the
    ranks of g."""
    cfg = tget_config("mamba2-130m").reduced()
    if not g.member:
        return None
    n = g.size
    layout = shard_layout(cfg, None, g.rank, n)
    lp = ssm.SSMLayer(cfg, torch.float32, "cpu",
                      places_under(placements(cfg, layout), ("layers",)))
    lo, hi = lp.inner
    with torch.no_grad():
        lp.gn.copy_(torch.from_numpy(gn[lo:hi]))
    yr = torch.from_numpy(y[..., lo:hi]).requires_grad_()
    lp.gn.requires_grad_(True)
    with torch.enable_grad():
        out = ssm.gated_norm(lp, yr, cfg, g)
        loss = g.reduce_out((out * torch.from_numpy(c[..., lo:hi])).sum())
        dy, dgn = torch.autograd.grad(loss, [yr, lp.gn])
    return (lo, hi), out.detach().numpy(), dy.numpy(), dgn.numpy()


def _norm_cases(groups, y, gn, c):
    """The gated norm's cases at tp 2 and 4, with the statistic's own
    backward and with an identity backward in its place."""
    from repro_torch import parallel
    out = {}
    for n, g in groups.items():
        out[n, "own"] = _norm_case(g, y, gn, c)
    saved = parallel._ReduceStat.backward
    parallel._ReduceStat.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        for n, g in groups.items():
            out[n, "identity"] = _norm_case(g, y, gn, c)
    finally:
        parallel._ReduceStat.backward = saved
    return out


def _train_case(world, arch, tree, batch, dp, tp):
    """The loss and (on world rank 0) the gathered gradients of one step
    of `arch` from `tree` on the first dp*tp ranks."""
    rows, cols = grid(sub_world(world, dp * tp), dp, tp)
    if not rows.member:
        return None
    cfg = tget_config(arch).reduced()
    model = wrap(params_from_numpy(tree, cfg, "cpu", shard=rows), rows)
    b = shard_batch(batch, "cpu", cols.rank, dp)
    loss, grads = loss_and_grads(model, model.params(), b, cols)
    out = dict(loss=float(loss))
    g_tree = gather_params(model.module, rows, values=grads)
    if world.rank == 0:
        out["grads"] = g_tree.tree
    return out


def _whole_cases(arch, tree, batch):
    """Every decode case of `arch` on the whole model (one rank)."""
    cfg = tget_config(arch).reduced()
    model = wrap(params_from_numpy(tree, cfg, "cpu"))
    return {name: _decode(model, batch, _plan(cfg, backend, groups),
                          forward=False)
            for name, backend, groups in _cases(cfg)}


def _family_rank(world, trees, batches, train_batches, norm):
    out = {"foreign": _foreign()}
    # creating a group is collective: every rank of the world calls
    four = sub_world(world, 4)
    groups = {n: replica_groups(four, 4 // n, n)[0] for n in TPS}
    for i, arch in enumerate(FAMILIES):
        for k, v in _serve_cases(groups, arch, trees[arch],
                                 batches[arch]).items():
            out[(arch,) + k] = v
        if world.rank == 4 + i:        # ranks past the groups: one rank
            out[arch, "whole"] = _whole_cases(arch, trees[arch],
                                              batches[arch])
        for dp, tp in GRIDS:
            out[arch, "train", dp, tp] = _train_case(
                world, arch, trees[arch], train_batches[arch], dp, tp)
    out["norm"] = _norm_cases(groups, *norm)
    return out


# -------------------------------------------------------------- fixture ----

def _tree(arch):
    """The reference's init from jax key 0, perturbed, as numpy."""
    import jax
    from repro.configs import get_config
    from repro.models.model import build_model as jbuild_model
    from test_torch_families import _perturbed
    return _perturbed(jbuild_model(get_config(arch).reduced())
                      .init(jax.random.key(0)))


def _reference(arch, tree, batch, train_batch):
    """The reference on one device from `tree`: forward logits, prefill
    and greedy decode logits and tokens per case, and the train step's
    loss and gradients."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.clusters import make_plan as jmake_plan
    from repro.models.model import build_model as jbuild_model
    from repro.train.steps import make_loss_fn
    cfg = get_config(arch).reduced()
    jm = jbuild_model(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"forward": np.asarray(
        jax.jit(lambda p, b: jm.forward(p, b))(params, jb))}
    s = cfg.sparse_ffn
    prefill = jax.jit(lambda p, b: jm.prefill(p, b,
                                              max_len=S_PROMPT + N_DEC))
    for name, backend, groups in _cases(cfg):
        # the reference's jnp and pallas backends pick the same tokens
        plan = None if backend is None else jmake_plan(
            cfg.d_ff, s.hot_ratio, s.cold_active_ratio, s.cluster_size,
            groups=groups, backend="jnp")
        step = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, plan))
        logits, cache = prefill(params, jb)
        outs, toks = [np.asarray(logits)], []
        for _ in range(N_DEC):
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            toks.append(np.asarray(tok)[:, 0])
            logits, cache = step(params, tok, cache)
            outs.append(np.asarray(logits))
        out[name] = (outs, np.stack(toks))
    loss_fn = make_loss_fn(jm)
    tb = {k: jnp.asarray(v) for k, v in train_batch.items()}
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params, tb)
    out["loss"] = float(loss)
    out["grads"] = _leaves(jax.tree.map(np.asarray, g))
    return out


@pytest.fixture(scope="module")
def runs():
    """The ranks run while the reference computes (the ranks need only
    its weights)."""
    import threading
    from conftest import tiny_batch
    from repro.configs import get_config
    batches, train_batches, trees = {}, {}, {}
    for arch in FAMILIES:
        cfg = get_config(arch).reduced()
        batches[arch] = tiny_batch(cfg, 2, S_PROMPT, seed=1)
        train_batches[arch] = tiny_batch(cfg, 4, 32, seed=0,
                                         with_labels=True)
        trees[arch] = _tree(arch)
    rng = np.random.default_rng(5)
    di = tget_config("mamba2-130m").reduced().ssm_d_inner
    norm = (rng.standard_normal((2, 3, di)).astype(np.float32),
            (rng.standard_normal(di) * 0.1).astype(np.float32),
            rng.standard_normal((2, 3, di)).astype(np.float32))
    box = {}

    def ranks():
        try:
            box["ranks"] = spawn(_family_rank, 8, trees, batches,
                                 train_batches, norm, timeout=600)
        except Exception as e:          # re-raised below, in the test
            box["error"] = e
    thread = threading.Thread(target=ranks)
    thread.start()
    refs = {arch: _reference(arch, trees[arch], batches[arch],
                             train_batches[arch]) for arch in FAMILIES}
    thread.join()
    if "error" in box:
        raise box["error"]
    whole = {(arch, name): v for r in box["ranks"] for arch in FAMILIES
             for name, v in r.get((arch, "whole"), {}).items()}
    return dict(refs=refs, ranks=box["ranks"], whole=whole, norm=norm)


def _serve_runs(runs, arch, n, name):
    got = [r[arch, n, name] for r in runs["ranks"]
           if (arch, n, name) in r]
    assert len(got) == n
    return got


def _close_to_scale(got, want, tol):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


# ---------------------------------------------------------------- holds ----

SERVE = [(a, n, name) for a in FAMILIES for n in TPS
         for name, _, _ in _cases(tget_config(a).reduced())]


@pytest.mark.parametrize("arch,n,name", SERVE,
                         ids=[f"{a}-tp{n}-{c}" for a, n, c in SERVE])
def test_family_decode_over_ranks_matches_reference(runs, arch, n, name):
    """Forward (once per family and n), prefill and every decode step's
    logits within 1e-5 of max |logit| of the reference's, the greedy
    tokens identical, on every rank."""
    ref = runs["refs"][arch]
    want_outs, want_toks = ref[name]
    first = name == _cases(tget_config(arch).reduced())[0][0]
    for fwd, outs, toks, _ in _serve_runs(runs, arch, n, name):
        assert (fwd is not None) == first
        if first:
            _close_to_scale(fwd, ref["forward"], 1e-5)
        np.testing.assert_array_equal(toks, want_toks)
        for got, want in zip(outs, want_outs):
            _close_to_scale(got, want, 1e-5)


@pytest.mark.parametrize("arch,n,name", [s for s in SERVE if s[2] != "dense"],
                         ids=[f"{a}-tp{n}-{c}" for a, n, c in SERVE
                              if c != "dense"])
def test_family_gathered_ids_match_one_rank(runs, arch, n, name):
    """Every decode step's cluster ids, gathered over the ranks, equal
    one rank's (the port's whole model on the same weights)."""
    want = runs["whole"][arch, name][3]
    assert want is not None and all(w is not None for w in want)
    for *_, ids in _serve_runs(runs, arch, n, name):
        assert len(ids) == N_DEC
        for got, w in zip(ids, want):
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_on_one_rank_matches_reference(runs, arch):
    """The port's whole model on the same weights: the tokens the ranks
    are held to."""
    ref = runs["refs"][arch]
    for name, _, _ in _cases(tget_config(arch).reduced()):
        _, outs, toks, _ = runs["whole"][arch, name]
        np.testing.assert_array_equal(toks, ref[name][1])


TRAIN = [(a, dp, tp) for a in FAMILIES for dp, tp in GRIDS]


@pytest.mark.parametrize("arch,dp,tp", TRAIN,
                         ids=[f"{a}-dp{d}tp{t}" for a, d, t in TRAIN])
def test_family_golden_sharded_train_step(runs, arch, dp, tp):
    """The golden recipe: the loss within 1e-5 relative of the
    reference's on every rank, every gathered gradient leaf within 1e-4
    of its max |g|."""
    ref = runs["refs"][arch]
    members = [r[arch, "train", dp, tp] for r in runs["ranks"]
               if r[arch, "train", dp, tp] is not None]
    assert len(members) == dp * tp
    for r in members:
        assert r["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    got = _leaves(members[0]["grads"])
    assert set(got) == set(ref["grads"])
    for keys, g in ref["grads"].items():
        assert got[keys].shape == g.shape, keys
        err = float(np.abs(got[keys] - g).max())
        assert err <= 1e-4 * max(float(np.abs(g).max()), 1e-30), keys


def _norm_one_rank(y, gn, c):
    cfg = tget_config("mamba2-130m").reduced()
    lp = ssm.SSMLayer(cfg, torch.float32, "cpu")
    with torch.no_grad():
        lp.gn.copy_(torch.from_numpy(gn))
    yt = torch.from_numpy(y).requires_grad_()
    lp.gn.requires_grad_(True)
    with torch.enable_grad():
        out = ssm.gated_norm(lp, yt, cfg)
        dy, dgn = torch.autograd.grad((out * torch.from_numpy(c)).sum(),
                                      [yt, lp.gn])
    return out.detach().numpy(), dy.numpy(), dgn.numpy()


def _norm_holds(runs, n, kind):
    """Whether every rank's gated norm and its gradients equal one
    rank's (the out always must)."""
    want_out, want_dy, want_dgn = _norm_one_rank(*runs["norm"])
    cases = [r["norm"][n, kind] for r in runs["ranks"]
             if r["norm"][n, kind] is not None]
    assert len(cases) == n
    same = True
    for (lo, hi), out, dy, dgn in cases:
        np.testing.assert_allclose(out, want_out[..., lo:hi], rtol=1e-6,
                                   atol=1e-6)
        same &= np.allclose(dy, want_dy[..., lo:hi], rtol=1e-5, atol=1e-6)
        same &= np.allclose(dgn, want_dgn[lo:hi], rtol=1e-5, atol=1e-6)
    return same


@pytest.mark.parametrize("n", TPS)
def test_split_gated_norm_matches_one_rank(runs, n):
    """mamba2's gated norm over ranks: its output and its gradients of y
    and gn equal one rank's; with the statistic's backward made the
    identity the gradients differ, so this test sees that fault."""
    assert _norm_holds(runs, n, "own")
    assert not _norm_holds(runs, n, "identity")


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("n", TPS)
def test_family_slice_drawn_from_seed_is_the_whole_models(arch, n):
    """A rank's model built at its training layout from a seed holds, bit
    for bit, its part of the whole model built from that seed."""
    from repro_torch.bridge import model_tree, shard_params
    cfg = tget_config(arch).reduced()
    whole = build_model(cfg, "cpu", seed=3).module
    for r in range(n):
        g = ShardGroup(r, n, None, torch.device("cpu"), tuple(range(n)))
        want = _leaves(shard_params(model_tree(whole), cfg, None, r, n))
        model = build_model(cfg, "cpu", seed=3, shard=g)
        got = _leaves(model_tree(model.module))
        assert set(got) == set(want)
        assert model.split_params()
        for keys, w in want.items():
            for a, b in (zip(got[keys], w) if isinstance(w, list)
                         else [(got[keys], w)]):
                assert torch.equal(a, b), (arch, n, r, keys)


def test_spawned_family_ranks_import_no_jax(runs):
    assert all(r["foreign"] == [] for r in runs["ranks"])
