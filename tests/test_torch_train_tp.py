"""Training of the port over ranks (dp x tp, gloo ranks on the CPU,
`repro_torch.parallel.spawn`) against the JAX package's single-device
train step: the reference's golden tests/test_distributed.py:75 on the
port.

* Golden :75: reduced smollm-135m (weights from jax key 0) and a (4, 32)
  numpy batch from seed 0, at dp=2 x tp=2 and dp=2 x tp=4 (at this
  width tp=2 splits attention and tp=4 replicates it; the FFN bundle and
  the vocab split at both): the loss within 1e-5 relative of the
  reference's `make_train_step`'s (the golden allows 1e-3), every
  gradient leaf, gathered, within 1e-4 of its max |g|, and the
  parameters after one AdamW step under test_torch_train.py's hold;
  every rank reports the same loss; the sharded clip scale equals the
  single-device one.
* With cfg.remat the backward repeats the layers' forward collectives:
  the same loss and gradients, and the extra collectives counted.
* `launch.train.train(tp=2, dp=2)`: a 5-step loss curve equal to one
  rank's within 1e-5, and the gathered whole model equal to one rank's.
* Reduced qwen2-vl-2b at dp=2 x tp=2 with label masks that differ
  between the replicas: the reference's global mean and gradients.
* A rank's slice drawn leaf by leaf from a seed is, bit for bit, its
  part of the whole model drawn from that seed (dense, vlm, ep and tp
  moe).

The rank function imports only the port (the JAX package is imported
inside the fixtures), so a spawned rank never loads it.
"""
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import gather_params, params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.data.pipeline import shard_batch
from repro_torch.models.model import wrap
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import ShardGroup, grid, spawn
from repro_torch.train.steps import loss_and_grads, make_train_step

LR = 1e-3
GRIDS = [(2, 2), (2, 4)]


def _foreign() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def _leaves(tree, keys=()):
    """{key path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, keys + (k,)))
        else:
            out[keys + (k,)] = v
    return out


# ---------------------------------------------------------------- ranks ----

def sub_world(world, k):
    """The first k ranks of `world` as a world of their own. Every rank
    of `world` calls, since creating a group is collective; the others
    get it with rank None."""
    if k == world.size:
        return world
    ranks = tuple(world.ranks[:k])
    pg = torch.distributed.new_group(list(ranks), backend="gloo")
    me = world.ranks[world.rank]
    return ShardGroup(ranks.index(me) if me in ranks else None, k, pg,
                      world.device, ranks)


def _step_case(world, arch, tree, batch, dp, tp, remat=False):
    """One train step of `arch` from `tree` on the first dp*tp ranks:
    this rank's loss, clip scale and collective counts, and (on world
    rank 0) the gathered gradients, parameters and first moments."""
    rows, cols = grid(sub_world(world, dp * tp), dp, tp)
    if not rows.member:
        return None
    cfg = tget_config(arch).reduced().replace(remat=remat)
    model = wrap(params_from_numpy(tree, cfg, "cpu", shard=rows), rows)
    b = shard_batch(batch, "cpu", cols.rank, dp)
    w = model.params()
    calls = rows.calls + cols.calls
    loss, grads = loss_and_grads(model, w, b, cols)
    calls = rows.calls + cols.calls - calls
    opt = AdamW(lr=LR)
    split = model.split_params()
    scale = float(opt.clip_scale({k: torch.zeros_like(p) if grads[k] is None
                                  else grads[k] for k, p in w.items()},
                                 rows, split))
    g_tree = gather_params(model.module, rows, values=grads)
    state = opt.init(w)
    w, state, m = make_train_step(model, opt, data=cols)(w, state, b)
    out = dict(loss=float(loss), step_loss=float(m["loss"]), scale=scale,
               calls=calls, split=sorted(split))
    p_tree = gather_params(model.module, rows)
    m_tree = gather_params(model.module, rows, values=state["m"])
    if world.rank == 0:
        out.update(grads=g_tree.tree, params=p_tree.tree, m=m_tree.tree)
    return out


def _train_rank(world, trees, batches):
    out = {"foreign": _foreign()}
    for dp, tp in GRIDS:
        out["smollm", dp, tp] = _step_case(world, "smollm-135m",
                                           trees["smollm"],
                                           batches["smollm"], dp, tp)
    out["remat"] = _step_case(world, "smollm-135m", trees["smollm"],
                              batches["smollm"], 2, 2, remat=True)
    out["vlm"] = _step_case(world, "qwen2-vl-2b", trees["vlm"],
                            batches["vlm"], 2, 2)
    return out


# -------------------------------------------------------------- fixture ----

def _reference(arch, batch):
    """The reference's single-device step from jax key 0: (numpy tree,
    loss, gradients, parameters, m, v after one AdamW step, the clip
    scale), leaves as {path: array}."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models.model import build_model
    from repro.optim.adamw import AdamW as JAdamW
    from repro.train.steps import make_loss_fn
    cfg = get_config(arch).reduced()
    jm = build_model(cfg)
    params = jm.init(jax.random.key(0))
    opt = JAdamW(lr=LR)
    loss_fn = make_loss_fn(jm)

    def ref(p, s, b):
        loss, g = jax.value_and_grad(loss_fn)(p, b)
        gn = jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                          for x in jax.tree.leaves(g)))
        p2, s2 = opt.update(g, s, p)
        return loss, g, p2, s2, jnp.minimum(1.0, opt.grad_clip / (gn + 1e-9))
    loss, g, p2, s2, scale = jax.jit(ref)(params, opt.init(params), batch)
    np_tree = jax.tree.map(np.asarray, params)
    leaves = lambda t: _leaves(jax.tree.map(np.asarray, t))
    return dict(tree=np_tree, p0=_leaves(np_tree), loss=float(loss),
                grads=leaves(g), params=leaves(p2), m=leaves(s2["m"]),
                v=leaves(s2["v"]), scale=float(scale))


def _golden_batch(cfg):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab_size, (4, 32))
            .astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (4, 32))
            .astype(np.int32)}


def _vlm_batch(cfg):
    """Four rows whose label masks differ between the replicas' halves:
    replica 0 keeps 20 + 32 labels, replica 1 keeps 32 + 3."""
    rng = np.random.default_rng(1)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32),
         "patch_embeds": (rng.standard_normal(
             (4, cfg.num_image_tokens, cfg.d_model)) * 0.1)
         .astype(np.float32)}
    b["labels"][0, :12] = -1
    b["labels"][3, 3:] = -1
    return b


@pytest.fixture(scope="module")
def runs():
    from repro.configs import get_config
    batches = {"smollm": _golden_batch(get_config("smollm-135m").reduced()),
               "vlm": _vlm_batch(get_config("qwen2-vl-2b").reduced())}
    refs = {"smollm": _reference("smollm-135m", batches["smollm"]),
            "vlm": _reference("qwen2-vl-2b", batches["vlm"])}
    ranks = spawn(_train_rank, 8, {k: r["tree"] for k, r in refs.items()},
                  batches, timeout=600)
    return dict(refs=refs, ranks=ranks)


# ---------------------------------------------------------------- holds ----

def _adam_sensitivity(g, dg, eps=1e-8):
    f = lambda x: x / (np.abs(x) + eps)
    return np.maximum(np.abs(f(g + dg) - f(g)), np.abs(f(g - dg) - f(g)))


def _hold_step(ref, got, lr):
    """test_torch_train.py's parameter hold: each parameter within lr
    times the most step 1's Adam direction moves while the clipped
    gradient moves by the two packages' measured difference (read from
    each one's first moment), plus 8 fp32 ulps."""
    c = 0.1
    flagged = total = 0
    gp, gm = _leaves(got["params"]), _leaves(got["m"])
    for keys, p0 in ref["p0"].items():
        p1, m = ref["params"][keys], ref["m"][keys]
        dg = np.abs(gm[keys] - m).astype(np.float64) / c
        sens = _adam_sensitivity(m.astype(np.float64) / c, dg)
        ulps = 8 * np.spacing(np.abs(p0) + np.abs(p1)) + 1e-38
        near = sens > 1e-3
        diff = np.abs(gp[keys] - p1)
        np.testing.assert_array_less(diff, lr * sens + ulps,
                                     err_msg=str(keys))
        assert (diff[~near] < 1e-3 * lr + ulps[~near]).all(), keys
        flagged += int(near.sum())
        total += m.size
    assert flagged < total // 1000


def _members(runs, key):
    return [r[key] for r in runs["ranks"] if r[key] is not None]


@pytest.mark.parametrize("dp,tp", GRIDS, ids=["dp2tp2", "dp2tp4"])
def test_golden_sharded_train_step_loss(runs, dp, tp):
    ref = runs["refs"]["smollm"]
    members = _members(runs, ("smollm", dp, tp))
    assert len(members) == dp * tp
    for r in members:
        assert r["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        assert r["step_loss"] == r["loss"]
        assert r["loss"] == members[0]["loss"]


@pytest.mark.parametrize("dp,tp", GRIDS, ids=["dp2tp2", "dp2tp4"])
def test_golden_sharded_gradients_gathered(runs, dp, tp):
    ref = runs["refs"]["smollm"]
    got = _leaves(_members(runs, ("smollm", dp, tp))[0]["grads"])
    assert set(got) == set(ref["grads"])
    for keys, g in ref["grads"].items():
        assert got[keys].shape == g.shape, keys
        err = float(np.abs(got[keys] - g).max())
        assert err <= 1e-4 * max(float(np.abs(g).max()), 1e-30), keys


@pytest.mark.parametrize("dp,tp", GRIDS, ids=["dp2tp2", "dp2tp4"])
def test_golden_sharded_step_parameters(runs, dp, tp):
    _hold_step(runs["refs"]["smollm"],
               _members(runs, ("smollm", dp, tp))[0], LR)


@pytest.mark.parametrize("dp,tp", GRIDS, ids=["dp2tp2", "dp2tp4"])
def test_sharded_clip_scale_matches_single_device(runs, dp, tp):
    ref = runs["refs"]["smollm"]
    members = _members(runs, ("smollm", dp, tp))
    assert ref["scale"] < 1.0                  # the clip is active
    for r in members:
        assert r["scale"] == pytest.approx(ref["scale"], rel=1e-6)
    split = set(members[0]["split"])
    assert {"embed", "layers.0.ffn.w"} <= split
    assert ("layers.0.attn.wq" in split) == (tp == 2)
    assert "out_norm" not in split and "layers.0.ffn.pred_A" not in split


def test_remat_repeats_collectives_in_backward(runs):
    """The same loss and gradients with remat; the backward's recompute
    repeats each layer's attention all-reduce (tp=2 splits attention at
    this width) on every rank, and not the FFN's: non-reentrant
    checkpointing stops recomputing at the layer's last saved tensor,
    which comes before the FFN's output is reduced."""
    plain = _members(runs, ("smollm", 2, 2))
    remat = _members(runs, "remat")
    assert [r["loss"] for r in remat] == [r["loss"] for r in plain]
    want = _leaves(plain[0]["grads"])
    for keys, g in _leaves(remat[0]["grads"]).items():
        np.testing.assert_array_equal(g, want[keys], err_msg=str(keys))
    extra = {r["calls"] - p["calls"] for r, p in zip(remat, plain)}
    L = tget_config("smollm-135m").reduced().num_layers
    assert extra == {L}


def test_vlm_unequal_label_masks_give_global_mean(runs):
    ref = runs["refs"]["vlm"]
    members = _members(runs, "vlm")
    assert len(members) == 4
    for r in members:
        assert r["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    got = _leaves(members[0]["grads"])
    for keys, g in ref["grads"].items():
        err = float(np.abs(got[keys] - g).max())
        assert err <= 1e-4 * max(float(np.abs(g).max()), 1e-30), keys


def test_train_over_ranks_tracks_one_rank():
    """launch.train.train at dp=2 x tp=2: five losses within 1e-5 of one
    rank's, and the gathered model one rank's: all but 0.1% of its
    elements within 1e-5 (the share test_torch_train.py allows near
    zero gradients), and every element within the 5 * lr that five Adam
    steps can move it (an element whose gradient sits near zero may take
    its step's direction from fp32 noise)."""
    from repro_torch.launch.train import train
    kw = dict(steps=5, batch_size=4, seq_len=32, lr=2e-3, log_every=0,
              device="cpu")
    one, l1 = train("smollm-135m", **kw)
    many, l4 = train("smollm-135m", tp=2, dp=2, **kw)
    np.testing.assert_allclose(l4, l1, rtol=1e-5)
    assert l4[-1] < l4[0]
    b = dict(many.module.named_parameters())
    far = total = 0
    for name, p in one.module.named_parameters():
        assert b[name].shape == p.shape
        d = np.abs(b[name].numpy() - p.numpy())
        assert d.max() <= 5 * kw["lr"], name
        far += int((d > 1e-5).sum())
        total += d.size
    assert far < total // 1000


@pytest.mark.parametrize("arch,n", [("smollm-135m", 2), ("smollm-135m", 4),
                                    ("qwen2-vl-2b", 2),
                                    ("deepseek-moe-16b", 2),
                                    ("grok-1-314b", 4)])
def test_slice_drawn_leaf_by_leaf_is_the_whole_models_slice(arch, n):
    """A rank's model built at its training layout from a seed holds,
    bit for bit, its part of the whole model built from that seed: each
    leaf is drawn whole from the same generator stream and cut."""
    from repro_torch.bridge import model_tree, shard_params
    from repro_torch.models.model import build_model
    from repro_torch.parallel import ShardGroup
    cfg = tget_config(arch).reduced()
    whole = build_model(cfg, "cpu", seed=3).module
    for r in range(n):
        g = ShardGroup(r, n, None, torch.device("cpu"), tuple(range(n)))
        want = _leaves(shard_params(model_tree(whole), cfg, None, r, n))
        got = _leaves(model_tree(build_model(cfg, "cpu", seed=3, shard=g)
                                 .module))
        assert set(got) == set(want)
        for keys, w in want.items():
            for a, b in (zip(got[keys], w) if isinstance(w, list)
                         else [(got[keys], w)]):
                assert torch.equal(a, b), (arch, n, r, keys)


def test_train_cli_refuses_what_serve_refuses(capsys):
    """--tp and --dp count at least 1 and the train CLI has no --ep
    (--tp sizes an moe arch's ranks too); and dp replicas of an moe
    config must split its dispatch groups; all before any rank starts.
    Every family has a tensor-parallel layout: mamba2-130m trains at
    --tp 2 --dp 2."""
    from repro_torch.launch.train import main
    from repro_torch.parallel import replica_cfg
    for argv in (["--tp", "0"], ["--dp", "0"], ["--ep", "2"]):
        with pytest.raises(SystemExit):
            main(["--device", "cpu"] + argv)
    main(["--arch", "mamba2-130m", "--tp", "2", "--dp", "2", "--steps",
          "1", "--device", "cpu"])
    assert "final loss" in capsys.readouterr().out
    ds = tget_config("deepseek-moe-16b").reduced()
    with pytest.raises(ValueError, match="does not split over dp=2"):
        replica_cfg(ds, 2)
    assert replica_cfg(ds.replace(moe_dispatch_groups=4), 2) \
        .moe_dispatch_groups == 2
    smollm = tget_config("smollm-135m").reduced()
    assert replica_cfg(smollm, 2) is smollm


def test_spawned_training_ranks_import_no_jax(runs):
    assert all(r["foreign"] == [] for r in runs["ranks"])
