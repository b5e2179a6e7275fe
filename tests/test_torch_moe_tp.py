"""The moe family of the port over ranks (gloo ranks on the CPU,
`repro_torch.parallel.spawn`) against the JAX package: the reference's
golden tests/test_distributed.py:111, and grok-1-314b's experts split by
neurons (`moe_shard_mode="tp"`).

* Golden :111: reduced deepseek-moe-16b with moe_capacity_factor 8 and
  moe_dispatch_groups 2, its weights from jax key 0, at dp=2 x ep=4
  (each replica routes its rows of the (4, 32) batch in one group): the
  forward logits within 1e-4 of the reference's single-device forward
  (the golden allows 2e-3).
* Reduced grok-1-314b at tp 2 and 4 (every expert's d_ff rows split):
  `apply_moe_ffn` within 1e-5 of one rank's max |y|; trained 20 steps in JAX and
  served (prompts arriving together), tokens identical to the reference
  engine on one device, the TokenStats at tp=1 the reference engine's,
  the traces equal to tp=1's and the TokenStats, per shard, those of
  the reference StoragePlane(n_shards=n) repriced on them; one
  train step from jax key 0 held as test_torch_train_tp.py holds the
  golden :75 (loss, gathered gradients, parameters after AdamW).
* The two-level trace under tp (reduced turbosparse-mixtral-47b with
  moe_shard_mode "tp"): each rank's cluster counts gathered in rank
  order give one rank's (L, E, 1+ncc) trace; a plan whose cluster size
  does not divide a rank's d_ff / n rows raises.

The rank function imports only the port (the JAX package is imported
inside the fixture), so a spawned rank never loads it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.core.planner import PHONE, build_moe_plan
from repro_torch.data.pipeline import shard_batch
from repro_torch.models import moe as tmoe
from repro_torch.models.model import wrap
from repro_torch.parallel import ShardGroup, grid, replica_cfg, \
    replica_groups, shard_layout, spawn
from repro_torch.serving.engine import ServeEngine
from test_torch_train_tp import _foreign, _golden_batch, _hold_step, \
    _leaves, _reference, _step_case

KW = dict(buckets=(1, 2), temperature=0.0, seed=0, ctx_budget=48)
TP = (2, 4)


def _golden_cfg(cfg):
    return cfg.replace(moe_capacity_factor=8.0, moe_dispatch_groups=2)


def _stream(vocab):
    """Three prompts arriving together: the modeled clock, which the
    shard count changes, then decides no admission (the tp decode
    golden's dp stream)."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, 16).astype(np.int32), 6, i * 1e-6)
            for i in range(3)]


def _serve(engine, stream):
    uids = [engine.submit(p, m, arrival_time=t) for p, m, t in stream]
    rep = engine.run_until_drained()
    return rep, {u: list(engine.sched.sequences[u].generated) for u in uids}


def _two_level(cfg):
    return cfg.replace(moe_shard_mode="tp")


# ---------------------------------------------------------------- ranks ----

def _grok_serve(g, n, tree, x):
    """Reduced grok over the group g of n ranks (None: one rank): layer
    0's apply_moe_ffn on x, then the stream served."""
    cfg = tget_config("grok-1-314b").reduced()
    plan = build_moe_plan(cfg, hw=PHONE)
    model = params_from_numpy(tree, cfg, "cpu", shard=None if n == 1 else
                              ShardGroup(g.rank, n))
    shard = None if n == 1 else g
    y, _, trace = tmoe.apply_moe_ffn(model.layers[0].moe, torch.from_numpy(x),
                                     cfg, collect_trace=True, shard=shard)
    engine = ServeEngine(cfg, model, plan, shard=shard, **KW)
    calls, price = [], engine.storage.step

    def step(tr, p, b, c):
        calls.append((np.asarray(tr), dataclasses.asdict(p), b, c))
        return price(tr, p, b, c)
    engine.storage.step = step
    rep, toks = _serve(engine, _stream(cfg.vocab_size))
    engine.close()
    return dict(y=y.numpy(), trace=trace.numpy(), toks=toks, calls=calls,
                stats=[dataclasses.asdict(s) for s in rep.stats],
                rows=model.layers[0].moe.experts.shape[1])


def _two_level_case(g, n, x):
    """Reduced turbosparse-mixtral-47b under moe_shard_mode 'tp' (seed 0):
    layer 0's two-level trace and output at each bucket plan."""
    cfg = _two_level(tget_config("turbosparse-mixtral-47b").reduced())
    plan = build_moe_plan(cfg, hw=PHONE)
    layout = None if n == 1 else shard_layout(cfg, plan, g.rank, n)
    model = tmoe.make_model(cfg, "cpu", seed=0, layout=layout)
    out = []
    for b in (1, 2):
        p = plan.plan_for_batch(b)
        assert p.n_expert_hot > 0
        y, _, tr = tmoe.apply_moe_ffn(
            model.layers[0].moe, torch.from_numpy(x), cfg, plan=p,
            collect_trace=True, shard=None if n == 1 else g)
        out.append((y.numpy(), tr.numpy()))
    return out


def _moe_rank(world, trees, batches, x):
    out = {"foreign": _foreign()}
    # golden :111 on the (2, 4) grid
    rows, cols = grid(world, 2, 4)
    cfg = replica_cfg(_golden_cfg(tget_config("deepseek-moe-16b").reduced()),
                      2)
    model = wrap(params_from_numpy(trees["ds"], cfg, "cpu", shard=rows),
                 rows)
    b = shard_batch(batches["ds"], "cpu", cols.rank, 2)
    with torch.no_grad():
        out["golden"] = (cols.rank, model.forward(model.module, b).numpy(),
                         model.module.layers[0].moe.experts.shape[0])
    # grok-1-314b and the two-level trace at tp 1, 2 and 4
    for n in (1, 2, 4):
        g = replica_groups(world, world.size // n, n)[0]
        if not g.member:
            continue
        out["grok", n] = _grok_serve(g, n, trees["grok"], x)
        out["two", n] = _two_level_case(g, n, x)
    for n in TP:
        out["step", n] = _step_case(world, "grok-1-314b", trees["grok0"],
                                    batches["grok"], 1, n)
    return out


# -------------------------------------------------------------- fixture ----

@pytest.fixture(scope="module")
def runs():
    import jax
    from repro.configs import get_config
    from repro.core.planner import PHONE as JPHONE
    from repro.core.planner import build_moe_plan as jplan
    from repro.models.model import build_model
    from repro.serving.engine import ServeEngine as JEngine
    from test_torch_ep import _train
    ds_cfg = _golden_cfg(get_config("deepseek-moe-16b").reduced())
    ds_model = build_model(ds_cfg)
    ds = ds_model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    ds_batch = {"tokens": rng.integers(0, ds_cfg.vocab_size, (4, 32))
                .astype(np.int32)}
    ds_logits = np.asarray(jax.jit(ds_model.forward)(ds, ds_batch))
    gcfg, grok = _train("grok-1-314b")
    engine = JEngine(gcfg, grok, jplan(gcfg, hw=JPHONE), **KW)
    ref_rep, ref_toks = _serve(engine, _stream(gcfg.vocab_size))
    engine.close()
    gbatch = _golden_batch(gcfg)
    step = _reference("grok-1-314b", gbatch)
    x = np.random.default_rng(3).standard_normal(
        (6, gcfg.d_model)).astype(np.float32)
    trees = {"ds": jax.tree.map(np.asarray, ds),
             "grok": jax.tree.map(np.asarray, grok), "grok0": step["tree"]}
    ranks = spawn(_moe_rank, 8, trees, {"ds": ds_batch, "grok": gbatch}, x,
                  timeout=600)
    return dict(ranks=ranks, ds_logits=ds_logits, ref_toks=ref_toks,
                ref_stats=[dataclasses.asdict(s) for s in ref_rep.stats],
                step=step, grok_cfg=gcfg, grok=grok)


def _members(runs, key):
    return [r[key] for r in runs["ranks"] if key in r]


# ---------------------------------------------------------------- tests ----

def test_golden_sharded_moe_forward(runs):
    want = runs["ds_logits"]
    got = [r["golden"] for r in runs["ranks"]]
    assert {e for _, _, e in got} == {1}          # ep=4: one expert each
    for replica, logits, _ in got:
        np.testing.assert_allclose(logits, want[2 * replica:2 * replica + 2],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n", TP)
def test_grok_moe_ffn_over_ranks_matches_one_rank(runs, n):
    one = _members(runs, ("grok", 1))[0]
    members = _members(runs, ("grok", n))
    assert len(members) == n
    cfg = tget_config("grok-1-314b").reduced()
    for r in members:
        assert r["rows"] == cfg.d_ff // n
        # fp32 partial sums over the ranks' rows: within 1e-5 of max |y|
        np.testing.assert_allclose(r["y"], one["y"], rtol=0,
                                   atol=1e-5 * np.abs(one["y"]).max())
        np.testing.assert_array_equal(r["trace"], one["trace"])


@pytest.mark.parametrize("n", (1,) + TP)
def test_grok_tokens_match_reference_engine(runs, n):
    for r in _members(runs, ("grok", n)):
        assert r["toks"] == runs["ref_toks"]
    assert all(len(t) == 6 for t in runs["ref_toks"].values())


@pytest.mark.parametrize("n", (1,) + TP)
def test_grok_traces_and_stats_match_tp1_and_reference_plane(runs, n):
    """tp=1: the reference engine's TokenStats. tp=n: every storage-plane
    call (trace, plan, batch, context) tp=1's, and the TokenStats the
    reference StoragePlane(n_shards=n) gives repricing them, per-shard
    stats included; every rank reports the same."""
    from repro.core.baselines import POWERINFER2
    from repro.core.clusters import HybridPlan as JPlan
    from repro.core.planner import PHONE as JPHONE
    from repro.core.planner import build_moe_plan as jplan
    from repro.serving.storage_plane import StoragePlane as JPlane
    one = _members(runs, ("grok", 1))[0]
    assert one["stats"] == runs["ref_stats"]
    members = _members(runs, ("grok", n))
    run = members[0]
    for r in members:
        assert r["stats"] == run["stats"]
        assert len(r["calls"]) == len(one["calls"])
        for (a, *ka), (b, *kb) in zip(r["calls"], one["calls"]):
            np.testing.assert_array_equal(a, b)
            assert ka == kb
    if n == 1:
        return
    cfg = runs["grok_cfg"]
    plane = JPlane(cfg, runs["grok"], jplan(cfg, hw=JPHONE),
                   spec=POWERINFER2, n_shards=n)
    want = [dataclasses.asdict(plane.step(tr, JPlan(**p), b, ctx))
            for tr, p, b, ctx in run["calls"]]
    plane.close()
    assert run["stats"] == want
    assert all(s["n_shards"] == n and len(s["shards"]) == n
               for s in run["stats"])


@pytest.mark.parametrize("n", TP)
def test_grok_train_step_over_ranks(runs, n):
    ref = runs["step"]
    members = [r for r in _members(runs, ("step", n)) if r is not None]
    assert len(members) == n
    for r in members:
        assert r["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        assert r["scale"] == pytest.approx(ref["scale"], rel=1e-6)
    assert "layers.0.moe.experts" in members[0]["split"]
    got = _leaves(members[0]["grads"])
    for keys, g in ref["grads"].items():
        err = float(np.abs(got[keys] - g).max())
        assert err <= 1e-4 * max(float(np.abs(g).max()), 1e-30), keys
    _hold_step(ref, members[0], 1e-3)


@pytest.mark.parametrize("n", TP)
def test_two_level_trace_gathered_in_rank_order(runs, n):
    one = _members(runs, ("two", 1))[0]
    for r in _members(runs, ("two", n)):
        for (y, tr), (y1, tr1) in zip(r, one):
            assert tr.ndim == 2 and tr.shape == tr1.shape
            np.testing.assert_array_equal(tr, tr1)
            np.testing.assert_allclose(y, y1, rtol=0,
                                       atol=1e-5 * np.abs(y1).max())


def test_cluster_size_must_divide_rank_rows():
    """A two-level plan whose clusters straddle two ranks' rows raises;
    whole-expert plans (cluster = d_ff) and training (no plan) do not."""
    cfg = _two_level(tget_config("turbosparse-mixtral-47b").reduced())
    bad = cfg.replace(d_ff=384)           # 192 rows per rank, clusters 32
    plan = build_moe_plan(bad, hw=PHONE)
    assert shard_layout(bad, plan, 0, 2).expert_rows == (0, 192)
    plan128 = build_moe_plan(bad.replace(sparse_ffn=dataclasses.replace(
        bad.sparse_ffn, cluster_size=128)), hw=PHONE)
    with pytest.raises(ValueError, match="not whole clusters of 128"):
        shard_layout(bad, plan128, 1, 2)
    assert shard_layout(bad, None, 1, 2).expert_rows == (192, 384)
    with pytest.raises(ValueError, match="does not split over 3"):
        shard_layout(cfg, None, 0, 3)
    grok = tget_config("grok-1-314b")
    whole = build_moe_plan(grok.reduced(), hw=PHONE)
    assert whole.cluster_size == grok.reduced().d_ff
    assert shard_layout(grok, whole, 3, 4).expert_rows == (
        3 * grok.d_ff // 4, grok.d_ff)


def test_spawned_moe_ranks_import_no_jax(runs):
    assert all(r["foreign"] == [] for r in runs["ranks"])
