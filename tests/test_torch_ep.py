"""Expert parallelism of the port over torch.distributed (gloo ranks on
the CPU) against the JAX package's single-device engine: the reference's
moe goldens (tests/test_distributed.py :219 and :289) on the port.

* ep golden: reduced deepseek-moe-16b trained 20 AdamW steps in JAX,
  served at ep=1, ep=2 and dp=2 x ep=2: tokens identical to the
  reference engine on one device; TokenStats equal to the reference's at
  ep=1 and, at ep=2, to the reference StoragePlane(n_shards=2) repriced
  on the port's trace; per-shard io_s summing to io_total_s and raw I/O
  no more than one device's.
* two-level golden: reduced turbosparse-mixtral-47b (20 steps), its
  two-level plan and per-expert permutation, at ep=1 and ep=2: tokens
  identical to the reference's dense-expert engine; the (L, E, 1+ncc)
  traces identical across ep (each rank's (E/2, 1+ncc) blocks gathered
  in expert order); the stats the reference plane's on that trace.

The rank functions import only the port.
"""
import dataclasses
import sys

import numpy as np
import pytest

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.core.planner import PHONE, build_moe_plan
from repro_torch.parallel import ShardGroup, replica_groups, spawn
from repro_torch.serving.engine import ServeEngine

KW = dict(buckets=(1, 2), temperature=0.0, seed=0, ctx_budget=48)


def _foreign() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def _stream(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, 16).astype(np.int32), 6, i * 1e-3)
            for i in range(3)]


def _serve(engine, stream):
    uids = [engine.submit(p, m, arrival_time=t) for p, m, t in stream]
    rep = engine.run_until_drained()
    return rep, {u: list(engine.sched.sequences[u].generated) for u in uids}


def _ep_rank(world, trees):
    """Each case on world ranks [0, dp*ep): (arch, tree key, dp, ep)."""
    out = {"foreign": _foreign()}
    cases = [("deepseek-moe-16b", "ds", 1, 1), ("deepseek-moe-16b", "ds",
                                                1, 2),
             ("deepseek-moe-16b", "ds", 2, 2),
             ("turbosparse-mixtral-47b", "ts", 1, 1),
             ("turbosparse-mixtral-47b", "ts", 1, 2)]
    for arch, key, dp, ep in cases:
        n = dp * ep
        group = replica_groups(world, world.size // n, n)[0]
        if not group.member:
            continue
        cfg = tget_config(arch).reduced()
        plan = build_moe_plan(cfg, hw=PHONE)
        model = params_from_numpy(trees[key], cfg, "cpu",
                                  shard=ShardGroup(group.rank % ep, ep))
        engine = ServeEngine(cfg, model, plan, dp=dp,
                             shard=None if n == 1 else group, **KW)
        calls = []
        for e in engine.replicas or [engine]:
            price = e.storage.step

            def step(trace, p, batch, ctx, price=price):
                calls.append((np.asarray(trace), dataclasses.asdict(p),
                              batch, ctx))
                return price(trace, p, batch, ctx)
            e.storage.step = step
        rep, toks = _serve(engine, _stream(cfg.vocab_size))
        out[key, dp, ep] = dict(
            toks=toks, calls=calls,
            stats=[dataclasses.asdict(s) for s in rep.stats],
            experts=model.layers[0].moe.experts.shape[0])
        engine.close()
    return out


def _train(arch, steps=20):
    import jax
    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.models.model import build_model
    from repro.optim.adamw import AdamW
    from repro.train.steps import make_train_step
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    opt = AdamW(lr=2e-3)
    step = jax.jit(make_train_step(model, opt), donate_argnums=(0, 1))
    state = opt.init(params)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4, seed=0))
    for _ in range(steps):
        params, state, _ = step(params, state, data.batch())
    return cfg, params


@pytest.fixture(scope="module")
def served():
    import jax
    from repro.core.planner import PHONE as JPHONE, build_moe_plan as jplan
    from repro.serving.engine import ServeEngine as JEngine
    from repro.serving.families import serving_family
    ds_cfg, ds = _train("deepseek-moe-16b")
    ts_cfg, ts = _train("turbosparse-mixtral-47b")
    ds_plan = jplan(ds_cfg, hw=JPHONE)
    ts_plan = serving_family(ts_cfg).build_plan(ts_cfg, hw=JPHONE)
    assert all(p.n_expert_hot > 0 for p in ts_plan.plans.values())
    ts_intra = serving_family(ts_cfg).prepare_params(ts, ts_plan)
    wcfg = ts_cfg.replace(moe_intra_expert=False)
    ref = {}
    for key, cfg, params, plan in (
            ("ds", ds_cfg, ds, ds_plan),
            ("ts", wcfg, ts, jplan(wcfg, hw=JPHONE))):
        e = JEngine(cfg, params, plan, **KW)
        ref[key] = _serve(e, _stream(cfg.vocab_size))
        e.close()
    trees = {"ds": jax.tree.map(np.asarray, ds),
             "ts": jax.tree.map(np.asarray, ts_intra)}
    ranks = spawn(_ep_rank, 4, trees, timeout=600)
    return dict(ref=ref, ranks=ranks,
                planes={"ds": (ds_cfg, ds, ds_plan),
                        "ts": (ts_cfg, ts_intra, ts_plan)})


def _members(served, key):
    return [r[key] for r in served["ranks"] if key in r]


EP_CASES = [("ds", 1, 1), ("ds", 1, 2), ("ds", 2, 2), ("ts", 1, 1),
            ("ts", 1, 2)]


@pytest.mark.parametrize("key", EP_CASES, ids=str)
def test_ep_tokens_match_reference(served, key):
    _, toks_ref = served["ref"][key[0]]
    runs = _members(served, key)
    assert len(runs) == key[1] * key[2]
    for run in runs:
        assert run["toks"] == toks_ref
    assert all(len(t) == 6 for t in toks_ref.values())


@pytest.mark.parametrize("key", [k for k in EP_CASES if k[1] == 1],
                         ids=str)
def test_ep_stats_match_reference_plane(served, key):
    """The reference StoragePlane(n_shards=ep) on the port's trace gives
    the port's TokenStats, per-shard stats included; at ep=1 for
    deepseek these are also the reference engine's."""
    from repro.core.baselines import POWERINFER2
    from repro.core.clusters import HybridPlan as JPlan
    from repro.serving.storage_plane import StoragePlane as JPlane
    cfg, params, plan = served["planes"][key[0]]
    runs = _members(served, key)
    run = runs[0]
    assert all(r["stats"] == run["stats"] for r in runs)
    plane = JPlane(cfg, params, plan, spec=POWERINFER2, n_shards=key[2])
    want = [dataclasses.asdict(plane.step(tr, JPlan(**p), b, ctx))
            for tr, p, b, ctx in run["calls"]]
    plane.close()
    assert run["stats"] == want
    if key == ("ds", 1, 1):
        rep_ref, _ = served["ref"]["ds"]
        assert run["stats"] == [dataclasses.asdict(s)
                                for s in rep_ref.stats]


@pytest.mark.parametrize("arch", ["ds", "ts"])
def test_ep_traces_identical_across_ranks(served, arch):
    base = [tr for tr, *_ in _members(served, (arch, 1, 1))[0]["calls"]]
    if arch == "ts":
        assert base[0].ndim == 3        # (L, E, 1+ncc): two-level
    for run in _members(served, (arch, 1, 2)):
        got = [tr for tr, *_ in run["calls"]]
        assert len(got) == len(base)
        for a, b in zip(got, base):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["ds", "ts"])
def test_ep_per_shard_accounting(served, arch):
    rep1 = _members(served, (arch, 1, 1))[0]["stats"]
    for run in _members(served, (arch, 1, 2)):
        assert run["experts"] == 2              # E/2 of the 4 experts
        for s in run["stats"]:
            assert s["n_shards"] == 2 and len(s["shards"]) == 2
            assert abs(s["io_total_s"]
                       - sum(sh["io_s"] for sh in s["shards"])) < 1e-12
        assert run["stats"][0]["io_s"] <= rep1[0]["io_s"] + 1e-12


def test_dp2_ep2_routes_both_replicas(served):
    for run in _members(served, ("ds", 2, 2)):
        assert all(s["n_shards"] == 2 and len(s["shards"]) == 2
                   for s in run["stats"])
        assert {s["replica"] for s in run["stats"]} == {0, 1}


def test_spawned_ep_ranks_import_no_jax(served):
    assert all(r["foreign"] == [] for r in served["ranks"])
