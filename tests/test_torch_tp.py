"""Tensor parallelism of the port over torch.distributed (gloo ranks on
the CPU, `repro_torch.parallel.spawn`) against the JAX package's
single-device results: the reference's distributed goldens
(tests/test_distributed.py) on the port.

* The shard-local cold path (golden :34; D 64, N 512, cs 32, G 4,
  relu2): at 2 and 4 ranks, under both backends (the CPU runs the
  kernel's plain version) and at int8 storage, from whole weights and
  from each rank's own rows, y within 1e-3 of the reference's
  single-device `ffn_hybrid` and the ids identical.
* tp decode (golden :142): reduced smollm-135m trained 30 AdamW steps in
  JAX, a plan of groups=4 scaled per bucket, served at tp 1, 2 and 4
  under jnp and pallas: tokens identical to the reference engine on one
  device; TokenStats equal to the reference's at tp=1 and, at tp=n, to
  the reference StoragePlane(n_shards=n) repriced on the port's own
  trace (per-shard stats included); io_s no more than one device's and
  the summed effective_s within 1.01x of it. At this width (4 heads, 2
  kv heads) tp=2 shards attention and tp=4 replicates it.
* dp=2 x tp=2 (golden :357, groups=2): tokens identical to the
  reference's dp=2 engine, under both backends.
* A group of one rank is bit-identical to no group; a spawned rank
  imports neither jax nor the JAX package; an engine over gloo ranks
  refuses CUDA graphs; the CLI's mesh flags refuse what the reference's
  refuse.

The rank functions below import only the port (the JAX package is
imported inside the fixtures), so a spawned rank never loads it.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.core.clusters import HybridPlan, make_plan, \
    scale_plan_for_batch
from repro_torch.core.planner import PHONE, build_plan
from repro_torch.core.sparse_ffn import ffn_hybrid
from repro_torch.parallel import NeuronRows, ShardGroup, dense_ranges, \
    ffn_ranges, replica_groups, spawn
from repro_torch.serving.engine import ServeEngine

# the golden's shapes: D 64, N 512, cs 32, G 4, relu2, relu mode
COLD = dict(D=64, N=512, cs=32, G=4, r=16, n_hot=128, k_cold=64)
KW = dict(temperature=0.0, seed=0, ctx_budget=48)
TP_BUCKETS, DP_BUCKETS = (1, 2, 4), (1, 2)


def _foreign() -> list:
    """Modules of jax or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def _group(world, n: int) -> ShardGroup:
    """The group of world ranks [0, n) (every rank of `world` calls)."""
    return replica_groups(world, world.size // n, n)[0]


# ------------------------------------------------------ the cold path ----

def _cold_rank(world, w, A, Bm, x, quant, plan_kw, with_vlm):
    """ffn_hybrid over ranks [0, n) for n in (2, 4), each backend, from
    whole weights and from the rank's own rows; with `with_vlm` also
    `_vlm_decode` on ranks [0, 2)."""
    out = {"foreign": _foreign()}
    t = lambda a: None if a is None else torch.from_numpy(a)
    for n in (2, 4):
        g = _group(world, n)
        if not g.member:
            continue
        for backend in ("jnp", "pallas"):
            plan = HybridPlan(**plan_kw, backend=backend)
            q = None if quant is None else tuple(t(a) for a in quant)
            whole = ffn_hybrid(t(w), (t(A), t(Bm)), t(x), "relu2", "relu",
                               plan, return_indices=True, quant=q,
                               shard=g)
            rows = NeuronRows(ffn_ranges(plan, w.shape[0], g.rank, n)
                              + dense_ranges(plan, w.shape[0], g.rank, n),
                              w.shape[0],
                              dense_ranges(plan, w.shape[0], g.rank, n))
            ids = rows.ids
            ql = None if q is None else tuple(
                None if a is None else a[ids] for a in q)
            own = ffn_hybrid(t(w[ids]), (t(A), t(Bm[:, ids])), t(x), "relu2",
                             "relu", plan, return_indices=True, quant=ql,
                             shard=g, rows=rows)
            out[n, backend] = [(y.numpy(), i.numpy()) for y, i in (whole,
                                                                   own)]
    if with_vlm:
        out["vlm"] = _vlm_decode(_group(world, 2))
    return out


def _vlm_decode(g):
    """Reduced qwen2-vl-2b's M-RoPE model (seed 0, on every rank) over
    the group of ranks [0, 2) and unsharded: prefill of patches and text,
    then three decode steps under the PHONE plan (groups=1: the cold
    path runs whole on every rank; 4 heads, 2 kv heads: attention
    split). Returns (max |logits diff| over the steps, traces equal)."""
    if not g.member:
        return None
    from repro_torch.bridge import shard_model
    from repro_torch.models import vlm
    cfg = tget_config("qwen2-vl-2b").reduced()
    plan = build_plan(cfg, hw=PHONE)
    model = vlm.make_model(cfg, device="cpu", seed=0)
    local = shard_model(model, plan, g)
    rng = np.random.default_rng(7)
    patches = torch.from_numpy(rng.standard_normal(
        (1, cfg.num_image_tokens, cfg.d_model)).astype(np.float32) * 0.1)
    text = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 5))
                            .astype(np.int32))
    diff, same = 0.0, True
    runs = []
    for m, shard in ((model, None), (local, g)):
        logits, cache = vlm.prefill(m, text, patches,
                                    max_len=cfg.num_image_tokens + 8,
                                    shard=shard)
        step = vlm.make_decode_step(cfg, collect_indices=True, shard=shard)
        got = [logits]
        for _ in range(3):
            nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            logits, cache, trace = step(m, nxt, cache,
                                        plan.plan_for_batch(1))
            got += [logits, trace]
        runs.append(got)
    for a, b in zip(*runs):
        if a.dtype == torch.int32:
            same &= torch.equal(a, b)
        else:
            diff = max(diff, float((a - b).abs().max()))
    return diff, same, local.kv_heads


@pytest.fixture(scope="module")
def cold_golden():
    import jax.numpy as jnp
    from repro.core.clusters import HybridPlan as JPlan
    from repro.core.sparse_ffn import ffn_hybrid as jffn_hybrid
    from repro.quant.storage import quantize_bundles
    c = COLD
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((c["N"], 3, c["D"])) / 8.0).astype(np.float32)
    A = (rng.standard_normal((c["D"], c["r"])) / 8.0).astype(np.float32)
    Bm = (rng.standard_normal((c["r"], c["N"])) / 4.0).astype(np.float32)
    x = (rng.standard_normal((2, c["D"])) * 0.5).astype(np.float32)
    qd = quantize_bundles(jnp.asarray(w), "int8")
    quant = (np.asarray(qd["wq"]), np.asarray(qd["wsc"]), None)
    plan_kw = dict(n_hot=c["n_hot"], k_cold=c["k_cold"], groups=c["G"],
                   cluster_size=c["cs"])
    out = {}
    for sd, q in (("fp16", None), ("int8", quant)):
        params = {"w": jnp.asarray(w), "pred": {"A": jnp.asarray(A),
                                                 "B": jnp.asarray(Bm)}}
        if q is not None:
            params.update(wq=jnp.asarray(q[0]), wsc=jnp.asarray(q[1]))
        y, ids = jffn_hybrid(params, jnp.asarray(x), "relu2", "relu",
                             JPlan(**plan_kw), return_indices=True)
        ranks = spawn(_cold_rank, 4, w, A, Bm, x, q, plan_kw, q is None,
                      timeout=300)
        out[sd] = (np.asarray(y), np.asarray(ids), ranks)
    return out


@pytest.mark.parametrize("sd", ["fp16", "int8"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_shard_local_cold_path_matches_reference(cold_golden, sd, n,
                                                 backend):
    y_ref, ids_ref, ranks = cold_golden[sd]
    for r in range(n):
        for y, ids in ranks[r][n, backend]:        # whole weights, own rows
            np.testing.assert_allclose(y, y_ref, atol=1e-3, rtol=1e-3)
            np.testing.assert_array_equal(ids, ids_ref)
    assert ids_ref.shape == (COLD["G"], COLD["k_cold"] // COLD["cs"])


def test_vlm_mrope_over_two_ranks(cold_golden):
    """The vlm model's prefill and decode over two ranks (attention
    head-sharded, the cold path replicated) give the unsharded logits
    within 1e-4 and the same traces."""
    for r in (0, 1):
        diff, same, kv = cold_golden["fp16"][2][r]["vlm"]
        assert diff < 1e-4 and same and kv == 1


def test_spawned_ranks_import_no_jax(cold_golden):
    for sd in ("fp16", "int8"):
        assert all(r["foreign"] == [] for r in cold_golden[sd][2])


# ------------------------------------------------------ serving goldens ----

def _plan(cfg, groups: int, buckets):
    """The golden's plan: build_plan's order with make_plan(d_ff, 0.25,
    0.25, cs, groups) scaled per bucket."""
    plan = build_plan(cfg, hw=PHONE)
    cs = cfg.sparse_ffn.cluster_size
    base = make_plan(cfg.d_ff, 0.25, 0.25, cs, groups=groups)
    plan.plans = {b: scale_plan_for_batch(base, cfg.d_ff, b, cs)
                  for b in buckets}
    return plan


def _serve(engine, stream):
    """Submit the stream, drain, return what the comparisons read."""
    uids = [engine.submit(p, m, arrival_time=t) for p, m, t in stream]
    rep = engine.run_until_drained()
    toks = {u: list(engine.sched.sequences[u].generated) for u in uids}
    return rep, toks


def _recorder(engine, calls):
    """Record every storage-plane call (trace, plan, batch, ctx) of a
    non-routed engine or of each replica's."""
    for e in engine.replicas or [engine]:
        price = e.storage.step

        def step(trace, plan, batch, ctx, price=price):
            calls.append((np.asarray(trace), dataclasses.asdict(plan),
                          batch, ctx))
            return price(trace, plan, batch, ctx)
        e.storage.step = step


def _tp_rank(world, tree, tp_stream, dp_stream):
    """Every serving case of this file on world ranks [0, dp*tp)."""
    cfg = tget_config("smollm-135m").reduced()
    plans = {4: _plan(cfg, 4, (1, 2, 4, 8)), 2: _plan(cfg, 2, (1, 2, 4, 8))}
    out = {"foreign": _foreign()}
    cases = [(name, 1, n, G, b) for name, n, G in
             (("none", 1, 4), ("one", 1, 4), ("tp2", 2, 4), ("tp4", 4, 4))
             for b in ("jnp", "pallas")]
    cases += [("dp2tp2", 2, 2, 2, b) for b in ("jnp", "pallas")]
    for name, dp, tp, G, backend in cases:
        group = _group(world, dp * tp)
        if not group.member:
            continue
        plan = plans[G]
        local = ShardGroup(group.rank % tp, tp)
        model = params_from_numpy(tree, cfg, "cpu", shard=local, plan=plan)
        shard = None if name == "none" else group
        if name == "one":
            shard = ShardGroup(0, 1, None, torch.device("cpu"),
                               (group.ranks[0],))
        engine = ServeEngine(cfg, model, plan, dp=dp, shard=shard,
                             backend=backend,
                             buckets=TP_BUCKETS if dp == 1 else DP_BUCKETS,
                             **KW)
        calls = []
        _recorder(engine, calls)
        rep, toks = _serve(engine, tp_stream if dp == 1 else dp_stream)
        plane = engine.replicas[0] if engine.replicas else engine
        out[name, backend] = dict(
            toks=toks, calls=calls, graphs=engine.cuda_graphs,
            policy=engine.graph_policy,
            stats=[dataclasses.asdict(s) for s in rep.stats],
            kv=engine.model.kv_heads, n_shards=plane.storage.n_shards,
            logits=None if engine.replicas else engine._last.numpy(),
            collectives=None if shard is None else shard.calls)
        engine.close()
    return out


@pytest.fixture(scope="module")
def served():
    """Reference: reduced smollm-135m trained 30 AdamW steps, permuted
    by build_plan's order; its single-device engine on the G=4 plan and
    its dp=2 engine on the G=2 plan. Port: every case of `_tp_rank` on 4
    gloo ranks."""
    import jax
    from repro.configs import get_config
    from repro.core.clusters import make_plan as jmake_plan, \
        scale_plan_for_batch as jscale
    from repro.core.planner import PHONE as JPHONE, \
        build_plan as jbuild_plan, permute_ffn_params
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.models.model import build_model
    from repro.optim.adamw import AdamW
    from repro.serving.engine import ServeEngine as JEngine
    from repro.train.steps import make_train_step

    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    opt = AdamW(lr=2e-3)
    step = jax.jit(make_train_step(model, opt), donate_argnums=(0, 1))
    state = opt.init(params)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4, seed=0))
    for _ in range(30):
        params, state, _ = step(params, state, data.batch())
    plan = jbuild_plan(cfg, hw=JPHONE)
    params = permute_ffn_params(params, plan.neuron_order)
    cs = cfg.sparse_ffn.cluster_size

    def jplan(groups):
        p = jbuild_plan(cfg, hw=JPHONE)
        base = jmake_plan(cfg.d_ff, 0.25, 0.25, cs, groups=groups)
        p.plans = {b: jscale(base, cfg.d_ff, b, cs) for b in (1, 2, 4, 8)}
        return p

    rng = np.random.default_rng(0)
    tp_stream = [(rng.integers(0, cfg.vocab_size, 16).astype(np.int32), 8,
                  i * 1e-3) for i in range(3)]
    rng = np.random.default_rng(0)
    dp_stream = [(rng.integers(0, cfg.vocab_size, 16).astype(np.int32), 6,
                  i * 1e-6) for i in range(4)]
    ref = {}
    for key, p, dp, buckets, stream in (
            ("tp", jplan(4), None, TP_BUCKETS, tp_stream),
            ("dp", jplan(2), 2, DP_BUCKETS, dp_stream)):
        e = JEngine(cfg, params, p, buckets=buckets, dp=dp, **KW)
        rep, toks = _serve(e, stream)
        ref[key] = (rep, toks, p)
        e.close()
    tree = jax.tree.map(np.asarray, params)
    ranks = spawn(_tp_rank, 4, tree, tp_stream, dp_stream, timeout=600)
    return dict(cfg=cfg, params=params, ref=ref, ranks=ranks)


def _members(served, name, backend):
    return [r[name, backend] for r in served["ranks"]
            if (name, backend) in r]


CASES = [("none", 1), ("one", 1), ("tp2", 2), ("tp4", 4)]


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("name,n", CASES)
def test_tp_decode_tokens_match_reference(served, name, n, backend):
    _, toks_ref, _ = served["ref"]["tp"]
    runs = _members(served, name, backend)
    assert len(runs) == n
    for run in runs:
        assert run["toks"] == toks_ref
    assert all(len(t) == 8 for t in toks_ref.values())


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("name,n", CASES)
def test_tp_stats_match_reference_plane(served, name, n, backend):
    """tp=1: the reference engine's TokenStats; tp=n: the reference
    StoragePlane(n_shards=n) repricing the port's own trace, per-shard
    stats included. Every rank reports the same."""
    from repro.core.clusters import HybridPlan as JPlan
    from repro.serving.storage_plane import StoragePlane as JPlane
    from repro.core.baselines import POWERINFER2
    rep_ref, _, jplan = served["ref"]["tp"]
    runs = _members(served, name, backend)
    run = runs[0]
    assert all(r["stats"] == run["stats"] for r in runs)
    assert run["n_shards"] == n
    if n == 1:
        want = [dataclasses.asdict(s) for s in rep_ref.stats]
    else:
        plane = JPlane(served["cfg"], served["params"], jplan,
                       spec=POWERINFER2, n_shards=n)
        want = [dataclasses.asdict(plane.step(tr, JPlan(**p), b, ctx))
                for tr, p, b, ctx in run["calls"]]
        plane.close()
    assert run["stats"] == want


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("name,n", CASES[2:])
def test_tp_per_shard_accounting(served, name, n, backend):
    """The golden's accounting: n shards each step, per-shard io_s
    summing to io_total_s, raw I/O no more than one device's, the summed
    effective time within 1.01x of one device's."""
    rep_ref, _, _ = served["ref"]["tp"]
    stats = _members(served, name, backend)[0]["stats"]
    s1 = rep_ref.stats[0]
    assert s1.n_shards == 1 and s1.shards is None
    for s in stats:
        assert s["n_shards"] == n and len(s["shards"]) == n
        assert abs(s["io_total_s"]
                   - sum(sh["io_s"] for sh in s["shards"])) < 1e-12
    assert stats[0]["io_s"] <= s1.io_s + 1e-12
    e1 = sum(s.effective_s for s in rep_ref.stats)
    en = sum(s["effective_s"] for s in stats)
    assert en <= e1 * 1.01, (e1, en)


def test_tp_traces_identical_across_ranks_and_backends(served):
    """Every rank of every group gathers the same trace, and it is the
    unsharded engine's."""
    base = [tr for tr, *_ in _members(served, "none", "jnp")[0]["calls"]]
    for name, _ in CASES:
        for backend in ("jnp", "pallas"):
            for run in _members(served, name, backend):
                got = [tr for tr, *_ in run["calls"]]
                assert len(got) == len(base)
                for a, b in zip(got, base):
                    np.testing.assert_array_equal(a, b)


def test_group_of_one_is_the_single_device_path(served):
    """A one-rank group takes the unsharded code: bit-identical logits,
    tokens, stats and traces, and no collective call."""
    for backend in ("jnp", "pallas"):
        a = _members(served, "none", backend)[0]
        b = _members(served, "one", backend)[0]
        np.testing.assert_array_equal(a["logits"], b["logits"])
        assert a["toks"] == b["toks"] and a["stats"] == b["stats"]
        assert b["collectives"] == 0


def test_attention_sharding_follows_the_heads(served):
    """4 heads and 2 kv heads: tp=2 holds one kv head per rank, tp=4
    replicates attention; both decode the reference's tokens (above),
    tp=2 with the extra all-reduce per layer."""
    assert {r["kv"] for r in _members(served, "tp2", "jnp")} == {1}
    assert {r["kv"] for r in _members(served, "tp4", "jnp")} == {2}
    L = served["cfg"].num_layers
    c2 = _members(served, "tp2", "jnp")[0]["collectives"]
    c4 = _members(served, "tp4", "jnp")[0]["collectives"]
    # per decode step: tp=2 three collectives per layer (attention's and
    # the FFN's all-reduce, the ids' gather) plus the token broadcast;
    # tp=4 two per layer plus the broadcast
    steps = len(_members(served, "tp2", "jnp")[0]["calls"])
    assert c2 > (3 * L + 1) * steps and c4 > (2 * L + 1) * steps


def test_gloo_ranks_step_eagerly(served):
    run = _members(served, "tp2", "pallas")[0]
    assert run["graphs"] is False and "gloo" in run["policy"]


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_dp2_tp2_tokens_match_reference_dp2(served, backend):
    """The dp golden: replica routing x tensor sharding leaves every
    token of the reference's dp=2 engine; each step carries its
    replica's two shards."""
    rep_ref, toks_ref, _ = served["ref"]["dp"]
    runs = _members(served, "dp2tp2", backend)
    assert len(runs) == 4
    for run in runs:
        assert run["toks"] == toks_ref
        assert all(s["n_shards"] == 2 and len(s["shards"]) == 2
                   for s in run["stats"])
        assert {s["replica"] for s in run["stats"]} == {0, 1}
        assert len(run["stats"]) == len(rep_ref.stats)
        assert [s["batch"] for s in run["stats"]] == \
            [s.batch for s in rep_ref.stats]


def test_spawned_serving_ranks_import_no_jax(served):
    assert all(r["foreign"] == [] for r in served["ranks"])


# ---------------------------------------------------------- refusals ----

def test_cuda_graphs_refused_over_gloo_ranks():
    cfg = tget_config("smollm-135m").reduced()
    plan = build_plan(cfg, hw=PHONE)
    from repro_torch.models.dense import make_model
    model = make_model(cfg, device="cpu")
    shard = ShardGroup(0, 2, None, torch.device("cpu"), (0, 1))
    with pytest.raises(ValueError, match="gloo collective"):
        ServeEngine(cfg, model, plan, shard=shard, cuda_graphs=True)


@pytest.mark.parametrize("argv,msg", [
    (["--ep", "2"], "has no experts"),
    (["--family", "moe", "--tp", "2", "--ep", "4"], "pass one"),
    (["--fleet", "2", "--tp", "2"], "nor --tp or --ep"),
    (["--family", "moe", "--backend", "pallas", "--ep", "2"],
     "expert dispatch"),
])
def test_cli_refuses_bad_mesh_flags(capsys, argv, msg):
    """The reference's four checks, each before any rank starts: --ep
    needs experts, --tp and --ep must agree, --fleet excludes the mesh
    flags, pallas refuses a moe arch (the ValueError the single-device
    CLI raises)."""
    from repro_torch.launch.serve import main
    raises = ValueError if "pallas" in argv else SystemExit
    with pytest.raises(raises) as err:
        main(["--reduced", "--device", "cpu"] + argv)
    text = str(err.value) if raises is ValueError \
        else capsys.readouterr().err
    assert msg in text


def test_cli_serves_tp2_on_gloo_ranks(capsys):
    from repro_torch.launch.serve import main
    main(["--reduced", "--device", "cpu", "--tp", "2", "--backend",
          "pallas", "--bon", "2", "--max-new", "3", "--temperature", "0"])
    out = capsys.readouterr().out
    assert "tp=2 (eager: gloo" in out and "6 tokens on cpu" in out


def test_load_checkpoint_keeps_each_ranks_slices(tmp_path):
    """A reference checkpoint at int8 storage, loaded for rank r of 2:
    the heads, the FFN rows with the predictor's columns and the
    quantized containers that rank holds, and every range each bucket's
    plan computes on it lies in its rows."""
    import jax
    from repro.checkpoint.ckpt import save_checkpoint
    from repro.configs import get_config
    from repro.core.planner import PHONE as JPHONE, build_plan as jbuild_plan
    from repro.models import dense as jdense
    from repro.serving.families import _dense_prepare
    from repro_torch.bridge import load_checkpoint
    from repro_torch.parallel import cold_range, hot_range, shard_layout
    jcfg = get_config("smollm-135m").reduced()
    params = _dense_prepare(jdense.make_model(jcfg).init(jax.random.key(5)),
                            jbuild_plan(jcfg, hw=JPHONE,
                                        storage_dtype="int8"))
    save_checkpoint(str(tmp_path), params, step=1)
    tree = jax.tree.map(np.asarray, params)
    cfg = tget_config("smollm-135m").reduced()
    plan = _plan(cfg, 4, (1, 2, 4, 8))
    dh = cfg.d_head
    for r in (0, 1):
        model = load_checkpoint(str(tmp_path), cfg, "cpu",
                                shard=ShardGroup(r, 2), plan=plan)
        rows = shard_layout(cfg, plan, r, 2).ffn
        ids = rows.ids
        assert model.kv_heads == 1
        for l, layer in enumerate(model.layers):
            ffn, at, t = layer.ffn, layer.attn, tree["layers"]
            for got, want in (
                    (ffn.w, t["ffn"]["w"][l][ids]),
                    (ffn.wq, t["ffn"]["wq"][l][ids]),
                    (ffn.wsc, t["ffn"]["wsc"][l][ids]),
                    (ffn.pred_A, t["ffn"]["pred"]["A"][l]),
                    (ffn.pred_B, t["ffn"]["pred"]["B"][l][:, ids]),
                    (at.wq, t["attn"]["wq"][l][:, r * 2 * dh:(r + 1) * 2
                                               * dh]),
                    (at.wk, t["attn"]["wk"][l][:, r * dh:(r + 1) * dh]),
                    (at.wo, t["attn"]["wo"][l][r * 2 * dh:(r + 1) * 2 * dh])):
                np.testing.assert_array_equal(got.numpy(), want)
        for p in plan.plans.values():
            for lo, hi in (hot_range(p.n_hot, r, 2),
                           cold_range(p, cfg.d_ff, r, 2)):
                assert rows.local(lo, hi).stop - rows.local(lo, hi).start \
                    == hi - lo
        assert len(ids) < cfg.d_ff
