"""The plain reference held against the port on the CPU at a reduced
size: served logits, the per-layer cluster picks and the storage
plane's TokenStats."""
import numpy as np
import pytest
import torch

from portbench.reference import plan as planmod
from portbench.reference.dense import DenseReference, Replayed
from portbench.reference.plane import FIELDS, PlaneReplay
from portbench.serve import ClosedLoop, Run, build_engine
from portbench.testing import TINY_MIX, tiny_model, run_tiny
from portbench.traffic import Stream
from portbench.weights import make_weights


def test_tiny_cell_is_correct_on_the_cpu(tmp_path):
    out, lines = run_tiny(tmp_path, seed=2 ** 31 + 11, seconds=2.0)
    c = out["checks"]
    assert out["correct"], lines
    assert c["logit_gap"]["value"] < 1e-4
    assert c["pick_gap"]["value"] == 0.0
    assert c["stats_off"]["value"] == 0.0
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["output_tok_s"]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    assert list(out)[-1] == "checks"
    assert lines[-1].startswith("check stats_off")


def _served(seed=5, steps=12):
    """Serve the tiny cell for `steps` engine steps, keeping the logits
    each live row got in each step."""
    m = tiny_model()
    cell = {"config": {"model": m, "serving": {
        "backend": "pallas", "storage_dtype": "fp16", "hardware": "PHONE",
        "offload_ratio": 0.5}}, "traffic": TINY_MIX}
    engine = build_engine(cell, seed, torch.device("cpu"))
    run = Run(cell=cell, seed=seed)
    loop = ClosedLoop(engine, Stream(TINY_MIX, m["vocab_size"], seed), run,
                      TINY_MIX["clients"])
    loop.start()
    got = {}
    for _ in range(steps):
        s = loop.step()
        live = [u for u in s.uids if u not in s.finished]
        for u, row in zip(live, engine.arena.rows_for(live)):
            got[u, s.index] = engine._last[row].float().clone()
    return engine, run, got


def test_reference_logits_and_picks_follow_the_port():
    engine, run, got = _served()
    m = run.model
    order, plans = planmod.dense_plan(m, 3)
    assert np.array_equal(order, engine.plan.neuron_order)
    p = plans[planmod.bucket_of(TINY_MIX["clients"])]
    steps = {s.index: (s.trace, p) for s in run.steps}
    ref = DenseReference(m, make_weights(m, run.seed, "cpu"), order, steps)
    reqs = list(run.requests.values())
    reps = [Replayed(r.prompt, r.tokens, r.token_steps) for r in reqs if
            r.tokens]
    block = [s.index for s in run.steps[-3:]]
    ref.run(reps, keep_steps=frozenset(block))
    n = 0
    for r, rep in zip([r for r in reqs if r.tokens], reps):
        # the logits after the step that fed token j predict token j + 1
        for j, s in enumerate(r.token_steps[:len(r.tokens) - 1]):
            torch.testing.assert_close(rep.logits[j + 1],
                                       got[r.uid, s][:m["vocab_size"]],
                                       rtol=1e-4, atol=1e-4)
            n += 1
    assert n > 20
    by_uid = {r.uid: rep for r, rep in zip([r for r in reqs if r.tokens],
                                           reps)}
    for s in block:
        for l in range(m["num_layers"]):
            x = torch.stack([by_uid[u].ffn_in[s][l]
                             for u in run.steps[s].uids])
            _, top = ref.union_picks(l, x, steps[s][1])
            assert sorted(top.reshape(-1).tolist()) == \
                sorted(run.steps[s].trace[l].reshape(-1).tolist())


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_replay_prices_as_the_port(seed):
    from repro_torch.core.baselines import POWERINFER2
    from repro_torch.core.planner import PHONE
    from repro_torch.serving.storage_plane import StoragePlane
    from portbench.serve import port_config
    m = tiny_model()
    m["num_layers"] = 4
    cfg = port_config(m)
    from repro_torch.core.planner import build_plan
    from repro_torch.models import dense
    model = dense.make_model(cfg, "cpu", seed=0)
    plan = build_plan(cfg, None, hw=PHONE)
    port = StoragePlane(cfg, model, plan, spec=POWERINFER2,
                        offload_ratio=0.5)
    order, plans = planmod.dense_plan(m, 3)
    mine = PlaneReplay(m, 3, plans[1], planmod.PHONE, 0.5)
    rng = np.random.default_rng(seed)
    for _ in range(60):
        b = int(rng.integers(1, 33))
        p = plans[planmod.bucket_of(b)]
        nc = (m["d_ff"] - p.n_hot) // p.cs
        trace = np.stack([rng.permutation(nc)[:p.kc].reshape(1, -1)
                          for _ in range(m["num_layers"])]).astype(np.int32)
        ctx = float(rng.uniform(8, 64))
        a = port.step(trace, plan.plan_for_batch(planmod.bucket_of(b)), b,
                      ctx)
        want = mine.step(trace, p, b, ctx)
        assert {f: getattr(a, f) for f in FIELDS} == want
    port.close()
