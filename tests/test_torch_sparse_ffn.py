"""The port's hybrid FFN and planner against the JAX package's.

ffn_hybrid runs on both backends with an active mask, on the same numpy
weights; selected ids must be identical and outputs agree within 2e-4
(fp32). The plan the port builds must equal the JAX one exactly, and
plans cross between the packages through ExecutionPlan's JSON.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import planner as jplanner
from repro.core.clusters import make_plan as jmake_plan
from repro.core.sparse_ffn import ffn_hybrid as jffn_hybrid
from repro_torch.configs import get_config as tget_config
from repro_torch.core import planner as tplanner
from repro_torch.core.clusters import make_plan as tmake_plan
from repro_torch.core.sparse_ffn import ffn_hybrid as tffn_hybrid

TOL = dict(rtol=2e-4, atol=2e-4)


def _weights(N=512, R=3, D=256, r=16, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N, R, D)) * 0.1).astype(np.float32)
    A = (rng.standard_normal((D, r)) * 0.2).astype(np.float32)
    B = (rng.standard_normal((r, N)) * 0.2).astype(np.float32)
    return w, A, B


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("mode", ["cats", "relu"])
def test_ffn_hybrid_matches_jax(backend, groups, mode):
    w, A, Bm = _weights()
    rng = np.random.default_rng(groups)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    mask = np.array([True, False, True, True])
    kw = dict(n_neurons=512, hot_ratio=0.25, cold_active_ratio=0.3,
              cluster_size=32, groups=groups, backend=backend)
    jp, tp = jmake_plan(**kw), tmake_plan(**kw)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    yj, ij = jffn_hybrid({"w": jnp.asarray(w), "pred": {
        "A": jnp.asarray(A), "B": jnp.asarray(Bm)}}, jnp.asarray(x),
        "silu", mode, jp, return_indices=True,
        active_mask=jnp.asarray(mask))
    yt, it = tffn_hybrid(torch.from_numpy(w), (torch.from_numpy(A),
                                               torch.from_numpy(Bm)),
                         torch.from_numpy(x), "silu", mode, tp,
                         return_indices=True,
                         active_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_backends_agree_on_all_masked_batch():
    """No live row: both port backends pick [0, kc) per group."""
    w, A, Bm = _weights(seed=3)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 256)).astype(np.float32))
    plan = tmake_plan(512, 0.25, 0.3, 32, groups=2)
    dead = torch.zeros(2, dtype=torch.bool)
    ids = [tffn_hybrid(torch.from_numpy(w), (torch.from_numpy(A),
                                             torch.from_numpy(Bm)), x,
                       "silu", "cats", dataclasses.replace(plan, backend=b),
                       return_indices=True, active_mask=dead)[1]
           for b in ("jnp", "pallas")]
    kc = plan.clusters_per_group
    assert ids[0].tolist() == ids[1].tolist() == [list(range(kc))] * 2


@pytest.mark.parametrize("reduced", [True, False])
def test_build_plan_matches_jax(reduced):
    jc, tc = jget_config("smollm-135m"), tget_config("smollm-135m")
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    jp = jplanner.build_plan(jc, hw=jplanner.PHONE, backend="pallas")
    tp = tplanner.build_plan(tc, hw=tplanner.PHONE, backend="pallas")
    np.testing.assert_array_equal(tp.neuron_order, jp.neuron_order)
    np.testing.assert_array_equal(tp.frequencies, jp.frequencies)
    assert {b: dataclasses.asdict(p) for b, p in tp.plans.items()} == \
        {b: dataclasses.asdict(p) for b, p in jp.plans.items()}
    assert dataclasses.asdict(tp.hardware) == dataclasses.asdict(jp.hardware)


def test_plan_json_crosses_packages(tmp_path):
    jc = jget_config("smollm-135m").reduced()
    jp = jplanner.build_plan(jc, hw=jplanner.PHONE)
    jp.save(tmp_path / "jax.json")
    tp = tplanner.ExecutionPlan.load(tmp_path / "jax.json")
    np.testing.assert_array_equal(tp.neuron_order, jp.neuron_order)
    assert {b: dataclasses.asdict(p) for b, p in tp.plans.items()} == \
        {b: dataclasses.asdict(p) for b, p in jp.plans.items()}
    tp.save(tmp_path / "torch.json")
    back = jplanner.ExecutionPlan.load(tmp_path / "torch.json")
    assert back.plans == jp.plans and back.hardware == jp.hardware


def test_hardware_profile_has_no_defaults():
    with pytest.raises(TypeError):
        tplanner.HardwareProfile(name="x")
