"""Prefill + greedy decode on reduced smollm-135m (fp32): the port and the
JAX package, on the same weights and plan, give identical tokens and
identical (L, G, kc) cluster-id traces on both cold-path backends.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.planner import PHONE as JPHONE, build_plan as jbuild_plan
from repro.models import dense as jdense
from repro.serving.families import _dense_prepare
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.core.planner import PHONE, build_plan
from repro_torch.models import dense as tdense

N_STEPS = 6


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("smollm-135m").reduced()
    tcfg = tget_config("smollm-135m").reduced()
    params = jdense.make_model(jcfg).init(jax.random.key(0))
    jplan = jbuild_plan(jcfg, hw=JPHONE)
    params = _dense_prepare(params, jplan)
    tree = jax.tree.map(np.asarray, params)
    model = params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, params, jplan, tcfg, model, build_plan(tcfg, hw=PHONE)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_prefill_and_decode_match_jax(models, backend):
    import dataclasses
    jcfg, params, jplan, tcfg, model, tplan = models
    B, S = 3, 8
    T = S + N_STEPS
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.array([True, True, False])       # row 2 is a dead lane
    jp = dataclasses.replace(jplan.plan_for_batch(B), backend=backend)
    tp = dataclasses.replace(tplan.plan_for_batch(B), backend=backend)

    jm = jdense.make_model(jcfg)
    jlog, jcache = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                                   max_len=T))(
        params, jnp.asarray(toks))
    jstep = jax.jit(lambda p, t, c, m: jdense.make_decode_step(
        jcfg, collect_indices=True)(p, t, c, jp, m))
    tlog, tcache = tdense.prefill(model, torch.from_numpy(toks), max_len=T)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=1e-4, atol=1e-4)
    for k in ("kv_pos", "length"):
        np.testing.assert_array_equal(tcache[k].numpy(),
                                      np.asarray(jcache[k]))

    tstep = tdense.make_decode_step(tcfg, collect_indices=True)
    jm_, tm_ = jnp.asarray(mask), torch.from_numpy(mask)
    for _ in range(N_STEPS):
        jt = np.asarray(jnp.argmax(jlog[:, -1], axis=-1), np.int32)
        tt = tlog[:, -1].argmax(dim=-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(tt, jt)
        jlog, jcache, jtrace = jstep(params, jnp.asarray(jt)[:, None],
                                     jcache, jm_)
        tlog, tcache, ttrace = tstep(model, torch.from_numpy(tt)[:, None],
                                     tcache, tp, tm_)
        assert ttrace.shape == (tcfg.num_layers, tp.groups,
                                tp.clusters_per_group)
        np.testing.assert_array_equal(ttrace.numpy(), np.asarray(jtrace))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-4, atol=1e-4)
