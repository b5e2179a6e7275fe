"""The port's numerics leaves against the JAX package's, on the same
numpy inputs in fp32: rms_norm, activation_fn, RoPE, decode and prefill
attention, predict_scores.

Tolerance 1e-5 (relative and absolute): both sides compute in fp32 and
differ only in the order of their sums and in their libm.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictor as jpred
from repro.models import attention as jatt
from repro.models import modules as jmod
from repro_torch.core import predictor as tpred
from repro_torch.models import attention as tatt
from repro_torch.models import modules as tmod

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def test_rms_norm():
    rng = _rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    _close(tmod.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jmod.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("name", ["silu", "relu2", "gelu", "geglu"])
def test_activation_fn(name):
    x = np.linspace(-6, 6, 97).astype(np.float32)
    _close(tmod.activation_fn(name)(torch.from_numpy(x)),
           jmod.activation_fn(name)(jnp.asarray(x)))


def test_activation_fn_rejects_unknown():
    with pytest.raises(ValueError):
        tmod.activation_fn("swish")


@pytest.mark.parametrize("batched", [False, True])
def test_rope(batched):
    rng = _rng(2)
    B, S, H, dh = 2, 7, 3, 16
    x = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    pos = np.arange(S) + 5
    if batched:
        pos = np.stack([pos, pos + 11])[..., None][:, :, 0]   # (B, S)
    at = tatt.rope_angles(torch.from_numpy(pos), dh // 2, 10000.0)
    aj = jatt.rope_angles(jnp.asarray(pos), dh // 2, 10000.0)
    _close(at, aj)
    _close(tatt.apply_rotary(torch.from_numpy(x), at),
           jatt.apply_rotary(jnp.asarray(x), aj))


def test_decode_attention():
    rng = _rng(3)
    B, T, H, KV, dh = 3, 12, 4, 2, 16
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, dh)).astype(np.float32)
    kv_pos = np.full((B, T), -1, np.int32)
    kv_pos[0, :5] = np.arange(5)
    kv_pos[1, :9] = np.arange(9)
    kv_pos[2] = np.arange(T) + 3            # wrapped ring: some slots > pos
    pos = np.array([4, 8, 10], np.int32)
    t = tatt.decode_attention(*(torch.from_numpy(a) for a in
                                (q, k, v, kv_pos, pos)))
    j = jatt.decode_attention(*(jnp.asarray(a) for a in
                                (q, k, v, kv_pos, pos)))
    _close(t, j)


@pytest.mark.parametrize("S,kv_block", [(16, 1024), (24, 8)])
def test_prefill_attention(S, kv_block):
    rng = _rng(4)
    B, H, KV, dh = 2, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, n, dh)).astype(np.float32)
               for n in (H, KV, KV))
    t = tatt.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True, kv_block=kv_block)
    j = jatt.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=True, kv_block=kv_block)
    _close(t, j)


def test_predict_scores():
    rng = _rng(5)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    A = rng.standard_normal((64, 16)).astype(np.float32)
    B = rng.standard_normal((16, 96)).astype(np.float32)
    t = tpred.predict_scores(torch.from_numpy(A), torch.from_numpy(B),
                             torch.from_numpy(x))
    assert t.dtype == torch.float32
    _close(t, jpred.predict_scores({"A": jnp.asarray(A),
                                    "B": jnp.asarray(B)}, jnp.asarray(x)),
           rtol=1e-5, atol=1e-4)
