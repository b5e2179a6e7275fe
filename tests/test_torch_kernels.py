"""The port's fused_cold_ffn (its plain version, which the wrapper runs
for CPU tensors) against the JAX package's Pallas kernel in interpret
mode, on the same numpy inputs.

Selected ids must be bit-identical; y must agree within the reference's
own kernel tolerances (tests/test_kernels.py): 2e-4 in fp32, 5e-2 in
bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.sparse_ffn import _top_k_ids
from repro_torch.kernels import ops as tops

ACTS = [("silu", 3), ("relu2", 3), ("gelu", 2), ("geglu", 3)]
# (B, D, r, cs, G, nc_g, kc)
SHAPES = [(2, 64, 16, 32, 1, 8, 3), (4, 128, 16, 64, 2, 4, 2),
          (1, 64, 8, 32, 3, 4, 4)]


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-4, rtol=2e-4)


def _inputs(B, D, r, cs, G, nc_g, R, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, D)) * 0.5).astype(np.float32)
    wc = (rng.standard_normal((G, nc_g, cs, R, D)) * 0.1).astype(np.float32)
    A = (rng.standard_normal((D, r)) * 0.3).astype(np.float32)
    Bp = (rng.standard_normal((r, G * nc_g * cs)) * 0.3).astype(np.float32)
    return x, wc, A, Bp


def _both(x, wc, A, Bp, act, mode, kc, mask=None, dtype="float32"):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jm = None if mask is None else jnp.asarray(mask)
    yj, ij = jops.fused_cold_ffn(
        jnp.asarray(x, jdt), jnp.asarray(wc, jdt), jnp.asarray(A, jdt),
        jnp.asarray(Bp, jdt), activation=act, mode=mode, kc=kc,
        active_mask=jm, interpret=True)
    tm = None if mask is None else torch.from_numpy(mask)
    t = lambda a: torch.from_numpy(a).to(tdt)
    yt, it = tops.fused_cold_ffn(t(x), t(wc), t(A), t(Bp), activation=act,
                                 mode=mode, kc=kc, active_mask=tm)
    return (np.asarray(yj, np.float32), np.asarray(ij)), \
        (yt.float().numpy(), it.numpy())


@pytest.mark.parametrize("act,R", ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", ["relu", "cats"])
def test_fused_cold_ffn_matches_jax(act, R, shape, mode):
    B, D, r, cs, G, nc_g, kc = shape
    x, wc, A, Bp = _inputs(B, D, r, cs, G, nc_g, R, seed=B * D + cs)
    (yj, ij), (yt, it) = _both(x, wc, A, Bp, act, mode, kc)
    assert it.dtype == np.int32 and it.shape == (G, kc)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(yt, yj, **_tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dead", ["some", "all"])
def test_fused_cold_ffn_masked_rows(dtype, dead):
    """Masked rows never vote in the batch union; an all-masked batch
    picks [0, kc) in every group on both sides."""
    B, D, r, cs, G, nc_g, kc = 4, 64, 16, 32, 2, 4, 2
    x, wc, A, Bp = _inputs(B, D, r, cs, G, nc_g, 3, seed=11)
    mask = np.array([True, False, True, False]) if dead == "some" \
        else np.zeros(B, bool)
    (yj, ij), (yt, it) = _both(x, wc, A, Bp, "silu", "cats", kc, mask,
                               dtype)
    np.testing.assert_array_equal(it, ij)
    if dead == "all":
        assert it.tolist() == [[0, 1], [0, 1]]
    np.testing.assert_allclose(yt, yj, **_tol(dtype))


def test_fused_cold_ffn_constructed_tie():
    """The top cluster's predictor columns are copied into another
    cluster, so the two tie exactly for first place: both sides must
    take the lower id first."""
    B, D, r, cs, G, nc_g, kc = 3, 64, 8, 32, 1, 6, 3
    x, wc, A, Bp = _inputs(B, D, r, cs, G, nc_g, 3, seed=4)
    s = (x.astype(np.float64) @ A) @ Bp
    top = int(s.max(0).reshape(nc_g, cs).max(-1).argmax())
    twin = (top + 2) % nc_g
    Bp[:, twin * cs:(twin + 1) * cs] = Bp[:, top * cs:(top + 1) * cs]
    (yj, ij), (yt, it) = _both(x, wc, A, Bp, "silu", "relu", kc)
    assert it[0, :2].tolist() == sorted([top, twin])
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(yt, yj, **_tol("float32"))


def test_plain_chain_top_k_ties_match_lax():
    """The jnp-backend chain's selection (stable descending sort) gives
    lax.top_k's ids on ties and on an all -inf row."""
    import jax
    cs = np.array([[0.5, 2.0, 1.0, 2.0, 2.0, -1.0],
                   [-np.inf] * 6, [3.0, 3.0, 3.0, 3.0, 1.0, 3.0]],
                  np.float32)
    for kc in (1, 3, 6):
        _, ij = jax.lax.top_k(jnp.asarray(cs), kc)
        it = _top_k_ids(torch.from_numpy(cs), kc)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_fused_cold_ffn_rejects_quantized_operands():
    x, wc, A, Bp = (torch.from_numpy(a) for a in
                    _inputs(1, 64, 8, 32, 1, 2, 3, seed=0))
    with pytest.raises(NotImplementedError, match="quantized-storage"):
        tops.fused_cold_ffn(x, wc, A, Bp, activation="silu", kc=1,
                            wq=wc.to(torch.int8))
