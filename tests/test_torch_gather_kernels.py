"""The port's cluster_gather_ffn, cluster_gather_ffn_grouped and
dense_ffn (their plain versions, which the wrappers run for CPU tensors)
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs, over the reference's own sweep (tests/test_kernels.py):
four activations, four shapes, fp32 and bf16, within its tolerances
(2e-4 in fp32, 5e-2 in bf16). The port also takes what the reference's
asserts refuse (dense_ffn with N not a multiple of block_n) and raises on
an activation it does not know, where the reference maps it to gelu.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.bridge import _tensor
from repro_torch.kernels import ops as tops

ACTS = [("silu", 3), ("relu2", 3), ("gelu", 2), ("geglu", 3)]
SHAPES = [(1, 64, 256, 32), (4, 128, 512, 64), (8, 256, 1024, 128),
          (2, 384, 768, 128)]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-4, rtol=2e-4)


def _inputs(B, D, N, R, dtype, seed):
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(rng.standard_normal((B, D)) * 0.5, jdt)
    w = jnp.asarray(rng.standard_normal((N, R, D)) * 0.1, jdt)
    return x, w, _tensor(np.asarray(x)), _tensor(np.asarray(w))


def _close(yt, yj, dtype):
    assert yt.dtype == (torch.bfloat16 if dtype == "bfloat16"
                        else torch.float32)
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj, np.float32), **_tol(dtype))


@pytest.mark.parametrize("act,R", ACTS)
@pytest.mark.parametrize("B,D,N,cs", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cluster_gather_ffn_matches_jax(act, R, B, D, N, cs, dtype):
    x, w, xt, wt = _inputs(B, D, N, R, dtype, seed=B * N + cs)
    n_clusters = N // cs
    k = max(1, n_clusters // 2)
    idx = np.random.default_rng(cs).permutation(n_clusters)[:k] \
        .astype(np.int32)
    yj = jops.cluster_gather_ffn(x, w, jnp.asarray(idx), activation=act,
                                 cluster_size=cs, interpret=True)
    yt = tops.cluster_gather_ffn(xt, wt, torch.from_numpy(idx),
                                 activation=act, cluster_size=cs)
    _close(yt, yj, dtype)


@pytest.mark.parametrize("act,R", ACTS[:2])
@pytest.mark.parametrize("B,D,N,cs", SHAPES[:3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_ffn_matches_jax(act, R, B, D, N, cs, dtype):
    x, w, xt, wt = _inputs(B, D, N, R, dtype, seed=7)
    yj = jops.dense_ffn(x, w, activation=act, block_n=cs, interpret=True)
    yt = tops.dense_ffn(xt, wt, activation=act, block_n=cs)
    _close(yt, yj, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_ffn_any_n(dtype):
    """N = 1472 does not divide the default block_n = 512, which the
    reference asserts; the port takes it (the reference, given a block
    that divides N, is the yardstick)."""
    x, w, xt, wt = _inputs(3, 64, 1472, 3, dtype, seed=1)
    yj = jops.dense_ffn(x, w, activation="silu", block_n=64, interpret=True)
    yt = tops.dense_ffn(xt, wt, activation="silu")
    _close(yt, yj, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cluster_gather_ffn_grouped_matches_jax(dtype):
    G, nc_g, cs, D, B = 3, 4, 32, 64, 2
    x, w, xt, wt = _inputs(B, D, G * nc_g * cs, 3, dtype, seed=2)
    wc = w.reshape(G, nc_g, cs, 3, D)
    cidx = np.array([[0, 2], [1, 3], [0, 1]], np.int32)
    yj = jops.cluster_gather_ffn_grouped(x, wc, jnp.asarray(cidx),
                                         activation="silu", interpret=True)
    yt = tops.cluster_gather_ffn_grouped(
        xt, wt.reshape(G, nc_g, cs, 3, D), torch.from_numpy(cidx),
        activation="silu")
    _close(yt, yj, dtype)


def test_gather_of_every_cluster_equals_dense():
    _, _, xt, wt = _inputs(2, 128, 512, 3, "float32", seed=0)
    idx = torch.arange(8, dtype=torch.int32)
    y = tops.cluster_gather_ffn(xt, wt, idx, activation="silu",
                                cluster_size=64)
    yd = tops.dense_ffn(xt, wt, activation="silu", block_n=64)
    torch.testing.assert_close(y, yd, atol=1e-4, rtol=1e-4)


def test_gather_order_invariance():
    _, _, xt, wt = _inputs(2, 128, 512, 3, "float32", seed=0)
    idx = torch.tensor([0, 2, 5, 7], dtype=torch.int32)
    y1 = tops.cluster_gather_ffn(xt, wt, idx, activation="silu",
                                 cluster_size=64)
    y2 = tops.cluster_gather_ffn(xt, wt, idx.flip(0), activation="silu",
                                 cluster_size=64)
    torch.testing.assert_close(y1, y2, atol=1e-4, rtol=1e-4)


def test_unknown_activation_raises():
    _, _, xt, wt = _inputs(2, 64, 256, 3, "float32", seed=0)
    idx = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown activation"):
        tops.cluster_gather_ffn(xt, wt, idx, activation="swish",
                                cluster_size=32)
    with pytest.raises(ValueError, match="unknown activation"):
        tops.cluster_gather_ffn_grouped(xt, wt.reshape(2, 4, 32, 3, 64),
                                        idx.reshape(2, 1),
                                        activation="tanh")
    with pytest.raises(ValueError, match="unknown activation"):
        tops.dense_ffn(xt, wt, activation="relu")
    with pytest.raises(ValueError, match="not a multiple"):
        tops.cluster_gather_ffn(xt, wt, idx, activation="silu",
                                cluster_size=48)


@pytest.mark.parametrize("B", [1, 17, 300, 4 * 65535 + 5])
@pytest.mark.parametrize("K,R", [(1536, 3), (768, 3), (1472, 2)])
@pytest.mark.parametrize("es", [2, 4])
def test_gather_plan_covers_every_neuron_once(B, K, R, es):
    """gather_plan's tiles: gate_up's blocks take consecutive runs of
    neurons_per_block neurons that end at or past K in the last block
    only; down's splits are consecutive, non-empty runs that partition
    [0, K), at most one 8-block cluster; every tile width is a multiple of
    the mma depth (16) and every block's shared memory fits the cap."""
    p = tops.gather_plan(B, 576, K, R, es)
    npb = p.neurons_per_block
    assert (p.gate_blocks - 1) * npb < K <= p.gate_blocks * npb
    runs = p.split_ranges()
    assert runs[0][0] == 0 and runs[-1][1] == K
    assert all(a < b for a, b in runs)
    assert all(r[1] == n[0] for r, n in zip(runs, runs[1:]))
    assert 1 <= p.splits <= 8 and p.split % 16 == 0
    assert p.chunk % 16 == 0 and p.down_chunk % 16 == 0
    assert max(p.gate_smem, p.down_smem) <= 120 * 1024
    assert 1 <= p.gate_groups <= 65535


def test_gather_plan_scratch_at_b300():
    """At B = 300 and the full-width shapes (D 576, N 1536, R 3, bf16) the
    call's only scratch is H (0.9 MB); down's split partials stay in its
    clusters' shared memory."""
    p = tops.gather_plan(300, 576, 1536, 3, 2)
    assert p.scratch_bytes == 300 * 1536 * 2 < 2**20
    assert p.splits > 1 and p.down_blocks >= 264
