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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dead", ["none", "some"])
@pytest.mark.parametrize("B", [65, 96])
def test_fused_cold_ffn_any_batch(B, dead, dtype):
    """The reference's BlockSpec takes any B: past 64 rows the port's
    fused_cold_ffn picks the same ids as the Pallas kernel and gives the
    same y, with every row live or every third row dead."""
    D, r, cs, G, nc_g, kc = 64, 16, 32, 1, 8, 2
    x, wc, A, Bp = _inputs(B, D, r, cs, G, nc_g, 3, seed=B)
    mask = None if dead == "none" else np.arange(B) % 3 != 1
    (yj, ij), (yt, it) = _both(x, wc, A, Bp, "silu", "cats", kc, mask,
                               dtype)
    assert yt.shape == (B, D)
    np.testing.assert_array_equal(it, ij)
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


_FMIN = np.finfo(np.float32).min
# (G, nc_g) cluster scores heavy with ties: a tie at the top, a group
# that is mostly -FLT_MAX (a masked row's value), and a group that ties
# throughout
TIED_CLUSTER_SCORES = np.array(
    [[1.0, 2.0, 2.0, _FMIN, 2.0, 1.0],
     [_FMIN, _FMIN, 0.5, _FMIN, 0.5, _FMIN],
     [-3.0, -3.0, -3.0, -3.0, -3.0, -3.0]], np.float32)


@pytest.mark.parametrize("masked", [False, True],
                         ids=["live", "all-masked"])
@pytest.mark.parametrize("kc", range(1, 7))
def test_select_clusters_ties_match_lax_and_pallas(kc, masked):
    """The port's select_clusters (the plain version the card holds the
    kernel's selection to) gives jax.lax.top_k's ids on tie-heavy cluster
    scores with -FLT_MAX entries, for every kc up to nc_g, and so does
    the Pallas kernel in interpret mode fed inputs whose cluster scores
    are exactly these; an all-masked batch sees -FLT_MAX everywhere."""
    import jax
    from repro_torch.kernels.ref import select_clusters
    cscore = np.full_like(TIED_CLUSTER_SCORES, _FMIN) if masked \
        else TIED_CLUSTER_SCORES
    G, nc_g = cscore.shape
    _, ij = jax.lax.top_k(jnp.asarray(cscore), kc)
    it = select_clusters(torch.from_numpy(cscore), kc)
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # one row x = e_0 and A = e_0 e_0^T make h = e_0, so every score is
    # exactly Bp[0, n]; each cluster's columns carry its score
    B, D, r, cs = 1, 64, 8, 32
    x, wc, A, Bp = _inputs(B, D, r, cs, G, nc_g, 3, seed=21)
    x[:] = 0.0
    x[0, 0] = 1.0
    A[:] = 0.0
    A[0, 0] = 1.0
    Bp[0] = np.repeat(TIED_CLUSTER_SCORES.reshape(-1), cs)
    mask = np.full(B, not masked)
    (_, ip), (_, itk) = _both(x, wc, A, Bp, "silu", "relu", kc, mask)
    np.testing.assert_array_equal(ip, np.asarray(ij))
    np.testing.assert_array_equal(itk, np.asarray(ij))


def test_fused_cold_ffn_rejects_quantized_operands():
    """Quantized operands that do not fit the kernel are refused: codes
    that are not int8, scales missing or of the wrong shape, a sidecar
    without codes (well-formed ones are held to the reference in
    test_torch_quant.py)."""
    from repro_torch.quant.storage import quantize_bundles
    x, wc, A, Bp = (torch.from_numpy(a) for a in
                    _inputs(1, 64, 8, 32, 1, 2, 3, seed=0))
    q = quantize_bundles(wc, "int4-mixed")
    call = lambda **kw: tops.fused_cold_ffn(x, wc, A, Bp, activation="silu",
                                            kc=1, **kw)
    with pytest.raises(TypeError, match="wq is torch.float32"):
        call(wq=wc, wsc=q["wsc"])
    with pytest.raises(ValueError, match="per-row scales"):
        call(wq=q["wq"])
    with pytest.raises(ValueError, match="wsc has shape"):
        call(wq=q["wq"], wsc=q["wsc"][..., :2])
    with pytest.raises(ValueError, match="without the int8 codes"):
        call(wout=q["wout"])
    with pytest.raises(TypeError, match="wout is torch.float32"):
        call(wq=q["wq"], wsc=q["wsc"], wout=q["wout"].float())


@pytest.mark.parametrize("G", [1, 2])
def test_cats_zero_gates_flags_a_zero_score(G):
    """kernels/ref.py::cats_zero_gates flags a (row, picked neuron) pair
    whose CATS score is exactly 0 by construction (h = x.A = (1, 1) against
    a Bp column (1, -1): products of size 1, sum 0), and leaves scores far
    from 0 alone, in every group."""
    from repro_torch.kernels.ref import cats_zero_gates
    nc_g, cs, D, r = 2, 2, 4, 2
    x = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]])
    A = torch.tensor([[1.0, 1.0], [2.0, -1.0], [0.0, 0.0], [0.0, 0.0]])
    # per group, cluster 1's neurons: (1, -1) -> scores 0 and 3 for rows
    # 0 and 1; (1, 1) -> 2 and 1; cluster 0's are never picked
    block = torch.tensor([[5.0, 5.0, 1.0, 1.0], [5.0, 5.0, -1.0, 1.0]])
    Bp = block.repeat(1, G)
    wc = torch.zeros((G, nc_g, cs, 3, D))
    idx = torch.ones((G, 1), dtype=torch.int32)
    pairs = cats_zero_gates(idx, x, wc, A, Bp)
    assert pairs.tolist() == [[0, g * cs] for g in range(G)]
    # a score that is small but far above fp32 rounding is not flagged
    Bp2 = Bp.clone()
    Bp2[1, 2::4] = -0.999
    assert cats_zero_gates(idx, x, wc, A, Bp2).tolist() == []
