"""The CUDA kernels (fused_cold_ffn in its fp and quant modes,
cluster_gather_ffn, dense_ffn) against their plain PyTorch versions, on
the card; the decode step's CUDA graphs against the eager step, the moe
family's included; the moe FFN on the card against the CPU; the offline
planner's profile and calibration on the card against the CPU, the
profiled engine graphed and eager, and calibration under captured
graphs; fused_cold_ffn on each gloo rank's own groups, ranks sharing
the card; a train step on the card against the CPU and the checkpoint
round trip on the card; compute-sanitizer's racecheck over
fused_cold_ffn; the shadow tier (every registry entry clean under the
shadow build, its outputs bit-identical to the normal build's) and its
mutants (each fires exactly its rules). Marked `gpu`: without a card
each test skips with a reason.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's own (tests/test_kernels.py): 2e-4 in fp32,
5e-2 in bf16. Ids must be identical except where the two clusters'
scores, recomputed in fp64, tie within fp32 rounding. In CATS mode a row
whose gate sits on a score within fp32 rounding of 0 (cats_zero_gates)
must match the plain version with those gates forced on or off.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    cats_zero_gates, cluster_gather_ffn_ref, dense_ffn_ref,
    fused_cold_ffn_ref, near_threshold, pick_disagreements, picked_ffn)
from repro_torch.quant.storage import quantize_bundles

# (B, D, r, cs, G, nc_g, R, kc, activation, mode, dtype)
CASES = [
    (1, 576, 64, 64, 1, 23, 3, 1, "silu", "cats", torch.bfloat16),
    (4, 576, 64, 64, 1, 23, 3, 1, "silu", "cats", torch.bfloat16),
    (32, 576, 64, 64, 1, 23, 3, 1, "silu", "cats", torch.bfloat16),
    (64, 576, 64, 64, 1, 23, 3, 1, "silu", "cats", torch.bfloat16),
    (8, 576, 64, 64, 1, 23, 3, 4, "silu", "cats", torch.bfloat16),
    (8, 576, 64, 64, 1, 23, 3, 23, "silu", "cats", torch.bfloat16),
    (16, 576, 64, 64, 2, 11, 3, 3, "silu", "cats", torch.bfloat16),
    (16, 576, 64, 64, 1, 23, 3, 2, "silu", "cats", torch.float32),
    (5, 200, 16, 32, 2, 5, 2, 2, "gelu", "relu", torch.float32),
    (7, 256, 16, 32, 1, 8, 3, 3, "relu2", "relu", torch.bfloat16),
    (3, 320, 32, 48, 3, 4, 3, 2, "geglu", "cats", torch.float32),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, D, r, cs, G, nc_g, R, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    Nc = G * nc_g * cs
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device, dtype)
    x = t(rng.standard_normal((B, D)) * 0.5)
    wc = t(rng.standard_normal((G, nc_g, cs, R, D)) * 0.1)
    A = t(rng.standard_normal((D, r)) / np.sqrt(D))
    Bp = t(rng.standard_normal((r, Nc)) / np.sqrt(r))
    return x, wc, A, Bp


def _check(x, wc, A, Bp, mask, act, mode, kc, **quant):
    tol = 5e-2 if x.dtype == torch.bfloat16 else 2e-4
    before = ops.fused_cold_ffn.launches
    y, idx = ops.fused_cold_ffn(x, wc, A, Bp, activation=act, mode=mode,
                                kc=kc, active_mask=mask, **quant)
    torch.cuda.synchronize()
    assert ops.fused_cold_ffn.launches == before + 1
    m = torch.ones(x.shape[0], device=x.device) if mask is None \
        else mask.float()
    yr, ir = fused_cold_ffn_ref(x, wc, A, Bp, m, activation=act,
                                cats=mode == "cats", kc=kc, **quant)
    near, real = pick_disagreements(idx, ir, x, wc, A, Bp, m)
    assert not real, f"picks differ beyond fp32 ties: {real}"
    if near:
        return
    pairs = cats_zero_gates(idx, x, wc, A, Bp) if mode == "cats" \
        else torch.empty((0, 2), dtype=torch.long)
    keep = torch.ones(x.shape[0], dtype=torch.bool)
    keep[pairs[:, 0]] = False
    keep = keep.to(x.device)
    torch.testing.assert_close(y[keep], yr[keep], atol=tol, rtol=tol)
    if len(pairs):
        _gate_variants_match(y, x, wc, A, Bp, idx, pairs, act, tol, quant)


def _gate_variants_match(y, x, wc, A, Bp, idx, pairs, act, tol, quant):
    """Each row with m gates on a score within fp32 rounding of 0 matches
    the plain version with those gates forced on or off, in one of its
    2^m variants; m above 4 fails."""
    by_row = {}
    for r, k in pairs.tolist():
        by_row.setdefault(r, []).append(k)
    rows = sorted(by_row)
    xr = x[torch.tensor(rows, device=x.device)]
    h, wd = picked_ffn(xr, wc, idx, activation=act, **quant)
    G, nc_g, cs = wc.shape[:3]
    groups = torch.arange(G, device=x.device)[:, None]
    scores = (xr.float() @ A.float()) @ Bp.float()
    tok = scores.reshape(len(rows), G, nc_g, cs)[:, groups, idx.long()]
    gate = (tok.reshape(len(rows), -1) > 0.0).float()
    for i, r in enumerate(rows):
        ks = by_row[r]
        assert len(ks) <= 4, f"row {r}: {len(ks)} gates on a zero score"
        variants = []
        for bits in range(2 ** len(ks)):
            g = gate[i].clone()
            for j, k in enumerate(ks):
                g[k] = float(bits >> j & 1)
            variants.append((h[i] * g).to(wd.dtype).float() @ wd.float())
        assert any(torch.allclose(y[r], v, atol=tol, rtol=tol)
                   for v in variants), \
            f"row {r}: no on/off variant of the zero-score gates {ks} matches"


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_cold_ffn_matches_plain(cuda, case):
    B, D, r, cs, G, nc_g, R, kc, act, mode, dtype = case
    x, wc, A, Bp = _inputs(B, D, r, cs, G, nc_g, R, dtype, cuda)
    _check(x, wc, A, Bp, None, act, mode, kc)


# the cold paths of the paper's widths, as the planner sizes them on the
# PHONE profile: qwen2-vl-2b (D 1536, 69 cold clusters of 128, kc 1),
# bamboo-7b (D 4096, 111, kc 2) and qwen3-14b (D 5120, 135, kc 2)
WIDE = [(1536, 69, 1), (4096, 111, 2), (5120, 135, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("act,mode", [("relu2", "relu"), ("silu", "cats")])
@pytest.mark.parametrize("D,nc_g,kc", WIDE, ids=lambda v: str(v))
def test_fused_cold_ffn_at_model_widths(cuda, D, nc_g, kc, act, mode, B):
    x, wc, A, Bp = _inputs(B, D, 64, 128, 1, nc_g, 3, torch.bfloat16, cuda,
                           seed=D + B)
    _check(x, wc, A, Bp, None, act, mode, kc)


@pytest.mark.gpu
@pytest.mark.parametrize("dead", ["some", "all"])
def test_fused_cold_ffn_dead_rows(cuda, dead):
    x, wc, A, Bp = _inputs(8, 576, 64, 64, 1, 23, 3, torch.bfloat16, cuda,
                           seed=3)
    mask = torch.zeros(8, dtype=torch.bool, device=cuda)
    if dead == "some":
        mask[::3] = True
    y, idx = ops.fused_cold_ffn(x, wc, A, Bp, activation="silu",
                                mode="cats", kc=4, active_mask=mask)
    if dead == "all":
        assert idx.tolist() == [[0, 1, 2, 3]]
    _check(x, wc, A, Bp, mask, "silu", "cats", 4)


@pytest.mark.gpu
def test_fused_cold_ffn_column_slice_and_repeat(cuda):
    """Bp as a column slice of the full predictor (the engine's layout),
    and two runs that agree bit for bit (no atomics)."""
    x, wc, A, Bfull = _inputs(4, 576, 64, 64, 1, 24, 3, torch.bfloat16,
                              cuda, seed=5)
    Bp = Bfull[:, 64:]
    wc = wc[:, 1:].contiguous()
    y1, i1 = ops.fused_cold_ffn(x, wc, A, Bp, activation="silu",
                                mode="cats", kc=2)
    y2, i2 = ops.fused_cold_ffn(x, wc, A, Bp, activation="silu",
                                mode="cats", kc=2)
    assert torch.equal(y1, y2) and torch.equal(i1, i2)
    _check(x, wc, A, Bp, None, "silu", "cats", 2)


@pytest.mark.gpu
@pytest.mark.parametrize("sd", ["int8", "int4-mixed"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_cold_ffn_quant_matches_plain(cuda, case, sd):
    B, D, r, cs, G, nc_g, R, kc, act, mode, dtype = case
    x, wc, A, Bp = _inputs(B, D, r, cs, G, nc_g, R, dtype, cuda, seed=1)
    _check(x, wc, A, Bp, None, act, mode, kc, **quantize_bundles(wc, sd))


STORAGE = ["fp", "int8", "int4-mixed"]


def _quant(wc, sd):
    return {} if sd == "fp" else quantize_bundles(wc, sd)


@pytest.mark.gpu
@pytest.mark.parametrize("sd", STORAGE)
@pytest.mark.parametrize("B", [65, 128, 300])
def test_fused_cold_ffn_any_batch(cuda, B, sd):
    """Past the 64 rows of the decode buckets, at the main path's shapes:
    rows are tiled over the grid, so any B runs."""
    x, wc, A, Bp = _inputs(B, 576, 64, 64, 1, 23, 3, torch.bfloat16, cuda,
                           seed=B)
    _check(x, wc, A, Bp, None, "silu", "cats", 1, **_quant(wc, sd))


@pytest.mark.gpu
@pytest.mark.parametrize("sd", STORAGE)
@pytest.mark.parametrize("D", [200, 203])
def test_fused_cold_ffn_ragged_rows(cuda, D, sd):
    """D = 200 (int8 rows of 200 bytes) and D = 203 (no row of x, A, the
    codes or the sidecar starts 16-byte aligned): the kernels load the
    ragged heads and tails of their vector runs one element at a time."""
    x, wc, A, Bp = _inputs(16, D, 64, 64, 1, 23, 3, torch.bfloat16, cuda,
                           seed=D)
    _check(x, wc, A, Bp, None, "silu", "cats", 2, **_quant(wc, sd))


@pytest.mark.gpu
@pytest.mark.parametrize("sd", STORAGE)
def test_fused_cold_ffn_odd_column_offset(cuda, sd):
    """Bp as the column slice [:, 65:] of a wider predictor: every row of
    the slice starts 2 bytes past a 16-byte boundary."""
    x, wc, A, Bfull = _inputs(8, 576, 64, 64, 1, 25, 3, torch.bfloat16,
                              cuda, seed=65)
    Bp = Bfull[:, 65:65 + 23 * 64]
    wc = wc[:, :23].contiguous()
    _check(x, wc, A, Bp, None, "silu", "cats", 2, **_quant(wc, sd))


@pytest.mark.gpu
@pytest.mark.parametrize("sd", STORAGE)
def test_fused_cold_ffn_repeats_bit_for_bit(cuda, sd):
    """Two runs at B = 32 agree bit for bit: every sum runs in a fixed
    order and nothing is added atomically."""
    x, wc, A, Bp = _inputs(32, 576, 64, 64, 1, 23, 3, torch.bfloat16, cuda,
                           seed=32)
    q = _quant(wc, sd)
    run = lambda: ops.fused_cold_ffn(x, wc, A, Bp, activation="silu",
                                     mode="cats", kc=1, **q)
    (y1, i1), (y2, i2) = run(), run()
    assert torch.equal(y1, y2) and torch.equal(i1, i2)
    _check(x, wc, A, Bp, None, "silu", "cats", 1, **q)


def _tied(Bp, G, nc_g, cs, period=3):
    """Bp with cluster c's column block a copy of cluster c % period's in
    every group: the copies' scores tie exactly."""
    blocks = Bp.reshape(Bp.shape[0], G, nc_g, cs)
    src = torch.arange(nc_g, device=Bp.device) % period
    return blocks[:, :, src].reshape(Bp.shape).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("sd", STORAGE)
@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("kc", [1, 2, 23])
def test_fused_cold_ffn_exact_ties(cuda, kc, G, B, sd):
    """Clusters that tie exactly (duplicate Bp column blocks): the
    selection, now in gate_up's prologue, takes the lowest id of each tie
    first, so the ids equal select_clusters's (the plain version's),
    kc = nc_g included."""
    nc_g, cs = 23, 64
    x, wc, A, Bp = _inputs(B, 576, 64, cs, G, nc_g, 3, torch.bfloat16, cuda,
                           seed=40 + B + G)
    Bp = _tied(Bp, G, nc_g, cs)
    q = _quant(wc, sd)
    y, idx = ops.fused_cold_ffn(x, wc, A, Bp, activation="silu",
                                mode="cats", kc=kc, **q)
    m = torch.ones(B, device=cuda)
    yr, ir = fused_cold_ffn_ref(x, wc, A, Bp, m, activation="silu",
                                cats=True, kc=kc, **q)
    assert torch.equal(idx, ir)
    if kc > 1:
        assert all(b - a == 3 for a, b in ir[:, :2].tolist())  # a real tie
    torch.testing.assert_close(y, yr, atol=5e-2, rtol=5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("sd", STORAGE)
@pytest.mark.parametrize("B", [1, 4, 5, 7, 8, 9, 15, 16, 17, 33])
def test_fused_cold_ffn_gate_up_row_tiles(cuda, B, sd):
    """gate_up takes 4 rows of x a block: B around each tile edge, at the
    main path's shapes."""
    x, wc, A, Bp = _inputs(B, 576, 64, 64, 1, 23, 3, torch.bfloat16, cuda,
                           seed=80 + B)
    _check(x, wc, A, Bp, None, "silu", "cats", 1, **_quant(wc, sd))


@pytest.mark.gpu
@pytest.mark.parametrize("cap", ["cs", "r", "nc_g"])
def test_fused_cold_ffn_shape_caps_raise(cuda, cap):
    """The card path takes cs <= 1024, r <= 1024 and nc_g <= 12288 (the
    plain version and the reference take any size): one past each raises
    ValueError before anything launches, at a tiny D and B."""
    cs, r, nc_g = {"cs": (1025, 4, 1), "r": (4, 1025, 1),
                   "nc_g": (4, 4, 12289)}[cap]
    x, wc, A, Bp = _inputs(2, 8, r, cs, 1, nc_g, 3, torch.bfloat16, cuda)
    before = ops.fused_cold_ffn.launches
    with pytest.raises(ValueError, match="unsupported shape"):
        ops.fused_cold_ffn(x, wc, A, Bp, activation="silu", mode="cats",
                           kc=1)
    assert ops.fused_cold_ffn.launches == before


@pytest.mark.gpu
def test_fused_cold_ffn_row_tiles_past_the_grid_cats(cuda):
    """B = 4 * 65535 + 5 in CATS mode: rows whose gate sits on an fp32
    score within rounding of 0 (cats_zero_gates) must match the plain
    version with those gates on or off; every other row within tolerance."""
    B = 4 * 65535 + 5
    x, wc, A, Bp = _inputs(B, 576, 64, 64, 1, 23, 3, torch.bfloat16, cuda,
                           seed=7)
    _check(x, wc, A, Bp, None, "silu", "cats", 1)


@pytest.mark.gpu
def test_fused_cold_ffn_row_tiles_past_the_grid(cuda):
    """B = 4 * 65535 + 5: gate_up's row tiles (4 rows each) and down's
    pass the grid's 65535 and loop inside the block. In relu mode: over
    16.8M (row, neuron) pairs some fp32 score sits so close to 0 that the
    kernel's and cuBLAS's summation orders give it opposite signs, and
    CATS would then keep the neuron on one side only."""
    B = 4 * 65535 + 5
    x, wc, A, Bp = _inputs(B, 576, 64, 64, 1, 23, 3, torch.bfloat16, cuda,
                           seed=7)
    _check(x, wc, A, Bp, None, "silu", "relu", 1)


@pytest.mark.gpu
@pytest.mark.parametrize("sd", STORAGE)
@pytest.mark.parametrize("D,dtype", [(200, torch.bfloat16),
                                     (203, torch.bfloat16),
                                     (1000, torch.bfloat16),
                                     (203, torch.float32),
                                     (700, torch.float32)],
                         ids=["200-bf16", "203-bf16", "1000-bf16", "203-fp32",
                              "700-fp32"])
def test_fused_cold_ffn_gate_up_row_runs(cuda, D, dtype, sd):
    """gate_up's 16-byte weight runs (codes and sidecar in the quant
    modes) on rows that are not 16-byte multiples (200 int8 codes, 203
    of anything), and rows wider than one D chunk (768 columns in bf16,
    640 in fp32), over two row tiles and two groups."""
    x, wc, A, Bp = _inputs(17, D, 32, 32, 2, 5, 3, dtype, cuda, seed=D)
    _check(x, wc, A, Bp, None, "silu", "cats", 2, **_quant(wc, sd))


# (B, D, N, R, cs, activation, dtype): the reference's sweep shapes plus
# prefill-sized B and an N that 512 does not divide
GATHER_CASES = [
    (1, 64, 256, 3, 32, "silu", torch.float32),
    (4, 128, 512, 3, 64, "relu2", torch.bfloat16),
    (8, 256, 1024, 2, 128, "gelu", torch.float32),
    (2, 384, 768, 3, 128, "geglu", torch.bfloat16),
    (1, 576, 1536, 3, 64, "silu", torch.bfloat16),
    (32, 576, 1472, 3, 64, "silu", torch.bfloat16),
    (300, 576, 1536, 3, 64, "silu", torch.bfloat16),
    (300, 200, 1472, 2, 32, "gelu", torch.float32),
]


def _gather_inputs(B, D, N, R, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device, dtype)
    return t(rng.standard_normal((B, D)) * 0.5), \
        t(rng.standard_normal((N, R, D)) * 0.1)


def _half_the_clusters(N, cs, device, seed=1):
    n_clusters = N // cs
    return torch.from_numpy(np.random.default_rng(seed).permutation(
        n_clusters)[:max(1, n_clusters // 2)].astype(np.int32)).to(device)


def _gather_check(x, w, idx, act, cs):
    """Both kernels once each (one launch count each) against their
    plain versions, in x's dtype, at the reference's tolerances."""
    tol = 5e-2 if x.dtype == torch.bfloat16 else 2e-4
    g0, d0 = ops.cluster_gather_ffn.launches, ops.dense_ffn.launches
    y = ops.cluster_gather_ffn(x, w, idx, activation=act, cluster_size=cs)
    yd = ops.dense_ffn(x, w, activation=act)
    torch.cuda.synchronize()
    assert (ops.cluster_gather_ffn.launches, ops.dense_ffn.launches) == \
        (g0 + 1, d0 + 1)
    assert y.dtype == yd.dtype == x.dtype
    assert y.shape == yd.shape == x.shape
    torch.testing.assert_close(
        y.float(), cluster_gather_ffn_ref(x, w, idx, activation=act,
                                          cluster_size=cs).float(),
        atol=tol, rtol=tol)
    torch.testing.assert_close(
        yd.float(), dense_ffn_ref(x, w, activation=act).float(),
        atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GATHER_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_gather_and_dense_match_plain(cuda, case):
    B, D, N, R, cs, act, dtype = case
    x, w = _gather_inputs(B, D, N, R, dtype, cuda)
    _gather_check(x, w, _half_the_clusters(N, cs, cuda), act, cs)


# (B, D, N, R, cs, dtype): rows of 16-byte multiples that D does not
# fill to the mma depth (200, bf16 and fp32) and rows that are no 16-byte
# multiple (203), N = 1472, clusters of 32 and 128, and B on each side of
# the multicast (B > 16) and row-group (128 rows) edges
GATHER_EDGE = [
    (37, 200, 512, 3, 64, torch.bfloat16),
    (37, 203, 512, 3, 64, torch.bfloat16),
    (37, 200, 512, 3, 64, torch.float32),
    (37, 203, 512, 2, 64, torch.float32),
    (16, 576, 1472, 3, 32, torch.bfloat16),
    (129, 576, 1536, 3, 128, torch.bfloat16),
    (65, 256, 1024, 3, 32, torch.float32),
    (300, 203, 1024, 3, 128, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GATHER_EDGE,
                         ids=lambda c: "-".join(map(str, c)))
def test_gather_and_dense_edge_shapes(cuda, case):
    B, D, N, R, cs, dtype = case
    x, w = _gather_inputs(B, D, N, R, dtype, cuda, seed=B + D)
    _gather_check(x, w, _half_the_clusters(N, cs, cuda, seed=D), "silu", cs)


@pytest.mark.gpu
@pytest.mark.parametrize("offset,D", [(64, 576), (1, 203)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_duplicate_ids_and_offset_view(cuda, dtype, offset, D):
    """w as the view w_full[offset:] (chip_smoke's phase 6 passes
    w[n_hot:]; offset 1 at D = 203 starts every bundle off a 16-byte
    boundary), and cluster ids that repeat: each repeat adds its cluster's
    FFN again, as the plain version's gather does."""
    N, cs = 1536, 64
    x, wfull = _gather_inputs(40, D, offset + N, 3, dtype, cuda, seed=offset)
    w = wfull[offset:]
    assert w.is_contiguous() and w.storage_offset() > 0
    idx = torch.tensor([3, 3, 0, 17, 3, 23], dtype=torch.int32, device=cuda)
    _gather_check(x, w, idx, "silu", cs)


@pytest.mark.gpu
def test_gather_and_dense_past_the_grid(cuda):
    """B = 4 * 65535 + 5 for both kernels: gate_up's row groups and down's
    row tiles at that size."""
    B, D, N, cs = 4 * 65535 + 5, 128, 512, 64
    x, w = _gather_inputs(B, D, N, 3, torch.bfloat16, cuda, seed=11)
    _gather_check(x, w, _half_the_clusters(N, cs, cuda), "silu", cs)


@pytest.mark.gpu
def test_gather_grouped_and_repeat(cuda):
    """The grouped form offsets ids by g * nc_g; two runs agree bit for
    bit (no atomics), here and for both kernels at B = 300 in bf16."""
    G, nc_g, cs, D, B = 3, 4, 32, 64, 5
    x, w = _gather_inputs(B, D, G * nc_g * cs, 3, torch.float32, cuda)
    wc = w.reshape(G, nc_g, cs, 3, D)
    cidx = torch.tensor([[0, 2], [1, 3], [0, 1]], dtype=torch.int32,
                        device=cuda)
    y1 = ops.cluster_gather_ffn_grouped(x, wc, cidx, activation="silu")
    y2 = ops.cluster_gather_ffn_grouped(x, wc, cidx, activation="silu")
    assert torch.equal(y1, y2)
    ref = sum(cluster_gather_ffn_ref(x, wc[g].reshape(nc_g * cs, 3, D),
                                     cidx[g], activation="silu",
                                     cluster_size=cs) for g in range(G))
    torch.testing.assert_close(y1, ref, atol=2e-4, rtol=2e-4)
    # both kernels at B = 300 in bf16, full width: every sum in a fixed
    # order (k-slices, down's cluster ranks), no float atomics
    x, w = _gather_inputs(300, 576, 1536, 3, torch.bfloat16, cuda, seed=300)
    idx = _half_the_clusters(1536, 64, cuda)
    for run in (lambda: ops.cluster_gather_ffn(x, w, idx, activation="silu",
                                               cluster_size=64),
                lambda: ops.dense_ffn(x, w, activation="silu")):
        assert torch.equal(run(), run())


# ------------------------------------------- the decode step's CUDA graphs ----

# (prompt length, max_new, arrival step): the batch walks the bucket
# ladder up (1, 2, 3), down (1) and back up (2, 3)
GRAPH_STREAM = [(12, 10, 0), (12, 4, 1), (20, 3, 2), (16, 8, 8),
                (14, 6, 9)]


def _full_width_engine(sd, cuda_graphs, **kw):
    from repro_torch.launch.serve import build_engine
    engine, cfg = build_engine("smollm-135m", reduced=False,
                               backend="pallas", storage_dtype=sd,
                               temperature=0.0, cuda_graphs=cuda_graphs,
                               **kw)
    traces = []
    price = engine.storage.step

    def record(trace, *a, **k):
        traces.append(np.array(trace))
        return price(trace, *a, **k)
    engine.storage.step = record
    return engine, cfg, traces


def _serve_graph_stream(engine, vocab):
    """GRAPH_STREAM on the engine's steps; returns (tokens per request,
    TokenStats per step)."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n, _, _ in GRAPH_STREAM]
    uids, stats = {}, []
    k = 0
    while k <= max(a for *_, a in GRAPH_STREAM) or engine.sched.has_work:
        for i, (_, m, arrive) in enumerate(GRAPH_STREAM):
            if arrive == k:
                uids[i] = engine.submit(prompts[i], max_new=m,
                                        arrival_time=engine.clock_s)
        r = engine.step()
        if r is not None:
            stats.append(r.stats)
        k += 1
    torch.cuda.synchronize()
    toks = [engine.sched.sequences[uids[i]].generated
            for i in range(len(GRAPH_STREAM))]
    return toks, stats


@pytest.mark.gpu
@pytest.mark.parametrize("sd", ["fp16", "int8", "int4-mixed"])
def test_graph_matches_eager_at_full_width(cuda, sd):
    """smollm-135m at full width (30 layers, bf16): one CUDA graph per
    bucket and the eager step give identical tokens, cluster ids and
    TokenStats over a stream that walks the bucket ladder up, down and
    back up; fused_cold_ffn.launches counts 30 per step in both."""
    out = {}
    for graphs in (True, False):
        engine, cfg, traces = _full_width_engine(sd, graphs, ctx_budget=48)
        ops.fused_cold_ffn.launches = 0
        toks, stats = _serve_graph_stream(engine, cfg.vocab_size)
        assert ops.fused_cold_ffn.launches == cfg.num_layers * len(stats)
        live = engine.decoder._cache
        assert all((type(fn).__name__ == "GraphedStep") == graphs
                   for _, fn in live.values())
        out[graphs] = (toks, [t.tolist() for t in traces], stats)
        engine.close()
    assert out[True][0] == out[False][0]
    assert out[True][1] == out[False][1]
    assert out[True][2] == out[False][2]
    b = [s.batch for s in out[True][2]]          # up, down, up again
    peak = b.index(max(b))
    low = b.index(min(b[peak:]), peak)
    assert b[peak] >= 3 and b[low] < b[peak] and max(b[low:]) > b[low]


@pytest.mark.gpu
def test_generate_twice_recaptures_on_a_new_arena(cuda):
    """generate() at two lengths rebuilds the arena (no ctx_budget), so
    every graph is dropped and captured again on the new buffers; the
    tokens stay the eager step's."""
    res = {}
    for graphs in (True, False):
        engine, cfg, _ = _full_width_engine("fp16", graphs)
        rng = np.random.default_rng(3)
        outs, arenas = [], []
        for S, n in ((10, 6), (14, 9), (10, 6)):
            prompt = rng.integers(0, cfg.vocab_size, (3, S)).astype(np.int32)
            outs.append(engine.generate(prompt, max_new=n,
                                        temperature=0.0).tokens.tolist())
            arenas.append(engine.arena)
        assert arenas[0] is not arenas[1] is not arenas[2]
        if graphs:
            steps = [fn for _, fn in engine.decoder._cache.values()]
            assert all(fn.captures == 3 for fn in steps), \
                [fn.captures for fn in steps]
        res[graphs] = outs
        engine.close()
    assert res[True] == res[False]


@pytest.mark.gpu
def test_graph_captured_before_the_library_is_built(cuda):
    """The first bucket's capture is the process's first use of the
    kernel library: its warm-up pass loads it outside the capture."""
    from repro_torch.kernels import build
    build.library.cache_clear()
    engine, cfg, _ = _full_width_engine("fp16", True, ctx_budget=32)
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    got = engine.generate(prompt, max_new=5, temperature=0.0).tokens
    engine.close()
    engine, _, _ = _full_width_engine("fp16", False, ctx_budget=32)
    want = engine.generate(prompt, max_new=5, temperature=0.0).tokens
    engine.close()
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_launches_count_per_replay(cuda):
    """A replay adds the launches its capture recorded; the warm-up pass
    and the capture itself add none."""
    engine, cfg, _ = _full_width_engine("int8", True, ctx_budget=32)
    rng = np.random.default_rng(6)
    for _ in range(2):
        engine.submit(rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
                      max_new=4)
    counts = []
    ops.fused_cold_ffn.launches = 0
    while engine.step() is not None:
        counts.append(ops.fused_cold_ffn.launches)
    torch.cuda.synchronize()
    assert counts == [cfg.num_layers * (i + 1) for i in range(len(counts))]
    (_, fn), = engine.decoder._cache.values()
    assert fn.launches["fused_cold_ffn"] == cfg.num_layers
    assert fn.warmup_launches["fused_cold_ffn"] == cfg.num_layers
    assert fn.captures == 1
    engine.close()


@pytest.mark.gpu
def test_prewarm_and_growth_keep_the_eager_tokens(cuda):
    """A one-request generate() holds a one-slot arena; prewarm grows it
    to max_slots and captures every bucket on it, and a later batch
    replays the prewarmed graph; tokens stay the eager step's."""
    res = {}
    for graphs in (True, False):
        engine, cfg, _ = _full_width_engine("fp16", graphs, ctx_budget=32,
                                            buckets=(1, 2, 4))
        rng = np.random.default_rng(5)
        one = rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
        outs = [engine.generate(one, max_new=4, temperature=0.0)
                .tokens.tolist()]
        assert engine.arena.capacity == 1
        engine.prewarm()
        assert engine.arena.capacity == 4
        steps = [fn for _, fn in engine.decoder._cache.values()]
        assert len(steps) == 3
        if graphs:
            assert all(fn.graph is not None for fn in steps)
            captured = [fn.captures for fn in steps]
        three = rng.integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
        outs.append(engine.generate(three, max_new=4, temperature=0.0)
                    .tokens.tolist())
        if graphs:      # the batch of three replayed bucket 4's graph
            assert [fn.captures for fn in steps] == captured
        res[graphs] = outs
        engine.close()
    assert res[True] == res[False]


@pytest.mark.gpu
def test_dp2_graph_matches_eager_at_full_width(cuda):
    """ServeEngine(dp=2) at full width (smollm-135m, 30 layers, bf16):
    each replica captures its own graphs over its own buffers and pool,
    and the graphed run gives the eager run's tokens, routing, cluster
    ids and TokenStats; 30 launches per replica step in both."""
    from repro_torch.launch.serve import build_engine
    out = {}
    for graphs in (True, False):
        engine, cfg = build_engine("smollm-135m", reduced=False,
                                   backend="pallas", temperature=0.0,
                                   ctx_budget=48, dp=2,
                                   cuda_graphs=None if graphs else False)
        traces = []
        for rep in engine.replicas:
            price = rep.storage.step

            def record(trace, *a, price=price, **k):
                traces.append(np.array(trace).tolist())
                return price(trace, *a, **k)
            rep.storage.step = record
        rng = np.random.default_rng(12)
        uids = [engine.submit(rng.integers(0, cfg.vocab_size, n)
                              .astype(np.int32), max_new=m,
                              arrival_time=t)
                for n, m, t in ((12, 8, 0.0), (16, 6, 0.0), (12, 5, 1e-3),
                                (20, 7, 2e-3), (14, 4, 3e-3))]
        ops.fused_cold_ffn.launches = 0
        rep = engine.run_until_drained()
        torch.cuda.synchronize()
        assert ops.fused_cold_ffn.launches == cfg.num_layers * len(rep.stats)
        if graphs:
            a, b = ({p for _, fn in r.decoder._cache.values()
                     for p, _ in fn._bound} for r in engine.replicas)
            assert a and b and not a & b
            assert engine.replicas[0].decoder._pool is not \
                engine.replicas[1].decoder._pool
        out[graphs] = ([engine.sched.sequences[u].generated for u in uids],
                       dict(engine.router.assignment), traces, rep.stats)
        engine.close()
    assert out[True] == out[False]
    assert {r for r, _ in out[True][1].values()} == {0, 1}


# ------------------------------------------------------------ moe family ----

def _moe_engine(arch, layers, cuda_graphs):
    """The moe config at full width cut to `layers` layers (bf16), the
    seeded model on the card, recording traces. The plan is PHONE's but
    with a 100 ms prefetch window: PHONE's 2 ms holds fewer bundles than
    turbosparse's shared expert, so its plan would have no per-expert
    hot prefix and no two-level trace."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.planner import PHONE
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.families import serving_family
    cfg = get_config(arch).replace(num_layers=layers)
    fam = serving_family(cfg)
    plan = fam.build_plan(cfg, hw=dataclasses.replace(PHONE,
                                                       attn_time_s=0.1))
    model = fam.prepare_params(fam.make_model(cfg, device="cuda", seed=0),
                               plan)
    engine = ServeEngine(cfg, model, plan, temperature=0.0, ctx_budget=48,
                         cuda_graphs=cuda_graphs)
    traces = []
    price = engine.storage.step

    def record(trace, *a, **k):
        traces.append(np.array(trace).tolist())
        return price(trace, *a, **k)
    engine.storage.step = record
    return engine, cfg, traces


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "turbosparse-mixtral-47b"])
def test_moe_graph_matches_eager_at_full_width(cuda, arch):
    """Whole experts (deepseek-moe-16b) and two-level (turbosparse-
    mixtral-47b) at full width, 2 layers, bf16: one CUDA graph per
    bucket gives the eager step's tokens, (L, E) / (L, E, 1+ncc) traces
    and TokenStats across the bucket ladder; no fused_cold_ffn launch."""
    out = {}
    for graphs in (True, False):
        engine, cfg, traces = _moe_engine(arch, 2, graphs)
        ops.fused_cold_ffn.launches = 0
        toks, stats = _serve_graph_stream(engine, cfg.vocab_size)
        torch.cuda.synchronize()
        assert ops.fused_cold_ffn.launches == 0
        assert all((type(fn).__name__ == "GraphedStep") == graphs
                   for _, fn in engine.decoder._cache.values())
        out[graphs] = (toks, traces, stats)
        engine.close()
        del engine
    assert out[True] == out[False]
    shape = np.array(out[True][1][0]).shape
    assert shape[:2] == (2, cfg.num_experts)
    assert len(shape) == (3 if cfg.moe_intra_expert else 2)


def _near_relu_flips(moe_cpu, cfg, x, active, C, p):
    """(E, ncc) occupied-slot cold activations whose fp64 gate
    pre-activation lies within 1e-5 of relu's threshold."""
    from repro_torch.models import moe as moe_mod
    buf, (slot, keep, _), *_ = moe_mod._dispatch_group(
        x, moe_cpu.router, cfg, C, active)
    E = buf.shape[0]
    occ = torch.zeros(E * C, dtype=torch.bool)
    occ[slot[keep].long()] = True
    g = torch.bmm(buf.double(),
                  moe_cpu.experts[:, :, 0].double().transpose(1, 2))
    near = ((g.abs() <= 1e-5) & occ.reshape(E, C, 1)).sum(dim=1)
    ncc = (cfg.d_ff - p.n_expert_hot) // p.cluster_size
    return near[:, p.n_expert_hot:].reshape(E, ncc, -1).sum(dim=-1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "grok-1-314b",
                                  "turbosparse-mixtral-47b"])
@pytest.mark.parametrize("T", [1, 4, 32, 64])
def test_apply_moe_ffn_card_matches_cpu(cuda, arch, T):
    """apply_moe_ffn of the reduced config (fp32) on the card against the
    CPU on the same weights and x, every third row dead; T 64 repeats one
    row 48 times at capacity factor 0.5, past its experts' capacity (16
    slots for 32 live copies). tope, slot, keep and the
    kept counts identical, the two-level cold counts identical but for
    fp64-confirmed near-threshold activations, y within 2e-4."""
    from repro_torch.configs import get_config
    from repro_torch.core.planner import PHONE
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.families import serving_family
    cfg = get_config(arch).reduced()
    if T == 64:
        cfg = cfg.replace(moe_capacity_factor=0.5)
    fam = serving_family(cfg)
    plan = fam.build_plan(cfg, hw=PHONE)
    cpu = fam.prepare_params(fam.make_model(cfg, device="cpu", seed=3),
                             plan).layers[0].moe
    dev = moe_mod.MoEFFN(cfg, torch.float32, cuda)
    with torch.no_grad():
        for name, p in dev.named_parameters():
            p.copy_(getattr(cpu, name))
    rng = np.random.default_rng(T)
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32) * 0.1
    if T == 64:
        x[:48] = x[0]
    x = torch.from_numpy(x)
    active = torch.arange(T) % 3 != 2
    E, k = cfg.num_experts, cfg.experts_per_token
    C = moe_mod._capacity(T, k, E, cfg.moe_capacity_factor)
    p = plan.plan_for_batch(T)
    got = []
    for moe, where in ((dev, cuda), (cpu, torch.device("cpu"))):
        xd, ad = x.to(where), active.to(where)
        disp = moe_mod.moe_dispatch(torch.softmax(xd @ moe.router, -1), k,
                                    C, ad)
        y, _, tr = moe_mod.apply_moe_ffn(moe, xd, cfg, plan=p,
                                         active_mask=ad, collect_trace=True)
        got.append([t.cpu() for t in (*disp, y, tr)])
    (te, _, sl, kp, y, tr), (te0, _, sl0, kp0, y0, tr0) = got
    for a, b in ((te, te0), (sl, sl0), (kp, kp0)):
        assert torch.equal(a, b)
    if T == 64:
        assert not bool(kp0[active].all())       # live entries dropped
    if tr.dim() == 1:
        assert torch.equal(tr, tr0)
    else:
        assert torch.equal(tr[:, 0], tr0[:, 0])
        near = _near_relu_flips(cpu, cfg, x, active, C, p)
        assert bool(((tr[:, 1:] - tr0[:, 1:]).abs() <= near).all())
    torch.testing.assert_close(y, y0, atol=2e-4, rtol=2e-4)


# ------------------------------------------------------ offline planner ----

def _planner_tokens(cfg, n=2, shape=(2, 32)):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    data = SyntheticTokens(DataConfig(cfg.vocab_size, shape[1], shape[0]))
    return [data.batch()["tokens"] for _ in range(n)]


@pytest.mark.gpu
def test_profile_and_calibration_card_match_cpu(cuda):
    """smollm-135m reduced (fp32), the same weights and tokens on the card
    and the CPU: counts identical but for near-threshold pairs, X within
    1e-5 of its scale, H identical but for flagged pairs; the card's
    calibrated A@B within 1e-6 relative of the CPU's fp64 solve and
    truncation on the same X and H (the card's, copied to the host: two
    X that differ in rounding give solutions that differ by that rounding
    times the ridge system's condition)."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.core import planner
    from repro_torch.models.dense import make_model
    cfg = get_config("smollm-135m").reduced()
    cpu = make_model(cfg, device="cpu", seed=4)
    dev = copy.deepcopy(cpu).to(cuda)
    tokens = _planner_tokens(cfg)
    counts, n = planner.profile_activations(dev, cfg, tokens)
    counts0, n0 = planner.profile_activations(cpu, cfg, tokens)
    X, H = planner.profile_ffn_inputs(dev, cfg, tokens)
    X0, H0 = planner.profile_ffn_inputs(cpu, cfg, tokens)
    assert X.device == dev.device and n == n0 == 128
    X, H = X.cpu(), H.cpu()
    torch.testing.assert_close(X, X0, rtol=0,
                               atol=1e-5 * float(X0.abs().max()))
    flags = torch.stack([near_threshold(
        X0[l], cpu.layers[l].ffn.w, cfg.activation, cfg.sparse_ffn.mode,
        dx=float((X[l] - X0[l]).abs().max())) for l in range(len(X))])
    assert not bool((H != H0)[~flags].any())
    diff = np.abs(counts - counts0)
    per = flags.sum(1).numpy()
    assert (diff <= per).all() and (diff[per == 0] == 0).all()
    planner.calibrate_predictor(dev, cfg, tokens)
    for l in range(cfg.num_layers):
        a, b = dev.layers[l].ffn.pred_A, dev.layers[l].ffn.pred_B
        got = (a.double() @ b.double()).cpu()
        ra, rb = planner._ridge_low_rank(X[l], H[l], 1e-2,
                                         cfg.sparse_ffn.predictor_rank)
        want = ra @ rb
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


@pytest.mark.gpu
def test_profiled_engine_graph_matches_eager(cuda):
    """build_engine(profile=True) at full width (smollm-135m, bf16): the
    profile on the card gives the same plan twice, and the graphed engine
    serves the eager one's tokens, cluster ids and TokenStats; the kernel
    runs once per layer in each step whose bucket keeps a cold path (on
    random weights CATS activates most neurons, and the profiled plan
    may make all of them hot)."""
    from repro_torch.core.adaptation import bucket_for
    out, orders = {}, []
    for graphs in (True, False):
        engine, cfg, traces = _full_width_engine("fp16", graphs,
                                                 ctx_budget=48, profile=True)
        orders.append(engine.plan.neuron_order)
        ops.fused_cold_ffn.launches = 0
        toks, stats = _serve_graph_stream(engine, cfg.vocab_size)
        plans = [engine.plan.plan_for_batch(
            bucket_for(s.batch, engine.decoder.buckets)) for s in stats]
        cold = sum(p.n_hot < cfg.d_ff and p.clusters_per_group > 0
                   for p in plans)
        assert ops.fused_cold_ffn.launches == cfg.num_layers * cold
        out[graphs] = (toks, [t.tolist() for t in traces], stats)
        engine.close()
    np.testing.assert_array_equal(orders[0], orders[1])
    assert out[True] == out[False]


@pytest.mark.gpu
def test_calibration_after_capture_keeps_replays_valid(cuda):
    """calibrate_predictor on an engine whose bucket graph is captured
    writes the predictor in place: the next replay (no new capture) gives
    the tokens of a fresh engine calibrated before its first step."""
    from repro_torch.core.planner import calibrate_predictor
    rng = np.random.default_rng(13)
    first, second = (rng.integers(0, 49152, (2, 12)).astype(np.int32)
                     for _ in range(2))
    engine, cfg, _ = _full_width_engine("fp16", True, ctx_budget=32,
                                        profile=True)
    tokens = _planner_tokens(cfg)
    engine.generate(first, max_new=4, temperature=0.0)
    steps = [fn for _, fn in engine.decoder._cache.values()]
    assert steps and all(fn.captures == 1 for fn in steps)
    address = engine.model.layers[0].ffn.pred_B.data_ptr()
    calibrate_predictor(engine.model, cfg, tokens)
    assert engine.model.layers[0].ffn.pred_B.data_ptr() == address
    got = engine.generate(second, max_new=4, temperature=0.0).tokens
    assert all(fn.captures == 1 for fn in steps)
    engine.close()
    fresh, _, _ = _full_width_engine("fp16", True, ctx_budget=32,
                                     profile=True)
    calibrate_predictor(fresh.model, cfg, tokens)
    want = fresh.generate(second, max_new=4, temperature=0.0).tokens
    fresh.close()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------- per rank, over gloo ----

def _rank_cold_path(shard, dtype_name, batches):
    """On each rank (all on the one card): fused_cold_ffn over the rank's
    g_loc = G/n groups of smollm-135m's FFN (D 576, d_ff 1536, cs 64, a
    plan of groups=4) against its plain version, one launch per call; then
    the sharded hybrid FFN under 'pallas' against the unsharded plain
    chain in fp32: ids identical, y within 2e-4."""
    import dataclasses
    from repro_torch.core.clusters import make_plan
    from repro_torch.core.sparse_ffn import ffn_hybrid
    from repro_torch.parallel import cold_range
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    D, N, cs, r, R = 576, 1536, 64, 64, 3
    plan = make_plan(N, 0.25, 0.25, cs, groups=4, backend="pallas")
    s, n = shard.rank, shard.size
    g_loc, kc = plan.groups // n, plan.clusters_per_group
    nc_g = (N - plan.n_hot) // plan.groups // cs
    lo, hi = cold_range(plan, N, s, n)
    out = []
    for B in batches:
        x, w, A, Bm = (t.to(dev, dtype) for t in _inputs(
            B, D, r, cs, 1, N // cs, R, torch.float32, "cpu", seed=B)[:4])
        w = w.reshape(N, R, D)
        wc = w[lo:hi].reshape(g_loc, nc_g, cs, R, D)
        _check(x, wc, A, Bm[:, lo:hi], None, "silu", "cats", kc)
        if dtype == torch.float32:
            before = ops.fused_cold_ffn.launches
            ys, ids = ffn_hybrid(w, (A, Bm), x, "silu", "cats", plan,
                                 return_indices=True, shard=shard)
            assert ops.fused_cold_ffn.launches == before + 1
            y1, ids1 = ffn_hybrid(w, (A, Bm), x, "silu", "cats",
                                  dataclasses.replace(plan, backend="jnp"),
                                  return_indices=True)
            assert torch.equal(ids.cpu(), ids1.cpu())
            torch.testing.assert_close(ys, y1, atol=2e-4, rtol=2e-4)
        out.append((B, g_loc, shard.calls))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_cold_ffn_per_rank_groups(cuda, n, dtype):
    from repro_torch.parallel import spawn
    got = spawn(_rank_cold_path, n, dtype, (1, 4, 32), device="cuda",
                timeout=300)
    assert [[b for b, _, _ in r] for r in got] == [[1, 4, 32]] * n
    assert all(g == 4 // n for r in got for _, g, _ in r)


def _rank_build_peak(shard):
    """build_engine at tp=2 on this rank (smollm-135m at full width, the
    ranks sharing the card), stopped where the engine would be built:
    the card's peak allocation until then, the slice's bytes and the
    whole model's."""
    from repro_torch.launch import serve
    from repro_torch.models import dense
    from repro_torch.configs import get_config
    torch.cuda.reset_peak_memory_stats()
    serve.ServeEngine = lambda cfg, model, plan, **kw: model
    local, cfg = serve.build_engine("smollm-135m", reduced=False, tp=2,
                                    shard=shard, device="cuda")
    size = lambda m: sum(t.numel() * t.element_size()
                         for t in list(m.parameters()) + list(m.buffers()))
    whole = dense.make_model(get_config("smollm-135m"), device="meta",
                             seed=None)
    return torch.cuda.max_memory_allocated(), size(local), size(whole), \
        local.embed.device.type


@pytest.mark.gpu
def test_build_engine_tp_holds_only_its_slice_on_the_card(cuda):
    """Under tp each rank builds the whole model on the host and moves
    only its slice to the card: the card's peak during the build is the
    slice, below the whole model."""
    from repro_torch.parallel import spawn
    for peak, mine, whole, dev in spawn(_rank_build_peak, 2, device="cuda",
                                        timeout=300):
        assert dev == "cuda"
        assert mine < whole
        assert peak < whole
        assert peak <= mine + 8 * 2**20


# ------------------------------------------------------------ training ----

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b",
                                  "qwen2-vl-2b"])
def test_train_step_card_matches_cpu(cuda, arch):
    """One fp32 train step of the reduced config on the card against the
    CPU, from the same weights and batch: loss within 1e-5 relative, every
    gradient leaf within 1e-4 of its max |g|, the same leaves without a
    gradient, and AdamW's update on the card finite, TF32 off."""
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (
        DataConfig, SyntheticTokens, shard_batch)
    from repro_torch.launch.train import add_modal_inputs
    from repro_torch.models.model import build_model, wrap
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import loss_and_grads, make_train_step
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch).reduced()
    cpu = build_model(cfg, device="cpu", seed=1)
    host = params_to_numpy(cpu.module)
    card = wrap(params_from_numpy(host.tree, cfg, cuda, dtypes=host.dtypes))
    batch = add_modal_inputs(SyntheticTokens(DataConfig(
        cfg.vocab_size, 32, 2, seed=1)).batch(), cfg,
        np.random.default_rng(1))
    out = {}
    for name, m in (("cpu", cpu), ("cuda", card)):
        out[name] = loss_and_grads(m, m.params(), shard_batch(batch, name))
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert float(lg) == pytest.approx(float(lc), rel=1e-5)
    for k, g in gc.items():
        assert (g is None) == (gg[k] is None), k
        if g is not None:
            err = float((gg[k].cpu() - g).abs().max())
            assert err <= 1e-4 * float(g.abs().max()), k
    opt = AdamW(lr=1e-3)
    w = card.params()
    _, state, met = make_train_step(card, opt)(w, opt.init(w),
                                               shard_batch(batch, cuda))
    assert float(met["loss"]) == float(lg) and int(state["step"]) == 1
    assert all(bool(torch.isfinite(p).all()) for p in w.values())
    assert not any(p.requires_grad for p in card.module.parameters())


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A reduced model trained two steps on the card: params_to_numpy ->
    save_checkpoint -> load_checkpoint gives every parameter back bit for
    bit, frozen, on the card (bf16 at full width: chip_smoke.py phase
    train)."""
    from repro_torch.bridge import load_checkpoint, params_to_numpy
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.launch.train import train
    model, losses = train("smollm-135m", steps=2, batch_size=2, seq_len=16,
                          lr=1e-3, log_every=0, device=cuda)
    assert np.isfinite(losses).all()
    save_checkpoint(str(tmp_path), params_to_numpy(model.module), step=2)
    back = load_checkpoint(str(tmp_path), model.cfg, cuda)
    mine = dict(model.module.named_parameters())
    for name, p in back.named_parameters():
        q = mine[name]
        assert p.device.type == "cuda" and not p.requires_grad
        assert p.dtype == q.dtype and torch.equal(p, q), name


@pytest.mark.gpu
def test_fused_cold_ffn_under_racecheck(cuda):
    """compute-sanitizer's racecheck over fused_cold_ffn at one small
    shape (bf16, B 4, smollm-135m's cold path): no hazard. A machine
    whose driver the tool does not support answers "Device not
    supported" before any kernel runs; the test then skips with that
    line, since nothing was checked. Any other run that does not reach
    the driver's end raises (run_tool)."""
    from repro_torch.analysis import sanitizer
    rep = sanitizer.run_tool("racecheck", timeout=300)
    if rep.blocked:
        pytest.skip(f"compute-sanitizer runs no tool here: {rep.blocked}")
    assert not rep.hazards, [str(f) for f in rep.findings()]


# ------------------------------------------------------- the shadow tier ----

from repro_torch.analysis import shadow, shadow_mutants  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("path", [c.path for c in shadow.CASES])
def test_shadow_tier_case_is_clean(cuda, path):
    """The registry entry under the shadow build at the case's shapes: no
    finding (every shared stage, cp.async, mbarrier, cluster barrier and
    PDL edge checked), and its outputs bit-identical to the normal
    build's on the same inputs."""
    res = shadow.run_case(shadow.BY_PATH[path])
    assert res.findings == [], [str(f) for f in res.findings]


@pytest.mark.gpu
def test_shadow_mutants_fire_exactly_their_rules(cuda):
    """Each mutant of the shipped sources, in a subprocess of its own,
    fires exactly the rules it names; none hangs; a perturbed output
    fires shadow-fidelity."""
    from repro_torch.kernels import build
    build.start(shadow_mutants.jobs()).wait()
    results = shadow_mutants.run_all(timeout=300)
    bad = [(r["name"], r["rules"], r["want"], r.get("error", ""))
           for r in results if not r["ok"]]
    assert not bad, bad
    assert shadow_mutants.fidelity_mutant() == \
        shadow_mutants.FIDELITY_MUTANT[1]
