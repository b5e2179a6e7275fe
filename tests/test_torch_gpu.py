"""The CUDA fused_cold_ffn kernel against its plain PyTorch version, on
the card. Marked `gpu`: without a card each test skips with a reason.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's own (tests/test_kernels.py): 2e-4 in fp32,
5e-2 in bf16. Ids must be identical except where the two clusters'
scores, recomputed in fp64, tie within fp32 rounding.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import fused_cold_ffn_ref, pick_disagreements

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


def _check(x, wc, A, Bp, mask, act, mode, kc):
    tol = 5e-2 if x.dtype == torch.bfloat16 else 2e-4
    before = ops.fused_cold_ffn.launches
    y, idx = ops.fused_cold_ffn(x, wc, A, Bp, activation=act, mode=mode,
                                kc=kc, active_mask=mask)
    torch.cuda.synchronize()
    assert ops.fused_cold_ffn.launches == before + 1
    m = torch.ones(x.shape[0], device=x.device) if mask is None \
        else mask.float()
    yr, ir = fused_cold_ffn_ref(x, wc, A, Bp, m, activation=act,
                                cats=mode == "cats", kc=kc)
    near, real = pick_disagreements(idx, ir, x, wc, A, Bp, m)
    assert not real, f"picks differ beyond fp32 ties: {real}"
    if not near:
        torch.testing.assert_close(y, yr, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_cold_ffn_matches_plain(cuda, case):
    B, D, r, cs, G, nc_g, R, kc, act, mode, dtype = case
    x, wc, A, Bp = _inputs(B, D, r, cs, G, nc_g, R, dtype, cuda)
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
