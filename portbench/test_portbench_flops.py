"""The FLOP and byte counts behind step_mfu and cold_ffn_roofline, on a
small shape worked by hand, and the traffic generator's fixed sizes."""
import numpy as np
import pytest

from portbench import flops
from portbench.traffic import Stream, quantiles

# D 8, 2 q heads and 1 kv head of 4, N 16, vocab 10, one layer, rank 2
M = {"num_layers": 1, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
     "d_head": 4, "d_ff": 16, "vocab_size": 10, "activation": "relu2",
     "sparse_ffn": {"predictor_rank": 2}}


@pytest.mark.parametrize("fn, args, want", [
    # q, k, v: 2*8*(2+1+1)*4 = 256; out: 2*(2*4)*8 = 128
    (flops.attn_proj_flops, (), 384),
    # scores and values of 2 heads of 4 over 3 keys: 4*2*4*3
    (flops.attn_ctx_flops, (3,), 96),
    # gate, up, down of 16 neurons: 2*3*8*16
    (flops.ffn_flops, (16,), 768),
    # x A (8 x 2) then (.) B (2 x 16): 2*2*(8+16)
    (flops.predictor_flops, (), 96),
    (flops.head_flops, (), 160),
    # 3 tokens: 3*384 + causal 1+2+3 keys (96*2) + 3*768, + one head
    (flops.prefill_flops, (3,), 3 * 384 + 192 + 3 * 768 + 160),
    # position 2 (3 keys), 4 neurons: 384 + 96 + 192 + 96, + head
    (flops.decode_flops, (2, 4), 384 + 96 + 192 + 96 + 160),
])
def test_model_flops_by_hand(fn, args, want):
    assert fn(M, *args) == want


def test_cold_ffn_cost_by_hand():
    # B 2, D 8, r 2, 12 cold neurons, 4 picked, R 3, one group, kc 1:
    # bf16 x 16, A 16, B's cold slice 24, picked bundles 96 -> 152 * 2;
    # mask 2 * 4, y 2 * 8 * 4, ids 4
    nbytes, ops = flops.cold_ffn_cost(2, 8, 2, 12, 4, 3, 1, 1)
    assert nbytes == 2 * 152 + 8 + 64 + 4
    assert ops == 2 * 2 * (16 + 24 + 96)
    peaks = {"hbm_bytes": 100.0, "bf16_flops": 1000.0}
    assert flops.least_seconds(nbytes, ops, peaks) == pytest.approx(3.80)
    assert flops.least_seconds(10, 5000, peaks) == pytest.approx(5.0)


def test_traffic_blocks_hold_the_same_sizes_for_every_seed():
    mix = {"block": 8, "prompt": {"dist": "lognormal", "median": 100,
                                  "sigma": 0.7, "min": 16, "max": 512},
           "output": {"dist": "uniform", "min": 4, "max": 20}}
    q = quantiles(mix["prompt"], 8)
    assert q.min() >= 16 and q.max() <= 512 and np.all(np.diff(q) >= 0)
    # 4 + 16 * (i + 0.5) / 8
    assert quantiles(mix["output"], 8).tolist() == [5, 7, 9, 11, 13, 15, 17,
                                                    19]
    blocks = []
    for seed in (1, 2 ** 31 + 5):
        s = Stream(mix, 1000, seed)
        reqs = [s.next() for _ in range(16)]
        blocks.append([sorted(r.prompt_len for r in reqs[i:i + 8])
                       for i in (0, 8)])
        assert all(0 <= r.prompt.min() and r.prompt.max() < 1000
                   for r in reqs)
    assert blocks[0] == blocks[1]
    a, b = Stream(mix, 1000, 3), Stream(mix, 1000, 3)
    assert [a.next().prompt.tolist() for _ in range(3)] == \
        [b.next().prompt.tolist() for _ in range(3)]
