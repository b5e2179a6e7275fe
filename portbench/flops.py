"""Operations and bytes the served work needs, from shapes alone.

`m` is a configuration file's "model" (dense family). A multiply-add
counts two operations. Counted: the q, k, v and output projections;
attention's scores and weighted values over the keys each query really
sees (causal in the prefill, the request's context in a decode step);
the FFN neurons the step computes (all N in the prefill, the plan's hot
prefix and picked cold clusters in a decode step) and, in a decode step,
the predictor that picks them; the LM head over the real vocabulary at
every position whose logits are used (the prefill's last, every decode
token). Not counted: norms, RoPE, softmax, sampling, padding rows of a
bucket and masked cache positions."""
from __future__ import annotations

from portbench.weights import ffn_rows


def attn_proj_flops(m: dict) -> int:
    D, H, KV, dh = m["d_model"], m["num_heads"], m["num_kv_heads"], m["d_head"]
    return 2 * D * (H + 2 * KV) * dh + 2 * H * dh * D


def attn_ctx_flops(m: dict, keys: int) -> int:
    """Scores and weighted values of one query over `keys` keys."""
    return 4 * m["num_heads"] * m["d_head"] * keys


def ffn_flops(m: dict, neurons: int) -> int:
    return 2 * ffn_rows(m["activation"]) * m["d_model"] * neurons


def predictor_flops(m: dict) -> int:
    r = m["sparse_ffn"]["predictor_rank"]
    return 2 * r * (m["d_model"] + m["d_ff"])


def head_flops(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab_size"]


def prefill_flops(m: dict, S: int) -> int:
    """A dense prefill of S prompt tokens (logits at the last one)."""
    per_layer = (S * attn_proj_flops(m)
                 + attn_ctx_flops(m, S * (S + 1) // 2)
                 + S * ffn_flops(m, m["d_ff"]))
    return m["num_layers"] * per_layer + head_flops(m)


def decode_flops(m: dict, pos: int, neurons: int) -> int:
    """One decode token at position `pos` (it sees pos + 1 keys) through
    a hybrid FFN that computes `neurons` neurons a layer."""
    per_layer = (attn_proj_flops(m) + attn_ctx_flops(m, pos + 1)
                 + ffn_flops(m, neurons) + predictor_flops(m))
    return m["num_layers"] * per_layer + head_flops(m)


def cold_ffn_cost(B: int, D: int, r: int, Nc: int, K: int, R: int,
                  G: int, kc: int, itemsize: int = 2) -> tuple:
    """(bytes, operations) of one `fused_cold_ffn` call over B rows: x,
    the predictor's A and cold slice of B, and the K picked neurons'
    bundles read once; the live mask read, y (fp32) and the ids written
    once. Operations: the predictor's two products and the picked
    bundles' R dot products per row."""
    nbytes = (itemsize * (B * D + D * r + r * Nc + K * R * D)
              + 4 * B + 4 * B * D + 4 * G * kc)
    ops = 2 * B * (D * r + r * Nc + K * R * D)
    return nbytes, ops


def least_seconds(nbytes: int, ops: int, peaks: dict) -> float:
    """The roofline's least time: the larger of bytes over the memory
    rate and operations over the bf16 peak."""
    return max(nbytes / peaks["hbm_bytes"], ops / peaks["bf16_flops"])
