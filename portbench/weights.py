"""The model's weights, made on the device from the run's seed.

One `torch.Generator` on the device draws each kind of weight for all
layers in one call, in the type it is served in: the embedding, the LM
head, the q, k, v and output projections, the bundled FFN
(N, R, D) and the predictor's A and B. The same seed gives the same
tensors bit for bit, so the plain reference draws them again after the
window instead of reading anything the program made or changed (the
port permutes its FFN rows in place)."""
from __future__ import annotations

import math

import torch

from portbench.traffic import seed_seq


def ffn_rows(activation: str) -> int:
    """Rows of a neuron bundle: gate, up, down (R = 3), or fc1, fc2 for
    the ungated gelu (R = 2)."""
    return 2 if activation == "gelu" else 3


def vocab_padded(m: dict) -> int:
    return (m["vocab_size"] + 255) // 256 * 256


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_weights(m: dict, seed: int, device) -> dict:
    """Stacked weights of the dense-family model `m` (a configuration
    file's "model"), in its parameter type: name -> tensor, each layer's
    leaf a view [l]."""
    dtype = DTYPES[m["param_dtype"]]
    g = torch.Generator(device=device).manual_seed(seed_seq(seed))
    L, D, N = m["num_layers"], m["d_model"], m["d_ff"]
    H, KV, dh = m["num_heads"], m["num_kv_heads"], m["d_head"]
    R, V = ffn_rows(m["activation"]), vocab_padded(m)
    r = m["sparse_ffn"]["predictor_rank"]

    def randn(*shape, scale):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dtype).mul_(scale)

    w = {
        "embed": randn(V, D, scale=0.02),
        "lm_head": randn(D, V, scale=1 / math.sqrt(D)),
        "wq": randn(L, D, H * dh, scale=1 / math.sqrt(D)),
        "wk": randn(L, D, KV * dh, scale=1 / math.sqrt(D)),
        "wv": randn(L, D, KV * dh, scale=1 / math.sqrt(D)),
        "wo": randn(L, H * dh, D, scale=1 / math.sqrt(H * dh)),
        "ffn": randn(L, N, R, D, scale=1 / math.sqrt(D)),
        "pred_A": randn(L, D, r, scale=1 / math.sqrt(D)),
        "pred_B": randn(L, r, N, scale=1 / math.sqrt(r)),
    }
    # the last bundle row is the down projection: fan-in N
    w["ffn"][:, :, R - 1].mul_(math.sqrt(D / N))
    return w


@torch.no_grad()
def load_into(model, w: dict):
    """Point the port's dense model's parameters at the stacked weights
    (views, no copy); norm weights stay zero."""
    model.embed.data = w["embed"]
    model.lm_head.data = w["lm_head"]
    for l, layer in enumerate(model.layers):
        for name in ("wq", "wk", "wv", "wo"):
            getattr(layer.attn, name).data = w[name][l]
        layer.ffn.w.data = w["ffn"][l]
        layer.ffn.pred_A.data = w["pred_A"][l]
        layer.ffn.pred_B.data = w["pred_B"][l]
    return model
