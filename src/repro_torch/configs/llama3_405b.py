"""Llama-3.1 405B [arXiv:2407.21783] — dense, GQA kv=8, 128k vocab, SiLU.

SiLU model: technique applies in CATS-style thresholded-sparsity mode
(paper §7.2.5, Table 6).
"""
from repro_torch.configs.base import ModelConfig, SparseFFNConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    activation="silu",
    rope_theta=500000.0,
    sparse_ffn=SparseFFNConfig(enabled=True, mode="cats",
                               hot_ratio=0.5, cold_active_ratio=0.25),
)
