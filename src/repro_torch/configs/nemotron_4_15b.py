"""Nemotron-4 15B [arXiv:2402.16819] — dense, GQA, squared-ReLU FFN.

Squared-ReLU is a ReLU-family activation (paper §2.1): natively sparse,
the PowerInfer-2 technique's home turf -> sparse_ffn mode 'relu'.
"""
from repro_torch.configs.base import ModelConfig, SparseFFNConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    activation="relu2",
    rope_theta=10000.0,
    sparse_ffn=SparseFFNConfig(enabled=True, mode="relu",
                               hot_ratio=0.25, cold_active_ratio=0.10),
)
