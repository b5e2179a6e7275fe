"""Qwen3-14B [hf:Qwen/Qwen3-8B family] — dense, qk-norm, GQA kv=8."""
from repro_torch.configs.base import ModelConfig, SparseFFNConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    activation="silu",
    qk_norm=True,
    rope_theta=1000000.0,
    sparse_ffn=SparseFFNConfig(enabled=True, mode="cats",
                               hot_ratio=0.3, cold_active_ratio=0.2),
)
