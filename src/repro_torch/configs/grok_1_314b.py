"""Grok-1 314B [hf:xai-org/grok-1] — MoE, 8 experts top-2, GQA kv=8.

8 experts < model-axis size (16) -> tensor-parallel *inside* experts
(moe_shard_mode='tp'); see DESIGN.md §5. Technique applies within
experts (the paper's TurboSparse-Mixtral case).
"""
from repro_torch.configs.base import ModelConfig, SparseFFNConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    activation="gelu",
    num_experts=8,
    experts_per_token=2,
    moe_shard_mode="tp",
    sparse_ffn=SparseFFNConfig(enabled=True, mode="cats",
                               hot_ratio=0.4, cold_active_ratio=0.2),
)
