"""DeepSeekMoE-16B [arXiv:2401.06066] — 2 shared + 64 routed experts, top-6.

Fine-grained experts (d_ff=1408) map 1:1 onto the paper's neuron-cluster
abstraction: shared experts = hot clusters (always-dense), routed
experts = cold clusters (predictor=router). EP sharding (64/16 = 4
experts per model shard).
"""
from repro_torch.configs.base import ModelConfig, SparseFFNConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    activation="silu",
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_shard_mode="ep",
    sparse_ffn=SparseFFNConfig(enabled=True, mode="cats",
                               hot_ratio=0.5, cold_active_ratio=0.25),
)
