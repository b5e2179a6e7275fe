"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small, GQA kv=3.

The primary CPU-runnable demo model for examples/ and serving benchmarks.
"""
from repro_torch.configs.base import ModelConfig, SparseFFNConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    activation="silu",
    tie_embeddings=True,
    sparse_ffn=SparseFFNConfig(enabled=True, mode="cats",
                               hot_ratio=0.25, cold_active_ratio=0.15,
                               cluster_size=64),
)
