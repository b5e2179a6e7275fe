"""RecurrentGemma-9B [arXiv:2402.19427 Griffin] — RG-LRU + local attention.

Pattern 1 local-attention : 2 recurrent blocks ('rec','rec','attn').
38 layers = 12 full groups + 2 remainder recurrent blocks.
GeGLU MLP blocks carry the sparse-FFN technique; the RG-LRU recurrence
itself is dense (see DESIGN.md §Arch-applicability). MQA (kv=1).
Natively sub-quadratic: local attention window 2048.
"""
from repro_torch.configs.base import ModelConfig, SparseFFNConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    activation="geglu",
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    tie_embeddings=True,
    sparse_ffn=SparseFFNConfig(enabled=True, mode="cats",
                               hot_ratio=0.4, cold_active_ratio=0.2),
)
