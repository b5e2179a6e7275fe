"""Mamba2-130M [arXiv:2405.21060] — SSD (state-space duality), attention-free.

d_ff=0: no FFN blocks at all -> the PowerInfer-2 hot/cold FFN technique is
INAPPLICABLE (DESIGN.md §Arch-applicability); implemented without it.
Natively sub-quadratic: long_500k decode runs on the recurrent state.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_head=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
)
