"""Qwen2-VL-2B [arXiv:2409.12191] — VLM backbone, M-RoPE, GQA kv=2.

LM backbone only (per brief): the ViT vision encoder + projector is a
stub; input_specs() supplies patch embeddings (B, num_image_tokens,
d_model) which the model interleaves ahead of text tokens with
multimodal 3D rotary positions (M-RoPE, sections over d_head//2).
d_head = 1536/12 = 128 -> half 64 -> sections (16, 24, 24).
"""
from repro_torch.configs.base import ModelConfig, SparseFFNConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    activation="silu",
    rope_theta=1000000.0,
    num_image_tokens=1024,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,
    sparse_ffn=SparseFFNConfig(enabled=True, mode="cats",
                               hot_ratio=0.3, cold_active_ratio=0.2),
)
