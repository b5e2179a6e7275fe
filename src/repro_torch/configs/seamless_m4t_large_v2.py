"""SeamlessM4T-large v2 [arXiv:2308.11596] — encoder-decoder audio backbone.

Transformer backbone only (per brief): the mel-spectrogram + conformer
feature frontend is a stub; input_specs() supplies precomputed frame
embeddings (B, num_frames, d_model). 24 encoder + 24 decoder layers,
MHA (kv=16=heads), d_ff 8192, vocab 256206. GELU FFNs carry the
technique in 'cats' mode.
"""
from repro_torch.configs.base import ModelConfig, SparseFFNConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    activation="gelu",
    num_frames=4096,
    sparse_ffn=SparseFFNConfig(enabled=True, mode="cats",
                               hot_ratio=0.4, cold_active_ratio=0.2),
)
