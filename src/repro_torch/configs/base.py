"""Model configuration system.

A single `ModelConfig` dataclass covers all six architecture families
(dense / moe / ssm / hybrid / encdec / vlm). Every assigned architecture
gets one file in this package instantiating the exact published config,
with the source paper / model card cited in the docstring.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class SparseFFNConfig:
    """PowerInfer-2 hybrid hot/cold FFN settings (the paper's technique).

    Neurons (FFN rows) are permuted offline by the planner so that the
    `hot_ratio` most frequently activated neurons form a contiguous *hot*
    prefix computed densely (the NPU/MXU path); the remaining *cold*
    neurons are computed through the predictor-gated gathered-cluster
    path (the CPU/sparse path).
    """
    enabled: bool = False
    # Fraction of FFN neurons in the dense hot prefix (batch-size bucket 1).
    hot_ratio: float = 0.25
    # Fraction of *cold* neurons actually computed per step (top-k budget).
    cold_active_ratio: float = 0.10
    # Low-rank activation predictor rank.
    predictor_rank: int = 64
    # Neuron-cluster granularity (rows per cluster).
    cluster_size: int = 128
    # Activation mode: 'relu' family has native zeros; 'cats' thresholds
    # SiLU activations (paper §7.2.5 — CATS / CHESS style ~50% sparsity).
    mode: str = "relu"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // num_heads
    activation: str = "silu"         # silu | relu2 | gelu | geglu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- attention variant ---
    sliding_window: int = 0          # 0 = full attention
    # auto-substituted window for long_500k on full-attention archs:
    long_context_window: int = 4096

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_shard_mode: str = "ep"       # 'ep' (experts over model axis) | 'tp'
    # Hierarchical dispatch (§Perf iteration): tokens dispatch to experts
    # within data-local groups (capacity per group), so the dispatch
    # buffer shards over the batch axes instead of materializing a
    # global (E, C_global, D) buffer. Launcher sets = data*pod shards.
    moe_dispatch_groups: int = 1
    # Intra-expert hot/cold sparsity (the paper's TurboSparse-Mixtral
    # path, DESIGN.md §9): each routed expert's d_ff rows get the
    # dense-family hybrid treatment — a per-expert hot-first
    # permutation with a pinned per-expert hot prefix, cold rows priced
    # as sparse_ffn.cluster_size clusters from the real activation
    # trace. False = whole experts are the cluster unit (DESIGN.md §8).
    moe_intra_expert: bool = False

    # --- SSM (Mamba-2 / SSD, arXiv:2405.21060) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- hybrid (RecurrentGemma / Griffin, arXiv:2402.19427) ---
    block_pattern: tuple = ()        # e.g. ('rec','rec','attn'); () = all attn
    local_window: int = 0            # local-attention window for 'attn' blocks
    rglru_conv_width: int = 4
    rglru_c: float = 8.0

    # --- encoder-decoder (audio) ---
    num_encoder_layers: int = 0
    # stub modality frontend: input_specs() provides (B, n_frames, d_model)
    num_frames: int = 4096

    # --- VLM ---
    num_image_tokens: int = 0        # patch embeddings prepended to text
    mrope_sections: tuple = ()       # M-RoPE section split of d_head//2

    # --- the paper's technique ---
    sparse_ffn: SparseFFNConfig = field(default_factory=SparseFFNConfig)

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True               # activation checkpointing over layer scan

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.num_heads, 1))

    # ---- derived ----
    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding shards over
        any mesh axis (production practice; invalid logits are masked)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if the arch natively supports 500k-token decode."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def moe_flat_neurons(self) -> int:
        """Flat serving neuron space of a MoE layer: shared experts
        first (the pinned hot prefix — always-dense clusters), then the
        routed experts (cold clusters of d_ff neurons each). This is
        the experts-as-clusters mapping the storage plane prices
        (DESIGN.md §8)."""
        return (self.num_shared_experts + self.num_experts) * self.d_ff

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        kv = self.num_kv_heads
        h = self.num_heads
        dh = self.d_head
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
        if self.family == "ssm":
            di, ns = self.ssm_d_inner, self.ssm_state
            blk = d * (2 * di + 2 * ns + self.ssm_heads) + di * d + di * self.ssm_conv_width
            return emb + self.num_layers * blk
        ffn = 3 * d * f
        if self.num_experts:
            ffn = ffn * self.num_experts + 3 * d * f * self.num_shared_experts \
                + d * self.num_experts
        blk = attn + ffn
        n_layers = self.num_layers + self.num_encoder_layers
        return emb + n_layers * blk

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed-active experts)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        full = self.param_count()
        ffn_all = 3 * d * f * self.num_experts
        ffn_act = 3 * d * f * self.experts_per_token
        return full - self.num_layers * (ffn_all - ffn_act)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests.

        2 layers, d_model<=512, <=4 experts, small vocab — per the brief.
        """
        kw = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            d_head=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            num_frames=64,
        )
        if self.num_experts:
            kw["num_experts"] = min(self.num_experts, 4)
            kw["num_shared_experts"] = min(self.num_shared_experts, 1)
            kw["experts_per_token"] = min(self.experts_per_token, 2)
        if self.num_encoder_layers:
            kw["num_encoder_layers"] = 2
        if self.block_pattern:
            kw["num_layers"] = len(self.block_pattern) + 2  # full group + remainder
        if self.num_image_tokens:
            kw["num_image_tokens"] = 16
        if self.mrope_sections:
            kw["mrope_sections"] = (8, 12, 12)  # sums to 32 = d_head//2
        if self.ssm_state:
            kw["ssm_state"] = min(self.ssm_state, 64)
            kw["ssm_head_dim"] = 32
            kw["ssm_chunk"] = 32
        if self.sparse_ffn.enabled:
            kw["sparse_ffn"] = dataclasses.replace(
                self.sparse_ffn, predictor_rank=16, cluster_size=32)
        return self.replace(**kw)


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}
