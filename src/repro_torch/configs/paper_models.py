"""The paper's own evaluation models (PowerInfer-2 §7.1).

Bamboo-7B [arXiv:2406.05955 TurboSparse] — ReLU-family, high sparsity.
TurboSparse-Mixtral-47B — 8-expert MoE, ~3B active params/token.
Mistral-7B (SiLU) — the §7.2.5 SiLU case.
"""
from repro_torch.configs.base import ModelConfig, SparseFFNConfig

BAMBOO_7B = ModelConfig(
    name="bamboo-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    activation="relu2",
    sparse_ffn=SparseFFNConfig(enabled=True, mode="relu",
                               hot_ratio=0.2, cold_active_ratio=0.08),
)

MISTRAL_7B = BAMBOO_7B.replace(
    name="mistral-7b-silu",
    activation="silu",
    sparse_ffn=SparseFFNConfig(enabled=True, mode="cats",
                               hot_ratio=0.4, cold_active_ratio=0.25),
)

TURBOSPARSE_MIXTRAL_47B = ModelConfig(
    name="turbosparse-mixtral-47b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    activation="relu2",
    num_experts=8,
    # TurboSparse's ReLUfication adds an always-on shared expert next
    # to the routed ones — the pinned hot prefix of the serving plane.
    num_shared_experts=1,
    experts_per_token=2,
    # expert-parallel over 'model' (8 experts / n shards), so the
    # serving EP goldens cover the two-level path shard-locally
    moe_shard_mode="ep",
    # the paper's headline case: the hybrid hot/cold FFN applies
    # *inside* each routed expert (DESIGN.md §9)
    moe_intra_expert=True,
    sparse_ffn=SparseFFNConfig(enabled=True, mode="relu",
                               hot_ratio=0.2, cold_active_ratio=0.08),
)
