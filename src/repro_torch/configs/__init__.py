"""Config registry: get_config('<arch-id>') for every assigned
architecture (plus the paper's own models) and the four assigned input
shapes. A copy of `repro.configs`; the port never imports `repro`.
Families the port does not serve yet (moe, ssm, hybrid, encdec) are
registered all the same: `serving.families.serving_family` refuses them."""
from repro_torch.configs.base import (
    INPUT_SHAPES, InputShape, ModelConfig, SparseFFNConfig)

from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.llama3_405b import CONFIG as _llama3
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.smollm_135m import CONFIG as _smollm
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl
from repro_torch.configs.qwen3_14b import CONFIG as _qwen3
from repro_torch.configs.deepseek_moe_16b import CONFIG as _dsmoe
from repro_torch.configs.paper_models import (
    BAMBOO_7B, MISTRAL_7B, TURBOSPARSE_MIXTRAL_47B)

ASSIGNED_ARCHS = (
    "nemotron-4-15b", "llama3-405b", "recurrentgemma-9b",
    "seamless-m4t-large-v2", "grok-1-314b", "smollm-135m",
    "mamba2-130m", "qwen2-vl-2b", "qwen3-14b", "deepseek-moe-16b",
)

_REGISTRY = {c.name: c for c in (
    _nemotron, _llama3, _rgemma, _seamless, _grok, _smollm,
    _mamba2, _qwen2vl, _qwen3, _dsmoe,
    BAMBOO_7B, MISTRAL_7B, TURBOSPARSE_MIXTRAL_47B,
)}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)


__all__ = ["ModelConfig", "SparseFFNConfig", "InputShape", "INPUT_SHAPES",
           "ASSIGNED_ARCHS", "get_config", "list_archs"]
