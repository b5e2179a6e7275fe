"""Config registry: get_config('<arch-id>') for the architectures the
port serves so far. A copy of `repro.configs` cut to its entries; the
port never imports `repro`."""
from repro_torch.configs.base import ModelConfig, SparseFFNConfig
from repro_torch.configs.smollm_135m import CONFIG as _smollm

_REGISTRY = {c.name: c for c in (_smollm,)}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)


__all__ = ["ModelConfig", "SparseFFNConfig", "get_config", "list_archs"]
