"""Serving family registry (counterpart of `repro/serving/families.py`).

Every family the engine can serve is one `ServingFamily` entry keyed on
`cfg.family`, bundling the family-specific pieces of the stack:

* `make_model(cfg, device, seed)` — the data-plane model;
* `make_decode_step(cfg)` — the decode callable with the serving
  signature `(model, tokens, cache, plan, active_mask) -> (logits,
  cache, trace)`, trace = the (L, G, kc) cold-cluster ids the storage
  plane prices;
* `build_plan(cfg, freqs=None, *, hw, backend="jnp",
  storage_dtype="fp16")` — the ExecutionPlan of the bucketed decoder
  and the storage plane;
* `prepare_params(model, plan)` — the offline weight transform, in
  place: the hot-first neuron permutation, then the cold bundles'
  quantization to the plan's storage dtype.

The `vlm` entry serves the LM backbone through the dense data plane, as
the reference's does: engine prompts are token streams, decoded with
plain 1-D RoPE (the M-RoPE model is `models/vlm.py`). moe comes in a
later slice; its configs, and those of the ssm, hybrid and encdec
families, raise here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

__all__ = ["ServingFamily", "register_family", "serving_family",
           "servable_families", "default_archs"]


@dataclass(frozen=True)
class ServingFamily:
    """One servable model family's factory bundle."""
    family: str
    make_model: Callable           # (cfg, device, seed) -> DenseModel
    make_decode_step: Callable     # (cfg) -> serving decode callable
    build_plan: Callable           # (cfg, freqs=None, *, hw, backend,
                                   #  storage_dtype) -> ExecutionPlan
    prepare_params: Callable       # (model, plan) -> model
    default_arch: str = ""         # the family's representative config


_REGISTRY: dict = {}


def register_family(fam: ServingFamily):
    _REGISTRY[fam.family] = fam
    return fam


def servable_families() -> tuple:
    return tuple(sorted(_REGISTRY))


def default_archs() -> dict:
    return {f: e.default_arch for f, e in sorted(_REGISTRY.items())}


def serving_family(cfg) -> ServingFamily:
    """Registry lookup for a config's family; unknown families raise
    with the servable set named."""
    if cfg.family not in _REGISTRY:
        raise ValueError(
            f"family {cfg.family!r} ({cfg.name}) is not servable; "
            f"registered families: {servable_families()}")
    return _REGISTRY[cfg.family]


# ------------------------------------------------- built-in families ----

def _dense_build_plan(cfg, freqs=None, *, hw, backend="jnp",
                      storage_dtype="fp16"):
    from repro_torch.core.planner import build_plan
    return build_plan(cfg, freqs, hw=hw, backend=backend,
                      storage_dtype=storage_dtype)


def _dense_prepare(model, plan):
    from repro_torch.core.planner import permute_ffn_params
    from repro_torch.quant.storage import quantize_plan_params
    model = permute_ffn_params(model, plan.neuron_order)
    return quantize_plan_params(model, plan)


def _dense_family(name: str, arch: str) -> ServingFamily:
    from repro_torch.models import dense
    return ServingFamily(
        family=name,
        make_model=dense.make_model,
        make_decode_step=lambda cfg: dense.make_decode_step(
            cfg, collect_indices=True),
        build_plan=_dense_build_plan,
        prepare_params=_dense_prepare,
        default_arch=arch,
    )


register_family(_dense_family("dense", "smollm-135m"))
register_family(_dense_family("vlm", "qwen2-vl-2b"))
