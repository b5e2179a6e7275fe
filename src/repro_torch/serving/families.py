"""Serving family registry (counterpart of `repro/serving/families.py`).

Every family the engine can serve is one `ServingFamily` entry keyed on
`cfg.family`, bundling the family-specific pieces of the stack:

* `make_model(cfg, device, seed)` — the data-plane model (its layers
  carry their FFN, so `dense.prefill` runs every family's model);
* `make_decode_step(cfg, shard=None)` — the decode callable with the
  serving signature `(model, tokens, cache, plan, active_mask) ->
  (logits, cache, trace)`, over `shard`'s ranks when given, trace = the activation trace the storage plane
  prices: (L, G, kc) cold-cluster ids for dense and vlm, (L, E)
  kept-dispatch expert counts for moe, or the two-level (L, E, 1+ncc)
  form when cfg.moe_intra_expert prices clusters inside each expert;
* `build_plan(cfg, freqs=None, *, hw, backend="jnp",
  storage_dtype="fp16")` — the ExecutionPlan of the bucketed decoder
  and the storage plane (dense: the hot-first planner; moe: experts as
  clusters, `build_moe_plan`);
* `prepare_params(model, plan)` — the offline weight transform, in
  place: the hot-first neuron permutation (moe: the per-expert one of
  two-level plans, none for whole experts), then the cold bundles'
  quantization to the plan's storage dtype;
* `backends` — the cold-path backends the family serves: 'pallas'
  (the fused CUDA kernel) only where the cold path is a cluster gather;
  moe's is expert dispatch.

The `vlm` entry serves the LM backbone through the dense data plane, as
the reference's does: engine prompts are token streams, decoded with
plain 1-D RoPE (the M-RoPE model is `models/vlm.py`). The ssm, hybrid
and encdec families are not served, here as in the reference; their
configs raise.
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
    make_decode_step: Callable     # (cfg, shard=None) -> decode callable
    build_plan: Callable           # (cfg, freqs=None, *, hw, backend,
                                   #  storage_dtype) -> ExecutionPlan
    prepare_params: Callable       # (model, plan) -> model
    default_arch: str = ""         # the family's representative config
    backends: tuple = ("jnp",)     # cold-path backends served


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
        make_decode_step=lambda cfg, shard=None: dense.make_decode_step(
            cfg, collect_indices=True, shard=shard),
        build_plan=_dense_build_plan,
        prepare_params=_dense_prepare,
        default_arch=arch,
        backends=("jnp", "pallas"),
    )


def _moe_build_plan(cfg, freqs=None, *, hw, backend="jnp",
                    storage_dtype="fp16"):
    # freqs: within-expert activation frequencies (L, E*f) of the
    # two-level plan (cfg.moe_intra_expert); ignored for whole experts
    if backend not in (None, "jnp"):
        raise ValueError(
            f"moe has no {backend!r} cold-path backend: its cold path "
            f"is expert dispatch (models/moe.py), not a cluster gather")
    from repro_torch.core.planner import build_moe_plan
    return build_moe_plan(cfg, freqs, hw=hw, storage_dtype=storage_dtype)


def _moe_prepare(model, plan):
    # two-level plans carry a per-expert hot-first permutation; the
    # whole-expert order is the identity (the experts are the clusters).
    # Then the routed experts' cold rows are quantized for non-fp16
    # plans.
    if any(getattr(p, "n_expert_hot", 0) for p in plan.plans.values()):
        from repro_torch.core.planner import permute_moe_params
        model = permute_moe_params(model, plan.neuron_order)
    from repro_torch.quant.storage import quantize_plan_params
    return quantize_plan_params(model, plan)


def _moe_family() -> ServingFamily:
    from repro_torch.models import moe
    return ServingFamily(
        family="moe",
        make_model=moe.make_model,
        make_decode_step=lambda cfg, shard=None: moe.make_decode_step(
            cfg, collect_indices=True, shard=shard),
        build_plan=_moe_build_plan,
        prepare_params=_moe_prepare,
        default_arch="deepseek-moe-16b",
    )


register_family(_dense_family("dense", "smollm-135m"))
register_family(_dense_family("vlm", "qwen2-vl-2b"))
register_family(_moe_family())
