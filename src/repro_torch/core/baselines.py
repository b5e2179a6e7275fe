"""Baseline system models the paper compares against (§7.1).

The paper evaluates against llama.cpp (dense compute, mmap offloading)
and LLMFlash (sparsity prediction + row-column bundling + neuron cache,
matrix-level overlap). Both are implemented here as engine
configurations over the same substrate, so benchmark deltas isolate the
paper's contributions exactly (bundle / cache / pipeline / hybrid —
the Fig 14 ablation ladder).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SystemSpec:
    name: str
    use_predictor: bool       # sparsity-aware (skip inactive neurons)
    use_bundling: bool        # Gate-Up-Down position-major fetches
    use_cache: bool           # neuron cache (vs re-read per token)
    pipeline: str             # 'none' (sync I/O) | 'matrix' | 'cluster'
    hybrid_engines: bool      # dense-hot + sparse-cold co-execution
    two_phase: bool = False   # gate-first cold loading
    # Without the segmented hot/cold split (§4.2), LLMFlash-style
    # co-activation bundles re-load hot neurons redundantly across
    # bundles — effective cache capacity shrinks.
    cache_efficiency: float = 1.0
    # Systems without a pinned hot region stream *all* activated
    # neurons (hot included) through the cache.
    pinned_hot: bool = False


LLAMACPP = SystemSpec(
    name="llama.cpp-mmap",
    use_predictor=False, use_bundling=False, use_cache=True,
    pipeline="none", hybrid_engines=False)

LLMFLASH = SystemSpec(
    name="llmflash",
    use_predictor=True, use_bundling=True, use_cache=True,
    pipeline="matrix", hybrid_engines=False, cache_efficiency=0.4)

POWERINFER2 = SystemSpec(
    name="powerinfer-2",
    use_predictor=True, use_bundling=True, use_cache=True,
    pipeline="cluster", hybrid_engines=True, two_phase=True,
    pinned_hot=True)

# Fig 14 ablation ladder (each adds one mechanism)
ABLATION_LADDER = (
    SystemSpec("baseline", True, False, False, "none", False),
    SystemSpec("+bundle", True, True, False, "none", False),
    SystemSpec("+cache", True, True, True, "none", False,
               pinned_hot=True),
    SystemSpec("+pipeline", True, True, True, "cluster", False,
               pinned_hot=True),
    SystemSpec("+xpu", True, True, True, "cluster", True, two_phase=True,
               pinned_hot=True),
)

ALL_SYSTEMS = (LLAMACPP, LLMFLASH, POWERINFER2)
