"""PowerInfer-2 core: neuron clusters, hybrid hot/cold FFN, activation
predictor, offline planner, segmented neuron cache, cold store and the
neuron-cluster-level pipeline.

Exports the reference's `repro.core` names that the port has (all but
`init_ffn`: the port's FFN weights live on `models.blocks.FFN`). They
load on first access, so importing one submodule does not import the
others (`adaptation` reaches the kernels, whose plain versions import
`sparse_ffn`)."""
import importlib

_EXPORTS = {
    "HybridPlan": "clusters", "make_plan": "clusters",
    "scale_plan_for_batch": "clusters",
    "init_predictor": "predictor", "predict_scores": "predictor",
    "predict_proba": "predictor",
    "ffn_dense": "sparse_ffn", "ffn_hybrid": "sparse_ffn",
    "ffn_apply": "sparse_ffn",
    "ExecutionPlan": "planner", "HardwareProfile": "planner",
    "build_plan": "planner", "profile_activations": "planner",
    "classify_neurons": "planner", "permute_ffn_params": "planner",
    "synthetic_frequencies": "planner",
    "NeuronCache": "cache", "CacheStats": "cache",
    "ColdStore": "coldstore",
    "ClusterTask": "pipeline", "simulate_pipeline": "pipeline",
    "make_decode_tasks": "pipeline", "PrefetchExecutor": "pipeline",
    "BucketedDecoder": "adaptation", "BatchTracker": "adaptation",
    "bucket_for": "adaptation",
}

__all__ = sorted(_EXPORTS) + ["baselines"]


def __getattr__(name):
    if name == "baselines":
        return importlib.import_module(f"{__name__}.baselines")
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
