"""PowerInfer-2 core: neuron clusters, hybrid hot/cold FFN, predictor,
planner, neuron cache, cold store and the cluster-level pipeline."""
