"""Quickstart on the port: train a reduced SmolLM on synthetic data, then
serve it with the PowerInfer-2 hybrid engine, the substrate end to end
(the counterpart of examples/quickstart.py).

  PYTHONPATH=src python examples_torch/quickstart.py                # card
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu

The plan is sized for the paper's phone (`planner.PHONE`); the
reference's example plans on its own default profile. The engine samples
from its own `torch.Generator`, seeded by its `seed`.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.baselines import POWERINFER2
from repro_torch.core.planner import PHONE, build_plan, permute_ffn_params
from repro_torch.launch.train import train
from repro_torch.serving.engine import ServeEngine


def plan_table(plan) -> dict:
    """{batch bucket: (hot neurons, cold budget)} of an ExecutionPlan."""
    return {b: (p.n_hot, p.total_cold) for b, p in sorted(plan.plans.items())}


def main(device=None) -> dict:
    """Train, plan and serve on `device` (default `cuda`); returns the
    losses, the plan table, the generated tokens, the modeled tok/s and
    the mean cache hit rate."""
    print("=== 1. train (reduced smollm-135m, synthetic tokens) ===")
    model, losses = train("smollm-135m", steps=60, batch_size=4,
                          seq_len=64, reduced=True, lr=2e-3, log_every=20,
                          device=device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")

    print("\n=== 2. offline plan (PowerInfer-2 §5) ===")
    cfg = get_config("smollm-135m").reduced()
    plan = build_plan(cfg, hw=PHONE)
    permute_ffn_params(model.module, plan.neuron_order)
    table = plan_table(plan)
    print("batch->plan:", table)

    print("\n=== 3. serve with 50% FFN offload (PowerInfer-2 §4) ===")
    engine = ServeEngine(cfg, model.module, plan, spec=POWERINFER2,
                         offload_ratio=0.5)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    res = engine.generate(prompt, max_new=16, temperature=0.8)
    hit = float(np.mean([s.cache_hit_rate for s in res.stats]))
    engine.close()
    print(f"generated {int((res.tokens >= 0).sum())} tokens; "
          f"modeled {res.tokens_per_s:.1f} tok/s; hit rate {hit:.1%}")
    print("tokens[0]:", res.tokens[0].tolist())
    return dict(losses=losses, plan=table, tokens=res.tokens,
                tokens_per_s=res.tokens_per_s, hit_rate=hit)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run here)")
    main(ap.parse_args().device)
