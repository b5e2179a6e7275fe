"""Offline planner walkthrough on the port (paper §5; the counterpart of
examples/plan_and_inspect.py): profile real activations, classify
neurons into hot/cold per batch-size bucket, inspect the I/O-aware
sizing, save and reload the execution plan.

  PYTHONPATH=src python examples_torch/plan_and_inspect.py          # card
  PYTHONPATH=src python examples_torch/plan_and_inspect.py --device cpu

The profiling batches are drawn with numpy from seeds 0..7, so both
packages profile the same tokens; the plans are sized for the paper's
phone (`planner.PHONE`), the slow and fast tiers by its sequential
bandwidth alone.
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.planner import (PHONE, ExecutionPlan, build_plan,
                                      profile_activations)
from repro_torch.models.model import build_model
from repro_torch.models.modules import resolve_device

N_BATCHES, BATCH_SHAPE = 8, (4, 128)


def relu_config():
    """Reduced smollm-135m with relu2 and the relu-mode sparse FFN."""
    cfg = get_config("smollm-135m").reduced().replace(activation="relu2")
    return cfg.replace(sparse_ffn=dataclasses.replace(cfg.sparse_ffn,
                                                      mode="relu"))


def batches(cfg):
    """The profiling corpus: N_BATCHES (4, 128) batches of uniform ids,
    batch i from numpy's generator seeded i."""
    return [np.random.default_rng(i).integers(0, cfg.vocab_size,
                                              BATCH_SHAPE).astype(np.int32)
            for i in range(N_BATCHES)]


def main(device=None, params=None) -> dict:
    """Profile, plan and round-trip on `device` (default `cuda`), the
    weights random from seed 0 or `params` (a reference-layout numpy
    tree); returns the counts, the plan tables and the round trip."""
    device = resolve_device(device)
    cfg = relu_config()
    model = build_model(cfg, device, seed=0).module if params is None \
        else params_from_numpy(params, cfg, device)

    print("=== profiling activations (paper: 10M tokens; demo: 4k) ===")
    counts, n_tok = profile_activations(
        model, cfg, [torch.from_numpy(b).to(device) for b in batches(cfg)])
    freqs = (counts / n_tok).astype(np.float32)
    print(f"profiled {n_tok} tokens; "
          f"layer-0 activation freq: min {freqs[0].min():.3f} "
          f"max {freqs[0].max():.3f}")

    print("\n=== classification across batch buckets ===")
    plan = build_plan(cfg, freqs, hw=PHONE)
    table = {b: (p.n_hot, p.total_cold) for b, p in sorted(plan.plans.items())}
    for b, (hot, cold) in table.items():
        print(f"batch<={b:3d}: hot {hot:5d} neurons "
              f"({hot / cfg.d_ff:5.1%}) cold budget {cold:5d}")

    print("\n=== I/O-aware hot sizing (slow vs fast tier) ===")
    tier = lambda bw: dataclasses.replace(PHONE, name=f"{PHONE.name}, "
                                          f"{bw:.0e} B/s", seq_bw=bw)
    slow = build_plan(cfg, freqs, hw=tier(5e7))
    fast = build_plan(cfg, freqs, hw=tier(50e9))
    hot32 = (slow.plans[32].n_hot, fast.plans[32].n_hot)
    print(f"slow-tier hot @b32: {hot32[0]}  fast-tier hot @b32: {hot32[1]}")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "plan.json")
        plan.save(path)
        plan2 = ExecutionPlan.load(path)
        same, size = plan2.plans == plan.plans, os.path.getsize(path)
    print(f"\nplan round-trips: {same} ({size} bytes)")
    return dict(counts=counts, n_tok=n_tok, plan=table, hot32=hot32,
                round_trip=same)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run here)")
    main(ap.parse_args().device)
