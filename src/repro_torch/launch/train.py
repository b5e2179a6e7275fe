"""End-to-end training driver of the port (counterpart of
`repro/launch/train.py`).

Trains a config on the seeded synthetic corpus (`data/pipeline.py`,
bit-identical to the reference's) with AdamW, and reports the loss.
Runs on the CUDA card unless `--device cpu`:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch smollm-135m --steps 30 --batch 4 --seq 32 --lr 2e-3

  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 40 \
      --batch 4 --seq 64 --lr 2e-3          # smollm-135m at full width

The trained weights are written by code, not by a flag (as in the
reference): `checkpoint.ckpt.save_checkpoint(path,
bridge.params_to_numpy(model.module))`, read back by
`bridge.load_checkpoint`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, shard_batch
from repro_torch.models.model import build_model, wrap
from repro_torch.models.modules import resolve_device
from repro_torch.optim.adamw import AdamW
from repro_torch.train.steps import make_train_step


def add_modal_inputs(batch, cfg, rng):
    """The stub frontends, drawn from `rng` (a numpy Generator) exactly
    as the reference draws them: the encdec's frame embeddings (B,
    num_frames, D), the vlm's patch embeddings (B, P, D)."""
    B = batch["tokens"].shape[0]
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.num_frames, cfg.d_model)).astype(np.float32) * 0.1
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32) * 0.1
    return batch


def train(arch: str, steps: int = 100, batch_size: int = 8,
          seq_len: int = 128, reduced: bool = True, lr: float = 1e-3,
          log_every: int = 20, seed: int = 0, device=None, params=None):
    """Train `arch` (its `.reduced()` config unless reduced=False) for
    `steps` AdamW steps on `device` (default `cuda`; raises without a
    card). Weights are random from a `torch.Generator` seeded by `seed`,
    or `params`, a reference-layout numpy tree (as `params_to_numpy`
    gives it). Returns (the trained Model, the loss of every step)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    device = resolve_device(device)
    model = build_model(cfg, device, seed) if params is None else \
        wrap(params_from_numpy(params, cfg, device))
    opt = AdamW(lr=lr)
    weights = model.params()
    opt_state = opt.init(weights)
    step_fn = make_train_step(model, opt)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq_len, batch_size,
                                      seed=seed))
    rng = np.random.default_rng(seed)
    losses = []
    t0 = time.time()
    for i in range(steps):
        batch = shard_batch(add_modal_inputs(data.batch(), cfg, rng), device)
        weights, opt_state, metrics = step_fn(weights, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"({(time.time() - t0) / (i + 1):.3f}s/step)", flush=True)
    return model, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run here)")
    args = ap.parse_args(argv)
    model, losses = train(args.arch, args.steps, args.batch, args.seq,
                          args.reduced, args.lr, device=args.device)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f}) on "
          f"{model.module.device}")


if __name__ == "__main__":
    main()
