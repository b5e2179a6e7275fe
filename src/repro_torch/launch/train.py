"""End-to-end training driver of the port (counterpart of
`repro/launch/train.py`).

Trains a config on the seeded synthetic corpus (`data/pipeline.py`,
bit-identical to the reference's) with AdamW, and reports the loss.
Runs on the CUDA card unless `--device cpu`:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch smollm-135m --steps 30 --batch 4 --seq 32 --lr 2e-3

  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 40 \
      --batch 4 --seq 64 --lr 2e-3          # smollm-135m at full width

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --tp 2 --dp 2 --steps 10 --batch 4 --seq 32   # over 4 gloo ranks

`--tp N` splits each replica's model over N ranks, in every family (an
moe arch splits its experts as its `moe_shard_mode` says; mamba2 its
heads, the hybrid its LRU channels), `--dp N` runs N
data-parallel replicas, each on its rows of the global batch: dp * tp
ranks, spawned as gloo processes on the one host (`parallel.spawn`; on
the card they share it). Each rank draws the seeded weights leaf by
leaf and keeps its slice; replica 0's trained slices are gathered on
its rank 0 (`bridge.gather_params`) into the whole model that one rank
would have trained.

The trained weights are written by code, not by a flag (as in the
reference): `checkpoint.ckpt.save_checkpoint(path,
bridge.params_to_numpy(model.module))`, read back by
`bridge.load_checkpoint`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.bridge import gather_params, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, shard_batch
from repro_torch.models.model import build_model, wrap
from repro_torch.models.modules import resolve_device
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import grid, replica_cfg, spawn
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
          log_every: int = 20, seed: int = 0, device=None, params=None,
          tp: int = 1, dp: int = 1):
    """Train `arch` (its `.reduced()` config unless reduced=False) for
    `steps` AdamW steps on `device` (default `cuda`; raises without a
    card). Weights are random from a `torch.Generator` seeded by `seed`,
    or `params`, a reference-layout numpy tree (as `params_to_numpy`
    gives it). With tp * dp > 1, over that many spawned gloo ranks
    (module docstring). Returns (the trained Model, whole, on `device`;
    the loss of every step, rank 0's)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    device = resolve_device(device)
    kw = dict(steps=steps, batch_size=batch_size, seq_len=seq_len, lr=lr,
              log_every=log_every, seed=seed, params=params)
    if tp * dp == 1:
        model, losses = run(cfg, device, **kw)
        return model, losses
    out = spawn(_train_rank, tp * dp, cfg, kw, tp, dp, device=device,
                timeout=3600.0)
    losses, tree = out[0]
    return wrap(params_from_numpy(tree.tree, cfg, device,
                                  dtypes=tree.dtypes)), losses


def _train_rank(world, cfg, kw, tp, dp):
    """One rank of `train` over the dp x tp grid: (losses, the gathered
    whole tree on world rank 0, else None). The replicas hold the same
    weights, so only replica 0's ranks gather."""
    rows, cols = grid(world, dp, tp)
    model, losses = run(cfg, world.device, shard=rows, data=cols, **kw)
    tree = gather_params(model.module, rows) if cols.rank == 0 else None
    return losses, tree


def run(cfg, device, steps, batch_size, seq_len, lr, log_every=20, seed=0,
        params=None, shard=None, data=None):
    """The training loop on this process: the model (this rank's slice
    over `shard`, dp = `data`'s size replicas) trained `steps` AdamW
    steps on the seeded synthetic corpus, each replica on its rows of
    every global batch. Returns (Model, losses)."""
    dp = 1 if data is None else data.size
    replica = 0 if data is None else data.rank
    rcfg = replica_cfg(cfg, dp)
    if params is None:
        model = build_model(rcfg, device, seed, shard=shard)
    else:
        model = wrap(params_from_numpy(params, rcfg, device, shard=shard),
                     shard)
    opt = AdamW(lr=lr)
    weights = model.params()
    opt_state = opt.init(weights)
    step_fn = make_train_step(model, opt, data=data)
    corpus = SyntheticTokens(DataConfig(cfg.vocab_size, seq_len, batch_size,
                                        seed=seed))
    rng = np.random.default_rng(seed)
    losses = []
    loud = log_every and (shard is None or shard.rank == 0) and replica == 0
    t0 = time.time()
    for i in range(steps):
        batch = shard_batch(add_modal_inputs(corpus.batch(), cfg, rng),
                            device, replica, dp)
        weights, opt_state, metrics = step_fn(weights, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if loud and (i % log_every == 0 or i == steps - 1):
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
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks each replica's model splits over")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel replicas, each on its rows of the "
                         "batch, each over --tp ranks")
    args = ap.parse_args(argv)
    if args.tp < 1 or args.dp < 1:
        ap.error("--tp and --dp count ranks and replicas: at least 1 each")
    model, losses = train(args.arch, args.steps, args.batch, args.seq,
                          args.reduced, args.lr, device=args.device,
                          tp=args.tp, dp=args.dp)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f}) on "
          f"{model.module.device}")


if __name__ == "__main__":
    main()
