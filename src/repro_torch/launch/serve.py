"""End-to-end serving driver of the port.

Plan (offline §5) -> permute weights hot-first -> ServeEngine (online
§4) -> batched generation. Runs on the CUDA card unless `--device cpu`:

  PYTHONPATH=src python -m repro_torch.launch.serve --backend pallas \
      --bon 4 --max-new 32            # smollm-135m at full width

`--storage-dtype int8|int4-mixed` serves quantized cold bundles;
`--host-dma` prices the slow tier as host DRAM behind DMA instead of UFS
4.0. On the card each decode bucket runs as one captured CUDA graph.

`--reduced` serves the 2-layer reduced config instead. Latencies the
driver prints are the storage plane's *modeled* figures; the wall time
is measured on the device it ran on.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.baselines import POWERINFER2
from repro_torch.core.io_model import HOST_DMA, UFS40
from repro_torch.core.planner import PHONE
from repro_torch.models.modules import resolve_device
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.families import default_archs, serving_family

FAMILY_ARCHS = default_archs()


def build_engine(arch: str = "smollm-135m", reduced: bool = True,
                 offload: float = 0.5, spec=POWERINFER2, storage=UFS40,
                 seed: int = 0, backend: str = "jnp",
                 storage_dtype: str = "fp16", hw=PHONE, device=None,
                 **engine_kwargs):
    """Build a serving engine for `arch` on `device` (default `cuda`;
    raises on a host without a card). Weights are random, from a
    `torch.Generator` seeded by `seed`; the plan comes from the planner
    with synthetic frequencies on hardware profile `hw`."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    fam = serving_family(cfg)
    model = fam.make_model(cfg, device=device, seed=seed)
    plan = fam.build_plan(cfg, hw=hw, backend=backend,
                          storage_dtype=storage_dtype)
    model = fam.prepare_params(model, plan)
    if backend != "jnp":
        engine_kwargs.setdefault("backend", backend)
    return ServeEngine(cfg, model, plan, spec=spec, storage=storage,
                       offload_ratio=offload, seed=seed,
                       **engine_kwargs), cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=FAMILY_ARCHS["dense"])
    ap.add_argument("--reduced", action="store_true",
                    help="serve the 2-layer reduced config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--offload", type=float, default=0.5)
    ap.add_argument("--bon", type=int, default=1)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--backend", choices=("jnp", "pallas"), default="jnp",
                    help="cold-path backend: 'pallas' runs the fused CUDA "
                         "kernel (the plain version on the CPU), 'jnp' the "
                         "plain PyTorch chain")
    ap.add_argument("--storage-dtype",
                    choices=("fp16", "int8", "int4-mixed"), default="fp16",
                    help="cold-bundle storage dtype (§7.6): cold FFN "
                         "bundles are quantized at prepare time, both cold "
                         "paths dequantize at the gather boundary, and the "
                         "storage plane prices the declared bundle bytes")
    ap.add_argument("--host-dma", action="store_true",
                    help="price the slow tier as host DRAM behind DMA "
                         "instead of UFS 4.0")
    args = ap.parse_args(argv)

    storage = HOST_DMA if args.host_dma else UFS40
    engine, cfg = build_engine(args.arch, args.reduced, args.offload,
                               storage=storage, backend=args.backend,
                               device=args.device,
                               storage_dtype=args.storage_dtype,
                               temperature=args.temperature)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size,
                          (args.bon, args.prompt_len)).astype(np.int32)
    res = engine.generate(prompt, max_new=args.max_new,
                          temperature=args.temperature)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    pct = res.latency_percentiles()
    hit = float(np.mean([s.cache_hit_rate for s in res.stats]))
    io = sum(s.io_s for s in res.stats)
    eff = sum(s.effective_s for s in res.stats)
    print(f"arch={cfg.name} spec=powerinfer-2 storage={storage.name} "
          f"device={engine.device} backend={args.backend} "
          f"storage_dtype={args.storage_dtype}")
    print(f"modeled decode: {res.tokens_per_s:.2f} tok/s | "
          f"cache hit {hit:.1%} | I/O share {io/max(eff, 1e-12):.1%}")
    print(f"modeled latency ms: mean {pct['mean']*1e3:.2f} "
          f"p50 {pct['p50']*1e3:.2f} p90 {pct['p90']*1e3:.2f} "
          f"p99 {pct['p99']*1e3:.2f}")
    print(f"wall time {res.wall_s:.3f}s for "
          f"{int(np.sum(res.tokens >= 0))} tokens on {engine.device}")
    engine.close()


if __name__ == "__main__":
    main()
