"""End-to-end serving driver of the port.

Profile -> plan (offline §5) -> permute weights hot-first ->
ServeEngine (online §4) -> batched generation. The engine path (`--dp`
included) plans from the activations it profiles on the model
(`build_engine(..., profile=True)`), as the reference's CLI does;
`--fleet` plans from synthetic frequencies, as the reference's does.
Runs on the CUDA card unless `--device cpu`:

  PYTHONPATH=src python -m repro_torch.launch.serve --backend pallas \
      --bon 4 --max-new 32            # smollm-135m at full width

`--storage-dtype int8|int4-mixed` serves quantized cold bundles;
`--host-dma` prices the slow tier as host DRAM behind DMA instead of UFS
4.0. On the card each decode bucket runs as one captured CUDA graph.

`--family {dense,moe,vlm}` serves that family's default arch
(smollm-135m, deepseek-moe-16b, qwen2-vl-2b) unless `--arch` names
another (grok-1-314b and turbosparse-mixtral-47b are the other moe
archs; the moe family serves the plain path only, so `--backend pallas`
raises for it). `--dp N` routes the prompts
over N replicas on the one device, and `--fleet N` over N complete
engines behind the fleet gateway (weighted least-loaded dispatch,
circuit breakers, response LRU, heartbeats); both serve the prompts as
a request stream (submit / run_until_drained) instead of the
static-batch generate(), and `--fleet` excludes `--dp`:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --reduced --fleet 2 --bon 8

`--tp N` (`--ep N` for the moe family) serves each replica over N
ranks, processes on this host that share `--device` and meet over gloo
(`repro_torch.parallel.spawn`; `--dp` replicas then take N ranks each).
Each rank builds the whole model on the host and keeps its slice on
the device (the embedding's and head's vocab share too; grok-1-314b,
`moe_shard_mode="tp"`, splits every expert's rows); rank 0 prints the
report:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --reduced --tp 2 --bon 2

`--reduced` serves the 2-layer reduced config instead. Latencies the
driver prints are the storage plane's *modeled* figures; the wall time
is measured on the device it ran on.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.bridge import shard_model
from repro_torch.configs import get_config
from repro_torch.core.baselines import POWERINFER2
from repro_torch.core.io_model import HOST_DMA, UFS40
from repro_torch.core.planner import PHONE, profile_activations
from repro_torch.models.modules import resolve_device
from repro_torch.parallel import ShardGroup, spawn
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.families import default_archs, serving_family

FAMILY_ARCHS = default_archs()


def build_engine(arch: str = "smollm-135m", reduced: bool = True,
                 offload: float = 0.5, spec=POWERINFER2, storage=UFS40,
                 profile: bool = False, seed: int = 0, backend: str = "jnp",
                 storage_dtype: str = "fp16", hw=PHONE, device=None,
                 dp: int = 1, tp: int = 1, ep: int = 0, shard=None,
                 **engine_kwargs):
    """Build a serving engine for `arch` on `device` (default `cuda`;
    raises on a host without a card), routing over `dp` replicas. Weights
    are random, from a `torch.Generator` seeded by `seed`. The plan comes
    from the planner on hardware profile `hw`: with `profile`, from the
    activation frequencies `profile_activations` measures over four
    (4, 64) batches of uniform token ids (`profile_batches`; the moe
    family is not profiled, as in the reference), else from synthetic
    frequencies.

    `tp` (or `ep` for the moe family) > 1 serves each replica over that
    many ranks: call it on every rank of `shard` (dp * tp ranks, e.g.
    from `parallel.spawn`). Each rank then builds, profiles, plans and
    prepares the whole model on the host, so its random weights are
    those of `device='cpu'`, and moves only its slice to `device`: a
    rank's device never holds the whole model. Without tp, dp replicas
    share the one device."""
    tp = replica_ranks(arch, tp, ep)
    world = 1 if shard is None else shard.size
    if tp > 1 and world != dp * tp:
        raise ValueError(f"dp={dp} x tp={tp} needs a group of {dp * tp} "
                         f"ranks, not {world}")
    cfg, model, plan = _model_and_plan(arch, reduced, seed, backend,
                                       storage_dtype, hw,
                                       "cpu" if tp > 1 else device, profile)
    if backend != "jnp":
        engine_kwargs.setdefault("backend", backend)
    if dp > 1:
        engine_kwargs.setdefault("dp", dp)
    if tp > 1:
        model = shard_model(model, plan, ShardGroup(shard.rank % tp, tp),
                            resolve_device(device))
        engine_kwargs["shard"] = shard
    return ServeEngine(cfg, model, plan, spec=spec, storage=storage,
                       offload_ratio=offload, seed=seed,
                       **engine_kwargs), cfg


def replica_ranks(arch: str, tp: int = 1, ep: int = 0) -> int:
    """The ranks of one replica: `tp`, or `ep` for an arch with experts
    (the reference CLI's checks: ep needs experts, and tp and ep size the
    same ranks, so they must agree)."""
    if not ep:
        return tp
    if not get_config(arch).num_experts:
        raise ValueError(f"--ep is expert parallelism but {arch} has no "
                         f"experts; use --tp for tensor parallelism")
    if tp > 1 and tp != ep:
        raise ValueError(f"--tp {tp} and --ep {ep} both size the ranks of "
                         f"a replica; pass one")
    return ep


# build_engine(profile=True)'s corpus, the reference's: four (4, 64)
# token batches
PROFILE_BATCHES, PROFILE_SHAPE = 4, (4, 64)


def profile_batches(cfg, device, seed: int = 0):
    """The profiling token batches of `build_engine(profile=True)`:
    PROFILE_BATCHES batches of PROFILE_SHAPE uniform ids in
    [0, vocab_size) drawn in turn from a `torch.Generator` on `device`
    seeded by `seed`. The reference draws them from `jax.random` keys
    0..3, which torch cannot reproduce, so the two packages profile
    different tokens for the same seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, PROFILE_SHAPE, generator=g,
                          device=device) for _ in range(PROFILE_BATCHES)]


def _model_and_plan(arch, reduced, seed, backend, storage_dtype, hw,
                    device, profile=False):
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    fam = serving_family(cfg)
    model = fam.make_model(cfg, device=device, seed=seed)
    freqs = None
    if profile and not cfg.num_experts:
        # dense-layer activation profiling; the moe router needs none
        # (routing is the predictor, experts are the clusters)
        counts, n_tok = profile_activations(
            model, cfg, profile_batches(cfg, device, seed))
        freqs = (counts / n_tok).astype(np.float32)
    plan = fam.build_plan(cfg, freqs, hw=hw, backend=backend,
                          storage_dtype=storage_dtype)
    return cfg, fam.prepare_params(model, plan), plan


def build_fleet(arch: str = "smollm-135m", n: int = 2, reduced: bool = True,
                offload: float = 0.5, spec=POWERINFER2, storage=UFS40,
                seed: int = 0, backend: str = "jnp",
                storage_dtype: str = "fp16", hw=PHONE, device=None,
                engine_kwargs: dict = None, **gateway_kwargs):
    """N complete single-device engines behind a FleetGateway, all on
    `device` (default `cuda`) and serving one model (`local_fleet`).
    `engine_kwargs` go to every engine, `gateway_kwargs` to the
    gateway."""
    from repro_torch.serving.gateway import FleetGateway, local_fleet
    cfg, model, plan = _model_and_plan(arch, reduced, seed, backend,
                                       storage_dtype, hw, device)
    engine_kwargs = dict(engine_kwargs or {})
    if backend != "jnp":
        engine_kwargs.setdefault("backend", backend)
    backends = local_fleet(cfg, model, plan, n, spec=spec,
                           storage=storage, offload_ratio=offload,
                           seed=seed, **engine_kwargs)
    return FleetGateway(backends, **gateway_kwargs), cfg


def _serve_stream(target, prompt, max_new):
    """Submit every prompt at time 0 and drain; (report, wall seconds),
    the wall synchronized with the device."""
    t0 = time.perf_counter()
    for p in prompt:
        target.submit(p, max_new=max_new, arrival_time=0.0)
    rep = target.run_until_drained()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return rep, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (default: the --family arch)")
    ap.add_argument("--family", choices=sorted(FAMILY_ARCHS),
                    default="dense",
                    help="serving family; picks its default arch unless "
                         "--arch is given")
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
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks per replica (processes on "
                         "this host sharing --device, over gloo)")
    ap.add_argument("--ep", type=int, default=0,
                    help="expert-parallel ranks per replica for the moe "
                         "family (each owns E/ep experts); the same ranks "
                         "as --tp")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel replicas: on the one device, or "
                         "with --tp/--ep each on its own ranks")
    ap.add_argument("--fleet", type=int, default=0,
                    help="serve through the fleet gateway over N complete "
                         "single-device engines; excludes --tp/--ep/--dp")
    args = ap.parse_args(argv)

    arch = args.arch or FAMILY_ARCHS[args.family]
    try:
        args.tp = replica_ranks(arch, args.tp, args.ep)
    except ValueError as e:
        ap.error(str(e))
    if args.backend == "pallas" and get_config(arch).num_experts:
        raise ValueError(f"--backend pallas is the dense-family fused "
                         f"cold-path kernel; {arch}'s cold path is expert "
                         f"dispatch (models/moe.py) and has no pallas "
                         f"backend")
    if args.fleet and (args.tp > 1 or args.dp > 1 or args.ep):
        ap.error("--fleet members are single-device engines; --dp doesn't "
                 "apply, nor --tp or --ep")
    if args.tp > 1:
        # one process per rank; rank 0's report is printed here
        print(spawn(_serve_rank, args.dp * args.tp, args, arch,
                    device=args.device or "cuda", threads=None)[0])
        return
    print(_serve(args, arch))


def _serve_rank(shard, args, arch):
    """One rank of `main`'s --tp/--ep run; its report."""
    return _serve(args, arch, shard)


def _serve(args, arch, shard=None) -> str:
    """Build the engine (or the fleet) `args` ask for, serve the prompts
    and return the report."""
    storage = HOST_DMA if args.host_dma else UFS40
    common = dict(storage=storage, backend=args.backend, device=args.device,
                  storage_dtype=args.storage_dtype)
    if args.fleet:
        gw, cfg = build_fleet(arch, args.fleet, args.reduced, args.offload,
                              engine_kwargs=dict(
                                  temperature=args.temperature), **common)
        prompt = _prompts(cfg, args)
        rep, wall = _serve_stream(gw, prompt, args.max_new)
        miss = rep.ttft_percentiles("miss")
        gw.close()
        return "\n".join([
            f"arch={cfg.name} spec=powerinfer-2 storage={storage.name} "
            f"fleet={args.fleet} backend={args.backend} "
            f"storage_dtype={args.storage_dtype}",
            f"modeled fleet serve: {rep.throughput_tok_s:.2f} tok/s over "
            f"the {rep.span_s:.2f}s span | {rep.n_completed}/"
            f"{rep.n_submitted} completed, {rep.n_rejected} rejected, "
            f"{rep.n_retries} retries | cache {rep.cache_hits} hit / "
            f"{rep.cache_misses} miss",
            f"modeled ttft ms (miss): mean {miss['mean']*1e3:.2f} "
            f"p50 {miss['p50']*1e3:.2f} p90 {miss['p90']*1e3:.2f} "
            f"p99 {miss['p99']*1e3:.2f} | per-backend "
            f"{[b['completed'] for b in rep.per_backend]} completed",
            f"wall time {wall:.3f}s for {rep.total_tokens} tokens on "
            f"{gw.backends[0].handle.engine.device}"])
    engine, cfg = build_engine(arch, args.reduced, args.offload,
                               profile=True, dp=args.dp, tp=args.tp,
                               shard=shard, temperature=args.temperature,
                               **common)
    prompt = _prompts(cfg, args)
    mesh = f"dp={args.dp} " if args.dp > 1 else ""
    if args.tp > 1:
        ep = cfg.num_experts and cfg.moe_shard_mode == "ep"
        mesh += f"{'ep' if ep else 'tp'}={args.tp} " \
                f"({engine.graph_policy}) "
    head = (f"arch={cfg.name} spec=powerinfer-2 storage={storage.name} "
            f"{mesh}device={engine.device} backend={args.backend} "
            f"storage_dtype={args.storage_dtype}")
    if args.dp > 1:
        rep, wall = _serve_stream(engine, prompt, args.max_new)
        pct = rep.latency_percentiles()
        hit = float(np.mean([s.cache_hit_rate for s in rep.stats]))
        io = sum(s.io_s for s in rep.stats)
        eff = sum(s.effective_s for s in rep.stats)
        engine.close()
        return "\n".join([
            head,
            f"modeled serve: {rep.throughput_tok_s:.2f} tok/s over the "
            f"{rep.span_s:.2f}s span ({rep.tokens_per_s:.2f} tok/s "
            f"per-replica pipeline rate) | cache hit {hit:.1%} | "
            f"I/O share {io/max(eff, 1e-12):.1%}",
            f"modeled ttft ms: mean {float(rep.ttft().mean())*1e3:.2f} | "
            f"latency ms: p50 {pct['p50']*1e3:.2f} "
            f"p90 {pct['p90']*1e3:.2f} p99 {pct['p99']*1e3:.2f}",
            f"wall time {wall:.3f}s for {rep.total_tokens} tokens on "
            f"{engine.device}"])
    res = engine.generate(prompt, max_new=args.max_new,
                          temperature=args.temperature)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    pct = res.latency_percentiles()
    hit = float(np.mean([s.cache_hit_rate for s in res.stats]))
    io = sum(s.io_s for s in res.stats)
    eff = sum(s.effective_s for s in res.stats)
    engine.close()
    return "\n".join([
        head,
        f"modeled decode: {res.tokens_per_s:.2f} tok/s | "
        f"cache hit {hit:.1%} | I/O share {io/max(eff, 1e-12):.1%}",
        f"modeled latency ms: mean {pct['mean']*1e3:.2f} "
        f"p50 {pct['p50']*1e3:.2f} p90 {pct['p90']*1e3:.2f} "
        f"p99 {pct['p99']*1e3:.2f}",
        f"wall time {res.wall_s:.3f}s for "
        f"{int(np.sum(res.tokens >= 0))} tokens on {engine.device}"])


def _prompts(cfg, args):
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size,
                        (args.bon, args.prompt_len)).astype(np.int32)


if __name__ == "__main__":
    main()
