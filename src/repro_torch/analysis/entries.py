"""The served decode steps of the dispatch tier, with declared facts.

The port's counterpart of `repro/analysis/trace_registry.py`. One
`Entry` per decode step the port serves, at reduced configs and two
buckets of `core/adaptation.py::DEFAULT_BUCKETS` (1 and 4), each with the
facts `dispatch_rules.py` holds it to:

* host reads and f64 ops: none. A step the engine captures in a CUDA
  graph (`graphed`: dense, vlm and moe on one rank) must show none at
  all; a step that runs eagerly (over ranks, where gloo collectives sit
  between its kernels, and the ssm, hybrid and encdec families, which no
  engine serves yet) reports what it reads, and each such finding is
  fixed or allowlisted with the reason it does not graph yet;
* collectives per step: exact, on every rank (`ShardGroup.calls`). Over
  tp = 2 ranks a dense or vlm step makes one fp32 all-reduce for the
  vocab-split embedding, two a layer (attention's output and the FFN's),
  one id gather a layer (the cold path's picked clusters) and one column
  gather of the vocab-split logits: 3 L + 2. The moe step over ep = 2
  makes the embedding's all-reduce, attention's and the experts' combine
  a layer and the logits' gather (2 L + 2); its two-level trace gathers
  no ids. The ssm / hybrid / encdec counts depend on each layer's kind;
  `_FAMILY_STEPS` lists them.
* the five `kernels/registry.py` entries: one wrapper call each, on CPU
  tensors through their plain versions, on the card through the kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

__all__ = ["Entry", "entries", "kernel_entries", "BUCKETS"]

BUCKETS = (1, 4)          # DEFAULT_BUCKETS[0] and DEFAULT_BUCKETS[2]
PROMPT = 8                # prefill length before the measured step
CTX = 16                  # cache slots


@dataclass(frozen=True)
class Entry:
    """One decode step and its declared facts. `build(device, shard)`
    returns a callable that runs exactly the step (everything it needs
    made beforehand, outside the measurement)."""
    name: str
    build: Callable
    world: int = 1            # ranks the step runs over (tp or ep)
    collectives: int = 0      # ShardGroup.calls one step makes, per rank
    graphed: bool = False     # the engine captures it in a CUDA graph

    def path(self, device) -> str:
        """Its findings' path: CPU and card findings key apart, since the
        card sees reads the CPU cannot."""
        return f"dispatch/{torch.device(device).type}/{self.name}"


# ------------------------------------------------------ served families ----

def _served(arch: str, backend: str, bucket: int):
    def build(device, shard):
        from repro_torch.bridge import shard_model
        from repro_torch.core.adaptation import stepped_plan
        from repro_torch.core.clusters import make_plan, scale_plan_for_batch
        from repro_torch.launch.serve import _model_and_plan
        from repro_torch.core.planner import PHONE
        from repro_torch.serving.families import serving_family
        cfg, model, plan = _model_and_plan(
            arch, True, 0, backend, "fp16", PHONE,
            "cpu" if shard is not None else device)
        if not cfg.num_experts:
            # group-aligned plans, so that tp 1 and 2 both divide them
            cs = cfg.sparse_ffn.cluster_size
            base = make_plan(cfg.d_ff, 0.25, 0.25, cs, groups=4,
                             backend=backend)
            plan.plans = {b: scale_plan_for_batch(base, cfg.d_ff, b, cs)
                          for b in BUCKETS}
        if shard is not None:
            model = shard_model(model, plan, shard, torch.device(device))
        step = serving_family(cfg).make_decode_step(cfg, shard=shard)
        pb = stepped_plan(plan, bucket, BUCKETS, backend)
        tokens = torch.zeros((bucket, 1), dtype=torch.int32, device=device)
        cache = model.init_cache(bucket, CTX)
        mask = torch.ones((bucket,), dtype=torch.bool, device=device)
        return lambda: step(model, tokens, cache, pb, mask)
    return build


def _served_entries():
    # (family, arch, backend, buckets, ranks, collectives per step at 2
    # ranks: reduced configs have 2 layers)
    grid = [("dense", "smollm-135m", "pallas", BUCKETS, 3 * 2 + 2),
            ("dense", "smollm-135m", "jnp", BUCKETS[:1], 3 * 2 + 2),
            ("vlm", "qwen2-vl-2b", "pallas", BUCKETS[:1], 3 * 2 + 2),
            ("moe", "deepseek-moe-16b", "jnp", BUCKETS[:1], 2 * 2 + 2)]
    for family, arch, backend, buckets, n_coll in grid:
        axis = "ep" if family == "moe" else "tp"
        for n in (1, 2):
            for b in buckets:
                yield Entry(f"decode/{family}/{backend}/{axis}{n}/b{b}",
                            _served(arch, backend, b), world=n,
                            collectives=n_coll if n > 1 else 0,
                            graphed=n == 1)


# ----------------------------------------------- ssm / hybrid / encdec ----

def _batch(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_frames, cfg.d_model)).astype(np.float32) * 0.1)
    return batch


def _family(arch: str, bucket: int):
    def build(device, shard):
        from repro_torch.bridge import model_tree, params_from_numpy
        from repro_torch.configs import get_config
        from repro_torch.core.clusters import make_plan
        from repro_torch.models.model import build_model, wrap
        cfg = get_config(arch).reduced()
        plan = None
        if cfg.d_ff:
            s = cfg.sparse_ffn
            plan = make_plan(cfg.d_ff, s.hot_ratio, s.cold_active_ratio,
                             s.cluster_size, groups=4, backend="pallas")
        whole = build_model(cfg, device="cpu", seed=0)
        m = wrap(params_from_numpy(model_tree(whole.module), cfg, device,
                                   shard=shard, plan=plan), shard) \
            if shard is not None else build_model(cfg, device=device, seed=0)
        batch = {k: v.to(device) for k, v in _batch(cfg, bucket).items()}
        with torch.no_grad():
            logits, cache = m.prefill(m.module, batch, PROMPT + CTX)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return lambda: m.decode_step(m.module, tok, cache, plan)
    return build


# arch -> collectives per step over 2 ranks (reduced configs): every
# step all-reduces the vocab-split embedding and gathers the logits' vocab
# columns (2). mamba2-130m's 2 layers each reduce their gated norm's
# statistic and their output (+4 = 6); recurrentgemma-9b's 5 layers
# (rec, rec, attn, rec, rec) each run the FFN's cold path (its reduction
# and its id gather, 2 a layer) and the four RG-LRU layers reduce their
# output, while the one local-attention layer (one kv head) stays whole
# (+14 = 16); seamless-m4t-large-v2's 2 decoder layers reduce self- and
# cross-attention and run the cold path (+8 = 10; the encoder runs in the
# prefill)
_FAMILY_STEPS = {"mamba2-130m": 6, "recurrentgemma-9b": 16,
                 "seamless-m4t-large-v2": 10}


def _family_entries():
    for arch, n_coll in _FAMILY_STEPS.items():
        family = {"mamba2-130m": "ssm", "recurrentgemma-9b": "hybrid",
                  "seamless-m4t-large-v2": "encdec"}[arch]
        for n in (1, 2):
            yield Entry(f"decode/{family}/tp{n}/b1", _family(arch, 1),
                        world=n, collectives=n_coll if n > 1 else 0)


# --------------------------------------------------------- the kernels ----

def _kernel(name: str):
    """One wrapper call of kernels/registry.py's entry `name` at a small
    shape (B 4, D 64)."""
    def build(device, shard):
        from repro_torch.kernels import ops
        from repro_torch.quant.storage import quantize_bundles
        g = torch.Generator().manual_seed(0)
        B, D, N, cs, G, nc_g, R, r = 4, 64, 256, 16, 2, 4, 3, 8

        def t(*shape, scale=1.0):
            return (torch.randn(shape, generator=g) * scale).to(device)
        x, w = t(B, D, scale=0.5), t(N, R, D, scale=0.1)
        wc = t(G, nc_g, cs, R, D, scale=0.1)
        A, Bp = t(D, r, scale=D ** -0.5), t(r, G * nc_g * cs, scale=r ** -0.5)
        ids = torch.tensor([0, 5, 9], dtype=torch.int32, device=device)
        cidx = torch.tensor([[0, 2], [1, 3]], dtype=torch.int32,
                            device=device)
        quant = quantize_bundles(wc, "int8") if "quant" in name else {}
        calls = {
            "fused_cold_ffn": lambda: ops.fused_cold_ffn(
                x, wc, A, Bp, activation="silu", mode="cats", kc=2),
            "fused_cold_ffn (quant mode)": lambda: ops.fused_cold_ffn(
                x, wc, A, Bp, activation="silu", mode="cats", kc=2,
                **quant),
            "cluster_gather_ffn": lambda: ops.cluster_gather_ffn(
                x, w, ids, activation="silu", cluster_size=cs),
            "cluster_gather_ffn_grouped": lambda: (
                ops.cluster_gather_ffn_grouped(x, wc, cidx,
                                               activation="silu")),
            "dense_ffn": lambda: ops.dense_ffn(x, w, activation="gelu"),
        }
        return calls[name]
    return build


def kernel_entries() -> tuple:
    from repro_torch.kernels.registry import KERNELS
    return tuple(Entry(f"kernel/{k.name.replace(' ', '-')}", _kernel(k.name),
                       graphed=True) for k in KERNELS)


def entries(max_world: int = 2) -> tuple:
    """Every entry over at most `max_world` ranks."""
    out = list(_served_entries()) + list(_family_entries()) \
        + list(kernel_entries())
    return tuple(e for e in out if e.world <= max_world)
