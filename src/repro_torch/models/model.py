"""build_model(cfg) — the family dispatcher of the uniform Model API
(counterpart of `repro/models/model.py`).

A `Model` pairs the family's parameters (an `nn.Module`: `DenseModel`
for dense and vlm, `MoEModel` for moe, `SSMModel`, `HybridModel`,
`EncDecModel`) with the family's functions over a batch dict:

* `forward(module, batch, plan=None) -> logits (B, S, V)`;
* `prefill(module, batch, max_len=None) -> (logits (B, 1, V), cache)`;
* `decode_step(module, tokens, cache, plan=None) -> (logits, cache)`,
  the cache updated in place;
* `init_cache(batch, seq_len)`.

The batch is {"tokens"} for dense, moe, ssm and hybrid, {"tokens",
"patch_embeds"} for vlm, whose logits cover the image positions too
(B, P + S, V), and {"tokens", "frames"} for encdec. `build_model(cfg,
shard=)` over a group of ranks builds the rank's slice of any family
(`parallel.shard_layout(cfg, None, ...)`) and binds the group to the
functions, which then take the same arguments. The module's
parameters stay frozen (`requires_grad=False`) as built; the train step
(`train/steps.py`) records autograd on them only while it
differentiates.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense, encdec, moe, rglru, ssm, vlm
from repro_torch.models.modules import resolve_device
from repro_torch.parallel import shard_layout

def _over_batch(fn, *keys):
    """fn(module, batch[tokens], batch[key]..., arg) as (module, batch,
    arg=None, shard=None): the third argument is the forward's plan or
    the prefill's max_len; `shard` reaches fn only when given."""
    def call(module, batch, arg=None, shard=None):
        kw = {} if shard is None else {"shard": shard}
        return fn(module, batch["tokens"], *(batch[k] for k in keys), arg,
                  **kw)
    return call


def _vlm_decode_step(module, tokens, cache, plan=None, shard=None):
    """dense decode under the text's M-RoPE positions."""
    return dense.decode_step(module, tokens, cache, plan, angles_fn=lambda
                             pos: vlm.decode_angles(module.cfg, pos),
                             shard=shard)


# family -> (make_model, forward, prefill, decode_step); moe's layers
# reach their MoE FFN through the dense walk (a plan only shapes the moe
# trace, which these functions do not keep)
_FAMILIES = {
    "dense": (dense.make_model, _over_batch(dense.forward),
              _over_batch(dense.prefill), dense.decode_step),
    "moe": (moe.make_model, _over_batch(dense.forward),
            _over_batch(dense.prefill), dense.decode_step),
    "vlm": (vlm.make_model, _over_batch(vlm.forward, "patch_embeds"),
            _over_batch(vlm.prefill, "patch_embeds"), _vlm_decode_step),
    "ssm": (ssm.make_model, _over_batch(ssm.forward),
            _over_batch(ssm.prefill), ssm.decode_step),
    "hybrid": (rglru.make_model, _over_batch(rglru.forward),
               _over_batch(rglru.prefill), rglru.decode_step),
    "encdec": (encdec.make_model, _over_batch(encdec.forward, "frames"),
               _over_batch(encdec.prefill, "frames"), encdec.decode_step),
}


@dataclass(frozen=True)
class Model:
    """The uniform model API: the parameters and the family's
    functions; `shard` is the group of ranks whose slice `module` holds
    (None: the whole model), already bound to the functions."""
    module: nn.Module
    forward: Callable        # (module, batch, plan=None)
    prefill: Callable        # (module, batch, max_len=None)
    decode_step: Callable    # (module, tokens, cache, plan=None)
    shard: Optional[object] = None

    @property
    def cfg(self) -> ModelConfig:
        return self.module.cfg

    def params(self) -> dict:
        """The module's parameters by name (each tensor itself, no
        copy): what the train step differentiates and updates."""
        return dict(self.module.named_parameters())

    def init_cache(self, batch: int, seq_len: int):
        return self.module.init_cache(batch, seq_len)

    def split_params(self) -> frozenset:
        """The names of the parameters the module holds a slice of (their
        shape differs from the whole model's)."""
        cfg = self.cfg
        whole = family(cfg)[0](cfg, torch.device("meta"), seed=None)
        shapes = {n: p.shape for n, p in whole.named_parameters()}
        return frozenset(n for n, p in self.module.named_parameters()
                         if p.shape != shapes[n])


def family(cfg: ModelConfig):
    """(make_model, forward, prefill, decode_step) of cfg's family."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family]


def wrap(module, shard=None) -> Model:
    """The Model of a built module (e.g. `bridge.params_from_numpy`'s);
    with `shard`, the group whose rank's slice the module holds."""
    fns = family(module.cfg)[1:]
    if shard is not None and shard.size > 1:
        fns = [functools.partial(f, shard=shard) for f in fns]
    else:
        shard = None
    return Model(module, *fns, shard=shard)


def build_model(cfg: ModelConfig, device=None, seed=0, shard=None) -> Model:
    """The family's model on `device` (default `cuda`; raises without a
    card), random weights from a `torch.Generator` seeded by `seed`
    (zero weights to be filled when None). With `shard`, a group of n >
    1 ranks, the module holds this rank's slice of the same weights
    (each leaf drawn whole and cut), laid out for training, in every
    family."""
    make_model = family(cfg)[0]
    if shard is None or shard.size == 1:
        return wrap(make_model(cfg, device=device, seed=seed))
    layout = shard_layout(cfg, None, shard.rank, shard.size)
    return wrap(make_model(cfg, device=resolve_device(device), seed=seed,
                           layout=layout), shard)
