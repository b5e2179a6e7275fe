"""build_model(cfg) — the family dispatcher of the training path
(counterpart of `repro/models/model.py`).

A `Model` pairs the family's parameters (an `nn.Module`: `DenseModel`
for dense and vlm, `MoEModel` for moe) with the family's forward over a
batch dict, `forward(module, batch, plan=None) -> logits (B, S, V)`:
{"tokens"} for dense and moe, {"tokens", "patch_embeds"} for vlm, whose
logits cover the image positions too (B, P + S, V). The module's
parameters stay frozen (`requires_grad=False`) as built; the train step
(`train/steps.py`) records autograd on them only while it differentiates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense, moe, vlm

# families whose forward, prefill and decode are not ported
UNPORTED = ("ssm", "hybrid", "encdec")


def _token_forward(module, batch, plan=None):
    """dense and moe (whose layers reach their MoE through the same walk;
    a plan only shapes the moe trace, which the forward does not keep)."""
    return dense.forward(module, batch["tokens"], plan)


def _vlm_forward(module, batch, plan=None):
    return vlm.forward(module, batch["tokens"], batch["patch_embeds"], plan)


_FAMILIES = {"dense": (dense.make_model, _token_forward),
             "moe": (moe.make_model, _token_forward),
             "vlm": (vlm.make_model, _vlm_forward)}


@dataclass(frozen=True)
class Model:
    """The uniform model API of training: the parameters and the
    family's forward."""
    module: dense.DenseModel
    forward: Callable            # (module, batch, plan=None) -> logits

    @property
    def cfg(self) -> ModelConfig:
        return self.module.cfg

    def params(self) -> dict:
        """The module's parameters by name (each tensor itself, no
        copy): what the train step differentiates and updates."""
        return dict(self.module.named_parameters())


def _family(cfg: ModelConfig):
    if cfg.family in UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported (ROADMAP.md "
            f"Queue 1 item 11)")
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family]


def wrap(module) -> Model:
    """The Model of a built module (e.g. `bridge.params_from_numpy`'s)."""
    return Model(module, _family(module.cfg)[1])


def build_model(cfg: ModelConfig, device=None, seed=0) -> Model:
    """The family's model on `device` (default `cuda`; raises without a
    card), random weights from a `torch.Generator` seeded by `seed`
    (zero weights to be filled when None). Raises NotImplementedError
    for the ssm, hybrid and encdec families."""
    make_model, forward = _family(cfg)
    return Model(make_model(cfg, device=device, seed=seed), forward)
