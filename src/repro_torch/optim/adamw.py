"""AdamW with a global-norm clip and a configurable moment dtype
(counterpart of `repro/optim/adamw.py`).

The reference's formula, leaf by leaf over a dict of named tensors: the
clip's squares summed in fp32 over every leaf, bias corrections
`1 - b**step` in fp32, the delta `mh / (sqrt(vh) + eps) + wd * p` in
fp32, the parameter cast back to its dtype and the moments to
`moment_dtype`. A leaf whose gradient is None (autograd reached no use
of it, as the predictor at plan=None) is updated as the reference
updates its zero gradient: its moments decay and weight decay still
shrinks it by (1 - lr * wd). `torch.optim.AdamW` differs in each of
these (it skips None grads, keeps moments in the parameter's dtype and
has no clip of its own).

Over ranks, each rank updates its own slices: the clip's global norm
sums the squares of the leaves split over the replica's group (`shard`,
the names in `split`) over that group, and the replicated leaves' once;
the gradients are already summed over the data replicas, so nothing is
summed there again.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.modules import dtype_of


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    moment_dtype: str = "float32"
    grad_clip: float = 1.0

    def init(self, params: dict) -> dict:
        """{"m", "v"}: zero moments of each leaf in `moment_dtype`;
        "step": a 0-d int32 count on the leaves' device."""
        dt = dtype_of(self.moment_dtype)
        device = next(iter(params.values())).device
        return {
            "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    @torch.no_grad()
    def clip_scale(self, grads: dict, shard=None, split=frozenset()):
        """min(1, grad_clip / global norm) of `grads` (no None values),
        in fp32; over ranks the leaves in `split` are summed over
        `shard` (see `update`)."""
        if shard is None or shard.size == 1 or not split:
            gn = torch.sqrt(sum(g.float().square().sum()
                                for g in grads.values()))
        else:
            sq = {k: g.float().square().sum() for k, g in grads.items()}
            part = shard.all_reduce_f32(
                sum(v for k, v in sq.items() if k in split))
            gn = torch.sqrt(part + sum(v for k, v in sq.items()
                                       if k not in split))
        return torch.clamp(self.grad_clip / (gn + 1e-9), max=1.0)

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, shard=None,
               split=frozenset()):
        """(new params, new state), new tensors; `params` and `state` are
        left as they are. `grads` maps each key of `params` to its
        gradient or None. `shard`: the group of ranks over which the
        leaves named in `split` are split (the clip sums their squares
        over it)."""
        grads = {k: torch.zeros_like(p) if grads.get(k) is None
                 else grads[k] for k, p in params.items()}
        step = state["step"] + 1
        if self.grad_clip:
            scale = self.clip_scale(grads, shard, split)
            grads = {k: g * scale.to(g.dtype) for k, g in grads.items()}
        dt = dtype_of(self.moment_dtype)
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g32 = grads[k].float()
            m32 = state["m"][k].float() * b1 + (1 - b1) * g32
            v32 = state["v"][k].float() * b2 + (1 - b2) * g32.square()
            mh = m32 / c1
            vh = v32 / c2
            p32 = p.float()
            delta = mh / (torch.sqrt(vh) + self.eps) \
                + self.weight_decay * p32
            new_p[k] = (p32 - self.lr * delta).to(p.dtype)
            new_m[k] = m32.to(dt)
            new_v[k] = v32.to(dt)
        return new_p, {"m": new_m, "v": new_v, "step": step}
