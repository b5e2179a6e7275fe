"""The training step over the uniform Model API (counterpart of
`repro/train/steps.py`).

Cross-entropy LM loss with label masking (labels < 0 are ignored: the
vlm's image positions and padding), the gradient by autograd, then
AdamW. Works for every ported family: the batch dict carries what the
family's forward takes. The moe router's aux loss stays out of the
loss, as in the reference, which computes it and drops it.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW


def lm_loss(logits, labels):
    """logits (B, S, V), labels (B, S) int (-1 = masked) -> the mean
    negative log-likelihood of the unmasked labels, in fp32; 0 when every
    label is masked."""
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, safe[..., None])[..., 0]
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def make_loss_fn(model: Model):
    """loss_fn(batch) on the model's current parameters. Labels shorter
    than the logits (the vlm: image positions first) are padded with -1
    at the front."""
    def loss_fn(batch):
        logits = model.forward(model.module, batch)
        labels = batch["labels"]
        pad = logits.shape[1] - labels.shape[1]
        if pad > 0:
            labels = torch.cat([labels.new_full((labels.shape[0], pad), -1),
                                labels], dim=1)
        return lm_loss(logits, labels)
    return loss_fn


def loss_and_grads(model: Model, params: dict, batch):
    """(loss, {name: gradient or None}) of `params`, the module's own
    parameters by name (`Model.params()`). They record autograd only
    inside this call and are frozen again when it returns."""
    loss_fn = make_loss_fn(model)
    names = list(params)
    try:
        for p in params.values():
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(batch)
            grads = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True)
    finally:
        for p in params.values():
            p.requires_grad_(False)
    return loss.detach(), dict(zip(names, grads))


def make_train_step(model: Model, optimizer: AdamW):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss"}): `params` are the module's own parameters by name
    (`Model.params()`), written in place with AdamW's update and
    returned."""
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch)
        new, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        return params, opt_state, {"loss": loss}
    return train_step
