"""The training step over the uniform Model API (counterpart of
`repro/train/steps.py`).

Cross-entropy LM loss with label masking (labels < 0 are ignored: the
vlm's image positions and padding), the gradient by autograd, then
AdamW. Works for every ported family: the batch dict carries what the
family's forward takes. The moe router's aux loss stays out of the
loss, as in the reference, which computes it and drops it.

Over ranks (dp x tp/ep, `parallel.grid`): the model holds its rank's
slice and runs its forward over its replica's group (`Model.shard`,
the counterpart of the reference's 'model' axis), and each replica
takes its rows of the global batch (`data/pipeline.py::shard_batch`).
A replica's loss is its sum of the unmasked labels' NLL over the count
of unmasked labels in the whole batch (summed over the data group), so
unequal label masks across replicas still give the reference's global
mean; the gradients and the loss are then summed over the data group
in fp32, in one flat buffer per step, and AdamW's clip sums the split
leaves' squares over the replica's group.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW


def lm_loss(logits, labels, count=None):
    """logits (B, S, V), labels (B, S) int (-1 = masked) -> the negative
    log-likelihood of the unmasked labels, in fp32, summed and divided
    by `count` (default: this batch's unmasked labels; at least 1), the
    mean when count is None; 0 when every label is masked."""
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, safe[..., None])[..., 0]
    count = mask.sum() if count is None else count
    return -(ll * mask).sum() / count.clamp_min(1.0)


def make_loss_fn(model: Model, data=None):
    """loss_fn(batch) on the model's current parameters. Labels shorter
    than the logits (the vlm: image positions first) are padded with -1
    at the front. `data`: the group of dp replicas whose batches make up
    the global batch; the loss divides by the global label count."""
    def loss_fn(batch):
        logits = model.forward(model.module, batch)
        labels = batch["labels"]
        pad = logits.shape[1] - labels.shape[1]
        if pad > 0:
            labels = torch.cat([labels.new_full((labels.shape[0], pad), -1),
                                labels], dim=1)
        if data is None or data.size == 1:
            return lm_loss(logits, labels)
        count = data.all_reduce_f32((labels >= 0).float().sum())
        return lm_loss(logits, labels, count)
    return loss_fn


def sum_over(data, loss, grads: dict, params: dict):
    """(loss, grads) summed over the data group's replicas in fp32 in one
    flat buffer (one collective, the same on every rank), each gradient
    cast back to its parameter's dtype; a None gradient counts as
    zero."""
    names = list(params)
    parts = [loss.float().reshape(1)] + [
        (torch.zeros_like(params[n]) if grads[n] is None else grads[n])
        .float().reshape(-1) for n in names]
    flat = data.all_reduce_f32(torch.cat(parts))
    out, o = {}, 1
    for n in names:
        p = params[n]
        out[n] = flat[o:o + p.numel()].view(p.shape).to(p.dtype)
        o += p.numel()
    return flat[0], out


def loss_and_grads(model: Model, params: dict, batch, data=None):
    """(loss, {name: gradient or None}) of `params`, the module's own
    parameters by name (`Model.params()`). They record autograd only
    inside this call and are frozen again when it returns. With `data`
    (dp > 1 replicas) the global loss and the gradients summed over
    them."""
    loss_fn = make_loss_fn(model, data)
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
    grads = dict(zip(names, grads))
    if data is not None and data.size > 1:
        return sum_over(data, loss.detach(), grads, params)
    return loss.detach(), grads


def make_train_step(model: Model, optimizer: AdamW, shard=None, data=None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss"}): `params` are the module's own parameters by name
    (`Model.params()`), written in place with AdamW's update and
    returned. Over ranks, `shard` (default `model.shard`) is the
    replica's group whose slices the module holds and `data` the group
    of dp replicas; every rank of the grid calls the step with its
    replica's rows of the batch."""
    shard = model.shard if shard is None else shard
    split = model.split_params() if shard is not None else frozenset()

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch, data)
        new, opt_state = optimizer.update(grads, opt_state, params,
                                          shard=shard, split=split)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        return params, opt_state, {"loss": loss}
    return train_step
