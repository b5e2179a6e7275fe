"""Clean fixture: seeded generators, collectives through the home class
in fp32 and on ids, a captured step that reads nothing on the host, a
conforming handle and family. Must produce no finding."""
import numpy as np
import torch
import torch.distributed as dist


class ShardGroup:
    def all_reduce_f32(self, y):
        t = y.to(torch.float32, copy=True)
        dist.all_reduce(t)
        return t.to(y.dtype)

    def all_gather_ids(self, idx):
        parts = [torch.empty_like(idx) for _ in range(2)]
        dist.all_gather(parts, idx)
        return torch.cat(parts)


def clean_step(x, mask, generator):
    y = torch.where(mask, x, torch.zeros_like(x))
    if x.shape[0] > 1:               # host metadata, not a device value
        y = y * 2
    noise = torch.randn(x.shape, generator=generator)
    return y + noise


def seeded(seed):
    return np.random.default_rng(seed).random(3)


class EchoHandle:
    def submit(self, prompt, max_new, arrival_time):
        raise NotImplementedError


class GoodBackend(EchoHandle):
    def submit(self, prompt, max_new, arrival_time, priority=0):
        return 0
