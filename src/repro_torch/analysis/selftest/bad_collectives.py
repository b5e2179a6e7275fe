"""Seeded violations: collective-route (a collective outside the home
class), collective-fp32 (a bf16 reduction in it). Fixture only."""
import torch
import torch.distributed as dist


class ShardGroup:
    def all_reduce_bf16(self, y):
        t = y.to(torch.bfloat16)
        dist.all_reduce(t)           # not an fp32 cast, not ids
        return t


def rogue_sum(y):
    dist.all_reduce(y)               # outside ShardGroup's methods
    return y
