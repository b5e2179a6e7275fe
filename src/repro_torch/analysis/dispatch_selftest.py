"""Seeded entries proving every dispatch rule fires (`--tier dispatch
--self-test`).

The counterpart of the reference's `semantic_selftest.py` for the jaxpr
tier. Each fixture entry seeds one violation: a branch on a tensor (a
host read), an f64 op, a declared collective the step never makes, a
build that raises and, on a CUDA device only, a host-to-device copy
inside the step and a `.cpu()` in a graphed step (a sync that only
torch.cuda's sync debug mode sees, raised there in "error" mode). A
clean entry must produce no finding. These fixtures
are imported and executed, so they live here and not in selftest/.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.dispatch_rules import DISPATCH_RULES, run_entry
from repro_torch.analysis.entries import Entry

__all__ = ["fixture_entries", "EXPECTED", "run_dispatch_self_test"]


def _x(device):
    return torch.arange(8, dtype=torch.float32, device=device)


def _branch(device, shard):
    x = _x(device)

    def step():
        return x * 2 if x.sum() > 0 else x       # a host read
    return step


def _f64(device, shard):
    x = _x(device)
    return lambda: (x.double() * 2).float()


def _silent(device, shard):
    x = _x(device)
    return lambda: x + 1                         # makes no collective


def _broken(device, shard):
    raise ValueError("seeded build failure")


def _h2d(device, shard):
    x = _x(device)
    host = torch.ones(8)
    return lambda: x + host.to(device)           # a copy inside the step


def _graphed_sync(device, shard):
    x = _x(device)
    return lambda: x.cpu()                       # a device-to-host sync


def _clean(device, shard):
    x, mask = _x(device), torch.ones(8, dtype=torch.bool, device=device)
    return lambda: torch.where(mask, x, torch.zeros_like(x)).cumsum(0)


# rule -> the fixture entry that seeds it
EXPECTED = {"dispatch-host-read": "selftest/host-read",
            "dispatch-f64": "selftest/f64",
            "dispatch-collective-count": "selftest/collectives",
            "dispatch-error": "selftest/error",
            "dispatch-h2d": "selftest/h2d"}
# fixture entry -> its rule, for the violations only a CUDA device sees
CARD_ONLY = {"selftest/h2d": "dispatch-h2d",
             "selftest/graphed-sync": "dispatch-host-read"}


def fixture_entries() -> tuple:
    return (Entry("selftest/host-read", _branch),
            Entry("selftest/f64", _f64),
            Entry("selftest/collectives", _silent, collectives=1),
            Entry("selftest/error", _broken),
            Entry("selftest/h2d", _h2d),
            Entry("selftest/graphed-sync", _graphed_sync, graphed=True),
            Entry("selftest/clean", _clean, graphed=True))


def run_dispatch_self_test(device: str = "cpu"):
    """(ok, report lines) on `device`; the CARD_ONLY entries are checked
    only on a CUDA device."""
    cuda = torch.device(device).type == "cuda"
    found = {}
    for e in fixture_entries():
        found[e.name] = {f.rule for f in run_entry(e, device)}
    ok, lines = True, []
    seeds = [(rule, EXPECTED[rule]) for rule in DISPATCH_RULES]
    seeds += [(rule, where) for where, rule in CARD_ONLY.items()
              if where not in EXPECTED.values()]
    for rule, where in seeds:
        if where in CARD_ONLY and not cuda:
            lines.append(f"--   {rule} in {where}: seen only on a CUDA "
                         f"device, not checked on {device}")
        elif rule in found[where]:
            lines.append(f"ok   {rule}: fires in {where}")
        else:
            ok = False
            lines.append(f"FAIL {rule}: seeded violation in {where} did "
                         f"not fire on {device}")
    if found["selftest/clean"]:
        ok = False
        lines.append(f"FAIL clean entry produced {sorted(found['selftest/clean'])}")
    else:
        lines.append("ok   clean entry: no findings")
    return ok, lines
