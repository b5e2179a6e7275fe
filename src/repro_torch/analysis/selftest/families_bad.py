"""Seeded violations: family-fields (a missing field, call shapes the
engine cannot use), registry-drift (a family the battery never names).
Fixture only."""
from dataclasses import dataclass


@dataclass(frozen=True)
class ServingFamily:
    family: str
    make_model: object
    make_decode_step: object
    build_plan: object
    prepare_params: object
    default_arch: str = ""


def register_family(fam):
    return fam


def _make_model(cfg, device=None, seed=0):
    return cfg


def _plan_no_hw(cfg, freqs=None):
    return cfg


register_family(ServingFamily(
    family="ghost",                  # never named in the battery fixture
    make_model=_make_model,
    build_plan=_plan_no_hw,          # takes no hw=, backend=, storage_dtype=
    prepare_params=lambda model: model,     # the engine passes (model, plan)
))                                   # make_decode_step missing
