"""`correct`: the configuration's plain reference reads what the timed
path produced, and each number it gives is held to its limit in
`checks/<workload>.json`.

Numbers of the dense family (`reference/dense.py::readings`):

* `logit_gap`: over the served tokens of a sample of requests, the
  widest gap by which a served (greedy) token's logit lies below the
  float32 reference's best at that position, in standard deviations of
  the position's logits. It covers the prefill, attention through the
  KV arena, the hot prefix, fused_cold_ffn's gathered clusters and the
  LM head.
* `pick_gap`: over a block of window steps and every layer, how far the
  weakest cluster the program picked lies below the kc-th best of the
  reference's batch-union scores of that step's live rows, in standard
  deviations of the scores. It covers the predictor, the batch union and
  the top-k.
* `stats_off`: the number of engine steps whose TokenStats (or plan, or
  trace shape) differ from a replay of the storage plane's pricing over
  every step. An exact comparison: its limit is 0.
"""
from __future__ import annotations

import json
from pathlib import Path

from portbench.spec import BENCH_DIR


def limits_of(workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "checks" / f"{workload}.json") as f:
        return json.load(f)["limits"]


def decide(readings: dict, limits: dict) -> tuple:
    """(correct, checks): every limited number at or under its limit;
    checks maps each to {"value", "limit"}."""
    checks = {k: {"value": readings.get(k, float("inf")), "limit": v}
              for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def decide_control(readings: dict, limits: dict) -> tuple:
    """The control judged as the program is: its readings
    (`control_<number>`), under the program's names, each held to the
    cell's limit of that number. It has to come out not correct."""
    ctl = {k[len("control_"):]: v for k, v in readings.items()
           if k.startswith("control_")}
    return decide(ctl, {k: limits[k] for k in ctl})
