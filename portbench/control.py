#!/usr/bin/env python3
"""The control of a cell's comparison, on the card at the cell's size:

    python3 portbench/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed it serves the cell as a run does (a shorter window at the
cell's own load), then reads the comparison's numbers twice over the
same prompts, served tokens and picks: the program's, and the float8
control's (the reference with every weight and matmul input rounded to
e4m3, put in the program's place; at each position the token it puts
first, and at each sampled step the clusters it picks). It prints one
JSON line per seed: the program's verdict and checks, and the control's
(`judge.decide_control`: its readings held to the same limits in
`checks/<workload>.json`; it has to come out not correct). The
benchmark's own runs never run it; the limits in `checks/<workload>.json`
are set from its readings and the program's."""
from __future__ import annotations

import argparse
import json
import sys

import run as harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from portbench import spec
    manifest = spec.load_manifest(harness.ROOT)
    for seed in args.seeds:
        out, lines = harness.run_cell(
            manifest, args.workload, seed, args.seconds, False, "cuda",
            harness.process_start_wall(), control=True)
        for line in lines:
            print(f"seed {seed} {line}", file=sys.stderr)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "checks": out["checks"],
                          "control": out["control"],
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
