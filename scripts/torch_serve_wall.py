"""Wall time per decode step of the port's full-width serve, for comparing
two trees on one CUDA card.

    python3 scripts/torch_serve_wall.py --src SRC [--storage-dtype fp16]
        [--repeat 2] [--label NAME] [--eager]

imports `repro_torch` from SRC (a checkout's `src` directory), builds
smollm-135m at full width (30 layers, bf16) with the "pallas" cold-path
backend at the given storage dtype, serves a stream of 4 greedy requests
(prompts 16/16/32/24, 16 new tokens, arrivals staggered over the first 7
steps) `--repeat` times on one engine, and prints one JSON line: the
card, and per repeat the synchronized wall time of every decode step
(first, median, mean after the first). `--eager` serves with
cuda_graphs=False (a tree whose engine captures one CUDA graph per decode
bucket; without the flag the engine's default is used). To compare trees,
run the script once per tree in one call, alternating (A, B, B, A).
Without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

STREAM = [(16, 0), (16, 0), (32, 3), (24, 6)]     # (prompt length, step)
MAX_NEW = 16


def serve_walls(engine, vocab, seed):
    """Per-step synchronized wall seconds of one pass of STREAM."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n, _ in STREAM]
    walls, k = [], 0
    while True:
        for (_, arrive), p in zip(STREAM, prompts):
            if arrive == k:
                engine.submit(p, max_new=MAX_NEW, arrival_time=engine.clock_s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = engine.step()
        torch.cuda.synchronize()
        if r is None:
            return walls
        walls.append(time.perf_counter() - t0)
        k += 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="the `src` directory of the tree to measure")
    ap.add_argument("--storage-dtype", default="fp16")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--label", default=None)
    ap.add_argument("--eager", action="store_true",
                    help="run the decode step eagerly (cuda_graphs=False)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_wall: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.launch.serve import build_engine
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    kw = {} if args.storage_dtype == "fp16" else \
        {"storage_dtype": args.storage_dtype}
    if args.eager:
        kw["cuda_graphs"] = False
    engine, cfg = build_engine("smollm-135m", reduced=False,
                               backend="pallas", ctx_budget=64, **kw)
    runs = []
    for i in range(args.repeat):
        w = np.array(serve_walls(engine, cfg.vocab_size, seed=i)) * 1e3
        runs.append(dict(steps=len(w), first_ms=float(w[0]),
                         median_ms=float(np.median(w)),
                         mean_after_first_ms=float(w[1:].mean())))
    engine.close()
    print(json.dumps({"label": args.label or args.src, "card": card,
                      "storage_dtype": args.storage_dtype,
                      "eager": args.eager, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
