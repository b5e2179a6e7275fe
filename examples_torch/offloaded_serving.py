"""The paper's headline scenario under a request stream, on the port (the
counterpart of examples/offloaded_serving.py): a model that does NOT fit
in memory, served with 50% of its FFN weights offloaded to the slow
tier, compared across llama.cpp-analogue / LLMFlash-analogue /
PowerInfer-2 (Fig 7) and across storage tiers (UFS 3.1 / UFS 4.0 / host
DRAM behind DMA).

Uses the continuous-batching API: requests arrive on a seeded schedule,
join the running batch at bucket boundaries (submit/step), and the
report aggregates modeled throughput, TTFT and cache behavior. Every
latency is the storage plane's modeled figure. The engines plan for the
paper's phone (`build_engine`'s default `planner.PHONE`); the reference
example's plan on its own default profile.

  PYTHONPATH=src python examples_torch/offloaded_serving.py         # card
  PYTHONPATH=src python examples_torch/offloaded_serving.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.baselines import ALL_SYSTEMS
from repro_torch.core.io_model import HOST_DMA, UFS31, UFS40
from repro_torch.launch.serve import build_engine

STORAGES = (UFS31, UFS40, HOST_DMA)
ENGINE = dict(offload=0.5, buckets=(1, 2, 4, 8), ctx_budget=40,
              temperature=0.0)


def serve_row(engine, cfg) -> dict:
    """Six requests on a staggered modeled-time schedule (numpy seed 0)
    through `engine`: modeled tok/s, mean TTFT (ms), mean cache hit rate
    and the I/O share of the effective step time."""
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(2e-3, 6))
    for t in arrivals:
        engine.submit(rng.integers(0, cfg.vocab_size, 16), max_new=10,
                      arrival_time=float(t))
    rep = engine.run_until_drained()
    hit = float(np.mean([s.cache_hit_rate for s in rep.stats]))
    io = sum(s.io_s for s in rep.stats)
    eff = sum(s.effective_s for s in rep.stats)
    return dict(tok_s=rep.tokens_per_s, ttft_ms=float(rep.ttft().mean()) *
                1e3, hit=hit, io_share=min(io / max(eff, 1e-12), 1.0))


def main(device=None) -> dict:
    """Every (system, storage) row on `device` (default `cuda`), by
    (system name, storage name)."""
    print(f"{'system':18s} {'storage':9s} {'tok/s':>9s} {'ttft-ms':>8s} "
          f"{'hit':>6s} {'io-share':>9s}")
    rows = {}
    for storage in STORAGES:
        for spec in ALL_SYSTEMS:
            engine, cfg = build_engine("smollm-135m", reduced=True,
                                       spec=spec, storage=storage,
                                       device=device, **ENGINE)
            r = rows[spec.name, storage.name] = serve_row(engine, cfg)
            engine.close()
            print(f"{spec.name:18s} {storage.name:9s} {r['tok_s']:9.1f} "
                  f"{r['ttft_ms']:8.2f} {r['hit']:6.1%} "
                  f"{r['io_share']:9.1%}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run here)")
    main(ap.parse_args().device)
