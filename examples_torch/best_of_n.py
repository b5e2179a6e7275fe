"""Best-of-N sampling with dynamic batch adaptation on the port (paper Fig
1b/13; the counterpart of examples/best_of_n.py).

Generates N=4 candidate continuations through the continuous-batching
API: the four candidates are submitted with staggered generation
budgets, so they finish at different steps, the effective batch shrinks,
and the engine swaps its per-bucket decode callables (the paper's
per-batch NPU graphs) and hot/cold plans live. The best candidate is
picked by mean token log-prob (`sampler.sequence_logprob`) of the
model's own forward.

  PYTHONPATH=src python examples_torch/best_of_n.py                 # card
  PYTHONPATH=src python examples_torch/best_of_n.py --device cpu

The engine samples at temperature 1 from its own `torch.Generator`,
seeded by its `seed`.
"""
import argparse

import numpy as np
import torch

from repro_torch.launch.serve import build_engine
from repro_torch.models.model import wrap
from repro_torch.serving.sampler import sequence_logprob

BUDGETS = (4, 8, 12, 16)          # each candidate's max_new


def main(device=None) -> dict:
    """Serve and rank the four candidates on `device` (default `cuda`);
    returns the batch timeline, the executable swaps, the scores and the
    winner."""
    engine, cfg = build_engine("smollm-135m", reduced=True, offload=0.5,
                               ctx_budget=32, temperature=1.0,
                               device=device)
    rng = np.random.default_rng(1)
    base = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)

    # N=4 candidates of the same prompt, staggered budgets 4/8/12/16
    max_new = max(BUDGETS)
    uids = [engine.submit(base, max_new=n) for n in BUDGETS]
    rep = engine.run_until_drained()
    batches = [s.batch for s in rep.stats]
    switches = engine.decoder.switches
    print("batch timeline:", batches)
    print("executable swaps:", switches)
    print(f"modeled {rep.tokens_per_s:.1f} tok/s; "
          f"ttft {rep.ttft().mean() * 1e3:.2f} ms")

    # rank candidates (pad short/finished ones)
    toks = np.zeros((len(uids), max_new), np.int32)
    for i, u in enumerate(uids):
        gen = engine.sched.sequences[u].generated
        toks[i, :len(gen)] = gen
    # score with the model's own logits via a fresh forward
    model = wrap(engine.model)
    prompt = np.repeat(base[None], len(uids), axis=0)
    full = torch.from_numpy(np.concatenate([prompt, toks], 1)).to(
        engine.model.device)
    with torch.no_grad():
        logits = model.forward(model.module, {"tokens": full})
    scores = sequence_logprob(logits[:, 15:-1], full[:, 16:]).cpu().numpy()
    best = int(np.argmax(scores))
    engine.close()
    print("candidate scores:", [round(float(s), 3) for s in scores])
    print(f"best-of-4 winner: candidate {best}: {toks[best].tolist()}")
    return dict(batches=batches, switches=switches, tokens=toks,
                scores=scores, best=best)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run here)")
    main(ap.parse_args().device)
