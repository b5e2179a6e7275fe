"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero
without printing a result:

1. card   — the card's name and power limit, torch and CUDA versions;
2. build  — nvcc builds every kernel from the sources in this checkout
            and prints the -Xptxas -v report;
3. kernel — each kernel against its plain PyTorch version on the card
            (ids identical but for fp64-confirmed near ties; y within
            2e-4 in fp32, 5e-2 in bf16, the reference's tolerances),
            then CUDA-event times beside the card's bound;
4. serve  — build_engine("smollm-135m", reduced=False, backend="pallas")
            serves a staggered stream of 4 greedy requests at full width
            (30 layers, bf16) through the kernel; the launch count must
            be 30 per decode step;
5. parity — the same stream at full width in fp32 (4 layers) under the
            "pallas" and "jnp" backends: identical tokens and traces;
6. summary — a JSON line per kernel, then {"ok": true, "device": ...}.

It imports the port only (never jax or the JAX package) and runs on the
card only: without one it exits non-zero at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.planner import PHONE, build_plan  # noqa: E402
from repro_torch.kernels import build as kbuild, ops  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    fused_cold_ffn_ref, pick_disagreements)
from repro_torch.launch.serve import build_engine  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.families import serving_family  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # fp32 outside the tensor cores
TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-4}
# main-path shapes of smollm-135m's cold path (planner: n_hot 64, 23 cold
# clusters of 64, kc 1)
MAIN = dict(D=576, r=64, cs=64, G=1, nc_g=23, R=3, kc=1, act="silu",
            mode="cats")
# the serve phase's stream: (prompt length, arrival step)
STREAM = [(16, 0), (16, 0), (32, 3), (24, 6)]
MAX_NEW = 16
CTX = 64                           # KV slots per request: 32 + 16 fit


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


# ----------------------------------------------------------- phase 3 ----

def kernel_inputs(B, D, r, cs, G, nc_g, R, dtype, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
    return (t(rng.standard_normal((B, D)) * 0.5),
            t(rng.standard_normal((G, nc_g, cs, R, D)) * 0.1),
            t(rng.standard_normal((D, r)) / np.sqrt(D)),
            t(rng.standard_normal((r, G * nc_g * cs)) / np.sqrt(r)))


def check_case(name, B, dtype, mask_kind="live", seed=0, **over):
    s = dict(MAIN, **over)
    x, wc, A, Bp = kernel_inputs(B, s["D"], s["r"], s["cs"], s["G"],
                                 s["nc_g"], s["R"], dtype, seed)
    mask = torch.ones(B, dtype=torch.bool, device="cuda")
    if mask_kind == "some":
        mask[1::2] = False
    elif mask_kind == "none":
        mask[:] = False
    y, idx = ops.fused_cold_ffn(x, wc, A, Bp, activation=s["act"],
                                mode=s["mode"], kc=s["kc"], active_mask=mask)
    torch.cuda.synchronize()
    yr, ir = fused_cold_ffn_ref(x, wc, A, Bp, mask.float(),
                                activation=s["act"],
                                cats=s["mode"] == "cats", kc=s["kc"])
    near, real = pick_disagreements(idx, ir, x, wc, A, Bp, mask.float())
    if real:
        raise AssertionError(f"{name}: picks differ beyond fp32 ties: {real}")
    if mask_kind == "none" and idx.tolist() != [list(range(s["kc"]))] * s["G"]:
        raise AssertionError(f"{name}: all-dead batch picked {idx.tolist()}")
    err = float((y - yr).abs().max())
    if near:
        print(f"  {name}: near-tie picks (g, k, kernel, plain) {near}; "
              f"y not compared")
        return 0.0
    tol = TOL[dtype]
    if not torch.allclose(y, yr, atol=tol, rtol=tol):
        raise AssertionError(f"{name}: max |y - plain| = {err} over tol {tol}")
    print(f"  {name}: ids identical, max |y - plain| = {err:.3e} "
          f"(tol {tol})")
    return err


def cuda_time_ms(fn, iters=200, warmup=20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters=200) -> float:
    """Device time per call with launch overhead removed: `iters` calls
    captured in one CUDA graph, replayed and timed with events."""
    fn()                                   # warm up outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(B, dtype):
    """Least time for one call at the main path's shapes: every input
    byte the call needs read once (the kc picked bundles, not the whole
    cold tensor), every output byte written once, against the card's
    memory rate; its operations against the peak rate for the type."""
    s = MAIN
    es = torch.empty((), dtype=dtype).element_size()
    Nc = s["G"] * s["nc_g"] * s["cs"]
    K = s["G"] * s["kc"] * s["cs"]
    nbytes = (es * (B * s["D"] + s["D"] * s["r"] + s["r"] * Nc
                    + K * s["R"] * s["D"])
              + 4 * B + 4 * B * s["D"] + 4 * s["G"] * s["kc"])
    ops_ = 2 * B * (s["D"] * s["r"] + s["r"] * Nc + K * s["R"] * s["D"])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel():
    print("== phase 3: fused_cold_ffn against its plain version")
    bf16, f32 = torch.bfloat16, torch.float32
    errs = []
    for B in (1, 4, 32, 64):
        errs.append(check_case(f"main B={B} bf16", B, bf16, seed=B))
    errs.append(check_case("kc=4", 8, bf16, kc=4, seed=11))
    errs.append(check_case("kc=23", 8, bf16, kc=23, seed=12))
    errs.append(check_case("G=2", 16, bf16, G=2, nc_g=11, kc=3, seed=13))
    errs.append(check_case("fp32", 16, f32, kc=2, seed=14))
    errs.append(check_case("R=2 gelu", 5, f32, R=2, act="gelu", D=200,
                           r=16, cs=32, nc_g=5, G=2, kc=2, seed=15))
    errs.append(check_case("relu mode relu2", 7, bf16, act="relu2",
                           mode="relu", kc=3, seed=16))
    errs.append(check_case("dead rows", 8, bf16, mask_kind="some", kc=4,
                           seed=17))
    errs.append(check_case("all rows dead", 8, bf16, mask_kind="none",
                           kc=4, seed=18))

    timings = {}
    for B in (1, 4, 32):
        x, wc, A, Bp = kernel_inputs(B, MAIN["D"], MAIN["r"], MAIN["cs"],
                                     MAIN["G"], MAIN["nc_g"], MAIN["R"],
                                     bf16, seed=100 + B)
        mask = torch.ones(B, device="cuda")
        kw = dict(activation="silu", mode="cats", kc=1)
        kern = lambda: ops.fused_cold_ffn(x, wc, A, Bp, **kw)
        plain = lambda: fused_cold_ffn_ref(x, wc, A, Bp, mask,
                                           activation="silu", cats=True,
                                           kc=1)
        ms = cuda_time_ms(kern)
        dev_ms = graph_time_ms(kern)
        plain_ms = cuda_time_ms(plain)
        b_ms, b_by = bound(B, bf16)
        timings[B] = dict(ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by)
        print(f"  B={B:2d} bf16: kernel {ms * 1e3:.2f} us/call "
              f"({dev_ms * 1e3:.2f} us in a CUDA graph), plain "
              f"{plain_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us "
              f"({b_by})")
    return max(errs), timings


# ----------------------------------------------------------- phase 4 ----

def check_logits(engine):
    if not bool(torch.isfinite(engine._last).all()):
        raise AssertionError("non-finite logits after a decode step")


def serve_stream(engine, vocab, seed=0):
    """Submit STREAM at temperature 0, staggered on the engine's steps
    (each request arrives at the modeled clock of its step), then
    run_until_drained. Returns (tokens per request, per-step stats,
    per-step synchronized wall seconds)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n, _ in STREAM]
    uids, stats, walls = [None] * len(STREAM), [], []
    for k in range(max(a for _, a in STREAM) + 1):
        for i, (_, arrive) in enumerate(STREAM):
            if arrive == k:
                uids[i] = engine.submit(prompts[i], max_new=MAX_NEW,
                                        arrival_time=engine.clock_s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = engine.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        stats.append(r.stats)
        check_logits(engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = engine.run_until_drained()
    torch.cuda.synchronize()
    drain = time.perf_counter() - t0
    check_logits(engine)
    walls += [drain / len(rep.stats)] * len(rep.stats)
    toks = [engine.sched.sequences[u].generated for u in uids]
    return toks, stats + rep.stats, walls


def profile_steps(engine, vocab, batch=4, n_new=5):
    """torch.profiler over the decode steps of `batch` fresh requests
    (admission and prefill stay outside the window): wall and device time
    per step, kernels per step, and the kernels that take the most device
    time. Reports "not measured" when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    for _ in range(batch):
        engine.submit(rng.integers(0, vocab, 16).astype(np.int32),
                      max_new=n_new, arrival_time=engine.clock_s)
    engine.step()                          # admits and prefills all four
    torch.cuda.synchronize()
    steps = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while engine.step() is not None:
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3   # ms
    print(f"  profile: {steps} decode steps at batch <= {batch}, wall "
          f"{wall * 1e3 / steps:.2f} ms/step")
    if busy == 0.0:
        print("  profile: device time not measured (no CUDA events)")
        return
    print(f"  profile: device busy {busy / steps:.3f} ms/step "
          f"({busy / (wall * 1e3):.1%} of wall), "
          f"{sum(e.count for e in dev) / steps:.0f} kernels/step")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count / steps:6.0f}/step  {e.key[:70]}")


def phase_serve():
    print("== phase 4: serve smollm-135m at full width through the kernel")
    torch.cuda.reset_peak_memory_stats()
    ops.fused_cold_ffn.launches = 0
    engine, cfg = build_engine("smollm-135m", reduced=False,
                               backend="pallas", ctx_budget=CTX)
    toks, stats, walls = serve_stream(engine, cfg.vocab_size)
    launches = ops.fused_cold_ffn.launches
    peak = torch.cuda.max_memory_allocated()
    hist = list(engine.sched.batch_history)
    profile_steps(engine, cfg.vocab_size)
    engine.close()
    steps = len(stats)
    print(f"  {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_dtype}; {steps} decode steps, batch sizes {hist}")
    for t in toks:
        if len(t) != MAX_NEW or not all(0 <= v < cfg.vocab_size for v in t):
            raise AssertionError(f"bad request output {t}")
    if max(hist) != len(STREAM) or len(set(hist)) < 3:
        raise AssertionError(f"stream did not cross buckets: {hist}")
    if launches != cfg.num_layers * steps:
        raise AssertionError(f"{launches} kernel launches for {steps} "
                             f"steps of {cfg.num_layers} layers")
    w = np.array(walls) * 1e3
    modeled = sum(s.batch for s in stats) / sum(s.effective_s for s in stats)
    print(f"  fused_cold_ffn launches {launches} = {cfg.num_layers} x "
          f"{steps} steps")
    print(f"  wall per decode step (synchronized): first {w[0]:.2f} ms, "
          f"mean {w.mean():.2f} ms, median {np.median(w):.2f} ms, "
          f"mean after the first {w[1:].mean():.2f} ms")
    print(f"  peak device memory {peak / 2**20:.1f} MiB")
    print(f"  modeled decode rate (storage plane, PHONE profile): "
          f"{modeled:.2f} tok/s")
    return dict(launches=launches, steps=steps, wall_ms_mean=float(w.mean()),
                wall_ms_median=float(np.median(w)), peak_bytes=peak,
                batch_history=hist)


# ----------------------------------------------------------- phase 5 ----

def parity_run(cfg, backend):
    fam = serving_family(cfg)
    model = fam.make_model(cfg, device="cuda", seed=0)
    plan = build_plan(cfg, hw=PHONE, backend=backend)
    model = fam.prepare_params(model, plan)
    engine = ServeEngine(cfg, model, plan, temperature=0.0, seed=0,
                         backend=backend, ctx_budget=CTX)
    traces = []
    price = engine.storage.step

    def record(trace, *a, **k):            # keep each step's trace
        traces.append(np.array(trace))
        return price(trace, *a, **k)
    engine.storage.step = record
    toks, stats, _ = serve_stream(engine, cfg.vocab_size, seed=1)
    engine.close()
    return toks, traces, stats


def phase_parity():
    print("== phase 5: pallas and jnp backends at full width, fp32, "
          "4 layers")
    cfg = get_config("smollm-135m").replace(
        num_layers=4, param_dtype="float32", compute_dtype="float32")
    pt, ptr, pst = parity_run(cfg, "pallas")
    jt, jtr, jst = parity_run(cfg, "jnp")
    if pt != jt:
        raise AssertionError("backends disagree on tokens")
    if len(ptr) != len(jtr) or any(not np.array_equal(a, b)
                                   for a, b in zip(ptr, jtr)):
        raise AssertionError("backends disagree on (L, G, kc) traces")
    if pst != jst:
        raise AssertionError("backends disagree on TokenStats")
    print(f"  {len(pst)} steps: tokens, TokenStats and {len(ptr)} traces "
          f"of shape {ptr[0].shape} identical")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False    # plain fp32 is fp32
    torch.backends.cudnn.allow_tf32 = False
    print("== phase 1: card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    print("== phase 2: build")
    t0 = time.perf_counter()
    built = kbuild.build()
    for b in built.values():
        print(f"  {b.name}: {b.seconds:.1f} s -> {b.path.name}")
        print(b.report.rstrip())
    print(f"  build phase {time.perf_counter() - t0:.1f} s")

    max_err, timings = phase_kernel()
    serve = phase_serve()
    phase_parity()

    print("== phase 6: summary")
    t1 = timings[1]
    print(json.dumps({"kernels": [{
        "name": "fused_cold_ffn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_cold_ffn.cu",
        "replaces": "src/repro/kernels/cluster_gather_ffn.py:273",
        "checked": True, "launches": serve["launches"],
        "max_abs_err": max_err, "ms": t1["ms"], "plain_ms": t1["plain_ms"],
        "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
        "library_ms": None, "graph_ms": t1["graph_ms"],
        "shape": "B=1 D=576 r=64 cs=64 nc_g=23 R=3 kc=1 bf16",
        "by_batch": {str(b): v for b, v in timings.items()},
        "decode_steps": serve["steps"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
