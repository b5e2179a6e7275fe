"""The traced sub-window: `torch.profiler` over a few seconds of steady
serving, read into what the per-layer metrics and the breakdown need.

The harness marks, from its own side, what the host is doing: each
engine step ("step"), the storage plane ("plane"), admission with its
prefill ("prefill"), sampling ("sample") and each CUDA graph replay
("replay"). Device time is the union of the card's kernel and copy
intervals inside the sub-window; an idle gap is charged to the most
specific host range open at its middle, or to the harness when none
is."""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

HOST = ("plane", "prefill", "sample", "replay", "step")   # most specific first
WINDOW = "portbench.window"
COLD_KERNELS = ("hidden_kernel", "score_kernel", "gate_up_kernel",
                "down_kernel")


def _wrap(obj, name: str, label: str):
    from torch.profiler import record_function
    inner = getattr(obj, name)

    def wrapped(*a, **k):
        with record_function(label):
            return inner(*a, **k)
    setattr(obj, name, wrapped)
    return lambda: setattr(obj, name, inner)


def profiled(loop, seconds: float) -> dict:
    """Serve `loop` for `seconds` under the profiler; returns `read`'s
    dict, with the profiled steps' indices."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.serving import engine as engine_mod
    eng = loop.engine
    undo = [_wrap(eng.storage, "step", "plane"),
            _wrap(eng, "_admit", "prefill"),
            _wrap(engine_mod, "sample_tokens", "sample"),
            _wrap(torch.cuda.CUDAGraph, "replay", "replay")]
    steps = []
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    try:
        loop.sync()
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    with record_function("step"):
                        steps.append(loop.step().index)
                loop.sync()
    finally:
        for u in reversed(undo):
            u()
    out = read(prof.events())
    out["steps"] = steps
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read(events) -> dict:
    """busy_s, window_s, the device ops by total time, the idle gaps by
    host activity, and the seconds in the fused cold path's kernels,
    from a profiler's FunctionEvents."""
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name == WINDOW and e.device_type != cuda]
    if not win:
        return {}
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host = [], defaultdict(list)
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name in HOST or e.name == WINDOW:
            # the harness's ranges; their copies on the device's
            # timeline are annotations, not work
            if e.device_type != cuda:
                host[e.name].append((a, b))
        elif e.device_type == cuda:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b, e.name))
    busy = _union([(a, b) for a, b, _ in dev])
    by_op = defaultdict(float)
    cold_s = 0.0
    for a, b, name in dev:
        by_op[name[:120]] += (b - a) * 1e-6
        if any(f"::{k}" in name for k in COLD_KERNELS):
            cold_s += (b - a) * 1e-6
    spans = {h: sorted(host[h]) for h in HOST}
    starts = {h: [s for s, _ in spans[h]] for h in HOST}

    def doing(t):
        for h in HOST:
            i = bisect.bisect_right(starts[h], t) - 1
            if i >= 0 and spans[h][i][1] >= t:
                return h
        return "harness"
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[doing((a + b) / 2)] += (b - a) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:10]
    return dict(busy_s=sum(b - a for a, b in busy) * 1e-6,
                window_s=(w1 - w0) * 1e-6, device_ops=top(by_op),
                idle_gaps=top(gaps), cold_s=cold_s)
