"""The port's own spans in the traced sub-window.

The port records its spans (`repro_torch.obs`: `(name, t0_ns, t1_ns)`
on `time.perf_counter_ns`, the clock `serve.py` stamps its steps with)
while torch's profiler runs, so `devtrace.profiled`'s sub-window leaves
them in the recorder's buffer. `window_spans` takes those of the
profiled steps, for the span metrics' readers (`per_step_ms`), and
`setup_plane_ns` the run's engine's `setup.plane`. A port without the
recorder gives none, and the readers return None.

`profiled` runs the sub-window as `devtrace.profiled` does and keeps
the profiler's events too: it moves the device's busy intervals onto
the recorder's clock, through one offset between the wall clock the
profiler stamps and the recorder's, taken at the sub-window's start.
`idle_spans` then charges each idle gap of the device inside the
sub-window to the innermost span open at its middle, the rule
`devtrace.read` follows for the harness's ranges: the most specific
span wins, and a gap with no span of the program open goes to the
harness. The program records its spans on the one thread that drives
the engine, where they nest. `python3 portbench/progtrace.py` serves a
cell that way and prints the split."""
from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from portbench import devtrace  # noqa: E402
from portbench.devtrace import WINDOW  # noqa: E402

HARNESS = "harness"
# where no idle time should fall: the step's own time outside its phases
UNNAMED = ("engine.step", HARNESS)


def recorder():
    """The port's span recorder, or None for a port without one."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs


def clock_offset_ns() -> int:
    """The wall clock's nanoseconds less the recorder's, now."""
    return time.time_ns() - time.perf_counter_ns()


def on_recorder_clock(prof, offset_ns: int):
    """A function from a profiler event's time (microseconds from the
    trace's start, as `FunctionEvent.time_range` gives it) to the
    recorder's nanoseconds. The profiler stamps the trace's start in
    the wall clock's nanoseconds."""
    start = prof.profiler.kineto_results.trace_start_ns() - offset_ns
    return lambda us: start + round(us * 1000)


def window_spans(run):
    """The spans the port recorded inside the profiled steps, or None
    where it records none (no recorder, no profiled step)."""
    obs = recorder()
    steps = (run.profile or {}).get("steps")
    if obs is None or not steps:
        return None
    lo = run.steps[steps[0]].t0 * 1e9
    hi = run.steps[steps[-1]].t1 * 1e9
    return [s for s in obs.recorded() if lo <= s[1] and s[2] <= hi]


def per_step_ms(run, *names):
    """Milliseconds a profiled step spends in the spans named `names`;
    None where the program recorded no span in the profiled steps."""
    spans = window_spans(run)
    if not spans:
        return None
    ns = sum(b - a for name, a, b in spans if name in names)
    return ns * 1e-6 / len(run.profile["steps"])


def setup_plane_ns(run):
    """The run's engine's `setup.plane` (the last one to end before the
    run's first step), in nanoseconds; None where there is none."""
    obs = recorder()
    if obs is None or not run.steps:
        return None
    first = run.steps[0].t0 * 1e9
    got = [b - a for name, a, b in obs.recorded()
           if name == "setup.plane" and b <= first]
    return got[-1] if got else None


def profiled(loop, seconds: float) -> dict:
    """`devtrace.profiled` (the same ranges, the same loop, `read`'s
    dict and the steps' indices), with `spans` (those of the window,
    and the window itself) and `busy` on the recorder's clock."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.serving import engine as engine_mod
    eng = loop.engine
    undo = [devtrace._wrap(eng.storage, "step", "plane"),
            devtrace._wrap(eng, "_admit", "prefill"),
            devtrace._wrap(engine_mod, "sample_tokens", "sample"),
            devtrace._wrap(torch.cuda.CUDAGraph, "replay", "replay")]
    steps = []
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    obs = recorder()
    try:
        loop.sync()
        with profile(activities=acts) as prof, obs.recording() as spans:
            offset = clock_offset_ns()
            with record_function(WINDOW):
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    with record_function("step"):
                        steps.append(loop.step().index)
                loop.sync()
    finally:
        for u in reversed(undo):
            u()
    events = prof.events()
    out = devtrace.read(events)
    out["steps"] = steps
    if not out:
        return out
    # the device's intervals as `devtrace.read` takes them: the card's
    # work inside the window, not the harness's ranges' copies there
    at = on_recorder_clock(prof, offset)
    cuda = torch.autograd.DeviceType.CUDA
    w = next(e.time_range for e in events
             if e.name == WINDOW and e.device_type != cuda)
    dev = [(max(e.time_range.start, w.start), min(e.time_range.end, w.end))
           for e in events if e.device_type == cuda
           and e.name not in devtrace.HOST and e.name != WINDOW]
    out["spans"] = spans + [(WINDOW, at(w.start), at(w.end))]
    out["busy"] = [(at(a), at(b)) for a, b in
                   devtrace._union([(a, b) for a, b in dev if b > a])]
    return out


def timeline(spans) -> tuple:
    """(times, names): from times[i] on, names[i] is the innermost span
    open (None where none is), for properly nested spans."""
    times, names, stack = [], [], []

    def close_to(t):
        while stack and stack[-1][1] <= t:
            _, end = stack.pop()
            times.append(end)
            names.append(stack[-1][0] if stack else None)
    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        close_to(a)
        stack.append((name, b))
        times.append(a)
        names.append(name)
    close_to(float("inf"))
    return times, names


def idle_spans(spans, busy, top: int = 10) -> list:
    """[name, seconds] of the `top` spans that the most idle time of the
    device is charged to, largest first; [] without the window's span."""
    win = [s for s in spans if s[0] == WINDOW]
    if not win:
        return []
    _, w0, w1 = win[0]
    times, names = timeline([s for s in spans if s[0] != WINDOW])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = defaultdict(float)
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            i = bisect.bisect_right(times, (a + b) / 2) - 1
            name = names[i] if i >= 0 else None
            gaps[name or HARNESS] += (b - a) * 1e-9
    return sorted(([k, v] for k, v in gaps.items()),
                  key=lambda kv: -kv[1])[:top]


def split(run) -> dict:
    """What `profiled` saw of a served run: the device's busy and window
    seconds, the harness's idle gaps, every span's idle seconds, the
    share of idle time inside a named phase (not bare `engine.step`, not
    the harness), and `plane.step` over the spy's plane time, step by
    step (least and most)."""
    prof = run.profile
    gaps = idle_spans(prof["spans"], prof["busy"], top=1 << 30)
    idle = sum(v for _, v in gaps)
    named = sum(v for k, v in gaps if k not in UNNAMED)
    planes = [s for s in prof["spans"] if s[0] == "plane.step"]
    ratios = []
    for i in prof["steps"]:
        st = run.steps[i]
        got = [b - a for _, a, b in planes
               if st.t0 * 1e9 <= a and b <= st.t1 * 1e9]
        if got and st.plane_s > 0:
            ratios.append(sum(got) * 1e-9 / st.plane_s)
    return {"busy_s": prof["busy_s"], "window_s": prof["window_s"],
            "idle_gaps": prof["idle_gaps"], "idle_spans": gaps,
            "named_idle_pct": 100.0 * named / idle if idle else None,
            "plane_over_spy": [min(ratios), max(ratios)] if ratios
            else None}


def split_cell(cell: dict, seed: int, seconds: float, device) -> dict:
    """Serve `cell` as `run.py --trace 1` does, up to the end of the
    sub-window (no reference check), with `profiled`; `split`'s dict."""
    from portbench import run as bench  # the sub-window's length
    from portbench.peaks import peaks_of
    from portbench.serve import Run, build_engine, serve
    device = torch.device(device)
    on_card = device.type == "cuda"
    run = Run(cell=cell, seed=seed, peaks=peaks_of(
        torch.cuda.get_device_name(device) if on_card else "cpu"))
    engine = build_engine(cell, seed, device)
    try:
        serve(engine, cell, run, seconds, min(bench.PROFILE_S, seconds),
              torch.cuda.synchronize if on_card else (lambda: None),
              profiler=profiled)
    finally:
        engine.close()
    return split(run)


def main(argv=None) -> int:
    """python3 portbench/progtrace.py --workload <name> --seed <n>
    --seconds <s>: one JSON line, `split` of the cell's sub-window on
    the card."""
    import argparse
    import json
    from portbench import spec
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load_manifest(), args.workload)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      **split_cell(cell, args.seed, args.seconds, "cuda")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
