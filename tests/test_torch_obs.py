"""The port's span recorder (`repro_torch.obs`) on a tiny CPU engine:
nothing is recorded per step while recording is off, every phase of a
step while it is on, properly nested, the storage plane's phases inside
its step and apart; the plane's set-up always; spans while torch's
profiler runs; and the benchmark's move of the profiler's times onto
the recorder's clock lines the two up."""
import time

import numpy as np
import pytest

from repro_torch import obs

ENGINE = ("engine.step", "engine.admit", "engine.prefill",
          "engine.kv_write", "engine.sample", "engine.read_tokens",
          "engine.feed", "engine.replay", "engine.read_trace",
          "engine.complete")
PLANE = ("plane.step", "plane.lookup", "plane.price", "plane.io_wait",
         "plane.simulate")
PHASES = ("plane.lookup", "plane.price", "plane.simulate")


@pytest.fixture(scope="module")
def engine():
    from repro_torch.launch.serve import build_engine
    eng, _ = build_engine("smollm-135m", reduced=True, device="cpu",
                          buckets=(1, 2, 4), temperature=0.0)
    yield eng
    eng.close()


def _serve(eng, n_steps=3):
    rng = np.random.default_rng(0)
    for n in (8, 8, 12):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, n), max_new=4)
    for _ in range(n_steps):
        eng.step()


def _nested(spans) -> bool:
    """Every span lies inside the one open when it starts, or starts
    after it closed."""
    stack = []
    for _, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1] <= a:
            stack.pop()
        if stack and b > stack[-1]:
            return False
        stack.append(b)
    return True


def test_recording_off_records_no_step_spans(engine):
    t0 = time.perf_counter_ns()
    _serve(engine)
    engine.run_until_drained()
    assert not [s for s in obs.recorded() if s[1] >= t0]


def test_each_step_records_its_phases_nested(engine):
    with obs.recording() as got:
        _serve(engine)
    engine.run_until_drained()
    steps = [s for s in got if s[0] == "engine.step"]
    assert len(steps) == 3
    assert _nested(got)
    assert set(ENGINE + PLANE) <= {s[0] for s in got}
    for _, a, b in steps:
        inside = [s for s in got if a <= s[1] and s[2] <= b]
        names = [s[0] for s in inside]
        assert names.count("plane.step") == 1
        assert names.count("plane.io_wait") == engine.cfg.num_layers
        for name in ("engine.sample", "engine.read_tokens", "engine.feed",
                     "engine.replay", "engine.read_trace",
                     "engine.complete"):
            assert names.count(name) == 1, name
    # every span of the body lies inside one of its steps
    assert all(any(a <= s[1] and s[2] <= b for _, a, b in steps)
               for s in got)


def test_plane_phases_lie_inside_its_step_apart(engine):
    with obs.recording() as got:
        _serve(engine, n_steps=2)
    engine.run_until_drained()
    for _, a, b in (s for s in got if s[0] == "plane.step"):
        phases = sorted((s for s in got if s[0] in PHASES
                         and a <= s[1] and s[2] <= b), key=lambda s: s[1])
        assert [s[0] for s in phases] == list(PHASES)
        assert all(x[2] <= y[1] for x, y in zip(phases, phases[1:]))
        price = phases[1]
        waits = [s for s in got if s[0] == "plane.io_wait"
                 and a <= s[1] and s[2] <= b]
        assert waits and all(price[1] <= s[1] and s[2] <= price[2]
                             for s in waits)


def test_setup_plane_is_recorded_with_recording_off():
    from repro_torch.launch.serve import build_engine
    t0 = time.perf_counter_ns()
    eng, _ = build_engine("smollm-135m", reduced=True, device="cpu",
                          buckets=(1,))
    eng.close()
    setup = [s for s in obs.recorded() if s[1] >= t0]
    assert [s[0] for s in setup] == ["setup.plane"]
    assert setup[0][2] > setup[0][1]


def test_off_span_is_one_shared_object():
    assert obs.span("a") is obs.span("b")
    with obs.recording():
        assert obs.span("a") is not obs.span("a")


def test_spans_are_recorded_while_the_profiler_runs():
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter_ns()
    with obs.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("inside"):
            pass
    with obs.span("after"):
        pass
    assert [s[0] for s in obs.recorded() if s[1] >= t0] == ["inside"]


def test_profiler_times_line_up_with_the_recorder():
    """A recorder span and a profiler range around the same 20 ms sleep,
    the range's times moved by `progtrace.on_recorder_clock`, agree within
    1 ms at both ends once one warm-up range has run."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import progtrace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        offset = progtrace.clock_offset_ns()
        with record_function("warm-up"):
            time.sleep(0.001)
        with obs.recording() as got:
            with record_function("sleep"), obs.span("sleep"):
                time.sleep(0.02)
    at = progtrace.on_recorder_clock(prof, offset)
    rng = [e for e in prof.events() if e.name == "sleep"][0].time_range
    (_, t0, t1), = got
    assert abs(at(rng.start) - t0) < 1e6
    assert abs(at(rng.end) - t1) < 1e6
