"""The traced sub-window: the harness's reading of the profiler kept as
it was, the idle gaps charged to the program's spans, and the six
span metrics reported by a tiny traced run on the CPU (and left out,
without a fault, for a port that records no spans); `progtrace`'s split
of a tiny cell's sub-window."""
import time
from types import SimpleNamespace as NS

import pytest
import torch

from portbench import devtrace, progtrace, spec
from portbench.run import run_cell
from portbench.testing import CELL, tiny_bench

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SPAN_METRICS = ("plane_lookup_ms", "plane_io_wait_ms", "plane_sim_ms",
                "prefill_host_ms", "host_read_ms", "setup_plane_s")


def _ev(name, a, b, dev=CPU):
    return NS(name=name, device_type=dev, time_range=NS(start=a, end=b))


def test_read_keeps_every_number_it_gave():
    """Two made-up steps (microseconds): the window, the harness's
    ranges, their annotation copies on the device, device ops (one
    before the window, one past it)."""
    events = [
        _ev("portbench.window", 100.0, 1100.0),
        _ev("step", 110.0, 590.0), _ev("step", 600.0, 1090.0),
        _ev("prefill", 120.0, 200.0), _ev("sample", 210.0, 220.0),
        _ev("replay", 230.0, 260.0), _ev("plane", 400.0, 580.0),
        _ev("replay", 700.0, 720.0), _ev("plane", 800.0, 1000.0),
        _ev("step", 50.0, 90.0),
        _ev("portbench.window", 100.0, 1100.0, CUDA),
        _ev("replay", 230.0, 231.0, CUDA),
        _ev("ampere_gemm", 90.0, 150.0, CUDA),
        _ev("void fused::hidden_kernel<float>", 240.0, 300.0, CUDA),
        _ev("void fused::down_kernel<float>", 290.0, 350.0, CUDA),
        _ev("elementwise_kernel", 705.0, 790.0, CUDA),
        _ev("Memcpy DtoH", 1050.0, 1200.0, CUDA)]
    assert devtrace.read(events) == {
        "busy_s": 0.00029499999999999996, "window_s": 0.001,
        "device_ops": [["elementwise_kernel", 8.499999999999999e-05],
                       ["void fused::hidden_kernel<float>",
                        5.9999999999999995e-05],
                       ["void fused::down_kernel<float>",
                        5.9999999999999995e-05],
                       ["ampere_gemm", 4.9999999999999996e-05],
                       ["Memcpy DtoH", 4.9999999999999996e-05]],
        "idle_gaps": [["plane", 0.000615],
                      ["prefill", 8.999999999999999e-05]],
        "cold_s": 0.00011999999999999999}
    assert devtrace.read(events[1:]) == {}


def test_idle_gaps_go_to_the_innermost_span():
    """Nanoseconds: a step holding a replay and the plane with its
    lookup, a second step, the harness's own time after them; each gap
    goes to the span open at its middle."""
    spans = [("setup.plane", 0, 50),
             ("engine.replay", 1_100, 1_300),
             ("plane.lookup", 1_500, 1_800),
             ("plane.step", 1_400, 1_900),
             ("engine.step", 1_000, 2_000),
             ("engine.step", 2_000, 2_500),
             (devtrace.WINDOW, 900, 3_000)]
    busy = [(1_150, 1_200), (1_250, 1_260), (2_100, 2_200), (2_600, 2_700)]
    got = progtrace.idle_spans(spans, busy)
    assert [name for name, _ in got] == [
        "plane.lookup", "engine.step", "harness", "engine.replay"]
    assert dict(got) == pytest.approx({
        "plane.lookup": 840e-9,           # 1260-2100, middle 1680
        "engine.step": 250e-9 + 400e-9,   # 900-1150 and 2200-2600
        "harness": 300e-9,                # 2700-3000, past the steps
        "engine.replay": 50e-9})          # 1200-1250
    assert progtrace.idle_spans(spans[:-1], busy) == []


def test_timeline_names_the_innermost_open_span():
    times, names = progtrace.timeline(
        [("b", 20, 30), ("a", 10, 50), ("c", 30, 40), ("d", 60, 70)])
    assert list(zip(times, names)) == [
        (10, "a"), (20, "b"), (30, "a"), (30, "c"), (40, "a"),
        (50, None), (60, "d"), (70, None)]


def _traced(tmp_path):
    manifest, bench = tiny_bench(tmp_path)
    return run_cell(manifest, CELL, 2 ** 31 + 5, 0.2, True, "cpu",
                    time.time(), bench_dir=bench)


def test_tiny_traced_run_reports_the_span_metrics(tmp_path):
    out, lines = _traced(tmp_path)
    assert out["correct"], lines
    m = out["metrics"]
    for name in SPAN_METRICS:
        assert m[name]["value"] >= 0, name
    assert m["plane_lookup_ms"]["value"] > 0
    assert m["plane_io_wait_ms"]["value"] > 0
    assert m["setup_plane_s"]["value"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_port_without_spans_leaves_their_metrics_out(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(progtrace, "recorder", lambda: None)
    out, lines = _traced(tmp_path)
    assert out["correct"], lines
    assert not set(SPAN_METRICS) & set(out["metrics"])
    assert "plane_ms" in out["metrics"]


def test_split_charges_the_tiny_window_to_the_program_spans(tmp_path):
    """On the CPU the device does nothing, so the whole sub-window is
    one idle gap, charged whole to the span open at its middle; each
    `plane.step` lies inside the spy's time of the same step."""
    manifest, bench = tiny_bench(tmp_path)
    got = progtrace.split_cell(spec.cell(manifest, CELL, bench),
                               2 ** 31 + 9, 0.2, "cpu")
    assert got["busy_s"] == 0
    spans = dict(got["idle_spans"])
    assert sum(spans.values()) == pytest.approx(got["window_s"], rel=1e-3)
    assert len(spans) == 1
    assert got["named_idle_pct"] in (0, 100)
    lo, hi = got["plane_over_spy"]
    assert 0 < lo <= hi <= 1
