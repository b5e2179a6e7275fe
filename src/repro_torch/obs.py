"""Spans on the host clock: where the serving path spends its time.

`span(name)` marks a piece of work:

    with obs.span("plane.lookup"):
        ...

While recording is off (the default) it returns one shared object that
does nothing, so a site costs two flag checks and no allocation.
Recording is on inside `recording()`, and while torch's profiler runs,
so that a profile of the serving path carries the program's spans
beside the profiler's own ranges. Each span then appends
`(name, t0_ns, t1_ns)`, read from `time.perf_counter_ns()`, to a
bounded buffer, and `recording()` hands back what its body recorded.
`always(name)` marks work that runs once per engine or per capture
(`setup.plane`, `decoder.capture`): it is recorded whether or not
recording is on, into the same buffer, and `recorded()` returns the
buffer.

Three rules hold the module to the serving path's contracts:

* apart from `ServeEngine.generate()`'s `wall_s`, this is the only
  place in the serving path that reads the host clock;
* nothing recorded here feeds the modeled clock or any scheduling
  decision: spans are read by a profiler or a benchmark, never by the
  engine;
* no span sits inside a function that a captured decode step runs
  (`models/`, `core/sparse_ffn.py`, `kernels/`): a CUDA graph capture
  would run the span once and its replays never.

Spans nest, and on the one thread that drives the engine they are
properly nested: a span closes before its parent does. The storage
plane's I/O thread records none.

The recorder is one per process, like the profiler it is read beside.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager

import torch

__all__ = ["span", "always", "recording", "recorded", "CAPACITY"]

CAPACITY = 1 << 16         # spans kept; the oldest go first

_clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
_buffer: deque = deque(maxlen=CAPACITY)
_on = False


class _Off:
    """The span of a site while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        _buffer.append((self.name, self.t0, _clock()))
        return False


def span(name: str):
    """A context manager that records `name` around its body while
    recording is on or torch's profiler runs."""
    return _Span(name) if _on or _profiling() else _OFF


def always(name: str):
    """A span recorded whether or not recording is on."""
    return _Span(name)


@contextmanager
def recording():
    """Record every span of the body; yields the list that holds them,
    `(name, t0_ns, t1_ns)` in the order they closed, once the body is
    done. The spans also stay in the process's buffer."""
    global _buffer, _on
    outer, was = _buffer, _on
    _buffer, _on = deque(maxlen=CAPACITY), True
    got: list = []
    try:
        yield got
    finally:
        got.extend(_buffer)
        outer.extend(_buffer)
        _buffer, _on = outer, was


def recorded() -> list:
    """Every span the buffer holds, in the order they closed."""
    return list(_buffer)
