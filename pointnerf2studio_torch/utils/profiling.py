"""Tracing: the port's own spans and counters, on torch.profiler's clock.

`span(name, args)` names a region of the program and `count(name, n)`
counts an event. Both act only while a torch.profiler session records
(torch's own flag, `torch.autograd.profiler._is_profiler_enabled`): the
benchmark's traced window, or the operator's `trace(log_dir)`. Otherwise
a span is one check of that flag and a shared empty context, and a
count is the same check: no `record_function` is opened (it costs 9-12
us even with no profiler running) and nothing is written.

While on, a span opens `torch.profiler.record_function(name, args)`, so
its host range lands in the same kineto timeline as the device
operations (`args` carries the request's identifier: `frame=<n>`,
`chunk=<i> budget=<b> tier=<dw>`, `step=<n>`). It also adds to the
registry, one `collections.Counter`: `span.<name>.n` (entries),
`span.<name>.ns` (host nanoseconds inside it) and `span.<name>.self_ns`
(the same less its child spans'). The program keeps no timeline of its
own: kineto's host stamps are not `time.perf_counter_ns`'s, so only
durations are recorded. `count` adds `n` to the registry under its
name. `reset()` clears the registry and `snapshot()` copies it.

`trace(log_dir)` records a torch.profiler trace of the block, of the
host and, where the process has a CUDA device, of the card, and writes
it as a Chrome trace (Perfetto and chrome://tracing read it) with the
registry beside it as `counters.json`.

Kernel launches by kernel name stay in `ops/_cuda.LAUNCHES`, counted
always; the registry holds no kernel names.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, List

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"
COUNTERS_FILE = "counters.json"

REGISTRY: collections.Counter = collections.Counter()
# the child spans' nanoseconds of each open span, innermost last
_CHILD_NS: List[int] = []


def recording() -> bool:
    """Whether a torch.profiler session records now (spans and counts
    act only then)."""
    return _autograd_profiler._is_profiler_enabled


_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str, args: str):
        self.name = name
        self.rf = torch.profiler.record_function(name, args or None)

    def __enter__(self):
        self.rf.__enter__()
        _CHILD_NS.append(0)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        child = _CHILD_NS.pop()
        if _CHILD_NS:
            _CHILD_NS[-1] += dt
        key = "span." + self.name
        REGISTRY[key + ".n"] += 1
        REGISTRY[key + ".ns"] += dt
        REGISTRY[key + ".self_ns"] += dt - child
        return self.rf.__exit__(*exc)


def span(name: str, args: str = ""):
    """A context manager naming the block `name` in the trace and the
    registry while a profiler records; an empty one otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)


def count(name: str, n: int = 1) -> int:
    """Add `n` to the registry's `name` while a profiler records; the
    count so far (0 when off)."""
    if not _autograd_profiler._is_profiler_enabled:
        return 0
    REGISTRY[name] += n
    return REGISTRY[name]


def reset() -> None:
    REGISTRY.clear()


def snapshot() -> Dict[str, int]:
    return dict(REGISTRY)


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace of the block and write it to
    `log_dir/trace.json`, and the block's spans and counts (the registry,
    cleared on entry) to `log_dir/counters.json`. Yields the profiler
    (its `key_averages()` sums the time by kernel and by span)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, COUNTERS_FILE), "w") as f:
        json.dump(snapshot(), f, indent=1, sort_keys=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
