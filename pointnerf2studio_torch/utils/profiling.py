"""Tracing and profiling utilities.

Port of `pointnerf2studio_tpu/utils/profiling.py` on torch: `trace`
records a torch.profiler trace of the host and, where the process has a
CUDA device, of the card, and writes it as a Chrome trace (Perfetto and
chrome://tracing read it); `annotate` names a region of that trace; a
stage timer that waits for the device of its stage's output tensors; and
a per-step rate meter (the reference's it/s logging, reference:
pointnerf/utils/visualizer.py:158-167).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace of the block and write it to
    `log_dir/trace.json`. Yields the profiler (its `key_averages()` sums
    the time by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Name a region so it shows up in the trace timeline."""
    return torch.profiler.record_function(name)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for x in out:
            yield from _tensors(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _tensors(x)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _tensors(getattr(out, f.name))


def synchronize(out) -> None:
    """Wait for every CUDA device that holds a tensor of `out` (a tensor,
    or lists, tuples, dicts and dataclasses of them); host tensors need
    no wait."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Wall-clock stage timing that waits for each stage's device work.

    Usage:
        st = StageTimer()
        out = st.stage("knn", lambda: knn_fn(...))
        print(st.report())
    """

    def __init__(self):
        self.times: Dict[str, float] = {}

    def stage(self, name: str, thunk):
        t0 = time.perf_counter()
        out = thunk()
        synchronize(out)
        self.times[name] = self.times.get(name, 0.0) + (
            time.perf_counter() - t0)
        return out

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k:>24s}: {v * 1e3:8.1f} ms ({v / total:5.1%})"
                 for k, v in self.times.items()]
        lines.append(f"{'total':>24s}: {total * 1e3:8.1f} ms")
        return "\n".join(lines)


class RateMeter:
    """Exponential-moving-average step rate (it/s and items/s)."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self._t: Optional[float] = None
        self.ema_dt: Optional[float] = None

    def tick(self, n_items: int = 1, out=None) -> Dict[str, float]:
        """One step of `n_items` done; `out`, the step's output, is waited
        for first (the device of each of its tensors), so that the clock
        reads the step's end and not its enqueue."""
        synchronize(out)
        now = time.perf_counter()
        res: Dict[str, float] = {}
        if self._t is not None:
            dt = now - self._t
            self.ema_dt = dt if self.ema_dt is None else (
                self.alpha * dt + (1 - self.alpha) * self.ema_dt)
            res = {"it_per_sec": 1.0 / self.ema_dt,
                   "items_per_sec": n_items / self.ema_dt}
        self._t = now
        return res
