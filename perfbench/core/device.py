"""The card: its description, the guard against JAX in the process, and
the reading of a torch.profiler trace into busy time, device operations
and idle gaps."""

from __future__ import annotations

import bisect
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "pointnerf2studio_tpu")


def forbidden_modules() -> List[str]:
    """Modules in this process whose whole top-level name is JAX's, its
    libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def smi_lines(index: int = 0) -> str:
    """nvidia-smi's name, power limit and clocks of card `index`, or why
    they could not be read."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit,power.draw,clocks.sm,"
             "clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _kineto_events(prof):
    """(device operations [(start_ns, end_ns, name)], host intervals) of
    a finished profile. The device timeline's user annotations (a
    record_function's or the optimizer's range mirrored onto the device,
    under the name of a host range) are no operations and are left out."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        iv = (s, s + e.duration_ns(), e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(iv)
        else:
            host.append(iv)
    host_names = {h[2] for h in host}
    dev = [d for d in dev if d[2] not in host_names]
    return dev, host


def summarise(prof, window_s: float) -> Dict:
    """busy_s (the union of the device operations' intervals), kernel
    launches, the 10 device operations that took most time, and the 10
    host operations under which the device idled longest (each gap
    between device operations named by the innermost host operation open
    at its middle), from a profile of `window_s` seconds."""
    dev, host = _kineto_events(prof)
    dev.sort()
    busy_ns, end = 0, None
    by_name: Dict[str, float] = {}
    gaps: List[Tuple[int, int]] = []
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
        if end is None or s >= end:
            if end is not None and s > end:
                gaps.append((s - end, (s + end) // 2))
            busy_ns += e - s
            end = e
        elif e > end:
            busy_ns += e - end
            end = e
    gaps.sort(reverse=True)
    idle: Dict[str, float] = {}
    if gaps:
        host.sort()
        starts = [h[0] for h in host]
        # the innermost open host operation at each of the longest gaps'
        # middles (the 5,000 longest carry nearly all idle time): the
        # latest-starting one that has not ended there
        for length, mid in gaps[:5000]:
            key = "no host operation"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if host[j][1] >= mid:
                    key = host[j][2]
                    break
            idle[key] = idle.get(key, 0.0) + length * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
            "launches": len(dev), "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:10]],
            "device_time_by_name": by_name}
