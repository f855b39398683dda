"""The program's own spans and counters: the registry of
`pointnerf2studio_torch/utils/profiling.py`, which counts only while a
torch.profiler session records. A run of `run.py` has one traced window,
so after a traced run the registry holds that window's counts. With
`program.py`, the harness's only import of the program.

A program without the registry (a version before it was added) gives an
empty snapshot, and the metrics that read it read nothing."""

from __future__ import annotations

from typing import Dict


def snapshot() -> Dict[str, int]:
    """The registry's counts: `span.<name>.n`, `.ns` and `.self_ns` of
    each span, and each counter by name; {} where the program has none."""
    from pointnerf2studio_torch.utils import profiling
    snap = getattr(profiling, "snapshot", None)
    return dict(snap()) if snap is not None else {}


def per(key: str, unit: str, scale: float = 1.0):
    """`key`'s count over the registry's `unit` count, times `scale`, or
    None where `unit` counted nothing (a cell of another kind, a program
    without the registry)."""
    snap = snapshot()
    n = snap.get(unit, 0)
    return snap.get(key, 0) * scale / n if n else None
