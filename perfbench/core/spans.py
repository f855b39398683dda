"""Spans of a traced run, recorded from the benchmark's own code: each
named function of the program is wrapped, for the run, in a
torch.profiler.record_function of the layer's name, so that the trace's
idle gaps can be named by the layer the host was in. Untraced runs wrap
nothing."""

from __future__ import annotations

import contextlib
import functools
import importlib

import torch


@contextlib.contextmanager
def spans(targets):
    """Wrap each (module path, function name, span name) of `targets`
    while the block runs; restore the originals after it."""
    saved = []
    try:
        for path, attr, name in targets:
            mod = importlib.import_module(path)
            fn = getattr(mod, attr)

            @functools.wraps(fn)
            def wrapped(*a, _fn=fn, _name=name, **k):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **k)

            setattr(mod, attr, wrapped)
            saved.append((mod, attr, fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
