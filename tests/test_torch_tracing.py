"""The port's spans and counters (utils/profiling.py) on the CPU.

  * with no profiler recording, a span opens no `record_function` and a
    count writes nothing: the registry and `_cuda.LAUNCHES` stay as they
    were;
  * under torch.profiler, nested spans land in the kineto events by name,
    and each span's `n`, `ns` and `self_ns` agree (a parent's self time is
    its time less its children's), also through an exception;
  * `render_frame` on a tiny sphere with a compact budget of 2, so that
    the budget escalation re-renders: frames, chunk renders and
    re-renders counted (chunk renders = chunks + re-renders), each of
    its spans entered as often as it runs, and a frame equal bit for bit
    with the profiler on and off;
  * the legacy train step records each `train.*` span once a step, and
    the joint MVS step each `joint.*` span and its two counters;
  * nvcc's builds, library loads and weight packs are counted;
  * the benchmark's five metrics that read the registry: finite in a
    traced run of each cell at the CPU tests' size, absent from an
    untraced one."""

import dataclasses
import json
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointnerf2studio_torch.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_torch.models import fast_render as tfr
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.train import trainer as ttrainer
from pointnerf2studio_torch.train.evaluator import make_fast_frame_renderer
from pointnerf2studio_torch.utils import profiling

torch.set_num_threads(1)

FRAME_SPANS = ("render_frame", "render_frame.plan", "render_frame.chunk",
               "render_frame.wait", "render_frame.scatter")
TRAIN_SPANS = ("train.step", "train.forward", "train.loss",
               "train.backward", "train.optimizer")
JOINT_SPANS = ("joint.step", "joint.features", "joint.cost_volume",
               "joint.cost_reg", "joint.points", "joint.grid", "joint.render",
               "joint.loss", "joint.backward", "joint.optimizer")
NEW_METRICS = {"room-frames-staged": ("frame_plan_ms", "frame_wait_ms",
                                      "frame_rerenders_per_frame"),
               "chair-train": ("train_host_ms_per_step",),
               "chair-mvs-joint": ("joint_host_ms_per_step",)}


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def recorded():
    return profile(activities=[ProfilerActivity.CPU])


def span_counts(name):
    snap = profiling.snapshot()
    return tuple(snap.get(f"span.{name}.{k}", 0)
                 for k in ("n", "ns", "self_ns"))


def test_off_opens_nothing_and_writes_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    launches = dict(_cuda.LAUNCHES)
    assert not profiling.recording()
    with profiling.span("outer", "frame=1"):
        with profiling.span("inner"):
            assert profiling.count("events", 3) == 0
    assert profiling.span("a") is profiling.span("b")
    assert profiling.snapshot() == {}
    assert dict(_cuda.LAUNCHES) == launches


def test_nested_spans_under_the_profiler():
    with recorded() as prof:
        assert profiling.recording()
        with profiling.span("outer", "step=4"):
            with profiling.span("child"):
                time.sleep(0.01)
            with profiling.span("child"):
                with profiling.span("leaf"):
                    time.sleep(0.005)
            time.sleep(0.01)
        assert profiling.count("events") == 1
        assert profiling.count("events", 2) == 3
    names = {e.name for e in prof.events()}
    assert {"outer", "child", "leaf"} <= names
    n, ns, self_ns = span_counts("outer")
    cn, cns, cself = span_counts("child")
    ln, lns, lself = span_counts("leaf")
    assert (n, cn, ln) == (1, 2, 1)
    assert self_ns == ns - cns and cself == cns - lns and lself == lns
    assert self_ns >= 10_000_000 and lns >= 5_000_000
    assert profiling.snapshot()["events"] == 3
    snap = profiling.snapshot()
    snap["events"] = 0
    assert profiling.snapshot()["events"] == 3
    profiling.reset()
    assert profiling.snapshot() == {}


def test_a_span_closes_through_an_exception():
    with recorded():
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise ValueError("out")
        with profiling.span("after"):
            pass
    assert span_counts("inner")[0] == span_counts("outer")[0] == 1
    n, ns, self_ns = span_counts("after")
    assert n == 1 and ns == self_ns
    assert profiling._CHILD_NS == []


def test_trace_clears_the_registry_on_entry(tmp_path):
    with recorded():
        profiling.count("stale", 5)
    with profiling.trace(str(tmp_path)):
        profiling.count("fresh")
    counters = json.loads((tmp_path / profiling.COUNTERS_FILE).read_text())
    assert counters == {"fresh": 1}


@pytest.fixture(scope="module")
def sphere():
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(
        cfg, query=dataclasses.replace(cfg.query, ray_slot_budget=16,
                                       compact_budget=2, max_q=32768),
        agg=dataclasses.replace(cfg.agg, compute_dtype="float32"))
    scene = make_sphere_scene(n_points=4000, cfg=cfg, device="cpu")
    return dict(cfg=cfg, scene=scene,
                rays=camera_rays(scene.camrotc2w, 16, 16, 12.0))


def test_render_frame_counts_frames_chunks_and_rerenders(sphere,
                                                        monkeypatch):
    s, sc = sphere, sphere["scene"]
    render = make_fast_frame_renderer(s["cfg"], sc.cloud, sc.grid, sc.near,
                                      sc.far, chunk=64)
    launches = sum(_cuda.LAUNCHES.values())
    off = render(sc.params, sc.campos, sc.camrotc2w, s["rays"])
    assert profiling.snapshot() == {}
    budgets = []
    orig = tfr.fast_render_rays

    def spy(*a, **k):
        budgets.append(a[8].query.compact_budget)
        return orig(*a, **k)

    monkeypatch.setattr(tfr, "fast_render_rays", spy)
    with recorded() as prof:
        outs = [render(sc.params, sc.campos, sc.camrotc2w, s["rays"])
                for _ in range(2)]
    for out in outs:
        for f in ("coarse_raycolor", "ray_mask", "acc", "depth"):
            assert torch.equal(getattr(out, f), getattr(off, f)), f
    # each chunk at budget 2 first, the tripped ones again at a larger one
    chunks = budgets.count(2)
    snap = profiling.snapshot()
    rerenders = snap.get("render_frame.rerenders", 0)
    assert chunks >= 4 and rerenders == len(budgets) - chunks >= 2
    assert snap["render_frame.frames"] == 2
    assert snap["render_frame.chunk_renders"] == chunks + rerenders
    assert span_counts("render_frame.chunk")[0] == snap[
        "render_frame.chunk_renders"]
    for name in ("render_frame", "render_frame.plan",
                 "render_frame.scatter"):
        assert span_counts(name)[0] == 2, name
    assert span_counts("render_frame.wait")[0] >= 2
    names = {e.name for e in prof.events()}
    assert set(FRAME_SPANS) <= names
    n, ns, self_ns = span_counts("render_frame")
    assert self_ns == ns - sum(span_counts(c)[1] for c in FRAME_SPANS[1:])
    assert not any(k.startswith(("render_frame", "span."))
                   for k in _cuda.LAUNCHES)
    assert sum(_cuda.LAUNCHES.values()) == launches


def test_legacy_train_step_records_each_phase_once_a_step(sphere):
    s, sc = sphere, sphere["scene"]
    cfg = s["cfg"]
    assert sc.grid.cache is not None
    state = ttrainer.create_train_state(sc.params, sc.cloud, cfg)
    step = ttrainer.make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    gt = torch.rand(s["rays"].shape[0], 3, generator=gen)
    args = (sc.grid, sc.campos, sc.camrotc2w, s["rays"], gt, sc.near,
            sc.far)
    state, _ = step(state, *args, generator=gen)
    assert profiling.snapshot() == {}
    with recorded() as prof:
        for _ in range(2):
            state, aux = step(state, *args, generator=gen)
    assert torch.isfinite(aux["total"])
    assert profiling.snapshot()["train.steps"] == 2
    for name in TRAIN_SPANS:
        assert span_counts(name)[0] == 2, name
    n, ns, self_ns = span_counts("train.step")
    assert self_ns == ns - sum(span_counts(c)[1] for c in TRAIN_SPANS[1:])
    assert set(TRAIN_SPANS) <= {e.name for e in prof.events()}


def test_joint_step_records_each_phase_once_a_step():
    """One joint step at the benchmark's tiny cut (3 views of 32x32, 16
    planes, 64 rays): nothing in the registry with no profiler running;
    under one, `joint.steps` and `joint.points_generated` (h * w) counted
    and each span entered once, the step's self time its time less its
    phases'."""
    from perfbench.kinds import joint as kj
    from perfbench.tests.tiny import tiny_spec
    cell = kj.Joint(tiny_spec("chair-mvs-joint"), 5, torch.device("cpu"))
    cell.build()
    cell.step()
    assert profiling.snapshot() == {}
    with recorded() as prof:
        aux = cell.step()
    assert torch.isfinite(aux["total"])
    snap = profiling.snapshot()
    assert snap["joint.steps"] == 1
    assert snap["joint.points_generated"] == 8 * 8
    for name in JOINT_SPANS:
        assert span_counts(name)[0] == 1, name
    n, ns, self_ns = span_counts("joint.step")
    assert self_ns == ns - sum(span_counts(c)[1] for c in JOINT_SPANS[1:])
    assert set(JOINT_SPANS) <= {e.name for e in prof.events()}


def test_kernel_builds_loads_and_packs_are_counted(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(_cuda, "_command", lambda name, out, extra=(): [
        sys.executable, "-c", f"open({str(out)!r}, 'w').close()"])
    monkeypatch.setattr(_cuda.ctypes, "CDLL", lambda path: path)
    params = [torch.zeros(3)]
    holder = type("Holder", (), {})()
    with recorded() as prof:
        _cuda.build(["march", "first_valid_cols"])
        _cuda.build(["march"])
        assert _cuda.library("march") == _cuda.library("march")
        for _ in range(2):
            _cuda.packed_once(holder, "packed", params, lambda: 1)
        params[0].add_(1.0)
        _cuda.packed_once(holder, "packed", params, lambda: 2)
    snap = profiling.snapshot()
    assert snap["kernels.builds"] == 2 and span_counts("kernels.build")[0] == 1
    assert snap["kernels.loads"] == 1 and snap["kernels.weight_packs"] == 2
    builds = [e for e in prof.events() if e.name == "kernels.build"]
    assert len(builds) == 1


@pytest.mark.parametrize("traced", [True, False], ids=["traced", "untraced"])
@pytest.mark.parametrize("cell", sorted(NEW_METRICS))
def test_benchmark_reads_the_registry(cell, traced):
    import math

    from perfbench.core import harness
    from perfbench.tests.tiny import tiny_spec
    line = harness.run(tiny_spec(cell), 2_400_000_017, 0.3, traced,
                       torch.device("cpu"), time.perf_counter())
    got = {m: line["metrics"].get(m) for m in NEW_METRICS[cell]}
    others = {m for ms in NEW_METRICS.values() for m in ms} - set(got)
    assert not others & set(line["metrics"])
    if not traced:
        assert got == dict.fromkeys(got)
        return
    for name, m in got.items():
        assert m is not None and math.isfinite(m["value"]), name
        assert m["value"] >= 0 and m["unit"] in ("ms", "renders")
    first = NEW_METRICS[cell][0]
    assert got[first]["value"] > 0
