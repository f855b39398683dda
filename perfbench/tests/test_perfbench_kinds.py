"""Traffic kinds as plug-ins (`perfbench/kinds/__init__.py`): the
end-to-end readers read what a record says its window timed, whatever
kind made it; a cell of a new kind is found, cut to the tiny size and
reported from new files and an appended `workloads` entry alone; the two
kinds' records read by their formulas; `tools/readings.py` hands each
mode to the cell's kind."""

import importlib.util
import json
import shutil
import time
import types

import numpy as np
import pytest
import torch

from perfbench.core import harness
from perfbench.tests.tiny import tiny_spec

CPU = torch.device("cpu")
RECORD = {"setup_s": 1.5, "attempted": 8, "failed": 0,
          "memory_peak_bytes": 0, "checks": {"x": 0.5}}
LOOPS = {
    "steps": ({"loop": "steps", "steps": 8, "rays": 8 * 4096,
               "window_s": 2.0},
              {"train_rays_per_s": 8 * 4096 / 2.0, "setup_s": 1.5}),
    "frames": ({"loop": "frames", "frames": 4, "pixels": 640 * 480,
                "frame_s": [0.2, 0.25, 0.3, 0.5], "window_s": 1.25},
               {"render_rays_per_s": 4 * 640 * 480 / 1.25,
                "frame_ms_p90": float(np.percentile([200, 250, 300, 500],
                                                    90)),
                "setup_s": 1.5}),
    None: ({}, {"setup_s": 1.5}),
}


def _bench(root=harness.ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _stub(monkeypatch, record: dict):
    """A kind `stub` in `harness.kind`'s place, whose run returns
    `record`; every other kind is the real one."""
    def run(spec, seed, seconds, trace, device, t_start, clock=None,
            hooks=None):
        return dict(record)
    stub = types.SimpleNamespace(run=run, CHECKS=("x",),
                                 TINY_TRAFFIC={"batch": 16})
    real = harness.kind
    monkeypatch.setattr(harness, "kind",
                        lambda name: stub if name == "stub" else real(name))


@pytest.mark.parametrize("loop", list(LOOPS), ids=str)
def test_end_to_end_readers_read_the_loop(monkeypatch, loop):
    """Under every metric of BENCHMARK.json, a stub kind's record gets
    the end-to-end metrics of what its window timed, by their formulas,
    and no per-layer metric (each belongs to its own kind)."""
    extra, want = LOOPS[loop]
    _stub(monkeypatch, {**RECORD, **extra})
    bench = _bench()
    spec = harness.Spec(name="stub-cell", cell={"chips": 1}, config={},
                        traffic={"kind": "stub"}, limits={"x": 1.0},
                        end_to_end=bench["end_to_end"],
                        per_layer=bench["per_layer"])
    line = harness.run(spec, 1, 1.0, False, CPU, time.perf_counter())
    assert {k: m["value"] for k, m in line["metrics"].items()} == want
    assert line["correct"] and line["checks"] == {
        "x": {"value": 0.5, "limit": 1.0}}
    traced = harness.run(spec, 1, 1.0, True, CPU, time.perf_counter())
    assert traced["metrics"] == {}


def test_a_cell_of_a_new_kind_from_files_alone(tmp_path, monkeypatch):
    """A copy of the benchmark with a new configuration, traffic mix of
    kind `stub`, limits and tiny cut, and the new cell's name appended to
    `train_rays_per_s`'s `workloads`: `harness.load` and `tiny_spec` find
    the cell, and its run reports `train_rays_per_s` and `setup_s`."""
    pb = tmp_path / "perfbench"
    shutil.copytree(harness.ROOT / "perfbench", pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    (pb / "configs" / "stub-config.json").write_text(json.dumps(
        {"name": "stub-config", "scene": {"n_points": 40000}}))
    (pb / "traffic" / "stub-mix.json").write_text(json.dumps(
        {"kind": "stub", "batch": 4096}))
    (pb / "limits" / "stub-cell.json").write_text(json.dumps({"x": 1.0}))
    (pb / "tiny" / "stub-config.json").write_text(json.dumps(
        {"scene": {"n_points": 100}}))
    bench["configs"].append({"name": "stub-config", "source": "-",
                             "file": "perfbench/configs/stub-config.json",
                             "reduced": [], "why": "-"})
    bench["workloads"].append({"name": "stub-cell", "config": "stub-config",
                               "traffic": "stub-mix", "chips": 1,
                               "why": "-"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append("stub-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    _stub(monkeypatch, {**RECORD, **LOOPS["steps"][0]})

    spec = harness.load("stub-cell", root=tmp_path)
    assert [m["name"] for m in spec.end_to_end] == ["train_rays_per_s",
                                                    "setup_s"]
    assert spec.per_layer == [] and spec.limits == {"x": 1.0}
    tiny = tiny_spec("stub-cell", root=tmp_path)
    assert tiny.config["scene"] == {"n_points": 100}
    assert tiny.traffic == {"kind": "stub", "batch": 16}
    line = harness.run(spec, 2 ** 31 + 5, 1.0, False, CPU,
                       time.perf_counter(), root=tmp_path)
    assert {k: m["value"] for k, m in line["metrics"].items()} == \
        LOOPS["steps"][1]
    assert line["correct"]
    for cell in ("chair-train", "room-frames-staged"):
        assert [m["name"] for m in harness.load(
            cell, root=tmp_path).end_to_end] == [
            m["name"] for m in harness.load(cell).end_to_end]


def _formulas(r: dict) -> dict:
    if r["loop"] == "steps":
        return {"train_rays_per_s": r["rays"] / r["window_s"],
                "setup_s": r["setup_s"]}
    return {"render_rays_per_s": r["frames"] * r["pixels"] / r["window_s"],
            "frame_ms_p90": float(np.percentile(
                np.asarray(r["frame_s"]) * 1e3, 90)),
            "setup_s": r["setup_s"]}


@pytest.mark.parametrize("cell,loop", [("chair-train", "steps"),
                                       ("room-frames-staged", "frames")])
def test_kinds_records_read_by_their_formulas(monkeypatch, cell, loop):
    """A whole run of each cell at the CPU tests' size: its kind's record
    says what the window timed, and the line's end-to-end values are the
    formulas on that record."""
    spec = tiny_spec(cell)
    records = []
    real = harness.kind

    def kind(name):
        mod = real(name)

        def run(*a, **k):
            records.append(mod.run(*a, **k))
            return records[-1]
        return types.SimpleNamespace(run=run, CHECKS=mod.CHECKS)
    monkeypatch.setattr(harness, "kind", kind)
    line = harness.run(spec, 2_400_000_011, 0.2, False, CPU,
                       time.perf_counter())
    (r,) = records
    assert r["loop"] == loop
    assert {k: m["value"] for k, m in line["metrics"].items()} == \
        _formulas(r)


def _readings_tool():
    path = harness.ROOT / "perfbench" / "tools" / "readings.py"
    s = importlib.util.spec_from_file_location("perfbench_readings", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", ["chair-train", "room-frames-staged"])
def test_readings_tool_runs_each_mode_through_the_kind(monkeypatch, capsys,
                                                       cell):
    """`tools/readings.py --cpu` hands every mode of the cell's kind to
    that kind's `readings`, and prints its compared numbers; a mode the
    kind lacks raises, naming the mode and the kind."""
    tool = _readings_tool()
    calls = []
    real = harness.kind

    def kind(name):
        mod = real(name)

        def readings(spec, seed, device, mode, frames):
            calls.append((name, mode))
            return mod.readings(spec, seed, device, mode, frames)
        return types.SimpleNamespace(readings=readings,
                                     TINY_TRAFFIC=mod.TINY_TRAFFIC)
    monkeypatch.setattr(harness, "kind", kind)
    name = tiny_spec(cell).traffic["kind"]
    modes = real(name).MODES
    for mode in modes:
        assert tool.main(["--cpu", "--workload", cell, "--seeds", "3",
                          "--mode", mode, "--frames", "1"]) == 0
        out = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert out["mode"] == mode and out["seed"] == 3
        assert set(real(name).CHECKS) <= set(out["readings"])
    assert calls == [(name, m) for m in modes]
    with pytest.raises(ValueError, match=f"{name}.*no_such_mode"):
        tool.main(["--cpu", "--workload", cell, "--seeds", "3", "--mode",
                   "no_such_mode"])
