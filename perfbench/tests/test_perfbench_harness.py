"""The harness: cells, configurations, traffic mixes and metric readers
found by name; the result line's shape; no card, no result; no JAX in a
run and nothing of the program in the reference."""

import json
import math
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from perfbench.core import harness
from perfbench.tests.tiny import tiny_spec

ROOT = Path(__file__).resolve().parents[2]


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_and_metric_is_found_by_name():
    bench = _bench()
    for w in bench["workloads"]:
        spec = harness.load(w["name"])
        assert spec.config["name"] == w["config"]
        assert harness.kind(spec.traffic["kind"]).run
        assert set(spec.limits) == set(harness.kind(
            spec.traffic["kind"]).CHECKS)
        assert any(m["name"] == "setup_s" for m in spec.end_to_end)
        assert len(spec.end_to_end) >= 2 and spec.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_a_new_cell_is_found_from_files_alone(tmp_path):
    """A configuration, traffic mix, metric reader and limits written to a
    new tree are found by name, with no code changed."""
    pb = tmp_path / "perfbench"
    for d in ("configs", "traffic", "metrics", "limits"):
        (pb / d).mkdir(parents=True)
    (pb / "configs" / "c.json").write_text(json.dumps({"name": "c"}))
    (pb / "traffic" / "t.json").write_text(json.dumps({"kind": "frames"}))
    (pb / "limits" / "w.json").write_text(json.dumps({"x": 1.0}))
    (pb / "metrics" / "odd.name.py").write_text(textwrap.dedent("""
        def read(r):
            return r.get("value")
        """))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "c", "file": "perfbench/configs/c.json"}],
        "workloads": [{"name": "w", "config": "c", "traffic": "t",
                       "chips": 1}],
        "end_to_end": [{"name": "setup_s"}, {"name": "odd.name",
                                             "workloads": ["other"]}],
        "per_layer": [{"name": "odd.name", "moves": "setup_s"}]}))
    spec = harness.load("w", root=tmp_path)
    assert spec.traffic == {"kind": "frames"} and spec.limits == {"x": 1.0}
    assert [m["name"] for m in spec.end_to_end] == ["setup_s"]
    assert [m["name"] for m in spec.per_layer] == ["odd.name"]
    assert harness.reader("odd.name", root=tmp_path)({"value": 2.5}) == 2.5
    assert harness.reader("odd.name", root=tmp_path)({}) is None


def test_a_limit_missing_or_extra_raises():
    """A cell whose limits file lacks a compared number, or names one the
    cell does not compare, raises instead of reporting correct."""
    spec = tiny_spec("chair-train")
    for limits in ({k: v for k, v in list(spec.limits.items())[1:]},
                   {**spec.limits, "no_such_check": 1.0}):
        spec.limits = limits
        with pytest.raises(KeyError, match="compares"):
            harness.run(spec, 5, 0.1, False, torch.device("cpu"),
                        time.perf_counter())


@pytest.mark.parametrize("section,key", [("query", "chunk_mod"),
                                         ("agg", "fused_decode_2"),
                                         ("train", "lr_field")])
def test_an_unknown_setting_raises(section, key):
    """A setting the program's config does not have (a misspelt route
    switch) raises rather than running another route."""
    from perfbench.core import program
    spec = tiny_spec("chair-train")
    spec.config[section][key] = 1
    with pytest.raises(KeyError, match=key):
        program.config(spec.config)


def test_result_line_shape():
    """A run's line at the CPU tests' size: the contract's keys, each
    metric with its value and unit, the compared numbers last."""
    spec = tiny_spec("chair-train")
    line = harness.run(spec, 12345678901, 0.5, False, torch.device("cpu"),
                       time.perf_counter())
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_rays_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_traced_line_has_per_layer_metrics_and_breakdown():
    spec = tiny_spec("room-frames-staged")
    line = harness.run(spec, 7, 0.5, True, torch.device("cpu"),
                       time.perf_counter())
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "render_mfu" in line["metrics"]
    assert list(line)[-1] == "checks"


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "chair-train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


SCRIPT = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from perfbench.core import harness, device
from perfbench.tests.tiny import tiny_spec
harness.run(tiny_spec({cell!r}), 3, 0.2, False, torch.device("cpu"),
            time.perf_counter())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(device.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    """A run (at the CPU size) loads no module whose whole top-level name
    is jax, jaxlib, flax or pointnerf2studio_tpu."""
    for cell in ("chair-train", "room-frames-staged"):
        p = subprocess.run([sys.executable, "-c", SCRIPT.format(
            root=str(ROOT), cell=cell)], capture_output=True, text=True,
            timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        tops = eval(p.stdout.splitlines()[-2])
        assert "pointnerf2studio_torch" in tops
        assert p.stdout.splitlines()[-1] == "[]"
        assert not {"jax", "jaxlib", "flax", "pointnerf2studio_tpu"} & set(
            tops)


def test_the_reference_loads_nothing_of_the_program():
    p = subprocess.run([sys.executable, "-c", (
        f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
        "import perfbench.reference.pointnerf, perfbench.core.counts, "
        "perfbench.core.scenes, perfbench.core.inputs; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))")],
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(eval(p.stdout.splitlines()[-1]))
    assert not {"pointnerf2studio_torch", "pointnerf2studio_tpu", "jax",
                "jaxlib", "flax"} & tops
