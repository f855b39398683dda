"""The traffic kind "joint" (`perfbench/kinds/joint.py`) and its cell
`chair-mvs-joint` at the CPU tests' size: the record of a run; the
end-to-end metric and the five per-layer metrics read from it; a fault
planted in the timed path, and the control, fail the check; the tool's
readings through the kind; the operation counts against torch's own
counter at the cell's widths; no JAX in a run, nothing of the program in
the reference or the counts."""

import importlib.util
import json
import math
import subprocess
import sys
import time
import types

import pytest
import torch

from perfbench.core import harness
from perfbench.tests.tiny import tiny_spec

CPU = torch.device("cpu")
CELL = "chair-mvs-joint"
PER_LAYER = ("joint_mfu", "joint_device_ms_per_step", "costvol_roofline",
             "joint_host_ms_per_step", "device_idle_share.joint")


def _recorded_run(monkeypatch, spec, trace, hooks=None):
    """harness.run of `spec`, with the kind's record kept."""
    records = []
    real = harness.kind

    def kind(name):
        mod = real(name)

        def run(*a, **k):
            records.append(mod.run(*a, **k))
            return records[-1]
        return types.SimpleNamespace(run=run, CHECKS=mod.CHECKS)
    monkeypatch.setattr(harness, "kind", kind)
    line = harness.run(spec, 2_400_000_023, 0.3, trace, CPU,
                       time.perf_counter(), hooks=hooks)
    return line, records[0]


def test_the_cell_and_its_metrics():
    spec = harness.load(CELL)
    assert spec.traffic["kind"] == "joint"
    assert [m["name"] for m in spec.end_to_end] == ["train_rays_per_s",
                                                    "setup_s"]
    assert [m["name"] for m in spec.per_layer] == list(PER_LAYER)
    assert set(spec.limits) == set(harness.kind("joint").CHECKS)


def test_a_run_records_steps_checks_and_per_layer_metrics(monkeypatch):
    """Untraced: the record times steps, every compared number is there
    and correct, and `train_rays_per_s` is its formula. Traced: each new
    per-layer metric reads a number; `costvol_roofline` reads the device
    time inside the cost volume's device-side ranges, which a CPU trace
    has none of, and is its formula on a record that has some."""
    spec = tiny_spec(CELL)
    line, r = _recorded_run(monkeypatch, spec, False)
    assert r["loop"] == "steps" and r["steps"] == r["attempted"] >= 1
    assert r["rays"] == r["steps"] * spec.traffic["rays_per_step"]
    assert set(r["checks"]) == set(harness.kind("joint").CHECKS)
    assert line["correct"], line["checks"]
    assert line["metrics"]["train_rays_per_s"]["value"] == \
        r["rays"] / r["window_s"]

    line, r = _recorded_run(monkeypatch, spec, True)
    got = line["metrics"]
    assert set(got) == set(PER_LAYER) - {"costvol_roofline"}
    for name, m in got.items():
        assert math.isfinite(m["value"]) and m["value"] >= 0, name
    assert got["joint_mfu"]["value"] > 0
    assert got["joint_host_ms_per_step"]["value"] > 0
    assert r["trace"]["costvol_device_s"] == 0.0
    r["trace"]["costvol_device_s"] = 0.004
    roof = harness.reader("costvol_roofline")(r)
    assert roof == pytest.approx(100.0 * r["work"]["costvol_bytes"]
                                 / 3.35e12 / 0.004)


def test_a_fault_in_the_timed_path_fails_the_check(monkeypatch):
    """The cost volume's planes one step off, planted once the program is
    built: the run is not correct, by the generated positions."""
    from pointnerf2studio_torch.train import joint as tj

    def plant(cell):
        real = tj.depth_values_linear
        monkeypatch.setattr(tj, "depth_values_linear",
                            lambda near, far, n, dev: real(near, far, n + 1,
                                                           dev)[1:])
    line, _ = _recorded_run(monkeypatch, tiny_spec(CELL), False,
                            hooks={"program": plant})
    assert not line["correct"]
    c = line["checks"]["xyz_gap"]
    assert c["value"] > 10 * c["limit"]


def test_the_control_fails_the_limits():
    spec = tiny_spec(CELL)
    got = harness.kind("joint").readings(spec, 11, CPU, "control")
    assert any(not got[k] <= lim for k, lim in spec.limits.items()), got


def test_readings_tool_runs_each_mode(capsys):
    path = harness.ROOT / "perfbench" / "tools" / "readings.py"
    s = importlib.util.spec_from_file_location("perfbench_readings", path)
    tool = importlib.util.module_from_spec(s)
    s.loader.exec_module(tool)
    kind = harness.kind("joint")
    for mode in kind.MODES:
        assert tool.main(["--cpu", "--workload", CELL, "--seeds", "5",
                          "--mode", mode]) == 0
        out = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert out["mode"] == mode and set(kind.CHECKS) <= set(
            out["readings"])
    with pytest.raises(ValueError, match="joint.*no_such_mode"):
        tool.main(["--cpu", "--workload", CELL, "--seeds", "5", "--mode",
                   "no_such_mode"])


def test_counts_agree_with_torch_flop_counter():
    """`core/mvs_counts.py` at the cell's widths against torch's own
    count of the reference's FeatureNet and U-Net on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.core import mvs_counts
    from perfbench.reference import mvs

    cfg = harness.load(CELL).config
    m, cam = cfg["mvs"], cfg["camera"]
    V, H, W, D = m["num_views"], cam["height"], cam["width"], m["num_depth"]
    meta = torch.device("meta")
    p = {k: torch.empty(s, device=meta) for k, s in
         mvs.weight_shapes(V, m["premlp_layers"]).items()}
    with FlopCounterMode(display=False) as fc:
        mvs.features(p, torch.empty((1, H, W, 3), device=meta))
    assert fc.get_total_flops() == mvs_counts.fpn_flops(H, W)
    with FlopCounterMode(display=False) as fc:
        mvs.depth_probability(p, torch.empty(
            (1, 3 * V + 32, D, H // 4, W // 4), device=meta))
    assert fc.get_total_flops() == mvs_counts.costreg_flops(
        3 * V + 32, D, H // 4, W // 4)
    # the U-Net's first layer alone: 8 x 41 x 27 multiply-adds a voxel
    assert mvs_counts.costreg_flops(41, D, H // 4, W // 4) > \
        2 * 8 * 41 * 27 * D * (H // 4) * (W // 4)


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


def test_a_run_loads_no_jax_and_the_reference_none_of_the_program():
    p = subprocess.run([sys.executable, "-c", SCRIPT.format(
        root=str(harness.ROOT), cell=CELL)], capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = eval(p.stdout.splitlines()[-2])
    assert "pointnerf2studio_torch" in tops
    assert p.stdout.splitlines()[-1] == "[]"
    p = subprocess.run([sys.executable, "-c", (
        f"import sys; sys.path.insert(0, {str(harness.ROOT)!r}); "
        "import perfbench.reference.mvs, perfbench.core.mvs_counts; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))")],
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert not {"pointnerf2studio_torch", "pointnerf2studio_tpu", "jax",
                "jaxlib", "flax"} & set(eval(p.stdout.splitlines()[-1]))
