"""The benchmark's plain reference against the program's plain versions on
the CPU, at the tiny sizes of `tiny.py`: a frame's colour, acc, depth and
ray_mask, and one train step's loss, gradients and Adam update."""

import copy

import numpy as np
import pytest
import torch

from perfbench.kinds import frames as fk
from perfbench.kinds import train as tk
from perfbench.reference import pointnerf as ref
from perfbench.tests.tiny import tiny_spec

CPU = torch.device("cpu")


def _f32(spec):
    spec = copy.deepcopy(spec)
    spec.config["agg"].update(compute_dtype="float32", pe_mode="direct",
                              fused_decode2=False)
    return spec


def _frame_outputs(spec, seed, n=2):
    cell = fk.Frames(spec, seed, CPU)
    cell.build()
    kept = [(i, cell.frame(i)) for i in range(n)]
    return cell, kept


def test_frame_xla_route_float32_matches_reference():
    """At float32 the program's XLA route (decode_radiance) and the
    reference agree to round-off: same ray_mask, colour, acc, depth."""
    spec = _f32(tiny_spec("room-frames-staged"))
    spec.config["query"]["chunk_mode"] = "xla"
    cell, kept = _frame_outputs(spec, 3)
    got = cell.compare(kept)
    assert got["mask_mismatch"] == 0.0
    assert got["color_mae"] < 2e-5
    assert got["acc_mae"] < 2e-5
    assert got["depth_rel_mae"] < 2e-5


@pytest.mark.parametrize("cell_name", ["room-frames-staged"])
def test_frame_staged_route_bf16_within_bf16_rounding(cell_name):
    """The cell's own route (selection #2, tower #4 in bf16) within
    bfloat16 rounding of the reference."""
    cell, kept = _frame_outputs(tiny_spec(cell_name), 4)
    got = cell.compare(kept)
    assert got["mask_mismatch"] == 0.0
    assert got["color_mae"] < 5e-3
    assert got["acc_mae"] < 5e-3


def test_frame_reference_outputs_shape_and_background():
    spec = tiny_spec("room-frames-staged")
    cell = fk.Frames(spec, 5, CPU)
    grid = cell.reference_grid()
    p = cell.poses[0]
    rd = torch.as_tensor(cell.rays[0])
    bg = torch.ones(3)
    r = ref.render_rays(cell.weights, cell.cloud, grid,
                        torch.as_tensor(p[:3, 3]), torch.as_tensor(p[:3, :3]),
                        rd, cell.near, cell.far, spec.config, bg)
    n = rd.shape[0]
    assert r["color"].shape == (n, 3) and r["acc"].shape == (n,)
    assert bool(r["ray_mask"].any())
    miss = ~r["ray_mask"]
    assert torch.equal(r["color"][miss], bg.expand(int(miss.sum()), 3))
    assert r["n_slots"] > 0 and r["n_rows"] >= r["n_found"] > 0
    c = ref.render_rays(cell.weights, cell.cloud, grid,
                        torch.as_tensor(p[:3, 3]), torch.as_tensor(p[:3, :3]),
                        rd, cell.near, cell.far, spec.config, bg,
                        count_only=True)
    assert (c["n_slots"], c["n_rows"], c["n_found"]) == (
        r["n_slots"], r["n_rows"], r["n_found"])


def test_train_step_float32_matches_reference():
    """One legacy train step at float32: the loss, every leaf's gradient
    and every leaf after the Adam update, program against reference (an
    update within 1% of the points' learning rate: where a gradient is near Adam's eps, its
    step m / (sqrt(v) + eps) follows the gradient's round-off)."""
    spec = _f32(tiny_spec("chair-train"))
    cell = tk.Train(spec, 9, CPU)
    cell.build()
    leaves = cell.leaves()
    start = {k: v.detach().clone() for k, v in leaves.items()}
    aux = cell.step(keep=True)
    grads = {k: v.grad.detach().clone() for k, v in leaves.items()}
    after = {k: v.detach().clone() for k, v in cell.leaves().items()}
    want = cell.reference()
    assert abs(float(aux["total"]) - want["loss"][0]) <= 1e-5 * abs(
        want["loss"][0])
    scale = max(float(g.abs().max()) for g in want["grad1"].values())
    for k, g in want["grad1"].items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(),
                                   rtol=1e-3, atol=1e-5 * scale, err_msg=k)
        np.testing.assert_allclose((after[k] - start[k]).numpy(),
                                   want["change"][k].numpy(), rtol=1e-3,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("dtype,most", [("float32", 1e-3), ("bfloat16", 0.02)])
def test_train_gaps_of_program_small(dtype, most):
    """The cell's own step (its float32 tower, and the same in bfloat16)
    against the float32 reference over the check's three steps: every
    compared number under `most`."""
    spec = tiny_spec("chair-train")
    spec.config["agg"]["compute_dtype"] = dtype
    cell = tk.Train(spec, 10, CPU)
    cell.build()
    got = cell.first_steps(3)
    cell.free()
    g = tk.gaps(got, cell.reference())
    assert all(v < most for v in g.values()), g
