"""The port's joint MVS step (`train/joint.py::make_joint_train_step`, as
the benchmark's cell `chair-mvs-joint` drives it) against the
benchmark's plain PyTorch reference (`perfbench/reference/mvs.py`) on the
CPU, at the cell's tiny cut (`perfbench/tiny/nerf-synth-chair-mvs.json`:
3 views of 32x32, 16 planes, 64 rays, 2 steps), on seeded random weights.

Both compute the same float32 step by different code (the port's
four-tap sampler and batched layers, the reference's `F.grid_sample`
and upstream's layer order), so each comparison allows rounding and no
more:

- positions within 1e-5 of the scene's extent (float32 depths of about
  4, through a U-Net without ReLU and a softmax over the planes);
- the gate and in-bounds mask equal off the pixel grid's outermost ring
  (whose flag rounding decides; the reference takes the program's flags
  there, departure 4 of its docstring);
- each step's loss within 1e-5 relative;
- each group's first gradient (FeatureNet, premlp, CostRegNet, ProbNet,
  the tower) within 1e-4 of its norm (sums in other orders through two
  backward passes);
- the change after the steps, by the benchmark's worst moving leaf,
  within 1e-3 (Adam's second update divides each element's second
  gradient by the root of its two squares, so an element whose two
  gradients nearly cancel carries their rounding into the change: 2e-4
  read on a BatchNorm bias of CostRegNet).

A fault planted in the port (the planes one step off, or the features
sampled without `align_corners`) must fail the comparison."""

import pytest
import torch

from perfbench.kinds import joint as kj
from perfbench.tests.tiny import tiny_spec
from pointnerf2studio_torch.train import joint as tj

torch.set_num_threads(1)

CPU = torch.device("cpu")
GROUPS = ("mvs.FeatureNet.", "mvs.premlp.", "mvs.costvol.costreg.",
          "mvs.costvol.probnet.", "fields.")


@pytest.fixture(scope="module")
def spec():
    return tiny_spec("chair-mvs-joint")


def run(spec, seed):
    cell = kj.Joint(spec, seed, CPU)
    cell.build()
    got = cell.first_steps(spec.traffic["check_steps"])
    cell.free()
    return got, cell.reference(ring_valid=got["valid"])


def group_gaps(got, want):
    """Each group's relative gap of its first gradient (norm of the
    difference over the norm of the reference's)."""
    out = {}
    for g in GROUPS:
        keys = [k for k in want["grad1"] if k.startswith(g)]
        d = sum(float((got["grad1"][k] - want["grad1"][k]).norm() ** 2)
                for k in keys)
        n = sum(float(want["grad1"][k].norm() ** 2) for k in keys)
        assert n > 0, g
        out[g] = (d / n) ** 0.5
    return out


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_the_joint_step_matches_the_reference(spec, seed):
    got, want = run(spec, seed)
    extent = kj.scene_extent(spec.config)
    assert float((got["xyz"] - want["xyz"]).abs().max()) <= 1e-5 * extent
    ring = want["ring"]
    for g, w in zip(got["valid"], want["valid_own"]):
        assert torch.equal(g[~ring], w[~ring])
        assert int(g.sum()) > 32
    for a, b in zip(got["loss"], want["loss"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert min(want["found"]) > 16          # rays hit the generated cloud
    for g, gap in group_gaps(got, want).items():
        assert gap <= 1e-4, (g, gap)
    assert kj.gaps(got, want)["change_gap"] <= 1e-3


def _planes_one_off(monkeypatch):
    real = tj.depth_values_linear
    monkeypatch.setattr(tj, "depth_values_linear",
                        lambda near, far, n, dev: real(near, far, n + 1,
                                                       dev)[1:])


def _corners_off(monkeypatch):
    real = tj.bilinear_grid_sample
    monkeypatch.setattr(tj, "bilinear_grid_sample",
                        lambda img, grid, align_corners=False:
                        real(img, grid, align_corners=False))


@pytest.mark.parametrize("fault", [_planes_one_off, _corners_off],
                         ids=["planes_one_off", "features_corners_off"])
def test_a_planted_fault_fails_the_comparison(spec, monkeypatch, fault):
    fault(monkeypatch)
    got, want = run(spec, 3)
    g = kj.joint_gaps(got, want, kj.scene_extent(spec.config))
    worst = max(g["xyz_gap"] / 1e-5, g["loss_gap"] / 1e-5,
                max(group_gaps(got, want).values()) / 1e-4)
    assert worst > 10, g
