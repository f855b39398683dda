"""The benchmark's frozen copies equal their originals as they were when
copied: the scene makers, the poses and rays, the peaks and the
operation counts."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.core import counts, harness, scenes

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from pointnerf2studio_torch.config import (  # noqa: E402
    AggregatorConfig, PointNerfConfig, QueryConfig)
from pointnerf2studio_torch.data import synthetic  # noqa: E402
from pointnerf2studio_torch.utils import flops  # noqa: E402


def test_chair_points_equal_make_chair_scene():
    cfg = PointNerfConfig(query=QueryConfig(vsize=(0.004,) * 3,
                                            vscale=(2, 2, 2)))
    sc = synthetic.make_chair_scene(3000, seed=21, cfg=cfg, device="cpu")
    got = scenes.chair_points(3000, 21, 0.008, 0.5, "cpu")
    c = sc.cloud
    for mine, theirs in (("xyz", c.xyz), ("emb", c.points_embeding),
                         ("conf", c.points_conf), ("dir", c.points_dir),
                         ("color", c.points_color)):
        np.testing.assert_array_equal(got[mine], theirs.numpy(), mine)


@pytest.mark.parametrize("n,seed", [(20_000, 0), (5_000, 2 ** 31 + 7)])
def test_room_cloud_equals_make_room_cloud(n, seed):
    got = scenes.room_cloud(n, seed)
    want = chip_smoke.make_room_cloud(n, seed)
    for k, w in zip(("xyz", "emb", "conf", "dir", "color"), want):
        np.testing.assert_array_equal(got[k], w, k)


@pytest.mark.parametrize("az", [0.0, 30.0, 123.4, 301.0])
def test_poses_equal_originals(az):
    np.testing.assert_array_equal(scenes.room_pose(az),
                                  chip_smoke.room_pose(az))
    np.testing.assert_array_equal(scenes.ring_pose(az, 30.0),
                                  chip_smoke.orbit_pose(az))


def test_camera_rays_equal_original():
    rot = scenes.ring_pose(40.0)[:3, :3]
    got = scenes.camera_rays(rot, 12, 16, 20.0)
    want = synthetic.camera_rays(torch.as_tensor(rot), 12, 16, 20.0)
    np.testing.assert_array_equal(got, want.numpy())


def test_peaks_and_counts_equal_chip_smoke():
    assert (counts.PEAK_BYTES, counts.PEAK_FLOPS) == (
        chip_smoke.PEAK_BYTES, chip_smoke.PEAK_FLOPS)
    assert (counts.ROW_MACS, counts.SLOT_MACS) == (
        chip_smoke.ROW_MACS, chip_smoke.SLOT_MACS)
    for args in ((32, 6, 256, 3, 5), (16, 3, 128, 2, 4), (32, 6, 512, 4, 6)):
        assert counts.tower_macs(*args) == chip_smoke.tower_macs(*args)
    for args in ((256, 128, 3, 4), (512, 256, 4, 5)):
        assert counts.colour_macs(*args) == chip_smoke.colour_macs(*args)
    for nb, fl in ((1e9, 1e12), (5e9, 1e9), (0.0, 0.0)):
        s, what = counts.bound(nb, fl)
        ms, what_ms = chip_smoke.bound(nb, fl)
        assert what == what_ms and s * 1e3 == pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("cell", ["chair-train", "room-frames-staged"])
def test_flops_equal_utils_flops(cell):
    agg = harness.load(cell).config["agg"]
    cfg = PointNerfConfig(agg=AggregatorConfig(
        hidden_size=agg["hidden_size"],
        hidden_size_color=agg["hidden_size_color"]))
    per_krow, per_slot = flops.decode_matmul_flops(cfg)
    assert counts.row_flops(agg) == per_krow
    assert counts.slot_flops(agg) == per_slot
