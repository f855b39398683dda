"""Evaluation in the port (train/evaluator.py, utils/metrics.py) against
the JAX reference, on the CPU:

  * psnr, rmse, ssim, compute_all and metrics_over_dirs equal the
    reference's within rtol 1e-9 (both are the same float64 numpy
    arithmetic); lpips raises RuntimeError, as the reference's does with
    no weights, and compute_all leaves it out;
  * render_image and evaluate_dataset (legacy) against the reference's
    on a toy sphere scene: ray_mask exactly, the canvases within the
    bf16 colour bound (atol 2e-2, mean < 2e-3), the metrics those of the
    port's own canvas and, both re-rendering the dataset's own imagery,
    within 1e-4 SSIM and 1e-5 RMSE of the reference's;
  * the reference's fast-against-legacy recipe
    (tests/test_evaluator_fast.py) in the port: fast=True through
    render_frame on the rows route and fast=True, frame=False;
  * spherical_poses and interpolated_poses within 1e-6;
  * render_video and save_images write their files."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.data import blender as tblender
from pointnerf2studio_torch.train import evaluator as tev
from pointnerf2studio_torch.utils import metrics as tm
from pointnerf2studio_tpu.data import blender as jblender
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.train import evaluator as jev
from pointnerf2studio_tpu.utils import metrics as jm

torch.set_num_threads(1)

H = W = 24
FOCAL = 18.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(20, 23, 3))
    b = np.clip(a + rng.normal(0, 0.05 * (seed + 1), a.shape), 0, 1)
    for f in ("psnr", "rmse", "ssim"):
        np.testing.assert_allclose(getattr(tm, f)(a, b), getattr(jm, f)(a, b),
                                   rtol=1e-9)
    np.testing.assert_allclose(tm.ssim(a[..., 0], b[..., 0]),
                               jm.ssim(a[..., 0], b[..., 0]), rtol=1e-9)
    got, want = tm.compute_all(a, b), jm.compute_all(a, b)
    assert set(got) == set(want) == {"psnr", "ssim", "rmse"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9)
    assert tm.psnr(a, a) == float("inf")


def test_lpips_raises():
    with pytest.raises(RuntimeError, match="LPIPS"):
        tm.lpips(np.zeros((4, 4, 3)), np.zeros((4, 4, 3)))


def test_metrics_over_dirs_match(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(4)
    for d in ("pred", "gt"):
        (tmp_path / d).mkdir()
    for i in range(3):
        a = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        b = np.clip(a.astype(int) + rng.integers(-20, 20, a.shape), 0,
                    255).astype(np.uint8)
        Image.fromarray(a).save(tmp_path / "pred" / f"{i}.png")
        Image.fromarray(b).save(tmp_path / "gt" / f"{i}.png")
    got = tm.metrics_over_dirs(str(tmp_path / "pred"), str(tmp_path / "gt"))
    want = jm.metrics_over_dirs(str(tmp_path / "pred"), str(tmp_path / "gt"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9)
    with pytest.raises(ValueError, match="mismatched"):
        tm.metrics_over_dirs(str(tmp_path / "pred"), str(tmp_path))


@pytest.fixture(scope="module")
def setup():
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(
        cfg, query=dataclasses.replace(cfg.query, ray_slot_budget=16))
    s = make_sphere_scene(n_points=4000, cfg=cfg)
    rays = np.asarray(camera_rays(s.campos, s.camrotc2w, H, W, FOCAL))
    out = jev.render_image(jev.make_render_chunk_fn(s.cfg), s.params, s.cloud,
                           s.grid, np.asarray(s.campos),
                           np.asarray(s.camrotc2w), rays, (H, W), s.near,
                           s.far, chunk=192)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(s.camrotc2w)
    pose[:3, 3] = np.asarray(s.campos)
    arrays = dict(
        images=out["coarse_raycolor"][None].astype(np.float32),
        poses=pose[None],
        intrinsics=np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2],
                             [0, 0, 1]], np.float32),
        near=s.near, far=s.far, split="test")
    pc = tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(s.cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(s.cfg.agg)))
    return dict(
        s=s, rays=rays, want=out, pc=pc,
        jds=jblender.BlenderDataset(**arrays),
        tds=tblender.BlenderDataset(**arrays),
        params=convert.aggregator_from_jax(jax.tree.map(np.asarray, s.params),
                                           pc.agg, device="cpu"),
        cloud=convert.cloud_from_jax(s.cloud, device="cpu"),
        grid=convert.grid_from_jax(s.grid, device="cpu"))


def test_render_image_matches_jax(setup):
    s, want = setup["s"], setup["want"]
    got = tev.render_image(tev.make_render_chunk_fn(setup["pc"]),
                           setup["params"], setup["cloud"], setup["grid"],
                           np.asarray(s.campos), np.asarray(s.camrotc2w),
                           setup["rays"], (H, W), s.near, s.far, chunk=100)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["ray_mask"], np.asarray(want["ray_mask"]))
    assert 0 < got["ray_mask"].sum() < H * W
    for k in ("coarse_raycolor", "acc"):
        d = np.abs(got[k] - np.asarray(want[k]))
        assert d.max() <= 2e-2 and d.mean() < 2e-3, (k, d.max(), d.mean())


def test_evaluate_dataset_matches_jax(setup, tmp_path):
    s = setup["s"]
    want = jev.evaluate_dataset(s.cfg, s.params, s.cloud, s.grid,
                                setup["jds"], chunk=192)
    got = tev.evaluate_dataset(setup["pc"], setup["params"], setup["cloud"],
                               setup["grid"], setup["tds"], chunk=192,
                               out_dir=str(tmp_path), save_images=True)
    ds = setup["tds"]
    img = tev.render_image(tev.make_render_chunk_fn(setup["pc"]),
                           setup["params"], setup["cloud"], setup["grid"],
                           ds.campos(0), ds.camrotc2w(0),
                           ds.full_image_rays(0), (H, W), s.near, s.far,
                           chunk=192)["coarse_raycolor"]
    assert got == tm.compute_all(img, setup["tds"].images[0])
    assert set(got) == set(want)
    # both re-render the dataset's own imagery to within some 1e-7 (PSNR
    # near 150 dB, where a dB is ulp noise): held by SSIM and RMSE
    assert min(got["psnr"], want["psnr"]) > 60
    assert abs(got["ssim"] - want["ssim"]) < 1e-4
    assert abs(got["rmse"] - want["rmse"]) < 1e-5
    assert (tmp_path / "eval_000.png").exists()


def test_fast_eval_matches_legacy(setup):
    """tests/test_evaluator_fast.py's bounds, in the port."""
    a = (setup["pc"], setup["params"], setup["cloud"], setup["grid"],
         setup["tds"])
    slow = tev.evaluate_dataset(*a, chunk=192)
    fast = tev.evaluate_dataset(*a, chunk=192, fast=True)
    chunked = tev.evaluate_dataset(*a, chunk=192, fast=True, frame=False)
    assert slow["psnr"] > 40
    assert fast["psnr"] > 32, fast
    assert abs(fast["ssim"] - slow["ssim"]) < 0.05
    assert min(fast["psnr"], chunked["psnr"]) > 32
    assert abs(fast["ssim"] - chunked["ssim"]) < 1e-4
    assert abs(fast["rmse"] - chunked["rmse"]) < 1e-5


def test_unported_eval_raises(setup):
    cfg = dataclasses.replace(setup["pc"], bgmodel="plane")
    with pytest.raises(NotImplementedError, match="item 9"):
        tev.evaluate_dataset(cfg, None, None, None, setup["tds"])


@pytest.mark.parametrize("n,radius,phi", [(8, 4.0, -30.0), (5, 2.5, 10.0)])
def test_spherical_poses_match(n, radius, phi):
    np.testing.assert_allclose(tev.spherical_poses(n, radius, phi),
                               jev.spherical_poses(n, radius, phi),
                               atol=1e-6)


def test_interpolated_poses_match():
    c2ws = np.concatenate([jev.spherical_poses(4, 3.0),
                           jev.spherical_poses(2, 2.0, 20.0)])
    got = tev.interpolated_poses(c2ws, n_views=12)
    np.testing.assert_allclose(got, jev.interpolated_poses(c2ws, n_views=12),
                               atol=1e-6)
    assert got.shape == (6 * 4, 4, 4)


def test_render_video_writes_a_gif(setup, tmp_path):
    s = setup["s"]
    path = tev.render_video(
        setup["pc"], setup["params"], setup["cloud"], setup["grid"],
        np.array([[6.0, 0, 4], [0, 6.0, 4], [0, 0, 1]], np.float32), (8, 8),
        s.near, s.far, str(tmp_path / "v.gif"), n_frames=3, radius=2.0,
        chunk=64)
    import imageio
    frames = imageio.mimread(path)
    assert len(frames) == 3 and frames[0].shape[:2] == (8, 8)
    assert (np.asarray(frames[0])[..., :3] < 255).any()
