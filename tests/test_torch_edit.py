"""Scene editing in the port (pointnerf2studio_torch/edit.py) against the
JAX reference's on the CPU: `apply_rigid_transform` bit for bit (the
same numpy), `load_and_merge_parts` on the same part checkpoints bit for
bit, the render of a rotated scene from a rotated camera against the
original render (the per-point Rw2c makes the aggregator's inputs
rotation-equivariant; the reference's tests/test_editing.py bound: 95%
of the rays' masks, mean colour difference under 0.02, since the grid is
rebuilt in the rotated frame), and an edited scene training on the
legacy step while the fast step refuses it, as the reference's does."""

import dataclasses

import numpy as np
import pytest
import torch

from pointnerf2studio_torch import edit as tedit
from pointnerf2studio_torch.config import AggregatorConfig
from pointnerf2studio_torch.data.blender import BlenderDataset
from pointnerf2studio_torch.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_torch.models import neural_points as tnp
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.models.render import render_rays
from pointnerf2studio_torch.ops.grid import build_grid_from_points
from pointnerf2studio_torch.train import loop as tloop
from pointnerf2studio_torch.utils import checkpoint_io as tcio
from pointnerf2studio_tpu import edit as jedit

torch.set_num_threads(1)


def rot_z90():
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    return T


def rigid(seed):
    r = np.random.default_rng(seed)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.linalg.qr(r.normal(size=(3, 3)))[0]
    T[:3, 3] = r.normal(size=3)
    return T


@pytest.mark.parametrize("per_point", [False, True])
def test_apply_rigid_transform_matches_jax(per_point):
    r = np.random.default_rng(2)
    xyz = r.standard_normal((10, 3)).astype(np.float32)
    rw2c = (np.stack([rigid(s)[:3, :3] for s in range(10)]) if per_point
            else np.eye(3, dtype=np.float32))
    T = rigid(7)
    got = tedit.apply_rigid_transform(xyz, rw2c, T)
    want = jedit.apply_rigid_transform(xyz, rw2c, T)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert got[1].shape == (10, 3, 3)
    # the composed Rw2c undoes the rotation for every point
    v = r.standard_normal(3).astype(np.float32)
    base = rw2c if per_point else np.broadcast_to(rw2c, (10, 3, 3))
    np.testing.assert_allclose((T[:3, :3] @ v) @ got[1], v @ base,
                               rtol=0, atol=1e-5)


def make_part(n, seed):
    r = np.random.default_rng(seed)
    return tnp.from_arrays(
        r.standard_normal((n, 3)).astype(np.float32),
        r.standard_normal((n, 32)).astype(np.float32),
        r.uniform(size=(n, 1)).astype(np.float32),
        r.standard_normal((n, 3)).astype(np.float32),
        r.uniform(size=(n, 3)).astype(np.float32), device="cpu")


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    root = tmp_path_factory.mktemp("parts")
    params = Aggregator(AggregatorConfig(), seed=3, device="cpu")
    paths = [str(root / "a.pth"), str(root / "b.pth")]
    tcio.export_torch_checkpoint(params, make_part(30, 1), paths[0])
    tcio.export_torch_checkpoint(params, make_part(20, 2), paths[1])
    tf = str(root / "t.npy")
    np.save(tf, rot_z90())
    return params, paths, tf


@pytest.mark.parametrize("capacity", [None, 64])
def test_merge_parts_matches_jax(parts, capacity):
    params, paths, tf = parts
    p_t, got = tedit.load_and_merge_parts(paths, [None, tf],
                                          capacity=capacity, device="cpu")
    p_j, want = jedit.load_and_merge_parts(paths, [None, tf],
                                           capacity=capacity)
    assert got.capacity == want.capacity == (capacity or 50)
    for k in ("xyz", "points_embeding", "points_conf", "points_dir",
              "points_color", "Rw2c", "alive"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    # part a untouched (identity Rw2c), part b rotated
    np.testing.assert_array_equal(got.Rw2c[0].numpy(), np.eye(3))
    assert not torch.allclose(got.Rw2c[35], torch.eye(3))
    # the weights are the first part's
    for a, b in zip(p_t.parameters(), params.parameters()):
        assert torch.equal(a, b)
    w_j = np.asarray(p_j["mlp_head"][1]["kernel"])
    np.testing.assert_array_equal(p_t.mlp_head[1].weight.detach().numpy(),
                                  w_j.T)


def test_merge_needs_points(parts, tmp_path):
    params = parts[0]
    bare = str(tmp_path / "bare.pth")
    tcio.export_torch_checkpoint(params, None, bare)
    with pytest.raises(ValueError, match="holds no neural points"):
        tedit.load_and_merge_parts([bare], device="cpu")


@pytest.fixture(scope="module")
def sphere():
    return make_sphere_scene(n_points=3000, cfg=sphere_config(sr=16, d=48),
                             device="cpu")


def test_rotated_scene_rotated_camera_matches(sphere):
    """render(scene, cam) == render(Rz90(scene), Rz90(cam)) through the
    legacy render with the per-point Rw2c."""
    s = sphere
    T = rot_z90()
    R = torch.as_tensor(T[:3, :3])
    rays = camera_rays(s.camrotc2w, 10, 10, 12.0)
    with torch.no_grad():
        out0 = render_rays(s.params, s.cloud, s.grid, s.campos, s.camrotc2w,
                           rays, s.near, s.far, s.cfg)
    xyz_r, rw2c_r = tedit.apply_rigid_transform(
        s.cloud.xyz.numpy(), s.cloud.Rw2c.numpy(), T)
    cloud_r = dataclasses.replace(
        s.cloud, xyz=torch.as_tensor(xyz_r),
        points_dir=s.cloud.points_dir @ R.T, Rw2c=torch.as_tensor(rw2c_r))
    grid_r = build_grid_from_points(cloud_r.xyz, cloud_r.alive, s.cfg.query)
    with torch.no_grad():
        out1 = render_rays(s.params, cloud_r, grid_r, R @ s.campos,
                           R @ s.camrotc2w, rays @ R.T, s.near, s.far, s.cfg)
    m0, m1 = out0.ray_mask, out1.ray_mask
    assert (m0 == m1).float().mean() > 0.95
    both = m0 & m1
    assert both.sum() > 10
    err = (out0.coarse_raycolor[both] - out1.coarse_raycolor[both]).abs()
    assert float(err.mean()) < 0.02, float(err.mean())


def test_edited_scene_trains_on_the_legacy_step(sphere, tmp_path):
    s = sphere
    n = int(s.cloud.num_alive)
    xyz, rw2c = tedit.apply_rigid_transform(
        s.cloud.xyz.numpy()[:n], s.cloud.Rw2c.numpy(), rot_z90())
    cloud = tnp.from_arrays(xyz, *(getattr(s.cloud, k).numpy()[:n] for k in (
        "points_embeding", "points_conf", "points_dir", "points_color")),
        Rw2c=rw2c, device="cpu")
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = s.camrotc2w.numpy(), s.campos.numpy()
    ds = BlenderDataset(
        images=np.full((1, 8, 8, 3), 0.5, np.float32), poses=pose[None],
        intrinsics=np.array([[10, 0, 4], [0, 10, 4], [0, 0, 1]], np.float32),
        near=s.near, far=s.far, split="train")
    cfg = dataclasses.replace(s.cfg, train=dataclasses.replace(
        s.cfg.train, rays_per_batch=32))
    res = tloop.fit(cfg, ds, s.params, cloud, str(tmp_path / "legacy"),
                    max_steps=2, print_freq=1, device="cpu")
    assert len(res.log) == 2 and all(np.isfinite(r["total"])
                                     for r in res.log)
    assert res.state.points.Rw2c.shape == (n, 3, 3)
    fast = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, fast_path=True))
    with pytest.raises(NotImplementedError, match="per-point Rw2c"):
        tloop.fit(fast, ds, s.params, cloud, str(tmp_path / "fast"),
                  max_steps=1, device="cpu")
