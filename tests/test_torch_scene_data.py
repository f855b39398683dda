"""The port's scene data path (data/presets.py, data/pointcloud_init.py,
data/scenes.py) against the JAX reference's, the counterparts of
tests/test_presets.py, tests/test_pointcloud_init.py and
tests/test_scene_loaders.py, on the CPU and on tiny folders written to
tmp_path. Everything is exact but the random features and point noise
of `init_cloud_from_points`: the reference draws them with jax.random,
the port with a torch.Generator, so those are held by shape, range,
moments (within 0.05 of the distribution's) and reproducibility of a
seed."""

import dataclasses

import numpy as np
import pytest
import torch

from pointnerf2studio_torch.data import pointcloud_init as tpi
from pointnerf2studio_torch.data import presets as tpre
from pointnerf2studio_torch.data import scenes as tsc
from pointnerf2studio_tpu.data import pointcloud_init as jpi
from pointnerf2studio_tpu.data import presets as jpre
from pointnerf2studio_tpu.data import scenes as jsc
from pointnerf2studio_tpu.models.mvsnet.pointgen import (
    voxel_downsample_closest)

torch.set_num_threads(1)

PTS = np.array([[0.1, 0.2, 0.3], [0.4, 0.5, 0.6], [-0.1, -0.2, -0.3],
                [0.9, 0.8, 0.7]], np.float32)
COL = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [128, 128, 128]],
               np.uint8)
HW = 8


@pytest.mark.parametrize("name", jpre.NERF_SYNTH_SCENES + jpre.COLMAP_SCENES
                         + jpre.SCANNET_SCENES + jpre.TT_SCENES + ("truck",))
def test_presets_equal(name):
    want = dataclasses.asdict(jpre.get_preset(name))
    assert dataclasses.asdict(tpre.get_preset(name)) == want
    assert tpre.get_preset(name).query.K == 8


def test_preset_overrides_and_unknown():
    a = dataclasses.asdict(tpre.scannet_config(bgmodel="plane"))
    assert a == dataclasses.asdict(jpre.scannet_config(bgmodel="plane"))
    assert a["query"]["vsize"] == (0.008,) * 3 and a["bgmodel"] == "plane"
    with pytest.raises(KeyError, match="unknown scene preset"):
        tpre.get_preset("nowhere")


def write_ply(path, binary):
    with open(path, "wb") as f:
        f.write(b"ply\nformat " + (b"binary_little_endian" if binary
                                   else b"ascii") + b" 1.0\n")
        f.write(b"element vertex 4\n")
        for p in "xyz":
            f.write(f"property float {p}\n".encode())
        for c in ("red", "green", "blue"):
            f.write(f"property uchar {c}\n".encode())
        f.write(b"element face 0\nproperty list uchar int vertex_index\n")
        f.write(b"end_header\n")
        if binary:
            dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                           ("red", "u1"), ("green", "u1"), ("blue", "u1")])
            rec = np.zeros(4, dt)
            rec["x"], rec["y"], rec["z"] = PTS.T
            rec["red"], rec["green"], rec["blue"] = COL.T
            f.write(rec.tobytes())
        else:
            for p, c in zip(PTS, COL):
                f.write((" ".join(f"{v:.6f}" for v in p) + " "
                         + " ".join(str(int(v)) for v in c) + "\n").encode())


@pytest.mark.parametrize("binary", [False, True])
def test_load_ply_equal(tmp_path, binary):
    path = str(tmp_path / "cloud.ply")
    write_ply(path, binary)
    want, got = jpi.load_ply(path), tpi.load_ply(path)
    for k in ("xyz", "color"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["xyz"], PTS, atol=1e-5)
    (tmp_path / "bad.ply").write_bytes(b"obj\n")
    with pytest.raises(ValueError, match="not a PLY"):
        tpi.load_ply(str(tmp_path / "bad.ply"))


def test_init_points_from_depth_equal():
    rng = np.random.default_rng(0)
    K = np.array([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]], np.float32)
    depths = rng.uniform(0.5, 3.0, (3, HW, HW)).astype(np.float32)
    depths[0, 0, 0] = 0.0
    depths[1, 2, 3] = 12.0                      # past max_depth
    depths[2] = 0.0                             # a view with no depth
    poses = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses[1, :3, 3] = (0.5, -0.2, 1.0)
    imgs = rng.random((3, HW, HW, 3)).astype(np.float32)
    for stride, images in ((1, imgs), (2, None)):
        want = jpi.init_points_from_depth(depths, poses, K, images=images,
                                          stride=stride)
        got = tpi.init_points_from_depth(depths, poses, K, images=images,
                                         stride=stride)
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if images is not None:
            np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape[0] > 0


def test_voxel_downsample_closest_equal():
    xyz = np.random.default_rng(1).normal(size=(3000, 3)).astype(np.float32)
    for res in (4, 16):
        want = voxel_downsample_closest(xyz, res)
        got = tpi.voxel_downsample_closest(xyz, res)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_init_cloud_deterministic_parts_equal():
    """Everything but the random draws equals the reference's cloud:
    the crop, the downsample, positions, conf, directions, colours and
    the alive mask; the deterministic feature inits too."""
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    col = rng.random((2000, 3)).astype(np.float32)
    kw = dict(vox_res=24, ranges=(-0.8, -0.8, -0.8, 0.8, 0.8, 0.8),
              capacity=2048, default_conf=0.4)
    for method in ("zeros", "ones", "rand"):
        want = jpi.init_cloud_from_points(xyz, col, feat_dim=16,
                                          feature_init_method=method, **kw)
        got = tpi.init_cloud_from_points(xyz, col, feat_dim=16,
                                         feature_init_method=method,
                                         device="cpu", **kw)
        for f in ("xyz", "points_conf", "points_dir", "points_color",
                  "alive"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        if method != "rand":
            np.testing.assert_array_equal(got.points_embeding.numpy(),
                                          np.asarray(want.points_embeding))
    n = int(got.alive.sum())
    assert 0 < n < 2000 and got.capacity == 2048
    pts = tpi.init_cloud_from_points(PTS, None, feat_dim=8, device="cpu")
    np.testing.assert_array_equal(pts.points_color.numpy(), 0.5)


def test_init_cloud_random_parts():
    """The random features and noise: shapes, ranges and moments of their
    distributions, the same cloud from the same seed, another from
    another seed."""
    xyz = np.random.default_rng(3).uniform(-1, 1, (4000, 3)).astype(
        np.float32)

    def emb(method, seed=0):
        return tpi.init_cloud_from_points(
            xyz, None, feat_dim=16, feature_init_method=method, seed=seed,
            device="cpu").points_embeding.numpy()

    e = emb("rand")
    assert e.shape == (4000, 16) and e.min() >= -0.5 and e.max() < 0.5
    assert abs(e.mean()) < 0.05 and abs(e.var() - 1 / 12) < 0.05
    np.testing.assert_array_equal(e, emb("rand"))
    assert not np.array_equal(e, emb("rand", seed=1))
    g = emb("gau_0.2")
    assert abs(g.mean()) < 0.05 and abs(g.std() - 0.2) < 0.05
    p = emb("pos")
    want_pos = np.asarray(__import__(
        "pointnerf2studio_tpu.ops.encoding", fromlist=["x"]
    ).positional_encoding(xyz, 16 // 6))
    np.testing.assert_allclose(p[:, :want_pos.shape[1]], want_pos, atol=1e-6)
    for mode, n_out in (("pointgaussian_0.01", 4000),
                        ("pointuniform_0.01", 4000),
                        ("pointuniformadd_0.01", 8000),
                        ("pointuniformdouble_0.01", 8000)):
        c = tpi.init_cloud_from_points(xyz, None, feat_dim=4,
                                       point_noise=mode, device="cpu")
        got = c.xyz.numpy()
        ref = jpi.init_cloud_from_points(xyz, None, feat_dim=4,
                                         point_noise=mode)
        assert got.shape == np.asarray(ref.xyz).shape == (n_out, 3)
        d = got - np.concatenate([xyz] * (n_out // 4000))
        assert 0 < np.abs(d).max() <= (0.01 if "uniform" in mode else 0.1)
        if mode.startswith("pointuniformadd"):
            np.testing.assert_array_equal(got[:4000], xyz)


def write_png(path, value):
    from PIL import Image
    Image.fromarray(np.full((HW, HW, 3), int(value * 255),
                            np.uint8)).save(path)


def pose(i):
    p = np.eye(4, dtype=np.float32)
    p[0, 3] = float(i)
    return p


def _equal(a, b):
    for f in ("images", "poses", "intrinsics"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.near, a.far, a.split) == (b.near, b.far, b.split)


def test_scannet_loader_equal(tmp_path):
    exp = tmp_path / "exported"
    for d in ("color", "pose", "intrinsic"):
        (exp / d).mkdir(parents=True)
    np.savetxt(exp / "intrinsic" / "intrinsic_color.txt",
               np.diag([10.0, 10.0, 1.0, 1.0]))
    for i in range(12):
        write_png(exp / "color" / f"{i}.jpg", i / 12)
        np.savetxt(exp / "pose" / f"{i}.txt", pose(i))
    np.savetxt(exp / "pose" / "5.txt", np.full((4, 4), np.inf))
    for split in ("train", "test"):
        kw = dict(split=split, test_every=4, factor=2, step=1)
        _equal(tsc.load_scannet(str(tmp_path), **kw),
               jsc.load_scannet(str(tmp_path), **kw))
    assert tsc.load_scannet(str(tmp_path), "train", test_every=4
                            ).num_views == 8


def test_nsvf_and_dtu_loaders_equal(tmp_path):
    nsvf = tmp_path / "nsvf"
    (nsvf / "rgb").mkdir(parents=True)
    (nsvf / "pose").mkdir()
    np.savetxt(nsvf / "intrinsics.txt", np.array(
        [[12.0, 0, 4, 0], [0, 12.0, 4, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    for s, n in (("0", 4), ("2", 2)):
        for i in range(n):
            write_png(nsvf / "rgb" / f"{s}_{i:04d}.png", 0.5)
            np.savetxt(nsvf / "pose" / f"{s}_{i:04d}.txt", pose(i))
    for split in ("train", "test"):
        _equal(tsc.load_nsvf(str(nsvf), split),
               jsc.load_nsvf(str(nsvf), split))
    _equal(tsc.load_scene("tt", str(nsvf), split="train", max_views=3),
           jsc.load_scene("tt", str(nsvf), split="train", max_views=3))
    cams = tmp_path / "dtu" / "Cameras" / "train"
    cams.mkdir(parents=True)
    rect = tmp_path / "dtu" / "Rectified" / "scan1_train"
    rect.mkdir(parents=True)
    for i in range(6):
        w2c = np.eye(4)
        w2c[2, 3] = -float(i)
        K = np.diag([20.0, 20.0, 1.0])
        K[0, 2] = K[1, 2] = 4.0
        lines = (["extrinsic"] + [" ".join(map(str, r)) for r in w2c]
                 + ["", "intrinsic"] + [" ".join(map(str, r)) for r in K]
                 + ["", "425.0 2.5"])
        (cams / f"{i:08d}_cam.txt").write_text("\n".join(lines))
        write_png(rect / f"rect_{i + 1:03d}_3_r5000.png", 0.25)
    for split in ("train", "test"):
        kw = dict(scan="scan1", split=split, test_views=(2,))
        _equal(tsc.load_dtu(str(tmp_path / "dtu"), **kw),
               jsc.load_dtu(str(tmp_path / "dtu"), **kw))
    with pytest.raises(KeyError, match="unknown dataset kind"):
        tsc.load_scene("llff", str(nsvf))
    with pytest.raises(NotImplementedError, match="item 10"):
        tsc.load_scene("blender", str(nsvf))
