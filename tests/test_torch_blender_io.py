"""The port's dataset readers against the JAX reference's on the CPU:
`load_blender` (factor with LANCZOS, max_views, RGBA, RGB-only and grey
frames, a file_path with and without its extension), the "blender" kind
of `load_scene`, and the PFM reader and writer (utils/pfm.py). Both
packages run the same numpy code on the same files, so everything is
held bit for bit."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from pointnerf2studio_torch.data import blender as tbl
from pointnerf2studio_torch.data import scenes as tsc
from pointnerf2studio_torch.utils import pfm as tpfm
from pointnerf2studio_tpu.data import blender as jbl
from pointnerf2studio_tpu.data import scenes as jsc
from pointnerf2studio_tpu.utils import pfm as jpfm

torch.set_num_threads(1)

HW = 12
FIELDS = ("images", "poses", "intrinsics", "alphas")


def write_scene(root, mode: str, ext_in_path: bool = False, n: int = 3,
                seed: int = 0):
    """A NeRF-Synthetic directory of `n` random frames of PIL `mode`
    ("RGBA", "RGB" or "L") in a train split."""
    rng = np.random.default_rng(seed)
    (root / "train").mkdir(parents=True)
    ch = {"RGBA": 4, "RGB": 3, "L": 1}[mode]
    frames = []
    for k in range(n):
        img = rng.integers(0, 256, (HW, HW, ch), dtype=np.uint8)
        Image.fromarray(img[..., 0] if ch == 1 else img, mode).save(
            root / "train" / f"r_{k}.png")
        c2w = np.eye(4)
        c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        c2w[:3, 3] = rng.normal(size=3) * 3
        frames.append({"file_path": f"./train/r_{k}"
                       + (".png" if ext_in_path else ""),
                       "transform_matrix": c2w.tolist()})
    (root / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.69, "frames": frames}))
    return str(root)


def assert_same(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
        else:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.near, got.far, got.split) == (want.near, want.far,
                                              want.split)


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L"])
@pytest.mark.parametrize("ext_in_path", [False, True])
def test_load_blender_matches_jax(tmp_path, mode, ext_in_path):
    root = write_scene(tmp_path / "s", mode, ext_in_path)
    got = tbl.load_blender(root, "train")
    assert_same(got, jbl.load_blender(root, "train"))
    assert got.images.shape == (3, HW, HW, 3)
    assert (got.alphas is None) == (mode != "RGBA")
    np.testing.assert_array_equal(tbl.BLENDER2OPENCV, jbl.BLENDER2OPENCV)


@pytest.mark.parametrize("factor", [2, 3])
def test_load_blender_factor_and_max_views(tmp_path, factor):
    root = write_scene(tmp_path / "s", "RGBA", n=4)
    kw = dict(factor=factor, max_views=2, bg_color=(0.2, 0.4, 0.6))
    got = tbl.load_blender(root, "train", **kw)
    assert_same(got, jbl.load_blender(root, "train", **kw))
    assert got.num_views == 2 and got.hw == (HW // factor, HW // factor)
    assert got.intrinsics[0, 2] == (HW // factor) / 2.0


def test_load_blender_composites_on_white(tmp_path):
    """A transparent pixel reads as the background, an opaque one as its
    colour, and the pose is the transform times BLENDER2OPENCV."""
    root = write_scene(tmp_path / "s", "RGBA", n=1)
    img = np.zeros((HW, HW, 4), np.uint8)
    img[0, 0] = (255, 0, 0, 255)
    Image.fromarray(img, "RGBA").save(tmp_path / "s" / "train" / "r_0.png")
    ds = tbl.load_blender(root, "train")
    np.testing.assert_array_equal(ds.images[0, 0, 0], [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(ds.images[0, 5, 5], [1.0, 1.0, 1.0])
    meta = json.loads((tmp_path / "s" / "transforms_train.json").read_text())
    np.testing.assert_array_equal(
        ds.poses[0], np.asarray(meta["frames"][0]["transform_matrix"],
                                np.float32) @ tbl.BLENDER2OPENCV)


def test_load_scene_blender(tmp_path):
    root = write_scene(tmp_path / "s", "RGBA")
    got = tsc.load_scene("blender", root, split="train", max_views=2)
    assert_same(got, jsc.load_scene("blender", root, split="train",
                                    max_views=2))
    assert_same(tsc.load_scene("nerf_synth360", root),
                jbl.load_blender(root))


@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3)])
def test_pfm_round_trip_and_jax_reader(tmp_path, shape):
    img = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    path = str(tmp_path / "d.pfm")
    tpfm.write_pfm(path, img)
    np.testing.assert_array_equal(tpfm.read_pfm(path), img)
    np.testing.assert_array_equal(jpfm.read_pfm(path), img)
    jpath = str(tmp_path / "j.pfm")
    jpfm.write_pfm(jpath, img)
    assert open(jpath, "rb").read() == open(path, "rb").read()


def test_pfm_big_endian_and_errors(tmp_path):
    """A big-endian file with a scale (the MVSNet writers' form) reads
    as the reference reads it; a bad header and a bad shape raise."""
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    path = tmp_path / "be.pfm"
    path.write_bytes(b"Pf\n4 3\n2.0\n" + img[::-1].astype(">f4").tobytes())
    np.testing.assert_array_equal(tpfm.read_pfm(str(path)),
                                  jpfm.read_pfm(str(path)))
    np.testing.assert_array_equal(tpfm.read_pfm(str(path)), img * 2)
    bad = tmp_path / "bad.pfm"
    bad.write_bytes(b"P6\n1 1\n-1\n")
    with pytest.raises(ValueError, match="not a PFM"):
        tpfm.read_pfm(str(bad))
    with pytest.raises(ValueError, match="PFM wants"):
        tpfm.write_pfm(str(tmp_path / "x.pfm"), np.zeros((2, 2, 2)))
