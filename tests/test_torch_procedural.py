"""The port's procedural chair dataset (data/procedural.py) against the
JAX reference's on the CPU: `render_view` (styles v1 and v2, ss 1 and 2)
and `render_depth` on the same cameras, `spherical_c2w_gl` bit for bit,
and `generate_chair_dataset` written by each package and read back by
the port's `load_blender`.

Tolerances: the reference runs its sphere tracer jitted on XLA:CPU,
which contracts `origin + dirs * t` into a fused multiply-add; the port
rounds product and sum apart. A ray's walk can so differ in its last
bits, and where a distance sits at the hit threshold the two walks stop
a step apart (up to 1e-3 in t) or one misses. So the hit masks must
agree on at least 99.5% of a view's rays, and so must the walks: a ray's
walks agree where both packages' depths along it are within 1e-4 (or
both miss), counted and printed. Depth is then within 1e-4 on at least
99.5% of the rays both hit and within 2e-3 (two steps) on all of them;
colour within 2e-4 on every pixel whose rays' walks all agree (a float32
sphere trace of some 100 steps, the texture's sines and the specular
power 24 over a few ulps of the hit point). A pixel of an ss=2 view
averages four rays: its coverage must agree on 99.5% of the pixels. PNG
files store 8 bits, so images of the two writers agree within 1/255."""

import json
import os

import numpy as np
import pytest
import torch

from pointnerf2studio_torch.data import blender as tbl
from pointnerf2studio_torch.data import procedural as tp
from pointnerf2studio_tpu.data import blender as jbl
from pointnerf2studio_tpu.data import procedural as jp

torch.set_num_threads(1)

W = 24
FOCAL = 0.5 * W / np.tan(0.5 * jp.CAMERA_ANGLE_X)
# (theta, phi): a train-like view, the test ring's, a low grazing one
CAMERAS = [(0.7, 0.5), (-np.pi / 2, np.deg2rad(30.0)), (2.5, 0.1)]


def traced_depths(c2w, ss):
    """Both packages' depth along every traced ray of a view (at the
    supersampled resolution: the rays render_view traces)."""
    hw, f = (W * ss, W * ss), FOCAL * ss
    return (tp.render_depth(c2w, hw, f, device="cpu"),
            jp.render_depth(c2w, hw, f))


def walks_agree(got, want):
    """Rays whose two walks end together: both miss, or both hit with
    depths within 1e-4."""
    hit_g, hit_w = got > 0, want > 0
    return (~hit_g & ~hit_w) | (hit_g & hit_w & (np.abs(got - want)
                                                  <= 1e-4))


@pytest.mark.parametrize("style", ["v1", "v2"])
@pytest.mark.parametrize("ss", [1, 2])
def test_render_view_matches_jax(style, ss):
    for theta, phi in CAMERAS:
        c2w = jp.spherical_c2w_gl(theta, phi)
        want = jp.render_view(c2w, (W, W), FOCAL, style=style, ss=ss)
        got = tp.render_view(c2w, (W, W), FOCAL, style=style, ss=ss,
                             device="cpu")
        assert got.shape == want.shape == (W, W, 4)
        assert got.dtype == np.float32
        same_cov = got[..., 3] == want[..., 3]
        agree = walks_agree(*traced_depths(c2w, ss))
        agree_px = agree.reshape(W, ss, W, ss).all((1, 3))
        print(f"{style} ss {ss} camera {theta:.2f}/{phi:.2f}: "
              f"{int((~same_cov).sum())} of {W * W} pixels differ in "
              f"coverage; the walks of {int((~agree).sum())} of "
              f"{agree.size} rays end apart")
        assert (~same_cov).sum() <= 0.005 * W * W
        assert (~agree).sum() <= 0.005 * agree.size
        both = agree_px & same_cov & (got[..., 3] > 0)
        assert both.sum() > 0.1 * W * W
        np.testing.assert_allclose(got[both], want[both], rtol=0, atol=2e-4)
        # a pixel no ray hits is exactly transparent black in both
        miss = (got[..., 3] == 0) & (want[..., 3] == 0)
        assert (got[miss] == 0).all() and (want[miss] == 0).all()


def test_render_depth_matches_jax():
    for theta, phi in CAMERAS:
        c2w = jp.spherical_c2w_gl(theta, phi)
        want = jp.render_depth(c2w, (W, W), FOCAL)
        got = tp.render_depth(c2w, (W, W), FOCAL, device="cpu")
        hit_w, hit_g = want > 0, got > 0
        n_diff = int((hit_w != hit_g).sum())
        both = hit_w & hit_g
        d = np.abs(got - want)[both]
        print(f"depth camera {theta:.2f}/{phi:.2f}: {n_diff} of "
              f"{hit_w.size} rays differ in their hit mask, "
              f"{int((d > 1e-4).sum())} of {d.size} both hit end apart")
        assert n_diff <= 0.005 * hit_w.size
        assert both.sum() > 0.1 * hit_w.size
        assert (d <= 1e-4).mean() >= 0.995
        assert d.max() <= 2e-3
        assert (got[~hit_g] == 0).all()
        # camera-Z depth of a chair 4 m away lies inside the chair's reach
        assert 2.0 < got[both].min() and got[both].max() < 6.5


@pytest.mark.parametrize("theta", [-np.pi, -1.0, 0.0, 0.3, 2.9])
@pytest.mark.parametrize("phi", [np.deg2rad(5), np.deg2rad(30.0), 0.9])
def test_spherical_c2w_gl_bit_for_bit(theta, phi):
    want = jp.spherical_c2w_gl(theta, phi)
    got = tp.spherical_c2w_gl(theta, phi)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_camera_schedule_is_the_reference():
    """chair_cameras draws the reference's train views and test ring."""
    cams = tp.chair_cameras(5, 3, seed=4)
    rng = np.random.default_rng(4)
    for k in range(5):
        theta = float(rng.uniform(-np.pi, np.pi))
        phi = float(rng.uniform(np.deg2rad(5), np.deg2rad(55)))
        np.testing.assert_array_equal(cams["train"][k],
                                      jp.spherical_c2w_gl(theta, phi))
    for k in range(3):
        np.testing.assert_array_equal(
            cams["test"][k], jp.spherical_c2w_gl(-np.pi + 2 * np.pi * k / 3,
                                                 np.deg2rad(30.0)))
    assert tp.chair_focal(400) == 0.5 * 400 / np.tan(0.5 * jp.CAMERA_ANGLE_X)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The same 16x16 v2 dataset (2 train views with depth, 1 test view)
    written by each package."""
    root = tmp_path_factory.mktemp("chairs")
    kw = dict(n_train=2, n_test=1, hw=(16, 16), seed=3, save_depth=True,
              style="v2", ss=2)
    jdir = jp.generate_chair_dataset(str(root / "jax"), **kw)
    tdir = tp.generate_chair_dataset(str(root / "torch"), device="cpu", **kw)
    return jdir, tdir


def test_generate_chair_dataset_layout(written):
    jdir, tdir = written
    for split, n in (("train", 2), ("test", 1)):
        with open(os.path.join(jdir, f"transforms_{split}.json")) as f:
            want = json.load(f)
        with open(os.path.join(tdir, f"transforms_{split}.json")) as f:
            got = json.load(f)
        assert got == want
        assert len(got["frames"]) == n
        for k in range(n):
            assert os.path.isfile(os.path.join(tdir, split, f"r_{k}.png"))
    for k in range(2):
        want = np.load(os.path.join(jdir, "train", f"depth_{k}.npy"))
        got = np.load(os.path.join(tdir, "train", f"depth_{k}.npy"))
        assert got.dtype == np.float32 and got.shape == (16, 16)
        both = (got > 0) & (want > 0)
        assert ((got > 0) != (want > 0)).sum() <= 0.005 * got.size
        np.testing.assert_allclose(got[both], want[both], rtol=0, atol=1e-4)
    assert not os.path.exists(os.path.join(tdir, "test", "depth_0.npy"))


@pytest.mark.parametrize("split", ["train", "test"])
def test_load_blender_reads_both_writers(written, split):
    jdir, tdir = written
    want = jbl.load_blender(jdir, split)
    got = tbl.load_blender(jdir, split)
    # the JAX-written directory: the port's loader is the reference's
    for f in ("images", "poses", "intrinsics", "alphas"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.near, got.far, got.split) == (want.near, want.far,
                                              want.split)
    mine = tbl.load_blender(tdir, split)
    np.testing.assert_array_equal(mine.poses, want.poses)
    np.testing.assert_array_equal(mine.intrinsics, want.intrinsics)
    # 8-bit frames: the two writers within one level
    assert np.abs(mine.images - want.images).max() <= 1 / 255 + 1e-7
    assert np.abs(mine.alphas - want.alphas).max() <= 1 / 255 + 1e-7
    assert mine.images.shape == (mine.num_views, 16, 16, 3)



def test_generate_without_a_card_raises(tmp_path):
    """The dataset writer, like the renderers (tests/test_torch_package.py),
    runs on the card unless given a device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.generate_chair_dataset(str(tmp_path / "d"), 1, 1, (4, 4))
    assert not os.path.exists(tmp_path / "d")
