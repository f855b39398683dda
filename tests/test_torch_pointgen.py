"""The port's point generation (pointnerf2studio_torch/models/mvsnet/
pointgen.py) and view batches (data/mvs_batches.py) against the JAX
package on the CPU, on a 64x64 procedural chair with 6 train views and
their depth maps (the pattern of tests/test_pointgen_modes.py on a real
scene): the filter stages one by one, then `generate_point_cloud` in
"gt" mode (the dataset's depth) with and without `far_plane_shift`, and
in "mvsnet" mode on random reference-layout weights, each with alpha
masking and voxel downsampling.

Both packages load the same checkpoint files; JAX runs at
`jax_default_matmul_precision("highest")`. Bounds: the point count equal,
or apart by at most FLIPS points or 1% of them (a pixel whose geometric
test, `dist < 1` or `rel < 0.01`, whose alpha pixel or whose voxel sits
on a float edge); positions within
1e-5, embedding, colour, dir and conf within 1e-4 (relative to the
scale). Masks of the filter stages equal off the edge: pixels whose
reprojection error is within 1e-4 of a threshold are left out and
counted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch.data import blender as tb
from pointnerf2studio_torch.data import mvs_batches as tmb
from pointnerf2studio_torch.data import procedural as tproc
from pointnerf2studio_torch.models.mvsnet import featurenet as tf
from pointnerf2studio_torch.models.mvsnet import mvsnet as tm
from pointnerf2studio_torch.models.mvsnet import pointgen as tp
from pointnerf2studio_tpu.data import blender as jb
from pointnerf2studio_tpu.data import mvs_batches as jmb
from pointnerf2studio_tpu.models.mvsnet import featurenet as jf
from pointnerf2studio_tpu.models.mvsnet import mvsnet as jm
from pointnerf2studio_tpu.models.mvsnet import pointgen as jp

torch.set_num_threads(1)

HW = 64
N_TRAIN = 6
FLIPS = 8
RANGES = (-0.721, -0.695, -0.995, 0.658, 0.706, 1.050)


@pytest.fixture(autouse=True)
def highest():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module", autouse=True)
def jit_reference_stages():
    """The reference's generate_point_cloud calls its per-pair stage op by
    op; compiled once here, the same function at a fraction of the
    test's time."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jp, "geometric_consistency",
               jax.jit(jp.geometric_consistency))
    mp.setattr(jp, "embed_points", jax.jit(jp.embed_points))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("pointgen")
    data = tproc.generate_chair_dataset(str(root / "data"), n_train=N_TRAIN,
                                        n_test=1, hw=(HW, HW), seed=1,
                                        save_depth=True, device="cpu")
    depths = np.stack([np.load(root / "data" / "train" / f"depth_{k}.npy")
                       for k in range(N_TRAIN)])
    out = {"depths": depths,
           "mvs": tm.random_mvsnet_checkpoint(str(root / "m.ckpt"), 0),
           "fpn": tf.random_fpn_checkpoint(str(root / "f.pth"), 1)}
    for pkg, blender, mb in (("t", tb, tmb), ("j", jb, jmb)):
        ds = blender.load_blender(data, "train")
        b, a, K, E = mb.build_view_batches(ds, num_src=2)
        for i, vb in enumerate(b):
            vb.gt_depth = depths[i]
        out[pkg] = (b, a, K, E)
    out["tnets"] = (tm.load_mvsnet_params(out["mvs"], device="cpu"),
                    tf.load_fpn_params(out["fpn"], device="cpu"))
    out["jnets"] = (jm.load_mvsnet_params(out["mvs"]),
                    jf.load_fpn_params(out["fpn"]))
    return out


def close(got, want, tol, name=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if want.size else 0.0
    assert err <= tol * scale, (name, err, scale)


def same_cloud(got, want):
    """Counts within the flip bound; every point of one cloud within 1e-5
    of a point of the other but for at most that many on each side (a
    flipped point moves its voxel's centroid), and the attributes of the
    matched points within 1e-4. The bound is FLIPS or 1% of the points,
    whichever is larger: the voxel grid spans the cloud's bounding box,
    so a rounding of the extreme points moves every voxel boundary."""
    n_t, n_j = got["xyz"].shape[0], want["xyz"].shape[0]
    flips = max(FLIPS, int(np.ceil(0.01 * max(n_t, n_j))))
    assert abs(n_t - n_j) <= flips, (n_t, n_j)
    assert got["embedding"].shape[1] == 32
    d = np.linalg.norm(got["xyz"][:, None].astype(np.float64)
                       - want["xyz"][None], axis=-1)
    j = d.argmin(1)
    ok = d[np.arange(n_t), j] < 1e-5
    assert (~ok).sum() <= flips, (~ok).sum()
    assert (d.min(0) >= 1e-5).sum() <= flips
    for k in ("embedding", "color", "dir", "conf"):
        close(got[k][ok], want[k][j[ok]], 1e-4, k)
    return int((~ok).sum())


def test_view_batches_equal(scene):
    """The same triples and arrays in both packages (a copy of numpy
    code), and a cloud the stages below can filter."""
    bt, at, Kt, Et = scene["t"]
    bj, aj, Kj, Ej = scene["j"]
    assert len(bt) == len(bj) == N_TRAIN
    for x, y in zip(bt, bj):
        for k in ("images", "intrinsics", "w2cs", "c2ws"):
            assert np.array_equal(getattr(x, k), getattr(y, k)), k
        assert x.near_far == y.near_far and x.near_far_depth == \
            y.near_far_depth
    assert np.array_equal(at, aj) and np.array_equal(Kt, Kj)
    assert np.array_equal(Et, Ej)


def stage_inputs(scene, i):
    vb = scene["t"][0][i]
    return vb, (np.asarray(vb.gt_depth, np.float32),
                np.ones((HW, HW), np.float32), vb.intrinsics[0],
                vb.near_far)


def test_depth_to_cam_points(scene):
    vb, (depth, conf, K, nf) = stage_inputs(scene, 0)
    cj, mj = jp.depth_to_cam_points(jnp.asarray(depth), jnp.asarray(conf),
                                    jnp.asarray(K), nf)
    ct, mt = tp.depth_to_cam_points(torch.tensor(depth), torch.tensor(conf),
                                    torch.tensor(K), nf)
    close(ct, cj, 1e-5)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    assert 0 < int(mt.sum()) < mt.numel()


def geo_inputs(scene, i, j):
    vbs = scene["t"][0]
    return [np.asarray(x, np.float32) for x in (
        vbs[i].gt_depth, vbs[i].intrinsics[0], vbs[i].w2cs[0],
        vbs[j].gt_depth, vbs[j].intrinsics[0], vbs[j].w2cs[0])]


def test_geometric_consistency(scene):
    n_edge = 0
    for i, j in ((0, 1), (0, 2), (3, 4)):
        args = geo_inputs(scene, i, j)
        mj, dj = jax.jit(jp.geometric_consistency)(*map(jnp.asarray, args))
        mt, dt = tp.geometric_consistency(*map(torch.tensor, args))
        mj, dj = np.asarray(mj), np.asarray(dj)
        same = mj == mt.numpy()
        n_edge += int((~same).sum())
        close(dt.numpy()[same], dj[same], 1e-5)
        assert mj.sum() > 0
    assert n_edge <= FLIPS


def test_sample_depth_border():
    rng = np.random.default_rng(2)
    d = rng.uniform(1, 3, (9, 11)).astype(np.float32)
    x = rng.uniform(-2, 13, (40,)).astype(np.float32)
    y = rng.uniform(-2, 11, (40,)).astype(np.float32)
    want = jp._sample_depth_border(*map(jnp.asarray, (d, x, y)))
    got = tp._sample_depth_border(*map(torch.tensor, (d, x, y)))
    close(got, want, 1e-6)


def test_filter_view(scene):
    vbs = scene["t"][0]
    cfg_j, cfg_t = jp.PointGenConfig(), tp.PointGenConfig()
    depths = [np.asarray(v.gt_depth, np.float32) for v in vbs]
    Ks = [np.asarray(v.intrinsics[0], np.float32) for v in vbs]
    Es = [np.asarray(v.w2cs[0], np.float32) for v in vbs]
    conf = np.ones((HW, HW), np.float32)
    cam_j, mask_j = jp.depth_to_cam_points(
        jnp.asarray(depths[0]), jnp.asarray(conf), jnp.asarray(Ks[0]),
        vbs[0].near_far)
    cam_t, mask_t = tp.depth_to_cam_points(
        torch.tensor(depths[0]), torch.tensor(conf), torch.tensor(Ks[0]),
        vbs[0].near_far)
    xj, fj, _ = jp.filter_view(cam_j, jnp.asarray(conf), mask_j, 0,
                               [jnp.asarray(d) for d in depths],
                               [jnp.asarray(k) for k in Ks],
                               [jnp.asarray(e) for e in Es], cfg_j)
    xt, ft, _ = tp.filter_view(cam_t, torch.tensor(conf), mask_t, 0,
                               [torch.tensor(d) for d in depths],
                               [torch.tensor(k) for k in Ks],
                               [torch.tensor(e) for e in Es], cfg_t)
    fj, ft = np.asarray(fj), ft.numpy()
    assert (fj != ft).sum() <= FLIPS
    both = fj & ft
    assert both.sum() > 0
    close(xt.numpy()[both], np.asarray(xj)[both], 1e-5)


def test_alpha_masking(scene):
    bt, alphas, K, E = scene["t"]
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.8, 0.8, (500, 3)).astype(np.float32)
    for nf in (None, (2.0, 6.0)):
        kj = np.asarray(jp.alpha_masking(jnp.asarray(pts), alphas, K, E, nf))
        kt = tp.alpha_masking(torch.tensor(pts), alphas, K, E, nf).numpy()
        assert np.array_equal(kt, kj)
        assert 0 < kt.sum() < kt.size


def test_embed_points(scene):
    vb = scene["t"][0][0]
    _, fpn_t = scene["tnets"]
    _, fpn_j = scene["jnets"]
    rng = np.random.default_rng(4)
    cam = np.concatenate([rng.uniform(-0.6, 0.6, (80, 2)),
                          rng.uniform(3.2, 4.6, (80, 1))], -1).astype(
        np.float32)
    conf = rng.uniform(size=80).astype(np.float32)
    c2w = np.linalg.inv(vb.w2cs[0]).astype(np.float32)
    args = (cam, conf, vb.images.astype(np.float32), c2w,
            vb.intrinsics[0].astype(np.float32))
    want = jp.embed_points(fpn_j, *map(jnp.asarray, args))
    got = tp.embed_points(fpn_t, *map(torch.tensor, args))
    for k in ("embedding", "color", "dir", "conf"):
        close(got[k], want[k], 1e-4, k)


def run_both(scene, cfg_kw, n_batches=None, alpha=True):
    bt, at, Kt, Et = scene["t"]
    bj, aj, Kj, Ej = scene["j"]
    if not alpha:
        at = aj = None
    got = tp.generate_point_cloud(
        *scene["tnets"], bt[:n_batches], alphas=at, alpha_intrinsics=Kt,
        alpha_w2cs=Et, cfg=tp.PointGenConfig(**cfg_kw))
    want = jp.generate_point_cloud(
        *scene["jnets"], bj[:n_batches], alphas=aj, alpha_intrinsics=Kj,
        alpha_w2cs=Ej, cfg=jp.PointGenConfig(**cfg_kw))
    return got, want


@pytest.mark.parametrize("far_plane_shift", [None, 1.0])
def test_generate_gt_mode(scene, far_plane_shift):
    """The dataset's depth: a real cloud on the chair's surface, inside
    the alpha hull. With the background sheet (a ScanNet-style option,
    run without the hull, which would cut the sheet), the rejected pixels
    come back at far + shift."""
    kw = {"depth_mode": "gt", "vox_res": 64,
          "far_plane_shift": far_plane_shift}
    if far_plane_shift is None:
        kw["ranges"] = RANGES
    got, want = run_both(scene, kw, alpha=far_plane_shift is None,
                         n_batches=None if far_plane_shift is None else 3)
    same_cloud(got, want)
    assert got["xyz"].shape[0] > 100
    if far_plane_shift is None:
        r = np.asarray(RANGES)
        assert np.all((got["xyz"] >= r[:3] - 1e-6)
                      & (got["xyz"] <= r[3:] + 1e-6))
    else:
        assert (got["conf"] == np.float32(0.02)).any()


def test_generate_mvsnet_mode(scene):
    """Random reference-layout weights: their softmax over depth is flat,
    so at the reference's gates (confidence 0.8, the two-view vote, the
    chair's ranges, the alpha hull) no point survives; with the
    confidence, the vote and the ranges off (the hull then bounds the
    camera depth by near - 1 and far) the whole pipeline is held on a
    large cloud of one batch. (On more, the consistency averaging of
    near-constant random depths sits on its `rel < 0.01` edge for much of
    the image; the gt-mode tests hold that stage.) An empty result is the reference's (0, 3)-wide arrays,
    every key of them, and a ValueError in the port."""
    got, want = run_both(scene, {"vox_res": 320, "depth_conf_thresh": 0.0,
                                 "geo_cnsst_num": 0}, n_batches=1)
    same_cloud(got, want)
    assert got["xyz"].shape[0] > 100
    want = jp.generate_point_cloud(
        *scene["jnets"], scene["j"][0][:4], alphas=scene["j"][1],
        alpha_intrinsics=scene["j"][2], alpha_w2cs=scene["j"][3],
        cfg=jp.PointGenConfig(vox_res=320, ranges=RANGES))
    if want["xyz"].shape[0] == 0:
        assert want["embedding"].shape == (0, 3)
        with pytest.raises(ValueError, match="no point survived"):
            tp.generate_point_cloud(
                *scene["tnets"], scene["t"][0][:4], alphas=scene["t"][1],
                alpha_intrinsics=scene["t"][2], alpha_w2cs=scene["t"][3],
                cfg=tp.PointGenConfig(vox_res=320, ranges=RANGES))
    else:
        got, want = run_both(scene, {"vox_res": 320, "ranges": RANGES}, 4)
        same_cloud(got, want)


def test_gt_mode_needs_a_depth_map(scene):
    vb = scene["t"][0][0]
    bare = tp.MVSViewBatch(vb.images, vb.intrinsics, vb.w2cs, vb.c2ws,
                           vb.near_far_depth, vb.near_far)
    with pytest.raises(ValueError, match="gt_depth"):
        tp.generate_point_cloud(*scene["tnets"], [bare],
                                cfg=tp.PointGenConfig(depth_mode="gt"))


def test_stats_count_each_stage(scene):
    stats = {}
    out = tp.generate_point_cloud(
        *scene["tnets"], scene["t"][0], alphas=scene["t"][1],
        alpha_intrinsics=scene["t"][2], alpha_w2cs=scene["t"][3],
        cfg=tp.PointGenConfig(depth_mode="gt", vox_res=64), stats=stats)
    assert stats["pixels"] == N_TRAIN * HW * HW
    assert (stats["pixels"] >= stats["depth_in_range"] >= stats["filtered"]
            >= stats["alpha_kept"] >= stats["points"]
            == out["xyz"].shape[0] > 0)


def sphere_dataset(pkg, n=12):
    """n cameras on a sphere looking at the origin, tiny images."""
    rng = np.random.default_rng(5)
    poses = []
    for k in range(n):
        th, ph = rng.uniform(-np.pi, np.pi), rng.uniform(0.1, 1.2)
        poses.append(tproc.spherical_c2w_gl(th, ph) @ tb.BLENDER2OPENCV)
    imgs = rng.uniform(size=(n, 4, 4, 3)).astype(np.float32)
    K = np.array([[4.0, 0, 2], [0, 4.0, 2], [0, 0, 1]], np.float32)
    return pkg.BlenderDataset(imgs, np.stack(poses).astype(np.float32), K,
                              2.0, 6.0, "train")


@pytest.mark.parametrize("pairing", ["nearest", "triangles", "file"])
def test_build_view_batches_pairings(pairing, tmp_path):
    pair_file = None
    if pairing == "file":
        pair_file = tmp_path / "pairs.txt"
        pair_file.write_text("3\n0\n4,5,6\n7\n1,2\n11\n0,1,3\n")
    kw = {"num_src": 2, "pairing": pairing,
          "pair_file": str(pair_file) if pair_file else None}
    bt, at, Kt, Et = tmb.build_view_batches(sphere_dataset(tb), **kw)
    bj, aj, Kj, Ej = jmb.build_view_batches(sphere_dataset(jb), **kw)
    assert len(bt) == len(bj) > 0
    for x, y in zip(bt, bj):
        for k in ("images", "intrinsics", "w2cs", "c2ws"):
            assert np.array_equal(getattr(x, k), getattr(y, k)), k
    for a, b in ((at, aj), (Kt, Kj), (Et, Ej)):
        assert np.array_equal(a, b)


def test_pair_file_parsers(tmp_path):
    init = tmp_path / "init.txt"
    init.write_text("2\n0\n1,2\n5\n3,4,6\n")
    scored = tmp_path / "pair.txt"
    scored.write_text("2\n0\n3 1 9.5 2 8.0 4 1.0\n1\n2 0 3.0 2 2.5\n")
    for f in (init, scored):
        for name in ("load_pair_list", "load_mvsnet_pairs"):
            try:
                want = getattr(jmb, name)(str(f))
            except (ValueError, IndexError):
                with pytest.raises((ValueError, IndexError)):
                    getattr(tmb, name)(str(f))
                continue
            assert getattr(tmb, name)(str(f)) == want
    assert tmb.load_pair_list(str(init)) == [[0, 1, 2], [5, 3, 4, 6]]
    assert tmb.load_mvsnet_pairs(str(scored)) == [[0, 1, 2, 4], [1, 0, 2]]
    with pytest.raises(ValueError, match="out of range"):
        bad = tmp_path / "bad.txt"
        bad.write_text("1\n0\n40,41\n")
        tmb.build_view_batches(sphere_dataset(tb), pairing="file",
                               pair_file=str(bad))


def test_camera_triangles():
    cams = sphere_dataset(tb, 16).poses[:, :3, 3]
    got = tmb.camera_triangles(cams)
    want = jmb.camera_triangles(cams)
    key = lambda t: sorted(tuple(sorted(r)) for r in np.asarray(t).tolist())
    assert key(got) == key(want) and len(key(got)) > 0


def test_mvsnet_mode_warps_at_four_times_the_disparity():
    """A fault of the reference, mirrored (ROADMAP §3): generate_point_cloud
    feeds MVSNet 1/4-res images with 1/4-res projection matrices, but the
    net's FeatureNet strides 4 more, so its 1/16-res feature pixels are
    warped as if they were 1/4-res pixels. Two cameras 0.5 apart along x,
    a plane at depth 4, 400x400 views: the source feature the warp reads
    for a ref feature pixel sits 4x the true disparity away. Both packages
    read the same place."""
    f, c, d = 555.0, 200.0, 4.0
    K = np.tile(np.array([[f, 0, c], [0, f, c], [0, 0, 1]], np.float32),
                (2, 1, 1))
    w2cs = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    w2cs[1, 0, 3] = -0.5
    proj = tp.rel_proj_mats(tp.quarter_intrinsics(K), w2cs)
    assert np.array_equal(proj, jp.rel_proj_mats(jp.quarter_intrinsics(K),
                                                 w2cs))
    h = w = 25                                   # 400 / 16
    ramp = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :, None],
                           (h, w, 1)).copy()     # a feature = its own x
    dv = np.array([d], np.float32)
    got = tm.homo_warp(torch.tensor(ramp), torch.tensor(proj[1]),
                       torch.tensor(dv))[0, 12, :, 0].numpy()
    want = np.asarray(jm.homo_warp(jnp.asarray(ramp), jnp.asarray(proj[1]),
                                   jnp.asarray(dv)))[0, 12, :, 0]
    np.testing.assert_allclose(got, want, atol=1e-5)
    x = 20                                       # a ref feature pixel
    true_src_x = x - (f / 16) * 0.5 / d          # 4.34 feature pixels off
    assert abs(x - true_src_x) < 5
    # the read: x minus 4x the disparity, through grid_sample's
    # align_corners=False with the reference's (W - 1) normalisation
    fx = x - (f / 4) * 0.5 / d
    assert abs(got[x] - (fx * w / (w - 1) - 0.5)) < 1e-3
    assert abs(got[x] - true_src_x) > 10
