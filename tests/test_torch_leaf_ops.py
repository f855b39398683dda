"""Leaf math of the PyTorch port vs the JAX reference on the same numpy
inputs: positional encodings, camera transforms, compositing, the
procedural chair SDF and albedo, ray generation (closed form exactly,
the caller-supplied jitter within a few ulps of the cumsum) and the
neighbour gather (exactly). float32 throughout; tolerances are a few
float32 ulps of the values compared (different sin/cos/exp
implementations and reduction orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch.data import procedural as tproc
from pointnerf2studio_torch.models import neural_points as tnp
from pointnerf2studio_torch.ops import camera as tcam
from pointnerf2studio_torch.ops import compositing as tcomp
from pointnerf2studio_torch.ops import encoding as tenc
from pointnerf2studio_torch.ops import raygen as traygen
from pointnerf2studio_tpu.data import procedural as jproc
from pointnerf2studio_tpu.models import neural_points as jnpts
from pointnerf2studio_tpu.ops import camera as jcam
from pointnerf2studio_tpu.ops import compositing as jcomp
from pointnerf2studio_tpu.ops import encoding as jenc
from pointnerf2studio_tpu.ops import raygen as jraygen

torch.set_num_threads(1)


@pytest.mark.parametrize("ori", [False, True])
@pytest.mark.parametrize("mode", ["direct", "rec"])
@pytest.mark.parametrize("F", [0, 3, 5])
def test_positional_encoding(ori, mode, F):
    x = np.random.default_rng(F).normal(0, 0.5, (37, 6)).astype(np.float32)
    want = np.asarray(jenc.positional_encoding(jnp.asarray(x), F, ori=ori,
                                               mode=mode))
    got = tenc.positional_encoding(torch.as_tensor(x), F, ori=ori,
                                   mode=mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_positional_encoding_bf16_layout():
    x = np.random.default_rng(1).normal(0, 0.1, (64, 32)).astype(np.float32)
    want = np.asarray(jenc.positional_encoding(
        jnp.asarray(x, jnp.bfloat16), 3, mode="rec").astype(jnp.float32))
    got = tenc.positional_encoding(torch.as_tensor(x).bfloat16(), 3,
                                   mode="rec").float().numpy()
    # both round the same f32 encodings to bf16: at most one bf16 ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=8e-3)


def _rot(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return q.astype(np.float32)


def test_world_to_cam_and_w2pers():
    rng = np.random.default_rng(2)
    p = rng.normal(0, 1, (50, 4, 3)).astype(np.float32)
    R = _rot(3)
    c = np.array([0.3, -2.0, 4.0], np.float32)
    for tf, jf in ((tcam.world_to_cam, jcam.world_to_cam),
                   (tcam.w2pers, jcam.w2pers)):
        want = np.asarray(jf(jnp.asarray(p), jnp.asarray(R), jnp.asarray(c)))
        got = tf(torch.as_tensor(p), torch.as_tensor(R),
                 torch.as_tensor(c)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_ray_dist_from_sample_z():
    rng = np.random.default_rng(4)
    z = np.sort(rng.uniform(2, 3, (40, 12)), -1).astype(np.float32)
    valid = rng.random((40, 12)) < 0.7
    zm = np.where(valid, z, -1e9).astype(np.float32)
    want = np.asarray(jcomp.ray_dist_from_sample_z(
        jnp.asarray(zm), jnp.asarray(valid), 0.02))
    got = tcomp.ray_dist_from_sample_z(
        torch.as_tensor(zm), torch.as_tensor(valid), 0.02).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["gamma", "normalize", "off"])
def test_tone_maps(name):
    c = np.random.default_rng(5).uniform(0, 1, (30, 3)).astype(np.float32)
    want = np.asarray(jcomp.TONE_MAPS[name](jnp.asarray(c)))
    got = tcomp.TONE_MAPS[name](torch.as_tensor(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("blend", ["alpha", "alpha2"])
def test_packed_alpha_composite(blend):
    """The [R, max_slots] grid form vs the reference's segmented scans,
    on packed segments with invalid in-segment slots and a padding tail."""
    rng = np.random.default_rng(6)
    R, BP, vz = 50, 8, 0.02
    cnt = rng.integers(0, BP + 1, R)
    total = int(cnt.sum())
    M = total + 17
    pack_end = np.cumsum(cnt)
    sel_ray = np.minimum(np.searchsorted(pack_end, np.arange(M),
                                         side="right"), R - 1)
    slot_ok = rng.random(M) < 0.8
    slot_ok[total:] = False
    # depth-ordered z within each segment
    z = np.zeros(M, np.float32)
    for r in range(R):
        s, e = pack_end[r] - cnt[r], pack_end[r]
        z[s:e] = np.sort(rng.uniform(2, 2.2, e - s))
    sig = np.where(slot_ok, rng.uniform(0, 60, M), 0).astype(np.float32)
    rgb = rng.uniform(0, 1, (M, 3)).astype(np.float32)
    args_np = (sig, rgb, z, slot_ok, sel_ray.astype(np.int32),
               pack_end.astype(np.int32), cnt.astype(np.int32))
    want = jax.jit(jcomp.packed_alpha_composite, static_argnums=(7, 8))(
        *(jnp.asarray(a) for a in args_np), vz, blend)
    got = tcomp.packed_alpha_composite(
        *(torch.as_tensor(a) for a in args_np), vz, blend, max_slots=BP)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_chair_sdf_and_albedo():
    p = np.random.default_rng(7).uniform(-1.1, 1.1, (4000, 3)).astype(
        np.float32)
    jd, jpart = jproc.chair_sdf(jnp.asarray(p))
    td, tpart = tproc.chair_sdf(torch.as_tensor(p))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2e-6)
    # part ids agree wherever two parts are not within float noise
    np.testing.assert_array_equal(tpart.numpy(), np.asarray(jpart))
    for style in ("v1", "v2"):
        ja = np.asarray(jproc._albedo(jnp.asarray(p), jpart, style))
        ta = tproc._albedo(torch.as_tensor(p), tpart, style).numpy()
        np.testing.assert_allclose(ta, ja, rtol=0, atol=2e-5)


def test_packed_composite_drops_rays_past_the_budget():
    """Rays whose slots all lie past M (a tripped cb_overflow) contribute
    nothing: zero sums, not found."""
    cnt = torch.tensor([3, 2, 4, 2], dtype=torch.int32)
    pack_end = torch.cumsum(cnt, 0).to(torch.int32)
    M = 6                                       # cuts ray 2, drops ray 3
    sel_ray = torch.tensor([0, 0, 0, 1, 1, 2])
    ok = torch.ones(M, dtype=torch.bool)
    z = torch.tensor([2.0, 2.01, 2.02, 2.0, 2.01, 2.0])
    rgb_sum, acc, depth, found = tcomp.packed_alpha_composite(
        torch.full((M,), 50.0), torch.ones(M, 3), z, ok, sel_ray, pack_end,
        cnt, 0.02, "alpha", max_slots=4)
    assert found.tolist() == [True, True, True, False]
    assert acc[3] == 0 and (rgb_sum[3] == 0).all() and depth[3] == 0
    assert acc[2] > 0


RAYGEN = ["near_far_linear_ray_generation",
          "near_far_disparity_linear_ray_generation"]


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return rng, rd, np.array([0.1, -0.2, 2.0], np.float32)


@pytest.mark.parametrize("fn", RAYGEN)
@pytest.mark.parametrize("D", [48, 120, 400])
def test_raygen_closed_form_exact(fn, D):
    """No jitter: sample positions, segment lengths and mid ts equal the
    reference's bit for bit (also with jitter > 0 but no draws given,
    which takes the closed form on both sides)."""
    _, rd, cp = _rays(33, D)
    for jitter in (0.0, 0.3):
        want = getattr(jraygen, fn)(jnp.asarray(cp), jnp.asarray(rd), D,
                                    near=2.0, far=6.0, jitter=jitter)
        got = getattr(traygen, fn)(torch.as_tensor(cp), torch.as_tensor(rd),
                                   D, 2.0, 6.0, jitter=jitter)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (33, D, 3) and got[1].shape == (33, D)


@pytest.mark.parametrize("fn", RAYGEN)
@pytest.mark.parametrize("batched", [False, True])
def test_raygen_jitter_u(fn, batched):
    """Caller-supplied uniform draws: the cumsum of the jittered
    segments differs from the reference's by a few float32 ulps of t."""
    D = 64
    rng, rd, cp = _rays(20, 5)
    u = rng.random((20, D)).astype(np.float32)
    if batched:
        rd, u, cp = rd.reshape(2, 10, 3), u.reshape(2, 10, D), cp[None]
        cp = np.repeat(cp, 2, 0)
    want = getattr(jraygen, fn)(jnp.asarray(cp), jnp.asarray(rd), D,
                                near=1.0, far=3.0, jitter=0.3,
                                jitter_u=jnp.asarray(u))
    got = getattr(traygen, fn)(torch.as_tensor(cp), torch.as_tensor(rd), D,
                               1.0, 3.0, jitter=0.3,
                               jitter_u=torch.as_tensor(u))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6)
    closed = getattr(traygen, fn)(torch.as_tensor(cp), torch.as_tensor(rd),
                                  D, 1.0, 3.0)
    assert float((got[2] - closed[2]).abs().max()) > 1e-4


def test_gather_neighbors_exact():
    rng = np.random.default_rng(2)
    n = 50
    arrs = dict(xyz=rng.normal(size=(n, 3)), emb=rng.normal(size=(n, 32)),
                conf=rng.random((n, 1)), dirs=rng.normal(size=(n, 3)),
                col=rng.random((n, 3)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    order = ("xyz", "emb", "conf", "dirs", "col")
    jc = jnpts.from_arrays(*(jnp.asarray(arrs[k]) for k in order))
    tc = tnp.from_arrays(*(arrs[k] for k in order), device="cpu")
    pidx = rng.integers(-1, n, (7, 5, 8)).astype(np.int32)
    want = jnpts.gather_neighbors(jc, jnp.asarray(pidx))
    got = tnp.gather_neighbors(tc, torch.as_tensor(pidx))
    assert set(got) == {"xyz", "embeding", "conf", "dir", "color"}
    for k, v in got.items():
        assert v.shape[:3] == pidx.shape
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


# ---- the leaf functions no path of either package runs: the other ray
# generators, importance resampling, the plain composite, the render
# functions, the linear weight and the loss wrapper. Uniform draws come
# from the reference's own key and are handed to the port.

LEAF_RD = np.random.default_rng(5).normal(size=(6, 3)).astype(np.float32)
LEAF_RD /= np.linalg.norm(LEAF_RD, axis=-1, keepdims=True)
LEAF_CAM = np.array([0.1, -0.2, 0.3], np.float32)


@pytest.mark.parametrize("jitter", [0.0, 0.4])
def test_near_middle_far_ray_generation(jitter):
    key = jax.random.PRNGKey(2) if jitter else None
    want = jraygen.near_middle_far_ray_generation(
        jnp.asarray(LEAF_CAM), jnp.asarray(LEAF_RD), 20, 0.5, 2.0, 8.0,
        middle_split=0.6, jitter=jitter, key=key)
    u = (np.array(jax.random.uniform(key, (1, 6, 20), dtype=jnp.float32))
         if jitter else None)
    got = traygen.near_middle_far_ray_generation(
        torch.as_tensor(LEAF_CAM), torch.as_tensor(LEAF_RD), 20, 0.5, 2.0,
        8.0, middle_split=0.6, jitter=jitter,
        jitter_u=None if u is None else torch.as_tensor(u))
    # running sums of the segments in another order: a few ulps of 8
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=4e-6)


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_and_refine(det):
    _, _, ts = jraygen.near_far_linear_ray_generation(
        jnp.asarray(LEAF_CAM), jnp.asarray(LEAF_RD), 32, 0.5, 5.0)
    w = jnp.exp(-((ts - 2.0) ** 2) / 0.05) + 0.01 * jnp.arange(32) / 32
    key = None if det else jax.random.PRNGKey(7)
    want = jraygen.sample_pdf(ts, w, 16, det=det, key=key)
    u = (None if det else torch.as_tensor(np.asarray(jax.random.uniform(
        key, (6, 16), dtype=jnp.float32))))
    got = traygen.sample_pdf(torch.as_tensor(np.array(ts)),
                             torch.as_tensor(np.array(w)), 16, det=det, u=u)
    assert got.shape == (6, 48) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jitter = 0.0 if det else 0.5
    want = jraygen.refine_ray_generation(
        jnp.asarray(LEAF_CAM), jnp.asarray(LEAF_RD), 24, ts, w,
        jitter=jitter, key=key)
    u = (None if det else torch.as_tensor(np.asarray(jax.random.uniform(
        key, (1, 6, 25), dtype=jnp.float32))[0]))
    got = traygen.refine_ray_generation(
        torch.as_tensor(LEAF_CAM), torch.as_tensor(LEAF_RD), 24,
        torch.as_tensor(np.array(ts)), torch.as_tensor(np.array(w)),
        jitter=jitter, u=u)
    for g, wt in zip(got, want):
        assert g.shape == np.asarray(wt).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=1e-5,
                                   atol=1e-5)


def test_alpha_composite_and_render_functions():
    rng = np.random.default_rng(11)
    sigma = rng.random((5, 12)).astype(np.float32) * 4
    rgb = rng.random((5, 12, 3)).astype(np.float32)
    dist = rng.random((5, 12)).astype(np.float32) * 0.1
    bg = np.array([1.0, 0.5, 0.25], np.float32)
    want = jcomp.alpha_composite(*(jnp.asarray(a) for a in (sigma, rgb, dist,
                                                            bg)))
    got = tcomp.alpha_composite(*(torch.as_tensor(a) for a in (sigma, rgb,
                                                               dist, bg)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    feat = rng.normal(size=(4, 7, 9)).astype(np.float32)
    for name in ("radiance", "white"):
        np.testing.assert_array_equal(
            tcomp.RENDER_FUNCTIONS[name](torch.as_tensor(feat)).numpy(),
            np.asarray(jcomp.RENDER_FUNCTIONS[name](jnp.asarray(feat))))


@pytest.mark.parametrize("axis_weight", [(1.0, 1.0, 1.0), (2.0, 0.5, 3.0)])
def test_inverse_distance_weight(axis_weight):
    from pointnerf2studio_torch.models import aggregator as tagg
    from pointnerf2studio_tpu.models import aggregator as jagg
    rng = np.random.default_rng(4)
    dists = rng.normal(size=(10, 8, 6)).astype(np.float32) * 0.05
    mask = rng.random((10, 8)) > 0.3
    want = jagg.inverse_distance_weight(jnp.asarray(dists),
                                        jnp.asarray(mask), axis_weight)
    got = tagg.inverse_distance_weight(torch.as_tensor(dists),
                                       torch.as_tensor(mask), axis_weight)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-7)


def test_compute_loss_wrapper():
    from pointnerf2studio_torch.models.fast_train import TrainRenderOutput
    from pointnerf2studio_torch.train.loss import compute_loss as tloss
    from pointnerf2studio_tpu.models.render import RenderOutput
    from pointnerf2studio_tpu.train.loss import compute_loss as jloss
    rng = np.random.default_rng(3)
    arrs = dict(coarse_raycolor=rng.random((16, 3)),
                ray_mask=rng.random(16) > 0.5, acc=rng.random(16),
                depth=rng.random(16) * 3, conf_coefficient=rng.random((24, 4)),
                pnt_mask=rng.random((24, 4)) > 0.3,
                weight=rng.random((24, 4)))
    arrs = {k: (v if v.dtype == bool else v.astype(np.float32))
            for k, v in arrs.items()}
    gt = rng.random((16, 3)).astype(np.float32)
    want_t, want = jloss(RenderOutput(**{k: jnp.asarray(v)
                                         for k, v in arrs.items()}),
                         jnp.asarray(gt), zero_epsilon=2e-3,
                         zero_one_weight=3e-4)
    got_t, got = tloss(TrainRenderOutput(**{k: torch.as_tensor(v)
                                            for k, v in arrs.items()}),
                       torch.as_tensor(gt), zero_epsilon=2e-3,
                       zero_one_weight=3e-4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
