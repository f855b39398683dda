"""Leaf math of the PyTorch port vs the JAX reference on the same numpy
inputs: positional encodings, camera transforms, compositing, the
procedural chair SDF and albedo. float32 throughout; tolerances are a
few float32 ulps of the values compared (different sin/cos/exp
implementations and reduction orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch.data import procedural as tproc
from pointnerf2studio_torch.ops import camera as tcam
from pointnerf2studio_torch.ops import compositing as tcomp
from pointnerf2studio_torch.ops import encoding as tenc
from pointnerf2studio_tpu.data import procedural as jproc
from pointnerf2studio_tpu.ops import camera as jcam
from pointnerf2studio_tpu.ops import compositing as jcomp
from pointnerf2studio_tpu.ops import encoding as jenc

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
