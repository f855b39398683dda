"""The port at the widths its tuned kernels are not built for, on the CPU
(the plain versions of the generic kernels csrc/decode_any.cu,
csrc/chunk_any.cu and fused_candidate_select_any), against the JAX
reference, whose Pallas kernels take every width as a static shape and
run here in interpret mode. Two width sets:

- wide: K 16 of cand_cap 128, hidden 512, colour 256 x 4 layers, PE
  octaves (4, 6, 5), 32 features, agg_dist_pers 20 (6 dists);
- narrow: K 4 of cand_cap 32, hidden 128, colour 64 x 2 layers, octaves
  (2, 4, 3), 16 features, agg_dist_pers 0 (3 dists). Two of these widths
  reach only the towers in both packages: every render computes the
  neighbour dists 6 wide (render.py, fast_render.py::neighbor_dists), so
  the renders take agg_dist_pers 20 (6 dists), and the fast path's
  candidate payload holds 32 features (the reference's cache rows are 44
  bf16 channels: xyz, 32 features, conf, dir, colour), so narrow's fast
  render keeps 32 features. The decode towers take 16 features and 3
  dists, the legacy render 16 features.

Bounds: the selection exactly (pnt_mask and every payload bit); towers
and renders within the bf16 bound of the reference's own kernel tests,
as tests/test_torch_fused_decode.py and test_torch_fused_chunk.py hold
the flagship widths: atol 2e-2 and mean 2e-3, sigma within 2e-2 + 2^-7
|sigma|; ray_mask and the counters exactly. And the envelope: a width
one step past a limit raises NotImplementedError on the CPU as on the
card (tests/test_torch_cuda.py holds the kernels to these plain
versions there)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.models import fast_render as tfr
from pointnerf2studio_torch.models import render as trender
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops import fused_chunk as tfc
from pointnerf2studio_torch.ops import fused_decode as tfd
from pointnerf2studio_torch.ops import fused_select as tfs
from pointnerf2studio_tpu.config import AggregatorConfig
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.models import fast_render as jfr
from pointnerf2studio_tpu.models.aggregator import init_aggregator_params
from pointnerf2studio_tpu.models.render import render_rays_jit
from pointnerf2studio_tpu.ops import fused_chunk as jfc
from pointnerf2studio_tpu.ops import fused_decode as jfd
from pointnerf2studio_tpu.ops import fused_select as jfs
from pointnerf2studio_tpu.ops.encoding import positional_encoding

torch.set_num_threads(1)
ATOL, MEAN_TOL, SIG_RTOL = 2e-2, 2e-3, 2.0 ** -7
PK = 48

# aggregator widths, K and cand_cap of each set
SETS = {
    "wide": (dict(hidden_size=512, hidden_size_color=256, num_color_layers=4,
                  num_feat_freqs=4, num_dist_freqs=6, num_viewdir_freqs=5),
             16, 128),
    "narrow": (dict(hidden_size=128, hidden_size_color=64, num_color_layers=2,
                    num_feat_freqs=2, num_dist_freqs=4, num_viewdir_freqs=3),
               4, 32),
}
# the towers' features and dists in each set (renders fix 6 dists, the
# fast path's payload 32 features)
TOWER_WIDTHS = {"wide": dict(point_features_dim=32, agg_dist_pers=20),
                "narrow": dict(point_features_dim=16, agg_dist_pers=0)}


def _agg_cfg(name):
    return AggregatorConfig(compute_dtype="bfloat16", **TOWER_WIDTHS[name],
                            **SETS[name][0])


def _params(cfg, seed=0, lift=1.0):
    """The reference's random weights at cfg's widths (pinned draw), the
    density head lifted so that alpha is not all zero, and the port's
    aggregator carrying them."""
    params = jax.tree.map(np.array, init_aggregator_params(
        jax.random.PRNGKey(seed), cfg))
    params["density_head"][0]["bias"] = (
        params["density_head"][0]["bias"] + lift)
    agg = convert.aggregator_from_jax(
        params, tcfg.AggregatorConfig(**dataclasses.asdict(cfg)),
        device="cpu")
    return params, agg


def _close(got, want, sig=False):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    bound = ATOL + (SIG_RTOL * np.abs(want) if sig else 0.0)
    assert np.all(d <= bound), d.max()
    assert d.mean() < MEAN_TOL, d.mean()


def _bf16_bits(a32):
    return np.asarray(jnp.asarray(a32).astype(jnp.bfloat16)).view(np.int16)


@pytest.mark.parametrize("name", sorted(SETS))
def test_select_matches_pallas_interpret(name):
    """fused_candidate_select at K 16 of C 128 and K 4 of C 32, layered
    shells, the radius test, masked slots, short rows and exact ties:
    pnt_mask and every payload bit equal the reference's."""
    _, K, C = SETS[name]
    rng = np.random.default_rng(C)
    max_q, M = 64, 200
    n = (rng.random(max_q) * C * 1.2).astype(np.int64).clip(0, C)
    n[:3] = (0, K // 2, C)
    valid = np.arange(C)[None, :] < n[:, None]
    shell = np.sort(rng.integers(0, 3, (max_q, C)), axis=-1)
    kmeta = np.where(valid, rng.integers(0, 1 << 20, (max_q, C)) * 4 + shell,
                     -1).astype(np.int32)
    pay = rng.normal(size=(max_q, PK, C)).astype(np.float32) * 0.02
    pay[:, :3, 1::2] = pay[:, :3, 0::2]           # equal d2 in two columns
    kpay = _bf16_bits(pay)
    qslot = rng.integers(0, max_q, M).astype(np.int32)
    cd0 = (rng.normal(size=(M, 3)) * 0.01).astype(np.float32)
    mask = rng.random(M) < 0.85
    args = (K, 0.03 ** 2, 3)
    nsel_j, pm_j = jfs.fused_candidate_select(
        jnp.asarray(kmeta)[qslot],
        jnp.asarray(kpay.view(jnp.bfloat16.dtype))[qslot],
        jnp.asarray(cd0), jnp.asarray(mask), *args, interpret=True)
    pay_t = torch.from_numpy(kpay.copy()).view(torch.bfloat16)
    _cuda.LAUNCHES.clear()
    nsel, pm = tfs.fused_candidate_select(
        torch.from_numpy(kmeta), pay_t.transpose(1, 2).contiguous(),
        pay_t[:, :3, :].contiguous(), torch.from_numpy(qslot),
        torch.from_numpy(cd0), torch.from_numpy(mask), *args)
    assert sum(_cuda.LAUNCHES.values()) == 0
    np.testing.assert_array_equal(pm.numpy(), np.asarray(pm_j))
    np.testing.assert_array_equal(nsel.view(torch.int16).numpy(),
                                  _bf16_bits(np.asarray(nsel_j)))
    # some slot finds all K neighbours, some fewer
    found = pm.numpy().sum(-1)
    assert found.max() == K and ((found > 0) & (found < K)).any()


@pytest.fixture(scope="module", params=sorted(SETS))
def towers(request):
    """Decoder inputs at a set's widths (M slots, a slot without any
    neighbour), the reference's weights and the port's aggregator."""
    name = request.param
    cfg = _agg_cfg(name)
    assert (cfg.shading_feature_dim, cfg.dist_dim) == (
        (32, 6) if name == "wide" else (16, 3))
    params, agg = _params(cfg)
    K, M = SETS[name][1], 96
    C, D = cfg.shading_feature_dim, cfg.dist_dim
    rng = np.random.default_rng(M + K)
    emb = rng.normal(size=(M, K, C)).astype(np.float32) * 0.1
    color = rng.random((M, K, 3)).astype(np.float32)
    ndir = rng.normal(size=(M, K, 3)).astype(np.float32)
    ndir /= np.linalg.norm(ndir, axis=-1, keepdims=True)
    dists = rng.normal(size=(M, K, D)).astype(np.float32) * 0.01
    pm = rng.random((M, K)) > 0.3
    pm[:, 0] = True
    pm[5] = False
    w = rng.random((M, K)).astype(np.float32) * pm
    w /= np.maximum(w.sum(-1, keepdims=True), 1e-8)
    vd = rng.normal(size=(M, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    dir_enc = np.asarray(positional_encoding(
        jnp.asarray(vd), cfg.num_viewdir_freqs, ori=True))
    ov, dir_pe = dir_enc[..., :3], dir_enc[..., 3:]
    dirdot = np.concatenate(
        [ndir - ov[:, None, :],
         np.sum(ndir * ov[:, None, :], -1, keepdims=True)], -1)
    return dict(name=name, cfg=cfg, params=params, agg=agg, K=K,
                args=(emb, dists, color, dirdot, (w * pm).astype(np.float32),
                      dir_pe))


@pytest.mark.parametrize("which", ["fused_decode", "fused_decode2"])
def test_decode_towers_match_pallas_interpret(towers, which):
    """fused_decode and fused_decode2 through the port's wrappers (the
    plain versions on the CPU, no launch) against the reference's
    Pallas kernels in interpret mode: sigma within 2e-2 + 2^-7 |sigma|,
    rgb within 2e-2, means within 2e-3."""
    cfg, K = towers["cfg"], towers["K"]
    freqs = (cfg.num_feat_freqs, cfg.num_dist_freqs)
    want_sig, want_rgb = getattr(jfd, which)(
        towers["params"], *(jnp.asarray(a) for a in towers["args"]), K=K,
        num_feat_freqs=freqs[0], num_dist_freqs=freqs[1], interpret=True)
    _cuda.LAUNCHES.clear()
    sig, rgb = getattr(tfd, which)(
        towers["agg"], *(torch.from_numpy(a.copy()) for a in towers["args"]),
        *freqs)
    assert sum(_cuda.LAUNCHES.values()) == 0
    assert float(sig.max()) > 0.1 and float(sig[5]) == 0.0
    _close(sig, want_sig, sig=True)
    _close(rgb, want_rgb)


@pytest.fixture(scope="module")
def wide_scene():
    """The sphere at the wide set's query widths (K 16, cand_cap 128) and
    aggregator, with the reference's fused cache of the same width."""
    agg_kw, K, cap = SETS["wide"]
    cfg = sphere_config(sr=16, d=48, k=K)
    cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, compute_dtype="bfloat16",
                                     **agg_kw),
        query=dataclasses.replace(cfg.query, use_cache=False, cand_cap=cap,
                                  ray_slot_budget=16, chunk_mode="fused",
                                  select_mode="pallas"))
    return make_sphere_scene(n_points=4000, cfg=cfg)


def test_fused_chunk_matches_pallas_interpret(wide_scene):
    """The whole fused chunk at the wide set on 256 slots at random
    points of random query voxels (10% masked off): found exactly,
    sigma and rgb within the bf16 bound."""
    s = wide_scene
    cfg = s.cfg
    q, a = cfg.query, cfg.agg
    cache = jfr.build_fat_cache(s.grid, s.cloud, q.kernel_size, 32768,
                                q.cand_cap, layout="fused")
    assert cache.kmeta.shape[1] == q.cand_cap
    rng = np.random.default_rng(0)
    M = 256
    q_ids = np.nonzero(np.asarray(cache.coor_2_qslot).reshape(-1) >= 0)[0]
    pick = rng.choice(q_ids, M)
    gx, gy, gz = s.grid.dims
    qc = np.stack([pick // (gy * gz), (pick // gz) % gy, pick % gz], -1)
    svs = np.asarray(s.grid.scaled_vsize)
    center = (np.asarray(s.grid.ranges_min) + (qc + 0.5) * svs).astype(
        np.float32)
    locs = (center + rng.uniform(-0.5, 0.5, (M, 3)) * svs).astype(np.float32)
    rd = rng.normal(size=(M, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    mask = rng.random(M) < 0.9
    qslot = np.asarray(cache.coor_2_qslot).reshape(-1)[pick].astype(np.int32)
    kmeta, kpay = np.array(cache.kmeta), np.array(cache.kpay)
    kw = dict(K=q.K, radius2=q.radius_limit ** 2,
              num_shells=(q.kernel_size[0] + 1) // 2, nff=a.num_feat_freqs,
              ndf=a.num_dist_freqs, nvf=a.num_viewdir_freqs,
              act_super=a.act_super)
    sig_w, rgb_w, found_w = (np.asarray(x) for x in jfc.fused_chunk_decode(
        s.params, s.cloud.Rw2c, s.camrotc2w, s.campos,
        jnp.asarray(kmeta[qslot]), jnp.asarray(kpay[qslot]),
        jnp.asarray(locs), jnp.asarray(center), jnp.asarray(rd),
        jnp.asarray(mask), block=128, interpret=True, **kw))
    agg = convert.aggregator_from_jax(
        jax.tree.map(np.asarray, s.params),
        tcfg.AggregatorConfig(**dataclasses.asdict(a)), device="cpu")
    T = torch.as_tensor
    pay_t = torch.from_numpy(kpay.view(np.int16).copy()).view(torch.bfloat16)
    _cuda.LAUNCHES.clear()
    sig, rgb, found = tfc.fused_chunk_decode(
        agg, T(np.array(s.cloud.Rw2c)), T(np.array(s.camrotc2w)),
        T(np.array(s.campos)), T(kmeta), pay_t.transpose(1, 2).contiguous(),
        pay_t[:, :3, :].contiguous(), T(qslot), T(locs), T(center), T(rd),
        T(mask), **kw)
    assert sum(_cuda.LAUNCHES.values()) == 0
    np.testing.assert_array_equal(found.numpy(), found_w)
    assert found.any() and not found[~T(mask)].any()
    # test_torch_fused_chunk.py's bound: sigma within 2e-2 + 2^-7 |sigma|
    # (alpha is a bf16 value, some 4 here, whose ulp is 2^-5), rgb within
    # 2e-2, the mean over both under 2e-3
    d_sig = np.abs(sig.numpy() - sig_w)
    d_rgb = np.abs(rgb.numpy() - rgb_w)[mask]
    assert np.all(d_sig <= ATOL + SIG_RTOL * np.abs(sig_w)), d_sig.max()
    assert d_rgb.max() <= ATOL, d_rgb.max()
    assert np.concatenate([d_sig, d_rgb.ravel()]).mean() < MEAN_TOL


def _port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)))


@pytest.mark.parametrize("name", sorted(SETS))
def test_fast_render_matches_jax(wide_scene, name):
    """One route end to end on the sphere, 24 x 24 rays: wide through the
    fused chunk (the reference's Pallas chunk in interpret mode), narrow
    through the staged path with fused_decode2 (the selection kernel,
    the decode tail and the K-accumulating tower; the reference's
    fused_decode2 wants a TPU backend and decodes with decode_radiance
    here). Counters and ray_mask equal, colour and acc within the bf16
    bound."""
    agg_kw, K, cap = SETS[name]
    if name == "wide":
        s = wide_scene
        cfg = s.cfg
    else:
        cfg = sphere_config(sr=16, d=48, k=K)
        cfg = dataclasses.replace(
            cfg, agg=dataclasses.replace(cfg.agg, compute_dtype="bfloat16",
                                         fused_decode2=True, **agg_kw),
            query=dataclasses.replace(
                cfg.query, use_cache=False, cand_cap=cap, ray_slot_budget=16,
                knn_mode="fused", chunk_mode="xla", select_mode="pallas"))
        s = make_sphere_scene(n_points=4000, cfg=cfg)
    cfg = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, compact_budget=4))
    cache, rmin, svs = jfr.make_fast_scene(cfg, s.cloud, s.grid)
    assert cache.kmeta.shape[1] == cap
    rays = np.asarray(camera_rays(s.campos, s.camrotc2w, 24, 24, 18.0))
    want = jfr.fast_render_rays_jit(
        s.params, s.cloud.Rw2c, cache, s.campos, s.camrotc2w, rays,
        s.near, s.far, cfg, rmin, svs)
    T = lambda a: torch.as_tensor(np.array(a))    # noqa: E731
    tc = _port_cfg(cfg)
    assert tfr._check_served(tc, T(s.cloud.Rw2c), False) == (
        "chunk" if name == "wide" else "staged")
    _cuda.LAUNCHES.clear()
    got = tfr.fast_render_rays(
        convert.aggregator_from_jax(jax.tree.map(np.asarray, s.params),
                                    tc.agg, device="cpu"),
        T(s.cloud.Rw2c), convert.fat_cache_from_jax(cache, device="cpu"),
        T(s.campos), T(s.camrotc2w), T(rays), s.near, s.far, tc, T(rmin),
        T(svs))
    assert sum(_cuda.LAUNCHES.values()) == 0
    for f in ("dw_overflow", "rb_overflow", "cb_overflow", "n_valid_slots"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            assert int(g) == int(w), f
    mask = got.ray_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.ray_mask))
    assert 0 < mask.sum() < mask.size
    _close(got.coarse_raycolor.numpy(), want.coarse_raycolor)
    _close(got.acc.numpy(), want.acc)


def test_legacy_render_narrow_matches_jax():
    """The legacy render_rays with fused_decode on at the narrow set (16
    features, hidden 128, octaves (2, 4); 6 dists) against the
    reference's render_rays (its decode kernel wants a TPU backend, so it
    decodes with decode_radiance): ray_mask and pnt_mask equal, colour
    and acc within the bf16 bound."""
    agg_kw, K, _ = SETS["narrow"]
    cfg = sphere_config(sr=16, d=48, k=K)
    cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, compute_dtype="bfloat16",
                                     fused_decode=True, point_features_dim=16,
                                     **agg_kw),
        query=dataclasses.replace(cfg.query, use_cache=False,
                                  compact_budget=8))
    s = make_sphere_scene(n_points=4000, cfg=cfg)
    cloud = dataclasses.replace(
        s.cloud, points_embeding=s.cloud.points_embeding[:, :16])
    rays = np.asarray(camera_rays(s.campos, s.camrotc2w, 24, 24, 18.0))
    with jax.default_matmul_precision("highest"):
        want = render_rays_jit(s.params, cloud, s.grid, s.campos,
                               s.camrotc2w, jnp.asarray(rays), s.near,
                               s.far, cfg)
    tc = _port_cfg(cfg)
    assert tfd.fused_decode_served(tc.agg, False, K)
    T = lambda a: torch.as_tensor(np.array(a))    # noqa: E731
    _cuda.LAUNCHES.clear()
    got = trender.render_rays(
        convert.aggregator_from_jax(jax.tree.map(np.asarray, s.params),
                                    tc.agg, device="cpu"),
        convert.cloud_from_jax(jax.tree.map(np.asarray, cloud),
                               device="cpu"),
        convert.grid_from_jax(s.grid, device="cpu"), T(s.campos),
        T(s.camrotc2w), T(rays), s.near, s.far, tc)
    assert sum(_cuda.LAUNCHES.values()) == 0
    mask = got.ray_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.ray_mask))
    np.testing.assert_array_equal(got.pnt_mask.numpy(),
                                  np.asarray(want.pnt_mask))
    assert 0 < mask.sum() < mask.size
    _close(got.coarse_raycolor.numpy(), want.coarse_raycolor)
    _close(got.acc.numpy(), want.acc)


# one step past each limit of the envelope; each raises on the CPU
DECODE_OUTSIDE = {
    "hidden513": dict(hidden_size=513), "features65": dict(
        point_features_dim=65), "feat_freqs11": dict(num_feat_freqs=11),
    "dist_freqs11": dict(num_dist_freqs=11), "feat_freqs0": dict(
        num_feat_freqs=0)}
CHUNK_OUTSIDE = {
    "hidden513": (dict(hidden_size=513), 8, 64),
    "colour513": (dict(hidden_size_color=513), 8, 64),
    "colour_layers9": (dict(num_color_layers=9), 8, 64),
    "viewdir_freqs11": (dict(num_viewdir_freqs=11), 8, 64),
    "k33": ({}, 33, 64), "cand257": ({}, 8, 257)}


@pytest.mark.parametrize("name", sorted(DECODE_OUTSIDE) + ["k33"])
def test_decode_envelope_limits(name):
    """The decode kernels' gate: the last width inside each limit is
    served, one step past it raises NotImplementedError naming it, on the
    CPU (the wrappers and fused_decode_served)."""
    kw = DECODE_OUTSIDE.get(name, {})
    K = 33 if name == "k33" else 8
    cfg = dataclasses.replace(tcfg.AggregatorConfig(), **kw)
    with pytest.raises(NotImplementedError, match="not ported"):
        tfd.fused_decode_served(cfg, False, K)
    inside = {k: (v - 1 if v > 1 else 1) for k, v in kw.items()}
    assert tfd.fused_decode_served(
        dataclasses.replace(tcfg.AggregatorConfig(), **inside), False,
        min(K, 32))
    if name in ("hidden513", "k33"):
        agg = Aggregator(cfg if name == "hidden513" else
                         tcfg.AggregatorConfig(), device="cpu")
        z = torch.zeros
        args = (z((2, K, 32), dtype=torch.bfloat16), z((2, K, 6)),
                z((2, K, 3)), z((2, K, 4)), z((2, K)))
        for tower in (tfd.pair_tower, tfd.kacc_tower):
            with pytest.raises(NotImplementedError, match="not ported"):
                tower(agg, *args, nff=3, ndf=5)


@pytest.mark.parametrize("name", sorted(CHUNK_OUTSIDE))
def test_chunk_envelope_limits(name):
    """The fused chunk's gate on the CPU: one step past a limit raises
    from the wrapper before any work; the last width inside is served
    (the check alone: the plain version's run is the tests above)."""
    kw, K, C = CHUNK_OUTSIDE[name]
    cfg = dataclasses.replace(tcfg.AggregatorConfig(compute_dtype="bfloat16"),
                              **kw)
    agg = Aggregator(cfg, device="cpu")
    freqs = (cfg.num_feat_freqs, cfg.num_dist_freqs, cfg.num_viewdir_freqs)
    with pytest.raises(NotImplementedError, match="not ported"):
        tfc.check_envelope(agg, K, C, *freqs)
    z = torch.zeros
    with pytest.raises(NotImplementedError, match="not ported"):
        tfc.fused_chunk_decode(
            agg, torch.eye(3), torch.eye(3), z(3),
            z((4, C), dtype=torch.int32), z((4, C, PK), dtype=torch.bfloat16),
            z((4, 3, C), dtype=torch.bfloat16), z(2, dtype=torch.int32),
            z((2, 3)), z((2, 3)), z((2, 3)), z(2, dtype=torch.bool), K=K,
            radius2=0.0, num_shells=1, nff=freqs[0], ndf=freqs[1],
            nvf=freqs[2], act_super=False)
    inside = {k: v - 1 for k, v in kw.items()}
    tfc.check_envelope(
        Aggregator(dataclasses.replace(cfg, **inside), device="cpu"),
        min(K, 32), min(C, 256), *(min(f, 10) for f in freqs))


@pytest.mark.parametrize("K,C", [(33, 64), (8, 257), (0, 64)])
def test_select_envelope_limits(K, C):
    """The selection's gate on the CPU: K up to 32 of C up to 256."""
    z = torch.zeros
    with pytest.raises(NotImplementedError, match="K <= 32"):
        tfs.fused_candidate_select(
            z((4, C), dtype=torch.int32), z((4, C, PK), dtype=torch.bfloat16),
            z((4, 3, C), dtype=torch.bfloat16), z(2, dtype=torch.int32),
            z((2, 3)), z(2, dtype=torch.bool), K, 0.0, 1)
    tfs.check_envelope(min(max(K, 1), 32), min(C, 256))
    assert tfs.tuned(8, 64) and not tfs.tuned(9, 64) and not tfs.tuned(8, 65)
