"""The fused chunk of the port on the CPU (its plain version) vs the JAX
reference's Pallas kernel in interpret mode, on slots drawn from a real
fused-layout cache; the weight preparation element for element; and the
port's decode_radiance vs the reference's.

Selection is float32 with the reference's op order, so `found` must match
exactly. The towers round at the same bf16 points but sum their products
in another order, so sigma/rgb agree to bf16 tolerance: rgb within 2e-2
(the bound of tests/test_fused_chunk.py), sigma within 2e-2 plus one
bf16 ulp of the densities summed into it (2^-7 |sigma|), mean < 2e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch import convert
from pointnerf2studio_torch.config import AggregatorConfig as TAggConfig
from pointnerf2studio_torch.models import aggregator as tagg
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops import fused_chunk as tfc
from pointnerf2studio_tpu.config import AggregatorConfig
from pointnerf2studio_tpu.data.synthetic import make_sphere_scene, sphere_config
from pointnerf2studio_tpu.models import aggregator as jagg
from pointnerf2studio_tpu.models import fast_render as jfr
from pointnerf2studio_tpu.ops import fused_chunk as jfc

torch.set_num_threads(1)
ATOL, MEAN_TOL, SIG_RTOL = 2e-2, 2e-3, 2.0 ** -7


def _bf16_cfg():
    cfg = sphere_config(sr=16, d=48)
    return dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, compute_dtype="bfloat16"),
        query=dataclasses.replace(cfg.query, use_cache=False))


@pytest.fixture(scope="module")
def chunk():
    """A JAX sphere scene's fused cache plus 640 slots at random points
    of random query voxels (10% masked off), as numpy arrays."""
    cfg = _bf16_cfg()
    s = make_sphere_scene(n_points=6000, cfg=cfg)
    cache = jfr.build_fat_cache(s.grid, s.cloud, cfg.query.kernel_size,
                                32768, 64, layout="fused")
    rng = np.random.default_rng(0)
    M = 640
    q_ids = np.nonzero(np.asarray(cache.coor_2_qslot).reshape(-1) >= 0)[0]
    pick = rng.choice(q_ids, M)
    gx, gy, gz = s.grid.dims
    qc = np.stack([pick // (gy * gz), (pick // gz) % gy, pick % gz], -1)
    rmin = np.asarray(s.grid.ranges_min)
    svs = np.asarray(s.grid.scaled_vsize)
    center = (rmin + (qc + 0.5) * svs).astype(np.float32)
    locs = (center + rng.uniform(-0.5, 0.5, (M, 3)) * svs).astype(np.float32)
    rd = rng.normal(size=(M, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return dict(
        s=s, cfg=cfg, params=jax.tree.map(np.asarray, s.params),
        kmeta=np.array(cache.kmeta), kpay=np.array(cache.kpay),
        qslot=np.asarray(cache.coor_2_qslot).reshape(-1)[pick].astype(
            np.int32),
        locs=locs, center=center, rd=rd, mask=rng.random(M) < 0.9)


def _kw(cfg):
    q, a = cfg.query, cfg.agg
    return dict(K=q.K, radius2=q.radius_limit ** 2,
                num_shells=(q.kernel_size[0] + 1) // 2,
                nff=a.num_feat_freqs, ndf=a.num_dist_freqs,
                nvf=a.num_viewdir_freqs, act_super=a.act_super)


def _check(sig, rgb, found, sig_w, rgb_w, found_w, mask):
    np.testing.assert_array_equal(found, found_w)
    d_sig = np.abs(sig - sig_w)
    assert np.all(d_sig <= ATOL + SIG_RTOL * np.abs(sig_w)), d_sig.max()
    d_rgb = np.abs(rgb - rgb_w)[mask]
    assert d_rgb.max() <= ATOL, d_rgb.max()
    assert np.concatenate([d_sig, d_rgb.ravel()]).mean() < MEAN_TOL


@pytest.mark.parametrize("layered", [True, False])
def test_plain_fused_chunk_matches_pallas_interpret(chunk, layered):
    c, cfg = chunk, chunk["cfg"]
    kw = _kw(cfg)
    if not layered:
        kw["num_shells"] = 1
    s = c["s"]
    sig_w, rgb_w, found_w = (np.asarray(a) for a in jfc.fused_chunk_decode(
        s.params, s.cloud.Rw2c, s.camrotc2w, s.campos,
        jnp.asarray(c["kmeta"][c["qslot"]]), jnp.asarray(c["kpay"][c["qslot"]]),
        jnp.asarray(c["locs"]), jnp.asarray(c["center"]),
        jnp.asarray(c["rd"]), jnp.asarray(c["mask"]), block=128,
        interpret=True, **kw))
    agg = convert.aggregator_from_jax(
        c["params"], TAggConfig(**dataclasses.asdict(cfg.agg)))
    T = torch.as_tensor
    _cuda.LAUNCHES.clear()
    sig, rgb, found = tfc.fused_chunk_decode(
        agg, T(np.array(s.cloud.Rw2c)), T(np.array(s.camrotc2w)),
        T(np.array(s.campos)), T(c["kmeta"]),
        convert.fat_cache_from_jax(_Cache(c)).kpay, T(c["qslot"]),
        T(c["locs"]), T(c["center"]), T(c["rd"]), T(c["mask"]), **kw)
    assert _cuda.LAUNCHES["fused_chunk_decode"] == 0
    assert found.any() and not found.all()
    # masked-off slots output (0, 0, False)
    assert not found[~T(c["mask"])].any()
    assert (rgb[~T(c["mask"])] == 0).all()
    _check(sig.numpy(), rgb.numpy(), found.numpy(), sig_w, rgb_w, found_w,
           c["mask"])


class _Cache:
    """Just the fields convert.fat_cache_from_jax reads."""

    def __init__(self, c):
        self.kmeta, self.kpay = c["kmeta"], c["kpay"]
        self.coor_2_qslot = np.zeros((1, 1, 1), np.int32)
        self.n_q = np.int32(c["kmeta"].shape[0])


def test_prep_params_exact(chunk):
    cfg = chunk["cfg"]
    agg = convert.aggregator_from_jax(
        chunk["params"], TAggConfig(**dataclasses.asdict(cfg.agg)))
    want, n_want = jfc._prep_params(chunk["s"].params, 32, 3, 5, 4)
    got, n_got = tfc._prep_params(agg, 32, 3, 5, 4)
    assert n_got == n_want == 2
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype == np.float32:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
    packed = tfc._kernel_params(got, n_got)
    assert packed.dtype == torch.bfloat16 and packed.numel() == 351_648


def test_permutations_match():
    from pointnerf2studio_torch.ops import fused_decode as tfd
    from pointnerf2studio_tpu.ops import fused_decode as jfd
    np.testing.assert_array_equal(tfd._w1_permutation(32, 3, 6, 5),
                                  jfd._w1_permutation(32, 3, 6, 5))
    np.testing.assert_array_equal(tfc._dirpe_permutation(4),
                                  jfc._dirpe_permutation(4))
    x = np.random.default_rng(1).normal(size=(7, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tfd._pe_blocks(torch.as_tensor(x), 5).numpy(),
        np.asarray(jfd._pe_blocks(jnp.asarray(x), 5)), rtol=0, atol=2e-6)


def test_eligibility_gate():
    ok = TAggConfig(compute_dtype="bfloat16")
    for cfg in (ok, dataclasses.replace(ok, agg_intrp_order=1),
                dataclasses.replace(ok, compute_dtype="float32"),
                dataclasses.replace(ok, agg_distance_kernel="quadric")):
        j = AggregatorConfig(**dataclasses.asdict(cfg))
        for pp in (False, True):
            assert (tfc.fused_chunk_eligible(cfg, pp, 8)
                    == jfc.fused_chunk_eligible(j, pp, 8))


@pytest.mark.parametrize("dtype,order", [("float32", 2), ("bfloat16", 2),
                                         ("float32", 1)])
def test_decode_radiance_matches(dtype, order):
    cfg = AggregatorConfig(compute_dtype=dtype, agg_intrp_order=order,
                           pe_mode="rec")
    rng = np.random.default_rng(2)
    M, K = 48, 8
    params = jagg.init_aggregator_params(jax.random.PRNGKey(0), cfg)
    params_np = jax.tree.map(np.asarray, params)
    pm = rng.random((M, K)) < 0.6
    dists = rng.normal(0, 0.02, (M, K, 6)).astype(np.float32)
    w_raw = pm / np.maximum(np.linalg.norm(dists[..., :3], axis=-1), 1e-6)
    weight = (w_raw / np.maximum(w_raw.sum(-1, keepdims=True), 1e-8)
              ).astype(np.float32)
    vd = rng.normal(size=(M, 3)).astype(np.float32)
    args = [rng.normal(0, 0.1, (M, K, 32)).astype(np.float32),
            rng.uniform(0, 1, (M, K, 3)).astype(np.float32),
            rng.normal(size=(M, K, 3)).astype(np.float32),
            dists, weight, pm, vd / np.linalg.norm(vd, axis=-1,
                                                   keepdims=True),
            np.eye(3, dtype=np.float32)]
    with jax.default_matmul_precision("highest"):
        sig_w, rgb_w = (np.asarray(a) for a in jagg.decode_radiance(
            params, cfg, *(jnp.asarray(a) for a in args)))
    agg = convert.aggregator_from_jax(
        params_np, TAggConfig(**dataclasses.asdict(cfg)))
    # the port's decode_radiance on the same weights and inputs
    sig, rgb = tagg.decode_radiance(
        agg, TAggConfig(**dataclasses.asdict(cfg)),
        *(torch.as_tensor(a) for a in args))
    if dtype == "float32":
        np.testing.assert_allclose(sig.numpy(), sig_w, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(rgb.numpy(), rgb_w, rtol=0, atol=1e-5)
    else:
        assert np.all(np.abs(sig.numpy() - sig_w)
                      <= ATOL + SIG_RTOL * np.abs(sig_w))
        np.testing.assert_allclose(rgb.numpy(), rgb_w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("axis_weight", [(1.0, 1.0, 1.0), (1.0, 0.5, 2.0)])
def test_aggregation_weight_matches(axis_weight):
    rng = np.random.default_rng(3)
    dists = rng.normal(0, 0.02, (40, 8, 6)).astype(np.float32)
    pm = rng.random((40, 8)) < 0.6
    emb = rng.normal(size=(40, 8, 32)).astype(np.float32)
    cfg = AggregatorConfig(axis_weight=axis_weight)
    want, _ = jagg.aggregation_weight(cfg, jnp.asarray(emb),
                                      jnp.asarray(dists), jnp.asarray(pm),
                                      0.008)
    got = tagg.aggregation_weight(TAggConfig(**dataclasses.asdict(cfg)),
                                  torch.as_tensor(dists), torch.as_tensor(pm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_aggregator_init_is_seeded():
    cfg = TAggConfig()
    a, b, c = (tagg.Aggregator(cfg, seed=s) for s in (0, 0, 1))
    for (na, pa), (_, pb), (_, pc) in zip(a.named_parameters(),
                                          b.named_parameters(),
                                          c.named_parameters()):
        assert torch.equal(pa, pb), na
        assert not torch.equal(pa, pc), na
    lin = a.mlp_base[0]
    assert tuple(lin.weight.shape) == (256, 284)
    assert float(lin.weight.abs().max()) <= 284 ** -0.5
