"""The port's aggregation weights and decoder (models/aggregator.py)
against the JAX reference on the same numpy inputs, on the CPU.

  * all nine weight kernels (`raw_aggregation_weight`, the per-lane weight
    and the embedding it leaves, and `aggregation_weight`, normalised over
    K) in float32 and bfloat16 inputs; the learned `feat_intrp` weight's
    gradients into its tower and the embedding too;
  * `decode_radiance` with orders 0, 1 and 2, a global and a per-point
    Rw2c, float32 and bfloat16 compute.

Tolerances: float32 within rtol 1e-5 (atol 1e-6 of the largest value,
for weights near 0 that are differences of near-equal numbers); bfloat16
within the bound of tests/test_fused_chunk.py:54-66, atol 2e-2 and mean
|diff| < 2e-3, each relative to max(1, the largest value) (raw weights
reach 1 / |delta| ~ 100), and for sigma (a K-sum of bf16-rounded
densities) 2^-7 of its size beside the bound, as chip_smoke.py holds it.
The reference runs under jax.default_matmul_precision("highest"): its CPU
default rounds float32 matmul operands to bfloat16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch import convert
from pointnerf2studio_torch.config import AggregatorConfig as TAggConfig
from pointnerf2studio_torch.models import aggregator as tagg
from pointnerf2studio_torch.ops import camera as tcam
from pointnerf2studio_torch.utils import spherical as tsph
from pointnerf2studio_tpu.config import AggregatorConfig
from pointnerf2studio_tpu.models import aggregator as jagg
from pointnerf2studio_tpu.ops import camera as jcam
from pointnerf2studio_tpu.utils import spherical as jsph

torch.set_num_threads(1)

KERNELS = ("linear", "numlinear", "quadric", "numquadric", "avg",
           "trilinear", "sh_intrp", "gau_intrp", "feat_intrp")
ATOL, MEAN_TOL, SIG_RTOL = 2e-2, 2e-3, 2.0 ** -7
VOX = 0.04          # grid_vox_sz: the sphere scene's scaled voxel edge
M, K = 48, 8


def inputs(seed=0, C=32):
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 0.5, (M, K, C)).astype(np.float32)
    dists = np.concatenate([rng.normal(0, 0.02, (M, K, 3)),
                            rng.normal(0, 0.05, (M, K, 3))],
                           -1).astype(np.float32)
    pm = rng.random((M, K)) < 0.7
    pm[0] = False                                   # a slot with no lane
    return emb, dists, pm


def params_pair(cfg, seed=0):
    """The reference's init for `cfg` and the same weights in the port."""
    jp = jagg.init_aggregator_params(jax.random.PRNGKey(seed), cfg)
    tp = convert.aggregator_from_jax(jax.tree.map(np.asarray, jp),
                                     TAggConfig(**dataclasses.asdict(cfg)),
                                     device="cpu")
    return jp, tp


def close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
    else:
        d = np.abs(got - want)
        assert d.max() <= ATOL * scale, d.max()
        assert d.mean() < MEAN_TOL * scale, d.mean()


def as_dtype(x, dtype):
    if dtype == "float32":
        return jnp.asarray(x), torch.as_tensor(x)
    return (jnp.asarray(x, jnp.bfloat16),
            torch.as_tensor(x).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KERNELS)
def test_weight_kernels_match(kind, dtype):
    cfg = AggregatorConfig(agg_distance_kernel=kind)
    tc = TAggConfig(**dataclasses.asdict(cfg))
    emb, dists, pm = inputs()
    je, te = as_dtype(emb, dtype)
    jd, td = as_dtype(dists, dtype)
    jp, tp = (params_pair(cfg) if kind == "feat_intrp" else (None, None))
    with jax.default_matmul_precision("highest"):
        w_j, e_j, n_j = jagg.raw_aggregation_weight(
            cfg, je, jd, jnp.asarray(pm), VOX, params=jp)
        a_j, ae_j = jagg.aggregation_weight(cfg, je, jd, jnp.asarray(pm),
                                            VOX, params=jp)
    w_t, e_t, n_t = tagg.raw_aggregation_weight(tc, te, td,
                                                torch.as_tensor(pm), VOX, tp)
    a_t, ae_t = tagg.aggregation_weight(tc, te, td, torch.as_tensor(pm),
                                        VOX, tp)
    assert n_t == n_j
    assert w_t.dtype == te.dtype and tuple(w_t.shape) == (M, K)
    np.testing.assert_array_equal(e_t.float().numpy(),
                                  np.asarray(e_j, np.float32))
    np.testing.assert_array_equal(ae_t.float().numpy(),
                                  np.asarray(ae_j, np.float32))
    close(w_t.float().numpy(), w_j, dtype)
    close(a_t.float().numpy(), a_j, dtype)
    w = a_t.float().numpy()
    assert np.all(w[~pm] == 0) and np.abs(w[pm]).sum() > 0
    if n_t == "norm":
        np.testing.assert_allclose(w[pm.any(-1)].sum(-1), 1.0,
                                   atol=1e-5 if dtype == "float32" else 3e-2)


def test_feat_intrp_gradients_match():
    """The learned weight is differentiable: the gradient of a weighted
    sum of the normalised weights into the feat_weight_mlp tower and the
    embedding, against jax.grad, float32 within rtol 1e-4 / atol 1e-7
    (a backward through three layers and the sum over K)."""
    cfg = AggregatorConfig(agg_distance_kernel="feat_intrp")
    tc = TAggConfig(**dataclasses.asdict(cfg))
    emb, dists, pm = inputs(1)
    coef = np.random.default_rng(2).normal(size=(M, K)).astype(np.float32)
    jp, tp = params_pair(cfg, seed=3)

    def f(p, e):
        w, _ = jagg.aggregation_weight(cfg, e, jnp.asarray(dists),
                                       jnp.asarray(pm), VOX, params=p)
        return jnp.sum(w * coef)

    with jax.default_matmul_precision("highest"):
        gp, ge = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(emb))
    tp.requires_grad_(True)
    te = torch.tensor(emb, requires_grad=True)
    w, _ = tagg.aggregation_weight(tc, te, torch.as_tensor(dists),
                                   torch.as_tensor(pm), VOX, tp)
    (w * torch.as_tensor(coef)).sum().backward()
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), rtol=1e-4,
                               atol=1e-7)
    for lin, want in zip(tp.feat_weight_mlp, gp["feat_weight_mlp"]):
        np.testing.assert_allclose(lin.weight.grad.numpy().T,
                                   np.asarray(want["kernel"]), rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(lin.bias.grad.numpy(),
                                   np.asarray(want["bias"]), rtol=1e-4,
                                   atol=1e-7)
    assert float(np.abs(te.grad.numpy()).sum()) > 0


def test_feat_intrp_needs_its_tower():
    tc = TAggConfig(agg_distance_kernel="feat_intrp")
    emb, dists, pm = (torch.as_tensor(x) for x in inputs())
    with pytest.raises(ValueError, match="feat_weight_mlp"):
        tagg.aggregation_weight(tc, emb, dists, pm, VOX, None)
    base = tagg.Aggregator(TAggConfig(), device="cpu")
    with pytest.raises(ValueError, match="feat_weight_mlp"):
        tagg.aggregation_weight(tc, emb, dists, pm, VOX, base)
    assert tagg.Aggregator(tc, device="cpu").towers[-1] == "feat_weight_mlp"


def test_sh_basis_and_local_frames_match():
    rng = np.random.default_rng(5)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for deg in range(1, 6):
        np.testing.assert_allclose(
            tsph.sh_basis(torch.as_tensor(d), deg).numpy(),
            np.asarray(jsph.sh_basis(jnp.asarray(d), deg)), rtol=1e-5,
            atol=1e-6)
    radii = rng.uniform(0.01, 0.1, (64, 3)).astype(np.float32)
    rot = rng.uniform(-0.7, 0.7, (64, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jcam.world2local_dist(jnp.asarray(d * 0.02),
                                     jnp.asarray(radii), jnp.asarray(rot))
    got = tcam.world2local_dist(torch.as_tensor(d * 0.02),
                                torch.as_tensor(radii), torch.as_tensor(rot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def rotations(n, seed):
    """n random rotation matrices [n, 3, 3] (QR of normal matrices)."""
    a = np.random.default_rng(seed).normal(size=(n, 3, 3))
    q, r = np.linalg.qr(a)
    return (q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
            ).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rw2c", ["global", "per-point"])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_decode_radiance_orders(order, rw2c, dtype):
    """(sigma, rgb) of decode_radiance against the reference: order 0
    (embeddings summed over K first; colour and direction modes off),
    orders 1 and 2, with a global Rw2c or one per neighbour [M, K, 3, 3]
    (the colour branch keeps the slot's own view encoding)."""
    extra = (dict(point_color_mode=False, point_dir_mode=False)
             if order == 0 else {})
    cfg = AggregatorConfig(agg_intrp_order=order, compute_dtype=dtype,
                           **extra)
    tc = TAggConfig(**dataclasses.asdict(cfg))
    emb, dists, pm = inputs(4)
    rng = np.random.default_rng(6)
    color = rng.random((M, K, 3)).astype(np.float32)
    ndir = rng.normal(size=(M, K, 3)).astype(np.float32)
    vd = rng.normal(size=(M, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    rot = (rotations(M * K, 7).reshape(M, K, 3, 3) if rw2c == "per-point"
           else rotations(1, 7)[0])
    jp, tp = params_pair(cfg, seed=order)
    jp["density_head"][0]["bias"] = jp["density_head"][0]["bias"] + 2.0
    with torch.no_grad():
        tp.density_head[0].bias += 2.0
    w_np = np.asarray(jagg.aggregation_weight(
        cfg, jnp.asarray(emb), jnp.asarray(dists), jnp.asarray(pm), VOX)[0])
    args = (emb, color, ndir, dists, w_np, pm, vd, rot)
    with jax.default_matmul_precision("highest"):
        sig_j, rgb_j = jagg.decode_radiance(
            jp, cfg, *(jnp.asarray(a) for a in args))
    sig_t, rgb_t = tagg.decode_radiance(
        tp, tc, *(torch.as_tensor(a) for a in args))
    sig_j, rgb_j = np.asarray(sig_j), np.asarray(rgb_j)
    assert sig_t.shape == (M,) and rgb_t.shape == (M, 3)
    assert float(np.abs(sig_j).max()) > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(sig_t.numpy(), sig_j, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(rgb_t.numpy(), rgb_j, rtol=1e-5,
                                   atol=1e-6)
    else:
        d = np.abs(sig_t.numpy() - sig_j)
        assert np.all(d <= ATOL + SIG_RTOL * np.abs(sig_j)), d.max()
        close(rgb_t.numpy(), rgb_j, dtype)


def test_order0_refuses_point_modes():
    tc = TAggConfig(agg_intrp_order=0)
    emb, dists, pm = (torch.as_tensor(x) for x in inputs())
    with pytest.raises(ValueError, match="agg_intrp_order=0"):
        tagg.decode_radiance(
            tagg.Aggregator(dataclasses.replace(
                tc, point_color_mode=False, point_dir_mode=False),
                device="cpu"),
            tc, emb, torch.zeros(M, K, 3), torch.zeros(M, K, 3), dists,
            torch.ones(M, K), pm, torch.zeros(M, 3), torch.eye(3))
