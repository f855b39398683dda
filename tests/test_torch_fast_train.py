"""The port's differentiable fast train path (models/fast_train.py)
against the JAX reference on the same numpy inputs: a sphere scene of
4,000 points (sr 16, D 48, slot budget 16, compact budget 8, as
tests/test_fast_train.py), 16x16 rays, jitter draws injected
(`jitter_u`) so both packages sample the same positions.

Tolerances, each stated where it is used:
  * the geometry cache: meta and rel exact, with and without cand_prune;
  * selections, masks and counters: exact (ray_mask, pnt_mask);
  * forward at training=False, float32: colour and acc within 2e-3;
  * one step at float32 under jax.default_matmul_precision("highest"):
    loss rtol 1e-4, every gradient leaf rtol 2e-3 / atol 1e-6, the bound
    the reference holds its own two train paths to
    (tests/test_fast_train.py:84-87);
  * one step at bfloat16: each leaf's relative L2 error (see BF16_REL_L2);
  * the port against itself, bit for bit: ray packing against the
    unpacked step, the march front-end against the dense one, loss and
    gradients.

The reference runs its chunk body under jit, where XLA:CPU may contract
campos + rd * t and the voxel centre into fused multiply-adds; a sample
within an ulp of a voxel face could then fall into another voxel there.
No sample of these inputs does: every comparison is over all rays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.models import aggregator as tagg
from pointnerf2studio_torch.models import fast_render as tfr
from pointnerf2studio_torch.models import fast_train as tft
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops import compositing as tcomp
from pointnerf2studio_torch.train.loss import compute_losses as tloss
from pointnerf2studio_torch.train.trainer import create_train_state
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.models import aggregator as jagg
from pointnerf2studio_tpu.models import fast_train as jft
from pointnerf2studio_tpu.ops import compositing as jcomp
from pointnerf2studio_tpu.train.loss import compute_losses as jloss

torch.set_num_threads(1)

# relative L2 error of each gradient leaf at bf16 compute: the two
# packages round the same bf16 operands but sum their products in other
# orders (XLA:CPU's order also varies from run to run), one flipped bf16
# rounding moves a value by 2^-8 of itself, and the point attributes'
# gradients pass through the sin/cos of PE(emb) at frequencies up to 2^5.
# Measured on these inputs in three runs: the point attributes 3.6e-2 to
# 5.7e-2 (points_embeding, points_dir, points_color), the tower's leaves
# 1.4e-3 to 2.4e-2; the bound leaves a factor of 2.6 over the largest
BF16_REL_L2 = 0.15


def T(a):
    return torch.as_tensor(np.array(a))


def port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)),
        train=tcfg.TrainConfig(**dataclasses.asdict(cfg.train)))


def with_query(cfg, **kw):
    return dataclasses.replace(cfg, query=dataclasses.replace(cfg.query,
                                                              **kw))


@pytest.fixture(scope="module")
def s():
    cfg = with_query(sphere_config(sr=16, d=48), ray_slot_budget=16,
                     compact_budget=8)
    scene = make_sphere_scene(n_points=4000, cfg=cfg)
    geo, rmin, svs = jft.make_geo_scene(cfg, scene.cloud, scene.grid)
    rays = np.asarray(camera_rays(scene.campos, scene.camrotc2w, 16, 16,
                                  12.0))
    R, D = rays.shape[0], cfg.query.z_depth_dim
    rng = np.random.default_rng(0)
    pc = port_cfg(cfg)
    return dict(
        cfg=cfg, pc=pc, scene=scene, geo=geo, rmin=rmin, svs=svs,
        rays=rays, u=rng.random((R, D)).astype(np.float32),
        gt=rng.random((R, 3)).astype(np.float32),
        tgeo=convert.geo_cache_from_jax(geo, device="cpu"),
        grid=convert.grid_from_jax(scene.grid, device="cpu"),
        cloud=convert.cloud_from_jax(scene.cloud, device="cpu"),
        params=convert.aggregator_from_jax(
            jax.tree.map(np.asarray, scene.params), pc.agg, device="cpu"),
        cam=(T(scene.campos), T(scene.camrotc2w)), tr=(T(rmin), T(svs)))


def port_render(s, cfg, state=None, geo=None, rays=None, training=True,
                u=True):
    p = state.params if state else s["params"]
    pts = state.points if state else s["cloud"]
    return tft.fast_train_render(
        p, pts, s["tgeo"] if geo is None else geo, *s["cam"],
        T(s["rays"] if rays is None else rays), s["scene"].near,
        s["scene"].far, cfg, *s["tr"], training=training,
        jitter_u=T(s["u"]) if u else None)


def port_step(s, cfg, geo=None, rays=None, gt=None):
    """One forward and backward of the port: (loss, out, state)."""
    st = create_train_state(s["params"], s["cloud"], cfg)
    out = port_render(s, cfg, st, geo=geo, rays=rays)
    total, _ = tloss(out, T(s["gt"] if gt is None else gt), cfg.train)
    total.backward()
    return total, out, st


def port_grads(st):
    """Every gradient leaf: the tower in the JAX tree's layout, then the
    trainable point attributes."""
    tree = convert.aggregator_to_jax(st.params, grad=True)
    leaves = [(f"{name}[{i}].{k}", lyr[k]) for name in tagg.TOWERS
              for i, lyr in enumerate(tree[name]) for k in ("kernel", "bias")]
    return leaves + [(k, v.grad.numpy())
                     for k, v in st.points.trainable().items()]


def jax_grads(gp, gt):
    leaves = [(f"{name}[{i}].{k}", np.asarray(lyr[k]))
              for name in tagg.TOWERS for i, lyr in enumerate(gp[name])
              for k in ("kernel", "bias")]
    return leaves + [(k, np.asarray(gt[k])) for k in
                     ("points_embeding", "points_conf", "points_dir",
                      "points_color")]


def jax_step(s, cfg):
    """The reference's loss, render output and gradients for one step."""
    sc = s["scene"]

    def loss(p, pt):
        out = jft.fast_train_render(
            p, sc.cloud.with_trainable(pt), s["geo"], sc.campos,
            sc.camrotc2w, jnp.asarray(s["rays"]), sc.near, sc.far, cfg,
            s["rmin"], s["svs"], training=True, jitter_u=jnp.asarray(s["u"]))
        return jloss(out, jnp.asarray(s["gt"]), cfg.train)[0], out

    (l, out), (gp, gt) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(sc.params, sc.cloud.trainable())
    return float(l), out, jax_grads(gp, gt)


@pytest.mark.parametrize("prune", [False, True])
def test_geo_cache_matches(s, prune):
    """The port's geometry cache equals the reference's: the qslot table,
    meta (ids, shells, candidate order) and rel exactly; with cand_prune
    the same trimmed width too."""
    if prune:
        cfg = with_query(s["cfg"], cand_prune=True)
        want, _, _ = jft.make_geo_scene(cfg, s["scene"].cloud,
                                        s["scene"].grid)
        got, _, _ = tft.make_geo_scene(port_cfg(cfg), s["cloud"], s["grid"])
        assert got.cand < s["tgeo"].cand
    else:
        want = s["geo"]
        got = tft.build_geo_cache(s["grid"], s["cloud"].xyz,
                                  s["cfg"].query.kernel_size,
                                  s["tgeo"].meta.shape[0],
                                  s["cfg"].query.cand_cap)
    want = convert.geo_cache_from_jax(want, device="cpu")
    assert got.cand == want.cand
    assert torch.equal(got.coor_2_qslot, want.coor_2_qslot)
    assert torch.equal(got.meta, want.meta)
    assert torch.equal(got.rel, want.rel)
    assert int(got.n_q) == int(want.n_q) and int((got.meta >= 0).sum()) > 0


def test_forward_matches(s):
    """training=False (no jitter, no clamp): ray_mask exact, colour and
    acc within 2e-3 on every ray."""
    sc, cfg = s["scene"], s["cfg"]
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p: jft.fast_train_render(
            p, sc.cloud, s["geo"], sc.campos, sc.camrotc2w,
            jnp.asarray(s["rays"]), sc.near, sc.far, cfg, s["rmin"],
            s["svs"], training=False))(sc.params)
    with torch.no_grad():
        got = port_render(s, s["pc"], training=False, u=False)
    np.testing.assert_array_equal(got.ray_mask.numpy(),
                                  np.asarray(want.ray_mask))
    np.testing.assert_array_equal(got.pnt_mask.numpy(),
                                  np.asarray(want.pnt_mask))
    assert 0.1 < float(got.ray_mask.float().mean()) < 0.9
    np.testing.assert_allclose(got.coarse_raycolor.numpy(),
                               np.asarray(want.coarse_raycolor), atol=2e-3)
    np.testing.assert_allclose(got.acc.numpy(), np.asarray(want.acc),
                               atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_loss_and_grads_match(s, dtype):
    """One step with the same jitter draws: masks exact; at float32 the
    loss within rtol 1e-4 and every gradient leaf within rtol 2e-3 / atol
    1e-6; at bfloat16 each leaf within BF16_REL_L2 in relative L2."""
    cfg = dataclasses.replace(s["cfg"], agg=dataclasses.replace(
        s["cfg"].agg, compute_dtype=dtype))
    with jax.default_matmul_precision("highest"):
        l_j, out_j, g_j = jax_step(s, cfg)
    l_t, out_t, st = port_step(s, port_cfg(cfg))
    np.testing.assert_array_equal(out_t.ray_mask.numpy(),
                                  np.asarray(out_j.ray_mask))
    np.testing.assert_array_equal(out_t.pnt_mask.numpy(),
                                  np.asarray(out_j.pnt_mask))
    g_t = port_grads(st)
    assert [n for n, _ in g_t] == [n for n, _ in g_j]
    if dtype == "float32":
        np.testing.assert_allclose(float(l_t.detach()), l_j, rtol=1e-4)
        for (name, a), (_, b) in zip(g_t, g_j):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-6,
                                       err_msg=name)
    else:
        # measured 6.6e-4
        np.testing.assert_allclose(float(l_t.detach()), l_j, rtol=1e-2)
        for (name, a), (_, b) in zip(g_t, g_j):
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel < BF16_REL_L2, (name, rel)
    assert float(np.abs(g_t[-4][1]).sum()) > 0      # points_embeding


def wide_rays(s, ray0):
    """16x16 rays of a wide field of view (some miss the grid), with the
    centre ray, which crosses the sphere, moved to row 0 when `ray0` is
    "hit"."""
    rays = np.asarray(camera_rays(s["scene"].campos, s["scene"].camrotc2w,
                                  16, 16, 6.0))
    pc = s["pc"]
    hit = tfr.slab_hit_mask(
        s["cam"][0], rays, s["scene"].near, s["scene"].far,
        pc.query.z_depth_dim, s["tr"][0], s["tgeo"].coor_2_qslot.shape,
        s["tr"][1], jitter=pc.train.jitter)
    if ray0 == "hit":
        first = 8 * 16 + 8
        order = np.r_[first, np.delete(np.arange(len(rays)), first)]
        rays, hit = rays[order], hit[order]
    assert 0 < int(hit.sum()) < rays.shape[0]
    assert bool(hit[0]) == (ray0 == "hit")
    return rays, int(hit.sum())


@pytest.mark.parametrize("ray0", ["miss", "hit"])
def test_ray_budget_packing_exact(s, ray0):
    """QueryConfig.ray_budget: the packed step equals the unpacked one
    bit for bit, forward and gradients, with rb_overflow 0 at a budget
    that holds the hitting rays, and counts the rays past a short one.
    The padding rows repeat ray 0; where ray 0 hits they take no slots
    (the reference lets them: test_reference_packing_counts_padding)."""
    rays, hits = wide_rays(s, ray0)
    pc = s["pc"]
    cfg_rb = with_query(pc, ray_budget=(hits + 15) // 16 * 16)
    assert cfg_rb.query.ray_budget > hits
    l0, o0, st0 = port_step(s, pc, rays=rays)
    l1, o1, st1 = port_step(s, cfg_rb, rays=rays)
    assert bool(o0.ray_mask[0]) == (ray0 == "hit")
    assert int(o1.rb_overflow) == 0 and o0.rb_overflow is None
    for f in ("coarse_raycolor", "ray_mask", "acc", "depth"):
        assert torch.equal(getattr(o0, f), getattr(o1, f)), f
    assert torch.equal(o0.pnt_mask.sum(), o1.pnt_mask.sum())
    assert float(l0) == float(l1)
    for (name, a), (_, b) in zip(port_grads(st0), port_grads(st1)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    with torch.no_grad():
        short = port_render(s, with_query(pc, ray_budget=hits - 8),
                            rays=rays)
    assert int(short.rb_overflow) == 8


def test_reference_packing_counts_padding(s):
    """The reference's packed dense step gives its padding rows (copies of
    ray 0) slots when ray 0 hits, so the neighbours its per-slot loss terms
    average over differ from its unpacked step's; the port's equal the
    unpacked ones (ROADMAP section 3)."""
    rays, hits = wide_rays(s, "hit")
    sc, cfg = s["scene"], s["cfg"]
    budget = (hits + 15) // 16 * 16

    def ref(rb):
        c = with_query(cfg, ray_budget=rb)
        out = jax.jit(lambda p: jft.fast_train_render(
            p, sc.cloud, s["geo"], sc.campos, sc.camrotc2w,
            jnp.asarray(rays), sc.near, sc.far, c, s["rmin"], s["svs"],
            training=True, jitter_u=jnp.asarray(s["u"])))(sc.params)
        return int(np.asarray(out.pnt_mask).sum())

    # measured: 870 unpacked, 1,434 packed (12 padding rows)
    n0, n1 = ref(0), ref(budget)
    assert n1 > n0
    with torch.no_grad():
        got = [port_render(s, with_query(s["pc"], ray_budget=rb), rays=rays)
               for rb in (0, budget)]
    assert int(got[0].pnt_mask.sum()) == int(got[1].pnt_mask.sum()) == n0


def test_march_equals_dense(s):
    """The jitter-aware march front-end (one stage of D + 8 steps, and
    three stages with buckets) against the dense lookup: mc_overflow 0,
    loss, outputs and gradients bit for bit; the plain walk ran, no
    kernel launched."""
    pc = s["pc"]
    D = pc.query.z_depth_dim
    l0, o0, st0 = port_step(s, pc)
    for steps, buckets in (((D + 8,), ()), ((D // 4, D // 4, D), (192, 96))):
        cfg_m = with_query(pc, march_steps=steps, march_buckets=buckets)
        geo_m, _, _ = tft.make_geo_scene(cfg_m, s["cloud"], s["grid"],
                                         max_q=s["tgeo"].meta.shape[0])
        assert geo_m.march_table is not None
        n0 = sum(_cuda.LAUNCHES.values())
        l1, o1, st1 = port_step(s, cfg_m, geo=geo_m)
        assert sum(_cuda.LAUNCHES.values()) == n0
        assert int(o1.mc_overflow) == 0 and o0.mc_overflow is None
        for f in ("coarse_raycolor", "ray_mask", "acc", "depth",
                  "pnt_mask"):
            assert torch.equal(getattr(o0, f), getattr(o1, f)), f
        assert float(l0) == float(l1)
        for (name, a), (_, b) in zip(port_grads(st0), port_grads(st1)):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_conf_gradient_clamp_matches():
    """Forward clip(conf, 1e-4, 1) and a gradient of 1 everywhere, inside
    the range and outside it, as the reference's expression gives."""
    conf = np.array([-0.5, 0.0, 5e-5, 0.3, 0.9999, 1.0, 1.7], np.float32)
    w = np.arange(1, 8, dtype=np.float32)
    want, g_want = jax.value_and_grad(
        lambda c: jnp.sum(jagg.conf_gradient_clamp(c) * w))(jnp.asarray(conf))
    want_c = jagg.conf_gradient_clamp(jnp.asarray(conf))
    c = torch.tensor(conf, requires_grad=True)
    out = tagg.conf_gradient_clamp(c)
    (out * torch.as_tensor(w)).sum().backward()
    # the expression's forward is clip(conf) up to the rounding of
    # conf - (conf - clip(conf)), in both packages alike
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want_c))
    np.testing.assert_allclose(out.detach().numpy(), np.clip(conf, 1e-4, 1),
                               rtol=0, atol=1e-7)
    assert float((out * torch.as_tensor(w)).sum().detach()) == pytest.approx(
        float(want), rel=1e-6)
    np.testing.assert_array_equal(c.grad.numpy(), np.asarray(g_want))
    np.testing.assert_array_equal(c.grad.numpy(), w)


def test_packed_composite_gradients_match():
    """The port's composite (an [R, BP] grid with cummax / cumprod rows)
    against the reference's segmented scans: outputs within 1e-6 and the
    gradients of sigma and rgb within rtol 1e-4 / atol 1e-6."""
    rng = np.random.default_rng(4)
    R, BP = 24, 6
    cnt = rng.integers(0, BP + 1, R)
    cnt[3] = 0
    M = int(cnt.sum()) + 5                          # a masked tail
    sel_ray = np.minimum(np.repeat(np.arange(R), cnt).tolist()
                         + [R - 1] * 5, R - 1).astype(np.int32)
    z = np.concatenate([np.sort(rng.uniform(2, 3, c)) for c in cnt]
                       + [np.zeros(5)]).astype(np.float32)
    ok = np.arange(M) < cnt.sum()
    ok[rng.random(M) < 0.1] = False
    sig = (rng.uniform(0, 40, M) * ok).astype(np.float32)
    rgb = rng.uniform(0, 1, (M, 3)).astype(np.float32)
    pack_end = np.cumsum(cnt).astype(np.int32)
    wr = rng.normal(size=(R, 3)).astype(np.float32)
    wa = rng.normal(size=R).astype(np.float32)

    def jfun(sig_, rgb_):
        c, a, d, f = jcomp.packed_alpha_composite(
            sig_, rgb_, jnp.asarray(z), jnp.asarray(ok), jnp.asarray(sel_ray),
            jnp.asarray(pack_end), jnp.asarray(cnt), 0.01, "alpha")
        return jnp.sum(c * wr) + jnp.sum(a * wa) + jnp.sum(d), (c, a, d, f)

    (_, want), g_want = jax.jit(jax.value_and_grad(jfun, argnums=(0, 1),
                                                   has_aux=True))(
        jnp.asarray(sig), jnp.asarray(rgb))
    ts, tr = T(sig).requires_grad_(), T(rgb).requires_grad_()
    got = tcomp.packed_alpha_composite(
        ts, tr, T(z), T(ok), T(sel_ray), T(pack_end), T(cnt), 0.01, "alpha",
        max_slots=BP)
    ((got[0] * T(wr)).sum() + (got[1] * T(wa)).sum()
     + got[2].sum()).backward()
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for a, b in ((ts.grad, g_want[0]), (tr.grad, g_want[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_gather_rows_backward():
    """The attribute gather's backward (sort, float64 prefix sums, one
    write a row) equals an index_put_ accumulate in float64 to within one
    float32 rounding of each row's sum, rows no index names get 0, and two
    runs agree bit for bit."""
    rng = np.random.default_rng(5)
    table = torch.tensor(rng.normal(size=(400, 39)).astype(np.float32),
                         requires_grad=True)
    idx = torch.as_tensor(np.minimum(rng.geometric(0.02, 5000), 300) - 1)
    g = torch.as_tensor(rng.normal(size=(5000, 39)).astype(np.float32))
    grads = []
    for _ in range(2):
        table.grad = None
        out = tft.gather_rows(table, idx)
        assert torch.equal(out, table[idx])
        (out * g).sum().backward()
        grads.append(table.grad.clone())
    assert torch.equal(grads[0], grads[1])
    want = torch.zeros(400, 39, dtype=torch.float64).index_put_(
        (idx,), g.double(), accumulate=True)
    np.testing.assert_allclose(grads[0].numpy(), want.numpy(), rtol=2e-7,
                               atol=1e-6)
    assert not grads[0][300:].any()
