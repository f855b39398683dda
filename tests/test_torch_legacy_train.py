"""The port's legacy train step (train/trainer.make_train_step, through
models/render.render_rays(training=True) on the grid's candidate cache)
against the JAX reference, on the CPU: a sphere scene of 4,000 points
(sr 16, D 48, slot budget 16, compact budget 8, as tests/test_fast_train.py),
16x16 rays, float32 compute, jitter 0.3 with the draws injected
(`jitter_u`; the reference's render_rays draws from a key, so its ray
generation is handed the same draws for the length of one trace).

  * one step's loss within rtol 1e-4 and every gradient leaf within rtol
    2e-3 / atol 1e-6 of jax.value_and_grad of the reference's
    render_rays(training=True) + compute_losses (the bound the reference
    holds its two train paths to, tests/test_fast_train.py:84-87), masks
    exact; the step run twice is bit-equal;
  * the port's legacy step against the port's fast step
    (models/fast_train.make_fast_train_step, no ray packing) to the same
    bound;
  * alter_step: the group that sits a phase out keeps its parameters and
    its Adam moments bit for bit;
  * fit(fast_path=False) on the CPU cuts a constant-colour loss within 20
    steps.

The reference's side is computed once per module (one jit of the loss and
its gradient, not of the jitted train step, which took 90 s to compile)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.data import blender as tblender
from pointnerf2studio_torch.models import aggregator as tagg
from pointnerf2studio_torch.models import fast_train as tft
from pointnerf2studio_torch.models import render as trender
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.train import loop as tloop
from pointnerf2studio_torch.train import trainer as ttrainer
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.models import render as jrender
from pointnerf2studio_tpu.train.loss import compute_losses as jloss

torch.set_num_threads(1)

COLOUR = (0.8, 0.3, 0.1)


def T(a):
    return torch.as_tensor(np.array(a))


def port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)),
        train=tcfg.TrainConfig(**dataclasses.asdict(cfg.train)))


def jax_grads(gp, gt):
    return ([(f"{n}[{i}].{k}", np.asarray(lyr[k])) for n in tagg.TOWERS
             for i, lyr in enumerate(gp[n]) for k in ("kernel", "bias")]
            + [(k, np.asarray(gt[k])) for k in
               ("points_embeding", "points_conf", "points_dir",
                "points_color")])


def port_grads(st):
    tree = convert.aggregator_to_jax(st.params, grad=True)
    return ([(f"{n}[{i}].{k}", lyr[k]) for n in tagg.TOWERS
             for i, lyr in enumerate(tree[n]) for k in ("kernel", "bias")]
            + [(k, v.grad.numpy()) for k, v in
               st.points.trainable().items()])


@pytest.fixture(scope="module")
def s():
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(
        cfg, query=dataclasses.replace(cfg.query, ray_slot_budget=16,
                                       compact_budget=8, max_q=32768),
        agg=dataclasses.replace(cfg.agg, compute_dtype="float32"))
    scene = make_sphere_scene(n_points=4000, cfg=cfg)
    assert scene.grid.cache is not None
    rays = np.asarray(camera_rays(scene.campos, scene.camrotc2w, 16, 16,
                                  12.0))
    R, D = rays.shape[0], cfg.query.z_depth_dim
    rng = np.random.default_rng(0)
    u = rng.random((R, D)).astype(np.float32)
    gt = rng.random((R, 3)).astype(np.float32)

    orig = jrender.near_far_linear_ray_generation

    def raygen(*a, **k):
        return orig(*a, **{**k, "jitter_u": jnp.asarray(u)})

    def loss(p, pt):
        out = jrender.render_rays(
            p, scene.cloud.with_trainable(pt), scene.grid, scene.campos,
            scene.camrotc2w, jnp.asarray(rays), scene.near, scene.far, cfg,
            training=True)
        return jloss(out, jnp.asarray(gt), cfg.train)[0], out

    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision("highest"):
        mp.setattr(jrender, "near_far_linear_ray_generation", raygen)
        (l_j, out_j), (gp, gpt) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(scene.params,
                                                 scene.cloud.trainable())
    pc = port_cfg(cfg)
    return dict(
        cfg=cfg, pc=pc, scene=scene, rays=rays, u=u, gt=gt,
        want=dict(loss=float(l_j), ray_mask=np.asarray(out_j.ray_mask),
                  pnt_mask=np.asarray(out_j.pnt_mask),
                  grads=jax_grads(gp, gpt)),
        grid=convert.grid_from_jax(scene.grid, device="cpu"),
        cloud=convert.cloud_from_jax(scene.cloud, device="cpu"),
        params=convert.aggregator_from_jax(
            jax.tree.map(np.asarray, scene.params), pc.agg, device="cpu"),
        cam=(T(scene.campos), T(scene.camrotc2w)))


def legacy_step(s, cfg=None, state=None, gt=None):
    cfg = cfg or s["pc"]
    st = state or ttrainer.create_train_state(s["params"], s["cloud"], cfg)
    st, aux = ttrainer.make_train_step(cfg)(
        st, s["grid"], *s["cam"], T(s["rays"]),
        T(s["gt"] if gt is None else gt), s["scene"].near, s["scene"].far,
        jitter_u=T(s["u"]))
    return st, aux


def train_render(s):
    return trender.render_rays(s["params"], s["cloud"], s["grid"],
                               *s["cam"], T(s["rays"]), s["scene"].near,
                               s["scene"].far, s["pc"], training=True,
                               jitter_u=T(s["u"]))


def test_step_matches_reference(s):
    """One legacy step of the port: its loss and gradients against the
    reference's, the render's masks exactly, and bit-equal when run
    again; the kernel-free CPU route launches nothing."""
    w = s["want"]
    with torch.no_grad():
        out = train_render(s)
    np.testing.assert_array_equal(out.ray_mask.numpy(), w["ray_mask"])
    np.testing.assert_array_equal(out.pnt_mask.numpy(), w["pnt_mask"])
    assert 0.1 < float(out.ray_mask.float().mean()) < 0.9
    _cuda.LAUNCHES.clear()
    st, aux = legacy_step(s)
    assert sum(_cuda.LAUNCHES.values()) == 0
    np.testing.assert_allclose(float(aux["total"]), w["loss"], rtol=1e-4)
    g = port_grads(st)
    assert [n for n, _ in g] == [n for n, _ in w["grads"]]
    for (name, a), (_, b) in zip(g, w["grads"]):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-6, err_msg=name)
    assert float(np.abs(g[-4][1]).sum()) > 0          # points_embeding
    assert st.step == 1
    st2, aux2 = legacy_step(s)
    assert float(aux2["total"]) == float(aux["total"])
    for (name, a), (_, b) in zip(port_grads(st2), g):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_legacy_step_matches_fast_step(s):
    """The port's legacy step (candidate cache, [R, D] composite) and its
    fast step (geometry cache, packed composite) on the same batch and
    jitter: loss within rtol 1e-4, gradients within rtol 2e-3 / atol
    1e-6 (the contract of tests/test_fast_train.py:50-90)."""
    pc = s["pc"]
    st_l, aux_l = legacy_step(s)
    geo, rmin, svs = tft.make_geo_scene(pc, s["cloud"], s["grid"])
    st_f = ttrainer.create_train_state(s["params"], s["cloud"], pc)
    st_f, aux_f = tft.make_fast_train_step(pc)(
        st_f, geo, rmin, svs, *s["cam"], T(s["rays"]), T(s["gt"]),
        s["scene"].near, s["scene"].far, jitter_u=T(s["u"]))
    np.testing.assert_allclose(float(aux_l["total"]),
                               float(aux_f["total"]), rtol=1e-4)
    for (name, a), (_, b) in zip(port_grads(st_l), port_grads(st_f)):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-6, err_msg=name)


def test_alter_step_phases(s):
    """alter_step=1: step 0 updates the fields only, step 1 the points
    only; the group sitting out keeps its parameters and Adam moments bit
    for bit, and its learning rate."""
    pc = dataclasses.replace(s["pc"], train=dataclasses.replace(
        s["pc"].train, alter_step=1))
    st = ttrainer.create_train_state(s["params"], s["cloud"], pc)
    groups = (list(st.params.parameters()),
              list(st.points.trainable().values()))
    opts = (st.opt_fields, st.opt_points)

    def snap(k):
        return ([p.detach().clone() for p in groups[k]],
                [{n: v.clone() for n, v in opts[k].state.get(p, {}).items()}
                 for p in groups[k]])

    for phase in (0, 1, 0, 1):
        idle = 1 - phase
        before, before_idle = snap(phase), snap(idle)
        lr_idle = opts[idle].param_groups[0]["lr"]
        st, _ = legacy_step(s, pc, st)
        now, now_idle = snap(phase), snap(idle)
        assert any(not torch.equal(a, b) for a, b in zip(now[0], before[0]))
        for a, b in zip(now_idle[0], before_idle[0]):
            assert torch.equal(a, b)
        for a, b in zip(now_idle[1], before_idle[1]):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[n], b[n]) for n in a)
        assert opts[idle].param_groups[0]["lr"] == lr_idle
    assert st.step == 4
    assert all(len(opts[k].state) == len(groups[k]) for k in (0, 1))


def test_fit_legacy_cuts_the_loss(s, tmp_path):
    """fit(fast_path=False) on the CPU: the grid is built with its
    candidate cache, 20 legacy steps on one constant colour seen by two
    cameras, and the loss of the last 5 steps is below half of the
    first 5's."""
    pc = dataclasses.replace(s["pc"], train=dataclasses.replace(
        s["pc"].train, fast_path=False, rays_per_batch=128,
        device_sampling=True))
    campos, camrot = np.asarray(s["scene"].campos), np.asarray(
        s["scene"].camrotc2w)
    side = np.array([[0, 0, -1], [0, -1, 0], [-1, 0, 0]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[0, :3, :3], poses[0, :3, 3] = camrot, campos
    poses[1, :3, :3], poses[1, :3, 3] = side, (2.0, 0.0, 0.0)
    ds = tblender.BlenderDataset(
        images=np.broadcast_to(np.asarray(COLOUR, np.float32),
                               (2, 16, 16, 3)).copy(),
        poses=poses, intrinsics=np.array(
            [[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32),
        near=s["scene"].near, far=s["scene"].far, split="train")
    res = tloop.fit(pc, ds, s["params"], s["cloud"], str(tmp_path),
                    max_steps=20, print_freq=5, seed=1, device="cpu")
    totals = [r["total"] for r in res.log]
    assert len(totals) == 4 and res.state.step == 20
    assert totals[-1] < 0.5 * totals[0], totals
    assert not s["params"].mlp_base[0].weight.requires_grad


def test_reference_routes_differ_at_short_steps():
    """The reference's legacy render and its fast path composite a sample
    that a hole follows (a sample of the ray not selected, or one without
    neighbours) with other step lengths: the legacy [R, D] cummax gives it
    vsize_z (its next entry repeats its z), the packed composite the gap
    to the next selected sample. Both clamp a step beyond 2 vsize_z to
    vsize_z, so they agree while a sample step is at least vsize_z (D 48
    on the sphere, tests/test_fast_train.py) and differ below it: here D
    120 (sphere_config's own default), a step of 0.0167 against vsize_z
    0.02. Selections agree exactly; colour differs beyond the 2e-3 the
    reference holds its two routes to. The port's two routes differ the
    same way (each is held to its reference route elsewhere)."""
    from pointnerf2studio_tpu.models import fast_train as jft
    cfg = sphere_config(sr=16, d=120)
    cfg = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, ray_slot_budget=16, compact_budget=8, use_cache=False),
        agg=dataclasses.replace(cfg.agg, compute_dtype="float32"))
    sc = make_sphere_scene(n_points=600, cfg=cfg)
    rays = camera_rays(sc.campos, sc.camrotc2w, 12, 12, 9.0)
    geo, rmin, svs = jft.make_geo_scene(cfg, sc.cloud, sc.grid)
    with jax.default_matmul_precision("highest"):
        legacy = jrender.render_rays_jit(sc.params, sc.cloud, sc.grid,
                                         sc.campos, sc.camrotc2w, rays,
                                         sc.near, sc.far, cfg)
        fast = jax.jit(lambda p: jft.fast_train_render(
            p, sc.cloud, geo, sc.campos, sc.camrotc2w, rays, sc.near,
            sc.far, cfg, rmin, svs, training=False))(sc.params)
    np.testing.assert_array_equal(np.asarray(legacy.ray_mask),
                                  np.asarray(fast.ray_mask))
    np.testing.assert_array_equal(np.asarray(legacy.pnt_mask).sum(),
                                  np.asarray(fast.pnt_mask).sum())
    want = float(np.abs(np.asarray(legacy.coarse_raycolor)
                        - np.asarray(fast.coarse_raycolor)).max())
    assert want > 2e-3, want

    pc = port_cfg(cfg)
    params = convert.aggregator_from_jax(
        jax.tree.map(np.asarray, sc.params), pc.agg, device="cpu")
    cloud = convert.cloud_from_jax(sc.cloud, device="cpu")
    grid = convert.grid_from_jax(sc.grid, device="cpu")
    tgeo, trmin, tsvs = tft.make_geo_scene(pc, cloud, grid)
    cam = (T(sc.campos), T(sc.camrotc2w))
    with torch.no_grad():
        a = trender.render_rays(params, cloud, grid, *cam, T(rays), sc.near,
                                sc.far, pc)
        b = tft.fast_train_render(params, cloud, tgeo, *cam, T(rays),
                                  sc.near, sc.far, pc, trmin, tsvs,
                                  training=False)
    assert torch.equal(a.ray_mask, b.ray_mask)
    got = float((a.coarse_raycolor - b.coarse_raycolor).abs().max())
    assert abs(got - want) < 1e-4, (got, want)
