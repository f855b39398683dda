"""The port's optimizers and fit() loop (train/trainer.py, train/loop.py)
against the JAX reference, on the CPU.

  * the two Adam groups, their exponential decay and alter_step against
    optax (the reference's make_optimizers and its alternation) over a
    few updates of the same gradients: parameters and moments within
    rtol 1e-5 / atol 1e-8 (float32 Adam arithmetic in another order);
  * an 8-step loss trajectory of the port's fit() against the reference's
    fast train step on the same host-sampled batches (device_sampling
    False, jitter 0, the numpy PixelSampler of the same seed: what the
    reference's fit() does on that route, train/loop.py:392-412), within
    rtol 5e-2 / atol 1e-3, the bound tests/test_fast_train.py:118 holds
    the reference's own two train paths to;
  * every part of fit() and fast_train_render that is not ported raises
    NotImplementedError naming its ROADMAP item, and fit() with no device
    raises without a card. (The legacy step behind fit(fast_path=False)
    is held to the reference in tests/test_torch_legacy_train.py.)"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.data import blender as tblender
from pointnerf2studio_torch.models import fast_train as tft
from pointnerf2studio_torch.train import loop as tloop
from pointnerf2studio_torch.train import trainer as ttrainer
from pointnerf2studio_tpu.data import blender as jblender
from pointnerf2studio_tpu.data.synthetic import make_sphere_scene, sphere_config
from pointnerf2studio_tpu.models import fast_train as jft
from pointnerf2studio_tpu.train import trainer as jtrainer

torch.set_num_threads(1)

COLOUR = (0.8, 0.3, 0.1)
H = W = 16
FOCAL = 20.0


def port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)),
        train=tcfg.TrainConfig(**dataclasses.asdict(cfg.train)))


def with_train(cfg, **kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **kw))


def two_view_arrays(campos, camrot):
    """Two 16x16 views of one constant colour: the scene's camera and one
    on the +x axis looking back at the origin."""
    side = np.array([[0, 0, -1], [0, -1, 0], [-1, 0, 0]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[0, :3, :3], poses[0, :3, 3] = camrot, campos
    poses[1, :3, :3], poses[1, :3, 3] = side, (2.0, 0.0, 0.0)
    images = np.broadcast_to(np.asarray(COLOUR, np.float32),
                             (2, H, W, 3)).copy()
    intr = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]],
                    np.float32)
    return dict(images=images, poses=poses, intrinsics=intr, split="train")


@pytest.fixture(scope="module")
def s():
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(
        cfg, query=dataclasses.replace(cfg.query, ray_slot_budget=16,
                                       compact_budget=8),
        agg=dataclasses.replace(cfg.agg, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, fast_path=True, jitter=0.0,
                                  rays_per_batch=64, device_sampling=False))
    scene = make_sphere_scene(n_points=4000, cfg=cfg)
    arrays = two_view_arrays(np.asarray(scene.campos),
                             np.asarray(scene.camrotc2w))
    pc = port_cfg(cfg)
    return dict(
        cfg=cfg, pc=pc, scene=scene,
        jds=jblender.BlenderDataset(near=scene.near, far=scene.far,
                                    **arrays),
        tds=tblender.BlenderDataset(near=scene.near, far=scene.far,
                                    **arrays),
        cloud=convert.cloud_from_jax(scene.cloud, device="cpu"),
        params=convert.aggregator_from_jax(
            jax.tree.map(np.asarray, scene.params), pc.agg, device="cpu"))


@pytest.mark.parametrize("alter_step", [0, 2])
def test_optimizers_match_optax(alter_step):
    """Six updates from the same gradients: each group's parameters and
    Adam moments equal optax's, lr0 * 0.1^(n / span) at update n, the
    span halved under alter_step; a group that sits a phase out keeps its
    parameters and moments bit for bit."""
    cfg = tcfg.PointNerfConfig(train=tcfg.TrainConfig(
        lr_decay_iters=8, alter_step=alter_step))
    rng = np.random.default_rng(3)
    init = [rng.normal(size=(5, 3)).astype(np.float32),
            rng.normal(size=(7,)).astype(np.float32)]
    grads = [[rng.normal(size=x.shape).astype(np.float32) for x in init]
             for _ in range(6)]
    f_t = torch.tensor(init[0], requires_grad=True)
    p_t = torch.tensor(init[1], requires_grad=True)
    (opt_f, sch_f), (opt_p, sch_p) = ttrainer.make_optimizers(
        cfg, [f_t], [p_t])
    state = ttrainer.TrainState(params=None, points=None, opt_fields=opt_f,
                                opt_points=opt_p, sched_fields=sch_f,
                                sched_points=sch_p)
    tx_f, tx_p = jtrainer.make_optimizers(cfg)     # reads cfg.train only
    f_j, p_j = jnp.asarray(init[0]), jnp.asarray(init[1])
    o_f, o_p = tx_f.init(f_j), tx_p.init(p_j)
    for i, (g_f, g_p) in enumerate(grads):
        phase = (i // alter_step) % 2 if alter_step else None
        before = [(x.detach().clone(), {k: v.clone() for k, v in
                                        o.state.get(x, {}).items()})
                  for x, o in ((f_t, opt_f), (p_t, opt_p))]
        state.zero_grad()
        f_t.grad, p_t.grad = torch.tensor(g_f), torch.tensor(g_p)
        ttrainer.apply_updates(state, cfg)
        if phase in (None, 0):
            u, o_f = tx_f.update(jnp.asarray(g_f), o_f, f_j)
            f_j = optax.apply_updates(f_j, u)
        if phase in (None, 1):
            u, o_p = tx_p.update(jnp.asarray(g_p), o_p, p_j)
            p_j = optax.apply_updates(p_j, u)
        for x, want, o_j, opt in ((f_t, f_j, o_f, opt_f),
                                  (p_t, p_j, o_p, opt_p)):
            np.testing.assert_allclose(x.detach().numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-8)
            adam = o_j[0]
            st = opt.state.get(x, {})
            if int(adam.count):
                np.testing.assert_allclose(st["exp_avg"].numpy(),
                                           np.asarray(adam.mu), rtol=1e-5,
                                           atol=1e-8)
                np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                           np.asarray(adam.nu), rtol=1e-5,
                                           atol=1e-8)
        for k, (x, moments) in enumerate(before):
            if phase is not None and phase != k:
                now = (f_t, p_t)[k]
                assert torch.equal(now.detach(), x)
                st = (opt_f, opt_p)[k].state.get(now, {})
                assert all(torch.equal(st[n], v) for n, v in moments.items())
    assert state.step == 6
    span = 8 // (2 if alter_step else 1)
    n_f = sum(1 for i in range(6)
              if not alter_step or (i // alter_step) % 2 == 0)
    assert opt_f.param_groups[0]["lr"] == pytest.approx(
        5e-4 * 0.1 ** (n_f / span), rel=1e-12)


def test_fit_trajectory_matches_reference(s, tmp_path):
    """Eight steps of the port's fit() and of the reference's fast train
    step on the same batches: the losses within rtol 5e-2 / atol 1e-3, and
    the loss falls in both."""
    cfg = s["cfg"]
    sc = s["scene"]
    steps = 8
    geo, rmin, svs = jft.make_geo_scene(cfg, sc.cloud, sc.grid)
    step = jft.make_fast_train_step(cfg)
    st = jtrainer.create_train_state(sc.params, sc.cloud, cfg)
    sampler = jblender.PixelSampler(s["jds"], cfg.train.rays_per_batch,
                                    seed=4)
    want = []
    with jax.default_matmul_precision("highest"):
        for i in range(steps):
            b = sampler.next_batch()
            st, aux = step(st, geo, rmin, svs, jnp.asarray(b["campos"]),
                           jnp.asarray(b["camrotc2w"]),
                           jnp.asarray(b["raydirs"]),
                           jnp.asarray(b["gt_rgb"]),
                           jnp.asarray(b["near"], jnp.float32),
                           jnp.asarray(b["far"], jnp.float32),
                           jax.random.PRNGKey(i))
            want.append(float(aux["total"]))
    res = tloop.fit(s["pc"], s["tds"], s["params"], s["cloud"],
                    str(tmp_path / "fit"), max_steps=steps, print_freq=1,
                    seed=4, device="cpu")
    got = [rec["total"] for rec in res.log]
    assert [rec["step"] for rec in res.log] == list(range(1, steps + 1))
    assert res.state.step == steps
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=1e-3)
    assert got[-1] < got[0] and want[-1] < want[0]
    # the caller's weights stay as they were
    assert not s["params"].mlp_base[0].weight.requires_grad
    assert (tmp_path / "fit" / "log.txt").exists()


def test_fit_march_auto_equals_dense(s, tmp_path):
    """fit() with march_auto (the jitter-aware walk, planned from the
    dataset's cameras) takes the dense lookup's steps bit for bit, with
    jitter on and the batches sampled on the device (here the CPU)."""
    pc = with_train(s["pc"], jitter=0.3, device_sampling=True)
    res = {}
    for name, cf in (("dense", pc), ("march", with_train(pc,
                                                          march_auto=True))):
        res[name] = tloop.fit(cf, s["tds"], s["params"], s["cloud"],
                              str(tmp_path / name), max_steps=3,
                              print_freq=1, seed=2, device="cpu")
    assert "mc_overflow" not in res["dense"].log[0]
    assert all(rec["mc_overflow"] == 0 for rec in res["march"].log)
    for a, b in zip(res["dense"].log, res["march"].log):
        assert a["total"] == b["total"]
    for k, v in res["dense"].state.points.trainable().items():
        assert torch.equal(v, res["march"].state.points.trainable()[k]), k


UNPORTED_FIT = {
    "mesh": (dict(mesh=object()), {}, "item 12"),
    "hash grid": ({}, dict(query=dict(grid_mode="hash")), "item 9"),
    "prune_iter": ({}, dict(train=dict(prune_iter=10)), "item 8"),
    "prob_freq": ({}, dict(train=dict(prob_freq=10)), "item 8"),
    "eval_freq": (dict(eval_freq=5), {}, "item 8"),
    "save_freq": (dict(save_freq=5), {}, "item 8"),
    "plane background": ({}, dict(bgmodel="plane"), "item 9"),
    "tensorboard": (dict(tensorboard=True), {}, "item 10"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED_FIT))
def test_fit_unported_raises(s, name, tmp_path):
    kw, over, item = UNPORTED_FIT[name]
    cfg = s["pc"]
    for part, fields in over.items():
        if isinstance(fields, dict):
            fields = dataclasses.replace(getattr(cfg, part), **fields)
        cfg = dataclasses.replace(cfg, **{part: fields})
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        tloop.fit(cfg, s["tds"], s["params"], s["cloud"], str(tmp_path),
                  max_steps=1, device="cpu", **kw)


def test_fit_resume_from_checkpoint_raises(s, tmp_path):
    (tmp_path / "ckpt" / "10").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        tloop.fit(s["pc"], s["tds"], s["params"], s["cloud"], str(tmp_path),
                  max_steps=1, device="cpu")


UNPORTED_RENDER = {
    "one-hot compaction": (dict(compact_mode="onehot"), False, "item 5"),
    "grid composite": (dict(composite_mode="grid"), False, "item 5"),
    "remat": ({}, True, "item 7"),
    "per-point Rw2c": ({}, False, "item 6"),
    "debug_prefix": ({}, False, "item 7"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED_RENDER))
def test_fast_train_render_unported_raises(s, name):
    q_over, remat, item = UNPORTED_RENDER[name]
    cfg = s["pc"]
    cfg = dataclasses.replace(cfg, query=dataclasses.replace(cfg.query,
                                                             **q_over))
    if remat:
        cfg = with_train(cfg, remat="full")
    pts = s["cloud"]
    if name == "per-point Rw2c":
        pts = dataclasses.replace(pts, Rw2c=torch.eye(3).expand(
            pts.capacity, 8, 3, 3))
    kw = dict(debug_prefix="front") if name == "debug_prefix" else {}
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        tft.fast_train_render(
            s["params"], pts, None, torch.zeros(3), torch.eye(3),
            torch.zeros(4, 3), 2.0, 6.0, cfg, torch.zeros(3),
            torch.ones(3), training=True, **kw)


def test_legacy_step_and_loader_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        tblender.load_blender("scene")


def test_fit_without_a_device_raises(s, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.fit(s["pc"], s["tds"], s["params"], s["cloud"], str(tmp_path),
                  max_steps=1)


def test_pixel_sampler_is_the_reference_copy(s):
    """The port's host sampler draws the reference's batches."""
    a = jblender.PixelSampler(s["jds"], 32, seed=7)
    b = tblender.PixelSampler(s["tds"], 32, seed=7)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))
