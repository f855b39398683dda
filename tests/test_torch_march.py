"""The port's march front-end (ops/march.py and the march branch of
fast_render_rays) against the JAX reference on the same numpy inputs, at
the size of tests/test_raster.py (chair with 30,000 points, vsize 0.016,
64x64 rays at focal 220, D = 64, SR 24, BP 16, compact budget 4).

Exact: the march table, the planner (`simulate_march`, `plan_march`),
`emit` / `cnt` / `mc_overflow` of the walk (also with `live`, with
`t_tab` + `jitter`, and with fuel and buckets too small), the walk's
step count against the planner's, and the port's march frame against its
own dense-path frame, bit for bit. Against the JAX frame: masks and
counters exact, colour and acc within the bf16 bound of the fused chunk
(atol 2e-2, mean < 2e-3).

The reference's walk runs under jit (`lax.fori_loop`), where XLA:CPU may
contract campos + rd * t into a fused multiply-add, so a sample within an
ulp of a voxel face could fall to the other side there. No ray of these
inputs does: every comparison below is over all rays, none set aside. On
the CPU the walk runs `march_rays_reference`; no CUDA kernel launches."""

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
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops import march as tm
from pointnerf2studio_tpu.config import (
    AggregatorConfig, PointNerfConfig, QueryConfig)
from pointnerf2studio_tpu.data.synthetic import make_chair_scene
from pointnerf2studio_tpu.models import fast_render as jfr
from pointnerf2studio_tpu.ops import march as jm
from pointnerf2studio_tpu.ops.raster import camera_rays_device

torch.set_num_threads(1)

H = W = 64
FOCAL = 220.0
D = 64
CAP = 16


def T(a):
    return torch.as_tensor(np.array(a))


def _port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)))


@pytest.fixture(scope="module")
def setup():
    cfg = PointNerfConfig(
        query=QueryConfig(
            vsize=(0.016,) * 3, vscale=(2, 2, 2), SR=24, K=8, P=12,
            max_o=200_000, z_depth_dim=D, compact_budget=4,
            ray_slot_budget=CAP, use_cache=False, fast_chunk=512,
            chunk_mode="fused", select_mode="pallas"),
        agg=AggregatorConfig(compute_dtype="bfloat16"))
    scene = make_chair_scene(n_points=30_000, cfg=cfg)
    rays = np.asarray(camera_rays_device(scene.camrotc2w, H, W, FOCAL))
    cache0, rmin, svs = jfr.make_fast_scene(cfg, scene.cloud, scene.grid)
    table = np.asarray(jm.build_march_table(cache0.coor_2_qslot))
    geo = (np.asarray(rmin), np.asarray(svs), np.asarray(scene.campos))
    steps, buckets = jm.plan_march(
        table, *geo, rays, float(scene.near), float(scene.far), D, CAP,
        slack=1.5, chunk=H * W, fuel_margin=10)
    cfg = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, march_steps=steps, march_buckets=buckets))
    cache = cache0.replace(march_table=jnp.asarray(table))
    port = dict(
        params=convert.aggregator_from_jax(
            jax.tree.map(np.asarray, scene.params),
            _port_cfg(cfg).agg, device="cpu"),
        cache=convert.fat_cache_from_jax(cache, device="cpu"),
        Rw2c=T(scene.cloud.Rw2c), campos=T(scene.campos),
        camrotc2w=T(scene.camrotc2w), rmin=T(rmin), svs=T(svs))
    return dict(scene=scene, cfg=cfg, cache=cache, rmin=rmin, svs=svs,
                rays=rays, table=table, geo=geo, port=port)


def _jax_walk(s, rays, steps, buckets, cap=CAP, **kw):
    scene, dims = s["scene"], s["table"].shape
    step_t = (scene.far - scene.near) / D
    emit, cnt, of = jm.march_rays(
        jnp.asarray(s["table"]).reshape(-1), jnp.array(dims, jnp.int32),
        dims[1], dims[2], s["rmin"], s["svs"], scene.campos,
        jnp.asarray(rays), jnp.asarray(scene.near, jnp.float32),
        jnp.asarray(scene.far, jnp.float32),
        jnp.asarray(step_t, jnp.float32), D, cap, steps, buckets, **kw)
    return np.asarray(emit), np.asarray(cnt), int(of)


def _port_walk(s, rays, steps, buckets, cap=CAP, **kw):
    scene, dims = s["scene"], s["table"].shape
    near = T(np.float32(scene.near))
    far = T(np.float32(scene.far))
    out = tm.march_rays(
        T(s["table"]).reshape(-1), T(np.array(dims, np.int32)), dims[1],
        dims[2], T(s["rmin"]), T(s["svs"]), T(scene.campos), T(rays), near,
        far, (far - near) / D, D, cap, steps, buckets, **kw)
    return (out[0].numpy(), out[1].numpy(), int(out[2])) + tuple(
        o.numpy() for o in out[3:])


def test_march_table_matches_jax(setup):
    s = setup
    qs = np.asarray(s["cache"].coor_2_qslot)
    got = tm.build_march_table(T(qs)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, s["table"])
    np.testing.assert_array_equal(s["port"]["cache"].march_table.numpy(),
                                  s["table"])
    # distances on a toy grid against brute force
    occ = np.full((8, 9, 10), -1, np.int32)
    occ[2, 3, 4], occ[6, 1, 1] = 7, 11
    t = tm.build_march_table(T(occ)).numpy()
    np.testing.assert_array_equal((t >> 5) - 1, occ)
    pts = np.argwhere(occ >= 0)
    want = np.abs(np.indices(occ.shape).transpose(1, 2, 3, 0)[..., None, :]
                  - pts).max(-1).min(-1)
    np.testing.assert_array_equal(t & 31, np.minimum(want, 31))


@pytest.mark.parametrize("jitter", [0.0, 0.5])
def test_simulate_march_matches_reference(setup, jitter):
    s = setup
    args = (s["table"], *s["geo"], s["rays"], float(s["scene"].near),
            float(s["scene"].far), D, CAP)
    want = jm.simulate_march(*args, jitter=jitter)
    got = tm.simulate_march(*args, jitter=jitter)
    np.testing.assert_array_equal(got, want)
    assert got.max() > 4 and (got == 0).any() == (want == 0).any()
    # per-ray origins: the planning-only form
    cam = np.broadcast_to(s["geo"][2], s["rays"].shape)
    np.testing.assert_array_equal(
        tm.simulate_march(s["table"], s["geo"][0], s["geo"][1], cam,
                          *args[4:], jitter=jitter), want)


@pytest.mark.parametrize("kw", [
    dict(), dict(stages=2), dict(stages=6, slack=1.35, fuel_margin=10),
    dict(chunk=1000, slack=1.5), dict(block_lens=(96, 4000), jitter=0.3),
])
def test_plan_march_matches_reference(setup, kw):
    s = setup
    args = (s["table"], *s["geo"], s["rays"], float(s["scene"].near),
            float(s["scene"].far), D, CAP)
    assert tm.plan_march(*args, **kw) == jm.plan_march(*args, **kw)
    none_hit = -s["rays"]
    assert tm.plan_march(args[0], *s["geo"], none_hit, *args[5:]) \
        == jm.plan_march(args[0], *s["geo"], none_hit, *args[5:]) == ((8,), ())


def _t_tab(s, jitter, seed=3):
    """Jittered stratified mids [R, D], as raygen's jitter draws them."""
    scene = s["scene"]
    R = s["rays"].shape[0]
    u = np.random.default_rng(seed).random((R, D), dtype=np.float32)
    base = np.float32((scene.far - scene.near) / D)
    seg = base * (np.float32(1.0) + np.float32(jitter) * (u - np.float32(0.5)))
    ends = np.float32(scene.near) + np.cumsum(seg, -1, dtype=np.float32)
    return (ends - np.float32(0.5) * seg).astype(np.float32)


WALKS = {
    "planned": lambda s: (s["cfg"].query.march_steps,
                          s["cfg"].query.march_buckets, {}),
    "one_stage": lambda s: ((2 * D,), (), {}),
    "fuel_starved": lambda s: ((3, 4), (4096,), {}),
    # stage 1 has room for 8 rays: the others sit it out and go on in stage
    # 2, whose bucket is too small as well
    "buckets_starved": lambda s: ((4, 1, 60), (8, 1024), {}),
    "cap_small": lambda s: ((2 * D,), (), {"cap": 3}),
}


@pytest.mark.parametrize("case", sorted(WALKS))
def test_march_rays_matches_jax(setup, case):
    s = setup
    steps, buckets, kw = WALKS[case](s)
    _cuda.LAUNCHES.clear()
    emit, cnt, of, used = _port_walk(s, s["rays"], steps, buckets,
                                     count_steps=True, **kw)
    assert sum(_cuda.LAUNCHES.values()) == 0
    j_emit, j_cnt, j_of = _jax_walk(s, s["rays"], steps, buckets, **kw)
    np.testing.assert_array_equal(cnt, j_cnt)
    np.testing.assert_array_equal(emit, j_emit)
    assert of == j_of
    assert (of > 0) == ("starved" in case)
    assert (cnt == 0).any() and 0 < cnt.max() <= kw.get("cap", CAP)
    assert of > 0 or cnt.max() == kw.get("cap", CAP)
    if case == "buckets_starved":
        # rays that sat stage 1 out did walk in stage 2
        assert ((used > 5) & (used <= 64)).sum() > 8


def test_march_rays_live_mask_matches_jax(setup):
    """Rows that are not live (ray packing's padding copies) do not walk,
    take no bucket room and do not count in mc_overflow."""
    s = setup
    rays = np.concatenate([s["rays"][::4], np.broadcast_to(
        s["rays"][H // 2 * W + W // 2], (64, 3))])
    live = np.arange(rays.shape[0]) < rays.shape[0] - 64
    for steps, buckets in (((2, 60), (256,)), ((1,), ())):
        emit, cnt, of = _port_walk(s, rays, steps, buckets, live=T(live))
        j_emit, j_cnt, j_of = _jax_walk(s, rays, steps, buckets,
                                        live=jnp.asarray(live))
        np.testing.assert_array_equal(cnt, j_cnt)
        np.testing.assert_array_equal(emit, j_emit)
        assert of == j_of
        assert cnt[~live].sum() == 0
    # without the mask the 64 copies of a hitting ray walk and count
    assert _port_walk(s, rays, (1,), ())[2] - of == 64


@pytest.mark.parametrize("jitter,walks", [
    (0.3, (((2 * D + 8,), ()), ((6, 80), (4096,)))),
    (1.0, (((3, 3), (128,)),)),
])
def test_march_rays_jittered_matches_jax(setup, jitter, walks):
    """The train path's branch: per-sample times from t_tab, the skip
    divided by 1 + jitter/2, termination at the true t."""
    s = setup
    tab = _t_tab(s, jitter)
    for steps, buckets in walks:
        emit, cnt, of = _port_walk(
            s, s["rays"], steps, buckets, t_tab=T(tab), jitter=jitter)
        j_emit, j_cnt, j_of = _jax_walk(
            s, s["rays"], steps, buckets, t_tab=jnp.asarray(tab),
            jitter=jitter)
        np.testing.assert_array_equal(cnt, j_cnt)
        np.testing.assert_array_equal(emit, j_emit)
        assert of == j_of
        assert (of > 0) == (sum(steps) < 10)
        # the jittered walk differs from the unjittered one: the branch
        # is really taken
        assert not np.array_equal(
            emit, _port_walk(s, s["rays"], steps, buckets)[0])


def test_walk_takes_the_planners_steps(setup):
    """Planner against walk: with fuel to spare, each ray's iterations on
    the device path equal `simulate_march`'s, ray for ray: with the slab
    test in float32, as the walk's is, and on these rays (none within a
    float32 ulp of a sample boundary) with the planner's float64 too."""
    s = setup
    sim, sim32 = (tm.simulate_march(
        s["table"], *s["geo"], s["rays"], float(s["scene"].near),
        float(s["scene"].far), D, CAP, slab_f32=f) for f in (False, True))
    np.testing.assert_array_equal(sim32, sim)
    q = s["cfg"].query
    for steps, buckets in (((2 * D + 8,), ()),
                           (q.march_steps, q.march_buckets)):
        *_, of, used = _port_walk(s, s["rays"], steps, buckets,
                                  count_steps=True)
        assert of == 0
        np.testing.assert_array_equal(used, sim)
    assert sim.sum() < 0.5 * D * (sim > 0).sum()    # the skips do skip


# ---- frames: 512 rays of the frame, every 8th a miss, so that ray
# packing at RB has padding rows; compact budget 8 keeps cb_overflow at 0
# (past it the reference's composite misreports the cut-off rays)
RB = 480


@pytest.fixture(scope="module")
def frame(setup):
    s = setup
    rays = s["rays"][::8].copy()
    rays[::8] *= -1.0
    steps, buckets = tm.plan_march(
        s["table"], *s["geo"], rays, float(s["scene"].near),
        float(s["scene"].far), D, CAP, stages=2, slack=1.5, fuel_margin=10)
    cfg = dataclasses.replace(s["cfg"], query=dataclasses.replace(
        s["cfg"].query, march_steps=steps, march_buckets=buckets,
        compact_budget=8))
    return rays, cfg


def _render_port(s, cfg, rays, **kw):
    p = s["port"]
    scene = s["scene"]
    return tfr.fast_render_rays(
        p["params"], p["Rw2c"], p["cache"], p["campos"], p["camrotc2w"],
        T(rays), scene.near, scene.far, _port_cfg(cfg), p["rmin"], p["svs"],
        **kw)


def _variant(cfg, body="fused", rb=0, **q):
    q["ray_budget"] = rb
    if body == "staged":
        q.update(knn_mode="fused", chunk_mode="xla")
    return dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, **q))


FIELDS = ("coarse_raycolor", "ray_mask", "acc", "depth")


@pytest.mark.parametrize("body", ["fused", "staged"])
@pytest.mark.parametrize("rb", [0, RB])
def test_march_frame_equals_dense_path(setup, frame, body, rb):
    """The march hands the same slots in the same order to the same chunk
    body as the dense front-ends, so the port's frames are equal bit for
    bit: against the full [R, D] table and against the depth window; also
    where the M budget cuts slots off (compact budget 4)."""
    s = setup
    rays, cfg0 = frame
    dw = tfr.measured_depth_window(
        s["scene"].campos, rays, s["scene"].near, s["scene"].far, D,
        s["rmin"], s["table"].shape, s["svs"])
    for budget in (8, 4):
        cfg = _variant(cfg0, body, rb, compact_budget=budget)
        _cuda.LAUNCHES.clear()
        out = _render_port(s, cfg, rays)
        assert sum(_cuda.LAUNCHES.values()) == 0
        assert int(out.mc_overflow) == 0 and out.dw_overflow is None
        assert (out.rb_overflow is None) == (rb == 0)
        assert rb == 0 or int(out.rb_overflow) == 0
        assert (int(out.cb_overflow) > 0) == (budget == 4)
        for dense_q in (dict(), dict(depth_window=dw)):
            dense = _render_port(s, _variant(
                cfg, body, rb, march_steps=(), march_buckets=(), **dense_q),
                rays)
            assert dense.mc_overflow is None
            for f in FIELDS:
                assert torch.equal(getattr(out, f), getattr(dense, f)), f
            assert int(out.n_valid_slots) == int(dense.n_valid_slots)
            assert int(out.cb_overflow) == int(dense.cb_overflow)
        assert 0 < int(out.ray_mask.sum()) < out.ray_mask.numel()


@pytest.mark.parametrize("body", ["fused", "staged"])
@pytest.mark.parametrize("rb", [0, RB])
def test_march_frame_matches_jax(setup, frame, body, rb):
    s = setup
    scene = s["scene"]
    rays, cfg0 = frame
    cfg = _variant(cfg0, body, rb)
    with jax.default_matmul_precision("highest"):
        want = jfr.fast_render_rays_jit(
            scene.params, scene.cloud.Rw2c, s["cache"], scene.campos,
            scene.camrotc2w, jnp.asarray(rays), scene.near, scene.far,
            cfg, s["rmin"], s["svs"])
    got = _render_port(s, cfg, rays)
    for f in ("dw_overflow", "rb_overflow", "cb_overflow", "mc_overflow",
              "n_valid_slots"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            assert int(g) == int(w), f
    assert int(got.mc_overflow) == int(got.cb_overflow) == 0
    assert int(got.n_valid_slots) > 0
    mask = got.ray_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.ray_mask))
    assert 0 < mask.sum() < mask.size
    color = got.coarse_raycolor.numpy()
    assert np.all(color[~mask] == np.asarray(cfg.bg_color, np.float32))
    for g, w in ((color, want.coarse_raycolor), (got.acc.numpy(), want.acc)):
        d = np.abs(g - np.asarray(w, np.float32))
        assert d.max() <= 2e-2 and d.mean() < 2e-3, (d.max(), d.mean())


def test_march_overflow_reaches_the_output(setup, frame):
    """Fuel too small: mc_overflow of the render equals the walk's on the
    same rays (held to the reference's above), with and without ray
    packing, whose padding rows must not count."""
    s = setup
    rays, cfg0 = frame
    _, _, of = _port_walk(s, rays, (2, 2), (128,))
    for rb in (0, RB):
        got = _render_port(s, _variant(
            cfg0, rb=rb, march_steps=(2, 2), march_buckets=(128,)), rays)
        assert int(got.mc_overflow) == of > 0


def test_premarch_takes_the_walks_place(setup, frame):
    """A [R, cap] emit table, or (frame table, ray ids), renders the same
    frame as the walk and reports no mc_overflow; a wrong shape raises."""
    s = setup
    rays, cfg = frame
    q = cfg.query
    walk = _render_port(s, cfg, rays)
    emit, cnt, of = _port_walk(s, rays, q.march_steps, q.march_buckets)
    assert of == 0
    ids = np.random.default_rng(0).permutation(rays.shape[0])
    for c, r, pm in (
            (cfg, rays, T(emit)),
            (_variant(cfg, rb=RB), rays, T(emit)),
            (cfg, rays[ids], (T(emit), T(ids.astype(np.int32))))):
        out = _render_port(s, c, r, premarch=pm)
        assert out.mc_overflow is None
        back = np.argsort(ids) if isinstance(pm, tuple) else slice(None)
        for f in FIELDS:
            assert torch.equal(getattr(out, f)[back], getattr(walk, f)), f
    with pytest.raises(ValueError, match="premarch shape"):
        _render_port(s, cfg, rays, premarch=T(emit[:, :8]))


def test_march_config_helpers_match_reference(setup):
    s = setup
    q0 = s["cfg"].query
    variants = [
        q0, dataclasses.replace(q0, ray_budget=512),
        dataclasses.replace(q0, march_steps=(), march_buckets=()),
        dataclasses.replace(q0, march_steps=(), march_buckets=(),
                            depth_window=8, ray_budget=64),
        dataclasses.replace(q0, compact_budget=0),
        dataclasses.replace(q0, compact_budget=16, depth_window=12,
                            march_steps=(), march_buckets=()),
        dataclasses.replace(q0, compact_mode="onehot"),
    ]
    for q in variants:
        tq = tcfg.QueryConfig(**dataclasses.asdict(q))
        assert tfr.march_active(tq) == jfr.march_active(q)
        assert tfr.has_cb_overflow(tq) == jfr.has_cb_overflow(q)


def test_make_fast_scene_builds_the_march_table(setup):
    """On a small scene of the port's own: the table is there when the
    config has march_steps, and a march config without it raises."""
    from pointnerf2studio_torch.data.synthetic import make_sphere_scene
    tc = _port_cfg(setup["cfg"])
    sc = make_sphere_scene(800, cfg=tc, device="cpu")
    cache, rmin, svs = tfr.make_fast_scene(tc, sc.cloud, sc.grid, max_q=2048)
    assert torch.equal(cache.march_table,
                       tm.build_march_table(cache.coor_2_qslot))
    off = dataclasses.replace(tc, query=dataclasses.replace(
        tc.query, march_steps=(), march_buckets=()))
    bare, _, _ = tfr.make_fast_scene(off, sc.cloud, sc.grid, max_q=2048)
    assert bare.march_table is None
    with pytest.raises(ValueError, match="march_table"):
        tfr.fast_render_rays(
            sc.params, sc.cloud.Rw2c, bare, sc.campos, sc.camrotc2w,
            torch.zeros(4, 3), sc.near, sc.far, tc, rmin, svs)


def test_huge_spans_cast_alike(setup, frame):
    """A ray parallel to a slab and outside it has t_enter past int32; the
    clamp before the cast gives d_lo, d_hi and the frame the reference's
    values (XLA saturates, a bare CPU cast wraps to INT_MIN)."""
    s = setup
    rays = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0],
                     [1e-12, -1e-12, 1.0], [0.6, 0.8, 1e-10]], np.float32)
    rays = np.concatenate([rays, s["rays"][:27]])
    emit, cnt, of = _port_walk(s, rays, (2 * D,), ())
    j_emit, j_cnt, j_of = _jax_walk(s, rays, (2 * D,), ())
    np.testing.assert_array_equal(cnt, j_cnt)
    np.testing.assert_array_equal(emit, j_emit)
    assert of == j_of == 0
    x = torch.tensor([3e9, -3e9, 1e11, -1e11, 7.9, -7.9])
    np.testing.assert_array_equal(
        tm.to_i32(x).numpy(), [1 << 30, -(1 << 30), 1 << 30, -(1 << 30), 7,
                               -7])
    cfg = frame[1]
    dense = _render_port(s, _variant(cfg, march_steps=(), march_buckets=(),
                                     depth_window=40), rays)
    walk = _render_port(s, _variant(cfg, march_steps=(2 * D,),
                                    march_buckets=()), rays)
    assert int(dense.dw_overflow) == 0
    for f in FIELDS:
        assert torch.equal(getattr(dense, f), getattr(walk, f)), f


def test_packing_guards_raise(setup, frame):
    """The packed emit holds qslot + 1 in 22 bits and the depth in 9: a
    cache of more than 2^22 - 2 query voxels, or D > 512, is refused on
    the walk and on the premarch path (where the reference has no such
    guard)."""
    s = setup
    rays, cfg = frame
    big = dataclasses.replace(
        s["port"]["cache"],
        kmeta=s["port"]["cache"].kmeta[:1].expand((1 << 22) - 1, -1))
    port = dict(s["port"], cache=big)
    emit = torch.zeros((rays.shape[0], CAP), dtype=torch.int32)
    for pm in (None, emit):
        with pytest.raises(ValueError, match="max_q < 2\\^22 - 1"):
            _render_port(dict(s, port=port), cfg, rays, premarch=pm)
    deep = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, z_depth_dim=513))
    with pytest.raises(ValueError, match="z_depth_dim <= 512"):
        _render_port(s, deep, rays)
