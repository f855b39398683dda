"""The port's whole-frame render (`models/fast_render.py::render_frame`) against
itself and against the JAX reference, at the size of tests/test_raster.py
(chair with 30,000 points, vsize 0.016, D = 64, SR 24, BP 16, compact
budget 8, so that the budget escalation runs) on a 32x32 frame of the same
field of view (a frame costs a dozen chunk renders through the plain
versions on one thread), with the off-centre pinhole intrinsics, halved
with the frame, and the loader-style rays (normalised with a +1e-5 norm
guard) of tests/test_raster.py::test_render_frame_raster_parity.

Bit for bit inside the port: the frame with and without `raster=`, the
frame against `fast_render_rays` on the raw ray order, and a frame whose
raster was refused against the walked one. Against the reference's
`render_frame`: masks and counters exact, colour and acc within the bf16
bound of the fused chunk (atol 2e-2, mean < 2e-3). A raster counter forced
non-zero walks the frame and says so; an exception that is none of the
raster's own propagates."""

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
from pointnerf2studio_torch.ops import raster as tr
from pointnerf2studio_tpu.config import (
    AggregatorConfig, PointNerfConfig, QueryConfig)
from pointnerf2studio_tpu.data.synthetic import make_chair_scene
from pointnerf2studio_tpu.models import fast_render as jfr
from pointnerf2studio_tpu.ops import march as jm

torch.set_num_threads(1)

H = W = 32
D = 64
CAP = 16
PINHOLE = (105.0, 111.0, 15.0, 17.25)
KW = dict(chunk=256, tier_quant=1_000_000)
FIELDS = ("coarse_raycolor", "ray_mask", "acc", "depth")


def T(a):
    return torch.as_tensor(np.array(a))


def _port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)))


def _loader_rays(rot):
    fx, fy, cx, cy = PINHOLE
    i, j = np.meshgrid(np.arange(W), np.arange(H))
    d = np.stack([(i + 0.5 - cx) / fx, (j + 0.5 - cy) / fy,
                  np.ones_like(i, np.float64)], -1).reshape(-1, 3)
    d = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-5)
    return (d @ np.asarray(rot, np.float64).T).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    cfg = PointNerfConfig(
        query=QueryConfig(
            vsize=(0.016,) * 3, vscale=(2, 2, 2), SR=24, K=8, P=12,
            max_o=200_000, z_depth_dim=D, compact_budget=8,
            ray_slot_budget=CAP, use_cache=False, fast_chunk=512,
            chunk_mode="fused", select_mode="pallas"),
        agg=AggregatorConfig(compute_dtype="bfloat16"))
    scene = make_chair_scene(n_points=30_000, cfg=cfg)
    rays = _loader_rays(scene.camrotc2w)
    cache0, rmin, svs = jfr.make_fast_scene(cfg, scene.cloud, scene.grid)
    table = np.asarray(jm.build_march_table(cache0.coor_2_qslot))
    steps, buckets = jm.plan_march(
        table, np.asarray(rmin), np.asarray(svs), np.asarray(scene.campos),
        rays, float(scene.near), float(scene.far), D, CAP, slack=1.5,
        chunk=KW["chunk"], fuel_margin=10)
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
                rays=rays, port=port, frames={})


def _frame(s, cfg=None, raster=None, memo=None, **kw):
    """The port's render_frame on the setup's rays; `memo` names a frame
    that several tests read, rendered once."""
    if memo is not None and memo in s["frames"]:
        return s["frames"][memo]
    p, scene = s["port"], s["scene"]
    out = tfr.render_frame(
        p["params"], p["Rw2c"], p["cache"], p["campos"], p["camrotc2w"],
        T(s["rays"]), scene.near, scene.far, _port_cfg(cfg or s["cfg"]),
        p["rmin"], p["svs"], raster=raster, **{**KW, **kw})
    if memo is not None:
        s["frames"][memo] = out
    return out


def _same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_raster_frame_equals_walked_frame(setup):
    s = setup
    walk = _frame(s, memo="walk")
    rast = _frame(s, raster=(H, W, PINHOLE), memo="raster")
    assert walk.front_end == "march" and rast.front_end == "raster"
    _same(walk, rast)
    assert int(walk.mc_overflow) == 0 and rast.mc_overflow is None
    assert walk.rb_overflow is None and walk.dw_overflow is None
    mask = walk.ray_mask.numpy()
    assert 0 < mask.sum() < mask.size
    bg = np.asarray(s["cfg"].bg_color, np.float32)
    assert np.all(walk.coarse_raycolor.numpy()[~mask] == bg)


def test_frame_equals_raw_order_render(setup):
    """Sorting, chunking and padding change no ray: the frame equals
    `fast_render_rays` on the raw ray order at a compaction budget that
    cannot overflow (the escalation's last level)."""
    s = setup
    p, scene = s["port"], s["scene"]
    q = s["cfg"].query

    def raw(budget):
        cfg = dataclasses.replace(s["cfg"], query=dataclasses.replace(
            q, compact_budget=budget, march_steps=(2 * D + 8,),
            march_buckets=()))
        return tfr.fast_render_rays(
            p["params"], p["Rw2c"], p["cache"], p["campos"], p["camrotc2w"],
            T(s["rays"]), scene.near, scene.far, _port_cfg(cfg), p["rmin"],
            p["svs"])

    full = raw(CAP)
    assert full.cb_overflow is None
    _same(_frame(s, memo="walk"), full)


def test_frame_matches_jax(setup):
    s = setup
    scene = s["scene"]
    with jax.default_matmul_precision("highest"):
        want = jfr.render_frame(
            scene.params, scene.cloud.Rw2c, s["cache"], scene.campos,
            scene.camrotc2w, jnp.asarray(s["rays"]), scene.near, scene.far,
            s["cfg"], s["rmin"], s["svs"], raster=(H, W, PINHOLE), **KW)
    got = _frame(s, raster=(H, W, PINHOLE), memo="raster")
    for f in ("dw_overflow", "rb_overflow"):
        assert getattr(want, f) is None and getattr(got, f) is None, f
    # after the escalation every chunk either fits its budget or renders at
    # the per-ray cap, where no counter exists
    assert (want.cb_overflow is None) == (got.cb_overflow is None)
    assert got.cb_overflow is None or int(got.cb_overflow) == int(
        want.cb_overflow) == 0
    mask = got.ray_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.ray_mask))
    for g, w in ((got.coarse_raycolor, want.coarse_raycolor),
                 (got.acc, want.acc), (got.depth, want.depth)):
        d = np.abs(g.numpy() - np.asarray(w, np.float32))
        assert d.max() <= 2e-2 and d.mean() < 2e-3, (d.max(), d.mean())


def test_depth_window_tiers_without_march(setup):
    """A config without march_steps: chunks at depth-window tiers, the
    same frame, and the output says which front-end it was."""
    s = setup
    cfg = dataclasses.replace(s["cfg"], query=dataclasses.replace(
        s["cfg"].query, march_steps=(), march_buckets=()))
    seen = []
    orig = tfr.fast_render_rays

    def spy(*a, **k):
        seen.append(a[8].query.depth_window)
        return orig(*a, **k)

    tfr.fast_render_rays = spy
    try:
        out = _frame(s, cfg, raster=(H, W, PINHOLE), tier_quant=8)
    finally:
        tfr.fast_render_rays = orig
    assert out.front_end == "depth_window" and out.mc_overflow is None
    assert int(out.dw_overflow) == 0
    assert len(set(seen)) > 1 and all(0 < dw < D for dw in seen)
    assert seen[0] == min(seen)         # ascending span: small tiers first
    _same(out, _frame(s, memo="walk"))


@pytest.mark.parametrize("why", ["counter", "frame_shape", "grid_dims"])
def test_refused_raster_walks_and_says_so(setup, why, capsys, monkeypatch):
    """A non-zero raster counter, or one of the raster's own refusals,
    means "walk this frame": same frame, front_end "march", a line on
    stderr under verbose."""
    s = setup
    raster = (H, W, PINHOLE)
    if why == "counter":
        make = tr.make_raster_program
        monkeypatch.setattr(
            tfr, "make_raster_program",
            lambda *a, **k: make(*a, **{**k, "live_budget": 1024}))
    elif why == "frame_shape":
        raster = (H, W + 1, PINHOLE)
    else:
        def refuse(*a, **k):
            raise tr.RasterUnserved("grid dims <= 1024")
        monkeypatch.setattr(tfr, "build_qvox", refuse)
    out = _frame(s, raster=raster, verbose=True)
    err = capsys.readouterr().err
    assert out.front_end == "march" and "raster disabled" in err
    assert (why != "counter") or "counters [0, 0," in err
    assert int(out.mc_overflow) == 0
    _same(out, _frame(s, memo="walk"))


def test_unexpected_exception_propagates(setup, monkeypatch):
    """Only the raster's own refusals are caught: a failure of another
    kind (a kernel that does not build, say) ends the render."""
    def boom(*a, **k):
        raise RuntimeError("nvcc failed for march")
    monkeypatch.setattr(tfr, "make_raster_program", boom)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _frame(setup, raster=(H, W, PINHOLE))


def test_program_cache_and_budget_tier(setup):
    """`program_cache` keeps the qvox table and the raster program across
    frames; `budget_tier` renders low first and escalates to the same
    frame."""
    s = setup
    pc = {}
    a = _frame(s, raster=(H, W, PINHOLE), program_cache=pc)
    keys = sorted(k[0] for k in pc)
    assert keys == ["raster_prog", "raster_qvox"]
    held = {k: id(v) for k, v in pc.items()}
    budgets = []
    orig = tfr.fast_render_rays

    def spy(*a, **k):
        budgets.append(a[8].query.compact_budget)
        return orig(*a, **k)

    tfr.fast_render_rays = spy
    try:
        b = _frame(s, raster=(H, W, PINHOLE), program_cache=pc,
                   budget_tier=2)
    finally:
        tfr.fast_render_rays = orig
    # every chunk at the low tier first, the tripped ones again at doubled
    # budgets: the escalation ran
    n = budgets.count(2)
    assert n >= 2 and budgets[:n] == [2] * n
    assert 0 < len(budgets) - n and set(budgets[n:]) <= {8, 16}
    assert {k: id(v) for k, v in pc.items()} == held
    assert a.front_end == b.front_end == "raster"
    _same(a, b)
    _same(a, _frame(s, memo="walk"))


# the tower's inputs that carry the payload, scaled so that the colour
# depends on it: mlp_base layer 0's rows for emb and PE(emb) (the first
# 32 + 192 of its 284 inputs) and mlp_head layer 0's rows for the
# neighbour colour, the dir difference and their dot (inputs 256 to 262)
PAYLOAD_SCALE = 4.0


def payload_weights(params):
    p = jax.tree.map(lambda x: np.array(x, np.float32), params)
    p["mlp_base"][0]["kernel"][:224] *= PAYLOAD_SCALE
    p["mlp_head"][0]["kernel"][256:263] *= PAYLOAD_SCALE
    return p


def rotate_payload(cache):
    """The payload mutant: each candidate's 96-byte payload row with its
    six 16-byte pieces rotated by one (what a selection extract that deals
    the pieces to the wrong lanes would hand the tower)."""
    kc = cache.kcand
    return dataclasses.replace(cache, kcand=kc.view(
        kc.shape[0], kc.shape[1], 6, 8).roll(1, 2).reshape(kc.shape))


def test_frame_check_depends_on_payload(setup):
    """With weights under which the colour depends on the payload, the
    port's frame (the plain fused chunk body) matches the reference's
    within the bf16 bound (atol 2e-2, mean < 2e-3; measured 2.2e-4 /
    4.2e-5), and the same frame rendered from a payload with its pieces
    rotated fails that bound by far (measured max 0.379, mean 0.196): the
    check sees a wrong payload."""
    s = setup
    scene = s["scene"]
    jp = payload_weights(scene.params)
    tp = convert.aggregator_from_jax(jp, _port_cfg(s["cfg"]).agg,
                                     device="cpu")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jfr.render_frame(
            jax.tree.map(jnp.asarray, jp), scene.cloud.Rw2c, s["cache"],
            scene.campos, scene.camrotc2w, jnp.asarray(s["rays"]),
            scene.near, scene.far, s["cfg"], s["rmin"], s["svs"],
            raster=(H, W, PINHOLE), **KW).coarse_raycolor, np.float32)
    p = dict(s["port"], params=tp)
    diffs = []
    for cache in (p["cache"], rotate_payload(p["cache"])):
        got = tfr.render_frame(
            tp, p["Rw2c"], cache, p["campos"], p["camrotc2w"], T(s["rays"]),
            scene.near, scene.far, _port_cfg(s["cfg"]), p["rmin"], p["svs"],
            raster=(H, W, PINHOLE), **KW)
        d = np.abs(got.coarse_raycolor.numpy() - want)
        diffs.append((float(d.max()), float(d.mean())))
    (good_max, good_mean), (bad_max, bad_mean) = diffs
    assert good_max <= 2e-2 and good_mean < 2e-3, diffs
    assert bad_max > 5 * 2e-2 and bad_mean > 5 * 2e-3, diffs
