"""The reference's opt-in render routes in the port, against the JAX
reference's fast_render_rays_jit on the same sphere scene (4,000 points,
D 48, SR 16, 16 slots a ray, 24x24 rays, chunks of 2,048 slots), with
the reference's weights, cloud, grid and cache carried over by
convert.py, and against the port's own default routes:

  * decode_chunk2 (the two-phase pipeline): the tower runs in pieces of
    decode_chunk2 slots; against the reference's two-phase render and the
    port's one-phase render under tests/test_raster.py's contract
    (ray_mask equal, colour within 1e-3, fewer than 0.1% of the
    components apart);
  * chunk_mode="fused" where the whole fused chunk does not apply: (a)
    fused_decode2 on, the selection kernel's and the decode kernel's
    plain versions, equal bit for bit to the staged frame (knn_mode
    "fused") and within the reference's bf16 bound of its XLA route
    (atol 2e-2, mean < 2e-3, tests/test_fused_chunk.py:54-66) with the
    selection (ray_mask, counters) exact; (b) an aggregator outside the
    fused chunk's gate (float32 compute, agg_intrp_order 1), the
    selection kernel's plain version and decode_radiance, within the
    same bound;
  * decode_mode="pair": against the reference's pair render within the
    bf16 bound, against the lanes within tests/test_pair_decode.py's
    (atol 2e-2, mean < 1e-3), pb_overflow None at a budget of K, equal
    to the reference's (0) at 6 and (> 0) starved;
  * extract_mode="krows": the slim view equal to the reference's word for
    word, the render equal to the onehot extract's bit for bit;
  * base_cache: the per-point table within one bf16 rounding of the
    reference's, the render within the bf16 bound of the reference's and
    within tests/test_fast_render.py:579-606's of the port's default
    (atol 5e-3, mean 5e-4), with krows and with pair;
  * cand_prune: the pruned words equal to the reference's rows, the
    render equal to the unpruned one bit for bit;
  * span_tiers: measured_span_tiers equal to the reference's, the render
    equal to the flat window bit for bit with counters 0, overflow
    counted per tier and in the last tier's window;
  * coarse_step: equal to the route without it bit for bit while
    win_overflow is 0, the starved budget's count equal to the
    reference's;
  * compact_mode="onehot": the slot selection equal to the reference's
    on ids up to 2^20 and to topk's bit for bit; composite_mode="grid"
    against the packed composite within 1e-5 (its sums run along the slot
    grid, the reference's own bound, tests/test_fast_render.py:235);
  * render_frame's render_maker: a maker wrapping fast_render_rays gives
    the default frame bit for bit.

On the CPU every kernel wrapper takes its plain version; no CUDA kernel
launches."""

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
from pointnerf2studio_torch.ops import fused_decode as tfd
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.models import fast_render as jfr

torch.set_num_threads(1)

BF16_ATOL, BF16_MEAN = 2e-2, 2e-3


def port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)))


def T(a):
    return torch.as_tensor(np.array(a))


def with_q(cfg, **kw):
    return dataclasses.replace(cfg, query=dataclasses.replace(cfg.query,
                                                              **kw))


def with_agg(cfg, **kw):
    return dataclasses.replace(cfg, agg=dataclasses.replace(cfg.agg, **kw))


@pytest.fixture(scope="module")
def S():
    cfg = sphere_config(sr=16, d=48)
    cfg = with_q(cfg, ray_slot_budget=16, use_cache=False, fast_chunk=2048)
    s = make_sphere_scene(n_points=4000, cfg=cfg)
    jcache, rmin, svs = jfr.make_fast_scene(cfg, s.cloud, s.grid)
    rays = np.asarray(camera_rays(s.campos, s.camrotc2w, 24, 24, 18.0))
    tree = jax.tree.map(np.asarray, s.params)
    return dict(
        s=s, cfg=cfg, jcache=jcache, rmin=rmin, svs=svs, rays=rays,
        tree=tree, tcache=convert.fat_cache_from_jax(jcache, device="cpu"),
        tcloud=convert.cloud_from_jax(s.cloud, device="cpu"),
        tgrid=convert.grid_from_jax(s.grid, device="cpu"), ref={})


def jrender(S, cfg, cache=None, key=None):
    """The reference's render of `cfg` (memoised per key)."""
    if key is not None and key in S["ref"]:
        return S["ref"][key]
    s = S["s"]
    with jax.default_matmul_precision("highest"):
        out = jfr.fast_render_rays_jit(
            s.params, s.cloud.Rw2c, cache or S["jcache"], s.campos,
            s.camrotc2w, S["rays"], s.near, s.far, cfg, S["rmin"], S["svs"])
    out = jax.tree.map(np.asarray, out)
    if key is not None:
        S["ref"][key] = out
    return out


def params_for(S, tc):
    return convert.aggregator_from_jax(S["tree"], tc.agg, device="cpu")


def trender(S, cfg, cache=None, rays=None, **kw):
    s = S["s"]
    tc = port_cfg(cfg) if not isinstance(cfg, tcfg.PointNerfConfig) else cfg
    _cuda.LAUNCHES.clear()
    out = tfr.fast_render_rays(
        params_for(S, tc), T(s.cloud.Rw2c), cache or S["tcache"],
        T(s.campos), T(s.camrotc2w), T(S["rays"] if rays is None else rays),
        s.near, s.far, tc, T(S["rmin"]), T(S["svs"]), **kw)
    assert sum(_cuda.LAUNCHES.values()) == 0
    return out


def tscene(S, cfg, **kw):
    tc = port_cfg(cfg)
    return tfr.make_fast_scene(tc, S["tcloud"], S["tgrid"],
                               max_q=S["tcache"].max_q, **kw)[0]


def near_far(S):
    return dict(near=float(S["s"].near), far=float(S["s"].far))


def same(a, b, fields=("coarse_raycolor", "ray_mask", "acc", "depth")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def within(got, want, atol=BF16_ATOL, mean=BF16_MEAN, hits_only=False):
    mask = np.asarray(want.ray_mask)
    np.testing.assert_array_equal(got.ray_mask.numpy(), mask)
    assert 0 < mask.sum() < mask.size
    g = got.coarse_raycolor.numpy()
    w = np.asarray(want.coarse_raycolor, np.float32)
    d = np.abs(g - w)[mask] if hits_only else np.abs(g - w)
    assert d.max() <= atol and d.mean() < mean, (d.max(), d.mean())
    if not hits_only:
        assert np.all(g[~mask] == np.asarray(
            S_BG, np.float32)), "miss rays not background"


S_BG = (1.0, 1.0, 1.0)


def counters_equal(got, want, fields):
    for f in fields:
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            assert int(g) == int(w), (f, int(g), int(w))


# ---- route 0: decode_chunk2 ---------------------------------------------

def test_two_phase_batches_the_tower_and_holds_the_contract(S, monkeypatch):
    cfg = S["cfg"]
    cfg2 = with_q(cfg, decode_chunk2=4096)
    one = trender(S, cfg)
    rows = []
    orig = tfr._decode_tail

    def spy(params, cfg_, Rw2c, camrotc2w, campos, nsel, *a, **k):
        rows.append(nsel.shape[0])
        return orig(params, cfg_, Rw2c, camrotc2w, campos, nsel, *a, **k)

    monkeypatch.setattr(tfr, "_decode_tail", spy)
    two = trender(S, cfg2)
    monkeypatch.setattr(tfr, "_decode_tail", orig)
    n_valid = int(two.n_valid_slots)
    M = S["rays"].shape[0] * 16
    assert M > 2048 and n_valid > 0
    # the tower takes the valid prefix in pieces of decode_chunk2 rows,
    # wider than the candidate stages' chunks of 2,048
    assert rows == [min(4096, M - s) for s in range(0, n_valid, 4096)]
    # the reference's own contract for the two phases (test_raster.py)
    np.testing.assert_array_equal(two.ray_mask.numpy(), one.ray_mask.numpy())
    a, b = one.coarse_raycolor.numpy(), two.coarse_raycolor.numpy()
    np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
    assert (a != b).mean() < 1e-3
    want = jrender(S, cfg2)
    counters_equal(two, want, ("cb_overflow", "n_valid_slots"))
    within(two, want)


# ---- route 1: chunk_mode="fused" outside the whole fused chunk ----------

def test_fused_chunk_mode_with_fused_decode2_runs_select_then_decode2(
        S, monkeypatch):
    cfg = with_agg(with_q(S["cfg"], chunk_mode="fused"), fused_decode2=True)
    tc = port_cfg(cfg)
    assert tfr._check_served(tc, torch.eye(3), False) == "staged"
    calls = {"select": 0, "decode2": 0}
    sel, dec = tfr.fused_candidate_select, tfr.fused_decode2

    def count(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    monkeypatch.setattr(tfr, "fused_candidate_select", count("select", sel))
    monkeypatch.setattr(tfr, "fused_decode2", count("decode2", dec))
    got = trender(S, tc)
    assert calls == {"select": 1, "decode2": 1}
    staged = trender(S, with_agg(with_q(S["cfg"], knn_mode="fused"),
                                 fused_decode2=True))
    same(got, staged)
    want = jrender(S, S["cfg"], key="xla")
    counters_equal(got, want, ("cb_overflow", "n_valid_slots"))
    within(got, want)


@pytest.mark.parametrize("agg_kw", [{}, {"agg_intrp_order": 1}],
                         ids=["float32", "order1"])
def test_fused_chunk_mode_outside_the_gate_runs_select_then_tail(
        S, monkeypatch, agg_kw):
    base = with_agg(S["cfg"], **agg_kw)
    tc = port_cfg(with_q(base, chunk_mode="fused"))
    assert not tfr.fused_chunk_eligible(tc.agg, False, tc.query.K)
    assert tfr._check_served(tc, torch.eye(3), False) == "staged"
    calls = []
    sel = tfr.fused_candidate_select
    monkeypatch.setattr(tfr, "fused_candidate_select",
                        lambda *a: calls.append(1) or sel(*a))
    got = trender(S, tc)
    assert calls == [1]
    want = jrender(S, base, key="xla" if not agg_kw else "xla_order1")
    counters_equal(got, want, ("cb_overflow", "n_valid_slots"))
    within(got, want)


# ---- route 2: decode_mode="pair" ----------------------------------------

def test_pair_matches_reference_and_lanes(S):
    cfg = S["cfg"]
    lanes = jrender(S, cfg, key="xla")
    p8 = trender(S, with_q(cfg, decode_mode="pair", pair_budget=8))
    assert p8.pb_overflow is None
    within(p8, lanes, atol=2e-2, mean=1e-3, hits_only=True)
    cfg6 = with_q(cfg, decode_mode="pair", pair_budget=6)
    p6 = trender(S, cfg6)
    want6 = jrender(S, cfg6)
    counters_equal(p6, want6, ("pb_overflow", "n_valid_slots"))
    assert int(p6.pb_overflow) == 0
    within(p6, want6)
    starved = with_q(cfg, decode_mode="pair", pair_budget=1,
                     compact_budget=4)
    got = trender(S, starved)
    want = jrender(S, starved)
    assert int(got.pb_overflow) > 0
    counters_equal(got, want, ("pb_overflow", "cb_overflow",
                               "n_valid_slots"))
    # order 1 and a count-normalised kernel take the other segment sums
    for agg_kw in ({"agg_intrp_order": 1},
                   {"agg_distance_kernel": "numlinear"}):
        base = with_agg(cfg, **agg_kw)
        within(trender(S, with_q(base, decode_mode="pair", pair_budget=8)),
               trender(S, base), atol=2e-2, mean=1e-3, hits_only=True)


def test_pair_refuses_what_the_reference_refuses(S):
    cfg = with_q(S["cfg"], decode_mode="pair")
    for bad in (with_q(cfg, knn_mode="fused"),
                with_agg(cfg, fused_decode2=True),
                with_agg(cfg, agg_intrp_order=0, point_color_mode=False,
                         point_dir_mode=False)):
        with pytest.raises(ValueError, match="decode_mode='pair'"):
            tfr.fast_render_rays(None, torch.eye(3), S["tcache"], None, None,
                                 torch.zeros(4, 3), 1.0, 3.0, port_cfg(bad),
                                 None, None)


# ---- route 3: extract_mode="krows" --------------------------------------

def test_krows_slim_words_and_bit_identical_render(S):
    cfg = with_q(S["cfg"], extract_mode="krows")
    jcache, _, _ = jfr.make_fast_scene(cfg, S["s"].cloud, S["s"].grid)
    tcache = tscene(S, cfg)
    np.testing.assert_array_equal(
        tcache.slim.view(torch.int32).numpy(),
        np.asarray(jcache.slim).view(np.int32))
    base = trender(S, S["cfg"], cache=tcache)
    got = trender(S, cfg, cache=tcache)
    same(got, base)
    with pytest.raises(ValueError, match="krows"):
        tscene(S, with_q(cfg, knn_mode="fused"))


# ---- route 4: base_cache -------------------------------------------------

def test_base_cache_table_and_render(S):
    s = S["s"]
    cfg = with_q(S["cfg"], base_cache=True)
    tc = port_cfg(cfg)
    with pytest.raises(ValueError, match="params"):
        tscene(S, cfg)
    params = params_for(S, tc)
    tcache = tscene(S, cfg, params=params)
    jcache, _, _ = jfr.make_fast_scene(cfg, s.cloud, s.grid,
                                       params=s.params)
    with jax.default_matmul_precision("highest"):
        want_h = np.asarray(jcache.base_h.astype(jnp.float32))
    got_h = tcache.base_h.float().numpy()
    assert got_h.shape == want_h.shape == (s.cloud.xyz.shape[0], 256)
    # one bf16 rounding of float32 sums in another order
    np.testing.assert_allclose(got_h, want_h, rtol=2 ** -7, atol=1e-5)
    got = trender(S, tc, cache=tcache)
    within(got, jrender(S, cfg, cache=jcache))
    within(got, trender(S, S["cfg"]), atol=5e-3, mean=5e-4, hits_only=True)
    # with krows and with pair
    for kw in ({"extract_mode": "krows"},
               {"decode_mode": "pair", "pair_budget": 6}):
        c2 = with_q(cfg, **kw)
        within(trender(S, c2, cache=tscene(S, c2, params=params)), got,
               atol=4e-2, mean=1e-3, hits_only=True)
    with pytest.raises(ValueError, match="base_h"):
        trender(S, cfg)


# ---- route 5: cand_prune -------------------------------------------------

def test_cand_prune_words_and_bit_identical_render(S, capsys):
    s = S["s"]
    cfg = with_q(S["cfg"], cand_prune=True)
    jcache, _, _ = jfr.make_fast_scene(cfg, s.cloud, s.grid)
    tcache = tscene(S, cfg)
    out = capsys.readouterr().out
    assert f"cand_prune: width {S['tcache'].cand} -> {tcache.cand}" in out
    assert tcache.cand < S["tcache"].cand
    words = torch.cat([tcache.kmeta[..., None], tcache.kcand[
        ..., :tfr.PAYW].contiguous().view(torch.int32)], -1)
    np.testing.assert_array_equal(
        words.reshape(tcache.max_q, -1).numpy(),
        np.asarray(jcache.rows).view(np.int32))
    same(trender(S, cfg, cache=tcache), trender(S, S["cfg"]))


# ---- route 6: span tiers -------------------------------------------------

def test_span_tiers_bit_exact_and_counted(S):
    s = S["s"]
    q = S["cfg"].query
    args = (s.campos, S["rays"], s.near, s.far, q.z_depth_dim,
            s.grid.ranges_min, s.grid.dims, q.scaled_vsize)
    widths, budgets = tfr.measured_span_tiers(*args, round_to=64)
    assert (widths, budgets) == jfr.measured_span_tiers(*args, round_to=64)
    assert len(widths) >= 2
    flat = with_q(S["cfg"], compact_budget=0,
                  depth_window=tfr.measured_depth_window(*args))
    base = trender(S, flat)
    tiers = with_q(S["cfg"], compact_budget=0, span_tiers=widths,
                   span_tier_budgets=budgets)
    got = trender(S, tiers)
    assert int(got.rb_overflow) == int(got.dw_overflow) == 0
    assert got.cb_overflow is None and int(base.dw_overflow) == 0
    same(got, base)
    assert int(got.n_valid_slots) == int(base.n_valid_slots)
    # each starved tier drops rays; a short last width drops samples
    for i in range(len(widths)):
        starved = with_q(tiers, span_tier_budgets=budgets[:i] + (
            max(budgets[i] // 8, 1),) + budgets[i + 1:])
        assert int(trender(S, starved).rb_overflow) > 0, i
    short = with_q(tiers, span_tiers=widths[:-1] + (widths[-2] + 1,))
    assert int(trender(S, short).dw_overflow) > 0


# ---- route 7: coarse_step -----------------------------------------------

def test_coarse_step_exact_and_counted(S):
    s = S["s"]
    cfg = with_q(S["cfg"], coarse_step=5, coarse_win_budget=12,
                 coarse_win_global=8)
    tcache = tscene(S, cfg, **near_far(S))
    jcache, _, _ = jfr.make_fast_scene(cfg, s.cloud, s.grid, near=s.near,
                                       far=s.far)
    np.testing.assert_array_equal(tcache.coarse_occ.numpy(),
                                  np.asarray(jcache.coarse_occ))
    got = trender(S, cfg, cache=tcache)
    assert int(got.win_overflow) == 0
    same(got, trender(S, S["cfg"]))
    for dw in (0, 20):
        c = with_q(cfg, coarse_win_budget=1, depth_window=dw)
        g = trender(S, c, cache=tcache)
        w = jrender(S, c, cache=jcache)
        assert int(g.win_overflow) > 0
        counters_equal(g, w, ("win_overflow", "dw_overflow", "cb_overflow",
                              "n_valid_slots"))
        within(g, w)
    with pytest.raises(ValueError, match="coarse_occ"):
        trender(S, cfg)


# ---- route 8: one-hot compaction and the grid composite -----------------

def test_onehot_select_exact_for_large_ids():
    rng = np.random.default_rng(3)
    R, D, BP = 64, 96, 16
    mask = rng.random((R, D)) < 0.25
    qs = np.where(mask, rng.integers(0, 2 ** 20, (R, D)), -1).astype(np.int32)
    d_true = np.broadcast_to(np.arange(D, dtype=np.int32) * 11, (R, D))
    rank = np.cumsum(mask, -1).astype(np.int32)
    keep = mask & (rank <= BP)
    want = jfr.onehot_select_qd(jnp.asarray(keep), jnp.asarray(rank),
                                jnp.asarray(qs), jnp.asarray(d_true), BP)
    got = tfr.onehot_select_qd(torch.as_tensor(keep), torch.as_tensor(rank),
                               torch.as_tensor(qs), torch.as_tensor(d_true.copy()),
                               BP)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_onehot_and_grid_composite(S):
    grid = with_q(S["cfg"], composite_mode="grid")
    onehot = with_q(S["cfg"], compact_mode="onehot")
    g = trender(S, grid)
    o = trender(S, onehot)
    same(o, g)
    counters_equal(o, g, ("cb_overflow", "n_valid_slots"))
    packed = trender(S, S["cfg"])
    np.testing.assert_array_equal(g.ray_mask.numpy(), packed.ray_mask.numpy())
    for f in ("coarse_raycolor", "acc"):
        np.testing.assert_allclose(getattr(g, f).numpy(),
                                   getattr(packed, f).numpy(), atol=1e-5)
    want = jrender(S, onehot)
    counters_equal(o, want, ("cb_overflow", "n_valid_slots"))
    within(o, want)
    # the one-hot compaction with a finite budget and a depth window
    c = with_q(onehot, compact_budget=4, depth_window=30)
    counters_equal(trender(S, c), trender(S, with_q(c, compact_mode="topk",
                                                    composite_mode="grid")),
                   ("cb_overflow", "dw_overflow", "n_valid_slots"))


# ---- route 12: render_frame's render_maker ------------------------------

def test_render_maker_gives_the_default_frame(S):
    s = S["s"]
    tc = port_cfg(S["cfg"])
    params = params_for(S, tc)
    args = (params, T(s.cloud.Rw2c), S["tcache"], T(s.campos),
            T(s.camrotc2w), T(S["rays"]), s.near, s.far, tc, T(S["rmin"]),
            T(S["svs"]))
    made = []

    def maker(c):
        made.append((c.query.depth_window, c.query.compact_budget))

        def fn(rays, bg):
            return tfr.fast_render_rays(*args[:5], rays, *args[6:8], c,
                                        *args[9:], bg_ray_colors=bg)
        return fn

    kw = dict(chunk=128, tier_quant=8)
    want = tfr.render_frame(*args, **kw)
    got = tfr.render_frame(*args, render_maker=maker, **kw)
    same(got, want)
    assert made and len(made) == len(set(made))
    counters_equal(got, want, ("dw_overflow", "cb_overflow"))
