"""The port's perf probes against the JAX reference's, on the CPU: every
key of `fast_render_rays(debug_ablate=)`, `chunk_pipeline` with each
chunk probe, its `skip_policy`, and the refusals, on the sphere scene of
tests/test_fast_render.py (4,000 points, sr 16, D 48, 16 slots a ray),
float32 compute, matmuls at "highest" precision on the JAX side, the
reference's weights and cache carried over by convert.py and pinned to
one draw (tests/pinned_weights.py).

  * Each of the 14 keys under the packed and the grid composite, with a
    depth window and a ray budget of every ray (the grid of the
    reference's test_debug_ablate_paths_run), 8x8 rays: ray_mask and every
    counter exactly, colour and acc within rtol 1e-4 / atol 1e-5.
  * `chunk_pipeline` with each chunk probe and None on the reference's own
    compaction outputs of 16x16 rays (all D samples looked up,
    select_first_cols, rank_gather_pack): found and pb exactly, sigma and
    rgb within the same bound.
  * skip_policy "prefix" against "any" on a mask with a hole at the start
    of a chunk (valid slots after it), single-phase and two-phase: the
    chunk after the hole is dropped under "prefix" and rendered under
    "any", in both packages alike.
  * A probe with the prob outputs (want_attrs) raises ValueError in both;
    an unknown key raises ValueError in the port (the reference ignores
    it).

The JAX calls are batched into a few jitted programs, each compiled in a
thread while the next is traced (`jax_batch`)."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.models import fast_render as tfr
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.models import fast_render as jfr
from pointnerf2studio_tpu.ops.select import (
    rank_gather_pack, select_first_cols)

torch.set_num_threads(1)

COUNTERS = ("win_overflow", "dw_overflow", "rb_overflow", "cb_overflow",
            "mc_overflow", "pb_overflow", "n_valid_slots")


def port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)))


def with_q(cfg, **kw):
    return dataclasses.replace(cfg, query=dataclasses.replace(cfg.query,
                                                              **kw))


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def S():
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, compute_dtype="float32"),
        query=dataclasses.replace(cfg.query, ray_slot_budget=16,
                                  use_cache=False, compact_mode="topk"))
    with jax.default_matmul_precision("highest"):
        s = make_sphere_scene(n_points=4000, cfg=cfg)
        cache, rmin, svs = jfr.make_fast_scene(cfg, s.cloud, s.grid)
    tc = port_cfg(cfg)
    return dict(
        s=s, cfg=cfg, cache=cache, rmin=rmin, svs=svs,
        params=convert.aggregator_from_jax(
            jax.tree.map(np.asarray, s.params), tc.agg, device="cpu"),
        tcache=convert.fat_cache_from_jax(cache, device="cpu"))


def jax_batch(fn, variants, *args, groups=1):
    """{variant: fn(variant, *args)} as numpy, from `groups` jitted
    programs (one compile for many variants, in place of one each); a
    group compiles in a thread while the next one is traced."""
    n = -(-len(variants) // groups)
    parts = [variants[i:i + n] for i in range(0, len(variants), n)]
    with jax.default_matmul_precision("highest"), \
            ThreadPoolExecutor(len(parts)) as pool:
        progs = [pool.submit(jax.jit(
            lambda *a, part=part: {str(v): fn(v, *a) for v in part})
            .lower(*args).compile) for part in parts]
        out = {k: v for p in progs for k, v in p.result()(*args).items()}
    return {v: jax.tree.map(np.asarray, out[str(v)]) for v in variants}


def frame_cfg(S, composite):
    """The reference test's grid: a depth window and a ray budget of every
    one of the 8x8 rays."""
    return with_q(S["cfg"], composite_mode=composite,
                  depth_window=S["cfg"].query.z_depth_dim - 8, ray_budget=64)


def rays8(s):
    return np.asarray(camera_rays(s.campos, s.camrotc2w, 8, 8, 6.0))


def port_render(S, cfg, rays, **kw):
    s = S["s"]
    return tfr.fast_render_rays(
        S["params"], T(s.cloud.Rw2c), S["tcache"], T(s.campos),
        T(s.camrotc2w), T(rays), s.near, s.far, port_cfg(cfg), T(S["rmin"]),
        T(S["svs"]), **kw)


@pytest.fixture(scope="module")
def frames(S):
    """The reference's frames of every probe under both composites, and
    (packed) of no probe and of an unknown key."""
    s = S["s"]
    variants = ([(k, "packed") for k in tfr.PROBES + (None, "tower")]
                + [(k, "grid") for k in tfr.PROBES])

    def render(v, params, Rw2c, cache, rays):
        return jfr.fast_render_rays(
            params, Rw2c, cache, s.campos, s.camrotc2w, rays, s.near, s.far,
            frame_cfg(S, v[1]), S["rmin"], S["svs"], debug_ablate=v[0])
    return jax_batch(render, variants, s.params, s.cloud.Rw2c, S["cache"],
                     jnp.asarray(rays8(s)), groups=3)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("composite", ["packed", "grid"])
@pytest.mark.parametrize("key", tfr.PROBES)
def test_fast_render_probe_matches_jax(S, frames, key, composite):
    want = frames[(key, composite)]
    got = port_render(S, frame_cfg(S, composite), rays8(S["s"]),
                      debug_ablate=key)
    for f in COUNTERS:
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            assert int(g) == int(w), (f, int(g), int(w))
    assert int(got.n_valid_slots) > 0
    np.testing.assert_array_equal(got.ray_mask.numpy(), want.ray_mask)
    assert got.ray_mask.any()
    close(got.coarse_raycolor, want.coarse_raycolor)
    close(got.acc, want.acc)


@pytest.fixture(scope="module")
def packed(S):
    """The reference's compaction outputs of 16x16 rays, as the reference
    tools make them: all D samples looked up, the first BP valid columns
    packed to M = R * 16 slots (two chunks of 2,048)."""
    s, cfg, cache = S["s"], S["cfg"], S["cache"]
    q = cfg.query
    rays = camera_rays(s.campos, s.camrotc2w, 16, 16, 12.0)
    R, D, BP = rays.shape[0], q.z_depth_dim, q.ray_slot_budget
    dims = cache.coor_2_qslot.shape
    near, far = jnp.asarray(s.near), jnp.asarray(s.far)
    step_t = (far - near) / D

    @jax.jit
    def compaction(rays, table):
        t_mid = near + (jnp.arange(D, dtype=jnp.float32) + 0.5) * step_t
        pos = s.campos + rays[:, None, :] * t_mid[None, :, None]
        gc = jnp.floor((pos - S["rmin"]) / S["svs"]).astype(jnp.int32)
        inb = jnp.all((gc >= 0) & (gc < jnp.array(dims)), axis=-1)
        gcc = jnp.clip(gc, 0, jnp.array(dims) - 1)
        fi = (gcc[..., 0] * dims[1] + gcc[..., 1]) * dims[2] + gcc[..., 2]
        qs = jnp.where(inb, table.reshape(-1)[jnp.where(inb, fi, 0)], -1)
        col_sel, cnt, _ = select_first_cols(qs, BP, min(q.SR, BP, D))
        sel_ray, _, colm, _, qslot_c, mask_c = rank_gather_pack(
            qs, col_sel, cnt, R * 16)
        return qslot_c, sel_ray, colm, mask_c
    return dict(rays=np.asarray(rays), near=np.float32(s.near),
                step=np.asarray(step_t),
                comp=[np.asarray(x) for x in compaction(
                    rays, cache.coor_2_qslot)])


def jax_pipelines(S, cfg, P, comp, variants, **kw):
    """{variant: the reference's chunk_pipeline outputs} with the probe
    (or, where `kw` names the argument varied, that argument) set to each
    variant, from one jitted program."""
    s = S["s"]
    name = "skip_policy" if "skip_policy" in kw else "debug_ablate"
    kw.pop("skip_policy", None)

    def run(v, params, Rw2c, cache, *a):
        return jfr.chunk_pipeline(
            params, Rw2c, cache, a[0], s.campos, s.camrotc2w, a[1], a[2],
            cfg, S["rmin"], S["svs"], *a[3:], **{name: v}, **kw)
    return jax_batch(run, variants, s.params, s.cloud.Rw2c, S["cache"],
                     *(jnp.asarray(x) for x in (P["rays"], P["near"],
                                                P["step"], *comp)))


def port_pipeline(S, cfg, P, comp, **kw):
    s = S["s"]
    return tfr.chunk_pipeline(
        S["params"], T(s.cloud.Rw2c), S["tcache"], T(P["rays"]),
        T(s.campos), T(s.camrotc2w), T(P["near"]), T(P["step"]),
        port_cfg(cfg), T(S["rmin"]), T(S["svs"]), *(T(x) for x in comp),
        **kw)


@pytest.fixture(scope="module")
def pipes(S, packed):
    cfg = with_q(S["cfg"], fast_chunk=2048)
    return cfg, jax_pipelines(S, cfg, packed, packed["comp"],
                              (None,) + tfr.CHUNK_PROBES)


@pytest.mark.parametrize("key", [None] + list(tfr.CHUNK_PROBES))
def test_chunk_pipeline_probe_matches_jax(S, packed, pipes, key):
    cfg, want = pipes[0], pipes[1][key]
    got = port_pipeline(S, cfg, packed, packed["comp"], debug_ablate=key)
    assert len(got) == len(want) == 4
    sig, rgb, found, pb = got
    assert sig.shape == (packed["comp"][0].shape[0],) and rgb.shape[1] == 3
    np.testing.assert_array_equal(found.numpy(), want[2])
    assert int(pb) == int(want[3]) == 0
    assert found.any()
    close(sig, want[0])
    close(rgb, want[1])


@pytest.mark.parametrize("two_phase", [False, True])
def test_skip_policy_prefix_drops_a_chunk_behind_a_hole(S, packed,
                                                         two_phase):
    """Slots 0..n-1 and 2049..2048+n hold the same valid slots, slot 2048
    (the start of the second chunk of 2,048) is padding: "prefix" skips
    that chunk, "any" renders it."""
    qslot_c, sel_ray, sel_d, mask_c = packed["comp"]
    n = int(mask_c.sum())
    assert 0 < n < 2047
    comp = []
    for x in (qslot_c, sel_ray, sel_d, mask_c):
        y = np.zeros_like(x)
        y[:n] = x[:n]
        y[2049:2049 + n] = x[:n]
        comp.append(y)
    cfg = with_q(S["cfg"], fast_chunk=2048,
                 decode_chunk2=1024 if two_phase else 0)
    want = jax_pipelines(S, cfg, packed, comp, ("prefix", "any"),
                         skip_policy=None)
    got = {p: port_pipeline(S, cfg, packed, comp, skip_policy=p)
           for p in ("prefix", "any")}
    for p in got:
        np.testing.assert_array_equal(got[p][2].numpy(), want[p][2])
        close(got[p][0], want[p][0])
        close(got[p][1], want[p][1])
    found_p, found_a = got["prefix"][2], got["any"][2]
    assert torch.equal(found_p[:2048], found_a[:2048])
    assert found_a[:n].any()
    assert not found_p[2048:].any()
    assert torch.equal(found_a[2049:2049 + n], found_a[:n])
    with pytest.raises(ValueError, match="skip_policy"):
        port_pipeline(S, cfg, packed, comp, skip_policy="all")


def test_probe_refusals(S, packed, frames):
    s = S["s"]
    with pytest.raises(ValueError, match="want_attrs"):
        frame_prob = jax.jit(lambda rays: jfr.fast_render_rays(
            s.params, s.cloud.Rw2c, S["cache"], s.campos, s.camrotc2w, rays,
            s.near, s.far, S["cfg"], S["rmin"], S["svs"],
            debug_ablate="decode", prob=True))
        frame_prob(jnp.asarray(rays8(s)))
    with pytest.raises(ValueError, match="want_attrs"):
        port_render(S, S["cfg"], rays8(s), debug_ablate="decode", prob=True)
    with pytest.raises(ValueError, match="want_attrs"):
        jax_pipelines(S, S["cfg"], packed, packed["comp"], ("knn",),
                      want_attrs=True)
    with pytest.raises(ValueError, match="want_attrs"):
        port_pipeline(S, S["cfg"], packed, packed["comp"],
                      debug_ablate="knn", want_attrs=True)
    # the reference renders an unknown key as no probe; the port refuses it
    for f in ("coarse_raycolor", "ray_mask", "acc"):
        np.testing.assert_array_equal(getattr(frames[("tower", "packed")], f),
                                      getattr(frames[(None, "packed")], f))
    with pytest.raises(ValueError, match="unknown debug_ablate"):
        port_render(S, frame_cfg(S, "packed"), rays8(s),
                    debug_ablate="tower")
    with pytest.raises(ValueError, match="unknown debug_ablate"):
        port_pipeline(S, S["cfg"], packed, packed["comp"],
                      debug_ablate="tower")
