"""The port's multi-device execution (parallel/sharding.py on
torch.distributed) against the JAX reference's sharded programs on the
8-device virtual CPU mesh, and against the port's own single-device
path, on the CPU: gloo ranks spawned from the test, one thread a rank,
on the sphere scene of tests/test_sharding.py (2,000 points, sr 8, D 32,
16x16 rays), float32 compute, matmuls at "highest" precision on the JAX
side.

Two worlds are spawned once each: two ranks as a 1-D "rays" mesh and
four as a 2x2 ("rays", "points") mesh. Every rank runs every job and
saves what it computed; the tests read those files.

  * The ray-sharded and the point-sharded legacy render against the JAX
    sharded render: ray_mask equal, colour within rtol 1e-4 / atol 1e-5
    (tests/test_sharding.py's own bound). The point-sharded fat-cache
    render against JAX: colour within atol 1e-6, acc within 1e-5, and
    equal to the port's unsharded render bit for bit (each valid slot has
    one owner, so the psum adds zeros); the ray-sharded fast render equal
    to the unsharded one bit for bit, its counters summed.
  * The sharded train steps (legacy, fast on the dense and on the hash
    GeoCache; 1-D and 2x2) against the JAX sharded step, jitter off: loss
    within 1e-5 relative, and every gradient element within 1e-5 * max|g|
    of the JAX step's gradient divided by n, plus the two single-device
    gaps of that element on the same weights (`held`): the port's
    single-device gradient against the reference's, itself held to the
    single-device parity bound (rtol 2e-3 / atol 1e-6, as in
    tests/test_torch_legacy_train.py), and the reference's sharded / n
    against its own single-device gradient. The JAX step hands its
    optimizer n times the gradient (the fault test below): n = n_rays = 2
    for the tower, and n_rays * n_points = 4 for the point attributes of
    the 2x2 legacy step, whose gather adds a psum over "points". Its
    gradients are read through its own optimizer update: optax's Adam is
    replaced, for the JAX steps only, by a transformation that moves no
    weight and keeps the gradient it is handed as its state. The 2x2 fast
    steps are held to the JAX 1-D fast step: both shard the rays in two,
    and the reference's fast step keeps the state replicated over
    "points".
  * The same steps against the port's single-device step on the same
    injected jitter_u: loss within 1e-6 relative, every gradient within
    1e-5 * max|g|.
  * The fault: a psum'd loss's gradient under the reference's
    shard_map(check_vma=False), psum'd over "rays" as its steps do, is
    n times the single-device gradient; the port's is the gradient.
  * The structure sequence of the reference's multi-device dry run on the
    2x2 mesh: capacity expansion to a multiple of n_points, probe and
    grow into a cut hole, prune, each with the state re-sharded with its
    Adam moments, then a step; every rank ends with the same state.

The JAX modules are imported inside the fixtures: the spawned ranks
import this module to find their function and need no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.data.blender import BlenderDataset
from pointnerf2studio_torch.models import neural_points as tnp
from pointnerf2studio_torch.models.fast_render import (
    build_slim, fast_render_rays)
from pointnerf2studio_torch.models.fast_train import make_fast_train_step
from pointnerf2studio_torch.models.render import render_rays
from pointnerf2studio_torch.ops.grid import build_grid_from_points
from pointnerf2studio_torch.parallel import sharding as sh
from pointnerf2studio_torch.train.grow import probe_and_grow
from pointnerf2studio_torch.train.trainer import (
    MOMENTS, create_train_state, expand_state_capacity, make_train_step)

torch.set_num_threads(1)

STEPS = ("legacy", "fast", "hash")
KINDS = ("1d", "2x2")
# the factor n of the JAX sharded step's gradient (tower, point
# attributes): psum transposes into psum over "rays", and on the 2x2 legacy
# step the attribute gather's psum over "points" adds its own
JAX_GRAD_FACTOR = {"legacy_1d": (2, 2), "legacy_2x2": (2, 4),
                   "fast": (2, 2), "hash": (2, 2)}


def port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)),
        train=tcfg.TrainConfig(**dataclasses.asdict(cfg.train)))


def with_jitter(cfg, jitter):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, jitter=jitter))


# ---------------------------------------------------------------- the ranks

def _np(x):
    return x.detach().cpu().numpy()


def _weights(st):
    tree = convert.aggregator_to_jax(st.params)
    return ({f"{n}[{i}].{k}": lyr[k] for n, lyrs in tree.items()
             for i, lyr in enumerate(lyrs) for k in ("kernel", "bias")},
            {k: _np(v) for k, v in st.points.trainable().items()})


def _point_grads(st, mesh):
    """The point attributes' gradients, whole on every rank."""
    pts = sh.points_axis(mesh)
    return {k: _np(sh.gather_blocks(v.grad, pts)[:v.shape[0] * (
        1 if pts is None else pts.size)])
        for k, v in st.points.trainable().items()}


def _grads(st, mesh):
    return ([_np(p.grad) for p in st.params.parameters()],
            _point_grads(st, mesh))


def _tower_grads(st):
    """The tower's gradients named as the JAX tree names its weights."""
    tree = convert.aggregator_to_jax(st.params, grad=True)
    return {f"{n}[{i}].{k}": lyr[k] for n, lyrs in tree.items()
            for i, lyr in enumerate(lyrs) for k in ("kernel", "bias")}


def _grad_tree(st, mesh):
    return _tower_grads(st), _point_grads(st, mesh)


def _step(d, mesh, kind, cfg, st, **kw):
    if kind == "legacy":
        return sh.make_sharded_train_step(cfg, mesh)(
            st, d["grid"], d["campos"], d["camrot"], d["rays"], d["gt"],
            d["near"], d["far"], **kw)
    geo, rmin, svs = d["geo"] if kind == "fast" else d["hgeo"]
    return sh.make_sharded_fast_train_step(cfg, mesh)(
        st, geo, rmin, svs, d["campos"], d["camrot"], d["rays"], d["gt"],
        d["near"], d["far"], **kw)


def _structure(d, mesh):
    """The dry run's sequence (reference __graft_entry__.py:199-300) on a
    sharded state: a step, capacity expansion, probe and grow, prune, each
    with the state whole for the event and re-sharded after it, then a
    step."""
    cfg = d["cfg0"]
    cloud = dataclasses.replace(d["cloud"], alive=d["cloud"].alive
                                & ~d["hole"])
    st = sh.shard_state(create_train_state(d["params"], cloud, cfg), mesh)
    grid = build_grid_from_points(cloud.xyz, cloud.alive, cfg.query)
    step = sh.make_sharded_train_step(cfg, mesh)
    st, _ = step(st, grid, d["campos"], d["camrot"], d["rays"], d["gt"],
                 d["near"], d["far"])
    cap0 = st.points.capacity
    new_cap = cap0 + 8 * mesh.shape["rays"] + 1      # padded on re-shard
    with sh.whole_state(st, mesh):
        expand_state_capacity(st, new_cap)
    with sh.whole_state(st, mesh):
        st, grid, n_new = probe_and_grow(cfg, st, grid, d["teacher"],
                                         views=[0], chunk=192,
                                         opacity_thresh=0.05)
    n_grown_alive = int(st.points.num_alive)
    with sh.whole_state(st, mesh), torch.no_grad():
        st.points.points_conf[:64] = 0.01
        st.points = tnp.prune(st.points, 0.1)
    grid = build_grid_from_points(st.points.xyz, st.points.alive, cfg.query)
    st, aux = step(st, grid, d["campos"], d["camrot"], d["rays"], d["gt"],
                   d["near"], d["far"])
    local = st.points.points_embeding.shape[0]
    moments = [_np(st.opt_points.state[p][k]).shape[0]
               for p in st.points.trainable().values()
               for k in MOMENTS]
    sh.unshard_state(st, mesh)
    return dict(cap0=cap0, cap=st.points.capacity, n_new=n_new,
                n_grown_alive=n_grown_alive,
                n_alive=int(st.points.num_alive), local=local,
                moments=moments, loss=float(aux["total"]),
                state=_weights(st), alive=_np(st.points.alive),
                m={k: [_np(v) for v in st.opt_points.state[p].values()
                       if v.ndim]
                   for k, p in st.points.trainable().items()})


def _rank(rank, path, kind):
    torch.set_num_threads(1)
    d = torch.load(path, weights_only=False)
    mesh = (sh.make_mesh(device="cpu") if kind == "1d"
            else sh.make_mesh_2d(2, 2, device="cpu"))
    pts = sh.points_axis(mesh)
    res = {}
    args = (d["campos"], d["camrot"], d["rays"], d["near"], d["far"])
    out = sh.make_sharded_render(d["cfg0"], mesh)(
        d["params"], sh.shard_cloud(d["cloud"], pts), d["grid"], *args)
    res["render"] = (_np(out.coarse_raycolor), _np(out.ray_mask))
    cache, rmin, svs = d["cache"]
    if kind == "1d":
        render = sh.make_sharded_fast_render(d["cfg0"], mesh)
    else:
        render = sh.make_sharded_fast_render_pt(d["cfg0"], mesh)
        cache = sh.shard_fat_cache(cache, mesh)
        res["cache_rows"] = cache.max_q
        krows = sh.make_sharded_fast_render_pt(d["cfg_k"], mesh)(
            d["params"], d["cloud"].Rw2c,
            sh.shard_fat_cache(d["cache_k"], mesh), *args, rmin, svs)
        res["krows"] = _np(krows.coarse_raycolor)
    out = render(d["params"], d["cloud"].Rw2c, cache, *args, rmin, svs)
    res["fast"] = {f: _np(getattr(out, f)) for f in
                   ("coarse_raycolor", "ray_mask", "acc", "depth",
                    "n_valid_slots")}
    for kind_s in STEPS:
        st = sh.shard_state(create_train_state(d["params"], d["cloud"],
                                               d["cfg0"]), mesh)
        st, aux = _step(d, mesh, kind_s, d["cfg0"], st)
        res[f"jax_{kind_s}"] = (float(aux["total"]), _grad_tree(st, mesh))
        st = sh.shard_state(create_train_state(d["params"], d["cloud"],
                                               d["cfgj"]), mesh)
        st, aux = _step(d, mesh, kind_s, d["cfgj"], st, jitter_u=d["u"])
        res[f"single_{kind_s}"] = (float(aux["total"]), _grads(st, mesh))
    if kind == "1d":
        w = d["fault_w"].clone().requires_grad_(True)
        x = d["fault_x"][sh.ray_slice(d["fault_x"].shape[0],
                                      mesh.axis("rays"))]
        loss = sh.psum(((w * x) ** 2).sum(), mesh.axis("rays")) / float(
            d["fault_x"].numel())
        loss.backward()
        sh._allreduce_grads([w], mesh.axis("rays"))
        res["fault"] = _np(w.grad)
        try:
            sh.make_mesh(3, device="cpu")
        except ValueError as e:
            res["refused"] = str(e)
    else:
        res["structure"] = _structure(d, mesh)
    torch.save(res, f"{path}.{kind}.{rank}")


# ------------------------------------------------------------ the reference

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The scene and its caches are built by the reference and carried
    over; the two worlds of ranks run while the reference computes its
    sharded renders and steps."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P

    from pointnerf2studio_tpu.data.synthetic import (
        camera_rays, make_sphere_scene, sphere_config)
    from pointnerf2studio_tpu.models.fast_render import make_fast_scene
    from pointnerf2studio_tpu.models.fast_train import (
        make_fast_train_step as jfast_step, make_geo_scene,
        make_hash_geo_scene)
    from pointnerf2studio_tpu.ops.hash_grid import (
        build_hash_grid_from_points)
    from pointnerf2studio_tpu.parallel import sharding as jsh
    from pointnerf2studio_tpu.train import trainer as jtrainer
    from pointnerf2studio_tpu.train.trainer import (
        create_train_state as jstate)

    class KeepGrads:
        """optax, with the reference's Adam replaced by a transformation
        that moves no weight and keeps the gradient it is handed as its
        state: a sharded step's gradients come back in its opt states."""
        @staticmethod
        def adam(learning_rate):
            return optax.GradientTransformation(
                lambda p: jax.tree.map(jnp.zeros_like, p),
                lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))

        def __getattr__(self, name):
            return getattr(optax, name)

    cfg = sphere_config(sr=8, d=32)
    cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, jitter=0.0))
    rng = np.random.default_rng(0)
    fx = rng.standard_normal((8, 3)).astype(np.float32)
    fw = np.array([1.0, -2.0, 0.5], np.float32)
    with jax.default_matmul_precision("highest"):
        s = make_sphere_scene(n_points=2_000, cfg=cfg)
        rays = camera_rays(s.campos, s.camrotc2w, 16, 16, 12.0)
        R = rays.shape[0]
        gt = rng.random((R, 3)).astype(np.float32)
        cache, rmin, svs = make_fast_scene(cfg, s.cloud, s.grid)
        geo = make_geo_scene(cfg, s.cloud, s.grid)
        hg = build_hash_grid_from_points(s.cloud.xyz, s.cloud.alive,
                                         cfg.query)
        hgeo = make_hash_geo_scene(cfg, s.cloud, hg)

    pc = port_cfg(cfg)

    def t(a):
        return torch.as_tensor(np.array(a))

    def geo_t(g):
        return (convert.geo_cache_from_jax(g[0], device="cpu"), t(g[1]),
                t(g[2]))

    xyz = np.asarray(s.cloud.xyz)
    d = dict(cfg0=pc, cfgj=with_jitter(pc, 0.3),
             params=convert.aggregator_from_jax(s.params, pc.agg,
                                                device="cpu"),
             cloud=convert.cloud_from_jax(s.cloud, device="cpu"),
             grid=convert.grid_from_jax(s.grid, device="cpu"),
             campos=t(s.campos), camrot=t(s.camrotc2w), rays=t(rays),
             near=float(s.near), far=float(s.far), gt=t(gt),
             u=torch.as_tensor(rng.random((R, cfg.query.z_depth_dim))
                               .astype(np.float32)),
             cache=(convert.fat_cache_from_jax(cache, device="cpu"),
                    t(rmin), t(svs)),
             geo=geo_t(geo), hgeo=geo_t(hgeo),
             hole=torch.as_tensor(np.linalg.norm(xyz[:, :2], axis=-1)
                                  < 0.28),
             fault_w=t(fw), fault_x=t(fx))
    d["teacher"] = teacher(d, camera_rays)
    d["cfg_k"] = dataclasses.replace(pc, query=dataclasses.replace(
        pc.query, extract_mode="krows"))
    d["cache_k"] = dataclasses.replace(d["cache"][0],
                                       slim=build_slim(d["cache"][0]))
    path = str(tmp_path_factory.mktemp("sharding") / "inputs.pt")
    torch.save(d, path)
    worlds = {kind: sh.run_ranks(_rank, world, "gloo", (path, kind),
                                 join=False)
              for kind, world in (("1d", 2), ("2x2", 4))}

    want = {}
    with jax.default_matmul_precision("highest"), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "optax", KeepGrads())
        near, far = jnp.asarray(s.near), jnp.asarray(s.far)
        args = (s.campos, s.camrotc2w, rays, near, far)
        mesh1, mesh2 = jsh.make_mesh(2), jsh.make_mesh_2d(2, 2)
        for kind, mesh in (("1d", mesh1), ("2x2", mesh2)):
            out = jsh.make_sharded_render(cfg, mesh)(
                s.params, s.cloud, s.grid, *args)
            want[f"render_{kind}"] = (np.asarray(out.coarse_raycolor),
                                      np.asarray(out.ray_mask))
        out = jsh.make_sharded_fast_render_pt(cfg, mesh2)(
            s.params, s.cloud.Rw2c, jsh.shard_fat_cache(cache, mesh2),
            *args, rmin, svs)
        want["fast_pt"] = {f: np.asarray(getattr(out, f)) for f in
                           ("coarse_raycolor", "ray_mask", "acc", "depth")}
        key = jax.random.PRNGKey(0)
        for name, mesh in (("legacy_1d", mesh1), ("legacy_2x2", mesh2)):
            st = jstate(s.params, s.cloud, cfg)
            f = jsh.make_sharded_train_step(cfg, mesh, example_state=st)
            st, aux = f(st, s.grid, *args[:3], jnp.asarray(gt), near, far,
                        key)
            want[name] = (float(aux["total"]), st)
        f = jsh.make_sharded_fast_train_step(cfg, mesh1)
        for name, (g, gr, gs) in (("fast", geo), ("hash", hgeo)):
            st, aux = f(jstate(s.params, s.cloud, cfg), g, jnp.asarray(gr),
                        jnp.asarray(gs), *args[:3], jnp.asarray(gt), near,
                        far, key)
            want[name] = (float(aux["total"]), st)
        # the reference's single-device steps on the same weights and rays
        st, aux = jtrainer.make_train_step(cfg)(
            jstate(s.params, s.cloud, cfg), s.grid, *args[:3],
            jnp.asarray(gt), near, far, key)
        want["single_legacy"] = (float(aux["total"]), st)
        for name, (g, gr, gs) in (("fast", geo), ("hash", hgeo)):
            st, aux = jfast_step(cfg)(
                jstate(s.params, s.cloud, cfg), g, jnp.asarray(gr),
                jnp.asarray(gs), *args[:3], jnp.asarray(gt), near, far, key)
            want[f"single_{name}"] = (float(aux["total"]), st)

        # the fault: the gradient of psum(sum((w x)^2)) / psum(count)
        # inside shard_map(check_vma=False), psum'd over "rays" as the
        # reference's steps psum theirs
        def local(w, x):
            def loss(w):
                return (jax.lax.psum(jnp.sum((w * x) ** 2), "rays")
                        / jax.lax.psum(jnp.float32(x.size), "rays"))
            return jax.lax.psum(jax.grad(loss)(w), "rays")

        fmesh = Mesh(np.asarray(jax.devices()[:2]), ("rays",))
        g_sharded = jax.jit(jax.shard_map(
            local, mesh=fmesh, in_specs=(P(), P("rays")), out_specs=P(),
            check_vma=False))(jnp.asarray(fw), jnp.asarray(fx))
        g_single = jax.grad(lambda w: jnp.mean((w * fx) ** 2))(
            jnp.asarray(fw))
        want["fault"] = (np.asarray(g_sharded), np.asarray(g_single))

    one = single(d)
    got = {}
    for kind, ctx in worlds.items():
        sh.wait_ranks(ctx, timeout=600)
        got[kind] = [torch.load(f"{path}.{kind}.{r}", weights_only=False)
                     for r in range(len(ctx.processes))]
    return dict(d=d, want=want, got=got, single=one)


def teacher(d, camera_rays):
    """A 24x24 view of the intact scene through the port's legacy render,
    as the dry run renders its teacher view."""
    h = w = 24
    focal = 16.0
    rays = torch.as_tensor(np.array(camera_rays(
        d["campos"], d["camrot"].numpy(), h, w, focal)))
    with torch.no_grad():
        out = render_rays(d["params"], d["cloud"], d["grid"], d["campos"],
                          d["camrot"], rays, d["near"], d["far"], d["cfg0"])
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = d["camrot"].numpy()
    pose[:3, 3] = d["campos"].numpy()
    return BlenderDataset(
        images=_np(out.coarse_raycolor).reshape(1, h, w, 3),
        poses=pose[None],
        intrinsics=np.array([[focal, 0, w / 2], [0, focal, h / 2],
                             [0, 0, 1]], np.float32),
        near=d["near"], far=d["far"], split="train")


def single(d):
    """The port's single-device renders and steps on the same inputs: with
    the injected jitter draw, and at jitter 0 as the JAX steps run
    ("<kind>_nojitter", gradients named as the JAX tree names them)."""
    args = (d["campos"], d["camrot"], d["rays"], d["near"], d["far"])
    cache, rmin, svs = d["cache"]
    with torch.no_grad():
        out = fast_render_rays(d["params"], d["cloud"].Rw2c, cache, *args,
                               d["cfg0"], rmin, svs)
    res = {"fast_render": {f: _np(getattr(out, f)) for f in
                    ("coarse_raycolor", "ray_mask", "acc", "depth",
                     "n_valid_slots")}}
    with torch.no_grad():
        res["krows"] = _np(fast_render_rays(
            d["params"], d["cloud"].Rw2c, d["cache_k"], *args, d["cfg_k"],
            rmin, svs).coarse_raycolor)
    for kind in STEPS:
        for tag, cfg, kw in (("", d["cfgj"], dict(jitter_u=d["u"])),
                             ("_nojitter", d["cfg0"], {})):
            st = create_train_state(d["params"], d["cloud"], cfg)
            if kind == "legacy":
                st, aux = make_train_step(cfg)(
                    st, d["grid"], *args[:3], d["gt"], *args[3:], **kw)
            else:
                geo, gr, gs = d["geo"] if kind == "fast" else d["hgeo"]
                st, aux = make_fast_train_step(cfg)(
                    st, geo, gr, gs, *args[:3], d["gt"], *args[3:], **kw)
            points = {k: _np(v.grad)
                      for k, v in st.points.trainable().items()}
            res[kind + tag] = (float(aux["total"]), (
                _tower_grads(st) if tag
                else [_np(p.grad) for p in st.params.parameters()], points))
    return res


# -------------------------------------------------------------------- tests

@pytest.mark.parametrize("kind", KINDS)
def test_sharded_render_matches_jax(ref, kind):
    color, mask = ref["want"][f"render_{kind}"]
    assert mask.sum() > 20
    for res in ref["got"][kind]:
        np.testing.assert_array_equal(res["render"][1], mask)
        np.testing.assert_allclose(res["render"][0], color, rtol=1e-4,
                                   atol=1e-5)


def test_point_sharded_fast_render(ref):
    want, one = ref["want"]["fast_pt"], ref["single"]["fast_render"]
    n = ref["d"]["cache"][0].max_q
    assert want["ray_mask"].sum() > 20
    for res in ref["got"]["2x2"]:
        assert res["cache_rows"] == -(-n // 2)
        got = res["fast"]
        np.testing.assert_array_equal(got["ray_mask"], want["ray_mask"])
        np.testing.assert_allclose(got["coarse_raycolor"],
                                   want["coarse_raycolor"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got["acc"], want["acc"], rtol=0,
                                   atol=1e-5)
        for f in one:
            np.testing.assert_array_equal(got[f], one[f], err_msg=f)


def test_point_sharded_krows_render_equals_unsharded(ref):
    """The krows selection view of a point-sharded cache (rebuilt from the
    rank's slab) renders the unsharded krows frame bit for bit."""
    for res in ref["got"]["2x2"]:
        np.testing.assert_array_equal(res["krows"], ref["single"]["krows"])


def test_ray_sharded_fast_render_equals_unsharded(ref):
    one = ref["single"]["fast_render"]
    for res in ref["got"]["1d"]:
        for f in one:
            np.testing.assert_array_equal(res["fast"][f], one[f], err_msg=f)
    assert int(one["n_valid_slots"]) > 0


def jax_grads(st, n_f, n_p):
    """The gradients a JAX step handed its optimizer (KeepGrads), divided
    by its factors n: (tower leaves by name, point attributes)."""
    return ({f"{n}[{i}].{k}": np.asarray(lyr[k]) / n_f
             for n, lyrs in st.opt_state_fields.items()
             for i, lyr in enumerate(lyrs) for k in ("kernel", "bias")},
            {k: np.asarray(v) / n_p for k, v in st.opt_state_points.items()})


def held(a, b, one, port, what):
    """The port's sharded gradient `a` against the JAX sharded one / n `b`,
    element by element within 1e-5 * max|b| plus the element's two
    single-device gaps: the port's single-device gradient `port` against
    the reference's `one`, held to the single-device parity bound, and the
    reference's `b` against its own `one`. The float32 sums of the two
    packages run in other orders; where a pre-activation of the tower lies
    within that rounding of leaky_relu's kink, its derivative is 1 in one
    package and 0.1 in the other, in the single-device and the sharded step
    alike (ROADMAP section 3: one (sample, neighbour, unit) of mlp_head[0]
    at -3.7e-9 against +3.7e-9 under the pinned draw). What sharding adds
    must stay within 1e-5 * max|b|."""
    np.testing.assert_allclose(port, one, rtol=2e-3, atol=1e-6, err_msg=what)
    bound = 1e-5 * np.abs(b).max() + np.abs(port - one) + np.abs(one - b)
    assert (np.abs(a - b) <= bound).all(), (what, np.abs(a - b).max())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("step", STEPS)
def test_sharded_step_matches_jax(ref, kind, step):
    """The port's sharded gradient is the JAX sharded step's gradient
    divided by its factor n (JAX_GRAD_FACTOR), within 1e-5 * max|g| and
    the single-device gaps (`held`). That bound follows from
    test_sharded_step_matches_single_device (1e-5) and the two
    single-device gaps, so the sharded parity is carried by that
    port-against-port test; this one holds the factor n and the sharded
    loss to the reference's, and would fail a gradient off by a factor."""
    name = f"legacy_{kind}" if step == "legacy" else step
    loss_j, st_j = ref["want"][name]
    n_f, n_p = JAX_GRAD_FACTOR[name]
    want_f, want_p = jax_grads(st_j, n_f, n_p)
    one_f, one_p = jax_grads(ref["want"][f"single_{step}"][1], 1, 1)
    port_f, port_p = ref["single"][f"{step}_nojitter"][1]
    assert max(np.abs(b).max() for b in want_f.values()) > 0
    for res in ref["got"][kind]:
        loss, (g, gp) = res[f"jax_{step}"]
        assert abs(loss - loss_j) <= 1e-5 * abs(loss_j), (loss, loss_j)
        for k, b in want_f.items():
            held(g[k], b, one_f[k], port_f[k], k)
        for k, b in want_p.items():
            assert np.abs(b).max() > 0, k
            n = b.shape[0]
            held(gp[k][:n], b, one_p[k][:n], port_p[k][:n], k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("step", STEPS)
def test_sharded_step_matches_single_device(ref, kind, step):
    loss1, (g1, gp1) = ref["single"][step]
    for res in ref["got"][kind]:
        loss, (g, gp) = res[f"single_{step}"]
        assert abs(loss - loss1) <= 1e-6 * abs(loss1), (loss, loss1)
        for a, b in zip(g, g1):
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
        for k, b in gp1.items():
            a = gp[k][:b.shape[0]]
            assert np.abs(b).max() > 0, k
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), k


def test_psum_gradient_fault(ref):
    """The reference's sharded gradient is n = 2 times the single-device
    one (its psum transposes into a psum under check_vma=False); the
    port's is the gradient."""
    g_sharded, g_single = ref["want"]["fault"]
    np.testing.assert_allclose(g_sharded, 2.0 * g_single, rtol=1e-6)
    for res in ref["got"]["1d"]:
        np.testing.assert_allclose(res["fault"], g_single, rtol=1e-6)


def test_mesh_refuses_another_world_size(ref):
    for res in ref["got"]["1d"]:
        assert "mesh of 3 ranks" in res["refused"]


def test_structure_sequence_on_2x2(ref):
    runs = [res["structure"] for res in ref["got"]["2x2"]]
    r0 = runs[0]
    assert r0["cap"] % 2 == 0 and r0["cap"] > r0["cap0"]
    assert r0["n_new"] > 0
    assert r0["n_alive"] < r0["n_grown_alive"]
    assert np.isfinite(r0["loss"])
    for r in runs:
        assert r["local"] == r0["cap"] // 2
        assert r["moments"] == [r0["cap"] // 2] * len(r["moments"])
        np.testing.assert_array_equal(r["alive"], r0["alive"])
        for a, b in zip(r["state"], r0["state"]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in r0["m"]:
            for a, b in zip(r["m"][k], r0["m"][k]):
                np.testing.assert_array_equal(a, b, err_msg=k)


def test_padding_rows_take_no_slots(ref):
    """Ray packing pads its rows with copies of row 0; they take no slots:
    with ray 0 a hit ray and a ray budget of every row, the frame, its
    slot count and cb_overflow equal those without packing (a rank's
    shard of a chunk packs mostly padding rows)."""
    d = ref["d"]
    cache, rmin, svs = d["cache"]
    rays = torch.roll(d["rays"], -136, 0)          # the centre ray first
    outs = []
    for rb in (0, rays.shape[0]):
        cf = dataclasses.replace(d["cfg0"], query=dataclasses.replace(
            d["cfg0"].query, ray_budget=rb, compact_budget=2))
        with torch.no_grad():
            outs.append(fast_render_rays(
                d["params"], d["cloud"].Rw2c, cache, d["campos"],
                d["camrot"], rays, d["near"], d["far"], cf, rmin, svs))
    a, b = outs
    assert bool(a.ray_mask[0]) and int(b.rb_overflow) == 0
    assert int(b.n_valid_slots) == int(a.n_valid_slots) > 0
    assert int(b.cb_overflow) == int(a.cb_overflow)
    for f in ("coarse_raycolor", "ray_mask", "acc", "depth"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
