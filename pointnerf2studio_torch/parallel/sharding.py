"""Multi-device execution on torch.distributed: rays sharded over a mesh
of ranks, and optionally the point attributes (and their Adam moments)
or the fat cache's rows sharded over a second, "points", axis.

Port of `pointnerf2studio_tpu/parallel/sharding.py`. The reference runs
one SPMD program over a JAX mesh; here one process runs per rank, each
with its own device (`Mesh.device`), and every collective is an explicit
`all_reduce` over a process group:

  * `make_mesh` / `make_mesh_2d` wrap the already initialised default
    process group (`run_ranks` starts the processes and initialises it,
    the caller naming the backend: NCCL for one card a rank, gloo for the
    CPU or for ranks that share a card). Rank (i, j) of a 2-D mesh is
    rank i * n_points + j. The mesh raises where the world size differs
    from the mesh's size; it never shrinks.
  * `psum` (an autograd Function: forward all_reduce(SUM), backward the
    identity), `pmax` and `axis_index` are the reference's collectives.
    Downstream of every psum in the reference the computation is the same
    on every rank of the axis, so the identity is the right transpose.
  * The reference's `P("rays")` in-specs become `ray_slice`: shard i of
    n takes rows [i * R / n, (i + 1) * R / n). Its ray-sharded outputs
    come back whole on every rank (`gather_blocks`: zero-filled buffers and
    one all_reduce).
  * `cloud_pspec` / `state_pspec` become `shard_cloud` / `shard_state`
    (rows padded to a multiple of n_points with dead points, then cut)
    and `unshard_cloud` / `unshard_state`.
  * Gradients are all_reduce(SUM)'d over "rays" only. With the identity
    backward of `psum` that is the single-device gradient; the
    reference's steps, under `shard_map(check_vma=False)`, transpose
    psum into psum and hand Adam n times the gradient (ROADMAP section
    3).
  * Jitter: the reference folds the axis index into its PRNG key. Here
    every rank draws the whole batch's `jitter_u` [R, D] from its own
    generator (seeded alike on every rank) and takes its rows, so a
    sharded step can equal the single-device step on the same draws.

Each rank's compute runs on its device; collectives over gloo stage CUDA
tensors through host memory (all_reduce and broadcast only, which is all
this module uses).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pointnerf2studio_torch.ops._cuda import resolve_device
from pointnerf2studio_torch.train.trainer import (
    expand_state_capacity, rebind_points)

COUNTERS = ("win_overflow", "dw_overflow", "rb_overflow", "cb_overflow",
            "mc_overflow", "pb_overflow", "n_valid_slots")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named axis of a mesh as this rank sees it: its size, this
    rank's index on it, and the process group of the ranks that share
    every other coordinate with this one (None: the default group, which
    a 1-D mesh spans; a size-1 axis makes no collective)."""
    name: str
    size: int
    index: int
    group: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    axes: Tuple[Axis, ...]
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        n = 1
        for a in self.axes:
            n *= a.size
        return n

    @property
    def shape(self) -> Dict[str, int]:
        return {a.name: a.size for a in self.axes}

    def axis(self, name: str) -> Optional[Axis]:
        for a in self.axes:
            if a.name == name:
                return a
        return None


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start the ranks with run_ranks or call "
            "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _mesh_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, device=None,
              axis_name: str = "rays") -> Mesh:
    """The 1-D mesh over every rank of the default process group (the
    reference's `make_mesh`, axis "rays"; `axis_name="points"` gives the
    slab mesh of parallel/grid_shard.py). `device` is this rank's device
    (None: the card)."""
    world = _world()
    n = n_devices or world
    if n != world:
        raise ValueError(f"mesh of {n} ranks, but the process group has "
                         f"{world}")
    rank = dist.get_rank()
    return Mesh(axes=(Axis(axis_name, n, rank),), rank=rank,
                device=_mesh_device(device))


def make_mesh_2d(n_rays: int, n_points: int, device=None) -> Mesh:
    """The ("rays", "points") mesh (the reference's `make_mesh_2d`): rank
    (i, j) = rank i * n_points + j renders ray shard i against point
    shard j. Every rank creates every group, in one order."""
    world = _world()
    n = n_rays * n_points
    if n != world:
        raise ValueError(f"mesh of {n_rays} x {n_points} ranks, but the "
                         f"process group has {world}")
    rank = dist.get_rank()
    i, j = divmod(rank, n_points)
    rays_g = points_g = None
    if n_rays > 1:
        for jj in range(n_points):
            g = dist.new_group([ii * n_points + jj for ii in range(n_rays)])
            if jj == j:
                rays_g = g
    if n_points > 1:
        for ii in range(n_rays):
            g = dist.new_group([ii * n_points + jj
                                for jj in range(n_points)])
            if ii == i:
                points_g = g
    return Mesh(axes=(Axis("rays", n_rays, i, rays_g),
                      Axis("points", n_points, j, points_g)),
                rank=rank, device=_mesh_device(device))


def points_axis(mesh: Mesh) -> Optional[Axis]:
    """The mesh's "points" axis where it shards anything (size > 1)."""
    a = mesh.axis("points")
    return a if a is not None and a.size > 1 else None


# ---------------------------------------------------------------- collectives

def _all_reduce(x: torch.Tensor, axis: Axis, op) -> torch.Tensor:
    """A new tensor: x reduced over the axis. bool goes as int32."""
    if x.dtype == torch.bool:
        return _all_reduce(x.to(torch.int32), axis, op) > 0
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=op, group=axis.group)
    return y


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Sum over the axis; differentiable, its backward the identity (the
    cotangent is the same on every rank of the axis)."""
    if axis is None or axis.size == 1:
        return x
    if x.requires_grad:
        return _PSum.apply(x, axis)
    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Maximum over the axis (no gradient)."""
    if axis is None or axis.size == 1:
        return x
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def axis_index(axis: Optional[Axis]) -> int:
    """This rank's index on the axis (0 off a mesh)."""
    return 0 if axis is None else axis.index


# ---------------------------------------------------------- ray shards

def ray_slice(n_rows: int, axis: Optional[Axis]) -> slice:
    """This rank's rows of a ray-sharded array of n_rows rows
    (`P("rays")`): shard i takes [i * n / k, (i + 1) * n / k)."""
    if axis is None or axis.size == 1:
        return slice(0, n_rows)
    if n_rows % axis.size:
        raise ValueError(f"{n_rows} rays do not split over {axis.size} "
                         f"ranks of axis {axis.name!r}")
    per = n_rows // axis.size
    return slice(axis.index * per, (axis.index + 1) * per)


def gather_blocks(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The whole array from each rank's block of rows, in rank order, on
    every rank: a zero-filled buffer per rank, one all_reduce."""
    if axis is None or axis.size == 1:
        return x
    n = x.shape[0]
    full = torch.zeros((n * axis.size,) + tuple(x.shape[1:]),
                       dtype=torch.int32 if x.dtype == torch.bool
                       else x.dtype, device=x.device)
    full[axis.index * n:(axis.index + 1) * n] = x.detach()
    full = _all_reduce(full, axis, dist.ReduceOp.SUM)
    return full > 0 if x.dtype == torch.bool else full


def _gather_output(out, axis: Optional[Axis], whole: Sequence[str] = ()):
    """A render output with every tensor field gathered over the ray
    axis, except the `whole` fields (already replicated)."""
    kw = {}
    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        if (isinstance(v, torch.Tensor) and v.ndim >= 1
                and f.name not in whole):
            kw[f.name] = gather_blocks(v, axis)
    return dataclasses.replace(out, **kw)


def _psum_counters(out, axis: Optional[Axis]):
    """The exactness counters of a FastRenderOutput summed over the ray
    axis, so that they come back replicated (reference `_psum_counters`)."""
    kw = {f: psum(getattr(out, f), axis) for f in COUNTERS
          if getattr(out, f) is not None}
    return dataclasses.replace(out, **kw)


# ------------------------------------------------------- point shards

def padded_capacity(capacity: int, n: int) -> int:
    return -(-capacity // n) * n


def shard_cloud(cloud, axis: Optional[Axis]):
    """This rank's shard of a cloud (the reference's `cloud_pspec`): the
    capacity padded to a multiple of the axis size with dead rows, the
    trainable attributes cut to rows [j * n_local, (j + 1) * n_local),
    xyz, Rw2c and alive whole."""
    from pointnerf2studio_torch.models.neural_points import expand_capacity
    if axis is None or axis.size == 1:
        return cloud
    cloud = expand_capacity(cloud, padded_capacity(cloud.capacity,
                                                   axis.size))
    n_local = cloud.capacity // axis.size
    rows = slice(axis.index * n_local, (axis.index + 1) * n_local)
    return cloud.with_trainable({k: v[rows]
                                 for k, v in cloud.trainable().items()})


def unshard_cloud(cloud, axis: Optional[Axis]):
    """The whole cloud on every rank from each rank's attribute rows."""
    if axis is None or axis.size == 1:
        return cloud
    return cloud.with_trainable({k: gather_blocks(v.detach(), axis)
                                 for k, v in cloud.trainable().items()})


def shard_state(state, mesh: Mesh):
    """Cut a whole TrainState into this rank's shard in place (the
    reference's `state_pspec`): on a mesh with a "points" axis the point
    attributes and their two Adam moments keep rows [j * n_local, (j + 1)
    * n_local) of a capacity padded to a multiple of n_points (the pad
    rows dead, their moments zero); the tower and everything else stay
    whole. Returns the state."""
    axis = points_axis(mesh)
    if axis is None:
        return state
    cap = state.points.capacity
    whole = padded_capacity(cap, axis.size)
    if whole != cap:
        expand_state_capacity(state, whole)
    n_local = whole // axis.size
    rows = slice(axis.index * n_local, (axis.index + 1) * n_local)
    rebind_points(state, shard_cloud(state.points, axis),
                  lambda v: v[rows].clone())
    return state


def unshard_state(state, mesh: Mesh):
    """Put a sharded TrainState back together in place, on every rank:
    the point attributes and their Adam moments whole again (one
    all_reduce each over "points"). Returns the state."""
    axis = points_axis(mesh)
    if axis is None or state.points.points_embeding.shape[0] == (
            state.points.capacity):
        return state
    rebind_points(state, unshard_cloud(state.points, axis),
                  lambda v: gather_blocks(v, axis))
    return state


@contextlib.contextmanager
def whole_state(state, mesh: Optional[Mesh]):
    """The state whole on every rank inside the block, for a structure
    event, a checkpoint or an evaluation (a row-sharded state is put
    together first and cut again after the block, its capacity re-padded
    where the block changed it)."""
    if mesh is None:
        yield state
        return
    unshard_state(state, mesh)
    try:
        yield state
    finally:
        shard_state(state, mesh)


# ------------------------------------------------------------ renders

def make_sharded_render(cfg, mesh: Mesh) -> Callable:
    """The legacy render with rays sharded over the mesh (reference
    :138): f(params, points, grid, campos, camrotc2w, raydirs, near, far)
    -> RenderOutput, every field whole on every rank. On a mesh with a
    "points" axis `points` is this rank's shard (`shard_cloud`) and the
    attribute gather completes with a psum over "points"."""
    from pointnerf2studio_torch.models.render import render_rays
    rays, pts = mesh.axis("rays"), points_axis(mesh)

    @torch.no_grad()
    def render(params, points, grid, campos, camrotc2w, raydirs, near, far):
        sl = ray_slice(raydirs.shape[0], rays)
        out = render_rays(params, points, grid, campos, camrotc2w,
                          raydirs[sl], near, far, cfg, training=False,
                          points_axis=pts)
        return _gather_output(out, rays)

    return render


def make_sharded_fast_render(cfg, mesh: Mesh) -> Callable:
    """The fast render with rays sharded over the mesh (reference :159):
    f(params, Rw2c, cache, campos, camrotc2w, raydirs, near, far,
    ranges_min, scaled_vsize) -> FastRenderOutput, whole on every rank,
    its exactness counters summed over "rays". On a one-rank mesh every
    collective and slice is the identity, so it is the direct call, as
    the reference's is."""
    from pointnerf2studio_torch.models.fast_render import fast_render_rays
    rays = mesh.axis("rays")

    @torch.no_grad()
    def render(params, Rw2c, cache, campos, camrotc2w, raydirs, near, far,
               ranges_min, scaled_vsize):
        sl = ray_slice(raydirs.shape[0], rays)
        out = fast_render_rays(params, Rw2c, cache, campos, camrotc2w,
                               raydirs[sl], near, far, cfg, ranges_min,
                               scaled_vsize)
        return _gather_output(_psum_counters(out, rays), rays, COUNTERS)

    return render


def make_sharded_fast_render_pt(cfg, mesh: Mesh) -> Callable:
    """The fast render on a ("rays", "points") mesh with the fat cache's
    rows sharded over "points" (reference :224): rank (i, j) renders ray
    shard i against qslot slab j of `shard_fat_cache`; the front-end runs
    on the replicated qslot table, each rank computes only the slots its
    slab owns, and one psum of the per-slot outputs reassembles them.
    The XLA candidate stages only: knn_mode="fused" is refused as in the
    reference (:245), and so is chunk_mode="fused" (its kernels read the
    whole cache). Signature of `make_sharded_fast_render`."""
    from pointnerf2studio_torch.models.fast_render import fast_render_rays
    pts = mesh.axis("points")
    if pts is None:
        raise ValueError("mesh needs a 'points' axis")
    q = cfg.query
    if q.knn_mode == "fused":
        raise ValueError(
            "knn_mode='fused' with a point-sharded cache is not supported "
            "(the reference refuses it too)")
    if q.chunk_mode == "fused":
        raise ValueError(
            "chunk_mode='fused' with a point-sharded cache is not supported: "
            "the fused kernels read the whole cache")
    rays = mesh.axis("rays")

    @torch.no_grad()
    def render(params, Rw2c, cache, campos, camrotc2w, raydirs, near, far,
               ranges_min, scaled_vsize):
        sl = ray_slice(raydirs.shape[0], rays)
        out = fast_render_rays(params, Rw2c, cache, campos, camrotc2w,
                               raydirs[sl], near, far, cfg, ranges_min,
                               scaled_vsize, pshard_axis=pts)
        return _gather_output(_psum_counters(out, rays), rays, COUNTERS)

    return render


def shard_fat_cache(cache, mesh: Mesh):
    """This rank's qslot slab of a fat cache (reference :282): kmeta,
    kcand and kxyz padded to a multiple of n_points with empty candidates
    (meta -1, which no selection takes) and cut to rows [j * n_local,
    (j + 1) * n_local), the krows view `slim` rebuilt from the cut rows;
    the qslot table, the coarse occupancy, the march table and base_h
    stay whole."""
    pts = mesh.axis("points")
    n = pts.size
    n_q = cache.max_q
    n_local = -(-n_q // n)
    pad = n_local * n - n_q
    rows = slice(pts.index * n_local, (pts.index + 1) * n_local)

    def cut(x, fill):
        if pad:
            x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]),
                                         fill)])
        return x[rows].clone()

    out = dataclasses.replace(
        cache, kmeta=cut(cache.kmeta, -1), kcand=cut(cache.kcand, 0),
        kxyz=cut(cache.kxyz, 0), slim=None)
    if cache.slim is not None:
        from pointnerf2studio_torch.models.fast_render import build_slim
        out.slim = build_slim(out)
    return out


# --------------------------------------------------------- train steps

def _allreduce_grads(tensors: Sequence[torch.Tensor],
                     axis: Optional[Axis]) -> None:
    """Sum the tensors' gradients over the axis in one all_reduce; a
    missing gradient counts as zeros."""
    if axis is None or axis.size == 1:
        return
    gs = [p.grad if p.grad is not None else torch.zeros_like(p)
          for p in tensors]
    flat = torch.cat([g.reshape(-1) for g in gs])
    dist.all_reduce(flat, group=axis.group)
    off = 0
    for p in tensors:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p)
        off += n


def _batch_rows(sl, *xs):
    return tuple(None if x is None else x[sl] for x in xs)


def _draw_jitter(cfg, generator, jitter_u, R: int):
    """The whole batch's jitter draws [R, D], drawn as the single-device
    step draws them, so that every rank takes its rows of one draw."""
    from pointnerf2studio_torch.ops.raygen import jitter_uniform
    if (jitter_u is None and generator is not None
            and cfg.train.jitter > 0.0):
        jitter_u = jitter_uniform((R, cfg.query.z_depth_dim), generator)
    return jitter_u


def _finish_step(state, cfg, total, rays: Optional[Axis]) -> None:
    from pointnerf2studio_torch.train.trainer import apply_updates
    total.backward()
    _allreduce_grads(list(state.params.parameters())
                     + list(state.points.trainable().values()), rays)
    apply_updates(state, cfg)


def make_sharded_train_step(cfg, mesh: Mesh) -> Callable:
    """The legacy train step over the mesh (reference :354):

        step(state, grid, campos, camrotc2w, raydirs, gt_rgb, near, far,
             generator=None, jitter_u=None, bg_rgb=None, gt_mask=None)
             -> (state, aux)

    raydirs, gt_rgb, bg_rgb, gt_mask and jitter_u are the whole batch;
    this rank renders its rows, the loss sums are psum'd over "rays"
    (each rank's loss is the global masked mean), the gradients are
    summed over "rays", and the update runs alike on every rank. On a
    mesh with a "points" axis `state` is this rank's shard (`shard_state`)
    and its Adam updates only its rows."""
    from pointnerf2studio_torch.models.render import render_rays
    from pointnerf2studio_torch.train.loss import compute_losses
    rays, pts = mesh.axis("rays"), points_axis(mesh)

    def step(state, grid, campos, camrotc2w, raydirs, gt_rgb, near, far,
             generator: Optional[torch.Generator] = None,
             jitter_u: Optional[torch.Tensor] = None,
             bg_rgb: Optional[torch.Tensor] = None,
             gt_mask: Optional[torch.Tensor] = None):
        R = raydirs.shape[0]
        sl = ray_slice(R, rays)
        jitter_u = _draw_jitter(cfg, generator, jitter_u, R)
        raydirs, gt_rgb, bg_rgb, gt_mask, jitter_u = _batch_rows(
            sl, raydirs, gt_rgb, bg_rgb, gt_mask, jitter_u)
        state.zero_grad()
        out = render_rays(state.params, state.points, grid, campos,
                          camrotc2w, raydirs, near, far, cfg, training=True,
                          bg_ray_colors=bg_rgb, jitter_u=jitter_u,
                          points_axis=pts)
        total, aux = compute_losses(out, gt_rgb, cfg.train, gt_mask=gt_mask,
                                    psum_axis=rays)
        _finish_step(state, cfg, total, rays)
        return state, {k: v.detach() for k, v in aux.items()}

    return step


def make_sharded_fast_train_step(cfg, mesh: Mesh) -> Callable:
    """The fast differentiable train step over the mesh (reference :302),
    on a dense or a hash GeoCache:

        step(state, geo, ranges_min, scaled_vsize, campos, camrotc2w,
             raydirs, gt_rgb, near, far, generator=None, jitter_u=None,
             gt_mask=None, bg_rgb=None) -> (state, aux)

    as `make_sharded_train_step`; `rb_overflow` and `mc_overflow` in aux
    are summed over "rays". On a mesh with a "points" axis the attribute
    gather completes with a psum over "points" (the reference's fast step
    keeps the state replicated there)."""
    from pointnerf2studio_torch.models.fast_train import fast_train_render
    from pointnerf2studio_torch.train.loss import compute_losses
    rays, pts = mesh.axis("rays"), points_axis(mesh)

    def step(state, geo, ranges_min, scaled_vsize, campos, camrotc2w,
             raydirs, gt_rgb, near, far,
             generator: Optional[torch.Generator] = None,
             jitter_u: Optional[torch.Tensor] = None,
             gt_mask: Optional[torch.Tensor] = None,
             bg_rgb: Optional[torch.Tensor] = None):
        R = raydirs.shape[0]
        sl = ray_slice(R, rays)
        jitter_u = _draw_jitter(cfg, generator, jitter_u, R)
        raydirs, gt_rgb, bg_rgb, gt_mask, jitter_u = _batch_rows(
            sl, raydirs, gt_rgb, bg_rgb, gt_mask, jitter_u)
        state.zero_grad()
        out = fast_train_render(
            state.params, state.points, geo, campos, camrotc2w, raydirs,
            near, far, cfg, ranges_min, scaled_vsize, training=True,
            jitter_u=jitter_u, bg_ray_colors=bg_rgb, points_axis=pts)
        total, aux = compute_losses(out, gt_rgb, cfg.train, gt_mask=gt_mask,
                                    psum_axis=rays)
        aux = {k: v.detach() for k, v in aux.items()}
        for name in ("rb_overflow", "mc_overflow"):
            v = getattr(out, name)
            if v is not None:
                aux[name] = psum(v, rays).to(torch.float32)
        _finish_step(state, cfg, total, rays)
        return state, aux

    return step


# ------------------------------------------------------------- launching

def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               port: int, args: tuple) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = dist.TCPStore("localhost", port, world + 1, is_master=False)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, backend: str, args: tuple = (),
              join: bool = True, timeout: Optional[float] = None):
    """Run fn(rank, *args) in `world` processes (start method "spawn")
    joined by one process group of `backend` on localhost, and wait for
    all of them (`wait_ranks`); a failed rank raises here. With "nccl"
    rank r runs on cuda:r. `fn` must be importable by name (a module-level
    function). With `join=False` the processes' context returns at once,
    for `wait_ranks`. The ranks meet at a TCP store that this process
    serves on a port the system picks while it holds it (so worlds
    started at once never share a port), kept on the context for as long
    as the ranks run; gloo ranks bind to the loopback interface unless
    GLOO_SOCKET_IFNAME names another."""
    import torch.multiprocessing as mp
    store = dist.TCPStore("localhost", 0, world + 1, is_master=True,
                          wait_for_workers=False)
    ctx = mp.spawn(_rank_main, args=(fn, world, backend, store.port, args),
                   nprocs=world, join=False)
    ctx.store = store
    if join:
        wait_ranks(ctx, timeout)
    return ctx


def wait_ranks(ctx, timeout: Optional[float] = None) -> None:
    """Wait for the ranks of `run_ranks(..., join=False)`; a failed rank
    raises here (the others are terminated). Past `timeout` seconds every
    rank still running is terminated and TimeoutError raised."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=None if deadline is None else 1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            raise TimeoutError(f"ranks still running after {timeout} s")
