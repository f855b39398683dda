"""Distance-field ray marching front-end for the fast render path.

Port of `pointnerf2studio_tpu/ops/march.py`. The dense front-end tests
every depth sample of a ray's in-box span against the query-voxel table,
though only a few percent of them land in a query voxel. The march tests
roughly the samples a sphere trace visits:

  * build time (`build_march_table`): a Chebyshev distance field over
    the query-voxel grid (31 rounds of a 3x3x3 max-pool dilation),
    packed with the qslot table into one int32 per voxel:
    (qslot + 1) << 5 | min(dist, 31).
  * render time (`march_rays`): each ray walks its in-box span. At an
    occupied voxel it emits the sample into its slot list and steps to
    the next sample; at an empty voxel the packed distance c gives a
    free radius (every sample within (c - 1) * min_voxel_edge is empty),
    so the ray skips floor((c - 1) * edge / step_len) samples at once.
  * the walk runs in stages (`march_steps` iterations each): after stage
    i only the first `march_buckets[i]` still-active rays, by ray id, go
    on. A ray that does not fit a bucket sits that stage out; a ray still
    active after the last stage counts in `mc_overflow` (raise the fuel
    or the buckets: samples may be missing).

While mc_overflow == 0 the emitted (ray, depth, qslot) set equals the
first `cap` valid samples per ray of the dense path, in depth order.

`march_rays` on CUDA tensors launches the hand-written kernel
`csrc/march.cu` (one thread a ray, one launch a stage); on CPU tensors it
runs `march_rays_reference`, the reference's staged loop written with
tensors. The reference has no Pallas kernel here: its walk is a
`lax.fori_loop` of array ops, which as a Python loop of torch ops would
be sum(march_steps) iterations of some forty small kernels a chunk. Both
versions keep every multiply and add separately rounded, in the
reference's order of operations, because `fast_render_rays` recomputes
each emitted sample's position with torch ops afterwards: a sample on a
voxel face must fall to the same side in both places.

`simulate_march` and `plan_march` are the reference's NumPy planner: the
same float32 arithmetic as the walk, so the planned fuel and buckets are
exact for the rays they were planned on.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from pointnerf2studio_torch.ops import _cuda

# floats are clamped to +-I32_SAFE before a cast to int32: beyond int32
# the cast saturates on CUDA and under XLA but wraps to INT_MIN on the
# CPU. 2^30 is exact in float32 and far outside every index range here.
I32_SAFE = float(1 << 30)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32, the same on every device (see I32_SAFE)."""
    return torch.clamp(x, -I32_SAFE, I32_SAFE).to(torch.int32)


def slab(raydirs, campos, ranges_min, rmax):
    """Entry/exit t of each ray through the grid bounding box."""
    tiny = torch.full_like(raydirs, 1e-9)
    safe = torch.where(torch.abs(raydirs) < 1e-9,
                       torch.where(raydirs >= 0, tiny, -tiny), raydirs)
    inv = 1.0 / safe
    ta = (ranges_min - campos) * inv
    tb = (rmax - campos) * inv
    t_enter = torch.minimum(ta, tb).max(-1).values
    t_exit = torch.maximum(ta, tb).min(-1).values
    return t_enter, t_exit


def build_march_table(coor_2_qslot: torch.Tensor, cmax: int = 31
                      ) -> torch.Tensor:
    """Pack the qslot table with a Chebyshev distance field.

    Returns int32 [gx, gy, gz]: (qslot + 1) << 5 | min(c, 31) where c is
    the L-inf distance in voxels to the nearest query voxel (0 iff the
    voxel is one). Empty voxels have qslot bits 0."""
    occ = (coor_2_qslot >= 0)
    dil = occ.to(torch.float32)[None, None]
    c = torch.zeros(occ.shape, dtype=torch.int32, device=occ.device)
    for _ in range(min(cmax, 31)):
        c = c + (1 - dil[0, 0].to(torch.int32))
        # max over the 3x3x3 window; the padding never wins (values >= 0)
        dil = torch.nn.functional.max_pool3d(dil, 3, stride=1, padding=1)
    return ((coor_2_qslot.to(torch.int32) + 1) << 5) | torch.clamp(c, max=31)


def _march_setup(dims_f, ranges_min, scaled_vsize, campos, raydirs, near,
                 far, step_t, D, jitter, jittered, live):
    """Per-ray start state of the walk: (d, d_hi, done, t_stop, stepw)."""
    hj = 0.5 * float(jitter)
    rmax = ranges_min + dims_f * scaled_vsize
    t_enter, t_exit = slab(raydirs, campos, ranges_min, rmax)
    if not jittered:
        far_c = far
        d_lo = to_i32(torch.floor((t_enter - near) / step_t - 0.5))
        d_hi = torch.clamp(to_i32(torch.ceil(
            (torch.minimum(t_exit, far) - near) / step_t - 0.5)), max=D - 1)
    else:
        # conservative index bounds under jittered mids: mid[d] lies in
        # near + (d + 0.5) * step_t * [1 -/+ jitter/2], and the jittered
        # segment sums can pass `far` by jitter/2 * (far - near)
        far_c = far + hj * (far - near)
        d_lo = to_i32(torch.floor(
            (t_enter - near) / (step_t * (1.0 + hj)) - 0.5))
        d_hi = torch.clamp(to_i32(torch.ceil(
            (torch.minimum(t_exit, far_c) + step_t - near)
            / (step_t * max(1.0 - hj, 1e-3)) - 0.5)), max=D - 1)
    hit_box = (t_exit >= t_enter) & (d_hi >= 0)
    t_stop = torch.minimum(t_exit, far_c) + step_t
    d = torch.clamp(d_lo, 0, D - 1)
    x, y, z = raydirs.unbind(-1)
    stepw = step_t * torch.sqrt(x * x + y * y + z * z)
    done = (~hit_box) | (d > d_hi)
    if live is not None:
        done = done | ~live
    return d, d_hi, done, t_stop, stepw


def _stage_mask(done: torch.Tensor, RS: int) -> torch.Tensor:
    """The rays that walk a later stage: the first RS still-active ones
    by ray id (an ordered prefix count; no tie order to rely on)."""
    active = ~done
    return active & (torch.cumsum(active.to(torch.int32), 0) <= RS)


def march_rays_reference(
    table_flat: torch.Tensor,       # [gx*gy*gz] packed int32
    dims_arr: torch.Tensor,         # [3] int32 grid dims
    gy: int, gz: int,
    ranges_min: torch.Tensor,       # [3]
    scaled_vsize: torch.Tensor,     # [3]
    campos: torch.Tensor,           # [3]
    raydirs: torch.Tensor,          # [R, 3]
    near, far, step_t,              # 0-dim float32 tensors
    D: int, cap: int,
    steps: Tuple[int, ...], buckets: Tuple[int, ...],
    t_tab: Optional[torch.Tensor] = None, jitter: float = 0.0,
    live: Optional[torch.Tensor] = None, count_steps: bool = False):
    """Plain version of `march_rays` (same arguments, same results): the
    reference's loop, one torch op per array op, every stage over all
    rays under a mask instead of over a packed bucket."""
    R = raydirs.shape[0]
    dev = raydirs.device
    if len(buckets) != max(len(steps) - 1, 0):
        raise ValueError("march_buckets must have one entry per stage after "
                         "the first")
    near, far, step_t = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                         for v in (near, far, step_t))
    dims_f = dims_arr.to(torch.float32)
    s_min = scaled_vsize.min()
    jfac = 1.0 + 0.5 * float(jitter)
    d, d_hi, done, t_stop, stepw = _march_setup(
        dims_f, ranges_min, scaled_vsize, campos, raydirs, near, far, step_t,
        D, jitter, t_tab is not None, live)
    k = torch.zeros(R, dtype=torch.int32, device=dev)
    used = torch.zeros(R, dtype=torch.int32, device=dev)
    emit = torch.zeros((R, cap), dtype=torch.int32, device=dev)
    rows = torch.arange(R, device=dev)
    t_flat = None if t_tab is None else t_tab.reshape(-1)
    B = stepw * jfac
    one = torch.ones((), dtype=torch.int32, device=dev)

    def body(d, k, done, run):
        if t_flat is None:
            t = near + (d.to(torch.float32) + 0.5) * step_t
        else:
            t = t_flat[torch.clamp(rows * D + d, max=R * D - 1)]
        pos = campos + raydirs * t[:, None]
        gc = torch.floor((pos - ranges_min) / scaled_vsize).to(torch.int32)
        inb = ((gc >= 0) & (gc < dims_arr)).all(-1)
        gcc = torch.minimum(torch.clamp(gc, min=0), dims_arr - 1).long()
        fi = (gcc[:, 0] * gy + gcc[:, 1]) * gz + gcc[:, 2]
        qsd = torch.where(inb, table_flat[torch.where(inb, fi, 0)], 0)
        qs1 = qsd >> 5
        occ = qs1 > 0
        active = run & ~done
        emitn = occ & active
        packed = (qs1 << 9) | torch.clamp(d, max=511)
        # emit[r, k[r]] = packed[r]; rows that emit nothing write lane 0's
        # own value back (k < cap while a ray is active)
        lane = torch.where(emitn, k, 0).long()
        emit[rows, lane] = torch.where(emitn, packed, emit[rows, lane])
        k = k + emitn.to(torch.int32)
        # skip count: the largest q with q * B < A, by an IEEE division
        # seed and a multiply-only fix-up, which is what makes the walk
        # and the planner (`simulate_march`) agree bit for bit
        cfree = torch.where(inb, qsd & 31, one)
        A = (cfree - 1).to(torch.float32) * s_min
        q1 = to_i32(torch.floor(A / B - 1e-4))
        for _ in range(2):
            q1 = q1 + ((q1 + 1).to(torch.float32) * B < A).to(torch.int32)
        for _ in range(2):
            q1 = q1 - (q1.to(torch.float32) * B >= A).to(torch.int32)
        skip = torch.where(occ | (cfree <= 1), one, torch.clamp(q1, min=1))
        d = d + torch.where(active, skip, 0)
        used.add_(active.to(torch.int32))
        fin = (d > d_hi) | (k >= cap)
        if t_flat is not None:
            fin = fin | (t > t_stop)
        return d, k, done | (run & fin)

    run = torch.ones(R, dtype=torch.bool, device=dev)
    for i, T in enumerate(steps):
        if i > 0:
            run = _stage_mask(done, min(int(buckets[i - 1]), R))
        for _ in range(int(T)):
            d, k, done = body(d, k, done, run)
    out = (emit, torch.clamp(k, max=cap), (~done).sum().to(torch.int32))
    return out + (used,) if count_steps else out


def march_rays(
    table_flat: torch.Tensor,       # [gx*gy*gz] packed int32
    dims_arr: torch.Tensor,         # [3] int32 grid dims
    gy: int, gz: int,
    ranges_min: torch.Tensor,       # [3]
    scaled_vsize: torch.Tensor,     # [3]
    campos: torch.Tensor,           # [3]
    raydirs: torch.Tensor,          # [R, 3]
    near, far, step_t,              # 0-dim float32 tensors
    D: int,
    cap: int,                       # per-ray slot cap (min(SR, BP, D))
    steps: Tuple[int, ...],
    buckets: Tuple[int, ...],       # active-ray caps, stages 1..
    t_tab: Optional[torch.Tensor] = None,   # [R, D] actual per-sample ts
                                    # (jittered raygen mids); None -> the
                                    # affine unjittered t
    jitter: float = 0.0,            # raygen jitter fraction (sizes the
                                    # skip-safety margin under t_tab)
    live: Optional[torch.Tensor] = None,    # [R] bool: rows that carry
                                    # real rays (ray packing pads with
                                    # copies of row 0, which must not
                                    # walk, take bucket room or count)
    count_steps: bool = False,      # also return the iterations per ray
):
    """March every ray's in-box span through the packed table.

    Returns (emit [R, cap] int32: (qslot + 1) << 9 | depth, 0 in unused
    slots; cnt [R] int32: emitted samples per ray; mc_overflow [] int32:
    rays whose span was not fully tested) and, with `count_steps`, the
    walk's iterations per ray [R] int32. Needs qslot < 2^22 - 1 and
    D <= 512 (the packing; callers gate).

    With `t_tab` (the train path's jittered sample times) each tested
    sample's t is read from the table, the free radius is divided by the
    largest per-sample advance step_t * (1 + jitter/2), the walk starts
    at the earliest index whose mid could reach t_enter and ends at the
    true t (t > t_exit + step_t).

    CUDA tensors launch `csrc/march.cu` once per stage; CPU tensors run
    `march_rays_reference`."""
    if not raydirs.is_cuda:
        return march_rays_reference(
            table_flat, dims_arr, gy, gz, ranges_min, scaled_vsize, campos,
            raydirs, near, far, step_t, D, cap, steps, buckets, t_tab=t_tab,
            jitter=jitter, live=live, count_steps=count_steps)
    dev = raydirs.device
    R = raydirs.shape[0]
    f32, i32 = torch.float32, torch.int32
    if len(buckets) != max(len(steps) - 1, 0):
        raise ValueError("march_buckets must have one entry per stage after "
                         "the first")
    if cap < 1 or not steps:
        raise ValueError(f"march_rays needs cap >= 1 and a stage, got cap "
                         f"{cap}, steps {steps}")
    _cuda.require(table_flat, "table_flat", i32, (None,), dev)
    _cuda.require(raydirs, "raydirs", f32, (R, 3), dev)
    _cuda.require(dims_arr, "dims_arr", i32, (3,), dev)
    geom = torch.cat(
        [ranges_min.reshape(3), scaled_vsize.reshape(3), campos.reshape(3)]
        + [torch.as_tensor(v, dtype=f32, device=dev).reshape(1)
           for v in (near, far, step_t)])
    _cuda.require(geom, "geometry", f32, (12,), dev)
    if t_tab is not None:
        _cuda.require(t_tab, "t_tab", f32, (R, D), dev)
    if live is not None:
        _cuda.require(live, "live", torch.bool, (R,), dev)
    if table_flat.shape[0] < 1 or gy < 1 or gz < 1 or \
            table_flat.shape[0] % (gy * gz):
        raise ValueError(f"table of {table_flat.shape[0]} voxels does not "
                         f"fit a grid of (*, {gy}, {gz})")
    d = torch.empty(R, dtype=i32, device=dev)
    k = torch.empty(R, dtype=i32, device=dev)
    done = torch.empty(R, dtype=torch.bool, device=dev)
    used = torch.zeros(R, dtype=i32, device=dev) if count_steps else None
    emit = torch.zeros((R, cap), dtype=i32, device=dev)
    if R == 0:
        out = (emit, k, torch.zeros((), dtype=i32, device=dev))
        return out + (used,) if count_steps else out
    hj = 0.5 * float(jitter)
    fn = _cuda.library("march").march_stage
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    null = ctypes.c_void_p(None)
    rank, RS = None, R
    for i, T in enumerate(steps):
        if i > 0:
            # the first RS still-active rays by ray id walk this stage: the
            # kernel reads each ray's rank among them (`_stage_mask` is the
            # same prefix count in the plain version)
            RS = min(int(buckets[i - 1]), R)
            rank = (torch.cumsum(~done, 0, dtype=i32) if RS < R else None)
        _cuda.LAUNCHES["march_rays"] += 1
        _cuda.check(fn(
            _cuda.ptr(table_flat), _cuda.ptr(dims_arr), _cuda.ptr(geom),
            _cuda.ptr(raydirs), null if t_tab is None else _cuda.ptr(t_tab),
            R, int(gy), int(gz), int(D), int(cap), int(T), int(i == 0),
            1.0 + hj, max(1.0 - hj, 1e-3), hj,
            null if live is None else _cuda.ptr(live),
            null if rank is None else _cuda.ptr(rank), RS,
            _cuda.ptr(d), _cuda.ptr(k), _cuda.ptr(done), _cuda.ptr(emit),
            null if used is None else _cuda.ptr(used),
            _cuda.stream_handle(dev)), "march_rays launch")
    out = (emit, torch.clamp(k, max=cap), (~done).sum().to(i32))
    return out + (used,) if count_steps else out


def simulate_march(
    table: np.ndarray,              # [gx, gy, gz] packed (host)
    ranges_min, scaled_vsize, campos,
    rays: np.ndarray,               # [R, 3]
    near: float, far: float, D: int, cap: int,
    jitter: float = 0.0,
    slab_f32: bool = False,
) -> np.ndarray:
    """Host simulation of march_rays with unbounded fuel.

    Returns steps_used [R] int64: the number of walk iterations each ray
    takes to finish (0 for rays that never start: box misses and empty
    spans), by the walk's own float32 arithmetic.

    `jitter` > 0 models the train path's jittered walk (the t_tab branch
    of march_rays): the free radius divides by 1 + jitter/2 and the
    d_lo/d_hi index bounds widen as the walk's do. It is conservative in
    those terms, not a per-ray guarantee (the walk tests the true
    jittered positions, which may pass through other voxels); callers'
    fuel margins absorb the rest and mc_overflow verifies it.

    `campos` may be [3] or [R, 3] per-ray origins, so that plan_march can
    size budgets over rays drawn from several cameras at once.

    The slab test below runs in float64, as the reference's does: its
    `np.where` on Python floats promotes `safe`, and with it t_enter and
    t_exit. The walk's runs in float32, so for a ray whose entry or exit
    lies within a float32 ulp of a sample boundary d_lo or d_hi, and the
    step count, can differ by one (a few rays in a hundred thousand; the
    plan's fuel margin covers them). `slab_f32` keeps the slab test in
    float32: then every ray's count is the walk's own, exactly. Plans
    are made with the default, which is what the reference plans with."""
    dims = np.asarray(table.shape, np.int64)
    gy, gz = int(dims[1]), int(dims[2])
    tflat = np.asarray(table).reshape(-1)
    rmin = np.asarray(ranges_min, np.float32)
    svs = np.asarray(scaled_vsize, np.float32)
    campos = np.asarray(campos, np.float32)
    rays = np.asarray(rays, np.float32)
    step_t = np.float32((far - near) / D)
    s_min = np.float32(svs.min())

    safe = np.where(np.abs(rays) < 1e-9,
                    np.where(rays >= 0, 1e-9, -1e-9), rays)
    if slab_f32:
        safe = safe.astype(np.float32)
    inv = np.float32(1.0) / safe
    ta = (rmin - campos) * inv
    tb = (rmin + dims.astype(np.float32) * svs - campos) * inv
    t_enter = np.minimum(ta, tb).max(-1)
    t_exit = np.maximum(ta, tb).min(-1)
    jfac = np.float32(1.0 + 0.5 * float(jitter))
    if jitter <= 0.0:
        d_lo = np.floor((t_enter - near) / step_t - 0.5).astype(np.int64)
        d_hi = np.minimum(
            np.ceil((np.minimum(t_exit, far) - near) / step_t
                    - 0.5).astype(np.int64), D - 1)
    else:
        far_ov = np.float32(far + 0.5 * float(jitter) * (far - near))
        d_lo = np.floor((t_enter - near) / (step_t * jfac)
                        - 0.5).astype(np.int64)
        d_hi = np.minimum(
            np.ceil((np.minimum(t_exit, far_ov) + step_t - near)
                    / (step_t
                       * np.float32(max(1.0 - 0.5 * float(jitter), 1e-3)))
                    - 0.5).astype(np.int64), D - 1)
    hit = (t_exit >= t_enter) & (d_hi >= 0)

    d = np.clip(d_lo, 0, D - 1)
    stepw = step_t * np.linalg.norm(rays, axis=-1).astype(np.float32)
    done = (~hit) | (d > d_hi)
    k = np.zeros(rays.shape[0], np.int64)
    steps_used = np.zeros(rays.shape[0], np.int64)
    for _ in range(2 * D + 8):
        if done.all():
            break
        act = ~done
        t = (near + (d.astype(np.float32) + 0.5) * step_t)[act]
        pos = ((campos if campos.ndim == 1 else campos[act])
               + rays[act] * t[:, None])
        gc = np.floor((pos - rmin) / svs).astype(np.int64)
        inb = ((gc >= 0) & (gc < dims)).all(-1)
        gcc = np.clip(gc, 0, dims - 1)
        fi = (gcc[:, 0] * gy + gcc[:, 1]) * gz + gcc[:, 2]
        qsd = np.where(inb, tflat[fi], 0)
        occ = (qsd >> 5) > 0
        kk = k[act] + occ
        cfree = np.where(inb, qsd & 31, 1)
        # multiply-fix-up floor, bit-matching the walk
        A = (cfree - 1).astype(np.float32) * s_min
        B = stepw[act] * jfac
        q1 = np.floor(A / B - 1e-4).astype(np.int64)
        for _ in range(2):
            q1 = q1 + ((q1 + 1).astype(np.float32) * B < A)
        for _ in range(2):
            q1 = q1 - (q1.astype(np.float32) * B >= A)
        skip = np.where(occ | (cfree <= 1), 1, np.maximum(1, q1))
        dd = d[act] + skip
        k[act] = kk
        d[act] = dd
        steps_used[act] += 1
        done[act] = (dd > d_hi[act]) | (kk >= cap)

    return steps_used


def plan_march(
    table: np.ndarray,              # [gx, gy, gz] packed (host)
    ranges_min, scaled_vsize, campos,
    rays: np.ndarray,               # [R, 3] representative ray set
    near: float, far: float, D: int, cap: int,
    stages: int = 4, slack: float = 1.10,
    chunk: int = 0, fuel_margin: int = 4,
    jitter: float = 0.0,
    block_lens: Optional[Tuple[int, ...]] = None,
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Size (march_steps, march_buckets) from a host simulation.

    Simulates the walk on `rays` with unbounded fuel, records each ray's
    steps-to-done, and cuts stages at quantiles: fuel boundaries at about
    p50 / p80 / p95 / max (+ fuel_margin), bucket sizes at the simulated
    active counts x `slack` (+256, rounded up to 256). mc_overflow still
    verifies the plan on the device.

    `chunk` > 0: the rays will be rendered in `chunk`-sized chunks, in
    this order; buckets are sized at the largest per-chunk active count
    at each stage boundary, a partial last chunk padded with zeros.
    `block_lens` overrides the uniform chunking with consecutive blocks
    of these exact lengths (one block = one call of the walk)."""
    steps_used = simulate_march(table, ranges_min, scaled_vsize,
                                campos, rays, near, far, D, cap,
                                jitter=jitter)
    n_done = steps_used[steps_used > 0]
    if n_done.size == 0:
        return (8,), ()
    if stages <= 4:
        qs = [0.5, 0.8, 0.95][: max(stages - 1, 0)]
    else:
        qs = [1.0 - 0.5 ** i for i in range(1, stages)]
    cuts = sorted(set(
        int(np.quantile(n_done, p)) + 1 for p in qs))
    cuts = [c for c in cuts if c < int(n_done.max())]
    bounds = cuts + [int(n_done.max()) + fuel_margin]
    R = rays.shape[0]
    if block_lens is not None:
        assert sum(block_lens) == R, (block_lens, R)
        max_l = max(block_lens)
        rows, off = [], 0
        for bl in block_lens:
            rows.append(np.pad(steps_used[off:off + bl],
                               (0, max_l - bl)))
            off += bl
        su_c = np.stack(rows)
        cap_rays = max_l
    elif chunk:
        cap_rays = min(chunk, R)
        n_chunks = (R + chunk - 1) // chunk
        su_c = np.pad(steps_used,
                      (0, n_chunks * chunk - R)).reshape(n_chunks, chunk)
    else:
        cap_rays = R
        su_c = steps_used[None, :]
    steps_plan, buckets, prev = [], [], 0
    for i, b in enumerate(bounds):
        steps_plan.append(b - prev)
        if i < len(bounds) - 1:
            active = int((su_c > b).sum(-1).max())
            buckets.append(min(
                cap_rays,
                (int(active * slack) + 256 + 255) // 256 * 256))
        prev = b
    return tuple(steps_plan), tuple(buckets)
