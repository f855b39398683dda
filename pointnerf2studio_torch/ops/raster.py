"""Sort-based tile-binning raster front-end for frame rendering.

Port of `pointnerf2studio_tpu/ops/raster.py`. One frame-level program
takes the place of the per-chunk distance-field ray march
(ops/march.py): it rasterises the occupied query voxels onto the pixel
grid and bins the resulting samples per ray:

  1. project each query voxel's 8 corners: a conservative pixel bbox and
     depth-bin range (a perspective projection of a convex box attains
     its screen extrema at vertices; distances along normalised rays
     attain theirs at the box's closest point and farthest corner);
  2. partition the voxels into footprint classes with static emit
     budgets (one worst-case budget would triple the row count);
  3. enumerate the (pixel, depth-bin) offsets of each voxel and
     band-verify each sample with ray directions recomputed inline:
     accept iff the sample lands inside the voxel expanded by a
     tolerance band that dominates any difference between the inline
     formula and the frame's actual ray array;
  4. one sort by (ray << 9 | d) compacts the accepted samples to a
     prefix, ordered per ray by ascending depth;
  5. the exact verify runs on the bounded prefix only: gather each row's
     true ray direction from the frame array and voxelise with the very
     arithmetic `fast_render_rays` uses afterwards (separately rounded
     torch ops), so the surviving rows are bit-identical to the march's;
  6. a segmented rank (the exclusive prefix of accepts, less its value
     at the start of the ray's run of sorted rows) and
     one bounded indexed store produce the packed emit table the march
     hands to ops/select.rank_gather_pack: (qslot + 1) << 9 | d.

Exact with counters: `counters` reports voxels whose footprint exceeded
every class (class_overflow), per-class list truncation (list_overflow),
sorted-prefix truncation (live_overflow) and `certain_flip`: prefix rows
the band phase called certainly inside that the exact verify rejected.
All zero is necessary, not sufficient: the band check drops a sample
that lies more than BAND outside its voxel without any counter moving,
so the tests and the smoke run also hold the emit table to the march's.

Everything here is plain tensor work (the reference runs it outside any
Pallas kernel): stable sorts, cumulative sums, a binary search over the
sorted rows and one indexed store whose
accepted destinations are unique; every dropped row goes to a sentinel
row past the end that is sliced off. No atomics. The enumeration runs
class by class in bounded pieces, so its temporaries stay small beside
the cache.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pointnerf2studio_torch.ops.march import to_i32

INT_MAX = 0x7FFFFFFF

# footprint classes: (PX, PY, ND) budget dims. A class budget of 0 means
# all of max_q; `render_frame` measures its own ladder per frame.
DEFAULT_CLASSES = ((3, 3, 3), (5, 5, 4), (8, 8, 6))

# tolerance band (in voxel units) of the phase-1 accept: must dominate
# |inline-recomputed pos - true pos| / vsize. Rounding differences between
# two evaluations of the ray formula are ~1e-7 relative (~5e-5 voxels at
# chair geometry); a dataset loader that normalises with a +1e-5 norm guard
# shifts directions by ~1e-5 relative (~7.5e-3 voxels). 3e-2 leaves 4x
# margin over that for a ~2% row surplus.
BAND = 3e-2

# rows enumerated at a time (bounds the enumeration's temporaries)
ENUM_ROWS = 1 << 22


class RasterUnserved(ValueError):
    """The raster does not serve this scene, frame or camera (a packing
    bound, a camera inside the grid box, a non-zero counter):
    `render_frame` walks such a frame with the march instead."""


def _intrin4(focal, height: int, width: int):
    """(fx, fy, cx, cy) from a scalar focal (principal point at the image
    centre) or a 4-tuple of pinhole intrinsics."""
    if isinstance(focal, (tuple, list)):
        fx, fy, cx, cy = (float(v) for v in focal)
    else:
        fx = fy = float(focal)
        cx, cy = width / 2.0, height / 2.0
    return fx, fy, cx, cy


def _pixel_dirs(i, j, camrotc2w, height: int, width: int, focal):
    """Pixel -> world ray direction (f32, elementwise; agreement with the
    caller's ray array to within BAND suffices)."""
    fx, fy, cx, cy = _intrin4(focal, height, width)
    x = (i + (0.5 - cx)) * (1.0 / fx)
    y = (j + (0.5 - cy)) * (1.0 / fy)
    inv_n = 1.0 / torch.sqrt(x * x + y * y + 1.0)
    xn = x * inv_n
    yn = y * inv_n
    zn = inv_n
    r = camrotc2w
    return torch.stack(
        [xn * r[0, 0] + yn * r[0, 1] + zn * r[0, 2],
         xn * r[1, 0] + yn * r[1, 1] + zn * r[1, 2],
         xn * r[2, 0] + yn * r[2, 1] + zn * r[2, 2]], dim=-1)


def camera_rays_device(camrotc2w: torch.Tensor, height: int, width: int,
                       focal) -> torch.Tensor:
    """f32 twin of data.synthetic.camera_rays on camrotc2w's device
    (OpenCV pinhole, +z forward, row-major pixels) [H*W, 3]."""
    dev = camrotc2w.device
    j, i = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    return _pixel_dirs(i.reshape(-1), j.reshape(-1),
                       camrotc2w.to(torch.float32), height, width, focal)


def build_qvox(coor_2_qslot: torch.Tensor, max_q: int) -> torch.Tensor:
    """Invert the dense voxel -> qslot table: qvox[qslot] = (ix, iy, iz),
    int32 [max_q, 3]. Unused qslots keep (-1, -1, -1) and never emit."""
    dims = tuple(coor_2_qslot.shape)
    if max(dims) > 1024:
        raise RasterUnserved(
            f"raster voxel-coord packing needs grid dims <= 1024 (got "
            f"{dims})")
    dev = coor_2_qslot.device
    qs = coor_2_qslot.reshape(-1).long()
    gi = torch.arange(qs.shape[0], device=dev)
    coords = torch.stack([gi // (dims[1] * dims[2]),
                          (gi // dims[2]) % dims[1], gi % dims[2]],
                         -1).to(torch.int32)
    tgt = torch.where((qs >= 0) & (qs < max_q), qs, max_q)
    out = torch.full((max_q + 1, 3), -1, dtype=torch.int32, device=dev)
    out[tgt] = coords         # non-query voxels all land on the spare row
    return out[:max_q]


def _voxel_footprint(qvox, ranges_min, scaled_vsize, campos, camrotc2w,
                     height, width, focal, near, far, D, step_t):
    """Per-voxel conservative screen bbox and depth-bin range.

    Returns (i0, j0, d0, w, h, nd, ok), int32 [max_q] each but `ok`
    (bool): False for empty qslots and voxels fully outside the frame or
    depth range; voxels too close to the camera plane get w = h = INT_MAX
    so that they land in class_overflow."""
    f32 = torch.float32
    dev = qvox.device
    valid = qvox[:, 0] >= 0
    lo = ranges_min + qvox.to(f32) * scaled_vsize
    hi = lo + scaled_vsize
    sel = torch.tensor([[(c >> a) & 1 for a in range(3)] for c in range(8)],
                       dtype=f32, device=dev)
    corners = lo[:, None, :] * (1 - sel) + hi[:, None, :] * sel   # [q, 8, 3]
    rel = corners - campos
    # x_cam = R^T rel, elementwise in f32 on purpose: a matrix product may
    # run at reduced precision and move corners by whole voxels
    r = camrotc2w
    cam = [rel[..., 0] * r[0, k] + rel[..., 1] * r[1, k]
           + rel[..., 2] * r[2, k] for k in range(3)]
    z = cam[2]
    behind = z.min(-1).values < 1e-3
    fx, fy, cx, cy = _intrin4(focal, height, width)
    zs = torch.clamp(z, min=1e-3)
    u = cam[0] * fx / zs + (cx - 0.5)
    v = cam[1] * fy / zs + (cy - 0.5)
    pad = 0.05
    umin, umax = u.min(-1).values - pad, u.max(-1).values + pad
    vmin, vmax = v.min(-1).values - pad, v.max(-1).values + pad
    # to_i32 clamps in float first: near the camera plane u and v pass
    # int32, where the cast differs between devices
    i0 = to_i32(torch.ceil(umin))
    i1 = to_i32(torch.floor(umax))
    j0 = to_i32(torch.ceil(vmin))
    j1 = to_i32(torch.floor(vmax))
    # clip to the frame (a bbox partly outside keeps its inside part)
    i0c = torch.clamp(i0, min=0)
    j0c = torch.clamp(j0, min=0)
    w = torch.clamp(i1, max=width - 1) - i0c + 1
    h = torch.clamp(j1, max=height - 1) - j0c + 1
    # depth range along normalised rays: euclidean distance extrema over
    # the box (min at its closest point, max at a corner)
    dn = torch.maximum(torch.minimum(campos.expand_as(lo), hi), lo) - campos
    tmin = torch.sqrt(dn[:, 0] * dn[:, 0] + dn[:, 1] * dn[:, 1]
                      + dn[:, 2] * dn[:, 2])
    tmax = torch.sqrt((rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]
                       + rel[..., 2] * rel[..., 2]).max(-1).values)
    tpad = 2e-3
    d0f = torch.ceil((tmin - tpad - near) / step_t - 0.5)
    d1f = torch.floor((tmax + tpad - near) / step_t - 0.5)
    d0 = torch.clamp(to_i32(d0f), min=0)
    d1 = torch.clamp(to_i32(d1f), max=D - 1)
    nd = d1 - d0 + 1
    ok = valid & (w > 0) & (h > 0) & (nd > 0) & ~behind
    # voxels behind the camera plane can still be hit by a ray: force them
    # into class_overflow instead of dropping them silently
    big = torch.full_like(w, INT_MAX)
    w = torch.where(behind & valid, big, w)
    h = torch.where(behind & valid, big, h)
    ok = ok | (behind & valid)
    return i0c, j0c, d0, w, h, nd, ok


def raster_emit_table(
    qvox: torch.Tensor,            # [max_q, 3] int32 (build_qvox)
    ranges_min: torch.Tensor,      # [3] f32
    scaled_vsize: torch.Tensor,    # [3] f32
    campos: torch.Tensor,          # [3] f32
    camrotc2w: torch.Tensor,       # [3, 3] f32
    raydirs_frame: torch.Tensor,   # [H*W, 3] f32, row-major pixels
    height: int, width: int, focal,
    near, far, D: int, step_t,
    cap: int,                      # per-ray emit cap = min(SR, BP, D)
    classes: Tuple[Tuple[int, int, int], ...] = DEFAULT_CLASSES,
    class_budgets: Tuple[int, ...] = (0, 65536, 8192),
    live_budget: int = 4_194_304,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-level packed emit table [H*W, cap] (march-compatible).

    Returns (emit, counters [4] int32): counters = [class_overflow,
    list_overflow, live_overflow, certain_flip]; while all are zero and
    no sample lies more than BAND from its voxel by the inline ray
    formula, `emit` equals the march's per-ray first-cap ascending-d
    emit. A class budget of 0 means max_q (no truncation possible).
    No host synchronisation happens inside."""
    f32, i32 = torch.float32, torch.int32
    dev = qvox.device
    max_q = qvox.shape[0]
    HW = height * width
    if D > 512:
        raise RasterUnserved("raster key packing needs z_depth_dim <= 512 (the "
                         "bound of the march's packed emit)")
    if HW >= (1 << 22):
        # at 2^22 pixels the last pixel's key (HW - 1) << 9 | 511 would
        # equal the dead-row sentinel
        raise RasterUnserved(f"raster key packing needs < 2^22 pixels per frame "
                         f"(got {HW})")
    if max_q > (1 << 22) - 2:
        raise RasterUnserved("raster emit packing needs max_q < 2^22 - 1")
    if raydirs_frame.shape != (HW, 3):
        raise ValueError(f"raydirs_frame {tuple(raydirs_frame.shape)} is not "
                         f"the {height}x{width} frame")
    if len(class_budgets) != len(classes):
        raise ValueError("one budget per footprint class")
    near = torch.as_tensor(near, dtype=f32, device=dev)
    step_t = torch.as_tensor(step_t, dtype=f32, device=dev)

    i0, j0, d0, w, h, nd, ok = _voxel_footprint(
        qvox, ranges_min, scaled_vsize, campos, camrotc2w,
        height, width, focal, near, far, D, step_t)

    # class = smallest class whose dims cover (w, h, nd); n_cls = none
    n_cls = len(classes)
    cls = torch.full((max_q,), n_cls, dtype=torch.long, device=dev)
    for c in range(n_cls - 1, -1, -1):
        px, py, ndc = classes[c]
        fits = (w <= px) & (h <= py) & (nd <= ndc)
        cls = torch.where(fits, c, cls)
    cls = torch.where(ok, cls, n_cls + 1)   # ray-free voxels: emit no rows
    class_overflow = (cls == n_cls).sum()

    # class-sorted voxel ids: classes become contiguous runs. Padded by the
    # largest class budget, so that a class's index window never runs past
    # the list; padding rows are masked by row_ok.
    ar_q = torch.arange(max_q, device=dev)
    ids_sorted = torch.sort(cls * (max_q + 1) + ar_q, stable=True).indices
    n_list = [min(int(b) or max_q, max_q) for b in class_budgets]
    ids_sorted = torch.cat(
        [ids_sorted, torch.zeros(max(n_list), dtype=torch.long, device=dev)])
    counts = torch.stack([(cls == c).sum() for c in range(n_cls)])
    starts = torch.cumsum(counts, 0) - counts

    key_parts, val_parts, vc_parts = [], [], []
    list_overflow = torch.zeros((), dtype=torch.long, device=dev)
    for c, (px, py, ndc) in enumerate(classes):
        n_c = n_list[c]
        e_c = px * py * ndc
        list_overflow = list_overflow + torch.clamp(counts[c] - n_c, min=0)
        # offset enumeration (broadcast against [1, e_c]: no gathers)
        off = torch.arange(e_c, dtype=i32, device=dev)[None, :]
        oa = off // (py * ndc)
        ob = (off // ndc) % py
        oc = off % ndc
        piece = max(1, ENUM_ROWS // e_c)
        for s in range(0, n_c, piece):
            lane = torch.arange(s, min(s + piece, n_c), device=dev)
            ids_c = ids_sorted[starts[c] + lane]
            row_ok = lane < counts[c]
            vi0, vj0, vd0 = i0[ids_c], j0[ids_c], d0[ids_c]
            vw, vh, vnd = w[ids_c], h[ids_c], nd[ids_c]
            vq = qvox[ids_c]                                    # [n, 3]
            ii = vi0[:, None] + oa
            jj = vj0[:, None] + ob
            dd = vd0[:, None] + oc
            live = (row_ok[:, None] & (oa < vw[:, None])
                    & (ob < vh[:, None]) & (oc < vnd[:, None])
                    & (ii < width) & (jj < height))
            # band verify: the sample position (rays recomputed inline)
            # must land inside the voxel expanded by BAND
            rd = _pixel_dirs(ii.to(f32).reshape(-1), jj.to(f32).reshape(-1),
                             camrotc2w, height, width, focal)
            t = near + (dd.to(f32).reshape(-1) + 0.5) * step_t
            pos = campos + rd * t[:, None]
            f = ((pos - ranges_min) / scaled_vsize).reshape(-1, e_c, 3)
            vq_b = vq.to(f32)[:, None, :]
            near_in = ((f > vq_b - BAND) & (f < vq_b + 1 + BAND)).all(-1)
            live = live & near_in
            ray = jj * width + ii
            key_parts.append(torch.where(
                live, (ray << 9) | dd, INT_MAX).reshape(-1))
            val_parts.append(ids_c.to(i32)[:, None].expand(-1, e_c)
                             .reshape(-1))
            # certainly-inside flag: more than BAND from every face; the
            # exact verify must agree on these rows (`certain_flip`)
            certain = ((f > vq_b + BAND) & (f < vq_b + 1 - BAND)).all(-1)
            vcoord = ((vq[:, 0] << 21) | (vq[:, 1] << 11)
                      | (vq[:, 2] << 1))[:, None]
            vc_parts.append((vcoord | certain.to(i32)).reshape(-1))
            del rd, t, pos, f, near_in, certain, live, ray, ii, jj, dd

    keys = torch.cat(key_parts)
    vals = torch.cat(val_parts)
    vcs = torch.cat(vc_parts)
    del key_parts, val_parts, vc_parts
    n_valid = (keys != INT_MAX).sum()
    live_overflow = torch.clamp(n_valid - live_budget, min=0)

    S = min(live_budget, int(keys.shape[0]))
    keys_s, order = torch.sort(keys, stable=True)
    keys_p = keys_s[:S]
    order = order[:S]
    vals_p = vals[order]
    vcs_p = vcs[order]
    del keys, keys_s, vals, vcs, order

    ray_p = keys_p >> 9
    d_p = keys_p & 511
    in_prefix = keys_p != INT_MAX
    # exact verify on the bounded prefix, with the true ray directions and
    # the render path's own arithmetic
    rd_true = raydirs_frame[torch.where(in_prefix, ray_p, 0).long()]
    t_p = near + (d_p.to(f32) + 0.5) * step_t
    pos_p = campos + rd_true * t_p[:, None]
    gcf = torch.floor((pos_p - ranges_min) / scaled_vsize)
    vq_p = torch.stack([(vcs_p >> 21) & 1023, (vcs_p >> 11) & 1023,
                        (vcs_p >> 1) & 1023], -1).to(f32)
    accept = in_prefix & (gcf == vq_p).all(-1)
    certain_flip = (((vcs_p & 1) == 1) & in_prefix & ~accept).sum()

    # segmented rank over accepted rows: b is the exclusive accept prefix,
    # a row's base is b at the first row of its ray's run. The rows are
    # sorted by ray, so a binary search finds each run's start (the
    # reference carries the base along with a running max, which a GPU
    # scans as one long row: 12 ms for the 4 M-row prefix on an H100)
    a = accept.long()
    b = torch.cumsum(a, 0) - a
    base = b[torch.searchsorted(ray_p, ray_p)]
    rank = b - base
    packed = ((vals_p + 1) << 9) | d_p
    dest = torch.where(accept & (rank < cap), ray_p.long() * cap + rank,
                       HW * cap)
    # accepted destinations are unique; every dropped row shares the one
    # sentinel element past the end, which is sliced off
    emit = torch.zeros(HW * cap + 1, dtype=i32, device=dev)
    emit[dest] = packed
    counters = torch.stack([class_overflow, list_overflow, live_overflow,
                            certain_flip]).to(i32)
    return emit[:HW * cap].reshape(HW, cap), counters


def make_raster_program(height: int, width: int, focal, D: int, cap: int,
                        classes=DEFAULT_CLASSES,
                        class_budgets=(0, 65536, 8192),
                        live_budget: int = 4_194_304):
    """Frame front-end with the static geometry baked in: returns
    fn(qvox, ranges_min, scaled_vsize, campos, camrotc2w, raydirs_frame,
    near, step_t) -> (emit [H*W, cap], counters)."""
    @torch.no_grad()
    def fn(qvox, ranges_min, scaled_vsize, campos, camrotc2w,
           raydirs_frame, near, step_t):
        return raster_emit_table(
            qvox, ranges_min, scaled_vsize, campos, camrotc2w,
            raydirs_frame, height, width, focal, near, None, D,
            step_t, cap, classes=classes, class_budgets=class_budgets,
            live_budget=live_budget)

    return fn
