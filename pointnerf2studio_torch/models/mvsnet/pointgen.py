"""Neural point cloud generation from multi-view images.

Port of `pointnerf2studio_tpu/models/mvsnet/pointgen.py`, the reference's
point-initialisation pipeline (reference: pointnerf/run/train_ft.py:
51-167 `gen_points_filter_embeddings`, pointnerf/models/mvs/
mvs_points_model.py:261-382, pointnerf/models/mvs/filter_utils.py:
157-292, and pointnerf/models/mvs/mvs_utils.py:537-562,573-606):

  1. per view-triple: MVSNet depth + photometric confidence on the
     triple's 1/4-res images, nearest-upsampled to full res (or the
     dataset's depth, `depth_mode="gt"`),
  2. unproject to camera-space points (NDC -> cam),
  3. cross-view geometric consistency filtering (reproject the ref depth
     into every other view; accept if the pixel error < 1 px and the
     relative depth error < 1%; require >= geo_cnsst_num consistent
     views; average the consistent depths),
  4. visual-hull filtering against every training view's alpha mask,
  5. voxel downsampling at `vox_res` (points become voxel centroids;
     attributes come from the original point nearest each centroid:
     `data/pointcloud_init.voxel_downsample_closest`, on the host),
  6. per-point appearance embedding: FPN features + colour + view dir +
     confidence through the premlp.

The per-view math runs in torch on the device of the networks' weights;
the orchestration and the voxel step run on the host. Decisions on a
float edge (`dist < 1`, `rel < 0.01`, `conf > thresh`, the voxel of a
point) can go the other way on another device; tests bound such flips.
The reference returns a (0, 3) array for every key, the 32-wide embedding
included, when no point survives; the port raises a ValueError there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pointnerf2studio_torch.data.pointcloud_init import (
    voxel_downsample_closest)
from pointnerf2studio_torch.models.mvsnet.featurenet import (
    fpn_features, premlp_embed)
from pointnerf2studio_torch.models.mvsnet.layers import bilinear_grid_sample
from pointnerf2studio_torch.models.mvsnet.mvsnet import mvsnet_depth
from pointnerf2studio_torch.ops.march import to_i32


@dataclasses.dataclass
class PointGenConfig:
    num_depth_bins: int = 192
    depth_conf_thresh: float = 0.8
    geo_cnsst_num: int = 2
    vox_res: int = 320
    std_depth: float = 0.0
    alpha_thresh: float = 0.1
    ranges: Optional[Tuple[float, ...]] = None   # (x0,y0,z0,x1,y1,z1)
    default_conf: float = 0.15
    # Background sheet for unbounded / ScanNet-style scenes
    # (filter_utils.py:275-283): every pixel REJECTED by the fused filter
    # contributes a point at its camera xy pushed to depth far +
    # far_plane_shift, confidence 0.02. None = off (NeRF-Synthetic).
    far_plane_shift: Optional[float] = None
    # "mvsnet": MVSNet depth + photometric confidence (manual_depth_view
    # == 1); "gt": the reference view's dataset depth, confidence 1
    # (manual_depth_view == 0; needs MVSViewBatch.gt_depth)
    depth_mode: str = "mvsnet"


@dataclasses.dataclass
class MVSViewBatch:
    """One reference view + its source views (full resolution)."""
    images: np.ndarray        # [V, H, W, 3], ref first
    intrinsics: np.ndarray    # [V, 3, 3] full-res
    w2cs: np.ndarray          # [V, 4, 4]
    c2ws: np.ndarray          # [V, 4, 4]
    near_far_depth: Tuple[float, float]   # depth-bin range (MVS)
    near_far: Tuple[float, float]         # scene range
    # ground-truth reference-view depth [H, W] (depth_mode="gt")
    gt_depth: Optional[np.ndarray] = None


def quarter_intrinsics(K: np.ndarray) -> np.ndarray:
    Kq = K.copy()
    Kq[..., :2, :] = Kq[..., :2, :] / 4.0
    return Kq


def rel_proj_mats(intrinsics_q: np.ndarray, w2cs: np.ndarray) -> np.ndarray:
    """[V, 4, 4] src @ inv(ref) projection mats at 1/4 res (host)."""
    V = w2cs.shape[0]
    proj = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    proj[:, :3, :4] = intrinsics_q @ w2cs[:, :3, :4]
    ref_inv = np.linalg.inv(proj[0])
    return (proj @ ref_inv).astype(np.float32)


def depth_to_cam_points(depth: torch.Tensor, conf: torch.Tensor,
                        intrinsic: torch.Tensor,
                        near_far: Tuple[float, float],
                        std_depth: float = 0.0,
                        noise: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-res depth map -> camera-space points [H, W, 3] + validity mask
    (NDC clamp + unprojection, mvs_points_model.py:150-181 and
    mvs_utils.ndc_2_cam:92-99). `noise` [H, W] standard-normal draws
    jitter the NDC depth by `std_depth` where both are given."""
    H, W = depth.shape
    near, far = near_far
    dev = depth.device
    mask = (depth >= near) & (depth <= far)
    ndc_z = (depth - near) / (far - near)
    if std_depth > 0.0 and noise is not None:
        ndc_z = ndc_z + std_depth * noise
    ndc_z = torch.clamp(ndc_z, 0.0, 1.0)
    y, x = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) / (H - 1),
        torch.arange(W, dtype=torch.float32, device=dev) / (W - 1),
        indexing="ij")
    cam_z = ndc_z * (far - near) + near
    cam_xy = torch.stack([x * (W - 1), y * (H - 1)], -1) * cam_z[..., None]
    cam_xyz = torch.cat([cam_xy, cam_z[..., None]], -1)
    Kinv_t = torch.linalg.inv(intrinsic).T
    return cam_xyz @ Kinv_t, mask & (conf > 0)


def _sample_depth_border(depth_src: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with border padding, align_corners=True
    (filter_utils.py:183)."""
    H, W = depth_src.shape
    fx = torch.clamp(x, 0.0, W - 1.0)
    fy = torch.clamp(y, 0.0, H - 1.0)
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wx = fx - x0
    wy = fy - y0
    return (depth_src[y0, x0] * (1 - wx) * (1 - wy)
            + depth_src[y0, x1] * wx * (1 - wy)
            + depth_src[y1, x0] * (1 - wx) * wy
            + depth_src[y1, x1] * wx * wy)


def geometric_consistency(
    depth_ref: torch.Tensor, K_ref: torch.Tensor, E_ref: torch.Tensor,
    depth_src: torch.Tensor, K_src: torch.Tensor, E_src: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(geo_mask, reprojected depth zeroed outside mask) for one src view
    (filter_utils.check_geometric_consistency_gpu:203-220)."""
    H, W = depth_ref.shape
    dev = depth_ref.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    ones = torch.ones_like(x)
    pix = torch.stack([x.reshape(-1), y.reshape(-1), ones.reshape(-1)], 0)
    xyz_ref = torch.linalg.inv(K_ref) @ (pix * depth_ref.reshape(-1))
    T = E_src @ torch.linalg.inv(E_ref)
    xyz_src = T[:3, :3] @ xyz_ref + T[:3, 3:4]
    Kx = K_src @ xyz_src
    xy_src = Kx[:2] / Kx[2:3]
    xs = xy_src[0].reshape(H, W)
    ys = xy_src[1].reshape(H, W)
    d_src = _sample_depth_border(depth_src, xs, ys)
    xyz_src2 = torch.linalg.inv(K_src) @ (
        torch.cat([xy_src, ones.reshape(1, -1)], 0) * d_src.reshape(-1))
    Tb = E_ref @ torch.linalg.inv(E_src)
    xyz_re = Tb[:3, :3] @ xyz_src2 + Tb[:3, 3:4]
    depth_re = xyz_re[2].reshape(H, W)
    Kr = K_ref @ xyz_re
    xr = (Kr[0] / Kr[2]).reshape(H, W)
    yr = (Kr[1] / Kr[2]).reshape(H, W)
    dist = torch.sqrt((xr - x) ** 2 + (yr - y) ** 2)
    rel = torch.abs(depth_re - depth_ref) / torch.clamp(depth_ref, min=1e-8)
    mask = (dist < 1.0) & (rel < 0.01)
    return mask, torch.where(mask, depth_re, torch.zeros_like(depth_re))


def filter_view(
    cam_xyz: torch.Tensor,          # [H, W, 3] this ref view's points
    conf: torch.Tensor,             # [H, W]
    points_mask: torch.Tensor,      # [H, W]
    view_idx: int,
    all_depths: Sequence[torch.Tensor],
    all_K: Sequence[torch.Tensor],
    all_E: Sequence[torch.Tensor],
    cfg: PointGenConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-view fused mask + averaged depth (filter_by_masks_gpu)."""
    depth_ref = cam_xyz[..., 2]
    geo_sum = torch.zeros(depth_ref.shape, dtype=torch.int32,
                          device=depth_ref.device)
    depth_sum = torch.zeros_like(depth_ref)
    for j in range(len(all_depths)):
        if j == view_idx:
            continue
        m, d = geometric_consistency(depth_ref, all_K[view_idx],
                                     all_E[view_idx], all_depths[j],
                                     all_K[j], all_E[j])
        geo_sum = geo_sum + m.to(torch.int32)
        depth_sum = depth_sum + d
    depth_avg = (depth_sum + depth_ref) / (geo_sum + 1)
    final = (conf > cfg.depth_conf_thresh) & points_mask
    if len(all_depths) > 1:
        final = final & (geo_sum >= cfg.geo_cnsst_num)
    xyz = torch.cat([cam_xyz[..., :2], depth_avg[..., None]], -1)
    return xyz, final, conf


def alpha_masking(points_w: torch.Tensor, alphas: np.ndarray,
                  intrinsics: np.ndarray, w2cs: np.ndarray,
                  near_far: Optional[Tuple[float, float]],
                  thresh: float = 0.1) -> torch.Tensor:
    """Visual-hull mask: keep points projecting into alpha > thresh (or
    out of frame) in EVERY view (mvs_utils.alpha_masking:573-606)."""
    dev = points_w.device
    N = points_w.shape[0]
    keep = torch.ones(N, dtype=torch.bool, device=dev)
    p1 = torch.cat([points_w, torch.ones((N, 1), dtype=points_w.dtype,
                                         device=dev)], -1)
    for i in range(alphas.shape[0]):
        alpha = torch.as_tensor(alphas[i], device=dev)
        H, W = alpha.shape
        cam = p1 @ torch.as_tensor(w2cs[i], device=dev).T
        pix = cam[:, :3] @ torch.as_tensor(intrinsics[i], device=dev).T
        xy = to_i32(torch.floor(pix[:, :2] / pix[:, 2:3]))
        inb = ((xy >= 0) & (xy < torch.tensor([W, H], device=dev))).all(-1)
        xc = torch.clamp(xy[:, 0], 0, W - 1).long()
        yc = torch.clamp(xy[:, 1], 0, H - 1).long()
        m = (alpha[yc, xc] + (~inb).to(alpha.dtype)) > thresh
        if near_far is not None:
            m = m & (cam[:, 2] >= near_far[0] - 1.0) & (cam[:, 2]
                                                         <= near_far[1])
        keep = keep & m
    return keep


def embed_points(
    fpn,
    cam_xyz: torch.Tensor,          # [N, 3] points in this view's ref cam
    conf: torch.Tensor,             # [N]
    images: torch.Tensor,           # [V, H, W, 3]
    c2w_ref: torch.Tensor,          # [4, 4] of the ref view
    intrinsic: torch.Tensor,        # [3, 3] full res
) -> Dict[str, torch.Tensor]:
    """Per-point embedding/colour/dir/conf (query_embedding with
    imgfeat_0_0123 dir_0 point_conf, pointdir_w=True;
    mvs_points_model.py:224-258, extract_2d:199-220)."""
    H, W = images.shape[1:3]
    feats = fpn_features(fpn, images[0])
    pix = (cam_xyz / cam_xyz[:, 2:3]) @ intrinsic.T
    xy = pix[:, :2]
    lim = torch.tensor([W - 1, H - 1], dtype=xy.dtype, device=xy.device)
    inb = ((xy >= 0) & (xy <= lim)).all(-1)
    gx = xy[:, 0] / ((W - 1) / 2.0) - 1.0
    gy = xy[:, 1] / ((H - 1) / 2.0) - 1.0
    grid = torch.stack([gx, gy], -1)
    sampled = [bilinear_grid_sample(f, grid, align_corners=True)
               * inb[:, None] for f in feats]
    colors = sampled[0]
    emb_feats = torch.cat(sampled[1:], -1)                        # [N, 56]
    dirs = cam_xyz / (torch.linalg.norm(cam_xyz, dim=-1, keepdim=True)
                      + 1e-6)
    dirs_w = dirs @ c2w_ref[:3, :3].T                             # pointdir_w
    conf = conf[:, None]
    embedding = premlp_embed(fpn, emb_feats, colors, dirs_w, conf)
    return {"embedding": embedding, "color": colors, "dir": dirs_w,
            "conf": conf}


def _device_of(module) -> torch.device:
    return next(module.parameters()).device


@torch.no_grad()
def generate_point_cloud(
    mvs_params,
    fpn_params,
    view_batches: List[MVSViewBatch],
    alphas: Optional[np.ndarray] = None,       # [Vall, H, W]
    alpha_intrinsics: Optional[np.ndarray] = None,
    alpha_w2cs: Optional[np.ndarray] = None,
    cfg: PointGenConfig = PointGenConfig(),
    stats: Optional[dict] = None,
) -> Dict[str, np.ndarray]:
    """Full pipeline -> dict of xyz/embedding/color/dir/conf numpy arrays,
    computed on the device of `fpn_params`. `stats`, where given, gets
    the pixels and points each stage keeps. Raises ValueError when no
    point survives the filters."""
    dev = _device_of(fpn_params)
    f32 = torch.float32

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    cam_xyz_l, conf_l, mask_l, K_l, E_l = [], [], [], [], []
    for vb in view_batches:
        if cfg.depth_mode == "gt":
            if vb.gt_depth is None:
                raise ValueError(
                    "depth_mode='gt' needs MVSViewBatch.gt_depth")
            depth = t(vb.gt_depth)
            conf = torch.ones_like(depth)
        else:
            Kq = quarter_intrinsics(vb.intrinsics)
            proj = rel_proj_mats(Kq, vb.w2cs)
            dmin, dmax = vb.near_far_depth
            dvals = (dmin + np.arange(cfg.num_depth_bins, dtype=np.float32)
                     * ((dmax - dmin) / cfg.num_depth_bins))
            depth_q, conf_q, _ = mvsnet_depth(
                mvs_params, t(_downsample4(vb.images)), t(proj), t(dvals))
            depth = _upsample_nearest(depth_q, vb.images.shape[1:3])
            conf = _upsample_nearest(conf_q, vb.images.shape[1:3])
        cam_xyz, mask = depth_to_cam_points(
            depth, conf, t(vb.intrinsics[0]), vb.near_far, cfg.std_depth)
        cam_xyz_l.append(cam_xyz)
        conf_l.append(conf)
        mask_l.append(mask)
        K_l.append(t(vb.intrinsics[0]))
        E_l.append(t(vb.w2cs[0]))
    if stats is not None:
        stats["pixels"] = int(sum(m.numel() for m in mask_l))
        stats["depth_in_range"] = int(sum(int(m.sum()) for m in mask_l))
        stats["conf_above"] = int(sum(
            int(((c > cfg.depth_conf_thresh) & m).sum())
            for c, m in zip(conf_l, mask_l)))

    depths = [c[..., 2] for c in cam_xyz_l]
    world_l, conf_f_l, vid_l = [], [], []
    for i in range(len(view_batches)):
        xyz, final, conf = filter_view(cam_xyz_l[i], conf_l[i], mask_l[i],
                                       i, depths, K_l, E_l, cfg)
        final_np = final.reshape(-1).cpu().numpy()
        xyz_np = xyz.reshape(-1, 3).cpu().numpy()
        xyz_cam = xyz_np[final_np]
        c = conf.reshape(-1).cpu().numpy()[final_np]
        if cfg.far_plane_shift is not None:
            # the background sheet (filter_utils.py:275-283): rejected
            # pixels keep their camera xy, depth far + far_plane_shift,
            # confidence 0.02
            bg_xy = xyz_np[~final_np, :2]
            bg_z = np.full(
                (bg_xy.shape[0], 1),
                view_batches[i].near_far[1] + cfg.far_plane_shift,
                np.float32)
            xyz_cam = np.concatenate(
                [xyz_cam, np.concatenate([bg_xy, bg_z], -1)], 0)
            c = np.concatenate(
                [c, np.full(bg_xy.shape[0], 0.02, np.float32)], 0)
        c2w = np.linalg.inv(E_l[i].cpu().numpy())
        world = np.concatenate(
            [xyz_cam, np.ones_like(xyz_cam[:, :1])], -1) @ c2w.T
        world = world[:, :3]
        if cfg.ranges is not None and cfg.ranges[0] > -90.0:
            r = np.asarray(cfg.ranges, np.float32)
            keep = np.all((world >= r[:3]) & (world <= r[3:]), -1)
            world, c = world[keep], c[keep]
        world_l.append(world)
        conf_f_l.append(c)
        vid_l.append(np.full(world.shape[0], i, np.int32))

    world = np.concatenate(world_l, 0)
    confs = np.concatenate(conf_f_l, 0)
    vids = np.concatenate(vid_l, 0)
    if stats is not None:
        stats["filtered"] = int(world.shape[0])

    if alphas is not None:
        nf = view_batches[0].near_far if (cfg.ranges is None
                                          or cfg.ranges[0] < -90.0) else None
        keep = alpha_masking(t(world), alphas, alpha_intrinsics,
                             alpha_w2cs, nf, cfg.alpha_thresh).cpu().numpy()
        world, confs, vids = world[keep], confs[keep], vids[keep]
    if stats is not None:
        stats["alpha_kept"] = int(world.shape[0])

    if cfg.vox_res > 0 and world.shape[0] > 0:
        cent, min_idx = voxel_downsample_closest(world, cfg.vox_res)
        world = cent
        confs = confs[min_idx]
        vids = vids[min_idx]
    if world.shape[0] == 0:
        raise ValueError(
            f"generate_point_cloud: no point survived the filters of "
            f"{len(view_batches)} view batches (confidence > "
            f"{cfg.depth_conf_thresh}, >= {cfg.geo_cnsst_num} consistent "
            f"views, the alpha hull, the ranges)")
    if stats is not None:
        stats["points"] = int(world.shape[0])

    # per-view embedding of the surviving points
    out = {k: [] for k in ("xyz", "embedding", "color", "dir", "conf")}
    for i, vb in enumerate(view_batches):
        sel = vids == i
        if not sel.any():
            continue
        pts_w = world[sel]
        E = E_l[i].cpu().numpy()
        cam = np.concatenate([pts_w, np.ones_like(pts_w[:, :1])], -1) @ E.T
        res = embed_points(
            fpn_params, t(cam[:, :3]), t(confs[sel]), t(vb.images),
            t(np.linalg.inv(E)), t(vb.intrinsics[0]))
        out["xyz"].append(pts_w)
        for k in ("embedding", "color", "dir", "conf"):
            out[k].append(res[k].to(f32).cpu().numpy())
    return {k: np.concatenate(v, 0) for k, v in out.items()}


def _downsample4(images: np.ndarray) -> np.ndarray:
    """Area-downsample x4 on the host (the reference feeds 1/4-res images
    to MVSNet)."""
    V, H, W, C = images.shape
    return images.reshape(V, H // 4, 4, W // 4, 4, C).mean((2, 4)).astype(
        np.float32)


def _upsample_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    H, W = hw
    h, w = x.shape
    return torch.repeat_interleave(
        torch.repeat_interleave(x, H // h, 0), W // w, 1)
