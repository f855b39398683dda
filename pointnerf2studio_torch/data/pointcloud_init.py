"""Point-cloud initialisation from external reconstructions.

Port of `pointnerf2studio_tpu/data/pointcloud_init.py`: the colmap scene
family starts its neural cloud from a COLMAP dense reconstruction
(reference: pointnerf/data/nerf_synth360_ft_dataset.py:358-375), the
ScanNet family from its sensor depth maps (train_ft.py:652-654). Here:
a dependency-free PLY reader (ascii and binary_little_endian),
`init_points_from_depth` (the depth maps unprojected to world points)
and `voxel_downsample_closest` (a copy of
models/mvsnet/pointgen.py's), all numpy and equal to the reference's,
and `init_cloud_from_points`, which builds a trainable NeuralPointCloud
on a device.

The reference draws its random features and its point noise with
`jax.random`, which torch cannot reproduce; here they come from a
`torch.Generator` seeded with `seed` (features) and `seed + 1` (noise),
drawn on the host so that a seed gives the same cloud on every device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pointnerf2studio_torch.models import neural_points as npts
from pointnerf2studio_torch.ops.encoding import positional_encoding

_PLY_DTYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
}


def load_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY point cloud -> {"xyz": [N,3] f32, "color": [N,3] f32
    in [0,1] or None}. Supports ascii and binary_little_endian vertex
    elements (the formats COLMAP/Open3D emit)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props = []          # (name, numpy dtype) for the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError("list property in vertex element")
                props.append((tok[2], _PLY_DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break

        names = [p[0] for p in props]
        if fmt == "ascii":
            rows = np.loadtxt(f, dtype=np.float64, max_rows=n_vertex,
                              ndmin=2)
            rec = {n: rows[:, i] for i, (n, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dt = np.dtype([(n, "<" + d) for n, d in props])
            raw = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt,
                                count=n_vertex)
            rec = {n: raw[n] for n in names}
        else:
            raise ValueError(f"unsupported PLY format: {fmt}")

    xyz = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
    color = None
    if all(c in rec for c in ("red", "green", "blue")):
        color = np.stack([rec["red"], rec["green"], rec["blue"]],
                         -1).astype(np.float32)
        if color.max() > 1.001:
            color = color / 255.0
    return {"xyz": xyz, "color": color}


def voxel_downsample_closest(xyz: np.ndarray, vox_res: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(centroids, index of the original point nearest each centroid).

    construct_vox_points_closest (mvs_utils.py:537-562) via numpy
    sort/segment ops instead of torch_scatter.
    """
    xyz = np.asarray(xyz, np.float32)
    xyz_min, xyz_max = xyz.min(0), xyz.max(0)
    edge = (xyz_max - xyz_min).max() * 1.05
    mid = (xyz_max + xyz_min) / 2
    smin = mid - edge / 2
    vsz = edge / vox_res
    g = np.floor((xyz - smin) / vsz).astype(np.int64)
    flat = (g[:, 0] * (vox_res + 2) + g[:, 1]) * (vox_res + 2) + g[:, 2]
    uniq, inv = np.unique(flat, return_inverse=True)
    nvox = uniq.shape[0]
    cnt = np.bincount(inv, minlength=nvox).astype(np.float64)
    cent = np.stack([
        np.bincount(inv, weights=xyz[:, c], minlength=nvox) for c in range(3)
    ], -1) / cnt[:, None]
    res = np.linalg.norm(xyz - cent[inv], axis=-1)
    order = np.lexsort((res, inv))
    first = np.concatenate([[True], inv[order][1:] != inv[order][:-1]])
    min_idx = order[first]
    return cent.astype(np.float32), min_idx


def init_features(generator: torch.Generator, xyz: torch.Tensor,
                  feat_dim: int, method: str = "rand") -> torch.Tensor:
    """Features of a cloud trained from bare geometry (reference:
    neural_points.py:284-304): rand (U - 0.5), zeros, ones, pos (the
    positional encoding of xyz, padded with rand) or gau_<std>."""
    n = xyz.shape[0]

    def rand(c):
        return torch.rand((n, c), generator=generator) - 0.5

    if method == "rand":
        return rand(feat_dim)
    if method == "zeros":
        return torch.zeros((n, feat_dim))
    if method == "ones":
        return torch.ones((n, feat_dim))
    if method == "pos":
        if feat_dim <= 3:
            return xyz[:, :feat_dim].clone()
        emb = positional_encoding(xyz, feat_dim // 6)
        if emb.shape[-1] < feat_dim:
            emb = torch.cat([emb, rand(feat_dim - emb.shape[-1])], -1)
        return emb
    if method.startswith("gau"):
        std = float(method.split("_")[1])
        return std * torch.randn((n, feat_dim), generator=generator)
    raise ValueError(f"unknown feature_init_method: {method}")


def _point_noise(generator: torch.Generator, xyz: np.ndarray, std: float,
                 mode: str) -> np.ndarray:
    """xyz plus one draw of the reference's point noise: gaussian of
    `std`, or uniform in [-std, std)."""
    shape = xyz.shape
    if mode == "pointgaussian":
        noise = std * torch.randn(shape, generator=generator)
    elif mode == "pointuniform":
        noise = (torch.rand(shape, generator=generator) - 0.5) * std * 2
    else:
        raise ValueError(f"unknown point noise mode: {mode}")
    return (torch.from_numpy(xyz) + noise).numpy()


def init_cloud_from_points(
    xyz: np.ndarray,                 # [N, 3]
    color: Optional[np.ndarray],     # [N, 3] in [0, 1] or None
    feat_dim: int = 32,
    feature_init_method: str = "rand",
    default_conf: float = 0.3,
    vox_res: int = 0,
    ranges: Optional[Tuple[float, ...]] = None,
    capacity: Optional[int] = None,
    seed: int = 0,
    point_noise: str = "",
    device: torch.device | str | None = None,
) -> npts.NeuralPointCloud:
    """A trainable NeuralPointCloud on `device` (None: the card) from bare
    geometry (reference: train_ft.py:645-680 and the feature init of
    neural_points.py:284-304): optional point noise at load
    ("pointgaussian_<std>", "pointuniform_<std>", and the doubling
    "pointuniformadd_<std>" / "pointuniformdouble_<std>"), the `ranges`
    crop, the voxel downsample at `vox_res`, features by
    `feature_init_method`, conf `default_conf`, directions the normalised
    positions, colour 0.5 where none is given."""
    xyz = np.asarray(xyz, np.float32)
    if point_noise:
        mode, std_s = point_noise.split("_")
        std = float(std_s)
        if std > 0.0:
            # the variants that change N first (reference
            # neural_points.py:681-688): "add" keeps the originals and
            # appends a jittered copy, "double" jitters a doubled set
            doubled = mode in ("pointuniformadd", "pointuniformdouble")
            keep_originals = mode == "pointuniformadd"
            if doubled:
                mode = "pointuniform"
                if color is not None:
                    color = np.concatenate([color, color], 0)
            base = xyz
            if doubled and not keep_originals:
                xyz = np.concatenate([xyz, xyz], 0)
            gen = torch.Generator().manual_seed(seed + 1)
            xyz = _point_noise(gen, xyz, std, mode).astype(np.float32)
            if keep_originals:
                xyz = np.concatenate([base, xyz], 0)
    if ranges is not None:
        r = np.asarray(ranges, np.float32)
        keep = np.all((xyz >= r[:3]) & (xyz <= r[3:]), axis=-1)
        xyz = xyz[keep]
        color = color[keep] if color is not None else None
    if vox_res > 0:
        _, keep_idx = voxel_downsample_closest(xyz, vox_res)
        xyz = xyz[keep_idx]
        color = color[keep_idx] if color is not None else None

    n = xyz.shape[0]
    gen = torch.Generator().manual_seed(seed)
    emb = init_features(gen, torch.from_numpy(xyz), feat_dim,
                        feature_init_method).numpy()
    conf = np.full((n, 1), default_conf, np.float32)
    dirs = xyz / np.maximum(np.linalg.norm(xyz, axis=-1, keepdims=True),
                            1e-6)
    if color is None:
        color = np.full((n, 3), 0.5, np.float32)
    return npts.from_arrays(xyz, emb, conf, dirs, color, capacity=capacity,
                            device=device)


def init_points_from_depth(
    depths: np.ndarray,       # [V, H, W] metric depth (0 = invalid)
    poses: np.ndarray,        # [V, 4, 4] c2w, OpenCV convention
    intrinsics: np.ndarray,   # [3, 3]
    images: Optional[np.ndarray] = None,    # [V, H, W, 3] for colors
    stride: int = 1,          # pixel subsampling
    max_depth: float = 10.0,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Unproject sensor depth maps into a world point cloud — the
    ScanNet init path (reference: train_ft.py:652-654
    `load_init_depth_points`, dataset class upstream-only).

    Returns (xyz [N, 3], color [N, 3] or None); feed into
    `init_cloud_from_points` for downsampling + feature init.
    """
    V, H, W = depths.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    us, vs = np.meshgrid(np.arange(0, W, stride), np.arange(0, H, stride))
    xyz_all, col_all = [], []
    for v in range(V):
        d = depths[v, ::stride, ::stride]
        ok = (d > 0) & (d < max_depth) & np.isfinite(d)
        if not ok.any():
            continue
        z = d[ok]
        x = (us[ok] + 0.5 - cx) / fx * z
        y = (vs[ok] + 0.5 - cy) / fy * z
        cam = np.stack([x, y, z, np.ones_like(z)], -1)
        world = cam @ poses[v].T
        xyz_all.append(world[:, :3].astype(np.float32))
        if images is not None:
            col_all.append(images[v, ::stride, ::stride][ok])
    xyz = np.concatenate(xyz_all, 0)
    color = np.concatenate(col_all, 0).astype(np.float32) \
        if images is not None else None
    return xyz, color
