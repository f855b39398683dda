"""MVS view-batch construction from a posed image dataset.

A copy of the jax-free `pointnerf2studio_tpu/data/mvs_batches.py`. It
replaces the reference's `get_init_item` assembly
(reference: pointnerf/data/nerf_synth360_ft_dataset.py:476-552): for
each reference view, pick the nearest source views by camera position,
build full-res intrinsics/extrinsics, and carry near/far ranges. The
reference reads precomputed pair lists (data/nerf_synth_configs/list);
we select pairs by pose proximity, which reproduces their structure.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from pointnerf2studio_torch.data.blender import BlenderDataset
from pointnerf2studio_torch.models.mvsnet.pointgen import MVSViewBatch


def load_pair_list(path: str) -> List[List[int]]:
    """Parse a finetune-init pair list -> [[ref, src, ...], ...].

    Format (reference: nerf_synth_ft_dataset.py:279-289, shipped
    artifact data/dtu_configs/dtu_finetune_init_pairs.txt): first line
    is the pair count, then alternating lines of a reference-view id
    and a comma-separated source-view list.
    """
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    n = int(lines[0])
    triples = []
    for i in range(n):
        ref = int(lines[1 + 2 * i])
        srcs = [int(s) for s in lines[2 + 2 * i].split(",") if s]
        triples.append([ref] + srcs)
    return triples


def load_mvsnet_pairs(path: str) -> List[List[int]]:
    """Parse an MVSNet-style scored pair file -> [[ref, src...], ...]
    with sources in file (score-ranked) order.

    Format (shipped artifact data/dtu_configs/dtu_pairs.txt; the
    standard MVSNet pair.txt layout): first line is the view count,
    then per view an id line followed by
    ``N src_0 score_0 src_1 score_1 ...``.
    """
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    n = int(lines[0])
    triples = []
    for i in range(n):
        ref = int(lines[1 + 2 * i])
        tok = lines[2 + 2 * i].split()
        n_src = int(tok[0])
        srcs = [int(tok[1 + 2 * j]) for j in range(n_src)]
        triples.append([ref] + srcs)
    return triples


def load_dtu_split_ids(pairs_th_path: str, scan: str, split: str) -> List[int]:
    """View ids for a DTU scan/split from the shipped ``pairs.th``
    (reference: nerf_synth_ft_dataset.py:296 —
    ``torch.load('../data/dtu_configs/pairs.th')[f'{scan}_{split}']``)."""
    import torch

    table = torch.load(pairs_th_path, map_location="cpu",
                       weights_only=False)
    ids = table[f"{scan}_{split}"]
    return [int(v) for v in np.asarray(ids).reshape(-1)]


def camera_triangles(cam_xyz: np.ndarray) -> np.ndarray:
    """Triangulate the camera rig -> view triples [T, 3] int.

    The reference runs open3d ball-pivoting over the camera POSITIONS
    and uses each mesh triangle as one MVS (ref, src, src) triple
    (reference: nerf_synth360_ft_dataset.py:338-349 ->
    data_utils.triangluation_bpa:81-120). For cameras on a sphere —
    every supported capture rig — the convex hull of the positions is
    the same surface triangulation, and scipy provides it without the
    open3d dependency.
    """
    from scipy.spatial import ConvexHull

    c = np.asarray(cam_xyz, np.float64)
    hull = ConvexHull(c - c.mean(0, keepdims=True))
    return np.asarray(hull.simplices, np.int32)


def build_view_batches(
    dataset: BlenderDataset,
    num_src: int = 2,
    max_batches: Optional[int] = None,
    near_far_depth: Optional[Tuple[float, float]] = None,
    pairing: str = "nearest",
    pair_file: Optional[str] = None,
) -> Tuple[List[MVSViewBatch], np.ndarray, np.ndarray, np.ndarray]:
    """-> (view batches, alpha maps, intrinsics [V,3,3], w2cs [V,4,4]).

    `pairing`: "nearest" picks the closest cameras per reference view;
    "triangles" reproduces the reference's BPA camera-rig
    triangulation (one batch per triangle; requires num_src == 2);
    "file" reads `pair_file` — a finetune-init pair list or an
    MVSNet-style scored pair file (auto-detected), truncating sources
    to `num_src` (the reference's precomputed-pair path,
    nerf_synth_ft_dataset.py:279-296).

    Alpha maps here are binary foreground masks derived from non-white
    pixels (the blender loader composites onto white; the reference
    stores the PNG alpha directly — equivalent for synthetic data).
    """
    V = dataset.num_views
    campos = dataset.poses[:, :3, 3]
    w2cs = np.stack([np.linalg.inv(p) for p in dataset.poses])
    K = np.tile(dataset.intrinsics[None], (V, 1, 1))
    nf_depth = near_far_depth or (dataset.near, dataset.far)

    alphas = (np.any(dataset.images < 0.999, axis=-1)).astype(np.float32)

    if pairing == "triangles":
        if num_src != 2:
            raise ValueError("triangle pairing implies num_src == 2")
        triples = [list(t) for t in camera_triangles(campos)]
    elif pairing == "nearest":
        triples = []
        for r in range(V):
            d = np.linalg.norm(campos - campos[r], axis=-1)
            order = np.argsort(d)
            src = [v for v in order if v != r][:num_src]
            triples.append([r] + src)
    elif pairing == "file":
        if not pair_file:
            raise ValueError("pairing='file' requires pair_file")
        # auto-detect: MVSNet files have "N src score ..." source
        # lines (odd token count, >= 3); init lists are comma-separated
        with open(pair_file) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        if len(lines) >= 3 and "," not in lines[2] and \
                len(lines[2].split()) >= 3:
            triples = load_mvsnet_pairs(pair_file)
        else:
            triples = load_pair_list(pair_file)
        triples = [t[: 1 + num_src] for t in triples]
        for t in triples:
            if max(t) >= V or len(t) < 1 + num_src:
                raise ValueError(
                    f"pair file {pair_file}: views {t} out of range "
                    f"for a {V}-view dataset or too few sources")
    else:
        raise ValueError(f"unknown pairing {pairing!r}")

    batches: List[MVSViewBatch] = []
    for ids in triples[: (max_batches or len(triples))]:
        batches.append(MVSViewBatch(
            images=dataset.images[ids],
            intrinsics=K[ids],
            w2cs=w2cs[ids],
            c2ws=dataset.poses[ids],
            near_far_depth=nf_depth,
            near_far=(dataset.near, dataset.far),
        ))
    return batches, alphas, K, w2cs
