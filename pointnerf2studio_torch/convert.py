"""Carry weights and state from the JAX reference into the port.

The JAX package keeps plain numpy-convertible trees: aggregator params
as {tower: [{"kernel": [in, out], "bias": [out]}, ...]}, and flax
dataclasses of arrays for the point cloud and the fat cache. These
functions take numpy arrays (np.asarray of each JAX leaf) and build the
port's objects, so a test can run both packages on the same weights,
the same cloud and the same cache. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from pointnerf2studio_torch.config import AggregatorConfig
from pointnerf2studio_torch.models.aggregator import TOWERS, Aggregator
from pointnerf2studio_torch.models.fast_render import FatCache
from pointnerf2studio_torch.models.neural_points import NeuralPointCloud


def _t(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if dtype is torch.bfloat16:
        # numpy has no bfloat16: carry the raw 16-bit patterns
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a.copy(), dtype=dtype, device=device)


@torch.no_grad()
def aggregator_from_jax(tree: Mapping[str, Any], cfg: AggregatorConfig,
                        device: torch.device | str = "cpu") -> Aggregator:
    """JAX aggregator params -> Aggregator. A JAX kernel is [in, out];
    an nn.Linear weight is [out, in], so each kernel is transposed."""
    agg = Aggregator(cfg, device=device)
    for name in TOWERS:
        layers = getattr(agg, name)
        if len(tree[name]) != len(layers):
            raise ValueError(f"{name}: {len(tree[name])} layers in the tree, "
                             f"{len(layers)} in the config")
        for lin, lyr in zip(layers, tree[name]):
            w = _t(lyr["kernel"], device, torch.float32).T
            if w.shape != lin.weight.shape:
                raise ValueError(f"{name}: kernel {tuple(w.shape[::-1])} does "
                                 f"not fit Linear{tuple(lin.weight.shape)}")
            lin.weight.copy_(w)
            lin.bias.copy_(_t(lyr["bias"], device, torch.float32))
    return agg


def cloud_from_jax(cloud, device: torch.device | str = "cpu"
                   ) -> NeuralPointCloud:
    """A JAX NeuralPointCloud (or any object with its fields) -> port."""
    f = torch.float32
    return NeuralPointCloud(
        xyz=_t(cloud.xyz, device, f),
        points_embeding=_t(cloud.points_embeding, device, f),
        points_conf=_t(cloud.points_conf, device, f),
        points_dir=_t(cloud.points_dir, device, f),
        points_color=_t(cloud.points_color, device, f),
        Rw2c=_t(cloud.Rw2c, device, f),
        alive=_t(cloud.alive, device, torch.bool))


def fat_cache_from_jax(cache, device: torch.device | str = "cpu"
                       ) -> FatCache:
    """A JAX fused-layout FatCache (kmeta/kpay set) -> port FatCache."""
    if cache.kmeta is None or cache.kpay is None:
        raise ValueError("the cache has no kernel-facing layout; build it "
                         "with chunk_mode='fused'")
    return FatCache(
        coor_2_qslot=_t(cache.coor_2_qslot, device, torch.int32),
        kmeta=_t(cache.kmeta, device, torch.int32),
        kpay=_t(cache.kpay, device, torch.bfloat16),
        n_q=_t(cache.n_q, device, torch.int32))
