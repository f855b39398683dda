"""The system under test, `pointnerf2studio_torch`, built from a
configuration file and the benchmark's inputs. The only module of the
harness, with the kinds, that imports the program."""

from __future__ import annotations

import dataclasses

import torch

from pointnerf2studio_torch.config import (
    AggregatorConfig, PointNerfConfig, QueryConfig, TrainConfig)
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.models.neural_points import from_arrays
from pointnerf2studio_torch.ops import _cuda

QUERY_KEYS = {f.name for f in dataclasses.fields(QueryConfig)}
AGG_KEYS = {f.name for f in dataclasses.fields(AggregatorConfig)}
TRAIN_KEYS = {f.name for f in dataclasses.fields(TrainConfig)}


def _fields(section: dict, keys, what: str) -> dict:
    """The section's settings as the program's dataclass takes them; a key
    the dataclass lacks raises (a misspelt setting would otherwise run
    another route)."""
    unknown = sorted(set(section) - set(keys))
    if unknown:
        raise KeyError(f"{what} has no setting {unknown}")
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in section.items()}


def config(cfg: dict, rays_per_batch: int = 4096) -> PointNerfConfig:
    """The program's config of a configuration file: its query,
    aggregator and (where it trains) train sections, camera planes and
    background; every other setting at the program's default."""
    cam = cfg["camera"]
    return PointNerfConfig(
        query=QueryConfig(**_fields(cfg["query"], QUERY_KEYS, "QueryConfig")),
        agg=AggregatorConfig(**_fields(cfg["agg"], AGG_KEYS,
                                       "AggregatorConfig")),
        train=TrainConfig(**_fields(cfg.get("train", {}), TRAIN_KEYS,
                                    "TrainConfig"),
                          rays_per_batch=rays_per_batch, fast_path=False,
                          prune_iter=0, prob_freq=0),
        near_plane=cam["near"], far_plane=cam["far"],
        bg_color=tuple(cfg["bg_color"]))


def cloud(arrays: dict, device):
    """The program's point cloud of the benchmark's arrays (copies)."""
    return from_arrays(*(arrays[k].detach().cpu().numpy() for k in
                         ("xyz", "emb", "conf", "dir", "color")),
                       device=device)


@torch.no_grad()
def aggregator(pcfg: PointNerfConfig, weights: dict, device) -> Aggregator:
    """The program's tower holding the benchmark's weights."""
    agg = Aggregator(pcfg.agg, seed=0, device=device)
    for name, layers in weights.items():
        for lin, (w, b) in zip(getattr(agg, name), layers):
            lin.weight.copy_(w)
            lin.bias.copy_(b)
    return agg


def launches() -> dict:
    """The program's own launch counter (kernel name -> launches)."""
    return dict(_cuda.LAUNCHES)
