"""`ns-train` surface of the port (optional nerfstudio shim).

Port of `pointnerf2studio_tpu/nerfstudio_shim.py`. The reference
registers its method through the `nerfstudio.method_configs` entry point
(reference: pyproject.toml:24-25 -> pointnerf/nerfstudio/
studio_config.py:52-54) and carries every model hyperparameter in a
studio `PointNerfConfig` (pointnerf/nerfstudio/studio_model.py:61-118).
Here:

* `studio_to_tpu_config`: the pure mapping from the studio config's field
  names and values onto the port's `PointNerfConfig` tree (works without
  nerfstudio installed). The name is the JAX package's, so that both
  shims take the same calls.
* `pointnerf_original`: read lazily, as the reference's. Without
  nerfstudio the read raises ImportError, as the reference's does; with
  it, NotImplementedError: the method spec (a model over the port's
  render, a pipeline stepping its trainer) is not ported (ROADMAP queue
  1 item 13).

The port registers no entry point for it: the name `pointnerf-original`
belongs to the JAX package's registration in pyproject.toml.
"""

from __future__ import annotations

from typing import Any, Optional

from pointnerf2studio_torch.config import (AggregatorConfig, PointNerfConfig,
                                           QueryConfig, TrainConfig)

# Studio-config field names (studio_model.py:61-118) -> where they live
# in the config tree.
_QUERY_FIELDS = ("vsize", "vscale", "kernel_size", "query_size", "ranges",
                 "z_depth_dim", "SR", "K", "max_o", "P", "NN")
_AGG_FIELDS = ("num_pos_freqs", "num_viewdir_freqs", "num_feat_freqs",
               "num_dist_freqs", "agg_dist_pers", "point_features_dim",
               "point_color_mode", "point_dir_mode",
               "num_mlp_base_layers", "num_mlp_head_layers",
               "num_color_layers", "hidden_size", "hidden_size_color")
_INT_TUPLE_FIELDS = {"vscale", "kernel_size", "query_size"}


def studio_to_tpu_config(
    path_point_cloud: Optional[str] = None,
    eval_num_rays_per_chunk: int = 4096,
    num_samples: int = 80,
    zero_epsilon: float = 1e-3,
    zero_one_loss_weights: float = 1e-4,
    **studio_fields: Any,
) -> PointNerfConfig:
    """Map the reference studio `PointNerfConfig` fields onto the port's
    config tree. Unknown fields raise (typo protection, as tyro's
    strictness)."""
    qkw, akw = {}, {}
    for name, val in studio_fields.items():
        if name in _QUERY_FIELDS:
            if isinstance(val, (list, tuple)):
                conv = int if name in _INT_TUPLE_FIELDS else float
                val = tuple(conv(v) for v in val)
            qkw[name] = val
        elif name in _AGG_FIELDS:
            akw[name] = val
        else:
            raise TypeError(f"unknown studio config field: {name!r}")
    train = TrainConfig(zero_epsilon=zero_epsilon,
                        zero_one_loss_weight=zero_one_loss_weights)
    return PointNerfConfig(
        query=QueryConfig(**qkw),
        agg=AggregatorConfig(**akw),
        train=train,
        path_point_cloud=(str(path_point_cloud)
                          if path_point_cloud is not None else None),
        num_samples=num_samples,
        eval_num_rays_per_chunk=eval_num_rays_per_chunk,
    )


def _build_method_spec():
    """The MethodSpecification is not ported. nerfstudio is imported
    first, so that without it the read raises ImportError as the
    reference's does."""
    import nerfstudio  # noqa: F401
    raise NotImplementedError(
        "pointnerf_original: the nerfstudio method spec is not ported "
        "(ROADMAP queue 1 item 13)")


def __getattr__(name: str):
    if name == "pointnerf_original":
        try:
            return _build_method_spec()
        except ImportError as e:
            raise ImportError(
                "ns-train integration needs the `studio` extra "
                "(nerfstudio installed)") from e
    raise AttributeError(name)
