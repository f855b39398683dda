"""Analytic matmul-FLOP accounting for the fast render pipeline.

A copy of `pointnerf2studio_tpu/utils/flops.py` on the port's
`models/aggregator._mlp_dims`: the matmul flops of a render from the
config's MLP dims and the measured slot occupancy
(FastRenderOutput.n_valid_slots).

Scope: matmul flops only - the decode tower per (slot, K) row, the
per-slot colour tower, and the one-hot payload-extract einsum of the
reference's XLA route. Geometry, positional encodings and compositing
are excluded, so a utilization quoted over a matmul peak from these
counts is conservative.

One difference: `QueryConfig.fast_chunk = 0` stands for chunks of 8192
slots (the fast render's rule); the reference divides by the 0 and
raises ZeroDivisionError, the port counts 8192.
"""

from __future__ import annotations

from pointnerf2studio_torch.models.aggregator import _mlp_dims


def decode_matmul_flops(cfg):
    """(flops_per_krow, flops_per_slot) from the aggregator's layer dims.

    flops_per_krow: one (slot, K) row through mlp_base + mlp_head +
    density_head (2 * in * out per layer: multiply and add).
    flops_per_slot: the aggregated-feature colour tower (mlp_color +
    color_head), one evaluation per slot (agg_intrp_order == 2).
    """
    dims = _mlp_dims(cfg.agg)
    per_krow = 2 * sum(
        i * o for i, o in
        dims["mlp_base"] + dims["mlp_head"] + dims["density_head"])
    per_slot = 2 * sum(
        i * o for i, o in dims["mlp_color"] + dims["color_head"])
    return per_krow, per_slot


def extract_flops_per_slot(cfg, cand_width: int, payload_width: int):
    """One-hot payload extract: einsum [Mc, K, C] x [Mc, C, W], 2 * K * C
    * W per slot."""
    return 2 * cfg.query.K * cand_width * payload_width


def executed_slots(n_valid: int, fast_chunk: int) -> int:
    """Valid slots -> executed slot rows: the decode runs fixed
    fast_chunk-sized chunks and skips only all-padding chunks (prefix
    validity), so execution rounds the valid count up to a chunk."""
    if n_valid <= 0:
        return 0
    return -(-n_valid // fast_chunk) * fast_chunk


def analytic_flops_per_ray(cfg, n_valid_slots_total: int, n_rays: int,
                           cand_width: int, payload_width: int,
                           n_dispatches: int = 1) -> float:
    """Executed matmul flops per ray at measured occupancy.

    n_valid_slots_total: the sum of FastRenderOutput.n_valid_slots over
    the frame's dispatches; the chunk rounding is applied per dispatch
    (assuming the valid slots spread evenly)."""
    per_krow, per_slot = decode_matmul_flops(cfg)
    per_slot_total = (cfg.query.K * per_krow + per_slot
                      + extract_flops_per_slot(cfg, cand_width,
                                               payload_width))
    nd = max(n_dispatches, 1)
    per_dispatch = n_valid_slots_total / nd
    exec_total = nd * executed_slots(int(per_dispatch),
                                     cfg.query.fast_chunk or 8192)
    return per_slot_total * exec_total / max(n_rays, 1)
