"""The yardstick's arithmetic: the card's peaks, the operations and bytes
of the tower and of the fused chunk, and a kernel's least time.

Frozen copies, as they were when copied: `PEAK_BYTES`, `PEAK_FLOPS`,
`ROW_MACS`, `SLOT_MACS`, `bound`, `tower_macs` and `colour_macs` of
`chip_smoke.py`; `decode_matmul_flops` of
`pointnerf2studio_torch/utils/flops.py` on the configuration's widths
(`row_flops`, `slot_flops`). The counts they are applied to come from the
benchmark's own reference (`perfbench/reference/pointnerf.py`) on the
cell's inputs, never from the program.
"""

from __future__ import annotations

# the card's published peaks (H100 SXM, 700 W): device memory bytes/s and
# dense bf16 tensor-core FLOP/s
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 989e12
# the peak of the precision a tower computes in: bf16 on the tensor cores,
# float32 with TF32 off on the CUDA cores (the H100 SXM's 67 TFLOP/s)
PEAK_FLOPS_OF = {"bfloat16": PEAK_FLOPS, "float32": 67e12}
# multiply-adds per (slot, neighbour) row of the per-neighbour tower and
# per slot of the colour tower (hidden 256, colour 128, 3 colour layers)
ROW_MACS = 284 * 256 + 256 * 256 + 263 * 256 + 256 * 256 + 256
SLOT_MACS = 280 * 128 + 128 * 128 + 128 * 128 + 128 * 3
# bytes a fused chunk reads for each valid slot besides its candidates and
# its neighbours' payload (qslot, locs, centre, ray direction, mask) and
# writes (sigma, rgb, found), and a neighbour's payload row (48 bf16)
SLOT_IO_BYTES = 4 + 12 + 12 + 12 + 1 + 4 + 12 + 1
PAYLOAD_ROW_BYTES = 96


def peak_flops(agg: dict) -> float:
    """The card's peak FLOP/s in the tower's compute dtype."""
    return PEAK_FLOPS_OF[agg["compute_dtype"]]


def bound(n_bytes: float, flops: float):
    """(least seconds the card could take, what bounds it)."""
    t_b, t_f = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def tower_macs(C, D, H, nff, ndf) -> int:
    """Multiply-adds of the per-neighbour tower a row (ROW_MACS at 32, 6,
    256, 3, 5)."""
    return (C + 2 * C * nff + 2 * D * ndf) * H + H * H + (H + 7) * H \
        + H * H + H


def colour_macs(H, HC, layers, nvf) -> int:
    """Multiply-adds of the colour tower a slot (SLOT_MACS at 256, 128, 3,
    4)."""
    return (H + 6 * nvf) * HC + (layers - 1) * HC * HC + HC * 3


def row_flops(agg: dict) -> int:
    """Operations of one (slot, neighbour) row through mlp_base, mlp_head
    and the density head."""
    return 2 * tower_macs(agg["point_features_dim"], 6, agg["hidden_size"],
                          agg["num_feat_freqs"], agg["num_dist_freqs"])


def slot_flops(agg: dict) -> int:
    """Operations of one slot's colour tower."""
    return 2 * colour_macs(agg["hidden_size"], agg["hidden_size_color"],
                           agg["num_color_layers"], agg["num_viewdir_freqs"])


def decode2_work(agg: dict, rows: float, slots_found: float):
    """(operations, bytes) of the K-accumulating tower (`fused_decode2`)
    on `rows` (sample, neighbour) rows within the radius of `slots_found`
    samples: each row's inputs read once (its bf16 embedding, distances,
    colour and direction terms and its f32 weight: 94 bytes) and each
    sample's K-sums written once (hidden f32 and sigma)."""
    return (rows * row_flops(agg),
            rows * 94 + slots_found * (4 * agg["hidden_size"] + 4))


def render_work(agg: dict, cand_cap: int, slots: float, rows: float,
                slots_found: float):
    """(operations, bytes) of the tower work that an exact render of
    `slots` valid samples, `slots_found` of them with a neighbour and
    `rows` (sample, neighbour) rows within the radius needs: each input
    byte read once (a slot's candidate metas and xyz, its neighbours'
    payload rows, its geometry) and each output byte written once."""
    flops = rows * row_flops(agg) + slots_found * slot_flops(agg)
    n_bytes = (slots * (cand_cap * (4 + 6) + SLOT_IO_BYTES)
               + rows * PAYLOAD_ROW_BYTES)
    return flops, n_bytes
