"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: every test skips where torch.cuda is unavailable (the
decision is made inside the fixture, never at import). On a machine with
an NVIDIA GPU and nvcc, run them without the JAX test set-up:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from pointnerf2studio_torch.config import AggregatorConfig
from pointnerf2studio_torch.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_torch.models import fast_render as fr
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops import fused_chunk as fc
from pointnerf2studio_torch.ops import fused_decode as fd
from pointnerf2studio_torch.ops import fused_select as fs
from pointnerf2studio_torch.ops import march
from pointnerf2studio_torch.ops import select as sel

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("R,D,BP,p", [(512, 180, 32, 0.1), (300, 64, 32, 0.5),
                                      (64, 20, 32, 0.9), (36864, 192, 32, 0.05),
                                      (16, 300, 8, 1.0)]
                         + [(301, D, BP, p) for D in (63, 190, 192, 400)
                            for BP, p in ((1, 0.02), (32, 0.2), (80, 0.7))]
                         + [(70, 1032, 1100, 0.5), (70, 1032, 40, 0.1)])
def test_first_valid_cols_kernel_exact(dev, R, D, BP, p):
    """Exact against the plain version: rows on 16-byte boundaries (the
    int4 kernel) and not (D no multiple of 4: the scalar kernel), D below
    one 128-column tile and above four, BP of 1, below and above a tile's
    valid count, and past what the shared-memory rows hold; row 0 all
    valid, row 1 with none."""
    rng = np.random.default_rng(R + D + BP)
    q = np.where(rng.random((R, D)) < p, rng.integers(0, 1 << 20, (R, D)),
                 -1).astype(np.int32)
    q[0], q[1] = 7, -1
    qs = torch.as_tensor(q, device=dev)
    n0 = _cuda.LAUNCHES["first_valid_cols"]
    got = sel.first_valid_cols(qs, BP)
    want = sel.first_valid_cols_reference(qs, BP)
    assert _cuda.LAUNCHES["first_valid_cols"] == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1][0]) == D and int(got[1][1]) == 0
    assert bool((got[0][1] == D).all())


def test_first_valid_cols_kernel_unaligned_rows(dev):
    """qs whose first row does not start on a 16-byte boundary (a
    contiguous tensor at an odd storage offset) takes the scalar kernel."""
    rng = np.random.default_rng(5)
    flat = torch.as_tensor(np.where(
        rng.random(1 + 200 * 192) < 0.1, 3, -1).astype(np.int32), device=dev)
    qs = flat[1:].view(200, 192)
    assert qs.is_contiguous() and qs.data_ptr() % 16 == 4
    got = sel.first_valid_cols(qs, 32)
    want = sel.first_valid_cols_reference(qs, 32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the widths of the generic kernels (csrc/decode_any.cu, csrc/chunk_any.cu,
# fused_candidate_select_any): aggregator widths, K, cand_cap
WIDTH_SETS = {
    "wide": (dict(hidden_size=512, hidden_size_color=256, num_color_layers=4,
                  num_feat_freqs=4, num_dist_freqs=6, num_viewdir_freqs=5),
             16, 128),
    "narrow": (dict(hidden_size=128, hidden_size_color=64,
                    num_color_layers=2, num_feat_freqs=2, num_dist_freqs=4,
                    num_viewdir_freqs=3), 4, 32),
    "edge": (dict(hidden_size=100, hidden_size_color=40, num_color_layers=1,
                  num_feat_freqs=10, num_dist_freqs=10, num_viewdir_freqs=10),
             32, 256),
    "flagship_k12": ({}, 12, 64),
    # csrc/tower_wg.cuh at its narrowest padded width (64) and at 512
    # from a ragged hidden width
    "w64": (dict(hidden_size=48, hidden_size_color=32, num_color_layers=2,
                 num_feat_freqs=3, num_dist_freqs=2, num_viewdir_freqs=2),
            8, 64),
    "ragged512": (dict(hidden_size=300, hidden_size_color=96,
                       num_color_layers=2, num_feat_freqs=1,
                       num_dist_freqs=3, num_viewdir_freqs=4), 12, 128),
    # the colour tower of csrc/tower_wg.cuh at 512 from a ragged width in
    # 8 layers, and at 200 x 3 with 10 viewdir octaves; the first layer's
    # inputs are 360 and 330 (a 16-byte chunk holds K-sums and PE values),
    # past the 320 columns of the tile at 256 (two passes)
    "colour512": (dict(hidden_size=300, hidden_size_color=300,
                       num_color_layers=8, num_feat_freqs=2,
                       num_dist_freqs=3, num_viewdir_freqs=10), 8, 64),
    "colour200": (dict(hidden_size=270, hidden_size_color=200,
                       num_color_layers=3, num_feat_freqs=3,
                       num_dist_freqs=2, num_viewdir_freqs=10), 6, 64),
}


def _chunk_call(dev, cand_cap, K, layered, agg_kw=None):
    """Render a small sphere through the fused-chunk path and return
    (out, args, kwargs) of its `fused_chunk_decode` call."""
    cfg = sphere_config(sr=16, d=48, k=K)
    cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, compute_dtype="bfloat16",
                                     **(agg_kw or {})),
        query=dataclasses.replace(cfg.query, ray_slot_budget=16,
                                  chunk_mode="fused", select_mode="pallas",
                                  compact_budget=8, cand_cap=cand_cap,
                                  layered_search=layered))
    s = make_sphere_scene(4000, cfg=cfg, device=dev)
    rays = camera_rays(s.camrotc2w, 64, 64, 48.0)
    cache, rmin, svs = fr.make_fast_scene(cfg, s.cloud, s.grid)
    assert cache.cand == cand_cap
    captured = {}
    orig = fr.fused_chunk_decode

    def capture(*a, **k):
        captured["args"] = (a, k)
        return orig(*a, **k)

    fr.fused_chunk_decode = capture
    try:
        out = fr.fast_render_rays(s.params, s.cloud.Rw2c, cache, s.campos,
                                  s.camrotc2w, rays, s.near, s.far, cfg,
                                  rmin, svs)
    finally:
        fr.fused_chunk_decode = orig
    return (out,) + captured["args"]


def _chunk_check(a, k, entry="fused_chunk_decode"):
    n0 = _cuda.LAUNCHES[entry]
    sig, rgb, found = fc.fused_chunk_decode(*a, **k)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[entry] == n0 + 1
    sig_p, rgb_p, found_p = fc.fused_chunk_decode_plain(*a, **k)
    mask = a[-1]
    assert torch.equal(found, found_p)
    d_sig = (sig - sig_p).abs()
    assert bool((d_sig <= 2e-2 + 2.0 ** -7 * sig_p.abs()).all())
    if bool(mask.any()):
        assert float((rgb - rgb_p).abs()[mask].max()) <= 2e-2
    assert not sig[~mask].any() and not rgb[~mask].any()
    assert not found[~mask].any()
    return found


@pytest.mark.parametrize("cand_cap,K,layered", [(64, 8, True),
                                                 (32, 4, False)])
def test_fused_chunk_kernel_and_render(dev, cand_cap, K, layered):
    out, a, k = _chunk_call(dev, cand_cap, K, layered)
    assert bool(_chunk_check(a, k).any())
    assert bool(out.ray_mask.any()) and int(out.cb_overflow) == 0


@pytest.mark.parametrize("name", ["wide", "narrow", "edge", "flagship_k12",
                                  "w64", "ragged512", "colour512",
                                  "colour200"])
def test_fused_chunk_any_kernel_and_render(dev, name):
    """csrc/chunk_any.cu at the widths the tuned kernels are not built for
    (K to 32, C to 256, hidden 48-512 - every padded width of the tower,
    64 to 512 - colour 32-256 in 1-4 layers, PE octaves to 10), held to the
    plain version as the tuned kernel is; then its tile edges: a ragged M
    and no valid slot."""
    agg_kw, K, cap = WIDTH_SETS[name]
    out, a, k = _chunk_call(dev, cap, K, True, agg_kw)
    assert bool(_chunk_check(a, k, "fused_chunk_decode_any").any())
    assert bool(out.ray_mask.any()) and int(out.cb_overflow) == 0
    a = list(a)
    for i in range(7, 12):
        a[i] = a[i][:1001].contiguous()
    assert bool(_chunk_check(a, k, "fused_chunk_decode_any").any())
    a[-1] = torch.zeros_like(a[-1])
    assert not _chunk_check(a, k, "fused_chunk_decode_any").any()


@pytest.mark.parametrize("edge", ["ragged", "one_slot", "no_valid_slot",
                                  "all_k_neighbours", "k3"])
def test_fused_chunk_kernel_tile_edges(dev, edge):
    """The edges of the kernel's tiles: M no multiple of the 128-slot
    span, a launch with no valid slot, slots that all bring K rows (eight
    slots fill a 64-row tile exactly), and K < 8."""
    _, a, k = _chunk_call(dev, 64, 3 if edge == "k3" else 8, True)
    a = list(a)
    if edge in ("ragged", "one_slot"):
        n = 1001 if edge == "ragged" else 1
        # one_slot: a single slot that has neighbours
        first = (int(torch.nonzero(fc.fused_chunk_decode_plain(
            *a, **k)[2])[0]) if edge == "one_slot" else 0)
        for i in range(7, 12):          # qslot, locs, center, rd, mask
            a[i] = a[i][first:first + n].contiguous()
    elif edge == "no_valid_slot":
        a[-1] = torch.zeros_like(a[-1])
    elif edge == "all_k_neighbours":
        k = dict(k, radius2=0.0, num_shells=1)
    found = _chunk_check(a, k)
    assert bool(found.any()) == (edge != "no_valid_slot")


@pytest.mark.parametrize("name", ["w64", "ragged512", "edge", "colour512",
                                  "colour200"])
@pytest.mark.parametrize("edge", ["one_slot", "no_valid_slot",
                                  "all_k_neighbours"])
def test_fused_chunk_any_tile_edges(dev, name, edge):
    """The tile edges of csrc/tower_wg.cuh inside fused_chunk_decode_any:
    a launch of one slot that has neighbours, a launch with no valid slot
    (no row at all), and slots that all bring K rows (at K 32 a slot is
    half a tile)."""
    agg_kw, K, cap = WIDTH_SETS[name]
    _, a, k = _chunk_call(dev, cap, K, True, agg_kw)
    a = list(a)
    if edge == "one_slot":
        first = int(torch.nonzero(fc.fused_chunk_decode_plain(*a, **k)[2])[0])
        for i in range(7, 12):          # qslot, locs, center, rd, mask
            a[i] = a[i][first:first + 1].contiguous()
    elif edge == "no_valid_slot":
        a[-1] = torch.zeros_like(a[-1])
    else:
        k = dict(k, radius2=0.0, num_shells=1)
    found = _chunk_check(a, k, "fused_chunk_decode_any")
    assert bool(found.any()) == (edge != "no_valid_slot")


@pytest.mark.parametrize("M,C,K,radius,shells,ties", [
    (5000, 64, 8, 0.03, 3, False), (777, 64, 8, 0.012, 1, True),
    (4096, 32, 4, 0.0, 2, True), (3, 17, 3, 0.03, 3, False),
    (1001, 20, 8, 0.0, 1, True), (37, 63, 5, 0.03, 2, False),
    (16, 8, 8, 0.0, 1, False), (1, 64, 1, 0.03, 3, False),
    (5000, 128, 16, 0.03, 3, False), (777, 256, 32, 0.012, 1, True),
    (1001, 100, 12, 0.0, 2, True), (37, 40, 16, 0.03, 2, False),
    (300, 200, 9, 0.0, 1, False), (16, 8, 20, 0.0, 1, False),
    (1, 256, 1, 0.03, 3, False)])
def test_fused_select_kernel_exact(dev, M, C, K, radius, shells, ties):
    """pnt_mask and every payload bit equal the plain version's, with
    layered shells, the radius test, masked slots, short rows and exact
    distance ties; C a multiple of 8 (16-byte loads of metas and xyz) and
    not, M a multiple of the 16 slots a block serves and not, K < 8; and
    past the tuned entry point (K <= 8, C <= 64) the generic one: 16 lanes
    a slot to C 128 and K 16, a warp beyond, K above C."""
    rng = np.random.default_rng(M + C)
    max_q = 300
    n = (rng.random(max_q) * C * 1.2).astype(np.int64).clip(0, C)
    n[:3] = (0, 1, C)
    valid = np.arange(C)[None, :] < n[:, None]
    shell = np.sort(rng.integers(0, shells, (max_q, C)), axis=-1)
    kmeta = np.where(valid, rng.integers(0, 1 << 20, (max_q, C)) * 4 + shell,
                     -1).astype(np.int32)
    pay = rng.normal(size=(max_q, fs.PK, C)).astype(np.float32) * 0.02
    if ties:
        pay[:, :3, 1::2] = pay[:, :3, 0::2][..., :pay[:, :3, 1::2].shape[-1]]
    kpay = torch.as_tensor(pay, device=dev).to(torch.bfloat16)
    rest = (torch.as_tensor(rng.integers(0, max_q, M).astype(np.int32),
                            device=dev),
            torch.as_tensor((rng.normal(size=(M, 3)) * 0.01).astype(
                np.float32), device=dev),
            torch.as_tensor(rng.random(M) < 0.85 if M > 1 else np.ones(1, bool),
                            device=dev),
            K, radius ** 2, shells)
    if M == 1:
        rest[0][0] = 2            # the full row
    kmeta = torch.as_tensor(kmeta, device=dev)
    entry = ("fused_candidate_select" if fs.tuned(K, C)
             else "fused_candidate_select_any")
    n0 = _cuda.LAUNCHES[entry]
    nsel, pm = fs.fused_candidate_select(
        kmeta, kpay.transpose(1, 2).contiguous(),
        kpay[:, :3, :].contiguous(), *rest)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[entry] == n0 + 1
    nsel_p, pm_p = fs.fused_candidate_select_reference(kmeta, kpay, *rest)
    assert torch.equal(pm, pm_p) and bool(pm.any())
    assert torch.equal(nsel.view(torch.int16), nsel_p.view(torch.int16))


def test_cuda_wrappers_refuse_a_strided_payload(dev):
    """On the card a wrapper launches its kernel or raises: the
    channel-major view of the payload is not what the kernels read."""
    kmeta = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    kpay = torch.zeros((4, fs.PK, 8), dtype=torch.bfloat16, device=dev)
    z = torch.zeros
    with pytest.raises(ValueError, match="kcand must be contiguous"):
        fs.fused_candidate_select(
            kmeta, kpay.transpose(1, 2), kpay[:, :3, :].contiguous(),
            z(2, dtype=torch.int32, device=dev), z((2, 3), device=dev),
            z(2, dtype=torch.bool, device=dev), 8, 0.0, 1)


def _decode_inputs(dev, M, K, seed, fill="mixed", C=32, D=6):
    rng = np.random.default_rng(seed)
    T = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa
    if fill == "mixed":
        pm = rng.random((M, K)) > 0.5
        pm[:7] = False
    else:
        pm = np.full((M, K), fill == "full")
    w = rng.random((M, K)) * pm
    w /= np.maximum(w.sum(-1, keepdims=True), 1e-8)
    return (T(rng.normal(size=(M, K, C)) * 0.1).to(torch.bfloat16),
            T(rng.normal(size=(M, K, D)) * 0.01),
            T(rng.random((M, K, 3))).to(torch.bfloat16),
            T(rng.normal(size=(M, K, 4))), T(w))


@pytest.mark.parametrize("M,K,fill", [
    (3000, 8, "mixed"), (13, 8, "mixed"), (1025, 4, "mixed"),
    (129, 8, "mixed"), (1, 8, "full"), (777, 8, "full"), (300, 8, "empty"),
    (500, 3, "mixed"), (260, 1, "full")])
def test_decode_kernels_match_plain(dev, M, K, fill):
    """aw within 2e-2 + 2^-7 |aw|, hw within 1e-3 + 2^-7 |hw|, for both
    entry points; rows with wk == 0 give exactly 0. Beside the mixed cases: M
    no multiple of the 128-slot span, every slot with all K rows (eight
    slots fill a 64-row tile exactly), no row at all, K < 8."""
    cfg = sphere_config().agg
    agg = make_sphere_scene(500, device=dev).params
    args = _decode_inputs(dev, M, K, M, fill)
    kw = dict(nff=cfg.num_feat_freqs, ndf=cfg.num_dist_freqs)
    for name, kern, plain in (
            ("fused_decode", fd.pair_tower, fd.pair_tower_reference),
            ("fused_decode2", fd.kacc_tower, fd.kacc_tower_reference)):
        n0 = _cuda.LAUNCHES[name]
        aw, hw = kern(agg, *args, **kw)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[name] == n0 + 1
        aw_p, hw_p = plain(agg, *args, **kw)
        assert aw.shape == aw_p.shape and hw.dtype == hw_p.dtype
        if fill != "empty" and M >= 13:
            assert float(aw_p.max()) > 0.5
        assert bool(((aw - aw_p).abs() <= 2e-2 + 2.0 ** -7 * aw_p.abs())
                    .all())
        # hw is small beside 2e-2: held to one bf16 ulp of the plain
        # value over a floor, and its mean |diff| to 2^-8 of mean |hw|
        d, size = (hw.float() - hw_p.float()).abs(), hw_p.float().abs()
        assert bool((d <= 1e-3 + 2.0 ** -7 * size).all())
        assert float(d.mean()) <= 2.0 ** -8 * float(size.mean())
        zero = args[4] == 0
        if name == "fused_decode":
            assert not aw[zero].any() and not hw[zero].any()
        else:
            none = zero.all(-1)
            assert not aw[none].any() and not hw[none].any()


# generic decode widths: the aggregator's overrides (features and
# agg_dist_pers give C and D), K, M
DECODE_ANY = {
    "wide": (dict(WIDTH_SETS["wide"][0]), 16, 3001),
    "narrow": (dict(WIDTH_SETS["narrow"][0], point_features_dim=16,
                    agg_dist_pers=0), 4, 1025),
    "edge": (dict(WIDTH_SETS["edge"][0], point_features_dim=64,
                  agg_dist_pers=30), 32, 300),
    "flagship_k12": ({}, 12, 777),
    # csrc/tower_wg.cuh's narrowest padded width (64), and 512 from a
    # ragged hidden width at 24 features and 4 dists (layer 1 exactly five
    # slabs of 64 inputs)
    "w64": (dict(hidden_size=64, num_feat_freqs=2, num_dist_freqs=3), 8,
            513),
    "ragged512": (dict(hidden_size=300, point_features_dim=24,
                       agg_dist_pers=30, num_feat_freqs=5,
                       num_dist_freqs=7), 6, 1001),
}


@pytest.mark.parametrize("name", sorted(DECODE_ANY))
@pytest.mark.parametrize("fill", ["mixed", "full", "empty"])
def test_decode_any_kernels_match_plain(dev, name, fill):
    """csrc/decode_any.cu (fused_decode_any, fused_decode2_any) at the
    widths csrc/fused_decode.cu is not built for, under the bounds of the
    tuned kernels' test; rows with wk == 0 give exactly 0."""
    kw, K, M = DECODE_ANY[name]
    cfg = AggregatorConfig(compute_dtype="bfloat16", **kw)
    agg = Aggregator(cfg, seed=3, device=dev)
    with torch.no_grad():
        agg.density_head[0].bias += 1.0
    C, D = cfg.shading_feature_dim, cfg.dist_dim
    args = _decode_inputs(dev, M, K, M, fill, C, D)
    k = dict(nff=cfg.num_feat_freqs, ndf=cfg.num_dist_freqs)
    for entry, kern, plain in (
            ("fused_decode_any", fd.pair_tower, fd.pair_tower_reference),
            ("fused_decode2_any", fd.kacc_tower, fd.kacc_tower_reference)):
        n0 = _cuda.LAUNCHES[entry]
        aw, hw = kern(agg, *args, **k)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[entry] == n0 + 1
        aw_p, hw_p = plain(agg, *args, **k)
        assert aw.shape == aw_p.shape and hw.shape == hw_p.shape
        assert hw.dtype == hw_p.dtype
        assert bool(((aw - aw_p).abs() <= 2e-2 + 2.0 ** -7 * aw_p.abs())
                    .all())
        d, size = (hw.float() - hw_p.float()).abs(), hw_p.float().abs()
        assert bool((d <= 1e-3 + 2.0 ** -7 * size).all())
        assert float(d.mean()) <= 2.0 ** -8 * max(float(size.mean()), 1e-30)
        zero = args[4] == 0
        if entry == "fused_decode_any":
            assert not aw[zero].any() and not hw[zero].any()
        else:
            none = zero.all(-1)
            assert not aw[none].any() and not hw[none].any()


def _decode_any_edge(dev, name, M, K, fill, pair):
    """One tile-edge case of csrc/tower_wg.cuh through fused_decode_any
    (`pair`) or fused_decode2_any, under the bounds of
    test_decode_any_kernels_match_plain."""
    entry = "fused_decode_any" if pair else "fused_decode2_any"
    kern, plain = ((fd.pair_tower, fd.pair_tower_reference) if pair
                   else (fd.kacc_tower, fd.kacc_tower_reference))
    kw = DECODE_ANY[name][0]
    cfg = AggregatorConfig(compute_dtype="bfloat16", **kw)
    agg = Aggregator(cfg, seed=5, device=dev)
    with torch.no_grad():
        agg.density_head[0].bias += 1.0
    args = _decode_inputs(dev, M, K, M + K, fill, cfg.shading_feature_dim,
                          cfg.dist_dim)
    k = dict(nff=cfg.num_feat_freqs, ndf=cfg.num_dist_freqs)
    n0 = _cuda.LAUNCHES[entry]
    aw, hw = kern(agg, *args, **k)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[entry] == n0 + 1
    aw_p, hw_p = plain(agg, *args, **k)
    assert aw.shape == aw_p.shape and hw.shape == hw_p.shape
    assert bool(((aw - aw_p).abs() <= 2e-2 + 2.0 ** -7 * aw_p.abs()).all())
    d, size = (hw.float() - hw_p.float()).abs(), hw_p.float().abs()
    assert bool((d <= 1e-3 + 2.0 ** -7 * size).all())
    assert float(d.mean()) <= 2.0 ** -8 * max(float(size.mean()), 1e-30)
    zero = args[4] == 0
    none = zero if pair else zero.all(-1)
    assert not aw[none].any() and not hw[none].any()
    if fill == "empty":
        assert not aw.any() and not hw.any()


@pytest.mark.parametrize("name", ["w64", "ragged512"])
@pytest.mark.parametrize("M,K,fill", [(130, 32, "full"), (1, 16, "full"),
                                      (300, 8, "empty"), (257, 1, "mixed")])
def test_decode2_any_tile_edges(dev, name, M, K, fill):
    """The tile edges of csrc/tower_wg.cuh in fused_decode2_any, under the
    bounds of test_decode_any_kernels_match_plain: slots of 32 rows (two
    a tile), a launch of one slot, a launch with no live slot, and K 1
    (up to 64 slots a tile)."""
    _decode_any_edge(dev, name, M, K, fill, pair=False)


@pytest.mark.parametrize("name", ["w64", "ragged512"])
@pytest.mark.parametrize("M,K,fill", [(130, 32, "full"), (1, 16, "full"),
                                      (300, 8, "empty"), (257, 1, "mixed")])
def test_decode_any_tile_edges(dev, name, M, K, fill):
    """The same tile edges in fused_decode_any (mode kPair): rows with
    wk == 0 and a launch with no live row are written 0. At ragged512 (H
    300) a row of hw is 600 bytes, so the rows' stores are 8 bytes wide;
    every row is compared whole, so a store past column H - 1 into the
    next row would show."""
    _decode_any_edge(dev, name, M, K, fill, pair=True)


@pytest.mark.parametrize("first", [0, 28])
def test_tower_feature_rows_match_plain(dev, first):
    """The layer-1 input the kernel builds, [emb, PE(emb), PE(dists)],
    read back through a tower that only passes it on: layer 1 selects
    features first .. first + 255 of the 284, the other layers are
    identities, every bias is 0, K = 1 with weight 1, so hw is the
    feature, scaled by LeakyReLU's 0.1 where it is negative. The kernel
    takes the embedding's octaves 2x and 4x by double angles, the plain
    version evaluates them: they may differ in a bf16 rounding now and
    then (two ulp after the four layers' roundings, 1e-6 near a zero of
    sin or cos), never in more, and a wrong column, octave or swizzle
    would."""
    import copy
    cfg = sphere_config().agg
    agg = copy.deepcopy(make_sphere_scene(500, device=dev).params)
    eye = torch.eye(256, device=dev)
    with torch.no_grad():
        w1 = agg.mlp_base[0].weight          # [256, 284], reference layout
        w1.zero_()
        w1[torch.arange(256), first + torch.arange(256)] = 1.0
        agg.mlp_base[1].weight.copy_(eye)
        agg.mlp_head[0].weight.zero_()
        agg.mlp_head[0].weight[:, :256] = eye
        agg.mlp_head[1].weight.copy_(eye)
        for lyr in (*agg.mlp_base, *agg.mlp_head):
            lyr.bias.zero_()
    rng = np.random.default_rng(first)
    M = 4099
    T = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa
    args = (T(rng.normal(size=(M, 1, 32)) * 0.7).to(torch.bfloat16),
            T(rng.normal(size=(M, 1, 6)) * 0.08),
            T(rng.random((M, 1, 3))).to(torch.bfloat16),
            T(rng.normal(size=(M, 1, 4))), torch.ones((M, 1), device=dev))
    kw = dict(nff=cfg.num_feat_freqs, ndf=cfg.num_dist_freqs)
    _, hw = fd.pair_tower(agg, *args, **kw)
    _, hw_p = fd.pair_tower_reference(agg, *args, **kw)
    hw, hw_p = hw.float(), hw_p.float()
    # the plain output is the feature: octave 0 of channel 0 where it is
    # selected, and values of both signs up to 1 everywhere
    if first == 0:
        e = args[0][:, 0, 0].float()
        assert torch.equal(hw_p[:, 0, 0], torch.where(
            e > 0, e, hw_p[:, 0, 0]))
    assert float(hw_p.abs().max()) > 0.99
    assert float((hw_p != 0).float().mean()) > 0.99
    d = (hw - hw_p).abs()
    floor = torch.where(hw_p >= 0, 1e-6, 1e-10)   # negatives carry 0.1^4
    assert bool((d <= floor + 2.0 ** -6 * hw_p.abs()).all())
    assert float((d != 0).float().mean()) < 1e-2


@pytest.mark.parametrize("fused2", [True, False])
def test_staged_render_kernels_vs_plain(dev, fused2):
    """The staged fast path on the card through its kernels against the
    same path through their plain versions."""
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, compute_dtype="bfloat16",
                                     fused_decode2=fused2),
        query=dataclasses.replace(cfg.query, ray_slot_budget=16,
                                  knn_mode="fused", select_mode="pallas",
                                  compact_budget=8))
    s = make_sphere_scene(4000, cfg=cfg, device=dev)
    rays = camera_rays(s.camrotc2w, 64, 64, 48.0)
    cache, rmin, svs = fr.make_fast_scene(cfg, s.cloud, s.grid)

    def render():
        return fr.fast_render_rays(s.params, s.cloud.Rw2c, cache, s.campos,
                                   s.camrotc2w, rays, s.near, s.far, cfg,
                                   rmin, svs)

    _cuda.LAUNCHES.clear()
    out = render()
    assert _cuda.LAUNCHES["fused_candidate_select"] == 1
    assert _cuda.LAUNCHES["fused_decode2"] == int(fused2)
    orig = fr.fused_candidate_select, fr.fused_decode2
    fr.fused_candidate_select = fs.fused_candidate_select_plain
    fr.fused_decode2 = fd.fused_decode2_reference
    try:
        ref = render()
    finally:
        fr.fused_candidate_select, fr.fused_decode2 = orig
    assert torch.equal(out.ray_mask, ref.ray_mask) and bool(out.ray_mask.any())
    d = (out.coarse_raycolor - ref.coarse_raycolor).abs()
    assert float(d.max()) <= 2e-2 and float(d.mean()) < 2e-3


# ---- march_rays (csrc/march.cu) against march_rays_reference

def _march_world(dev, seed=0, dims=(40, 36, 44), fill=0.02):
    """A random query-voxel grid with its packed march table, and a camera
    outside it looking at its centre."""
    rng = np.random.default_rng(seed)
    occ = rng.random(dims) < fill
    occ[dims[0] // 2 - 8:dims[0] // 2 + 8, dims[1] // 2 - 8:dims[1] // 2 + 8,
        dims[2] // 2 - 10:dims[2] // 2 + 10] = True      # a solid core
    qs = np.where(occ.reshape(-1), np.cumsum(occ.reshape(-1)) - 1,
                  -1).astype(np.int32).reshape(dims)
    table = march.build_march_table(torch.as_tensor(qs, device=dev))
    svs = torch.tensor([0.05, 0.055, 0.045], device=dev)
    rmin = torch.tensor([-1.0, -0.99, -0.99], device=dev)
    campos = torch.tensor([0.3, -0.2, -3.5], device=dev)
    return dict(table=table.reshape(-1).contiguous(), dims=dims, svs=svs,
                rmin=rmin, campos=campos,
                dims_t=torch.tensor(dims, dtype=torch.int32, device=dev))


def _march_dirs(dev, R, seed, spread=0.25):
    """R unit directions from campos around the one to the grid's centre
    (ray 0): most cross the grid, the widest miss it."""
    rng = np.random.default_rng(seed)
    d = np.concatenate([rng.normal(size=(R, 2)) * spread, np.ones((R, 1))], -1)
    d[0, :2] = 0.0
    d[:, :2] += (-0.3 / 3.5, 0.2 / 3.5)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(d.astype(np.float32), device=dev)


def _march_both(w, rays, D, cap, steps, buckets, **kw):
    near = torch.tensor(1.5, device=rays.device)
    far = torch.tensor(5.5, device=rays.device)
    args = (w["table"], w["dims_t"], w["dims"][1], w["dims"][2], w["rmin"],
            w["svs"], w["campos"], rays, near, far, (far - near) / D, D, cap,
            steps, buckets)
    n0 = _cuda.LAUNCHES["march_rays"]
    got = march.march_rays(*args, count_steps=True, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["march_rays"] == n0 + (len(steps) if len(rays)
                                                 else 0)
    want = march.march_rays_reference(*args, count_steps=True, **kw)
    return got, want


def _march_equal(got, want, cap):
    emit, cnt, of, used = got
    emit_p, cnt_p, of_p, used_p = want
    assert torch.equal(cnt, cnt_p)
    assert torch.equal(emit, emit_p)
    lanes = torch.arange(cap, device=cnt.device)[None] >= cnt[:, None]
    assert bool((emit[lanes] == 0).all())
    assert int(of) == int(of_p)
    assert torch.equal(used, used_p)


@pytest.mark.parametrize("R,D,cap,steps,buckets", [
    (1, 96, 8, (200,), ()),                      # one ray
    (1000, 96, 8, (6, 10, 200), (1000, 900)),    # R no multiple of the block
    (4099, 200, 32, (4, 8, 16, 400), (4099, 4000, 3900)),
    (777, 96, 8, (5, 200), (0,)),                # a bucket of 0 rays
    (513, 64, 1, (64, 200), (513,)),             # cap reached on stage one
    (900, 96, 8, (3, 4), (64,)),                 # fuel and bucket starved
    (640, 512, 16, (1100,), ()),                 # the largest D
])
def test_march_rays_kernel_exact(dev, R, D, cap, steps, buckets):
    """emit, cnt, mc_overflow and the iterations per ray equal the plain
    version's at odd sizes, with buckets and fuel too small too."""
    w = _march_world(dev, seed=R)
    rays = _march_dirs(dev, R, seed=D)
    got, want = _march_both(w, rays, D, cap, steps, buckets)
    _march_equal(got, want, cap)
    starved = (steps, buckets) in (((3, 4), (64,)), ((5, 200), (0,)))
    assert (int(got[2]) > 0) == starved
    assert int(got[1].max()) == cap or starved


def test_march_rays_kernel_all_miss_and_live(dev):
    """Every ray a miss: nothing walks, nothing is emitted. And rows that
    are not live do not walk, take no bucket room and do not count."""
    w = _march_world(dev, seed=3)
    rays = -_march_dirs(dev, 300, seed=4)
    got, want = _march_both(w, rays, 96, 8, (4, 100), (128,))
    _march_equal(got, want, 8)
    assert int(got[1].sum()) == 0 and int(got[2]) == 0
    assert int(got[3].sum()) == 0
    rays = _march_dirs(dev, 700, seed=5)
    rays[600:] = rays[0]
    live = torch.arange(700, device=dev) < 600
    got, want = _march_both(w, rays, 96, 8, (2, 200), (384,), live=live)
    _march_equal(got, want, 8)
    assert int(got[1][600:].sum()) == 0 and int(got[3][600:].sum()) == 0
    assert march.march_rays(
        w["table"], w["dims_t"], w["dims"][1], w["dims"][2], w["rmin"],
        w["svs"], w["campos"], rays[:0], 1.5, 5.5, 4.0 / 96, 96, 8, (4,),
        ())[0].shape == (0, 8)


@pytest.mark.parametrize("jitter", [0.3, 1.0])
def test_march_rays_kernel_jittered(dev, jitter):
    """The train path's branch: sample times read from t_tab, the free
    radius divided by 1 + jitter/2, the walk ended at the true t."""
    w = _march_world(dev, seed=7)
    R, D = 1500, 128
    rays = _march_dirs(dev, R, seed=8)
    u = torch.as_tensor(np.random.default_rng(9).random(
        (R, D), dtype=np.float32), device=dev)
    seg = (4.0 / D) * (1.0 + jitter * (u - 0.5))
    tab = (1.5 + torch.cumsum(seg, -1) - 0.5 * seg).contiguous()
    got, want = _march_both(w, rays, D, 8, (6, 300), (1500,), t_tab=tab,
                            jitter=jitter)
    _march_equal(got, want, 8)
    plain, _ = _march_both(w, rays, D, 8, (6, 300), (1500,))
    assert not torch.equal(plain[0], got[0])


def test_march_render_kernels_vs_plain(dev):
    """A march config on the card: the frame through csrc/march.cu equals,
    bit for bit, the frame through the depth-window front-end, and the
    walk and the fused chunk were launched, first_valid_cols was not."""
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, compute_dtype="bfloat16"),
        query=dataclasses.replace(
            cfg.query, ray_slot_budget=16, chunk_mode="fused",
            select_mode="pallas", compact_budget=16,
            march_steps=(4, 8, 120), march_buckets=(4096, 2048)))
    s = make_sphere_scene(4000, cfg=cfg, device=dev)
    rays = camera_rays(s.camrotc2w, 64, 64, 48.0)
    cache, rmin, svs = fr.make_fast_scene(cfg, s.cloud, s.grid)

    def render(c):
        return fr.fast_render_rays(s.params, s.cloud.Rw2c, cache, s.campos,
                                   s.camrotc2w, rays, s.near, s.far, c, rmin,
                                   svs)

    _cuda.LAUNCHES.clear()
    out = render(cfg)
    assert _cuda.LAUNCHES["march_rays"] == 3
    assert _cuda.LAUNCHES["fused_chunk_decode"] == 1
    assert _cuda.LAUNCHES["first_valid_cols"] == 0
    assert int(out.mc_overflow) == 0 and bool(out.ray_mask.any())
    dense = render(dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, march_steps=(), march_buckets=())))
    for f in ("coarse_raycolor", "ray_mask", "acc", "depth"):
        assert torch.equal(getattr(out, f), getattr(dense, f)), f


# ---- the train step (models/fast_train.py) through the kernels on the card

def _train_world(dev):
    """A small sphere scene on the card, a 48x48 batch of its camera's rays
    with fixed jitter draws, a march plan for them and the geometry cache
    with its march table."""
    from pointnerf2studio_torch.models import fast_train as ft
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, compute_dtype="bfloat16"),
        query=dataclasses.replace(cfg.query, ray_slot_budget=16,
                                  select_mode="pallas", compact_budget=8,
                                  ray_budget=2048))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, fast_path=True, jitter=0.3))
    s = make_sphere_scene(4000, cfg=cfg, device=dev)
    rays = camera_rays(s.camrotc2w, 48, 48, 30.0)
    g = torch.Generator(device=dev).manual_seed(0)
    u = torch.rand((rays.shape[0], 48), generator=g, device=dev)
    gt = torch.rand((rays.shape[0], 3), generator=g, device=dev)
    cfg_m = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, march_steps=(8, 16, 120), march_buckets=(2048, 1024)))
    geo, rmin, svs = ft.make_geo_scene(cfg_m, s.cloud, s.grid)
    return dict(s=s, cfg=cfg, cfg_m=cfg_m, rays=rays, u=u, gt=gt, geo=geo,
                rmin=rmin, svs=svs)


def _train_step(w, cfg, plain=False):
    """One step from a fresh state: (aux, launches, every gradient and
    updated weight)."""
    from pointnerf2studio_torch.models import fast_train as ft
    from pointnerf2studio_torch.train.trainer import create_train_state
    s = w["s"]
    st = create_train_state(s.params, s.cloud, cfg)
    orig = ft.march_rays
    if plain:
        cfg = dataclasses.replace(cfg, query=dataclasses.replace(
            cfg.query, select_mode="topk"))
        ft.march_rays = march.march_rays_reference
    _cuda.LAUNCHES.clear()
    try:
        st, aux = ft.make_fast_train_step(cfg)(
            st, w["geo"], w["rmin"], w["svs"], s.campos, s.camrotc2w,
            w["rays"], w["gt"], torch.tensor(s.near, device=s.campos.device),
            torch.tensor(s.far, device=s.campos.device), jitter_u=w["u"])
    finally:
        ft.march_rays = orig
    torch.cuda.synchronize()
    pts = list(st.points.trainable().values())
    ten = ([p.grad for p in st.params.parameters()] + [p.grad for p in pts]
           + [p.detach() for p in st.params.parameters()] + pts)
    return aux, dict(_cuda.LAUNCHES), ten


def _train_equal(a, b):
    assert float(a[0]["total"]) == float(b[0]["total"])
    for i, (x, y) in enumerate(zip(a[2], b[2])):
        assert torch.equal(x, y), i


def test_train_step_kernels_vs_plain(dev):
    """The train step through first_valid_cols, and through march_rays,
    equals the step through their plain versions bit for bit: loss,
    every gradient and every updated weight; the counters read 0."""
    w = _train_world(dev)
    for cfg, kern, n in ((w["cfg"], "first_valid_cols", 1),
                         (w["cfg_m"], "march_rays", 3)):
        got = _train_step(w, cfg)
        assert got[1].get(kern, 0) == n, got[1]
        want = _train_step(w, cfg, plain=True)
        assert want[1].get(kern, 0) == 0
        _train_equal(got, want)
        assert float(got[0]["rb_overflow"]) == 0
        assert float(got[0].get("mc_overflow", 0)) == 0
        n_params = len(list(w["s"].params.parameters()))
        assert float(got[2][n_params].abs().sum()) > 0  # points_embeding


def test_train_step_deterministic(dev):
    """The same step twice on the card gives the same loss, gradients and
    weights bit for bit (the attribute gather's backward included)."""
    w = _train_world(dev)
    _train_equal(_train_step(w, w["cfg"]), _train_step(w, w["cfg"]))


def test_train_march_equals_dense(dev):
    """The march front-end's step equals the dense front-end's bit for
    bit, as the reference holds its own two front-ends."""
    w = _train_world(dev)
    m = _train_step(w, w["cfg_m"])
    assert m[1].get("first_valid_cols", 0) == 0
    _train_equal(m, _train_step(w, w["cfg"]))


def test_cost_volume_net_same_bits_every_run(dev):
    """CostRegNet and ProbNet give the same bits on every run at the joint
    step's size (128 planes of 100x100, 3 views): `f32_convs` asks cuDNN
    for deterministic algorithms, without which the 3-D convolutions'
    last bits change from run to run and move generated points."""
    from pointnerf2studio_torch.models.mvsnet import costvol as cv
    g = torch.Generator(device=dev).manual_seed(0)
    params = cv.init_costvol_params(torch.Generator().manual_seed(0),
                                    num_views=3, device=dev)
    vol = torch.randn((128, 100, 100, 41), generator=g, device=dev)
    first = None
    with torch.no_grad():
        for _ in range(8):
            prob = cv.prob_net(params.probnet,
                               cv.cost_reg_net8(params.costreg, vol))
            if first is None:
                first = prob.clone()
            assert torch.equal(prob, first)


def test_gather_rows_backward_same_bits_every_run(dev):
    """The attribute gather's backward gives the same bits on every run at
    a train step's size (262,144 rows of 39 channels into 558,000 points):
    its float64 prefix sums are scanned row by row, where one device-wide
    scan of a 1-D tensor groups the sums as its tiles happen to finish."""
    from pointnerf2studio_torch.models.neural_points import gather_rows
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((558_000, 39), generator=g, device=dev,
                        requires_grad=True)
    idx = torch.randint(0, 558_000, (262_144,), generator=g, device=dev)
    up = torch.randn((262_144, 39), generator=g, device=dev)
    first = None
    for _ in range(20):
        table.grad = None
        gather_rows(table, idx).backward(up)
        if first is None:
            first = table.grad.clone()
        assert torch.equal(table.grad, first)


@pytest.mark.parametrize("where", ["inside", "outside"])
def test_frame_plan_on_card_matches_numpy_with_one_sync(dev, where):
    """render_frame's plan on the card, on a seeded 640x480 frame of the
    room preset's box (+-10 m, voxel 0.016, D 400 over [0.1, 8]), from
    inside the box and from outside past one corner: `frame_ray_order`
    equals frame_ray_spans and np.lexsort((span, ~hit)) bit for bit,
    `frame_chunks` the host's slicing, and the plan (slab test, sorts,
    chunk maxima, the frame's buffers) waits for the card once."""
    rng = np.random.default_rng(22 if where == "inside" else 23)
    H, W, f, near, far, D, chunk = 480, 640, 580.0, 0.1, 8.0, 400, 65536
    # the grid's bounds are float32 tensors, as render_frame is given them
    dims = (1250,) * 3
    rmin_h, svs_h = np.full(3, -10, np.float32), np.full(3, 0.016, np.float32)
    j, i = np.mgrid[0:H, 0:W]
    cam = np.stack([(i - W / 2) / f, -(j - H / 2) / f, -np.ones((H, W))],
                   -1).reshape(-1, 3)
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if where == "inside":
        cp = rng.uniform(-3, 3, 3)
    else:
        cp, rot = np.array([9.5, 9.5, 12.0]), np.eye(3)
    rd = cam @ rot.T
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    cp = cp.astype(np.float32)
    span, hit = fr.frame_ray_spans(cp, rd, near, far, D, rmin_h, dims, svs_h)
    want_order = np.lexsort((span, ~hit))

    cp_t, rd_t = torch.as_tensor(cp, device=dev), torch.as_tensor(rd,
                                                                  device=dev)
    rmin, svs = (torch.as_tensor(x, device=dev) for x in (rmin_h, svs_h))
    args = (near, far, D, rmin, dims, svs)
    order, n_hit, tspan = fr.frame_ray_order(cp_t, rd_t, *args)
    np.testing.assert_array_equal(tspan.cpu().numpy(), span)
    np.testing.assert_array_equal(order.cpu().numpy(), want_order)
    assert int(n_hit) == int(hit.sum()) > 0
    if where == "outside":
        assert not hit.all()

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            perm, smax = fr.frame_chunks(
                *fr.frame_ray_order(cp_t, rd_t, *args), chunk)
            fr.frame_buffers(H * W, (1.0, 1.0, 1.0), None, dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]

    n_chunks = -(-int(hit.sum()) // chunk)
    n_used, R = n_chunks * chunk, H * W
    o = want_order
    if n_used > R:
        o = np.concatenate([o, o[R - (n_used - R):]])
    ss = span[o[:n_used]]
    assert smax == [int(ss[k * chunk:(k + 1) * chunk].max())
                    for k in range(n_chunks)]
    np.testing.assert_array_equal(perm.cpu().numpy(), o[:n_used])


def _look_at_origin(pos):
    """c2w [4, 4] (x right, y down, z forward) of a camera at `pos` looking
    at the origin."""
    z = -np.asarray(pos, np.float64) / np.linalg.norm(pos)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
    c2w[:3, 3] = pos
    return c2w


def _costvol_case(dev, case):
    """(imgs, feats, proj, depth planes, vid, pad) on the card. "cell": the
    joint cell's shapes, three views 30 degrees apart on a ring of radius
    4 (the reference view first), 128 planes over [2, 6]. "ragged": odd h
    and w, pad 2, vid 1, sources moved along the reference's axis (their
    epipoles inside the frame) over planes from 0.3 to 3.0, some of them
    behind a source camera."""
    rng = np.random.default_rng(0)
    if case == "cell":
        V, h, w, D, pad, vid = 3, 200, 200, 128, 0, 0
        K = np.array([[1111.1 / 4, 0, 100.0], [0, 1111.1 / 4, 100.0],
                      [0, 0, 1]])
        w2c = [np.linalg.inv(_look_at_origin(
            4.0 * np.array([np.sin(a), 0.0, -np.cos(a)])))
            for a in np.deg2rad([0.0, 30.0, -30.0])]
        dv = np.linspace(2.0, 6.0, D)
    else:
        V, h, w, D, pad, vid = 3, 37, 53, 9, 2, 1
        K = np.array([[40.0, 0, 26.0], [0, 40.0, 18.0], [0, 0, 1]])
        w2c = []
        for i, tz in enumerate([0.8, 0.0, -0.9]):
            a = 0.1 * i
            E = np.eye(4)
            E[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                         [-np.sin(a), 0, np.cos(a)]]
            E[:3, 3] = [0.05 * (i != 1), -0.03 * (i != 1), tz]
            w2c.append(E)
        dv = np.linspace(0.3, 3.0, D)
    P = np.stack([np.vstack([K @ e[:3], [0, 0, 0, 1]]) for e in w2c])
    proj = P @ np.linalg.inv(P[vid])
    imgs = rng.uniform(size=(V, h, w, 3))
    feats = rng.standard_normal((V, h, w, 32))
    return ([torch.tensor(a, dtype=torch.float32, device=dev)
             for a in (imgs, feats, proj, dv)] + [vid, pad])


@pytest.mark.parametrize("case", ["cell", "ragged"])
def test_costvol_kernels_match_the_composite(dev, case):
    """csrc/costvol.cu through `build_cost_volume`: the forward equals the
    torch composite bit for bit; the features' gradient matches autograd
    through the composite within 1e-5 of its largest and is the same bits
    on two runs; one launch of each kernel a forward and backward. At the
    ragged shape both also equal their plain versions on the CPU, bit for
    bit (the same operations in the same order)."""
    from pointnerf2studio_torch.models.mvsnet import costvol as cv
    from pointnerf2studio_torch.ops import costvol as oc
    imgs, feats, proj, dv, vid, pad = _costvol_case(dev, case)
    want_f = feats.clone().requires_grad_()
    want = cv.build_cost_volume_composite(imgs, want_f, proj, dv, vid=vid,
                                          pad=pad)
    g = torch.randn(want.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    want.backward(g)
    want = want.detach()
    n0 = [_cuda.LAUNCHES[k] for k in ("costvol_forward", "costvol_backward")]
    grads = []
    for _ in range(2):
        f = feats.clone().requires_grad_()
        got = cv.build_cost_volume(imgs, f, proj, dv, vid=vid, pad=pad)
        assert torch.equal(got, want)
        got.backward(g)
        grads.append(f.grad)
        del got
    torch.cuda.synchronize()
    assert [_cuda.LAUNCHES[k] - n for k, n in zip(
        ("costvol_forward", "costvol_backward"), n0)] == [2, 2]
    scale = float(want_f.grad.abs().max())
    assert float((grads[0] - want_f.grad).abs().max()) <= 1e-5 * scale
    assert torch.equal(grads[0], grads[1])
    if case == "ragged":
        h, w = feats.shape[1:3]
        grids = [tuple(t.cpu() for t in cv._sweep_grid(
            proj[v], dv, h + 2 * pad, w + 2 * pad, pad, h, w))
            for v in range(3) if v != vid]
        assert torch.equal(oc.cost_volume_plain(
            feats.cpu(), imgs.cpu(), grids, vid, pad), want.cpu())
        assert torch.equal(oc.cost_volume_backward_plain(
            g.cpu(), feats.cpu(), grids, vid, pad), grads[0].cpu())


def test_joint_step_launches_each_costvol_kernel_once(dev):
    """One joint step (the chair preset, three 64x64 views, 8 planes, 256
    rays, the gate open) launches the cost volume's forward and its
    backward once each."""
    from pointnerf2studio_torch.data.presets import get_preset
    from pointnerf2studio_torch.ops.grid import compute_grid_geometry
    from pointnerf2studio_torch.train import joint as tj
    cfg = get_preset("chair")
    V, H, R, f = 3, 64, 256, 1111.1 * 64 / 800
    rng = np.random.default_rng(0)
    c2w = np.stack([_look_at_origin(4.0 * np.array(
        [np.sin(a), 0.0, -np.cos(a)])) for a in np.deg2rad([0, 30, -30])])
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]])
    pix = rng.uniform(0, H, (R, 2))
    d = np.concatenate([(pix - H / 2) / f, np.ones((R, 1))], 1) @ \
        c2w[0, :3, :3].T
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    batch = tj.MVSTrainBatch(
        images=t(rng.uniform(size=(V, H, H, 3))), intrinsics=t([K] * V),
        w2cs=t(np.linalg.inv(c2w)), c2ws=t(c2w), near_far=t([2.0, 6.0]),
        campos=t(c2w[0, :3, 3]), camrotc2w=t(c2w[0, :3, :3]), raydirs=t(d),
        gt_rgb=t(rng.uniform(size=(R, 3))))
    r = cfg.query.ranges
    rmin, dims = compute_grid_geometry(np.asarray(r[:3]), np.asarray(r[3:]),
                                       cfg.query)
    state = tj.create_joint_state(Aggregator(cfg.agg, seed=0, device=dev),
                                  cfg, num_views=V, seed=0, device=dev)
    step = tj.make_joint_train_step(cfg, rmin, dims, num_depth=8,
                                    dprob_thresh=0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    step(state, batch, generator=gen)
    n0 = dict(_cuda.LAUNCHES)
    aux = step(state, batch, generator=gen)
    torch.cuda.synchronize()
    assert np.isfinite(float(aux["total"]))
    for name in ("costvol_forward", "costvol_backward"):
        assert _cuda.LAUNCHES[name] - n0.get(name, 0) == 1
