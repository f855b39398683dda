"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: every test skips where torch.cuda is unavailable (the
decision is made inside the fixture, never at import). On a machine with
an NVIDIA GPU and nvcc, run them without the JAX test set-up:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from pointnerf2studio_torch.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_torch.models import fast_render as fr
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops import fused_chunk as fc
from pointnerf2studio_torch.ops import fused_decode as fd
from pointnerf2studio_torch.ops import fused_select as fs
from pointnerf2studio_torch.ops import select as sel

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("R,D,BP,p", [(512, 180, 32, 0.1), (300, 64, 32, 0.5),
                                      (64, 20, 32, 0.9), (36864, 192, 32, 0.05),
                                      (16, 300, 8, 1.0)])
def test_first_valid_cols_kernel_exact(dev, R, D, BP, p):
    rng = np.random.default_rng(R + D)
    qs = torch.as_tensor(np.where(rng.random((R, D)) < p,
                                  rng.integers(0, 1 << 20, (R, D)),
                                  -1).astype(np.int32), device=dev)
    n0 = _cuda.LAUNCHES["first_valid_cols"]
    got = sel.first_valid_cols(qs, BP)
    want = sel.first_valid_cols_reference(qs, BP)
    assert _cuda.LAUNCHES["first_valid_cols"] == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("cand_cap,K,layered", [(64, 8, True),
                                                 (32, 4, False)])
def test_fused_chunk_kernel_and_render(dev, cand_cap, K, layered):
    cfg = sphere_config(sr=16, d=48, k=K)
    cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, compute_dtype="bfloat16"),
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
    a, k = captured["args"]
    sig, rgb, found = fc.fused_chunk_decode(*a, **k)
    sig_p, rgb_p, found_p = fc.fused_chunk_decode_reference(*a, **k)
    mask = a[-1]
    assert torch.equal(found, found_p) and bool(found.any())
    d_sig = (sig - sig_p).abs()
    assert bool((d_sig <= 2e-2 + 2.0 ** -7 * sig_p.abs()).all())
    assert float((rgb - rgb_p).abs()[mask].max()) <= 2e-2
    assert bool(out.ray_mask.any()) and int(out.cb_overflow) == 0


@pytest.mark.parametrize("M,C,K,radius,shells,ties", [
    (5000, 64, 8, 0.03, 3, False), (777, 64, 8, 0.012, 1, True),
    (4096, 32, 4, 0.0, 2, True), (3, 17, 3, 0.03, 3, False)])
def test_fused_select_kernel_exact(dev, M, C, K, radius, shells, ties):
    """pnt_mask and every payload bit equal the plain version's, with
    layered shells, the radius test, masked slots, short rows and exact
    distance ties."""
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
    args = (torch.as_tensor(kmeta, device=dev),
            torch.as_tensor(pay, device=dev).to(torch.bfloat16),
            torch.as_tensor(rng.integers(0, max_q, M).astype(np.int32),
                            device=dev),
            torch.as_tensor((rng.normal(size=(M, 3)) * 0.01).astype(
                np.float32), device=dev),
            torch.as_tensor(rng.random(M) < 0.85, device=dev),
            K, radius ** 2, shells)
    n0 = _cuda.LAUNCHES["fused_candidate_select"]
    nsel, pm = fs.fused_candidate_select(*args)
    assert _cuda.LAUNCHES["fused_candidate_select"] == n0 + 1
    nsel_p, pm_p = fs.fused_candidate_select_reference(*args)
    assert torch.equal(pm, pm_p) and bool(pm.any())
    assert torch.equal(nsel.view(torch.int16), nsel_p.view(torch.int16))


def _decode_inputs(dev, M, K, seed):
    rng = np.random.default_rng(seed)
    T = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa
    pm = rng.random((M, K)) > 0.5
    pm[:7] = False
    w = rng.random((M, K)) * pm
    w /= np.maximum(w.sum(-1, keepdims=True), 1e-8)
    return (T(rng.normal(size=(M, K, 32)) * 0.1).to(torch.bfloat16),
            T(rng.normal(size=(M, K, 6)) * 0.01),
            T(rng.random((M, K, 3))).to(torch.bfloat16),
            T(rng.normal(size=(M, K, 4))), T(w))


@pytest.mark.parametrize("M,K", [(3000, 8), (13, 8), (1025, 4)])
def test_decode_kernels_match_plain(dev, M, K):
    """aw within 2e-2 + 2^-7 |aw|, hw within 2e-2, for both entry
    points; rows with wk == 0 give exactly 0."""
    cfg = sphere_config().agg
    agg = make_sphere_scene(500, device=dev).params
    args = _decode_inputs(dev, M, K, M)
    kw = dict(nff=cfg.num_feat_freqs, ndf=cfg.num_dist_freqs)
    for name, kern, plain in (
            ("fused_decode", fd.pair_tower, fd.pair_tower_reference),
            ("fused_decode2", fd.kacc_tower, fd.kacc_tower_reference)):
        n0 = _cuda.LAUNCHES[name]
        aw, hw = kern(agg, *args, **kw)
        assert _cuda.LAUNCHES[name] == n0 + 1
        aw_p, hw_p = plain(agg, *args, **kw)
        assert aw.shape == aw_p.shape and hw.dtype == hw_p.dtype
        assert float(aw_p.max()) > 0.5
        assert bool(((aw - aw_p).abs() <= 2e-2 + 2.0 ** -7 * aw_p.abs())
                    .all())
        d = (hw.float() - hw_p.float()).abs()
        assert float(d.max()) <= 2e-2 and float(d.mean()) < 2e-3
        zero = args[4] == 0
        if name == "fused_decode":
            assert not aw[zero].any() and not hw[zero].any()
        else:
            assert not aw[:7].any() and not hw[:7].any()


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
    fr.fused_candidate_select = fs.fused_candidate_select_reference
    fr.fused_decode2 = fd.fused_decode2_reference
    try:
        ref = render()
    finally:
        fr.fused_candidate_select, fr.fused_decode2 = orig
    assert torch.equal(out.ray_mask, ref.ray_mask) and bool(out.ray_mask.any())
    d = (out.coarse_raycolor - ref.coarse_raycolor).abs()
    assert float(d.max()) <= 2e-2 and float(d.mean()) < 2e-3
