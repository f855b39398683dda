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
