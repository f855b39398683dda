"""The port's decode towers on the CPU (their plain versions) vs the JAX
reference's Pallas kernels `fused_decode` / `fused_decode2` in interpret
mode, on the inputs of tests/test_fused_decode.py, with the reference's
weights carried over by convert.py; and the eligibility gate.

Both sides round at the same bf16 points and sum their float32 products
in another order, so sigma and rgb agree to bf16 tolerance: atol 2e-2,
mean < 2e-3 (the bound of the reference's own kernel tests is 3e-2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch import convert
from pointnerf2studio_torch.config import AggregatorConfig as TAggConfig
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops import fused_decode as tfd
from pointnerf2studio_tpu.config import AggregatorConfig
from pointnerf2studio_tpu.models.aggregator import init_aggregator_params
from pointnerf2studio_tpu.ops import fused_decode as jfd
from pointnerf2studio_tpu.ops.encoding import positional_encoding

torch.set_num_threads(1)
ATOL, MEAN_TOL = 2e-2, 2e-3
M, K, C = 70, 8, 32     # M deliberately not a multiple of any tile size


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    cfg = AggregatorConfig(compute_dtype="bfloat16")
    params = jax.tree.map(np.array, init_aggregator_params(
        jax.random.PRNGKey(0), cfg))
    # lift the density head so that alpha is not all zero
    params["density_head"][0]["bias"] = (
        params["density_head"][0]["bias"] + 1.0)
    emb = rng.normal(size=(M, K, C)).astype(np.float32) * 0.1
    color = rng.random((M, K, 3)).astype(np.float32)
    ndir = rng.normal(size=(M, K, 3)).astype(np.float32)
    ndir /= np.linalg.norm(ndir, axis=-1, keepdims=True)
    dists = rng.normal(size=(M, K, 6)).astype(np.float32) * 0.01
    pm = rng.random((M, K)) > 0.3
    pm[:, 0] = True
    pm[5] = False                     # a slot with no neighbour at all
    w = rng.random((M, K)).astype(np.float32) * pm
    w /= np.maximum(w.sum(-1, keepdims=True), 1e-8)
    vd = rng.normal(size=(M, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    dir_enc = np.asarray(positional_encoding(
        jnp.asarray(vd), cfg.num_viewdir_freqs, ori=True))
    ov, dir_pe = dir_enc[..., :3], dir_enc[..., 3:]
    dirdot = np.concatenate(
        [ndir - ov[:, None, :],
         np.sum(ndir * ov[:, None, :], -1, keepdims=True)], -1)
    agg = convert.aggregator_from_jax(
        params, TAggConfig(compute_dtype="bfloat16"), device="cpu")
    return dict(cfg=cfg, params=params, agg=agg,
                args=(emb, dists, color, dirdot, (w * pm), dir_pe))


def _close(got, want):
    d = np.abs(got.numpy() - np.asarray(want, np.float32))
    assert d.max() <= ATOL and d.mean() < MEAN_TOL, (d.max(), d.mean())


@pytest.mark.parametrize("which", ["fused_decode", "fused_decode2"])
@pytest.mark.parametrize("wrapper", [False, True])
def test_plain_version_matches_pallas_interpret(case, which, wrapper):
    """wrapper=True goes through the dispatching function, which on CPU
    tensors must take the plain version and launch nothing."""
    cfg = case["cfg"]
    want_sig, want_rgb = getattr(jfd, which)(
        case["params"], *(jnp.asarray(a) for a in case["args"]), K=K,
        num_feat_freqs=cfg.num_feat_freqs,
        num_dist_freqs=cfg.num_dist_freqs, interpret=True)
    fn = getattr(tfd, which if wrapper else which + "_reference")
    _cuda.LAUNCHES.clear()
    sig, rgb = fn(case["agg"],
                  *(torch.from_numpy(a.copy()) for a in case["args"]),
                  cfg.num_feat_freqs, cfg.num_dist_freqs)
    assert sum(_cuda.LAUNCHES.values()) == 0
    assert sig.shape == (M,) and rgb.shape == (M, 3)
    assert float(sig.max()) > 0.1 and float(sig[5]) == 0.0
    _close(sig, want_sig)
    _close(rgb, want_rgb)


def test_towers_shapes_types_and_zero_rows(case):
    """Kernel-level outputs: the pair tower gives per-row f32 / bf16,
    the K-accumulating tower per-slot f32; a row with wk == 0 adds
    exactly 0; and the two towers agree up to the pair tower's extra
    bf16 roundings."""
    a = [torch.from_numpy(x) for x in case["args"][:5]]
    aw, hw = tfd.pair_tower(case["agg"], *a, nff=3, ndf=5)
    aw2, hw2 = tfd.kacc_tower(case["agg"], *a, nff=3, ndf=5)
    assert aw.shape == (M, K) and aw.dtype == torch.float32
    assert hw.shape == (M, K, 256) and hw.dtype == torch.bfloat16
    assert aw2.shape == (M,) and hw2.shape == (M, 256)
    assert hw2.dtype == torch.float32
    zero = a[4] == 0
    assert bool(zero.any()) and not aw[zero].any() and not hw[zero].any()
    assert float((aw.sum(-1) - aw2).abs().max()) <= ATOL
    assert float((hw.float().sum(1) - hw2).abs().max()) <= ATOL


def _read_slabs(buf, n_slabs, n_out):
    """[n_slabs * 64, n_out] from the packed image as the kernel's wgmma
    reads it: slab s, output row n (128 bytes), input k in the 16-byte
    chunk (k // 8) ^ (n & 7)."""
    k, n = np.arange(64)[:, None], np.arange(n_out)[None, :]
    idx = n * 64 + ((k // 8) ^ (n & 7)) * 8 + k % 8
    size = 64 * n_out
    return np.concatenate([buf[s * size:(s + 1) * size][idx]
                           for s in range(n_slabs)])


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


def test_tower_pack_inverts(case):
    """Reading the packed buffer the way the kernel does gives back every
    layer's [in, out] matrix, zero padding included, and the biases."""
    agg = case["agg"]
    w1, b1, w2, b2, w3, b3, w4, b4, wd, bd = tfd._tower_params(
        agg, 32, 6, 3, 5)
    weights, params = tfd._kernel_params(agg, 3, 5)
    assert weights.dtype == torch.bfloat16 and weights.numel() == 17 * 16384
    slabs = _read_slabs(_bits(weights), 17, 256)
    np.testing.assert_array_equal(slabs[:256], _bits(w1[:256]))
    tail = slabs[256:320]
    np.testing.assert_array_equal(tail[:28], _bits(w1[256:]))
    np.testing.assert_array_equal(tail[32:39], _bits(w3[256:]))
    assert not tail[28:32].any() and not tail[39:].any()
    np.testing.assert_array_equal(slabs[320:576], _bits(w2))
    np.testing.assert_array_equal(slabs[576:832], _bits(w3[:256]))
    np.testing.assert_array_equal(slabs[832:], _bits(w4))
    assert params.dtype == torch.float32 and params.numel() == 1296
    want = torch.cat([b1[0], b2[0], b3[0], b4[0], wd[:, 0].float(), bd[0],
                      torch.zeros(15)])
    assert torch.equal(params, want)


def test_tower_pack_is_made_once(case, monkeypatch):
    agg = case["agg"]
    calls = []
    orig = tfd._pack_decode
    monkeypatch.setattr(tfd, "_pack_decode",
                        lambda *a: calls.append(1) or orig(*a))
    agg.__dict__.pop("_decode_kernel_params", None)
    first = tfd._kernel_params(agg, 3, 5)
    again = tfd._kernel_params(agg, 3, 5)
    assert len(calls) == 1 and again[0] is first[0] and again[1] is first[1]
    with torch.no_grad():
        agg.mlp_head[1].weight[3, 5] += 1.0       # in-place write
    new = tfd._kernel_params(agg, 3, 5)
    assert len(calls) == 2 and not torch.equal(new[0], first[0])
    with torch.no_grad():
        agg.mlp_head[1].weight[3, 5] -= 1.0
    tfd._kernel_params(agg, 3, 5)
    assert len(calls) == 3


def test_w1_permutation_and_pe_blocks_match():
    np.testing.assert_array_equal(tfd._w1_permutation(32, 3, 6, 5),
                                  jfd._w1_permutation(32, 3, 6, 5))
    x = np.random.default_rng(0).normal(size=(9, 6)).astype(np.float32)
    got = tfd._pe_blocks(torch.from_numpy(x), 5).numpy()
    np.testing.assert_allclose(got, np.asarray(jfd._pe_blocks(
        jnp.asarray(x), 5)), atol=1e-5)


GATES = {
    "default": {},
    "bf16": dict(compute_dtype="bfloat16"),
    "base3": dict(num_mlp_base_layers=3),
    "head1": dict(num_mlp_head_layers=1),
    "no_color": dict(point_color_mode=False),
    "no_dir": dict(point_dir_mode=False),
    "sh_intrp": dict(agg_distance_kernel="sh_intrp"),
    "quadric": dict(agg_distance_kernel="quadric"),
    "numlinear": dict(agg_distance_kernel="numlinear"),
    "order1": dict(agg_intrp_order=1),
    "gau_intrp": dict(agg_distance_kernel="gau_intrp"),
}


@pytest.mark.parametrize("name", sorted(GATES))
@pytest.mark.parametrize("per_point", [False, True])
def test_eligibility_gate_matches(name, per_point):
    want = jfd.fused_decode_eligible(
        dataclasses.replace(AggregatorConfig(), **GATES[name]), per_point, 8)
    got = tfd.fused_decode_eligible(
        dataclasses.replace(TAggConfig(), **GATES[name]), per_point, 8)
    assert got == want
    assert got == (name in ("default", "bf16", "quadric", "numlinear")
                   and not per_point)


SERVED = {
    "default": ({}, True),
    "bf16": (dict(compute_dtype="bfloat16"), True),
    "order1": (dict(agg_intrp_order=1), False),
    "no_dir": (dict(point_dir_mode=False), False),
    "quadric": (dict(agg_distance_kernel="quadric"), True),
    "numlinear": (dict(agg_distance_kernel="numlinear"), True),
    "hidden128": (dict(hidden_size=128), None),
    "features16": (dict(point_features_dim=16), None),
    "feat_freqs2": (dict(num_feat_freqs=2), None),
    "dist_freqs4": (dict(num_dist_freqs=4), None),
    "dist_dim3": (dict(agg_dist_pers=0), None),
}


@pytest.mark.parametrize("name", sorted(SERVED))
def test_served_gate(name):
    """An ineligible config is not served (it takes decode_radiance); an
    eligible one outside what csrc/fused_decode.cu is built for raises
    on any device instead of rendering on the CPU only."""
    kw, want = SERVED[name]
    cfg = dataclasses.replace(TAggConfig(), **kw)
    if want is None:
        assert tfd.fused_decode_eligible(cfg, False, 8)
        with pytest.raises(NotImplementedError, match="not ported"):
            tfd.fused_decode_served(cfg, False, 8)
    else:
        assert tfd.fused_decode_served(cfg, False, 8) == want
        assert not tfd.fused_decode_served(cfg, True, 8)


def test_served_gate_reaches_both_paths():
    from pointnerf2studio_torch.config import PointNerfConfig
    from pointnerf2studio_torch.models import fast_render as tfr
    narrow = dataclasses.replace(TAggConfig(), hidden_size=128,
                                 fused_decode2=True)
    with pytest.raises(NotImplementedError, match="hidden_size"):
        tfr._use_fused2(PointNerfConfig(agg=narrow))
    with pytest.raises(NotImplementedError, match="K"):
        tfd.fused_decode_served(TAggConfig(), False, 12)
