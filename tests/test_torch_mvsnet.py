"""The port's MVS building blocks and depth net
(pointnerf2studio_torch/models/mvsnet/{layers,featurenet,mvsnet}.py)
against the JAX package on the CPU.

Weights are random, made from a seed, and written as torch checkpoints in
the reference's layouts (`model_000014.ckpt`: {"model": {"module.<key>":
...}}; `best_net_mvs.pth`: FeatureNet.* and premlp.*); both packages load
the same file with their own `load_*_params`. The JAX side runs at
`jax_default_matmul_precision("highest")`. Bounds: layers within 1e-5
(absolute and relative to the output's scale); the depth net's depth and
probability within 1e-4, its confidence equal where the two truncated
expectation indices agree, and the indices apart on at most 1% of the
pixels (none apart on these inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch import convert
from pointnerf2studio_torch.models.mvsnet import featurenet as tf
from pointnerf2studio_torch.models.mvsnet import layers as tl
from pointnerf2studio_torch.models.mvsnet import mvsnet as tm
from pointnerf2studio_tpu.models.mvsnet import featurenet as jf
from pointnerf2studio_tpu.models.mvsnet import layers as jl
from pointnerf2studio_tpu.models.mvsnet import mvsnet as jm

torch.set_num_threads(1)

H = W = 32
V = 3
D = 16


def close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, (err, scale)
    return err


@pytest.fixture(autouse=True)
def highest():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("mvs")
    return {"mvs": tm.random_mvsnet_checkpoint(str(d / "model.ckpt"), 0),
            "fpn": tf.random_fpn_checkpoint(str(d / "best_net_mvs.pth"), 1)}


@pytest.fixture(scope="module")
def nets(ckpts):
    return {"tm": tm.load_mvsnet_params(ckpts["mvs"], device="cpu"),
            "jm": jm.load_mvsnet_params(ckpts["mvs"]),
            "tf": tf.load_fpn_params(ckpts["fpn"], device="cpu"),
            "jf": jf.load_fpn_params(ckpts["fpn"])}


def bn_tree(rng, c):
    return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.normal(0, 0.1, c).astype(np.float32),
            "mean": rng.normal(0, 0.1, c).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def fill_bn(bn, p):
    convert._fill(convert._bn_pairs(bn, p), "cpu")


@pytest.mark.parametrize("three_d,stride,k", [(False, 1, 3), (False, 2, 5),
                                              (True, 1, 3), (True, 2, 3)])
def test_conv_bn(three_d, stride, k):
    rng = np.random.default_rng(3)
    shape = (5, 9, 11, 6) if three_d else (13, 10, 6)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((k,) * (3 if three_d else 2) + (6, 4)).astype(
        np.float32) * 0.2
    p = {"w": w, "bn": bn_tree(rng, 4)}
    pad = k // 2
    want = jl.conv_bn(jnp.asarray(x)[None], jax.tree.map(jnp.asarray, p),
                      stride, pad, relu=True, three_d=three_d)[0]
    m = tl.ConvBn(6, 4, k, stride, pad, relu=True, three_d=three_d)
    convert._fill(convert._convbn_pairs(m, p), "cpu")
    with torch.no_grad():
        got = tl.from_cf(m(tl.to_cf(torch.tensor(x))))
    close(got, want, 1e-5)


def test_conv3d_transpose_alone():
    """The transposed stage against the reference's input-dilated conv
    with a flipped kernel, and against torch's ConvTranspose3d on the
    torch-layout weight."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 5, 6, 8)).astype(np.float32)
    w_torch = rng.standard_normal((8, 3, 3, 3, 3)).astype(np.float32) * 0.2
    w_jax = np.transpose(w_torch, (2, 3, 4, 1, 0))       # [*S, O, I]
    want = jl.conv3d_transpose(jnp.asarray(x)[None], jnp.asarray(w_jax))[0]
    assert np.array_equal(convert._convt_w(w_jax), w_torch)
    m = tl.ConvTransposeBn(8, 3, relu=False)
    with torch.no_grad():
        m[0].weight.copy_(torch.tensor(w_torch))
        got = tl.from_cf(m(tl.to_cf(torch.tensor(x))))
    assert got.shape == (8, 10, 12, 3)
    close(got, want, 1e-5)


def test_batch_norm_in_stored_statistics():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 6, 4)).astype(np.float32) * 3
    p = bn_tree(rng, 4)
    want = jl.batch_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    bn = tl.BatchNorm(4)
    fill_bn(bn, p)
    bn.train()     # no training mode: the stored statistics still apply
    got = tl.from_cf(bn(tl.to_cf(torch.tensor(x))))
    close(got, want, 1e-5)
    assert {n for n, _ in bn.named_parameters()} == {
        "weight", "bias", "running_mean", "running_var"}
    assert "num_batches_tracked" in bn.state_dict()


@pytest.mark.parametrize("align_corners", [False, True])
def test_bilinear_grid_sample(align_corners):
    rng = np.random.default_rng(6)
    img = rng.standard_normal((7, 9, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(50, 2)).astype(np.float32)
    want = jl.bilinear_grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                   align_corners=align_corners)
    got = tl.bilinear_grid_sample(torch.tensor(img), torch.tensor(grid),
                                  align_corners=align_corners)
    close(got, want, 1e-5)
    # zero padding: torch's own grid_sample gives the same
    ref = torch.nn.functional.grid_sample(
        torch.tensor(img).permute(2, 0, 1)[None],
        torch.tensor(grid)[None, None], mode="bilinear",
        padding_mode="zeros", align_corners=align_corners)[0, :, 0].T
    close(got, ref.numpy(), 1e-5)


def test_the_plane_model_shares_the_sampler():
    from pointnerf2studio_torch.models import bg_plane
    assert bg_plane.bilinear_grid_sample is tl.bilinear_grid_sample


def test_checkpoints_load_strictly(ckpts, nets):
    """The port's modules carry the reference's key names: the checkpoint
    loads with strict=True after `module.` is stripped, and every key of
    the file is a key of the module."""
    sd = torch.load(ckpts["mvs"], weights_only=False)["model"]
    assert all(k.startswith("module.") for k in sd)
    keys = {k[len("module."):] for k in sd}
    assert keys == set(tm.MVSNet().state_dict())
    assert "cost_regularization.conv7.0.weight" in keys
    assert "feature.conv0.bn.running_var" in keys
    fsd = torch.load(ckpts["fpn"], weights_only=False)
    assert set(fsd) == set(tf.FPNParams().state_dict())
    assert {"FeatureNet.conv0.0.conv.weight", "premlp.0.weight",
            "premlp.2.weight"} <= set(fsd)
    # what was written is what was read
    for k, v in nets["tm"].state_dict().items():
        assert torch.equal(v, sd["module." + k]), k


def test_feature_net(nets):
    img = np.random.default_rng(7).uniform(size=(H, W, 3)).astype(
        np.float32)
    want = jm.feature_net(nets["jm"]["feature"], jnp.asarray(img))
    with torch.no_grad():
        got = tm.feature_net(nets["tm"].feature, torch.tensor(img))
    assert got.shape == (8, 8, 32)
    close(got, want, 1e-5)


@pytest.mark.parametrize("shape", [(16, 8, 8), (12, 10, 13)])
def test_cost_reg_net(nets, shape):
    """With and without an edge that is not a multiple of 8 (edge
    padding up, crop back)."""
    vol = np.random.default_rng(8).standard_normal(shape + (32,)).astype(
        np.float32)
    want = jm.cost_reg_net(nets["jm"]["costreg"], jnp.asarray(vol))
    with torch.no_grad():
        got = tm.cost_reg_net(nets["tm"].cost_regularization,
                              torch.tensor(vol))
    assert got.shape == shape
    close(got, want, 1e-5)


def test_homo_warp():
    rng = np.random.default_rng(9)
    feat = rng.standard_normal((16, 16, 4)).astype(np.float32)
    proj = np.eye(4, dtype=np.float32)
    proj[:3, :3] += rng.standard_normal((3, 3)) * 0.01
    proj[:3, 3] = rng.standard_normal(3) * 0.1
    depths = np.linspace(2, 6, 5).astype(np.float32)
    want = jm.homo_warp(jnp.asarray(feat), jnp.asarray(proj),
                        jnp.asarray(depths))
    got = tm.homo_warp(torch.tensor(feat), torch.tensor(proj),
                       torch.tensor(depths))
    close(got, want, 1e-5)


def depth_inputs(seed=10):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(size=(V, H, W, 3)).astype(np.float32)
    projs = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for v in range(1, V):
        projs[v, :3, 3] = rng.standard_normal(3) * 0.05
    depths = np.linspace(2, 6, D).astype(np.float32)
    return imgs, projs, depths


def test_mvsnet_depth(nets):
    imgs, projs, depths = depth_inputs()
    dj, cj, pj = (np.asarray(a) for a in jax.jit(jm.mvsnet_depth)(
        nets["jm"], jnp.asarray(imgs), jnp.asarray(projs),
        jnp.asarray(depths)))
    with torch.no_grad():
        dt, ct, pt = tm.mvsnet_depth(nets["tm"], torch.tensor(imgs),
                                     torch.tensor(projs),
                                     torch.tensor(depths))
    assert dt.shape == ct.shape == (8, 8) and pt.shape == (D, 8, 8)
    close(dt, dj, 1e-4)
    close(pt, pj, 1e-4)
    ar = np.arange(D, dtype=np.float32)[:, None, None]
    di_j = (pj * ar).sum(0).astype(np.int64)
    di_t = (pt.numpy() * ar).sum(0).astype(np.int64)
    same = di_j == di_t
    assert (~same).sum() <= 0.01 * same.size
    np.testing.assert_allclose(ct.numpy()[same], cj[same], atol=1e-5)
    np.testing.assert_allclose(pt.sum(0).numpy(), 1.0, atol=1e-5)


def test_fpn_features_and_premlp(nets):
    rng = np.random.default_rng(11)
    img = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    want = jf.fpn_features(nets["jf"], jnp.asarray(img))
    got = tf.fpn_features(nets["tf"], torch.tensor(img))
    assert [tuple(g.shape) for g in got] == [
        (16, 16, 3), (16, 16, 8), (8, 8, 16), (4, 4, 32)]
    for g, w in zip(got, want):
        close(g, w, 1e-5)
    # batched views give each view's levels
    both = tf.fpn_features(nets["tf"], torch.tensor(np.stack([img, img])))
    for g, b in zip(got, both):
        close(b[1], g.detach().numpy(), 1e-5)
    feats = rng.standard_normal((10, 56)).astype(np.float32)
    colors = rng.uniform(size=(10, 3)).astype(np.float32)
    dirs = rng.standard_normal((10, 3)).astype(np.float32)
    conf = rng.uniform(size=(10, 1)).astype(np.float32)
    want = jf.premlp_embed(nets["jf"], *map(jnp.asarray,
                                            (feats, colors, dirs, conf)))
    got = tf.premlp_embed(nets["tf"], *map(torch.tensor,
                                           (feats, colors, dirs, conf)))
    close(got, want, 1e-5)


def test_init_fpn_params_through_convert():
    """The JAX package's random FPN carried over by convert.py gives the
    reference's features; the port's own init draws the same kind of
    weights (xavier-uniform bounds, BatchNorm at identity)."""
    from pointnerf2studio_torch.models.mvsnet import costvol as tc
    from pointnerf2studio_tpu.models.mvsnet import costvol as jc
    tree = jc.init_fpn_params(jax.random.PRNGKey(0))
    net = convert.fpn_from_jax(tree, device="cpu")
    img = np.random.default_rng(12).uniform(size=(16, 16, 3)).astype(
        np.float32)
    for g, w in zip(tf.fpn_features(net, torch.tensor(img)),
                    jf.fpn_features(tree, jnp.asarray(img))):
        close(g, w, 1e-5)
    own = tc.init_fpn_params(torch.Generator().manual_seed(0), device="cpu")
    for (name, a), b in zip(own.named_parameters(), net.parameters()):
        assert a.shape == b.shape, name
        if name.endswith("conv.weight"):
            lim = float(np.sqrt(6.0 / ((a.shape[0] + a.shape[1])
                                       * a[0, 0].numel())))
            assert float(a.detach().abs().max()) <= lim
            assert float(b.detach().abs().max()) <= lim
        elif name.endswith("running_var") or name.endswith("bn.weight"):
            assert torch.equal(a, torch.ones_like(a))
