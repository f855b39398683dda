"""The port's learned-depth stack (pointnerf2studio_torch/models/mvsnet/
costvol.py) against the JAX package on the CPU: the plane-sweep cost
volume (V = 3 views, pad 0 and 2), the 8-channel U-Net, ProbNet, the
depth probability and the prob_filter statistics, on the JAX package's
random weights carried over by convert.py and the same numpy inputs.
JAX at `jax_default_matmul_precision("highest")`. Bounds: the volume and
the nets within 1e-5 of the output's scale, probabilities within 1e-5;
the prob_filter mask equal wherever prob[bin 2] is not within 1e-6 of
the threshold, the expectation and std within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch import convert
from pointnerf2studio_torch.models.mvsnet import costvol as tc
from pointnerf2studio_tpu.models.mvsnet import costvol as jc

torch.set_num_threads(1)

V, h, w, D = 3, 8, 8, 16


@pytest.fixture(autouse=True)
def highest():
    with jax.default_matmul_precision("highest"):
        yield


def close(got, want, tol):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(V, h, w, 3)).astype(np.float32)
    feats = rng.standard_normal((V, h, w, 32)).astype(np.float32)
    # small rotations and baselines about the ref camera, at feature res
    K = np.array([[6.0, 0, 4.0], [0, 6.0, 4.0], [0, 0, 1]], np.float32)
    proj = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for v in range(V):
        E = np.eye(4, dtype=np.float32)
        a = 0.05 * v
        E[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        E[0, 3] = -0.2 * v
        proj[v, :3, :4] = K @ E[:3, :4]
    proj = (proj @ np.linalg.inv(proj[0])).astype(np.float32)
    dv = np.asarray(jnp.linspace(0.0, 1.0, D) * 2.5 + 1.0, np.float32)
    tree = jc.init_costvol_params(jax.random.PRNGKey(0), num_views=V)
    return {"imgs": imgs, "feats": feats, "proj": proj, "dv": dv,
            "tree": tree, "net": convert.costvol_from_jax(tree, "cpu")}


@pytest.mark.parametrize("pad", [0, 2])
def test_build_cost_volume(inputs, pad):
    a = inputs
    want = jc.build_cost_volume(*(jnp.asarray(a[k]) for k in
                                  ("imgs", "feats", "proj", "dv")), pad=pad)
    got = tc.build_cost_volume(*(torch.tensor(a[k]) for k in
                                 ("imgs", "feats", "proj", "dv")), pad=pad)
    assert got.shape == (D, h + 2 * pad, w + 2 * pad, 3 * V + 32)
    close(got, want, 1e-5)


def test_homo_warp_pad(inputs):
    a = inputs
    f = np.concatenate([a["feats"][1], a["imgs"][1]], -1)
    want = jc.homo_warp_pad(jnp.asarray(f), jnp.asarray(a["proj"][1]),
                            jnp.asarray(a["dv"]), 2)
    got = tc.homo_warp_pad(torch.tensor(f), torch.tensor(a["proj"][1]),
                           torch.tensor(a["dv"]), 2)
    close(got, want, 1e-5)


def test_cost_reg_net8_and_prob_net(inputs):
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((12, 10, 13, 3 * V + 32)).astype(np.float32)
    want8 = jc.cost_reg_net8(inputs["tree"]["costreg"], jnp.asarray(vol))
    got8 = tc.cost_reg_net8(inputs["net"].costreg, torch.tensor(vol))
    assert got8.shape == (12, 10, 13, 8)
    close(got8, want8, 1e-5)
    want = jc.prob_net(inputs["tree"]["probnet"], want8)
    got = tc.prob_net(inputs["net"].probnet, torch.tensor(np.asarray(want8)))
    close(got, want, 1e-5)


def test_depth_probability_and_filter(inputs):
    a = inputs
    args_j = [jnp.asarray(a[k]) for k in ("imgs", "feats", "proj")]
    args_t = [torch.tensor(a[k]) for k in ("imgs", "feats", "proj")]
    want = jc.depth_probability(a["tree"], *args_j, (1.0, 3.5),
                                num_depth=D)
    got = tc.depth_probability(a["net"], *args_t, (1.0, 3.5), num_depth=D)
    assert got.shape == (D, h, w)
    close(got, want, 1e-5)
    np.testing.assert_allclose(got.sum(0).detach().numpy(), 1.0, atol=1e-5)
    # the depth planes are the reference's linspace values
    assert torch.equal(tc.depth_values_linear(1.0, 3.5, D),
                       torch.tensor(np.asarray(
                           1.0 * (1 - jnp.linspace(0.0, 1.0, D))
                           + 3.5 * jnp.linspace(0.0, 1.0, D))))
    p = np.asarray(want)
    # a sharpened copy so that the gate opens on part of the pixels
    sharp = np.asarray(jax.nn.softmax(jnp.log(jnp.asarray(p)) * 40.0, 0))
    for prob, thresh in ((p, 0.0), (p, 0.05), (sharp, 0.8)):
        ej, sj, mj = (np.asarray(x) for x in jc.expected_depth_std(
            jnp.asarray(prob), thresh))
        et, st, mt = (x.numpy() for x in tc.expected_depth_std(
            torch.tensor(prob), thresh))
        np.testing.assert_allclose(et, ej, atol=1e-6)
        np.testing.assert_allclose(st, sj, atol=1e-6)
        edge = np.abs(prob[2] - thresh) < 1e-6
        assert np.array_equal(mt[~edge], mj[~edge])
        # the literal prob_filter: ceil of the NDC expectation is 1, so
        # the gate reads bin 2
        assert np.array_equal(mt, prob[2] > thresh)
    assert 0 < mt.sum() < mt.size


def test_init_costvol_params_matches_the_reference_draws():
    """Xavier-uniform bounds and identity BatchNorm, as the reference's
    init; the layout of the JAX tree."""
    net = tc.init_costvol_params(torch.Generator().manual_seed(0),
                                 num_views=V, device="cpu")
    tree = jc.init_costvol_params(jax.random.PRNGKey(0), num_views=V)
    pairs = list(convert._costreg_pairs(net.costreg, tree["costreg"]))
    pairs += list(convert._convbn_pairs(net.probnet, tree["probnet"]))
    assert len(pairs) == len(jax.tree.leaves(tree))
    for p, leaf, fn in pairs:
        leaf = np.asarray(leaf)
        leaf = fn(leaf) if fn else leaf
        assert tuple(p.shape) == leaf.shape
        bound = float(np.abs(leaf).max())
        assert float(p.detach().abs().max()) <= max(bound * 1.0001, 1.0)


def test_std_gradient_where_the_probability_sits_on_one_bin():
    """A fault of the reference, guarded (ROADMAP §3): the std is the
    sqrt of the variance, whose derivative is infinite at 0, so a pixel
    whose softmax has gone to one bin in float32 gives a NaN gradient,
    which the joint step hands to every weight. The port's std has the
    same value and a zero gradient there."""
    logits = np.zeros((D, 2, 2), np.float32)
    logits[5, 0, 0] = 200.0                       # one bin in float32
    logits[:, 1, 1] = np.linspace(0, 3, D)
    g_j = jax.grad(lambda l: jnp.sum(jc.expected_depth_std(
        jax.nn.softmax(l, 0), 0.0)[1]))(jnp.asarray(logits))
    assert not np.isfinite(np.asarray(g_j)).all()
    lt = torch.tensor(logits, requires_grad=True)
    _, std, _ = tc.expected_depth_std(torch.softmax(lt, 0), 0.0)
    std.sum().backward()
    assert torch.isfinite(lt.grad).all()
    _, std_j, _ = jc.expected_depth_std(jax.nn.softmax(jnp.asarray(logits),
                                                       0), 0.0)
    assert float(std[0, 0].detach()) == float(std_j[0, 0]) == 0.0
    np.testing.assert_allclose(std.detach().numpy(), np.asarray(std_j),
                               atol=1e-6)
    # elsewhere the gradient is the reference's
    np.testing.assert_allclose(lt.grad[:, 1, 1].numpy(),
                               np.asarray(g_j)[:, 1, 1], atol=1e-6)


def _sweep_setup(V, vid, D, geom):
    """9x9 views, so that a normalised coordinate x / 4 - 1 is exact.
    "epipole": each source camera moves along the ref's optical axis
    (forward or back, with a small turn), so its epipole lies inside the
    frame and some planes sit behind it or on its centre. "exact": the
    sources are the ref itself and the ref shifted by 1 / depth pixels
    over depths that are powers of two, so that samples land exactly on
    pixels, on half and quarter pixels and at gx, gy = +-1."""
    hw = 9
    rng = np.random.default_rng(V * 100 + vid * 10 + D)
    imgs = rng.uniform(size=(V, hw, hw, 3)).astype(np.float32)
    feats = rng.standard_normal((V, hw, hw, 32)).astype(np.float32)
    proj = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    srcs = [v for v in range(V) if v != vid]
    if geom == "exact":
        dv = np.array([1.0, 0.5, 2.0, 0.25, 4.0, 0.125, 8.0][:D], np.float32)
        proj[srcs[0], 0, 3] = 1.0
    else:
        dv = np.linspace(0.3, 3.0, D).astype(np.float32)
        K = np.array([[6.0, 0, 4.0], [0, 6.0, 4.0], [0, 0, 1]], np.float32)
        P = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
        for i, v in enumerate(srcs):
            E = np.eye(4, dtype=np.float32)
            a = 0.1 * (i + 1)
            E[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                         [-np.sin(a), 0, np.cos(a)]]
            E[:3, 3] = [0.05, -0.03, 0.8 if i == 0 else -0.9]
            P[v, :3, :4] = K @ E[:3, :4]
        P[vid, :3, :4] = K @ np.eye(4, dtype=np.float32)[:3]
        proj = (P @ np.linalg.inv(P[vid])).astype(np.float32)
    return [torch.tensor(a) for a in (imgs, feats, proj, dv)]


@pytest.mark.parametrize("geom", ["epipole", "exact"])
@pytest.mark.parametrize("D", [1, 7])
@pytest.mark.parametrize("vid", [0, 1])
@pytest.mark.parametrize("V", [2, 3])
@pytest.mark.parametrize("pad", [0, 2])
def test_cost_volume_function_against_the_composite(pad, V, vid, D, geom):
    """`ops/costvol.py::cost_volume` on the CPU (its plain versions):
    the forward equals the torch composite `build_cost_volume_composite`
    bit for bit; the features' gradient matches autograd through the
    composite within 1e-5 of its largest (float32 sums of up to ~4D terms
    in another order); two backward calls give the same bits; the images
    and the projections may not require a gradient."""
    imgs, feats, proj, dv = _sweep_setup(V, vid, D, geom)
    g = torch.randn((D, 9 + 2 * pad, 9 + 2 * pad, 3 * V + 32),
                    generator=torch.Generator().manual_seed(D + pad))
    want_f = feats.clone().requires_grad_()
    want = tc.build_cost_volume_composite(imgs, want_f, proj, dv, vid=vid,
                                          pad=pad)
    want.backward(g)
    grads = []
    for _ in range(2):
        f = feats.clone().requires_grad_()
        got = tc.build_cost_volume(imgs, f, proj, dv, vid=vid, pad=pad)
        assert torch.equal(got, want.detach())
        got.backward(g)
        grads.append(f.grad)
    scale = float(want_f.grad.abs().max())
    assert scale > 0
    assert float((grads[0] - want_f.grad).abs().max()) <= 1e-5 * scale
    assert torch.equal(grads[0], grads[1])
    with pytest.raises(ValueError, match="carry no gradient"):
        tc.build_cost_volume(imgs.clone().requires_grad_(), feats, proj, dv,
                             vid=vid, pad=pad)
    with pytest.raises(ValueError, match="carry no gradient"):
        tc.build_cost_volume(imgs, feats, proj.clone().requires_grad_(), dv,
                             vid=vid, pad=pad)
