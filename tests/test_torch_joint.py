"""The port's joint MVS + render training (pointnerf2studio_torch/train/
joint.py) against the JAX package's on the CPU, at the sizes of
tests/test_joint_mvs.py (32x32 images, 3 views, 16 depth bins, its tiny
config and batch; the fields' density head biased alive as there), on
the JAX package's weights carried over by convert.py and with JAX's
noise draws fed to the port (the depth draw `noise`; the tiny config has
no jitter).

The outermost ring of generated points lies on the image edge: they are
placed at pixel 0 or W - 1 and projected back through K^-1 and K, so
their in-bounds test `xy <= W - 1` is decided by rounding (a reference
fault, ROADMAP §3), and XLA and torch round those products differently.
`test_generate_points_diff` counts the ring's flips and holds the rest;
the loss, gradient and step tests drop the ring in both packages (the
same wrapper around each package's `generate_points_diff`) so that both
render one cloud. Bounds: positions within 1e-5, embeddings and colours
within 1e-4 of the scale, the loss within 1e-4, every group's gradient
(fpn, premlp, costreg, probnet, fields) within 1e-3 of its norm, and over
3 steps the losses within 1e-3 with every group moving. JAX at
`jax_default_matmul_precision("highest")`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch import convert
from pointnerf2studio_torch import config as tconfig
from pointnerf2studio_torch.train import joint as tj
from pointnerf2studio_tpu.ops.grid import compute_grid_geometry
from pointnerf2studio_tpu.train import joint as jj
from pinned_weights import pinned_reference_weights  # noqa: F401
from test_joint_mvs import V, live_fields, make_batch, tiny_cfg

torch.set_num_threads(1)

D = 16
h = w = 8


@pytest.fixture(autouse=True)
def highest():
    with jax.default_matmul_precision("highest"):
        yield


def port_cfg(c):
    def conv(obj, cls):
        return cls(**{f.name: getattr(obj, f.name)
                      for f in dataclasses.fields(obj)})
    rest = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
            if f.name not in ("query", "agg", "train")}
    return tconfig.PointNerfConfig(
        query=conv(c.query, tconfig.QueryConfig),
        agg=conv(c.agg, tconfig.AggregatorConfig),
        train=conv(c.train, tconfig.TrainConfig), **rest)


def ring_mask():
    m = np.zeros((h, w), bool)
    m[0], m[-1], m[:, 0], m[:, -1] = True, True, True, True
    return m.reshape(-1)


def off_ring(fn, as_array):
    def wrapped(*a, **k):
        g = fn(*a, **k)
        return {**g, "valid": g["valid"] & as_array(~ring_mask())}
    return wrapped


@pytest.fixture(scope="module")
def env():
    jcfg = tiny_cfg()
    batch = make_batch(jax.random.PRNGKey(0))
    mvs_j = jj.init_joint_params(jax.random.PRNGKey(1), num_views=V)
    fields_j = live_fields(jcfg)
    rmin, dims = compute_grid_geometry(
        np.array([-2.0, -2.0, 0.0]), np.array([2.0, 2.0, 4.0]), jcfg.query)
    tcfg = port_cfg(jcfg)
    return {"jcfg": jcfg, "tcfg": tcfg, "batch": batch,
            "tbatch": tj.MVSTrainBatch(*(torch.tensor(np.asarray(a))
                                         for a in batch)),
            "mvs_j": mvs_j, "fields_j": fields_j, "rmin": rmin,
            "dims": dims,
            "mvs_t": convert.mvs_params_from_jax(mvs_j, device="cpu"),
            "fields_t": convert.aggregator_from_jax(fields_j, tcfg.agg,
                                                    device="cpu")}


@pytest.fixture(scope="module")
def no_ring():
    mp = pytest.MonkeyPatch()
    mp.setattr(jj, "generate_points_diff",
               off_ring(jj.generate_points_diff, jnp.asarray))
    mp.setattr(tj, "generate_points_diff",
               off_ring(tj.generate_points_diff, torch.tensor))
    yield
    mp.undo()


def close(got, want, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, (name, err, scale)


def test_generate_points_diff(env):
    b, tb = env["batch"], env["tbatch"]
    kgen = jax.random.PRNGKey(7)
    noise = jax.random.normal(kgen, (h, w))
    gj = jax.jit(jj.generate_points_diff, static_argnames=(
        "num_depth", "dprob_thresh"))(
        env["mvs_j"], b.images, b.intrinsics, b.w2cs, b.c2ws, b.near_far,
        key=kgen, num_depth=D, dprob_thresh=0.0)
    with torch.no_grad():
        gt = tj.generate_points_diff(
            env["mvs_t"], tb.images, tb.intrinsics, tb.w2cs, tb.c2ws,
            tb.near_far, noise=torch.tensor(np.asarray(noise)),
            num_depth=D, dprob_thresh=0.0)
    ring = ring_mask()
    vj, vt = np.asarray(gj["valid"]), gt["valid"].numpy()
    assert np.array_equal(vj[~ring], vt[~ring])
    assert vt[~ring].sum() > 0 and (vj != vt).sum() <= ring.sum()
    close(gt["xyz"], gj["xyz"], 1e-5, "xyz")
    close(gt["dir"], gj["dir"], 1e-5, "dir")
    close(gt["conf"], gj["conf"], 0.0, "conf")
    for k in ("embedding", "color"):
        close(gt[k][~ring], np.asarray(gj[k])[~ring], 1e-4, k)
    # with no draw the expectation is sampled
    with torch.no_grad():
        g0 = tj.generate_points_diff(
            env["mvs_t"], tb.images, tb.intrinsics, tb.w2cs, tb.c2ws,
            tb.near_far, num_depth=D, dprob_thresh=0.0)
    assert not torch.equal(g0["xyz"], gt["xyz"])


def group_grads(mvs_t, g_mvs_j):
    """{group: [(port grad, JAX grad in the port's layout)]}."""
    out = {"fpn": [], "premlp": [], "costreg": [], "probnet": []}
    names = {id(p): n for n, p in mvs_t.named_parameters()}
    for p, leaf, fn in convert._mvs_pairs(mvs_t, g_mvs_j):
        a = np.asarray(leaf, np.float32)
        a = fn(a) if fn else a
        n = names[id(p)]
        grp = ("fpn" if n.startswith("FeatureNet") else "premlp"
               if n.startswith("premlp") else "costreg"
               if n.startswith("costvol.costreg") else "probnet")
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(a)
        out[grp].append((g, a))
    return out


def rel_err(pairs):
    num = sum(float(((g - a).astype(np.float64) ** 2).sum())
              for g, a in pairs)
    den = sum(float((a.astype(np.float64) ** 2).sum()) for g, a in pairs)
    return np.sqrt(num) / max(np.sqrt(den), 1e-30), np.sqrt(den)


def test_loss_and_gradients(env, no_ring):
    """jax.value_and_grad of the reference's loss against the port's
    backward, the gate open (dprob_thresh 0.0)."""
    b, tb = env["batch"], env["tbatch"]
    kgen, krender = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    lf_j = jj.make_joint_loss_fn(env["jcfg"], env["rmin"], env["dims"],
                                 num_depth=D, dprob_thresh=0.0)
    (tot_j, _), (gm_j, gf_j) = jax.jit(jax.value_and_grad(
        lambda m, f: lf_j(m, f, b, kgen, krender), argnums=(0, 1),
        has_aux=True))(env["mvs_j"], env["fields_j"])
    mvs_t = convert.mvs_params_from_jax(env["mvs_j"], device="cpu")
    fields_t = convert.aggregator_from_jax(env["fields_j"],
                                           env["tcfg"].agg, device="cpu")
    mvs_t.requires_grad_(True)
    fields_t.requires_grad_(True)
    lf_t = tj.make_joint_loss_fn(env["tcfg"], env["rmin"], env["dims"],
                                 num_depth=D, dprob_thresh=0.0)
    tot_t, aux = lf_t(mvs_t, fields_t, tb,
                      noise=torch.tensor(np.asarray(
                          jax.random.normal(kgen, (h, w)))))
    tot_t.backward()
    assert int(aux["n_valid"]) > 0
    assert abs(float(tot_t.detach()) - float(tot_j)) <= 1e-4
    for grp, pairs in group_grads(mvs_t, gm_j).items():
        err, norm = rel_err(pairs)
        assert norm > 0, grp
        assert err <= 1e-3, (grp, err)
    f_pairs = []
    gf_t = convert.aggregator_to_jax(fields_t, grad=True)
    for name in gf_t:
        for lt, lj in zip(gf_t[name], gf_j[name]):
            f_pairs += [(lt["kernel"], np.asarray(lj["kernel"])),
                        (lt["bias"], np.asarray(lj["bias"]))]
    err, norm = rel_err(f_pairs)
    assert norm > 0 and err <= 1e-3, ("fields", err)


@pytest.fixture(scope="module")
def jax_steps(env, no_ring):
    """The reference's jitted joint step, 3 steps from the converted
    weights' source state; the states after each step and the losses."""
    jstate = jj.create_joint_state(jax.random.PRNGKey(3), env["fields_j"],
                                   env["jcfg"], num_views=V,
                                   mvs=env["mvs_j"])
    jstep = jj.make_joint_train_step(env["jcfg"], env["rmin"], env["dims"],
                                     num_depth=D, dprob_thresh=0.0)
    states, losses = [], []
    for i in range(3):
        jstate, aux = jstep(jstate, env["batch"], jax.random.PRNGKey(10 + i))
        states.append(jstate)
        losses.append(float(aux["total"]))
    return states, losses


def test_three_train_steps(env, no_ring, jax_steps):
    """make_joint_train_step against the reference's: 3 steps from the
    same state and draws; losses within 1e-3, every group moves in both,
    and the port's weights after the steps within 1e-3 of the
    reference's."""
    tb = env["tbatch"]
    states, losses = jax_steps
    tstate = tj.create_joint_state(env["fields_t"], env["tcfg"],
                                   num_views=V, mvs=env["mvs_t"])
    tstep = tj.make_joint_train_step(env["tcfg"], env["rmin"], env["dims"],
                                     num_depth=D, dprob_thresh=0.0)
    before = {n: p.detach().clone() for n, p in
              tstate.mvs.named_parameters()}
    f_before = [p.detach().clone() for p in tstate.fields.parameters()]
    for i in range(3):
        kgen, _ = jax.random.split(jax.random.PRNGKey(10 + i))
        aux_t = tstep(tstate, tb, noise=torch.tensor(np.asarray(
            jax.random.normal(kgen, (h, w)))))
        assert abs(float(aux_t["total"]) - losses[i]) <= 1e-3
    assert tstate.step == 3
    for grp in ("FeatureNet", "premlp", "costvol.costreg",
                "costvol.probnet"):
        moved = max(float((p.detach() - before[n]).abs().max())
                    for n, p in tstate.mvs.named_parameters()
                    if n.startswith(grp))
        assert moved > 0, grp
    assert max(float((p.detach() - q).abs().max()) for p, q in
               zip(tstate.fields.parameters(), f_before)) > 0
    jstate = states[-1]
    p0 = env["mvs_j"]
    assert float(jnp.abs(jstate.mvs.costvol["probnet"]["w"]
                         - p0.costvol["probnet"]["w"]).max()) > 0
    # the reference's Adam moves the stored BatchNorm statistics too
    assert float(jnp.abs(jstate.mvs.fpn["conv0"][0]["bn"]["var"]
                         - p0.fpn["conv0"][0]["bn"]["var"]).max()) > 0
    got = convert.mvs_params_from_jax(jstate.mvs, device="cpu")
    for (n, p), q in zip(tstate.mvs.named_parameters(), got.parameters()):
        close(p, q.detach().numpy(), 1e-3, n)


def test_joint_state_from_jax(env, jax_steps):
    """The reference's state after one step, carried over with its Adam
    moments, counts and schedule."""
    jstate = jax_steps[0][0]
    port = convert.joint_state_from_jax(jstate, env["tcfg"], device="cpu")
    assert port.step == 1
    adam = jstate.opt_state_mvs[0]
    for p, mu, fn in convert._mvs_pairs(port.mvs, adam.mu):
        mu = np.asarray(mu)
        st = port.opt_mvs.state[p]
        assert float(st["step"]) == 1.0
        assert np.array_equal(st["exp_avg"].numpy(), fn(mu) if fn else mu)
    ref = convert.mvs_params_from_jax(jstate.mvs, device="cpu")
    for p, q in zip(port.mvs.parameters(), ref.parameters()):
        assert torch.equal(p.detach(), q.detach())
    t = env["tcfg"].train
    assert port.opt_fields.param_groups[0]["lr"] == pytest.approx(
        t.lr_fields * t.lr_decay_exp ** (1 / t.lr_decay_iters))
    assert len(port.opt_fields.state) == len(list(port.fields.parameters()))


def test_init_and_pretrained_joint_params(tmp_path):
    from pointnerf2studio_torch.models.mvsnet.featurenet import (
        random_fpn_checkpoint)
    a = tj.init_joint_params(0, num_views=V, device="cpu")
    b = tj.init_joint_params(0, num_views=V, device="cpu")
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    assert a.fpn is a.FeatureNet and len(a.premlp) == 1
    path = random_fpn_checkpoint(str(tmp_path / "best_net_mvs.pth"), 2)
    p = tj.load_pretrained_joint_params(0, path, num_views=V, device="cpu")
    sd = torch.load(path, weights_only=False)
    assert torch.equal(p.FeatureNet.conv0[0].conv.weight.detach(),
                       sd["FeatureNet.conv0.0.conv.weight"])
    assert torch.equal(p.premlp[2].weight.detach(), sd["premlp.2.weight"])
    for q, r in zip(p.costvol.parameters(), a.costvol.parameters()):
        assert torch.equal(q, r)     # the learned-depth stack starts fresh
