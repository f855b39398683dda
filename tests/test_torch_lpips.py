"""The port's LPIPS (pointnerf2studio_torch/utils/lpips.py) against the
JAX package's on the CPU: alex and vgg on 64x64 images with the same
random weights (`init_random_params(seed)` draws the same numpy tree in
both packages), within 1e-5 relative; a combined torch state dict in the
layout the JAX package's EXPORT_SNIPPET writes (torchvision `features.*`
and lpips `lin<l>.model.1.weight`) imported by both; `metrics.lpips` with
and without a weight file. No pretrained weights exist in the repo, so
these are structure and arithmetic checks, not a perceptual metric."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch.utils import lpips as tl
from pointnerf2studio_torch.utils import metrics as tm
from pointnerf2studio_tpu.utils import lpips as jl

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def highest():
    with jax.default_matmul_precision("highest"):
        yield


def images(seed=0, hw=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(hw, hw, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_distance(net):
    a, b = images()
    pt = tl.init_random_params(net, seed=3, device="cpu")
    pj = jl.init_random_params(net, seed=3)
    for ct, cj in zip(pt["convs"], pj["convs"]):
        assert np.array_equal(ct["w"].numpy(),
                              np.transpose(cj["w"], (3, 2, 0, 1)))
    want = float(jl.lpips_distance(pj, jnp.asarray(a), jnp.asarray(b)))
    got = float(tl.lpips_distance(pt, a, b))
    assert want > 0
    assert abs(got - want) <= 1e-5 * abs(want)
    assert float(tl.lpips_distance(pt, a, a)) == 0.0


def combined_state_dict(net, seed):
    """What EXPORT_SNIPPET writes, from a random tree."""
    p = jl.init_random_params(net, seed=seed)
    cfg = jl.CONFIGS[net][0]
    sd, ci = {}, 0
    for i, it in enumerate(cfg):
        if it[0] == "conv":
            c = p["convs"][ci]
            ci += 1
            sd[f"features.{i}.weight"] = torch.tensor(
                np.transpose(c["w"], (3, 2, 0, 1)).copy())
            sd[f"features.{i}.bias"] = torch.tensor(c["b"])
    rng = np.random.default_rng(seed)
    for l, c in enumerate(jl.CONFIGS[net][2]):
        # heads with negative entries: both imports clip them to 0
        sd[f"lin{l}.model.1.weight"] = torch.tensor(
            rng.normal(0, 0.01, (1, c, 1, 1)).astype(np.float32))
    sd["net"] = net
    return sd


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_weight_import_round_trip(net, tmp_path):
    path = str(tmp_path / f"lpips_{net}_combined.pth")
    torch.save(combined_state_dict(net, 5), path)
    pt = tl.load_torch_lpips_weights(path, device="cpu")
    pj = jl.load_torch_lpips_weights(path)
    assert pt["net"] == pj["net"] == net
    for ct, cj in zip(pt["convs"], pj["convs"]):
        assert np.array_equal(ct["w"].numpy(),
                              np.transpose(cj["w"], (3, 2, 0, 1)))
        assert np.array_equal(ct["b"].numpy(), cj["b"])
    for lt, lj in zip(pt["lins"], pj["lins"]):
        assert np.array_equal(lt.numpy(), lj) and (lj >= 0).all()
    a, b = images(1)
    want = float(jl.lpips_distance(pj, jnp.asarray(a), jnp.asarray(b)))
    got = float(tl.lpips_distance(pt, a, b))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_metrics_lpips_with_a_weight_file(tmp_path, monkeypatch):
    from pointnerf2studio_tpu.utils import metrics as jm
    path = str(tmp_path / "lpips_alex_combined.pth")
    torch.save(combined_state_dict("alex", 6), path)
    a, b = images(2)
    want = jm.lpips(a, b, net="alex", weights_path=path)
    got = tm.lpips(a, b, net="alex", weights_path=path, device="cpu")
    assert abs(got - want) <= 1e-5 * abs(want)
    # found through $LPIPS_WEIGHTS_DIR, as the reference finds it
    monkeypatch.setenv("LPIPS_WEIGHTS_DIR", str(tmp_path))
    assert tl.find_weights("alex") == path
    assert tl.find_weights("vgg") is None
    assert tm.lpips(a, b, device="cpu") == got


def test_metrics_lpips_without_weights_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("LPIPS_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="LPIPS"):
        tm.lpips(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)), device="cpu")
    assert set(tm.compute_all(*images(3, 16))) == {"psnr", "ssim", "rmse"}
