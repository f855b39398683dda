"""The port's user-surface utilities on the CPU: the matmul-FLOP counts
(utils/flops.py) equal to the JAX reference's on three configurations,
the profiling helpers (utils/profiling.py: a Chrome trace with its
span, and the registry beside it as counters.json), the logger's
tensorboard scalars, its fall-back to the JSONL where tensorboard is
missing (utils/logger.py), `fit(tensorboard=True)`, and the nerfstudio shim's
config mapping against the reference's and its refusal without
nerfstudio."""

import dataclasses
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from pointnerf2studio_torch import nerfstudio_shim as tshim
from pointnerf2studio_torch.config import (
    AggregatorConfig, PointNerfConfig, QueryConfig)
from pointnerf2studio_torch.data.blender import BlenderDataset
from pointnerf2studio_torch.data.presets import get_preset
from pointnerf2studio_torch.data.synthetic import (
    make_sphere_scene, sphere_config)
from pointnerf2studio_torch.train import loop as tloop
from pointnerf2studio_torch.utils import flops as tflops
from pointnerf2studio_torch.utils import logger as tlog
from pointnerf2studio_torch.utils import profiling as tprof
from pointnerf2studio_tpu import config as jcfg
from pointnerf2studio_tpu import nerfstudio_shim as jshim
from pointnerf2studio_tpu.data.presets import get_preset as jget_preset
from pointnerf2studio_tpu.utils import flops as jflops

torch.set_num_threads(1)

CONFIGS = {
    "default": (PointNerfConfig(), jcfg.PointNerfConfig()),
    "chair": (get_preset("chair"), jget_preset("chair")),
    "narrow": (
        PointNerfConfig(query=QueryConfig(K=4, fast_chunk=1024),
                        agg=AggregatorConfig(hidden_size=64,
                                             hidden_size_color=32,
                                             num_color_layers=2,
                                             point_features_dim=16)),
        jcfg.PointNerfConfig(query=jcfg.QueryConfig(K=4, fast_chunk=1024),
                             agg=jcfg.AggregatorConfig(
                                 hidden_size=64, hidden_size_color=32,
                                 num_color_layers=2,
                                 point_features_dim=16))),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flops_match_jax(name):
    t, j = CONFIGS[name]
    assert tflops.decode_matmul_flops(t) == jflops.decode_matmul_flops(j)
    assert (tflops.extract_flops_per_slot(t, 64, 48)
            == jflops.extract_flops_per_slot(j, 64, 48))
    for n in (0, 1, 4095, 4096, 100_003):
        assert tflops.executed_slots(n, 4096) == jflops.executed_slots(n,
                                                                     4096)
    # fast_chunk 0 stands for 8192-slot chunks; the reference divides by
    # the 0 (ROADMAP section 3), so it is handed the 8192 it stands for
    if not j.query.fast_chunk:
        with pytest.raises(ZeroDivisionError):
            jflops.analytic_flops_per_ray(j, 10, 10, 64, 48)
        j = dataclasses.replace(j, query=dataclasses.replace(
            j.query, fast_chunk=8192))
    for args in ((200_000, 640_000, 64, 48, 10), (5, 7, 32, 44, 1),
                 (0, 10, 64, 48, 3)):
        assert (tflops.analytic_flops_per_ray(t, *args)
                == jflops.analytic_flops_per_ray(j, *args))


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.span("pn2s_region", "step=3"):
            for _ in range(3):
                x = x @ x.T / 64
        tprof.count("pn2s_events", 2)
    path = tmp_path / tprof.TRACE_FILE
    assert path.is_file()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "pn2s_region" for e in events)
    assert any(e.key == "pn2s_region" for e in prof.key_averages())
    counters = json.loads((tmp_path / tprof.COUNTERS_FILE).read_text())
    assert counters["pn2s_events"] == 2
    assert counters["span.pn2s_region.n"] == 1
    assert counters["span.pn2s_region.ns"] == counters[
        "span.pn2s_region.self_ns"] > 0


def scalars(out_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    files = glob.glob(os.path.join(out_dir, "tensorboard",
                                   "events.out.tfevents.*"))
    assert files
    acc = EventAccumulator(os.path.dirname(files[0]))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_logger_tensorboard_scalars(tmp_path):
    lg = tlog.Logger(str(tmp_path), tensorboard=True)
    for step, loss in ((1, 0.5), (2, 0.25)):
        lg.accumulate({"coarse_raycolor_loss": torch.tensor(loss),
                       "total": torch.tensor(loss)})
        lg.flush(step)
    lg.close()
    sc = scalars(str(tmp_path))
    assert {"total", "coarse_raycolor_loss", "coarse_raycolor_psnr",
            "it_per_sec"} <= set(sc)
    assert sc["total"] == [(1, 0.5), (2, 0.25)]
    assert sc["coarse_raycolor_psnr"][1][1] == pytest.approx(
        tlog.mse2psnr(0.25), rel=1e-6)


def test_logger_without_tensorboard_writes_jsonl(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lg = tlog.Logger(str(tmp_path), tensorboard=True)
    assert "tensorboard unavailable" in capsys.readouterr().out
    lg.accumulate({"total": torch.tensor(0.125)})
    rec = lg.flush(3)
    assert rec["total"] == 0.125
    lines = (tmp_path / "train_metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["total"] == 0.125
    assert not os.path.exists(tmp_path / "tensorboard")


def test_fit_with_tensorboard(tmp_path):
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, rays_per_batch=32))
    s = make_sphere_scene(n_points=2000, cfg=cfg, device="cpu")
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = s.camrotc2w.numpy(), s.campos.numpy()
    ds = BlenderDataset(
        images=np.full((1, 8, 8, 3), 0.5, np.float32), poses=pose[None],
        intrinsics=np.array([[10, 0, 4], [0, 10, 4], [0, 0, 1]], np.float32),
        near=s.near, far=s.far, split="train")
    res = tloop.fit(cfg, ds, s.params, s.cloud, str(tmp_path), max_steps=2,
                    print_freq=1, tensorboard=True, device="cpu")
    sc = scalars(str(tmp_path))
    assert [st for st, _ in sc["total"]] == [1, 2]
    assert [v for _, v in sc["total"]] == pytest.approx(
        [r["total"] for r in res.log], rel=1e-6)


STUDIO_FIELDS = [
    dict(vsize=[0.008, 0.008, 0.008], vscale=[2, 2, 2],
         kernel_size=[5, 5, 5], SR=24, K=8, max_o=610_000, z_depth_dim=400,
         ranges=[-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], num_feat_freqs=3,
         hidden_size=256, point_features_dim=32,
         eval_num_rays_per_chunk=2304, zero_one_loss_weights=1e-4),
    dict(path_point_cloud="a/0_net_ray_marching.pth", num_samples=24,
         query_size=(3, 3, 3), P=16, NN=1, agg_dist_pers=10,
         point_color_mode=False, num_color_layers=2, hidden_size_color=64,
         zero_epsilon=1e-2),
    dict(),
]


@pytest.mark.parametrize("i", range(len(STUDIO_FIELDS)))
def test_studio_config_matches_jax(i):
    got = tshim.studio_to_tpu_config(**STUDIO_FIELDS[i])
    want = jshim.studio_to_tpu_config(**STUDIO_FIELDS[i])
    assert isinstance(got, PointNerfConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got.query.vscale[0]) is type(want.query.vscale[0])


def test_studio_config_rejects_unknown_fields():
    with pytest.raises(TypeError, match="unknown studio config field"):
        tshim.studio_to_tpu_config(not_a_field=3)


def test_method_spec_needs_nerfstudio():
    try:
        import nerfstudio  # noqa: F401
        has_ns = True
    except ImportError:
        has_ns = False
    if has_ns:
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1 item 13"):
            tshim.pointnerf_original
    else:
        with pytest.raises(ImportError, match="studio"):
            tshim.pointnerf_original
    with pytest.raises(AttributeError):
        tshim.not_an_attribute
