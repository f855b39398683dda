"""Package rules of the PyTorch port: no module of
`pointnerf2studio_torch/`, nor `chip_smoke.py`, imports `jax` or the JAX
package (the sources are scanned for import statements), and the entry
points that build state run on the card by default - without a card a
call that does not ask for the CPU raises instead of running there."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from pointnerf2studio_torch import convert, edit
from pointnerf2studio_torch.config import AggregatorConfig
from pointnerf2studio_torch.data import procedural, synthetic
from pointnerf2studio_torch.models import aggregator, neural_points
from pointnerf2studio_torch.models.mvsnet import (
    costvol, featurenet, mvsnet)
from pointnerf2studio_torch.train import joint, loop
from pointnerf2studio_torch.utils import checkpoint_io, lpips, metrics

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted(
    str(p.relative_to(ROOT))
    for p in list((ROOT / "pointnerf2studio_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"])
BANNED = ("jax", "jaxlib", "flax", "optax", "pointnerf2studio_tpu")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_sources_found():
    assert "chip_smoke.py" in SOURCES
    for mod in ("ops/fused_select.py", "ops/fused_decode.py",
                "models/render.py", "ops/raygen.py", "ops/march.py",
                "ops/raster.py", "models/fast_render.py",
                "models/fast_train.py", "train/loop.py", "train/loss.py",
                "train/trainer.py", "data/blender.py", "utils/logger.py",
                "train/grow.py", "train/evaluator.py",
                "utils/checkpoint_io.py", "utils/metrics.py",
                "data/procedural.py", "utils/pfm.py", "utils/profiling.py",
                "utils/flops.py", "edit.py", "cli.py", "nerfstudio_shim.py",
                "models/mvsnet/layers.py", "models/mvsnet/featurenet.py",
                "models/mvsnet/mvsnet.py", "models/mvsnet/costvol.py",
                "models/mvsnet/pointgen.py", "models/mvsnet/__init__.py",
                "data/mvs_batches.py", "train/joint.py", "utils/lpips.py",
                "parallel/__init__.py", "parallel/sharding.py",
                "parallel/grid_shard.py"):
        assert f"pointnerf2studio_torch/{mod}" in SOURCES


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_no_jax(source):
    roots = set(_imported_roots(ROOT / source))
    assert not roots & set(BANNED), (source, roots & set(BANNED))
    text = (ROOT / source).read_text()
    assert "__import__(" not in text and "import_module(" not in text


class _Fields:
    def __getattr__(self, name):
        return np.zeros((2, 3), np.float32)


DEFAULT_DEVICE_CALLS = {
    "make_chair_scene": lambda **kw: synthetic.make_chair_scene(**kw),
    "make_sphere_scene": lambda **kw: synthetic.make_sphere_scene(**kw),
    "aggregator_from_jax": lambda **kw: convert.aggregator_from_jax(
        {}, AggregatorConfig(), **kw),
    "cloud_from_jax": lambda **kw: convert.cloud_from_jax(_Fields(), **kw),
    "grid_from_jax": lambda **kw: convert.grid_from_jax(_Fields(), **kw),
    "fat_cache_from_jax": lambda **kw: convert.fat_cache_from_jax(
        _Fields(), **kw),
    "geo_cache_from_jax": lambda **kw: convert.geo_cache_from_jax(
        _Fields(), **kw),
    "fit": lambda **kw: loop.fit(None, None, None, None, "unused", **kw),
    "train_state_from_jax": lambda **kw: convert.train_state_from_jax(
        None, None, **kw),
    "import_aggregator_params": lambda **kw: (
        checkpoint_io.import_aggregator_params({}, AggregatorConfig(), **kw)),
    "from_arrays": lambda **kw: neural_points.from_arrays(
        *(np.zeros((2, c), np.float32) for c in (3, 32, 1, 3, 3)), **kw),
    "Aggregator": lambda **kw: aggregator.Aggregator(AggregatorConfig(), **kw),
    "render_view": lambda **kw: procedural.render_view(
        np.eye(4, dtype=np.float32), (2, 2), 1.0, **kw),
    "render_depth": lambda **kw: procedural.render_depth(
        np.eye(4, dtype=np.float32), (2, 2), 1.0, **kw),
    "load_and_merge_parts": lambda **kw: edit.load_and_merge_parts([], **kw),
    "load_mvsnet_params": lambda **kw: mvsnet.load_mvsnet_params(
        "unused", **kw),
    "load_fpn_params": lambda **kw: featurenet.load_fpn_params("unused",
                                                               **kw),
    "init_joint_params": lambda **kw: joint.init_joint_params(0, **kw),
    "create_joint_state": lambda **kw: joint.create_joint_state(
        None, None, **kw),
    "init_costvol_params": lambda **kw: costvol.init_costvol_params(
        None, **kw),
    "lpips.init_random_params": lambda **kw: lpips.init_random_params(**kw),
    "lpips.load_torch_lpips_weights": lambda **kw: (
        lpips.load_torch_lpips_weights("unused", **kw)),
    "metrics.lpips": lambda **kw: metrics.lpips(
        None, None, weights_path="unused", **kw),
    "mvs_params_from_jax": lambda **kw: convert.mvs_params_from_jax(
        None, **kw),
    "mvsnet_params_from_jax": lambda **kw: convert.mvsnet_params_from_jax(
        None, **kw),
    "joint_state_from_jax": lambda **kw: convert.joint_state_from_jax(
        None, None, **kw),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CALLS))
def test_default_device_is_the_card(name):
    """With no card, a call without a device raises before it builds
    anything; it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULT_DEVICE_CALLS[name]()


def test_sphere_scene_on_the_cpu_when_asked():
    s = synthetic.make_sphere_scene(500, device="cpu")
    assert s.cloud.xyz.device.type == "cpu"
    assert s.params.mlp_base[0].weight.device.type == "cpu"


@pytest.mark.parametrize("name", ["fused_decode", "fused_chunk"])
def test_library_key_covers_shared_headers(name, tmp_path, monkeypatch):
    """An edit to a header under csrc/ renames the library of every
    source beside it, so a stale build is never loaded."""
    import shutil

    from pointnerf2studio_torch.ops import _cuda
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    assert '#include "tower.cuh"' in (csrc / f"{name}.cu").read_text()
    before = _cuda._lib_path(name, csrc)
    assert before == _cuda._lib_path(name)
    with open(csrc / "tower.cuh", "a") as f:
        f.write("// edited\n")
    after = _cuda._lib_path(name, csrc)
    assert after != before and after.parent == before.parent
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "nvcc")
    assert f"-I{csrc}" in _cuda._command(name, after, csrc)


def test_march_source_is_in_the_library_key(tmp_path, monkeypatch):
    """csrc/march.cu is one of the sources `build()` compiles, without
    FMA contraction and without fast math (the walk's positions must
    round as the render path's torch ops do), and its library is keyed by
    its source and flags."""
    import shutil

    from pointnerf2studio_torch.ops import _cuda
    assert "march" in _cuda.EXTRA_FLAGS
    assert sorted(p.stem for p in _cuda.CSRC.glob("*.cu")) == sorted(
        _cuda.EXTRA_FLAGS)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "nvcc")
    cmd = _cuda._command("march", _cuda._lib_path("march"))
    assert "-fmad=false" in cmd and _cuda.ARCH in cmd
    assert not any("fast" in flag for flag in cmd[:-1])
    assert cmd[-1].endswith("csrc/march.cu")
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    before = _cuda._lib_path("march", csrc)
    assert before == _cuda._lib_path("march")
    with open(csrc / "march.cu", "a") as f:
        f.write("// edited\n")
    assert _cuda._lib_path("march", csrc) != before
    monkeypatch.setitem(_cuda.EXTRA_FLAGS, "march", [])
    assert _cuda._lib_path("march") != before


def test_march_rays_on_the_cpu_launches_nothing():
    """CPU tensors run the plain version: no library is asked for."""
    from pointnerf2studio_torch.ops import _cuda, march
    table = march.build_march_table(torch.full((4, 4, 4), -1).index_put(
        (torch.tensor([2]),) * 3, torch.tensor(0)))
    n0 = sum(_cuda.LAUNCHES.values())
    emit, cnt, of = march.march_rays(
        table.reshape(-1), torch.tensor([4, 4, 4], dtype=torch.int32), 4, 4,
        torch.zeros(3), torch.ones(3), torch.tensor([2.5, 2.5, -2.0]),
        torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]]), 1.0, 7.0,
        6.0 / 24, 24, 4, (40,), ())
    assert sum(_cuda.LAUNCHES.values()) == n0 and int(of) == 0
    assert cnt.tolist() == [4, 0]
    assert ((emit[0] >> 9) == 1).all() and (emit[1] == 0).all()
    assert (emit[0] & 511).tolist() == [12, 13, 14, 15]


def test_library_variant_is_keyed_by_its_flags(monkeypatch):
    """A source built with flags added is a library of its own under the
    same keying, and `library` asks for it only inside the block."""
    from pointnerf2studio_torch.ops import _cuda
    flags = ["-DTOWER_PROBE=2"]
    plain = _cuda._lib_path("fused_decode")
    probe = _cuda._lib_path("fused_decode", extra=flags)
    assert probe != plain and probe.parent == plain.parent
    assert probe != _cuda._lib_path("fused_decode", extra=["-DTOWER_PROBE=4"])
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "nvcc")
    assert flags[0] in _cuda._command("fused_decode", probe, extra=flags)
    asked = []
    monkeypatch.setattr(_cuda, "build", lambda specs: asked.extend(specs) or
                        {s: "/nonexistent/lib.so" for s in specs})
    monkeypatch.setattr(_cuda.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_cuda, "_LIBS", {})
    with _cuda.variant("fused_decode", flags):
        _cuda.library("fused_decode")
        _cuda.library("fused_chunk")
    _cuda.library("fused_decode")
    assert asked == [("fused_decode", ("-DTOWER_PROBE=2",)),
                     ("fused_chunk", ()), ("fused_decode", ())]
