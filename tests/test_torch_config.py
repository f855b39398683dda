"""The port's config tree mirrors the JAX reference's field for field:
same names, same order, same defaults, same derived properties."""

import dataclasses

import pytest
import torch

import pointnerf2studio_torch.config as tcfg
import pointnerf2studio_tpu.config as jcfg

torch.set_num_threads(1)

CLASSES = ["QueryConfig", "AggregatorConfig", "TrainConfig",
           "PointNerfConfig"]


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            d = f.default
        elif f.default_factory is not dataclasses.MISSING:
            d = dataclasses.asdict(f.default_factory())
        else:
            d = dataclasses.MISSING
        out.append((f.name, d))
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_same_fields_and_defaults(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


@pytest.mark.parametrize("name", CLASSES)
def test_frozen(name):
    cfg = getattr(tcfg, name)()
    field = dataclasses.fields(cfg)[0].name
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(cfg, field, None)


def test_derived_properties_match():
    kw = dict(vsize=(0.01, 0.02, 0.03), vscale=(2, 3, 4),
              radius_limit_scale=3.0)
    tq, jq = tcfg.QueryConfig(**kw), jcfg.QueryConfig(**kw)
    assert tq.scaled_vsize == jq.scaled_vsize
    assert tq.radius_limit == jq.radius_limit
    for pers in (5, 20, 30):
        for kern in ("linear", "sh_intrp", "gau_intrp", "feat_intrp"):
            ta = tcfg.AggregatorConfig(agg_dist_pers=pers,
                                       agg_distance_kernel=kern)
            ja = jcfg.AggregatorConfig(agg_dist_pers=pers,
                                       agg_distance_kernel=kern)
            assert ta.dist_dim == ja.dist_dim
            assert ta.shading_feature_dim == ja.shading_feature_dim
