"""ops/select.py of the port: the plain first_valid_cols (what a CPU
tensor runs) against the reference's Pallas kernel in interpret mode and
its top_k expression, and rank_gather_pack exactly. A CPU tensor never
reaches the CUDA kernel: the launch counter stays 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops import select as tsel
from pointnerf2studio_tpu.ops import select as jsel

torch.set_num_threads(1)


def _qs(R, D, p, seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((R, D)) < p,
                    rng.integers(0, 1 << 20, (R, D)), -1).astype(np.int32)


@pytest.mark.parametrize(
    "R,D,BP,p",
    [(512, 180, 32, 0.1), (300, 64, 32, 0.5), (256, 400, 24, 0.02),
     (128, 100, 32, 0.0), (64, 20, 32, 0.9),
     (256, 192, 32, 0.05)])     # the chair path's depth window
def test_first_valid_cols_matches_jax(R, D, BP, p):
    qs = _qs(R, D, p, R + D)
    _cuda.LAUNCHES.clear()
    cs, cn = tsel.first_valid_cols(torch.as_tensor(qs), BP)
    assert _cuda.LAUNCHES["first_valid_cols"] == 0
    cs, cn = cs.numpy(), cn.numpy()
    ck, cnk = (np.asarray(a) for a in
               jsel.first_valid_cols(jnp.asarray(qs), BP, interpret=True))
    cr, cnr = (np.asarray(a) for a in
               jsel.first_valid_cols_reference(jnp.asarray(qs), BP))
    np.testing.assert_array_equal(cn, cnr)
    np.testing.assert_array_equal(cn, cnk)
    # the plain version reproduces the top_k expression everywhere
    np.testing.assert_array_equal(cs, cr)
    valid = np.arange(BP)[None, :] < np.minimum(cnr, BP)[:, None]
    np.testing.assert_array_equal(cs[valid], ck[valid])
    assert np.all(cs[~valid] >= D)


@pytest.mark.parametrize("mode", ["pallas", "topk"])
def test_select_first_cols(mode):
    qs = _qs(200, 96, 0.2, 3)
    got = tsel.select_first_cols(torch.as_tensor(qs), 16, 12, mode)
    want = jsel.select_first_cols(jnp.asarray(qs), 16, 12, mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("M", [40, 400, 4000])
def test_rank_gather_pack_exact(M):
    qs = _qs(300, 64, 0.08, M)
    col_sel, cnt, _ = jsel.select_first_cols(jnp.asarray(qs), 16, 12)
    want = jsel.rank_gather_pack(jnp.asarray(qs), col_sel, cnt, M)
    got = tsel.rank_gather_pack(
        torch.as_tensor(qs), torch.as_tensor(np.array(col_sel)),
        torch.as_tensor(np.array(cnt)), M)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
