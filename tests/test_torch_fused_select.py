"""The port's candidate selection on the CPU (its plain version) vs the
JAX reference: the Pallas kernel `fused_candidate_select` in interpret
mode, and the XLA candidate stages (d2, masks, layered shells,
`lax.top_k`, gather) run un-jitted.

Selection is float32 with the reference's op order and the payload is
bf16 bits passed through, so everything is held exactly: pnt_mask, the
chosen columns (read back from a payload channel that carries the column
id) and every payload bit. The synthetic caches cover layered shells,
the radius test, masked slots, empty rows, rows with fewer than K
candidates, and exact distance ties (duplicated candidates), which the
smallest-column rule must break."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops import fused_select as tfs
from pointnerf2studio_tpu.ops import fused_select as jfs

torch.set_num_threads(1)
PK = 48
COLCH = 47      # a padding channel of the payload; here it holds the column


def _bf16_bits(a32: np.ndarray) -> np.ndarray:
    """float32 -> the int16 bit patterns of its bf16 rounding."""
    return np.asarray(jnp.asarray(a32).astype(jnp.bfloat16)).view(np.int16)


def _case(seed, max_q=96, M=256, C=64, fill=0.7, ties=False, shells=3):
    rng = np.random.default_rng(seed)
    n = (rng.random(max_q) * fill * C * 1.4).astype(np.int64).clip(0, C)
    n[:3] = (0, 1, C)                       # empty, one candidate, full
    col = np.arange(C)
    valid = col[None, :] < n[:, None]
    # candidates ordered by shell, as the cache stores them
    shell = np.sort(rng.integers(0, shells, (max_q, C)), axis=-1)
    pidx = rng.integers(0, 1 << 20, (max_q, C))
    kmeta = np.where(valid, pidx * 4 + shell, -1).astype(np.int32)
    pay = rng.normal(size=(max_q, PK, C)).astype(np.float32) * 0.02
    if ties:
        # every candidate appears twice: equal d2 in two columns
        pay[:, :3, 1::2] = pay[:, :3, 0::2]
    pay[:, COLCH, :] = col[None, :]
    kpay = _bf16_bits(pay)
    qslot = rng.integers(0, max_q, M).astype(np.int32)
    qslot[:3] = (0, 1, 2)
    cd0 = (rng.normal(size=(M, 3)) * 0.01).astype(np.float32)
    mask = rng.random(M) < 0.85
    return kmeta, kpay, qslot, cd0, mask


def _cache_tensors(kpay):
    """The cache's two payload tensors from the reference's channel-major
    kpay bits [max_q, PK, C]: the candidate-major kcand [max_q, C, PK]
    and the xyz planes kxyz [max_q, 3, C], both contiguous."""
    pay = torch.from_numpy(kpay.copy()).view(torch.bfloat16)
    return pay.transpose(1, 2).contiguous(), pay[:, :3, :].contiguous()


def _port(kmeta, kpay, qslot, cd0, mask, K, radius2, num_shells):
    """The wrapper on the cache's tensors; on the CPU it runs the plain
    version on the [max_q, PK, C] view of kcand."""
    _cuda.LAUNCHES.clear()
    kcand, kxyz = _cache_tensors(kpay)
    nsel, pm = tfs.fused_candidate_select(
        torch.from_numpy(kmeta), kcand, kxyz,
        torch.from_numpy(qslot), torch.from_numpy(cd0),
        torch.from_numpy(mask), K, radius2, num_shells)
    assert sum(_cuda.LAUNCHES.values()) == 0        # CPU: the plain version
    assert nsel.dtype == torch.bfloat16 and nsel.shape == (len(qslot), K, PK)
    return nsel.view(torch.int16).numpy(), pm.numpy()


def _xla_stages(kmeta, kpay, qslot, cd0, mask, K, radius2, num_shells):
    """The reference's XLA candidate stages (fast_render.chunk_body),
    un-jitted: (payload bits [M, K, PK], pnt_mask, top_idx)."""
    meta = jnp.asarray(kmeta)[qslot]
    pay = jnp.asarray(kpay.view(jnp.bfloat16.dtype))[qslot]   # [M, PK, C]
    shell = meta & 3
    cdelta = (jnp.transpose(pay[:, :3, :], (0, 2, 1)).astype(jnp.float32)
              + jnp.asarray(cd0)[:, None, :])
    d2 = jnp.sum(cdelta ** 2, -1)
    ok = (meta >= 0) & jnp.asarray(mask)[:, None]
    if radius2 > 0:
        ok = ok & (d2 <= radius2)
    if num_shells > 1:
        eligible = shell == 0
        before = jnp.zeros((meta.shape[0], 1), jnp.int32)
        for s in range(1, num_shells):
            before = before + jnp.sum((ok & (shell == s - 1)).astype(
                jnp.int32), -1, keepdims=True)
            eligible = eligible | ((shell == s) & (before < K))
        ok = ok & eligible
    neg_top, top_idx = jax.lax.top_k(-jnp.where(ok, d2, jnp.inf), K)
    pm = neg_top > -jnp.inf
    nsel = jnp.take_along_axis(jnp.transpose(pay, (0, 2, 1)),
                               top_idx[..., None], 1)
    nsel = jnp.where(pm[..., None], nsel, 0)    # +0, as the one-hot extract
    return (np.asarray(nsel).view(np.int16), np.asarray(pm),
            np.asarray(top_idx))


CASES = {
    "layered": dict(seed=1, K=8, radius=0.03, num_shells=3),
    "flat": dict(seed=2, K=8, radius=0.03, num_shells=1),
    "no_radius": dict(seed=3, K=4, radius=0.0, num_shells=2),
    "tight_radius": dict(seed=4, K=8, radius=0.012, num_shells=3),
    "ties": dict(seed=5, K=8, radius=0.03, num_shells=3, ties=True),
    "ties_flat_k3": dict(seed=6, K=3, radius=0.0, num_shells=1, ties=True),
    "narrow": dict(seed=7, K=8, radius=0.03, num_shells=2, C=32),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_select_matches_pallas_interpret(name):
    c = dict(CASES[name])
    K, r2, ns = c.pop("K"), c.pop("radius") ** 2, c.pop("num_shells")
    kmeta, kpay, qslot, cd0, mask = _case(**c)
    got, got_pm = _port(kmeta, kpay, qslot, cd0, mask, K, r2, ns)
    nsel_j, pm_j = jfs.fused_candidate_select(
        jnp.asarray(kmeta)[qslot],
        jnp.asarray(kpay.view(jnp.bfloat16.dtype))[qslot],
        jnp.asarray(cd0), jnp.asarray(mask), K, r2, ns, interpret=True)
    np.testing.assert_array_equal(got_pm, np.asarray(pm_j))
    # the reference writes float32; its bf16 cast is exact
    np.testing.assert_array_equal(got, _bf16_bits(np.asarray(nsel_j)))
    assert 0 < got_pm.sum() < got_pm.size
    assert not got_pm[~mask].any() and not got[~mask].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_select_matches_xla_stages(name):
    c = dict(CASES[name])
    K, r2, ns = c.pop("K"), c.pop("radius") ** 2, c.pop("num_shells")
    kmeta, kpay, qslot, cd0, mask = _case(**c)
    got, got_pm = _port(kmeta, kpay, qslot, cd0, mask, K, r2, ns)
    want, want_pm, top_idx = _xla_stages(kmeta, kpay, qslot, cd0, mask, K,
                                         r2, ns)
    np.testing.assert_array_equal(got_pm, want_pm)
    np.testing.assert_array_equal(got, want)
    # the chosen columns, read back from the payload's column channel
    cols = torch.from_numpy(got[..., COLCH].copy()).view(
        torch.bfloat16).float().numpy().astype(np.int64)
    np.testing.assert_array_equal(cols[got_pm], top_idx[got_pm])
    if c.get("ties"):
        # of two equal candidates the smaller column goes first
        first = cols[:, 0][got_pm[:, 0]]
        assert (first % 2 == 0).all()


def test_select_empty_and_all_masked():
    kmeta, kpay, qslot, cd0, mask = _case(seed=9, M=64)
    nsel, pm = _port(kmeta, kpay, qslot, cd0, np.zeros_like(mask), 8,
                     0.03 ** 2, 3)
    assert not pm.any() and not nsel.any()
    nsel0, pm0 = _port(kmeta, kpay, qslot[:0], cd0[:0], mask[:0], 8,
                       0.03 ** 2, 3)
    assert nsel0.shape == (0, 8, PK) and pm0.shape == (0, 8)


@pytest.mark.parametrize("name", ["layered", "ties", "narrow"])
def test_wrapper_on_cache_tensors_equals_plain_on_view(name):
    """The wrapper called with kcand / kxyz gives the bits the plain
    version gives on the reference's channel-major kpay itself."""
    c = dict(CASES[name])
    K, r2, ns = c.pop("K"), c.pop("radius") ** 2, c.pop("num_shells")
    kmeta, kpay, qslot, cd0, mask = _case(**c)
    got, got_pm = _port(kmeta, kpay, qslot, cd0, mask, K, r2, ns)
    want, want_pm = tfs.fused_candidate_select_reference(
        torch.from_numpy(kmeta),
        torch.from_numpy(kpay.copy()).view(torch.bfloat16),
        torch.from_numpy(qslot), torch.from_numpy(cd0),
        torch.from_numpy(mask), K, r2, ns)
    np.testing.assert_array_equal(got_pm, want_pm.numpy())
    np.testing.assert_array_equal(got, want.view(torch.int16).numpy())
    assert got_pm.any()


@pytest.mark.parametrize("which", ["kcand", "kxyz"])
def test_wrapper_refuses_a_strided_cache_tensor(which):
    """The kernel reads kcand and kxyz as they lie in memory: a view of
    another layout (the channel-major kpay transposed, say) raises."""
    kmeta, kpay, qslot, cd0, mask = _case(seed=11, M=32)
    kcand, kxyz = _cache_tensors(kpay)
    pay = torch.from_numpy(kpay.copy()).view(torch.bfloat16)
    if which == "kcand":
        kcand = pay.transpose(1, 2)                 # right shape, strided
    else:
        kxyz = kcand[:, :, :3].transpose(1, 2)
    assert not (kcand.is_contiguous() and kxyz.is_contiguous())
    with pytest.raises(ValueError, match=f"{which} must be contiguous"):
        tfs.fused_candidate_select(
            torch.from_numpy(kmeta), kcand, kxyz, torch.from_numpy(qslot),
            torch.from_numpy(cd0), torch.from_numpy(mask), 8, 0.03 ** 2, 3)
