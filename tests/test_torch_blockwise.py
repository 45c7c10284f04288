"""Port parity: FLASH-D tile math and oracles (repro_torch.core.blockwise,
repro_torch.kernels.ref) against the JAX reference on the same numpy inputs.

Tolerance: O and Λ within 5e-5 (f32; the two sides sum in different
orders, nothing else differs)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockwise as jb
from repro.kernels import ref as jref
from repro_torch.core import blockwise as tb
from repro_torch.kernels import ref as tref

TOL = 5e-5

MASKS = [
    ("full", 0, 0, 0),
    ("causal", 0, 0, 0),
    ("causal", 0, 0, 5),
    ("causal", 0, 0, -9),  # leading rows see no key: dead rows
    ("local", 6, 0, 0),
    ("local", 4, 0, 3),
    ("chunked", 0, 8, 0),
    ("chunked", 0, 5, 2),
]


def _masks(kind, window, chunk, q_offset):
    return (jb.MaskSpec(kind, window, chunk, q_offset),
            tb.MaskSpec(kind, window, chunk, q_offset))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("skip", [False, True])
def test_blockwise_flashd_matches_reference(mask, skip):
    jm, tm = _masks(*mask)
    rng = np.random.default_rng(hash(mask) % 2**32)
    q = rng.standard_normal((21, 16)).astype(np.float32) * 2
    k = rng.standard_normal((27, 16)).astype(np.float32) * 2
    v = rng.standard_normal((27, 16)).astype(np.float32)
    o_j, l_j = jb.blockwise_flashd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm,
                                   block_q=8, block_k=8, skip=skip)
    o_t, l_t = tb.blockwise_flashd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   mask=tm, block_q=8, block_k=8, skip=skip)
    _close(o_j, o_t)
    _close(l_j, l_t)
    assert torch.isfinite(o_t).all()


def test_blockwise_skip_changes_the_result_like_the_reference():
    """A row dominated by one early key: later tiles fall below the skip
    threshold on both sides, and both suppress the same updates."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((16, 8)).astype(np.float32)
    k = rng.standard_normal((64, 8)).astype(np.float32) * 0.1
    k[0] = q.mean(0) * 40
    v = rng.standard_normal((64, 8)).astype(np.float32)
    jm, tm = _masks("full", 0, 0, 0)
    o_j, _ = jb.blockwise_flashd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm,
                                 block_q=8, block_k=8, skip=True)
    o_t, _ = tb.blockwise_flashd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 mask=tm, block_q=8, block_k=8, skip=True)
    o_n, _ = tb.blockwise_flashd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 mask=tm, block_q=8, block_k=8, skip=False)
    _close(o_j, o_t)
    assert (o_t - o_n).abs().max() > 0  # skip really suppressed something


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("group", [1, 2, 4])
def test_attention_ref_matches_reference(mask, group):
    jm, tm = _masks(*mask)
    rng = np.random.default_rng(group)
    hkv = 2
    q = rng.standard_normal((2, hkv * group, 13, 8)).astype(np.float32)
    k = rng.standard_normal((2, hkv, 17, 8)).astype(np.float32)
    v = rng.standard_normal((2, hkv, 17, 8)).astype(np.float32)
    o_j, l_j = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm)
    o_t, l_t = tref.attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  mask=tm)
    _close(o_j, o_t)
    _close(l_j, l_t)


@pytest.mark.parametrize("window,chunk", [(0, 0), (5, 0), (0, 4)])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_decode_ref_matches_reference_ragged(window, chunk, group):
    rng = np.random.default_rng(10 + group)
    hkv, s_max = 2, 24
    q = rng.standard_normal((5, hkv * group, 8)).astype(np.float32)
    kc = rng.standard_normal((5, hkv, s_max, 8)).astype(np.float32)
    vc = rng.standard_normal((5, hkv, s_max, 8)).astype(np.float32)
    cl = np.array([0, 1, 7, 23, 24], np.int32)  # empty, single, ragged, full
    o_j = jref.decode_ref(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cl),
                          window=window, chunk=chunk)
    o_t = tref.decode_ref(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                          torch.from_numpy(cl), window=window, chunk=chunk)
    _close(o_j, o_t)
    assert (o_t[0] == 0).all()  # cache_len 0: dead row, zero output


def test_dead_rows_follow_the_convention():
    """A fully masked row gives O = 0 and Λ = NEG_INF, never a uniform softmax."""
    jm, tm = _masks("causal", 0, 0, -4)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 8, 8)).astype(np.float32))
    o, lam = tref.attention_ref(q, k, k, mask=tm)
    assert (o[:, :, :4] == 0).all() and (lam[:, :, :4] == tb.NEG_INF).all()
    o2, lam2 = tb.blockwise_flashd(q, k, k, mask=tm, block_q=4, block_k=4)
    assert (o2[:, :, :4] == 0).all() and (lam2[:, :, :4] == tb.NEG_INF).all()
    _close(o2, o)


@pytest.mark.parametrize("n_parts", [1, 2, 3, 5, 8])
def test_merge_partials_matches_reference(n_parts):
    rng = np.random.default_rng(n_parts)
    o = rng.standard_normal((n_parts, 3, 4, 6)).astype(np.float32)
    lam = rng.standard_normal((n_parts, 3, 4)).astype(np.float32) * 3
    lam[0, 0, 0] = jb.NEG_INF  # dead partials are identity elements
    lam[:, 1, 1] = jb.NEG_INF  # a row dead in every partial
    o_j, l_j = jb.merge_partials(jnp.asarray(o), jnp.asarray(lam))
    o_t, l_t = tb.merge_partials(torch.from_numpy(o), torch.from_numpy(lam))
    _close(o_j, o_t)
    _close(l_j, l_t)


def test_merge_pair_matches_reference():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((4, 5)).astype(np.float32), rng.standard_normal(4).astype(np.float32))
    b = (rng.standard_normal((4, 5)).astype(np.float32), rng.standard_normal(4).astype(np.float32))
    b[1][2] = jb.NEG_INF
    oj, lj = jb.merge_pair(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    ot, lt = tb.merge_pair(tuple(map(torch.from_numpy, a)), tuple(map(torch.from_numpy, b)))
    _close(oj, ot)
    _close(lj, lt)


@pytest.mark.parametrize("mask", MASKS)
def test_tile_live_and_static_predicates_match_reference(mask):
    jm, tm = _masks(*mask)
    for iq, ik in itertools.product(range(6), range(6)):
        assert bool(jb.tile_live(jm, iq, ik, 4, 8, 30)) == tb.tile_live(tm, iq, ik, 4, 8, 30)
    for q_lo, k_lo in itertools.product(range(0, 24, 4), range(0, 24, 4)):
        args = (q_lo, q_lo + 4, k_lo, k_lo + 4)
        assert jm.block_fully_masked(*args) == tm.block_fully_masked(*args)
        assert jm.block_fully_visible(*args) == tm.block_fully_visible(*args)
    qp, kp = np.arange(9), np.arange(11)
    bj = jm.block_bias(jnp.asarray(qp), jnp.asarray(kp))
    bt = tm.block_bias(torch.from_numpy(qp), torch.from_numpy(kp))
    assert (bj is None) == (bt is None)
    if bt is not None:
        np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
