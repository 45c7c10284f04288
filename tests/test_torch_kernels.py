"""Port parity for the kernel modules.

On the CPU: each kernel module's plain version (`flashd_fwd_plain`,
`flashd_decode_plain`) against the JAX Pallas kernel run as the reference's
own tests run it (interpret mode), the tuning heuristics against the
reference's, and the op registry / impl routing. The CUDA kernels against
their plain versions are in tests/test_torch_gpu.py (on the card).

Tolerance: O and Λ within 5e-5 in f32 (summation order only)."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockwise as jb
from repro.core.attention import decode_attention as j_decode_attention
from repro.kernels import tuning as jtune
from repro.kernels.flashd_decode import flashd_decode_pallas
from repro.kernels.flashd_fwd import flashd_fwd_pallas
from repro_torch.core import attention as tatt
from repro_torch.core import blockwise as tb
from repro_torch.kernels import ops, tuning as ttune
from repro_torch.kernels.flashd_decode import flashd_decode, flashd_decode_plain
from repro_torch.kernels.flashd_fwd import flashd_fwd, flashd_fwd_plain

TOL = 5e-5


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=0, atol=tol)


FWD_CASES = [
    # (mask kind, window, chunk, q_offset, skip)
    ("causal", 0, 0, 0, False),
    ("causal", 0, 0, 0, True),
    ("full", 0, 0, 0, False),
    ("local", 9, 0, 0, True),
    ("chunked", 0, 16, 0, False),
    ("causal", 0, 0, 8, False),
    ("causal", 0, 0, -12, True),  # dead leading rows
]


@pytest.mark.parametrize("case", FWD_CASES)
def test_fwd_plain_matches_pallas_interpret(case):
    kind, window, chunk, q_offset, skip = case
    rng = np.random.default_rng(abs(hash(case)) % 2**32)
    b, hkv, g, sq, skv, d = 1, 2, 2, 40, 48, 32
    q = rng.standard_normal((b, hkv * g, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    jm = jb.MaskSpec(kind, window, chunk, q_offset)
    tm = tb.MaskSpec(kind, window, chunk, q_offset)
    o_j, l_j = flashd_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm,
                                 block_q=16, block_k=16, skip=skip, interpret=True)
    o_t, l_t = flashd_fwd_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                mask=tm, block_q=16, block_k=16, skip=skip)
    _close(o_j, o_t)
    _close(l_j, l_t)


DECODE_CASES = [
    # (n_splits, window, chunk, with start, fused)
    (3, 0, 0, False, True),
    (3, 0, 0, False, False),
    (4, 6, 0, False, True),
    (2, 0, 8, False, False),
    (3, 0, 0, True, True),
    (1, 0, 0, False, True),
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("group", [1, 2])
def test_decode_plain_matches_pallas_interpret(case, group):
    n_splits, window, chunk, with_start, fused = case
    rng = np.random.default_rng(group * 7 + n_splits)
    b, hkv, s_max, d = 5, 2, 32, 32
    q = rng.standard_normal((b, hkv * group, d)).astype(np.float32)
    kc = rng.standard_normal((b, hkv, s_max, d)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, s_max, d)).astype(np.float32)
    cl = np.array([0, 1, 13, 31, 32], np.int32)
    start = np.array([0, 0, 5, 20, 3], np.int32) if with_start else None
    o_j, l_j = flashd_decode_pallas(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cl),
        n_splits=n_splits, window=window, chunk=chunk,
        start=None if start is None else jnp.asarray(start),
        fused=fused, return_lam=True, interpret=True)
    o_t, l_t = flashd_decode_plain(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), torch.from_numpy(cl),
        n_splits=n_splits, window=window, chunk=chunk,
        start=None if start is None else torch.from_numpy(start),
        fused=fused, return_lam=True)
    _close(o_j, o_t)
    _close(l_j, l_t)
    assert (o_t[0] == 0).all() and (l_t[0] == tb.NEG_INF).all()  # empty cache: dead row


def test_decode_fused_and_unfused_orders_agree():
    """The in-order carry and the log-depth tree differ only in rounding."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((3, 2, 50, 16)).astype(np.float32))
    cl = torch.tensor([50, 17, 3])
    a = flashd_decode_plain(q, kc, kc, cl, n_splits=7, fused=True)
    b = flashd_decode_plain(q, kc, kc, cl, n_splits=7, fused=False)
    _close(a, b, 1e-6)


@pytest.mark.parametrize("window,chunk,n_splits", [(0, 0, None), (0, 0, 3), (7, 0, 2), (0, 8, 4)])
def test_decode_attention_matches_reference(window, chunk, n_splits):
    rng = np.random.default_rng(21)
    q = rng.standard_normal((4, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((4, 40, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((4, 40, 2, 16)).astype(np.float32)
    cl = np.array([0, 1, 25, 40], np.int32)
    o_j = j_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cl),
                             window=window, chunk=chunk, n_splits=n_splits)
    o_t = tatt.decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                                torch.from_numpy(cl), window=window, chunk=chunk,
                                n_splits=n_splits)
    _close(o_j, o_t)


def test_tuning_heuristics_are_the_reference():
    for s, d, g in itertools.product((1, 7, 64, 300, 4096, 32768), (32, 64, 128), (1, 2, 8)):
        assert (dataclasses.astuple(ttune.choose_prefill_blocks(s, s + 3, d))
                == dataclasses.astuple(jtune.choose_prefill_blocks(s, s + 3, d)))
        for w, c in ((0, 0), (100, 0), (0, 64)):
            tj = jtune.choose_decode_split(s, d, group=g, window=w, chunk=c)
            tt = ttune.choose_decode_split(s, d, group=g, window=w, chunk=c)
            assert (tj.n_splits, tj.split) == (tt.n_splits, tt.split)
        assert ttune.choose_page_size(s, d, group=g) == jtune.choose_page_size(s, d, group=g)
        lj = jtune.choose_page_layout(s, d, group=g, pool_tokens=4 * s)
        lt = ttune.choose_page_layout(s, d, group=g, pool_tokens=4 * s)
        assert (lj.page_size, lj.n_pages, lj.pages_per_seq) == (lt.page_size, lt.n_pages, lt.pages_per_seq)
        vj = jtune.choose_varlen_blocks(s, d, group=g, segment_hint=5)
        assert vj.block_q == ttune.choose_varlen_blocks(s, d, group=g, segment_hint=5).block_q
        assert ttune.bucket_pow2(s) == jtune.bucket_pow2(s)
        assert ttune.padded_rows(s, 8) == jtune.padded_rows(s, 8)
    rj = jtune.choose_ring_schedule(64, 64, 64, n_devices=8, mask=jb.MaskSpec("local", window=100))
    rt = ttune.choose_ring_schedule(64, 64, 64, n_devices=8, mask=tb.MaskSpec("local", window=100))
    assert (rj.n_hops, rj.block_q, rj.block_k) == (rt.n_hops, rt.block_q, rt.block_k)
    with pytest.raises(ValueError):
        ttune.bucket_pow2(9, hi=8)


def test_registry_and_impl_routing():
    assert ops.op_names() == ("attention_bwd", "attention_fwd", "decode", "decode_paged",
                              "varlen")
    for name in ops.op_names():
        assert callable(ops.get_fallback(name))
    assert ops.fallback_impl("flashd_gpu") == "flashd"
    assert ops.fallback_impl("fa2_gpu") == "fa2"
    assert ops.fallback_impl("naive") == "naive"
    with pytest.raises(KeyError):
        ops.get_op("ring_prefill")  # the context-parallel routes: multi-device slice (A13)
    x = torch.zeros(1)
    for family in ("flashd", "fa2"):
        assert not tatt.uses_kernel(family, x)  # CPU tensor: plain path
        assert tatt.uses_kernel(f"{family}_gpu", x)  # always the kernel
        assert not tatt.uses_kernel(f"{family}_plain", x)
    assert not tatt.uses_kernel("xla", x) and not tatt.uses_kernel("naive", x)
    with pytest.raises(ValueError, match="not ported"):
        tatt.uses_kernel("fa3", x)


@pytest.mark.parametrize("mask", [("causal", 0, 0, 0), ("local", 5, 0, 0), ("full", 0, 0, 0)])
def test_flash_attention_impls_agree_on_cpu(mask):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 19, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 19, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 19, 2, 16)).astype(np.float32))
    m = tb.MaskSpec(*mask)
    o = tatt.flash_attention(q, k, v, mask=m, impl="flashd")
    _close(o, tatt.flash_attention(q, k, v, mask=m, impl="flashd_plain"), 0)
    _close(o, tatt.flash_attention(q, k, v, mask=m, impl="naive"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """No silent fallback: a wrapper given CPU tensors raises, and so does
    the flashd_gpu impl."""
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flashd_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flashd_decode(q[:, :, 0], q, q, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tatt.flash_attention(q, q, q, impl="flashd_gpu")
