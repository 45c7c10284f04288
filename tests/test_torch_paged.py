"""Port parity for the paged KV cache (A5, K3) against the JAX reference.

On the CPU: `flashd_decode_paged_plain` (K3's plain version) and the plain
`decode_attention_paged` / `gather_pages` against the reference's jnp
`decode_attention_paged` (and, on small cases, the Pallas kernel
`flashd_decode_paged_pallas` in interpret mode — also in the kernel's own
split order, runs of positions that span pages or split them); K3's split
count at the engine's shapes; the paged cache layout,
the paged decode step and `prefill_lm` on a paged cache against the
reference's; the copied page allocator. The kernel itself is held against
the plain version on the card (tests/test_torch_gpu.py).

Inputs are drawn with numpy from a seed. The pool's pages are distinct and
shuffled; table slots past a sequence's live pages point at page 0, which
the port sees filled with NaN (the reference sees it zeroed: its plain path
multiplies masked probabilities by whatever page 0 holds), so a port result
that used page 0 would be NaN. Tolerances: O within 5e-5 (f32, summation
order only), logits within 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_llama as j_paper_llama
from repro.configs import qwen3_0_6b as j_qwen3
from repro.core import attention as jatt
from repro.kernels.flashd_decode import flashd_decode_paged_pallas
from repro.models import get_model as j_get_model
from repro.models import transformer as jtf
from repro.runtime.kvcache import PagedKVAllocator as JAllocator
from repro_torch import bridge
from repro_torch.core import attention as tatt
from repro_torch.kernels import ops
from repro_torch.kernels.flashd_decode import (
    flashd_decode_paged,
    flashd_decode_paged_plain,
    gpu_decode_splits,
)
from repro_torch.models import transformer as ttf
from repro_torch.runtime import PagedKVAllocator, PageError

TOL = 5e-5
LOGIT_TOL = 1e-4


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=0, atol=tol)


def _pool(rng, lengths, n_tbl, page, hkv, d, *, int8=False):
    """(k, v pools with page 0 zeroed, k, v with page 0 NaN, table, scales).

    Pages are distinct and shuffled; slots past each row's live pages hold 0.
    An int8 pool's page-0 scales are NaN in the port's copy."""
    b = len(lengths)
    n_pages = b * n_tbl + 1
    shape = (n_pages, page, hkv, d)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random((n_pages, hkv)) / 64 + 1e-3).astype(np.float32)
        vs = (rng.random((n_pages, hkv)) / 64 + 1e-3).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    k[0] = 0
    v[0] = 0
    tbl = (rng.permutation(n_pages - 1)[: b * n_tbl] + 1).reshape(b, n_tbl).astype(np.int32)
    for i, n in enumerate(lengths):
        tbl[i, -(-n // page):] = 0
    if int8:
        ks_nan, vs_nan = ks.copy(), vs.copy()
        ks_nan[0] = vs_nan[0] = np.nan
        return (k, v), (k, v), tbl, (ks, vs), (ks_nan, vs_nan)
    k_nan, v_nan = k.copy(), v.copy()
    k_nan[0] = v_nan[0] = np.nan
    return (k, v), (k_nan, v_nan), tbl, None, None


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


CASES = [
    # (group, page, window, chunk, int8)
    (1, 4, 0, 0, False),
    (2, 8, 0, 0, False),
    (4, 16, 0, 0, False),
    (2, 4, 6, 0, False),
    (4, 8, 0, 12, False),
    (2, 8, 0, 0, True),
    (1, 16, 9, 0, True),
]


@pytest.mark.parametrize("case", CASES)
def test_paged_decode_plain_matches_reference(case):
    group, page, window, chunk, int8 = case
    rng = np.random.default_rng(page * 13 + group + 100 * int8)
    hkv, d, n_tbl = 2, 16, 5
    full = n_tbl * page
    lengths = [0, 1, page, page + 1, full - 1, full]
    (k0, v0), (kn, vn), tbl, sc0, scn = _pool(rng, lengths, n_tbl, page, hkv, d, int8=int8)
    q = rng.standard_normal((len(lengths), hkv * group, d)).astype(np.float32)
    cl = np.array(lengths, np.int32)
    sc0 = sc0 or (None, None)
    scn = scn or (None, None)
    want = np.asarray(jatt.decode_attention_paged(
        jnp.asarray(q[:, None]), jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(tbl),
        jnp.asarray(cl), window=window, chunk=chunk, k_scale=_j(sc0[0]), v_scale=_j(sc0[1])))[:, 0]
    got = flashd_decode_paged_plain(
        _t(q), _t(kn), _t(vn), _t(tbl), _t(cl), window=window, chunk=chunk,
        k_scale=_t(scn[0]), v_scale=_t(scn[1]))
    assert torch.isfinite(got).all()
    _close(got, want)
    assert (got[0] == 0).all()  # empty cache: dead row
    got2 = tatt.decode_attention_paged(
        _t(q[:, None]), _t(kn), _t(vn), _t(tbl), _t(cl), window=window, chunk=chunk,
        k_scale=_t(scn[0]), v_scale=_t(scn[1]))
    _close(got2[:, 0], want)
    # the registered plain fallback is the same function
    _close(ops.get_fallback("decode_paged")(
        _t(q), _t(kn), _t(vn), _t(tbl), _t(cl), window=window, chunk=chunk,
        k_scale=_t(scn[0]), v_scale=_t(scn[1]))[:, 0], want)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_plain_matches_pallas_interpret(int8):
    rng = np.random.default_rng(5 + int8)
    page, hkv, group, d, n_tbl = 8, 2, 2, 16, 4
    lengths = [1, 8, 9, 32]
    (k0, v0), (kn, vn), tbl, _, scn = _pool(rng, lengths, n_tbl, page, hkv, d, int8=int8)
    scn = scn or (None, None)
    q = rng.standard_normal((len(lengths), hkv * group, d)).astype(np.float32)
    cl = np.array(lengths, np.int32)
    # the Pallas kernel never reads a dead page either: it gets the NaN pool
    want = np.asarray(flashd_decode_paged_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(tbl), jnp.asarray(cl),
        k_scale=_j(scn[0]), v_scale=_j(scn[1]), interpret=True))
    got = flashd_decode_paged_plain(_t(q), _t(kn), _t(vn), _t(tbl), _t(cl),
                                    k_scale=_t(scn[0]), v_scale=_t(scn[1]))
    assert np.isfinite(want).all()
    _close(got, want)


SPLIT_CASES = [
    # (page, n_tbl, n_splits, int8): the kernel's split order — runs of
    # ⌈N·page / n_splits⌉ positions — against the reference's per-page carry
    (4, 16, 4, False),  # a run of 16 spans 4 pages
    (4, 16, 5, True),  # runs of 13 straddle page edges; int8
    (16, 4, 8, False),  # a page of 16 spans 2 runs of 8
    (16, 4, 3, True),  # runs of 22 straddle page edges; int8
    (64, 2, 8, False),  # a page of 64 spans 4 runs of 16
    (64, 2, 3, True),  # runs of 43; int8
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_paged_decode_split_order_matches_pallas_interpret(case):
    """K3's plain version in the kernel's split order against the Pallas
    kernel in interpret mode: the blend is associative to a few ulps, so
    the orders agree within 5e-5. Page 0 is NaN (or has NaN scales) on both
    sides: neither follows a dead table slot."""
    page, n_tbl, n_splits, int8 = case
    rng = np.random.default_rng(page * 7 + n_splits + 50 * int8)
    hkv, group, d = 2, 2, 16
    full = n_tbl * page
    lengths = [1, page - 1, page + 1, full // 2 + 3, full - 1, full]
    _, (kn, vn), tbl, _, scn = _pool(rng, lengths, n_tbl, page, hkv, d, int8=int8)
    scn = scn or (None, None)
    q = rng.standard_normal((len(lengths), hkv * group, d)).astype(np.float32)
    cl = np.array(lengths, np.int32)
    want = np.asarray(flashd_decode_paged_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(tbl), jnp.asarray(cl),
        k_scale=_j(scn[0]), v_scale=_j(scn[1]), interpret=True))
    got = flashd_decode_paged_plain(_t(q), _t(kn), _t(vn), _t(tbl), _t(cl),
                                    k_scale=_t(scn[0]), v_scale=_t(scn[1]), n_splits=n_splits)
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    _close(got, want)


def test_gpu_decode_splits_by_hand():
    """K2's and K3's split count from shapes alone (S_max = N·page for K3,
    so pages of 64 and 16 give one count): ⌈4·SMs / (B·Hkv)⌉ splits wanted,
    each a multiple of 16 positions in [16, 64]."""
    sms = 132
    assert gpu_decode_splits(4, 8, 512, sms) == 16  # the engine's decode: splits of 32, 512 CTAs
    assert gpu_decode_splits(8, 8, 512, sms) == 8  # chip smoke phase 7's B 8: splits of 64
    assert gpu_decode_splits(1, 8, 4096, sms) == 64  # one long row: splits of 64
    assert gpu_decode_splits(64, 8, 512, sms) == 8  # a wide batch: the ceiling of 64 positions
    assert gpu_decode_splits(1, 1, 64, sms) == 4  # one row, one head: the floor of 16
    assert gpu_decode_splits(4, 8, 1, sms) == 1


def test_gather_pages_matches_reference():
    rng = np.random.default_rng(9)
    (k0, _), _, tbl, (ks, _), _ = _pool(rng, [3, 9, 16], 4, 4, 2, 8, int8=True)
    for scales in (None, ks):
        want = np.asarray(jatt.gather_pages(jnp.asarray(k0), jnp.asarray(tbl), scales=_j(scales)))
        got = tatt.gather_pages(_t(k0), _t(tbl), scales=_t(scales))
        np.testing.assert_array_equal(got.numpy(), want)


def test_paged_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 32)
    pool = torch.zeros(3, 4, 1, 32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flashd_decode_paged(q, pool, pool, torch.zeros(1, 2, dtype=torch.int32),
                            torch.ones(1, dtype=torch.int32))


# ---- the copied allocator ----

def test_allocator_is_the_reference_copy():
    """The same admit / extend / free script gives the same tables, free
    counts and errors in the port's copy and the reference."""
    ours, ref = PagedKVAllocator(9, 4), JAllocator(9, 4)
    for a in (ours, ref):
        a.admit(0, prompt_len=5, reserve_tokens=5)
        a.admit(1, prompt_len=9, reserve_tokens=12)
        a.extend(0, 11)
        a.extend(1, 12)
        a.free(0)
        a.admit(2, prompt_len=3, reserve_tokens=3)
        a.check()
    assert ours.table(1) == ref.table(1) and ours.table(2) == ref.table(2)
    assert ours.free_pages == ref.free_pages and ours.pages_in_use == ref.pages_in_use
    with pytest.raises(PageError):
        ours.extend(2, 40)


# ---- model level: the paged cache ----

CONFIGS = {
    "qwen3-0.6b-smoke": dataclasses.replace(j_qwen3.SMOKE, dtype="float32"),
    "paper-llama": j_paper_llama.CONFIG,
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jcfg = CONFIGS[request.param]
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, bridge.config_from_reference(jcfg), tparams


def test_paged_cache_layout_matches_reference(model):
    jcfg, _, tcfg, _ = model
    for kw in ({}, {"page_size": 4, "n_pages": 13}):
        jc = jtf.init_decode_cache(3, 24, jcfg, layout="paged", **kw)
        tc = ttf.init_decode_cache(3, 24, tcfg, layout="paged", device="cpu", **kw)
        for name in ("k_pages", "v_pages", "tbl"):
            assert tuple(tc["blocks"]["pos0"][name].shape) == jc["blocks"]["pos0"][name].shape
        assert tc["blocks"]["pos0"]["tbl"].dtype == torch.int32
        assert (tc["blocks"]["pos0"]["tbl"] == 0).all()  # every row on the garbage page
    with pytest.raises(NotImplementedError, match="A8"):
        ttf.init_decode_cache(1, 8, tcfg, layout="paged", kv_dtype="int8", device="cpu")


def test_paged_prefill_and_decode_match_reference(model):
    """prefill_lm and decode_step_lm on a paged cache with shuffled tables:
    logits as the reference's, pages written where the reference writes
    them, and the same logits as the contiguous cache."""
    jcfg, jp, tcfg, tp = model
    b, s, max_len, page, n_pages = 2, 10, 24, 4, 14
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    jc = jtf.init_decode_cache(b, max_len, jcfg, layout="paged", page_size=page, n_pages=n_pages)
    tc = ttf.init_decode_cache(b, max_len, tcfg, layout="paged", page_size=page, n_pages=n_pages,
                               device="cpu")
    n_tbl = jc["blocks"]["pos0"]["tbl"].shape[-1]
    tbl = (np.random.default_rng(4).permutation(n_pages - 1)[: b * n_tbl] + 1)
    tbl = tbl.reshape(b, n_tbl).astype(np.int32)
    jc = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.broadcast_to(jnp.asarray(tbl), x.shape) if p[-1].key == "tbl" else x, jc)
    for group in tc.values():
        for leaves in group.values():
            leaves["tbl"][:] = torch.from_numpy(tbl)
    lj, jc = jtf.prefill_lm(jp, jnp.asarray(toks), jc, jcfg)
    lt, tc2 = ttf.prefill_lm(tp, torch.from_numpy(toks).long(), tc, tcfg)
    assert tc2 is tc  # updated in place
    _close(lj[:, : jcfg.vocab_size], lt[:, : jcfg.vocab_size], LOGIT_TOL)
    live = np.unique(tbl[tbl > 0])
    np.testing.assert_allclose(np.asarray(jc["blocks"]["pos0"]["k_pages"])[:, live],
                               tc["blocks"]["pos0"]["k_pages"][:, live].numpy(), rtol=0, atol=1e-5)
    cc = ttf.init_decode_cache(b, max_len, tcfg, device="cpu")
    lc, _ = ttf.prefill_lm(tp, torch.from_numpy(toks).long(), cc, tcfg)
    _close(lc[:, : jcfg.vocab_size], lt[:, : jcfg.vocab_size], LOGIT_TOL)
    nxt = np.argmax(np.asarray(lj)[:, : jcfg.vocab_size], axis=-1).astype(np.int32)
    for step in range(3):
        pos = np.full((b,), s + step, np.int32)
        dj, jc = jtf.decode_step_lm(jp, jc, jnp.asarray(nxt), jnp.asarray(pos), jcfg)
        dt, _ = ttf.decode_step_lm(tp, tc, torch.from_numpy(nxt).long(),
                                   torch.from_numpy(pos).long(), tcfg)
        _close(dj[:, : jcfg.vocab_size], dt[:, : jcfg.vocab_size], LOGIT_TOL)
        nxt = np.argmax(np.asarray(dj)[:, : jcfg.vocab_size], axis=-1).astype(np.int32)


def test_kernel_impls_route_the_paged_ops_to_the_kernels(model):
    """The bridge maps the reference's 'flashd_pallas' onto 'flashd_gpu';
    on a paged cache that impl reaches K3 (decode) and K4 (packed step),
    whose wrappers refuse CPU tensors instead of falling back."""
    jcfg, _, _, tp = model
    tcfg = bridge.config_from_reference(dataclasses.replace(jcfg, attn_impl="flashd_pallas"))
    assert tcfg.attn_impl == "flashd_gpu"
    cache = ttf.init_decode_cache(2, 16, tcfg, layout="paged", page_size=4, n_pages=9,
                                  device="cpu")
    one = torch.ones(2, dtype=torch.long)
    with torch.inference_mode(), pytest.raises(ValueError, match="flashd_decode_paged"):
        ttf.decode_step_lm(tp, cache, one, one, tcfg)
    seq_ids = torch.tensor([0, 0, -1, -1, 1, 1, -1, -1])
    positions = torch.tensor([0, 1, -1, -1, 0, 1, -1, -1])
    with torch.inference_mode(), pytest.raises(ValueError, match="flashd_varlen"):
        ttf.forward_packed(tp, torch.zeros(8, dtype=torch.long), seq_ids, positions, one * 2,
                           cache, tcfg, torch.tensor([1, 5]), block_q=4)
