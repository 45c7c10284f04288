"""Port parity at head dim 256 and query groups of 9–16 (recurrentgemma-9b:
Hq 16 over Hkv 1 of head dim 256; qwen3-moe-235b-a22b: Hq 64 over Hkv 4,
G 16), on the CPU.

The plain versions of K1 (`flashd_fwd_plain`), K2 (`flashd_decode_plain`),
K3 (`flashd_decode_paged_plain`), K4 (`flashd_varlen_plain`) and K5
(`flashd_bwd_plain`) against the reference's Pallas kernels run in
interpret mode, at small lengths: K1 under the local and chunked masks, K2
with a window and `start`, K3 on an int8 pool, K4 on a mixed pack, K5
under the local mask and with dead leading rows; one train step of a
recurrentgemma-shaped stack with head dim 256 against the reference's; the
copied tuning heuristics at these shapes against the reference's; and the
shape choices the kernels' host code makes there (`decode_rows`,
`_row_groups`, the translation units a head dim is built in). The CUDA
kernels at these shapes are held to these plain versions in
tests/test_torch_gpu.py (on the card).

Tolerance: O and Λ within 5e-5 in f32 (summation order only); gradients
rtol 1e-4 / atol 1e-5; the train step's loss, grad norm and parameters
within 1e-4 relative (`tests/test_torch_archs_train.py`'s REL)."""

import dataclasses
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core import blockwise as jb
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import tuning as jtune
from repro.kernels.flashd_bwd import flashd_bwd_pallas
from repro.kernels.flashd_decode import flashd_decode_paged_pallas, flashd_decode_pallas
from repro.kernels.flashd_fwd import flashd_fwd_pallas
from repro.kernels.flashd_varlen import flashd_varlen_pallas
from repro.kernels.ref import attention_ref
from repro.models import get_model as j_get_model
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.core import blockwise as tb
from repro_torch.kernels import _build
from repro_torch.kernels import flashd_bwd as k5
from repro_torch.kernels import flashd_decode as k2
from repro_torch.kernels import flashd_fwd as k1
from repro_torch.kernels import flashd_varlen as k4
from repro_torch.kernels import tuning as ttune
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tts

TOL = 5e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
REL = 1e-4  # tests/test_torch_archs_train.py


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Interpret mode and the plain versions at these sizes: one intra-op
    thread keeps the module's run short beside other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=0, atol=tol)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


FWD_CASES = [
    # (group, head dim, mask kind, window, chunk, q_offset)
    (16, 256, "local", 20, 0, 0),  # recurrentgemma-9b's heads and mask
    (16, 256, "chunked", 0, 16, 0),
    (12, 256, "causal", 0, 0, 8),
    (16, 128, "chunked", 0, 16, 0),  # qwen3-moe's group at its head dim
    (12, 128, "local", 9, 0, 0),
]


@pytest.mark.parametrize("case", FWD_CASES)
def test_fwd_plain_matches_pallas_interpret(case):
    group, d, kind, window, chunk, q_offset = case
    rng = np.random.default_rng(group * 1000 + d + window + chunk)
    b, hkv, sq, skv = 1, 1, 40, 48
    q = rng.standard_normal((b, hkv * group, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    jm = jb.MaskSpec(kind, window, chunk, q_offset)
    tm = tb.MaskSpec(kind, window, chunk, q_offset)
    o_j, l_j = flashd_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm,
                                 block_q=16, block_k=16, interpret=True)
    o_t, l_t = k1.flashd_fwd_plain(_t(q), _t(k), _t(v), mask=tm, block_q=16, block_k=16)
    _close(o_j, o_t)
    _close(l_j, l_t)


DECODE_CASES = [
    # (group, head dim, n_splits, window, with start)
    (16, 256, 3, 12, False),  # recurrentgemma-9b's ring read with a window
    (16, 256, 4, 0, True),
    (12, 256, 2, 0, True),
    (16, 128, 3, 0, False),  # qwen3-moe-235b-a22b's group
    (9, 128, 4, 10, True),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_pallas_interpret(case):
    group, d, n_splits, window, with_start = case
    rng = np.random.default_rng(group * 100 + d + n_splits)
    b, hkv, s_max = 3, 1, 32
    q = rng.standard_normal((b, hkv * group, d)).astype(np.float32)
    kc = rng.standard_normal((b, hkv, s_max, d)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, s_max, d)).astype(np.float32)
    cl = np.array([0, 19, 32], np.int32)
    start = np.array([0, 6, 25], np.int32) if with_start else None
    o_j, l_j = flashd_decode_pallas(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cl), n_splits=n_splits,
        window=window, start=_j(start), return_lam=True, interpret=True)
    o_t, l_t = k2.flashd_decode_plain(
        _t(q), _t(kc), _t(vc), _t(cl), n_splits=n_splits, window=window, start=_t(start),
        return_lam=True)
    _close(o_j, o_t)
    _close(l_j, l_t)
    assert (o_t[0] == 0).all() and (l_t[0] == tb.NEG_INF).all()  # empty cache: dead row


def _int8_pool(rng, lengths, n_tbl, page, hkv, d):
    """An int8 pool with shuffled distinct pages, dead table slots on page
    0, whose scales are NaN: neither side may follow a dead slot."""
    n_pages = len(lengths) * n_tbl + 1
    shape = (n_pages, page, hkv, d)
    k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    ks, vs = ((rng.random((n_pages, hkv)) / 64 + 1e-3).astype(np.float32) for _ in range(2))
    ks[0] = vs[0] = np.nan
    tbl = (rng.permutation(n_pages - 1) + 1).reshape(len(lengths), n_tbl).astype(np.int32)
    for i, n in enumerate(lengths):
        tbl[i, -(-n // page):] = 0
    return k, v, ks, vs, tbl


@pytest.mark.parametrize("group, d", [(16, 256), (16, 128), (12, 256)])
def test_paged_decode_plain_on_an_int8_pool_matches_pallas_interpret(group, d):
    rng = np.random.default_rng(group + d)
    page, hkv, n_tbl = 8, 1, 4
    lengths = [1, 9, 32]
    k, v, ks, vs, tbl = _int8_pool(rng, lengths, n_tbl, page, hkv, d)
    q = rng.standard_normal((len(lengths), hkv * group, d)).astype(np.float32)
    cl = np.array(lengths, np.int32)
    want = np.asarray(flashd_decode_paged_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl), jnp.asarray(cl),
        k_scale=_j(ks), v_scale=_j(vs), window=12, interpret=True))
    n = k2.gpu_decode_splits(len(lengths), hkv, n_tbl * page)  # the kernel's split order too
    for n_splits in (None, n):
        got = k2.flashd_decode_paged_plain(_t(q), _t(k), _t(v), _t(tbl), _t(cl), k_scale=_t(ks),
                                           v_scale=_t(vs), window=12, n_splits=n_splits)
        assert np.isfinite(want).all() and torch.isfinite(got).all()
        _close(got, want)


def _pack(lengths, seg_rows, block_q):
    seq_ids, q_pos = [], []
    for s, (n, r) in enumerate(zip(lengths, seg_rows)):
        if r == 0:
            continue
        pad = (-r) % block_q
        seq_ids += [s] * r + [-1] * pad
        q_pos += list(range(n - r, n)) + [-1] * pad
    seq_ids += [-1] * block_q
    q_pos += [-1] * block_q
    return np.array(seq_ids, np.int32), np.array(q_pos, np.int32)


@pytest.mark.parametrize("group, d, int8", [(16, 256, False), (16, 128, True), (12, 256, True)])
def test_varlen_plain_on_a_mixed_pack_matches_pallas_interpret(group, d, int8):
    """A mixed pack: a 9-row prefill chunk mid-sequence, two decode rows
    and a 3-row verify segment, block_q 8, then a padding block; at G 16 a
    decode row is 16 (token, head) rows."""
    rng = np.random.default_rng(group * 10 + d + int8)
    page, hkv, n_tbl, block_q = 8, 1, 4, 8
    lengths = [20, 7, 32, 12]
    if int8:
        k, v, ks, vs, tbl = _int8_pool(rng, lengths, n_tbl, page, hkv, d)
    else:
        n_pages = len(lengths) * n_tbl + 1
        k, v = (rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32) for _ in range(2))
        k[0] = v[0] = np.nan
        ks = vs = None
        tbl = (rng.permutation(n_pages - 1) + 1).reshape(len(lengths), n_tbl).astype(np.int32)
        for i, n in enumerate(lengths):
            tbl[i, -(-n // page):] = 0
    seq_ids, q_pos = _pack(lengths, [9, 1, 1, 3], block_q)
    kv_len = np.array(lengths, np.int32)
    q = rng.standard_normal((len(seq_ids), hkv * group, d)).astype(np.float32)
    want = np.asarray(flashd_varlen_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl), jnp.asarray(seq_ids),
        jnp.asarray(q_pos), jnp.asarray(kv_len), block_q=block_q, k_scale=_j(ks),
        v_scale=_j(vs), window=10, interpret=True))
    n = k4.gpu_varlen_splits(len(seq_ids) // block_q, block_q, group, hkv, n_tbl * page)
    for n_splits in (None, n):
        got = k4.flashd_varlen_plain(_t(q), _t(k), _t(v), _t(tbl), _t(seq_ids), _t(q_pos),
                                     _t(kv_len), block_q=block_q, k_scale=_t(ks), v_scale=_t(vs),
                                     window=10, n_splits=n_splits)
        assert np.isfinite(want).all() and torch.isfinite(got).all()
        _close(got, want)
        assert (got[_t(q_pos) < 0] == 0).all()


BWD_CASES = [
    # (mask kind, window, q_offset, sq, skv)
    ("local", 20, 0, 49, 49),  # recurrentgemma-9b's mask, the window crossed
    ("causal", 0, -9, 40, 40),  # dead leading rows
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_plain_matches_pallas_interpret_at_head_dim_256(case):
    """K5's plain version at head dim 256 over a group of 16 (Hq 16 over
    Hkv 1) against `flashd_bwd_pallas` in interpret mode on the same saved
    (O, Λ): dQ, dK, dV within rtol 1e-4 / atol 1e-5; dead rows get none."""
    kind, window, q_offset, sq, skv = case
    rng = np.random.default_rng(sq + window)
    shapes = ((1, 16, sq, 256), (1, 1, skv, 256), (1, 1, skv, 256), (1, 16, sq, 256))
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32) for sh in shapes)
    jm = jb.MaskSpec(kind, window, 0, q_offset)
    o, lam = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm)
    args = (q, k, v, np.asarray(o), np.asarray(lam), do)
    want = flashd_bwd_pallas(*(jnp.asarray(x) for x in args), mask=jm, block_q=16, block_k=16,
                             interpret=True)
    got = k5.flashd_bwd_plain(*(_t(x) for x in args), mask=tb.MaskSpec(kind, window, 0, q_offset),
                              block_q=16, block_k=16)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if q_offset < 0:
        assert (got[0][:, :, :-q_offset] == 0).all()


LR = 1e-2
STEP_REL = 2.0 ** -10  # a leaf's step against the reference's (see below)


def test_train_step_at_head_dim_256_matches_reference():
    """One train step of a recurrentgemma-shaped stack — one period
    (rglru, rglru, attn_local), Hq 16 over Hkv 1 of head dim 256, window 8
    crossed by 24 tokens — with the knobs `chip_smoke.py` phase 21 trains
    recurrentgemma-9b with (bf16 AdamW moments, no numerics guard, the lr
    at its peak at step 0), f32, on the reference's weights and batch:
    loss and grad norm within REL relative; every parameter of the port
    updated; the updated tree within REL of its norm; and each leaf's step
    (new − old) within STEP_REL of the reference's step's norm. A moment
    within f32 noise of a bf16 rounding boundary rounds one bf16 ulp (at
    most 2^-7 relative) apart in the two packages, which moves that
    entry's first step lr·m̂/√v̂ by at most 2^-7 + 2^-8 of it; such flips
    are rare, and which leaves they touch follows the intra-op thread
    count's f32 noise: measured steps within 3.35e-4 of the reference's
    (`final_norm`, `pos0.norm2`: 64 entries that start at zero, so also
    3.35e-4 of their norm; one thread and two), 1.5e-4 with f32 moments.
    A leaf left alone, or stepped with a wrong sign, lr, bias correction or
    clip, is off by O(1) of its step; a wrong decay mask by wd·|p| ≈ 3e-3
    of it here."""
    jcfg = dataclasses.replace(j_get_smoke_config("recurrentgemma-9b"), dtype="float32",
                               n_layers=3, n_heads=16, n_kv_heads=1, head_dim=256)
    tcfg = bridge.config_from_reference(jcfg)
    knobs = dict(warmup_steps=0, total_steps=10, opt_state_dtype="bfloat16",
                 numerics_guard=False)
    jtc = jts.TrainConfig(optimizer=jadamw.AdamWConfig(lr=LR), **knobs)
    ttc = tts.TrainConfig(optimizer=tadamw.AdamWConfig(lr=LR), **knobs)
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jtc)._replace(params=jp)
    tstate = tts.init_train_state(
        tcfg, ttc, params=bridge.params_from_numpy(jax.tree.map(np.asarray, jp)))
    batch = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=24,
                                     global_batch=2)).batch(0)
    jnew, jm = jax.jit(jts.make_train_step(jcfg, jtc))(jstate, jax.tree.map(jnp.asarray, batch))
    tnew, tm = tts.make_train_step(tcfg, ttc)(tstate, {k_: torch.from_numpy(x)
                                                       for k_, x in batch.items()})
    for key in ("loss", "grad_norm"):
        assert abs(float(jm[key]) - float(tm[key])) <= REL * abs(float(jm[key])), key
    leaves = lambda tree: dict(jax.tree_util.tree_leaves_with_path(tree))
    before = leaves(jax.tree.map(np.asarray, jp))
    want = leaves(jax.tree.map(np.asarray, jnew.params))
    got = leaves(bridge.params_to_numpy(tnew.params))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, w in want.items():
        name = jax.tree_util.keystr(path)
        assert not np.array_equal(got[path], before[path]), name  # lr > 0
        assert not np.array_equal(w, before[path]), name
        step = w.astype(np.float64) - before[path]
        gap = got[path].astype(np.float64) - w
        assert np.sum(gap ** 2) <= STEP_REL ** 2 * np.sum(step ** 2), name
    diff = sum(np.sum((got[p].astype(np.float64) - w) ** 2) for p, w in want.items())
    norm = sum(np.sum(w.astype(np.float64) ** 2) for w in want.values())
    assert diff <= REL ** 2 * norm, np.sqrt(diff / norm)


def test_tuning_heuristics_are_the_reference_at_head_dim_256_and_group_16():
    """The copied heuristics make the reference's choices at these shapes:
    prefill blocks, decode splits (recurrentgemma-9b's window 2048 too),
    page size and layout, varlen blocks (int8 pools too)."""
    for s, d, g in itertools.product((1, 64, 300, 2048, 4096, 32768), (128, 256), (9, 12, 16)):
        assert (dataclasses.astuple(ttune.choose_prefill_blocks(s, s + 3, d))
                == dataclasses.astuple(jtune.choose_prefill_blocks(s, s + 3, d)))
        for w, c, item in ((0, 0, 4), (2048, 0, 4), (0, 8192, 4), (0, 0, 1)):
            tj = jtune.choose_decode_split(s, d, group=g, window=w, chunk=c, kv_itemsize=item)
            tt = ttune.choose_decode_split(s, d, group=g, window=w, chunk=c, kv_itemsize=item)
            assert (tj.n_splits, tj.split) == (tt.n_splits, tt.split)
        assert ttune.choose_page_size(s, d, group=g) == jtune.choose_page_size(s, d, group=g)
        lj = jtune.choose_page_layout(s, d, group=g, pool_tokens=4 * s)
        lt = ttune.choose_page_layout(s, d, group=g, pool_tokens=4 * s)
        assert (lj.page_size, lj.n_pages, lj.pages_per_seq) == (lt.page_size, lt.n_pages,
                                                                lt.pages_per_seq)
        for hint, item in ((1, 4), (5, 4), (None, 4), (1, 1)):
            vj = jtune.choose_varlen_blocks(s, d, group=g, segment_hint=hint, kv_itemsize=item)
            vt = ttune.choose_varlen_blocks(s, d, group=g, segment_hint=hint, kv_itemsize=item)
            assert vj.block_q == vt.block_q


@pytest.mark.parametrize("split", [1, 3, 16, 31, 32, 33, 48, 64])
def test_decode_rows_by_head_dim(split):
    """K2 / K3 stage a split in chunks of its length rounded up to 4, at
    most 64 rows — 32 at head dim 256, where two stages of 64 f32 K and V
    rows would take 256 KB of shared memory."""
    ceil4 = -(-split // 4) * 4
    for d in k1.HEAD_DIMS:
        assert k2.decode_rows(split, d) == min(ceil4, 64 if d <= 128 else 32)


def test_varlen_row_groups_at_groups_above_8():
    """K4 cuts a q block of block_q·G rows into row groups of 64 (the
    launcher refuses a geometry whose rows do not fit): at G 16 block_q 8
    makes 2 groups, the reference's block_q 64 makes 16, and a group of
    12 at block_q 8 makes 2 (96 rows)."""
    assert k4._row_groups(8, 16) == (2, 1, 64)
    assert k4._row_groups(64, 16) == (16, 1, 64)
    assert k4._row_groups(8, 12) == (2, 1, 64)
    assert k4._row_groups(4, 16) == (1, 1, 64)
    for bq, g in itertools.product((4, 8, 16, 32, 64, 128), range(1, 17)):
        rg, bpg, rb = k4._row_groups(bq, g)
        assert rg * k4.ROW_GROUP >= bq * g * bpg and rb >= min(k4.ROW_GROUP, bq * g * bpg)


def test_every_head_dim_is_built_in_one_unit():
    """K1–K4 and K6 take the head dims of `flashd_fwd.HEAD_DIMS`, K5 those
    of `flashd_bwd.HEAD_DIMS` (256 since K5's d-256 tile plan); K2 / K3's,
    K4's and K5's head dims are split over translation units that nvcc
    builds at once, each head dim instantiated in exactly one of them (K5's
    256 in its own) and dispatched by a `case` of the entry point's
    switch."""
    assert 256 in k1.HEAD_DIMS and 256 in k5.HEAD_DIMS and set(k5.HEAD_DIMS) <= set(k1.HEAD_DIMS)
    assert k2.MAX_GROUP == 16
    for lib, macro, dims in (("flashd_decode", "FLASHD_DECODE_HD", k1.HEAD_DIMS),
                             ("flashd_varlen", "FLASHD_VARLEN_HD", k1.HEAD_DIMS),
                             ("flashd_bwd", "FLASHD_BWD_HD", k5.HEAD_DIMS)):
        units = _build.UNITS[lib]
        assert units[0] == lib
        seen = {}
        for unit in units:
            text = (_build.CSRC / f"{unit}.cu").read_text()
            seen[unit] = [int(x) for x in re.findall(macro + r"\((\d+)\) \{", text)]
        assert sorted(sum(seen.values(), [])) == sorted(dims), (lib, seen)
        if lib == "flashd_bwd":
            assert [u for u, found in seen.items() if 256 in found] == ["flashd_bwd_hd256"]
            assert seen["flashd_bwd_hd256"] == [256]
    for lib in ("flashd_fwd", "fa2_fwd", "flashd_bwd"):
        text = (_build.CSRC / f"{lib}.cu").read_text()
        dims = [int(x) for x in re.findall(r"case (\d+): return", text)]
        assert dims == list(k5.HEAD_DIMS if lib == "flashd_bwd" else k1.HEAD_DIMS), (lib, dims)
