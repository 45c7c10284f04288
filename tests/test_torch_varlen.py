"""Port parity for the packed mixed step (A6, K4) against the JAX reference.

On the CPU: `flashd_varlen_plain` (K4's plain version) and the plain
`varlen_attention` against the reference's jnp `varlen_attention` (and
the Pallas kernel `flashd_varlen_pallas` in interpret mode, also with the
plain version in the kernel's own split order at pages of 4, 16 and 64);
K4's split count at the engine's shapes; an emulation of K4's tensor-core
operand rounding (3xTF32, bf16 P, fresh partials) over its runs and masks
against the reference; `forward_packed` logits (1-D and 2-D `last_rows`) against the
reference's on the same weights; the mixed loop's pack layout against the
reference packer's. The kernel itself is held against the plain version
on the card (tests/test_torch_gpu.py).

Packs mix whole prompts, mid-sequence prefill chunks, one-row decode
segments, K+1-row verify segments, padding rows and an all-padding block.
Page 0 is NaN on the port's side (zero on the reference's). Tolerances: O
within 5e-5 (f32), padding rows exactly 0, logits within 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_llama as j_paper_llama
from repro.configs import qwen3_0_6b as j_qwen3
from repro.core import attention as jatt
from repro.kernels.flashd_varlen import flashd_varlen_pallas
from repro.models import get_model as j_get_model
from repro.models import transformer as jtf
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.core import attention as tatt
from repro_torch.kernels import ops
from repro_torch.core import blockwise as tb
from repro_torch.kernels.flashd_varlen import flashd_varlen, flashd_varlen_plain, gpu_varlen_splits
from repro_torch.models import transformer as ttf
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve import engine as tengine
from repro_torch.serve.scheduler import Segment, StepPlan
from test_torch_tc_numerics import _matmul

TOL = 5e-5
LOGIT_TOL = 1e-4


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=0, atol=tol)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _pool(rng, lengths, n_tbl, page, hkv, d, int8):
    """Reference pool (page 0 zero) and port pool (page 0 NaN, or NaN
    scales for int8), distinct shuffled pages, dead slots on page 0."""
    b = len(lengths)
    n_pages = b * n_tbl + 1
    shape = (n_pages, page, hkv, d)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        k[0] = v[0] = 0
        sc = [(rng.random((n_pages, hkv)) / 64 + 1e-3).astype(np.float32) for _ in range(2)]
        sc_nan = [x.copy() for x in sc]
        for x in sc_nan:
            x[0] = np.nan
        ref, port = (k, v, *sc), (k, v, *sc_nan)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        k[0] = v[0] = 0
        kn, vn = k.copy(), v.copy()
        kn[0] = vn[0] = np.nan
        ref, port = (k, v, None, None), (kn, vn, None, None)
    tbl = (rng.permutation(n_pages - 1)[: b * n_tbl] + 1).reshape(b, n_tbl).astype(np.int32)
    for i, n in enumerate(lengths):
        tbl[i, -(-n // page):] = 0
    return ref, port, tbl


def _pack(lengths, seg_rows, block_q):
    """seq_ids / q_pos: sequence s feeds its last seg_rows[s] positions, each
    segment padded to block_q; then one all-padding block."""
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


CASES = [
    # (group, page, block_q, window, chunk, int8)
    (1, 4, 8, 0, 0, False),
    (2, 8, 8, 0, 0, False),
    (4, 16, 16, 0, 0, False),
    (2, 4, 16, 7, 0, False),
    (2, 8, 8, 0, 10, False),
    (2, 8, 8, 0, 0, True),
    (1, 4, 16, 5, 0, True),
]


@pytest.mark.parametrize("case", CASES)
def test_varlen_plain_matches_reference(case):
    group, page, block_q, window, chunk, int8 = case
    rng = np.random.default_rng(page * 31 + block_q + group + 7 * int8)
    hkv, d, n_tbl = 2, 16, 10
    # whole prompt, mid-sequence prefill chunk, 1-row decode, K+1 = 4-row
    # verify, a sequence absent from the pack, a one-token prompt
    lengths = [13, 4 * page + 3, 22, 17, 9, 1]
    seg_rows = [13, 16, 1, 4, 0, 1]
    (k0, v0, ks0, vs0), (kn, vn, ksn, vsn), tbl = _pool(rng, lengths, n_tbl, page, hkv, d, int8)
    seq_ids, q_pos = _pack(lengths, seg_rows, block_q)
    kv_len = np.array(lengths, np.int32)
    q = rng.standard_normal((len(seq_ids), hkv * group, d)).astype(np.float32)
    want = np.asarray(jatt.varlen_attention(
        jnp.asarray(q), jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(tbl), jnp.asarray(seq_ids),
        jnp.asarray(q_pos), jnp.asarray(kv_len), window=window, chunk=chunk,
        k_scale=_j(ks0), v_scale=_j(vs0)))
    args = (_t(q), _t(kn), _t(vn), _t(tbl), _t(seq_ids), _t(q_pos), _t(kv_len))
    kw = dict(window=window, chunk=chunk, k_scale=_t(ksn), v_scale=_t(vsn))
    for got in (flashd_varlen_plain(*args, block_q=block_q, **kw),
                tatt.varlen_attention(*args, **kw),
                ops.get_fallback("varlen")(*args, block_q=block_q, **kw)):
        assert torch.isfinite(got).all()
        _close(got, want)
        assert (got[_t(q_pos) < 0] == 0).all()  # padding rows: exact zeros


def test_varlen_plain_matches_pallas_interpret():
    rng = np.random.default_rng(77)
    group, page, block_q, hkv, d, n_tbl = 2, 8, 8, 2, 16, 4
    lengths = [9, 20, 5]
    (_, _, _, _), (kn, vn, _, _), tbl = _pool(rng, lengths, n_tbl, page, hkv, d, False)
    seq_ids, q_pos = _pack(lengths, [9, 8, 1], block_q)
    kv_len = np.array(lengths, np.int32)
    q = rng.standard_normal((len(seq_ids), hkv * group, d)).astype(np.float32)
    want = np.asarray(flashd_varlen_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(tbl), jnp.asarray(seq_ids),
        jnp.asarray(q_pos), jnp.asarray(kv_len), block_q=block_q, interpret=True))
    got = flashd_varlen_plain(_t(q), _t(kn), _t(vn), _t(tbl), _t(seq_ids), _t(q_pos),
                              _t(kv_len), block_q=block_q)
    assert np.isfinite(want).all()
    _close(got, want)


VARLEN_SPLIT_CASES = [
    # (page, n_tbl, block_q, n_splits, int8): the kernel's split order
    (4, 12, 8, 3, False),  # runs of 16 span 4 pages
    (4, 12, 16, 7, True),  # runs of 7 straddle page edges; int8
    (16, 3, 8, 6, False),  # a page spans 2 runs of 8
    (16, 3, 16, 5, True),  # runs of 10; int8
    (64, 1, 8, 4, False),  # a page spans 4 runs of 16
    (64, 1, 16, 3, True),  # runs of 22; int8
]


@pytest.mark.parametrize("case", VARLEN_SPLIT_CASES)
def test_varlen_split_order_matches_pallas_interpret(case):
    """K4's plain version in the kernel's split order (runs of ⌈N·page /
    n_splits⌉ positions blended in order) against the Pallas kernel's
    per-page carry in interpret mode, within 5e-5; page 0 NaN (NaN scales
    for int8) on both sides; padding rows exactly 0."""
    page, n_tbl, block_q, n_splits, int8 = case
    rng = np.random.default_rng(page * 3 + n_splits + 40 * int8)
    group, hkv, d = 2, 2, 16
    full = n_tbl * page
    lengths = [min(21, full), full, full // 2 + 1, 5]
    seq_ids, q_pos = _pack(lengths, [min(21, full), 3, 1, 5], block_q)
    _, (kn, vn, ksn, vsn), tbl = _pool(rng, lengths, n_tbl, page, hkv, d, int8)
    kv_len = np.array(lengths, np.int32)
    q = rng.standard_normal((len(seq_ids), hkv * group, d)).astype(np.float32)
    want = np.asarray(flashd_varlen_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(tbl), jnp.asarray(seq_ids),
        jnp.asarray(q_pos), jnp.asarray(kv_len), block_q=block_q, k_scale=_j(ksn),
        v_scale=_j(vsn), interpret=True))
    got = flashd_varlen_plain(_t(q), _t(kn), _t(vn), _t(tbl), _t(seq_ids), _t(q_pos),
                              _t(kv_len), block_q=block_q, k_scale=_t(ksn), v_scale=_t(vsn),
                              n_splits=n_splits)
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    _close(got, want)
    assert (got[_t(q_pos) < 0] == 0).all()


def test_gpu_varlen_splits_by_hand():
    """K4's split count from shapes alone: ⌈4·SMs / CTAs of one split⌉
    splits wanted (CTAs = row groups of up to 64 rows × Hkv, where a group
    joins up to 64 / (block_q·G) blocks), each a multiple of 64 positions,
    at most 64 splits."""
    sms = 132
    # chip smoke's mixed-step pack: T 64, block_q 8, G 2, Hkv 8, S 512 → runs of 64
    assert gpu_varlen_splits(8, 8, 2, 8, 512, sms) == 8
    # four whole prompts of 512 at block_q 8: 64 groups of 4 blocks × 8 heads → runs of 256
    assert gpu_varlen_splits(256, 8, 2, 8, 512, sms) == 2
    # a lone slot's chunk at block_q 128, G 2: 4 row groups → runs of 64
    assert gpu_varlen_splits(1, 128, 2, 8, 512, sms) == 8
    # a long context: the cap of 64 splits (runs of 512)
    assert gpu_varlen_splits(1, 8, 2, 8, 32768, sms) == 64


def _k4_tc_emulated(q_rows, q_pos, k, v, kv_len, *, s_max, n_splits, window, chunk, mode):
    """K4's tensor-core body for one q block's live rows of one kv head:
    runs of ⌈s_max / n_splits⌉ positions, each read from the first position
    any row can see ([i0, i1) as the kernel clips it) in 64-key tiles with
    K1's carry and the tensor cores' operand rounding, then the runs
    blended in split order. q_rows [R, d], q_pos [R], k / v [S, d] f32
    (bf16-valued in bf16 mode)."""
    neg, dead = tb.NEG_INF, tb.NEG_INF / 2
    scale = 1.0 / q_rows.shape[-1] ** 0.5
    split = -(-s_max // n_splits)
    q_min, q_max = int(q_pos.min()), int(q_pos.max())
    out = (torch.zeros(q_rows.shape[0], v.shape[-1]), torch.full((q_rows.shape[0],), neg))
    for lo in range(0, s_max, split):
        i1 = min(lo + split, s_max, kv_len, q_max + 1)
        i0 = max(lo, q_min - window + 1) if window > 0 else lo
        if chunk > 0:
            i0 = max(i0, q_min // chunk * chunk)
        acc = torch.zeros_like(out[0])
        lam = torch.full_like(out[1], neg)
        for k0 in range(i0, i1, 64):
            pos = torch.arange(k0, min(k0 + 64, i1))
            s = _matmul(q_rows, k[pos].T, mode) * scale  # each k8 step a fresh f32 partial
            keep = pos[None, :] <= q_pos[:, None]
            if window > 0:
                keep &= q_pos[:, None] - pos[None, :] < window
            if chunk > 0:
                keep &= (q_pos[:, None] // chunk) == (pos[None, :] // chunk)
            s = torch.where(keep, s, torch.full_like(s, neg))
            m_safe = torch.clamp(s.amax(-1), min=dead)
            p = torch.exp(s - m_safe[..., None])
            l = p.sum(-1)
            lam_b = torch.where(l > 0, m_safe + torch.log(torch.clamp(l, min=1.17549435e-38)),
                                torch.full_like(l, neg))
            delta = lam_b - lam
            tile_dead, first = lam_b <= dead, lam <= dead
            w = torch.where(tile_dead, 0.0, torch.where(first, 1.0, torch.sigmoid(delta)))
            ln = torch.where(tile_dead, lam, torch.where(
                first, lam_b, lam_b - torch.nn.functional.logsigmoid(delta)))
            pc = p * torch.where(tile_dead, 0.0, torch.exp(m_safe - ln))[..., None]
            if mode == "bf16":
                pc = pc.bfloat16().float()  # P rounded to bf16 for the mma
            acc = acc * (1.0 - w)[..., None] + _matmul(pc, v[pos], mode)  # a fresh P·V partial
            lam = ln
        out = tb.merge_pair(out, (acc, lam))
    return out[0]


TC_CASES = [
    # (dtype, window, chunk, int8, magnitude)
    ("f32", 0, 0, False, 1.0),
    ("f32", 0, 0, False, 4.0),  # scores of ±60
    ("f32", 7, 0, False, 1.0),
    ("f32", 0, 10, True, 1.0),
    ("bf16", 0, 0, False, 1.0),
    ("bf16", 9, 0, True, 1.0),
]


@pytest.mark.parametrize("case", TC_CASES)
def test_varlen_tc_operand_rounding_holds_the_bounds(case):
    """Every q block with ≥ 16 live rows per kv head (a whole prompt, a
    prefill chunk) through the emulated tensor-core body — 3xTF32 in f32,
    bf16 operands with P rounded to bf16 — with K4's masks and split order,
    against the reference's jnp varlen_attention: 5e-5 in f32, 2e-2 in bf16
    (one bf16 rounding of O)."""
    dtype, window, chunk, int8, magnitude = case
    rng = np.random.default_rng(TC_CASES.index(case))
    group, hkv, d, page, n_tbl, block_q, n_splits = 2, 2, 64, 8, 10, 8, 3
    lengths = [40, 4 * page + 3, 22, 17]
    seg_rows = [40, 16, 1, 4]  # whole prompt, chunk (tensor cores); decode, verify (CUDA cores)
    (k0, v0, ks0, vs0), _, tbl = _pool(rng, lengths, n_tbl, page, hkv, d, int8)
    if not int8:
        k0 = k0 * magnitude
    seq_ids, q_pos = _pack(lengths, seg_rows, block_q)
    kv_len = np.array(lengths, np.int32)
    q = (rng.standard_normal((len(seq_ids), hkv * group, d)) * magnitude).astype(np.float32)
    if dtype == "bf16":
        q, k0, v0 = (torch.from_numpy(x).bfloat16().float().numpy() if x.dtype == np.float32
                     else x for x in (q, k0, v0))
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    kj, vj = (jnp.asarray(x) if int8 else jnp.asarray(x, jdt) for x in (k0, v0))
    want = np.asarray(jatt.varlen_attention(
        jnp.asarray(q, jdt), kj, vj, jnp.asarray(tbl), jnp.asarray(seq_ids), jnp.asarray(q_pos),
        jnp.asarray(kv_len), window=window, chunk=chunk, k_scale=_j(ks0), v_scale=_j(vs0)),
        np.float32)
    kc = tatt.gather_pages(_t(k0), _t(tbl), scales=_t(ks0)).float()  # [B, S, Hkv, d], dequantized
    vc = tatt.gather_pages(_t(v0), _t(tbl), scales=_t(vs0)).float()
    if dtype == "bf16":  # the tensor cores take the dequantized tiles as bf16
        kc, vc = kc.bfloat16().float(), vc.bfloat16().float()
    mode = "3xtf32" if dtype == "f32" else "bf16"
    tol = 5e-5 if dtype == "f32" else 2e-2
    n_tc = 0
    for ib in range(len(seq_ids) // block_q):
        rows = np.arange(ib * block_q, (ib + 1) * block_q)
        seq, live = seq_ids[rows[0]], rows[q_pos[rows] >= 0]
        if seq < 0 or len(live) * group < 16:
            continue  # the CUDA-core body: f32 FMA, the plain version's arithmetic
        n_tc += 1
        for hk in range(hkv):
            heads = np.arange(hk * group, (hk + 1) * group)
            q_rows = torch.from_numpy(q[live][:, heads].reshape(-1, d))  # rows (t, g)
            pos = torch.from_numpy(np.repeat(q_pos[live], group)).long()
            o = _k4_tc_emulated(q_rows, pos, kc[seq, :, hk], vc[seq, :, hk], int(kv_len[seq]),
                                s_max=n_tbl * page, n_splits=n_splits, window=window,
                                chunk=chunk, mode=mode)
            if dtype == "bf16":
                o = o.bfloat16().float()
            _close(o.numpy(), want[live][:, heads].reshape(-1, d), tol)
    assert n_tc == 7  # 5 prompt blocks + 2 chunk blocks


def test_varlen_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(8, 2, 32)
    pool = torch.zeros(3, 4, 1, 32)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flashd_varlen(q, pool, pool, torch.zeros(1, 2, dtype=torch.int32), idx, idx,
                      torch.ones(1, dtype=torch.int32), block_q=8)


# ---- model level: forward_packed ----

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


def test_forward_packed_matches_reference(model):
    """Two packed steps on shuffled tables: a first pack of whole prompts
    and a prefill chunk (1-D last_rows), then decode rows, the chunk's tail
    and a 3-row verify segment read at every row (2-D rows)."""
    jcfg, jp, tcfg, tp = model
    b, max_len, page, n_pages, block_q = 3, 32, 4, 25, 8
    rng = np.random.default_rng(8)
    jc = jtf.init_decode_cache(b, max_len, jcfg, layout="paged", page_size=page, n_pages=n_pages)
    tc = ttf.init_decode_cache(b, max_len, tcfg, layout="paged", page_size=page, n_pages=n_pages,
                               device="cpu")
    n_tbl = tc["blocks"]["pos0"]["tbl"].shape[-1]
    tbl = (rng.permutation(n_pages - 1)[: b * n_tbl] + 1).reshape(b, n_tbl).astype(np.int32)
    jc = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.broadcast_to(jnp.asarray(tbl), x.shape) if p[-1].key == "tbl" else x, jc)
    for group in tc.values():
        for leaves in group.values():
            leaves["tbl"][:] = torch.from_numpy(tbl)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32) for n in (5, 14, 3)]

    def pack(segs):  # (slot, start, tokens) → block_q-aligned arrays
        tokens, seq_ids, positions = [], [], []
        kv_len = np.zeros((b,), np.int32)
        starts = {}
        for slot, start, toks in segs:
            starts[slot] = len(tokens)
            pad = (-len(toks)) % block_q
            tokens += list(toks) + [0] * pad
            seq_ids += [slot] * len(toks) + [-1] * pad
            positions += list(range(start, start + len(toks))) + [-1] * pad
            kv_len[slot] = start + len(toks)
        tokens += [0] * block_q  # an all-padding block
        seq_ids += [-1] * block_q
        positions += [-1] * block_q
        arrs = [np.array(x, np.int32) for x in (tokens, seq_ids, positions)]
        return arrs + [kv_len], starts

    def both(arrs, rows):
        lj, jc_ = jtf.forward_packed(jp, *(jnp.asarray(a) for a in arrs[:4]), jcache[0], jcfg,
                                     jnp.asarray(rows), block_q=block_q)
        jcache[0] = jc_
        lt, tc_ = ttf.forward_packed(tp, *(_t(a) for a in arrs[:4]), tc, tcfg, _t(rows),
                                     block_q=block_q)
        assert tc_ is tc  # updated in place
        return np.asarray(lj), lt.numpy()

    jcache = [jc]
    arrs, starts = pack([(0, 0, prompts[0]), (1, 0, prompts[1][:8]), (2, 0, prompts[2])])
    rows = np.array([starts[0] + 4, -1, starts[2] + 2], np.int32)
    lj, lt = both(arrs, rows)
    v = jcfg.vocab_size
    _close(lj[[0, 2], :v], lt[[0, 2], :v], LOGIT_TOL)

    nxt = np.argmax(lj[:, :v], axis=-1).astype(np.int32)
    arrs, starts = pack([(0, 5, [nxt[0]]), (1, 8, prompts[1][8:]), (2, 3, [nxt[2], 7, 11])])
    rows = np.array([[starts[0], -1, -1], [starts[1] + 5, -1, -1],
                     [starts[2], starts[2] + 1, starts[2] + 2]], np.int32)
    lj, lt = both(arrs, rows)
    assert lt.shape == lj.shape and lt.shape[:2] == (b, 3)
    _close(lj[0, 0, :v], lt[0, 0, :v], LOGIT_TOL)
    _close(lj[1, 0, :v], lt[1, 0, :v], LOGIT_TOL)
    _close(lj[2, :, :v], lt[2, :, :v], LOGIT_TOL)


# ---- the mixed loop's packer ----

def test_pack_plan_layout_by_hand():
    plan = StepPlan(segments=(
        Segment(slot=1, tokens=np.array([5]), start=9, emits=True),
        Segment(slot=0, tokens=np.arange(10, 21), start=16, emits=False),
        Segment(slot=2, tokens=np.array([3, 4]), start=0, emits=True),
    ), n_tokens=14)
    tokens, seq_ids, positions, kv_len, last_rows = tengine.pack_plan(plan, 8, 4)
    assert len(tokens) == 32  # 8 + 16 + 8 rows = 32, already a power of two
    np.testing.assert_array_equal(seq_ids[:9], [1] + [-1] * 7 + [0])
    np.testing.assert_array_equal(positions[8:19], np.arange(16, 27))
    assert (positions[19:24] == -1).all() and (seq_ids[19:24] == -1).all()
    np.testing.assert_array_equal(tokens[24:26], [3, 4])
    np.testing.assert_array_equal(kv_len, [27, 10, 2, 0])
    np.testing.assert_array_equal(last_rows, [-1, 0, 25, -1])
    one = StepPlan(segments=(Segment(slot=0, tokens=np.array([1, 2, 3]), start=0, emits=True),),
                   n_tokens=3)
    assert len(tengine.pack_plan(one, 16, 2)[0]) == 16  # floor: one block


@pytest.mark.parametrize("max_batch,budget", [(3, 0), (1, 0), (2, 5)])
def test_mixed_pack_layout_matches_reference_packer(model, monkeypatch, max_batch, budget):
    """Every packed step of a mixed serve: the port's (tokens, seq_ids,
    positions, kv_len, last_rows, block_q) equal the reference packer's,
    recorded at the reference engine's jitted step call."""
    jcfg, jp, tcfg, tp = model
    sc = dict(max_batch=max_batch, max_len=48, decode_chunk=3, step_mode="mixed",
              prefix_cache=False, prefill_chunk=6, token_budget=budget)
    reqs = [np.random.default_rng(9).integers(0, jcfg.vocab_size, (n,)).astype(np.int32)
            for n in (13, 4, 21, 7)]
    je = JEngine(jp, jcfg, JServeConfig(**sc))
    want = []
    mixed = je._mixed

    def record_ref(params, cache, tokens, seq_ids, positions, kv_len, last_rows, key, block_q):
        want.append([np.asarray(a) for a in (tokens, seq_ids, positions, kv_len, last_rows)]
                    + [block_q])
        return mixed(params, cache, tokens, seq_ids, positions, kv_len, last_rows, key, block_q)

    je._mixed = record_ref
    out_j = je.serve(reqs, 5)
    got = []
    forward = tengine.forward_packed

    def record_port(params, tokens, seq_ids, positions, kv_len, cache, cfg, last_rows, block_q):
        # copies: the engine packs into static buffers that the next step rewrites
        got.append([a.numpy().copy() for a in (tokens, seq_ids, positions, kv_len, last_rows)]
                   + [block_q])
        return forward(params, tokens, seq_ids, positions, kv_len, cache, cfg, last_rows,
                       block_q=block_q)

    monkeypatch.setattr(tengine, "forward_packed", record_port)
    out_t = Engine(tp, tcfg, ServeConfig(**sc), device="cpu").serve(reqs, 5)
    for a, b_ in zip(out_t, out_j):
        np.testing.assert_array_equal(a, b_)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for x, y in zip(g[:5], w[:5]):
            np.testing.assert_array_equal(x, y)
        assert g[5] == w[5]
