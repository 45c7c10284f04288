"""Port parity for the packed mixed step (A6, K4) against the JAX reference.

On the CPU: `flashd_varlen_plain` (K4's plain version) and the plain
`varlen_attention` against the reference's jnp `varlen_attention` (and, on
one small case, the Pallas kernel `flashd_varlen_pallas` in interpret
mode); `forward_packed` logits (1-D and 2-D `last_rows`) against the
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
from repro_torch.kernels.flashd_varlen import flashd_varlen, flashd_varlen_plain
from repro_torch.models import transformer as ttf
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve import engine as tengine
from repro_torch.serve.scheduler import Segment, StepPlan

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
        got.append([a.numpy() for a in (tokens, seq_ids, positions, kv_len, last_rows)]
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
