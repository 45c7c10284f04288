"""Port parity for the quantized KV pool (A8), int8 and fp8 (e4m3), against
the JAX reference (`repro/runtime/quant.py`, the slot-0 write rule in
`repro/models/transformer.py`, `tests/test_quant.py`).

- `slot0_scale`, `quantize_rows` and `dequantize_pages` give the
  reference's bytes on the same inputs (the scale as the reference's jitted
  engine computes it: XLA folds the division by qmax / HEADROOM into a
  product with its reciprocal);
- the sequential (`_paged_attn_step`) and packed (`_packed_attn`) write
  paths of both packages, fed the same K/V rows (an identity-weight layer
  makes the packed path's K/V the input rows exactly), store byte-equal
  pages and scales on every page a table maps;
- the engines, paged and mixed, on the same weights and requests: greedy
  tokens equal the reference's, the pages on the allocator's pages are
  byte-equal and the scales within 1e-6 relative (the f32 K/V rows feeding
  them differ by ulps between XLA's and torch's arithmetic);
- a warm radix hit on an int8 pool serves the cold tokens; `stats()` pool
  bytes (scales counted) equal the reference's; the allocator's scale
  check catches a corrupted scale;
- K3's and K4's plain versions on an fp8 pool equal the reference's Pallas
  kernels in interpret mode within 5e-5.

Everything runs on the CPU at the smoke widths of qwen3-0.6b."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as j_qwen3
from repro.kernels.flashd_decode import flashd_decode_paged_pallas
from repro.kernels.flashd_varlen import flashd_varlen_pallas
from repro.models import get_model as j_get_model
from repro.models import transformer as jtf
from repro.runtime import quant as jq
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.kernels.flashd_decode import flashd_decode_paged_plain
from repro_torch.kernels.flashd_varlen import flashd_varlen_plain
from repro_torch.models import transformer as ttf
from repro_torch.runtime import quant as tq
from repro_torch.serve import Engine, ServeConfig

FORMATS = ("int8", "fp8")
TOL = 5e-5
SCALE_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_qwen3.SMOKE, dtype="float32")
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, bridge.config_from_reference(jcfg), tparams


def _bytes(x) -> np.ndarray:
    """The stored bytes of a pool or scale array (either package)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.uint8) if x.element_size() == 1 else x).numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def _to_torch(x) -> torch.Tensor:
    """A numpy / jax array as a torch tensor, fp8 by its bytes."""
    x = np.asarray(x)
    if x.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(x.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(x.copy())


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lengths]


# ---- the format ----

def test_spec_registry_matches_reference():
    assert tq.available() == jq.available() == ("fp8", "int8")
    for name in FORMATS:
        t, j = tq.get_spec(name), jq.get_spec(name)
        assert (t.name, t.qmax, t.itemsize) == (j.name, j.qmax, j.itemsize)
        assert tq.spec_for_dtype(t.dtype) is t and tq.kv_itemsize(name) == 1
    assert tq.get_spec("") is None and tq.kv_itemsize("") == 4
    assert tq.spec_for_dtype(torch.float32) is None
    assert (tq.HEADROOM, tq._EPS) == (jq.HEADROOM, jq._EPS)
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        tq.get_spec("int4")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", FORMATS)
def test_quant_functions_byte_equal_to_reference(name, seed):
    """Rows of mixed magnitudes (saturating rows included, an all-zero
    slot-0 row): the same scales, codes and dequantized pools."""
    rng = np.random.default_rng(seed)
    js, ts = jq.get_spec(name), tq.get_spec(name)
    rows = rng.standard_normal((6, 4, 2, 32)).astype(np.float32)
    rows *= rng.choice([1e-3, 1.0, 40.0], (6, 4, 2, 1)).astype(np.float32)
    rows[0, 0, 1] = 0.0
    want_sc = jax.jit(lambda r: jq.slot0_scale(r, js))(jnp.asarray(rows[:, 0]))
    got_sc = tq.slot0_scale(torch.from_numpy(rows[:, 0]), ts)
    np.testing.assert_array_equal(_bytes(got_sc), _bytes(want_sc))
    assert (got_sc > 0).all()
    scales = np.repeat(np.asarray(want_sc)[:, None], 4, axis=1) * 0.5  # later rows saturate
    want_q = jq.quantize_rows(jnp.asarray(rows), jnp.asarray(scales), js)
    got_q = tq.quantize_rows(torch.from_numpy(rows), torch.from_numpy(scales), ts)
    assert got_q.dtype == ts.dtype
    np.testing.assert_array_equal(_bytes(got_q), _bytes(want_q))
    pages_sc = np.array(want_sc)  # [P=6, Hkv]
    want_d = jq.dequantize_pages(want_q, jnp.asarray(pages_sc))
    got_d = tq.dequantize_pages(got_q, torch.from_numpy(pages_sc))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


# ---- the write paths, on the same K/V rows ----

def _identity_layer():
    """A layer whose packed step writes its input rows as K and V exactly:
    attn_nope, no qk-norm, Hq = Hkv, d_model = Hkv·hd, identity weights."""
    jcfg = dataclasses.replace(j_qwen3.SMOKE, dtype="float32", d_model=32, n_heads=2,
                               n_kv_heads=2, head_dim=16, qk_norm=False,
                               pattern=(("attn_nope", "swiglu"),))
    eye = np.eye(32, dtype=np.float32)
    return jcfg, bridge.config_from_reference(jcfg), {n: eye for n in ("wq", "wk", "wv", "wo")}


def _pools(spec_name, n_pages, page, tbl):
    jspec, tspec = jq.get_spec(spec_name), tq.get_spec(spec_name)
    shape = (n_pages, page, 2, 16)
    jc = {"k_pages": jnp.zeros(shape, jspec.dtype), "v_pages": jnp.zeros(shape, jspec.dtype),
          "tbl": jnp.asarray(tbl), "k_scale": jnp.ones((n_pages, 2), jnp.float32),
          "v_scale": jnp.ones((n_pages, 2), jnp.float32)}
    tc = {"k_pages": torch.zeros(shape, dtype=tspec.dtype),
          "v_pages": torch.zeros(shape, dtype=tspec.dtype), "tbl": torch.from_numpy(tbl),
          "k_scale": torch.ones((n_pages, 2)), "v_scale": torch.ones((n_pages, 2))}
    return jc, tc


@pytest.mark.parametrize("name", FORMATS)
def test_write_paths_byte_equal_to_reference(name):
    """Two sequences of 13 positions (rows of rising magnitude, so later
    rows of a page saturate) through a pool of pages of 4 with shuffled
    tables: one position a step through `_paged_attn_step`, and as packs of
    chunks (slot 0 and later slots of one page in one call, a chunk across
    page edges, padding rows) through `_packed_attn`, in both packages.
    All four pools hold the same bytes and scales on every mapped page."""
    jcfg, tcfg, eye = _identity_layer()
    rng = np.random.default_rng(11)
    page, n_tbl, n, block_q = 4, 4, 13, 8
    n_pages = 2 * n_tbl + 1
    tbl = (rng.permutation(n_pages - 1) + 1).reshape(2, n_tbl).astype(np.int32)
    x = rng.standard_normal((2, n, 32)).astype(np.float32)
    x *= np.linspace(0.5, 3.0, n, dtype=np.float32)[None, :, None]
    kv = x.reshape(2, n, 2, 16)
    jp = {k_: jnp.asarray(v_) for k_, v_ in eye.items()}
    tp = {k_: torch.from_numpy(v_) for k_, v_ in eye.items()}
    # the reference's steps jitted, as its engine runs them
    jstep = jax.jit(lambda c, q, pos: jtf._paged_attn_step(jp, q, q, q, jcfg, c, pos)[1])
    jpack = jax.jit(lambda c, x_, pos, sid, kvl: jtf._packed_attn(
        jp, x_, jcfg, "attn_nope", c, pos, sid, kvl, block_q)[1])

    # sequential: both sequences, one position a step
    jseq, tseq = _pools(name, n_pages, page, tbl)
    for t in range(n):
        kt = kv[:, t][:, None]  # [B, 1, Hkv, hd]
        pos = np.full((2,), t, np.int32)
        jseq = jstep(jseq, jnp.asarray(kt), jnp.asarray(pos))
        ttf._paged_attn_step(torch.from_numpy(kt), torch.from_numpy(kt), torch.from_numpy(kt),
                             tcfg, tseq, torch.from_numpy(pos).long())

    # packed: seq 0 feeds [0, 6) then [6, 13); seq 1 feeds [0, 3), [3, 4), [4, 13)
    jpk, tpk = _pools(name, n_pages, page, tbl)
    for chunks in (((0, 0, 6), (1, 0, 3)), ((1, 3, 4),), ((0, 6, 13), (1, 4, 13))):
        rows, sid, pos = [], [], []
        kv_len = np.zeros((2,), np.int32)
        for s, lo, hi in chunks:
            pad = -(hi - lo) % block_q
            rows += [x[s, lo:hi], np.zeros((pad, 32), np.float32)]
            sid += [s] * (hi - lo) + [-1] * pad
            pos += list(range(lo, hi)) + [-1] * pad
            kv_len[s] = hi
        xp = np.concatenate(rows)[None]
        sid, pos = np.asarray(sid, np.int32), np.asarray(pos, np.int32)
        jpk = jpack(jpk, jnp.asarray(xp), jnp.asarray(pos), jnp.asarray(sid),
                    jnp.asarray(kv_len))
        ttf._packed_attn(tp, torch.from_numpy(xp), tcfg, "attn_nope", tpk,
                         torch.from_numpy(pos).long(), torch.from_numpy(sid).long(),
                         torch.from_numpy(kv_len).long(), block_q)

    live = sorted(set(tbl.ravel().tolist()))  # every mapped page, never page 0
    for leaf in ("k_pages", "v_pages", "k_scale", "v_scale"):
        want = _bytes(np.asarray(jseq[leaf])[live])
        for got in (tseq[leaf][live], np.asarray(jpk[leaf])[live], tpk[leaf][live]):
            np.testing.assert_array_equal(_bytes(got), want, err_msg=leaf)
    # a slot-0 row reads back within half an int8 step or an e4m3 rounding;
    # later, larger rows saturate
    deq = tq.dequantize_pages(tseq["k_pages"], tseq["k_scale"])
    step = float(tseq["k_scale"][tbl[0, 0]].max())
    assert deq[tbl[0, 0], 0].allclose(torch.from_numpy(kv[0, 0]), rtol=2 ** -4, atol=0.51 * step)
    codes = tseq["k_pages"][live].float().abs().amax()
    assert codes == tq.get_spec(name).qmax  # some rows clipped


# ---- the engines ----

def _sc(mode, **kw):
    base = dict(max_batch=2, max_len=64, kv_layout="paged", page_size=8)
    if mode == "mixed":
        base["step_mode"] = "mixed"
    base.update(kw)
    return base


@pytest.mark.parametrize("mode", ["paged", "mixed"])
@pytest.mark.parametrize("name", FORMATS)
def test_engine_pools_and_tokens_match_reference(model, name, mode):
    jcfg, jp, tcfg, tp = model
    prompts = _prompts(jcfg.vocab_size, (5, 9, 13, 7), 7)
    sc = _sc(mode, kv_dtype=name)
    je = JEngine(jp, jcfg, JServeConfig(**sc))
    want = je.serve(prompts, 8)
    te = Engine(tp, tcfg, ServeConfig(**sc), device="cpu")
    got = te.serve(prompts, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    used = [p for p in range(te._alloc.n_pages) if te._alloc._ref[p] > 0]
    assert used == [p for p in range(je._alloc.n_pages) if je._alloc._ref[p] > 0] and used
    te._alloc.check(te._paged.cache)
    for leaf in ("k_pages", "v_pages", "k_scale", "v_scale"):
        t = te._paged.cache["blocks"]["pos0"][leaf][:, used]
        j = np.asarray(je._paged_cache["blocks"]["pos0"][leaf])[:, used]
        if leaf.endswith("pages"):
            assert t.dtype == tq.get_spec(name).dtype
            np.testing.assert_array_equal(_bytes(t), _bytes(j), err_msg=leaf)
        else:
            np.testing.assert_allclose(t.numpy(), j, rtol=SCALE_RTOL, atol=0, err_msg=leaf)


@pytest.mark.parametrize("name", FORMATS)
def test_sequential_and_packed_serves_agree(model, name):
    """The reference's `test_write_determinism_sequential_vs_packed` on the
    port: the paged loop and the mixed loop serve the same tokens from the
    same quantized pool format."""
    jcfg, _, tcfg, tp = model
    prompts = _prompts(jcfg.vocab_size, (7, 11, 5), 3)
    seq = Engine(tp, tcfg, ServeConfig(**_sc("paged", kv_dtype=name)), device="cpu")
    mix = Engine(tp, tcfg, ServeConfig(**_sc("mixed", kv_dtype=name)), device="cpu")
    for a, b in zip(seq.serve(prompts, 6), mix.serve(prompts, 6)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["paged", "mixed"])
def test_radix_warm_hit_token_identical_int8(model, mode):
    jcfg, _, tcfg, tp = model
    prompts = _prompts(jcfg.vocab_size, (17, 11, 21), 5)
    eng = Engine(tp, tcfg, ServeConfig(**_sc(mode, kv_dtype="int8")), device="cpu")
    cold = eng.serve(prompts, 6)
    warm = eng.serve(prompts, 6)
    assert eng.stats()["hit_tokens"] > 0
    for a, b in zip(cold, warm):
        np.testing.assert_array_equal(a, b)
    eng._alloc.check(eng._paged.cache)


@pytest.mark.parametrize("name", ["", "int8", "fp8"])
def test_stats_pool_bytes_match_reference(model, name):
    """kv_pool_bytes and kv_bytes_per_token count the pages and the scale
    side-band, as the reference's stats() does."""
    jcfg, jp, tcfg, tp = model
    prompt = _prompts(jcfg.vocab_size, (6,), 1)
    sc = dict(max_batch=2, max_len=32, kv_layout="paged", kv_dtype=name)
    je = JEngine(jp, jcfg, JServeConfig(**sc))
    te = Engine(tp, tcfg, ServeConfig(**sc), device="cpu")
    je.serve(prompt, 2)
    te.serve(prompt, 2)
    js, ts = je.stats(), te.stats()
    for key in ("kv_pool_bytes", "kv_bytes_per_token", "kv_dtype"):
        assert ts[key] == js[key], key
    lay = te._page_layout
    hkv, hd, n_layers = tcfg.n_kv_heads, tcfg.head_dim_, tcfg.n_layers
    per_page = 2 * n_layers * hkv * (lay.page_size * hd * (1 if name else 4) + (4 if name else 0))
    assert ts["kv_pool_bytes"] == per_page * lay.n_pages


def test_allocator_check_validates_scales(model):
    jcfg, _, tcfg, tp = model
    eng = Engine(tp, tcfg, ServeConfig(**_sc("paged", kv_dtype="int8", page_size=4)),
                 device="cpu")
    eng.serve(_prompts(jcfg.vocab_size, (7, 11, 5), 7), 4)
    alloc, cache = eng._alloc, eng._paged.cache
    alloc.check(cache)  # a healthy pool passes
    in_use = [pid for pid in range(alloc.n_pages) if alloc._ref[pid] > 0]
    assert in_use, "the radix cache retains pages"
    with torch.inference_mode():  # the engine's pool is an inference tensor
        cache["blocks"]["pos0"]["v_scale"][1, in_use[0], 0] = -1.0
    with pytest.raises(AssertionError, match="non-positive"):
        alloc.check(cache)


# ---- K3's and K4's plain versions on an fp8 pool ----

def _fp8_pool(rng, n_pages, page, hkv, d):
    """An fp8 pool quantized from f32 rows by the reference, with its scales."""
    spec = jq.get_spec("fp8")
    out = []
    for _ in range(2):
        x = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
        sc = jq.slot0_scale(jnp.asarray(x[:, 0]), spec)
        out += [jq.quantize_rows(jnp.asarray(x), sc[:, None], spec), sc]
    return out  # k, k_scale, v, v_scale


@pytest.mark.parametrize("group,page,window", [(1, 4, 0), (2, 8, 0), (4, 16, 9)])
def test_paged_decode_plain_on_fp8_matches_reference(group, page, window):
    rng = np.random.default_rng(group * 7 + page)
    hkv, d, n_tbl, lengths = 2, 16, 4, [1, page + 1, 3 * page, 4 * page]
    n_pages = len(lengths) * n_tbl + 1
    k, ks, v, vs = _fp8_pool(rng, n_pages, page, hkv, d)
    tbl = (rng.permutation(n_pages - 1)[: len(lengths) * n_tbl] + 1).reshape(-1, n_tbl)
    for i, n in enumerate(lengths):
        tbl[i, -(-n // page):] = 0
    tbl = tbl.astype(np.int32)
    q = rng.standard_normal((len(lengths), hkv * group, d)).astype(np.float32)
    cl = np.asarray(lengths, np.int32)
    want = np.asarray(flashd_decode_paged_pallas(
        jnp.asarray(q), k, v, jnp.asarray(tbl), jnp.asarray(cl), window=window,
        k_scale=ks, v_scale=vs, interpret=True))
    got = flashd_decode_paged_plain(torch.from_numpy(q), _to_torch(k), _to_torch(v),
                                    torch.from_numpy(tbl), torch.from_numpy(cl), window=window,
                                    k_scale=_to_torch(ks), v_scale=_to_torch(vs))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("group,page,block_q", [(1, 4, 8), (2, 8, 8), (4, 16, 16)])
def test_varlen_plain_on_fp8_matches_reference(group, page, block_q):
    """A pack of a prompt chunk, a K + 1-row verify segment, a decode row
    and a padding block over an fp8 pool."""
    rng = np.random.default_rng(group * 5 + page)
    hkv, d, n_tbl = 2, 16, 4
    lengths = [2 * page + 3, 3 * page, page]
    n_pages = len(lengths) * n_tbl + 1
    k, ks, v, vs = _fp8_pool(rng, n_pages, page, hkv, d)
    tbl = (rng.permutation(n_pages - 1)[: len(lengths) * n_tbl] + 1).reshape(-1, n_tbl)
    for i, n in enumerate(lengths):
        tbl[i, -(-n // page):] = 0
    tbl = tbl.astype(np.int32)
    seq_ids, q_pos = [], []
    for s, (n, r) in enumerate(zip(lengths, [9, 5, 1])):
        pad = -r % block_q
        seq_ids += [s] * r + [-1] * pad
        q_pos += list(range(n - r, n)) + [-1] * pad
    seq_ids = np.asarray(seq_ids + [-1] * block_q, np.int32)
    q_pos = np.asarray(q_pos + [-1] * block_q, np.int32)
    kv_len = np.asarray(lengths, np.int32)
    q = rng.standard_normal((len(seq_ids), hkv * group, d)).astype(np.float32)
    want = np.asarray(flashd_varlen_pallas(
        jnp.asarray(q), k, v, jnp.asarray(tbl), jnp.asarray(seq_ids), jnp.asarray(q_pos),
        jnp.asarray(kv_len), block_q=block_q, k_scale=ks, v_scale=vs, interpret=True))
    got = flashd_varlen_plain(torch.from_numpy(q), _to_torch(k), _to_torch(v),
                              torch.from_numpy(tbl), torch.from_numpy(seq_ids),
                              torch.from_numpy(q_pos), torch.from_numpy(kv_len), block_q=block_q,
                              k_scale=_to_torch(ks), v_scale=_to_torch(vs))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert (got[torch.from_numpy(q_pos) < 0] == 0).all()
