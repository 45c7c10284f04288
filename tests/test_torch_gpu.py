"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the `gpu` marker and skips without a CUDA device.
This file imports torch and the port only, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: O and Λ within 5e-5 in f32 (summation order only); bf16 O
within 2e-2 (one bf16 rounding of |O| < 4); engine tokens identical.
Gradients (K5) within rtol 1e-4 / atol 1e-5 in f32 — the reference's own
kernel-vs-autodiff bound — and in bf16 within 2^-7 of the largest
gradient entry (one bf16 rounding of the output, either way)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import blockwise as tb
from repro_torch.core.attention import flash_attention
from repro_torch.kernels import fa2_fwd as k6
from repro_torch.kernels import flashd_bwd as k5
from repro_torch.kernels import flashd_decode as k2
from repro_torch.kernels import flashd_fwd as k1
from repro_torch.kernels import flashd_varlen as k4
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models.transformer import apply_lm, init_lm
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.tree import tree_leaves

TOL = 5e-5
BF16_TOL = 2e-2

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: python -m pytest -m gpu "
                    "tests/test_torch_gpu.py")
    return torch.device("cuda")


def _close(a, b, tol=TOL):
    torch.cuda.synchronize()
    err = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
    assert err <= tol, err


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
@pytest.mark.parametrize("d", [32, 48, 64, 128])
def test_fwd_kernel_matches_plain(cuda, case, d):
    kind, window, chunk, q_offset, skip = case
    gen = torch.Generator(device=cuda).manual_seed(d)
    b, hkv, g, sq, skv = 2, 2, 2, 150, 170
    q = torch.randn(b, sq, hkv * g, d, generator=gen, device=cuda)
    k = torch.randn(b, skv, hkv, d, generator=gen, device=cuda)
    v = torch.randn(b, skv, hkv, d, generator=gen, device=cuda)
    m = tb.MaskSpec(kind, window, chunk, q_offset)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))  # model layout, no copy
    o, lam = k1.flashd_fwd(*args, mask=m, skip=skip, block_k=64)
    o_p, lam_p = k1.flashd_fwd_plain(*args, mask=m, skip=skip, block_k=64)
    _close(o, o_p)
    _close(lam, lam_p)
    assert o.transpose(1, 2).is_contiguous()  # written in the model layout
    if q_offset < 0:
        assert (o[:, :, :-q_offset] == 0).all() and (lam[:, :, :-q_offset] == tb.NEG_INF).all()
    ob, _ = k1.flashd_fwd(*(x.bfloat16() for x in args), mask=m, skip=skip)
    ob_p, _ = k1.flashd_fwd_plain(*(x.bfloat16() for x in args), mask=m, skip=skip, block_k=64)
    assert ob.dtype == torch.bfloat16
    _close(ob, ob_p, BF16_TOL)


@pytest.mark.parametrize("block_k", [16, 33, 64])
def test_fwd_kernel_block_k(cuda, block_k):
    gen = torch.Generator(device=cuda).manual_seed(block_k)
    q = torch.randn(1, 2, 100, 64, generator=gen, device=cuda)
    k = torch.randn(1, 1, 100, 64, generator=gen, device=cuda)
    o, lam = k1.flashd_fwd(q, k, k, block_k=block_k, skip=True)
    o_p, lam_p = k1.flashd_fwd_plain(q, k, k, block_k=block_k, skip=True)
    _close(o, o_p)
    _close(lam, lam_p)


BWD_CASES = [
    # (mask kind, window, chunk, q_offset, group, sq, skv)
    ("causal", 0, 0, 0, 2, 150, 150),
    ("full", 0, 0, 0, 1, 70, 170),
    ("local", 9, 0, 0, 4, 130, 130),
    ("chunked", 0, 16, 0, 2, 100, 100),
    ("causal", 0, 0, 20, 2, 80, 100),  # a q block of a longer sequence
    ("causal", 0, 0, -12, 2, 90, 90),  # dead leading rows
]


def _grads_close(got, ref, dtype):
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)
        else:
            _close(a, r, 2.0 ** -7 * float(r.float().abs().max()))


def _bwd_operands(gen, dev, b, hkv, g, sq, skv, d, mask, dtype):
    q = torch.randn(b, sq, hkv * g, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    k = torch.randn(b, skv, hkv, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    v = torch.randn(b, skv, hkv, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    do = torch.randn(b, sq, hkv * g, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    o, lam = k1.flashd_fwd_plain(q, k, v, mask=mask)
    return q, k, v, o, lam, do


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain(cuda, case, dtype):
    kind, window, chunk, q_offset, g, sq, skv = case
    gen = torch.Generator(device=cuda).manual_seed(sq + skv)
    m = tb.MaskSpec(kind, window, chunk, q_offset)
    args = _bwd_operands(gen, cuda, 2, 2, g, sq, skv, 64, m, dtype)
    got = k5.flashd_bwd(*args, mask=m)
    _grads_close(got, k5.flashd_bwd_plain(*args, mask=m), dtype)
    for x in got:  # written in the model layout
        assert x.transpose(1, 2).is_contiguous()
    if q_offset < 0:  # dead rows: P = 0, so no gradient flows through them
        assert (got[0][:, :, :-q_offset] == 0).all()


@pytest.mark.parametrize("d", [32, 48, 128])
def test_bwd_kernel_head_dims(cuda, d):
    gen = torch.Generator(device=cuda).manual_seed(d)
    m = tb.MaskSpec("causal")
    args = _bwd_operands(gen, cuda, 1, 2, 2, 97, 97, d, m, torch.float32)
    _grads_close(k5.flashd_bwd(*args, mask=m), k5.flashd_bwd_plain(*args, mask=m), torch.float32)


def test_bwd_kernel_is_deterministic(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    m = tb.MaskSpec("causal")
    args = _bwd_operands(gen, cuda, 2, 2, 4, 200, 200, 64, m, torch.float32)
    first = k5.flashd_bwd(*args, mask=m)
    for a, b_ in zip(first, k5.flashd_bwd(*args, mask=m)):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("case", FWD_CASES)
def test_fa2_kernel_matches_plain_and_k1(cuda, case):
    kind, window, chunk, q_offset, _ = case  # FA2 has no skip
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, hkv, g, sq, skv, d = 2, 2, 2, 150, 170, 128
    args = tuple(torch.randn(b, s_, h, d, generator=gen, device=cuda).transpose(1, 2)
                 for s_, h in ((sq, hkv * g), (skv, hkv), (skv, hkv)))
    m = tb.MaskSpec(kind, window, chunk, q_offset)
    o, lam = k6.fa2_fwd(*args, mask=m)
    o_p, lam_p = k6.fa2_fwd_plain(*args, mask=m)
    o_1, lam_1 = k1.flashd_fwd(*args, mask=m)
    _close(o, o_p)
    _close(lam, lam_p)
    _close(o, o_1)
    _close(lam, lam_1)
    if q_offset < 0:
        assert (o[:, :, :-q_offset] == 0).all() and (lam[:, :, :-q_offset] == tb.NEG_INF).all()
    ob, _ = k6.fa2_fwd(*(x.bfloat16() for x in args), mask=m)
    ob_p, _ = k6.fa2_fwd_plain(*(x.bfloat16() for x in args), mask=m)
    _close(ob, ob_p, BF16_TOL)


@pytest.mark.parametrize("impl", ["flashd_gpu", "fa2_gpu", "flashd", "fa2"])
def test_flash_attention_grads_on_the_kernel_route(cuda, impl):
    """The autograd Function on CUDA tensors: K1 or K6 forward, K5 backward,
    gradients equal to the plain route's."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(2, 133, 4, 64, generator=gen, device=cuda)
    k = torch.randn(2, 133, 2, 64, generator=gen, device=cuda)
    v = torch.randn(2, 133, 2, 64, generator=gen, device=cuda)
    w = torch.randn(2, 133, 4, 64, generator=gen, device=cuda)
    grads = {}
    for route in (impl, "flashd_plain"):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        before = (k1.launches, k5.launches, k6.launches)
        (flash_attention(*xs, impl=route) * w).sum().backward()
        after = (k1.launches, k5.launches, k6.launches)
        grads[route] = [x.grad for x in xs]
        if route == "flashd_plain":
            assert after == before
        else:
            fwd = 0 if impl.startswith("flashd") else 2
            assert after[fwd] == before[fwd] + 1 and after[1] == before[1] + 1
    _grads_close(grads[impl], grads["flashd_plain"], torch.float32)


DECODE_CASES = [
    # (n_splits, window, chunk, with start, fused)
    (None, 0, 0, False, True),
    (3, 0, 0, False, True),
    (3, 0, 0, False, False),
    (4, 6, 0, False, True),
    (2, 0, 8, False, False),
    (5, 0, 0, True, True),
    (1, 0, 0, False, True),
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("group", [1, 2, 8])
def test_decode_kernel_matches_plain(cuda, case, group):
    n_splits, window, chunk, with_start, fused = case
    gen = torch.Generator(device=cuda).manual_seed(group)
    b, hkv, s_max, d = 6, 2, 300, 128
    q = torch.randn(b, hkv * group, d, generator=gen, device=cuda)
    kc = torch.randn(b, s_max, hkv, d, generator=gen, device=cuda).transpose(1, 2)
    vc = torch.randn(b, s_max, hkv, d, generator=gen, device=cuda).transpose(1, 2)
    cl = torch.tensor([0, 1, 130, 257, 299, 300], dtype=torch.int32, device=cuda)
    start = (torch.tensor([0, 0, 40, 200, 10, 299], dtype=torch.int32, device=cuda)
             if with_start else None)
    kw = dict(window=window, chunk=chunk, start=start, fused=fused, return_lam=True,
              n_splits=k2.gpu_decode_splits(s_max) if n_splits is None else n_splits)
    o, lam = k2.flashd_decode(q, kc, vc, cl, **kw)
    o_p, lam_p = k2.flashd_decode_plain(q, kc, vc, cl, **kw)
    _close(o, o_p)
    _close(lam, lam_p)
    assert (o[0] == 0).all() and (lam[0] == tb.NEG_INF).all()
    ob = k2.flashd_decode(q.bfloat16(), kc.bfloat16(), vc.bfloat16(), cl, n_splits=kw["n_splits"])
    ob_p = k2.flashd_decode_plain(q.bfloat16(), kc.bfloat16(), vc.bfloat16(), cl,
                                  n_splits=kw["n_splits"])
    _close(ob, ob_p, BF16_TOL)


@pytest.mark.parametrize("d", [32, 48, 64])
def test_decode_kernel_head_dims(cuda, d):
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(3, 4, d, generator=gen, device=cuda)
    kc = torch.randn(3, 4, 77, d, generator=gen, device=cuda)
    cl = torch.tensor([77, 5, 40], dtype=torch.int32, device=cuda)
    _close(k2.flashd_decode(q, kc, kc, cl, n_splits=4), k2.flashd_decode_plain(q, kc, kc, cl, n_splits=4))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 2, 8, 96, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        k1.flashd_fwd(q, q, q)
    q = torch.randn(1, 2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        k1.flashd_fwd(q, q, q)
    q = torch.randn(1, 2, 8, 64, device=cuda, requires_grad=True)
    for fwd in (k1.flashd_fwd, k6.fa2_fwd):  # the gradient is flash_attention's Function
        with pytest.raises(RuntimeError, match="no backward of their own"):
            fwd(q, q, q)
    qd = torch.randn(1, 2, 64, device=cuda)
    kc = torch.randn(1, 2, 8, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward of their own"):
        k2.flashd_decode(qd, kc.requires_grad_(), kc, torch.tensor([3], device=cuda))
    kc = kc.detach()
    with pytest.raises(ValueError, match="tensor on"):
        k2.flashd_decode(qd, kc, kc, torch.tensor([3]))  # host lengths


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "paper-llama"])
def test_engine_kernel_path_matches_plain_path(cuda, arch):
    """Smoke widths, f32: the default impl launches both kernels and gives
    the plain path's greedy tokens."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_lm(cfg, device=cuda, seed=1)
    rng = np.random.default_rng(2)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32) for n in (5, 17, 9, 30)]
    sc = ServeConfig(max_batch=2, max_len=64, decode_chunk=3)
    k1.launches = k2.launches = 0
    toks = torch.as_tensor(np.stack([r[:5] for r in reqs]), device=cuda)
    with torch.inference_mode():
        logits, _ = apply_lm(params, {"tokens": toks}, cfg)
    got = Engine(params, cfg, sc, device=cuda).serve(reqs, 8)
    assert k1.launches > 0 and k2.launches > 0
    plain_cfg = dataclasses.replace(cfg, attn_impl="flashd_plain")
    before = (k1.launches, k2.launches)
    with torch.inference_mode():
        logits_p, _ = apply_lm(params, {"tokens": toks}, plain_cfg)
    want = Engine(params, plain_cfg, sc, device=cuda).serve(reqs, 8)
    assert (k1.launches, k2.launches) == before  # the plain path launches nothing
    _close(logits[..., :cfg.vocab_size], logits_p[..., :cfg.vocab_size], 1e-4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---- K3 (paged decode) and K4 (packed varlen) ----

def _paged_pool(gen, dev, lengths, n_tbl, page, hkv, d, dtype=torch.float32):
    """A pool of distinct shuffled pages, page 0 (the garbage page every
    dead table slot points at) filled with NaN — or, for int8, NaN scales."""
    b = len(lengths)
    n_pages = b * n_tbl + 1
    shape = (n_pages, page, hkv, d)
    if dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        ks = torch.rand(n_pages, hkv, generator=gen, device=dev) / 64 + 1e-3
        vs = torch.rand(n_pages, hkv, generator=gen, device=dev) / 64 + 1e-3
        ks[0] = vs[0] = float("nan")
    else:
        kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
        vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
        kp[0] = vp[0] = float("nan")
        ks = vs = None
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tbl = perm.reshape(b, n_tbl).to(torch.int32)
    for i, n in enumerate(lengths):
        tbl[i, -(-n // page):] = 0  # slots past the live pages: the garbage page
    return kp, vp, tbl, ks, vs


PAGED_CASES = [
    # (group, page, window, chunk)
    (1, 4, 0, 0),
    (2, 8, 0, 0),
    (2, 64, 0, 0),
    (4, 16, 11, 0),
    (8, 8, 0, 12),
    (2, 128, 0, 0),
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_decode_kernel_matches_plain(cuda, case):
    group, page, window, chunk = case
    gen = torch.Generator(device=cuda).manual_seed(page * 10 + group)
    hkv, d, n_tbl = 2, 128, 6
    full = n_tbl * page
    lengths = [0, 1, page, page + 1, full - 1, full]
    cl = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn(len(lengths), hkv * group, d, generator=gen, device=cuda)
    kp, vp, tbl, _, _ = _paged_pool(gen, cuda, lengths, n_tbl, page, hkv, d)
    kw = dict(window=window, chunk=chunk)
    k2.paged_launches = 0
    o = k2.flashd_decode_paged(q, kp, vp, tbl, cl, **kw)
    assert k2.paged_launches == 1
    o_p = k2.flashd_decode_paged_plain(q, kp, vp, tbl, cl, **kw)
    assert torch.isfinite(o).all()
    _close(o, o_p)
    assert (o[0] == 0).all()
    kb, vb = kp.bfloat16(), vp.bfloat16()
    _close(k2.flashd_decode_paged(q.bfloat16(), kb, vb, tbl, cl, **kw),
           k2.flashd_decode_paged_plain(q.bfloat16(), kb, vb, tbl, cl, **kw), BF16_TOL)
    ki, vi, tbl_i, ks, vs = _paged_pool(gen, cuda, lengths, n_tbl, page, hkv, d, torch.int8)
    oi = k2.flashd_decode_paged(q, ki, vi, tbl_i, cl, k_scale=ks, v_scale=vs, **kw)
    assert torch.isfinite(oi).all()
    _close(oi, k2.flashd_decode_paged_plain(q, ki, vi, tbl_i, cl, k_scale=ks, v_scale=vs, **kw))


def _pack(lengths, seg_rows, block_q):
    """seq_ids / q_pos of a pack: per sequence s, its last seg_rows[s] positions
    (a whole prompt, a mid-sequence chunk, a 1-row decode, a verify chain),
    each segment padded to block_q, then one all-padding block."""
    seq_ids, q_pos = [], []
    for s, (n, r) in enumerate(zip(lengths, seg_rows)):
        if r == 0:
            continue
        pad = (-r) % block_q
        seq_ids += [s] * r + [-1] * pad
        q_pos += list(range(n - r, n)) + [-1] * pad
    seq_ids += [-1] * block_q
    q_pos += [-1] * block_q
    return seq_ids, q_pos


VARLEN_CASES = [
    # (group, page, block_q, window, chunk)
    (1, 8, 8, 0, 0),
    (2, 16, 8, 0, 0),
    (2, 64, 16, 0, 0),
    (4, 4, 16, 9, 0),
    (8, 8, 8, 0, 10),
    (2, 128, 8, 0, 0),
]


@pytest.mark.parametrize("case", VARLEN_CASES)
def test_varlen_kernel_matches_plain(cuda, case):
    group, page, block_q, window, chunk = case
    gen = torch.Generator(device=cuda).manual_seed(page * 100 + block_q + group)
    hkv, d, n_tbl = 2, 128, 8
    lengths = [37, page * 2 + 5, 1, 150 % (n_tbl * page) + 1, 0, n_tbl * page]
    seg_rows = [37, 16, 1, 5, 0, 3]  # whole prompt, chunk, decode, verify, absent, tail
    seq_ids, q_pos = _pack(lengths, [min(r, n) for r, n in zip(seg_rows, lengths)], block_q)
    t = len(seq_ids)
    sid = torch.tensor(seq_ids, dtype=torch.int32, device=cuda)
    qp = torch.tensor(q_pos, dtype=torch.int32, device=cuda)
    kvl = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn(t, hkv * group, d, generator=gen, device=cuda)
    kp, vp, tbl, _, _ = _paged_pool(gen, cuda, lengths, n_tbl, page, hkv, d)
    kw = dict(window=window, chunk=chunk, block_q=block_q)
    k4.launches = 0
    o = k4.flashd_varlen(q, kp, vp, tbl, sid, qp, kvl, **kw)
    assert k4.launches == 1
    o_p = k4.flashd_varlen_plain(q, kp, vp, tbl, sid, qp, kvl, **kw)
    assert torch.isfinite(o).all()
    _close(o, o_p)
    assert (o[qp < 0] == 0).all()  # padding rows: exact zeros
    kb, vb = kp.bfloat16(), vp.bfloat16()
    ob = k4.flashd_varlen(q.bfloat16(), kb, vb, tbl, sid, qp, kvl, **kw)
    _close(ob, k4.flashd_varlen_plain(q.bfloat16(), kb, vb, tbl, sid, qp, kvl, **kw), BF16_TOL)
    assert (ob[qp < 0] == 0).all()
    ki, vi, tbl_i, ks, vs = _paged_pool(gen, cuda, lengths, n_tbl, page, hkv, d, torch.int8)
    oi = k4.flashd_varlen(q, ki, vi, tbl_i, sid, qp, kvl, k_scale=ks, v_scale=vs, **kw)
    assert torch.isfinite(oi).all()
    _close(oi, k4.flashd_varlen_plain(q, ki, vi, tbl_i, sid, qp, kvl, k_scale=ks, v_scale=vs,
                                      **kw))


def test_paged_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(2, 4, 64, device=cuda)
    kp = torch.randn(5, 8, 2, 64, device=cuda)
    tbl = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    cl = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        k2.flashd_decode_paged(q, kp, kp, tbl.long(), cl)
    with pytest.raises(ValueError, match="int8"):
        k2.flashd_decode_paged(q, kp.to(torch.int8), kp.to(torch.int8), tbl, cl)
    with pytest.raises(ValueError, match="multiple of block_q"):
        k4.flashd_varlen(q[:1].expand(6, 4, 64), kp, kp, tbl, cl.new_zeros(6), cl.new_zeros(6),
                         cl, block_q=4)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "paper-llama"])
@pytest.mark.parametrize("mode", [dict(kv_layout="paged"), dict(step_mode="mixed"),
                                  dict(step_mode="mixed", kv_pool_tokens=96, page_size=8)])
def test_paged_and_mixed_engines_kernel_path_match_plain(cuda, arch, mode):
    """Smoke widths, f32: the paged and mixed loops launch K3 (and K4 in the
    mixed loop), give the plain path's and the contiguous loop's tokens,
    and leave the allocator consistent."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_lm(cfg, device=cuda, seed=1)
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32) for n in (5, 37, 9, 30)]
    sc = ServeConfig(max_batch=2, max_len=64, decode_chunk=3, prefix_cache=False, **mode)
    base = Engine(params, cfg, ServeConfig(max_batch=2, max_len=64, decode_chunk=3),
                  device=cuda).serve(reqs, 8)
    k2.paged_launches = k4.launches = 0
    eng = Engine(params, cfg, sc, device=cuda)
    got = eng.serve(reqs, 8)
    eng._alloc.check()
    assert k2.paged_launches > 0
    assert (k4.launches > 0) == (sc.step_mode == "mixed")
    before = (k2.paged_launches, k4.launches)
    plain_cfg = dataclasses.replace(cfg, attn_impl="flashd_plain")
    want = Engine(params, plain_cfg, sc, device=cuda).serve(reqs, 8)
    assert (k2.paged_launches, k4.launches) == before
    for g, w, c in zip(got, want, base):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, c)


@pytest.mark.parametrize("impl", ["flashd_gpu", "fa2_gpu"])
def test_train_step_kernel_path_matches_plain(cuda, impl):
    """One qwen3-0.6b SMOKE train step (f32): K1 or K6 forward and K5
    backward against the plain path — loss and grad norm within 1e-5
    relative, the AdamW update within 1e-3 of its size."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype="float32")
    tc = TrainConfig(warmup_steps=0)
    state0 = init_train_state(cfg, tc, device=cuda, seed=0)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=100, global_batch=2))
    batch = {k: torch.as_tensor(x, device=cuda) for k, x in data.batch(0).items()}
    runs = {}
    for route in (impl, "flashd_plain"):
        before = (k1.launches, k5.launches, k6.launches)
        runs[route] = make_train_step(dataclasses.replace(cfg, attn_impl=route), tc)(state0, batch)
        launched = [a - b for a, b in zip((k1.launches, k5.launches, k6.launches), before)]
        fwd = 0 if impl == "flashd_gpu" else 2
        if route == impl:  # remat 'full': the forward runs again in the backward
            assert launched[fwd] == 2 * cfg.n_layers and launched[1] == cfg.n_layers
        else:
            assert launched == [0, 0, 0]
    (sk, mk), (sp, mp) = runs[impl], runs["flashd_plain"]
    for key in ("loss", "grad_norm"):
        assert abs(float(mk[key]) - float(mp[key])) <= 1e-5 * abs(float(mp[key])), key
    dev = sum(float(((a - b) ** 2).sum()) for a, b in zip(tree_leaves(sk.params),
                                                          tree_leaves(sp.params))) ** 0.5
    upd = sum(float(((b - c) ** 2).sum()) for b, c in zip(tree_leaves(sp.params),
                                                          tree_leaves(state0.params))) ** 0.5
    assert dev <= 1e-3 * upd, (dev, upd)
