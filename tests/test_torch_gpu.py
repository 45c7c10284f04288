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
from repro_torch.core.attention import gather_pages as tb_gather
from repro_torch.kernels import fa2_fwd as k6
from repro_torch.kernels import flashd_bwd as k5
from repro_torch.kernels import flashd_decode as k2
from repro_torch.kernels import flashd_fwd as k1
from repro_torch.kernels import flashd_varlen as k4
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models.transformer import apply_lm, init_lm
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.engine import pack_plan
from repro_torch.serve.scheduler import Segment, StepPlan
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 48, 64, 128])
def test_bwd_kernel_head_dims(cuda, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(d)
    m = tb.MaskSpec("causal")
    args = _bwd_operands(gen, cuda, 1, 2, 2, 97, 97, d, m, dtype)
    _grads_close(k5.flashd_bwd(*args, mask=m), k5.flashd_bwd_plain(*args, mask=m), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_is_deterministic(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    m = tb.MaskSpec("causal")
    args = _bwd_operands(gen, cuda, 2, 2, 4, 200, 200, 64, m, dtype)
    first = k5.flashd_bwd(*args, mask=m)
    for a, b_ in zip(first, k5.flashd_bwd(*args, mask=m)):
        assert torch.equal(a, b_)


def _bwd_f64(q, k, v, o, lam, do, mask):
    """K5's formula evaluated exactly (float64) on the same inputs: P =
    e^{s − Λ} (0 where masked or dead), dS = P∘(dO·Vᵀ − D)·scale, D =
    rowsum(dO∘O); dK and dV summed over each kv head's group."""
    g = q.shape[1] // k.shape[1]
    qd, od, dod = (x.double() for x in (q, o, do))
    kd, vd = (x.double().repeat_interleave(g, 1) for x in (k, v))
    scale = q.shape[-1] ** -0.5
    keep = mask.keep(torch.arange(q.shape[2], device=q.device),
                     torch.arange(k.shape[2], device=q.device))
    lamd = lam.double()[..., None]
    s = qd @ kd.transpose(-1, -2) * scale
    p = torch.where(keep & (lamd > tb.NEG_INF / 2), torch.exp(s - lamd), torch.zeros_like(s))
    ds = p * (dod @ vd.transpose(-1, -2) - (dod * od).sum(-1, keepdim=True)) * scale
    fold = lambda x: x.unflatten(1, (k.shape[1], g)).sum(2)
    return ds @ kd, fold(ds.transpose(-1, -2) @ qd), fold(p.transpose(-1, -2) @ dod)


def _excess(a, exact):
    """The largest error beyond rtol·|exact|: what atol must cover."""
    return float(((a.double() - exact).abs() - 1e-4 * exact.abs()).max())


def test_bwd_kernel_holds_f32_at_large_scores(cuda):
    """q and k scaled ×4 (scores up to ±60), f32, S 512, G 2. Any f32
    evaluation of the backward is ~1e-4 off there (the CPU test
    tests/test_torch_tc_bwd_numerics.py shows the reference's own), so the
    kernel and the plain version are both held against the exact (float64)
    evaluation of the formula on the same inputs: the kernel's excess over
    rtol 1e-4 stays within atol 1e-5 or within the plain version's own."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    m = tb.MaskSpec("causal")
    q = torch.randn(1, 512, 4, 128, generator=gen, device=cuda).transpose(1, 2) * 4
    k = torch.randn(1, 512, 2, 128, generator=gen, device=cuda).transpose(1, 2) * 4
    v = torch.randn(1, 512, 2, 128, generator=gen, device=cuda).transpose(1, 2)
    do = torch.randn(1, 512, 4, 128, generator=gen, device=cuda).transpose(1, 2)
    o, lam = k1.flashd_fwd_plain(q, k, v, mask=m)
    args = (q, k, v, o, lam, do)
    for got, plain, exact in zip(k5.flashd_bwd(*args, mask=m), k5.flashd_bwd_plain(*args, mask=m),
                                 _bwd_f64(*args, m)):
        assert _excess(got, exact) <= max(1e-5, _excess(plain, exact)), (
            _excess(got, exact), _excess(plain, exact))


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


TC_FWD = [(k1.flashd_fwd, k1.flashd_fwd_plain), (k6.fa2_fwd, k6.fa2_fwd_plain)]


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("sq, skv", [(1, 1), (63, 63), (65, 65), (200, 1000)])
def test_tc_fwd_kernels_ragged_tiles_and_groups(cuda, sq, skv, group):
    """K1 and K6 (tensor cores) at lengths that are not multiples of the
    64-row q block and the 64-key tile, every GQA group the models use;
    causal as a chunk at the end of the keys, and full."""
    gen = torch.Generator(device=cuda).manual_seed(sq * 8 + group)
    hkv, d = 2, 128
    args = tuple(torch.randn(2, s_, h, d, generator=gen, device=cuda).transpose(1, 2)
                 for s_, h in ((sq, hkv * group), (skv, hkv), (skv, hkv)))
    for m in (tb.MaskSpec("causal", q_offset=skv - sq), tb.MaskSpec("full")):
        for fwd, plain in TC_FWD:
            o, lam = fwd(*args, mask=m)
            o_p, lam_p = plain(*args, mask=m)
            _close(o, o_p)
            _close(lam, lam_p)
            ob, _ = fwd(*(x.bfloat16() for x in args), mask=m)
            ob_p, _ = plain(*(x.bfloat16() for x in args), mask=m)
            _close(ob, ob_p, BF16_TOL)


def _attention_f64(q, k, v, mask):
    """Softmax attention in float64 (GQA), the truth at large scores."""
    g = q.shape[1] // k.shape[1]
    kd, vd = (x.double().repeat_interleave(g, 1) for x in (k, v))
    s = q.double() @ kd.transpose(-1, -2) / q.shape[-1] ** 0.5
    keep = mask.keep(torch.arange(q.shape[2], device=q.device),
                     torch.arange(k.shape[2], device=q.device))
    s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, -1) @ vd, torch.logsumexp(s, -1)


def test_tc_fwd_kernels_hold_f32_at_large_scores(cuda):
    """q and k scaled ×4 (scores up to ±60), f32, S 1024: one-pass TF32
    would be ~1e-2 off (tests/test_torch_tc_numerics.py); the 3xTF32 split
    holds 5e-5. Held against float64: at these scores the plain version's
    own f32 arithmetic is ~4e-5 from the truth, so both kernels are also
    held to be no farther from it than the plain version is."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(1, 1024, 4, 128, generator=gen, device=cuda).transpose(1, 2) * 4
    k = torch.randn(1, 1024, 2, 128, generator=gen, device=cuda).transpose(1, 2) * 4
    v = torch.randn(1, 1024, 2, 128, generator=gen, device=cuda).transpose(1, 2)
    m = tb.MaskSpec("causal")
    o_t, lam_t = _attention_f64(q, k, v, m)
    o_p, lam_p = k1.flashd_fwd_plain(q, k, v, mask=m)
    plain_err = max(float((o_p - o_t).abs().max()), float((lam_p - lam_t).abs().max()))
    for fwd, _ in TC_FWD:
        o, lam = fwd(q, k, v, mask=m)
        err = max(float((o - o_t).abs().max()), float((lam - lam_t).abs().max()))
        assert err <= min(TOL, plain_err), (fwd.__name__, err, plain_err)


def test_tc_fwd_kernels_on_a_q_offset_view(cuda):
    """A q block of Sq < Skv as a strided view (`qt[:, :, 1024:]`, as chip
    smoke phase 3), causal with q_offset, f32 and bf16."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(1, 2048, 4, 128, generator=gen, device=cuda)
    k = torch.randn(1, 2048, 2, 128, generator=gen, device=cuda)
    v = torch.randn(1, 2048, 2, 128, generator=gen, device=cuda)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    m = tb.MaskSpec("causal", q_offset=1024)
    for fwd, plain in TC_FWD:
        for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
            args = (qt.to(dtype)[:, :, 1024:], kt.to(dtype), vt.to(dtype))
            o, lam = fwd(*args, mask=m)
            o_p, lam_p = plain(*args, mask=m)
            _close(o, o_p, tol)
            _close(lam, lam_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tc_fwd_kernels_are_deterministic(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(9)
    args = tuple(torch.randn(2, 300, h, 128, generator=gen, device=cuda).to(dtype).transpose(1, 2)
                 for h in (8, 2, 2))
    for fwd, _ in TC_FWD:
        o, lam = fwd(*args)
        o2, lam2 = fwd(*args)
        assert torch.equal(o, o2) and torch.equal(lam, lam2), fwd.__name__


def test_tc_fwd_wrappers_refuse_unaligned_views(cuda):
    """The 16-byte asynchronous copies need 16-byte bases and strides: a
    view whose row stride is 33 floats (132 bytes) raises, launching
    nothing."""
    x = torch.randn(1, 2, 40, 33, device=cuda)[..., :32]
    ok = torch.randn(1, 2, 40, 32, device=cuda)
    for fwd, _ in TC_FWD:
        mod = k1 if fwd is k1.flashd_fwd else k6
        before = mod.launches
        for args in ((x, ok, ok), (ok, x, ok), (ok, ok, x)):
            with pytest.raises(ValueError, match="16 bytes"):
                fwd(*args)
        off = torch.randn(1, 2, 40 * 32 + 1, device=cuda).bfloat16()[..., 1:]
        with pytest.raises(ValueError, match="16 bytes"):  # a base off by one bf16
            fwd(off.reshape(1, 2, 40, 32), ok.bfloat16(), ok.bfloat16())
        assert mod.launches == before


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
              n_splits=k2.gpu_decode_splits(b, hkv, s_max) if n_splits is None else n_splits)
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


K2_SWEEP = [(b, s_max) for b in (1, 4, 32) for s_max in (1, 64, 512, 4096)]


@pytest.mark.parametrize("b, s_max", K2_SWEEP)
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_decode_kernel_default_splits_sweep(cuda, b, s_max, group):
    """K2 at its own split choice (`gpu_decode_splits` for this card)
    against the plain version at the same splits: cache_len 0, 1, full and
    a ragged one; head dims 32, 48, 64, 128; f32 and bf16; fused and
    unfused; an empty row exactly 0 / NEG_INF."""
    gen = torch.Generator(device=cuda).manual_seed(b * 10_000 + s_max + group)
    hkv = 2
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = k2.gpu_decode_splits(b, hkv, s_max, n_sm)
    pattern = [0, 1, s_max, max(1, 2 * s_max // 3)]
    lengths = [[x] for x in pattern[:3]] if b == 1 else [[pattern[i % 4] for i in range(b)]]
    for d in (32, 48, 64, 128):
        q = torch.randn(b, hkv * group, d, generator=gen, device=cuda)
        kc = torch.randn(b, s_max, hkv, d, generator=gen, device=cuda).transpose(1, 2)
        vc = torch.randn(b, s_max, hkv, d, generator=gen, device=cuda).transpose(1, 2)
        for lens in lengths:
            cl = torch.tensor(lens, dtype=torch.int32, device=cuda)
            for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
                x = (q.to(dtype), kc.to(dtype), vc.to(dtype))
                for fused in (True, False):
                    o, lam = k2.flashd_decode(*x, cl, fused=fused, return_lam=True)
                    o_p, lam_p = k2.flashd_decode_plain(*x, cl, n_splits=n, fused=fused,
                                                        return_lam=True)
                    _close(o, o_p, tol)
                    if dtype == torch.float32:
                        _close(lam, lam_p)
                    empty = cl == 0
                    assert (o[empty] == 0).all() and (lam[empty] == tb.NEG_INF).all()


def test_decode_kernel_is_bitwise_repeatable(cuda):
    """The fused merge runs in split order whichever CTA arrives last."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(4, 16, 128, generator=gen, device=cuda)
    kc = torch.randn(4, 512, 8, 128, generator=gen, device=cuda).transpose(1, 2)
    vc = torch.randn(4, 512, 8, 128, generator=gen, device=cuda).transpose(1, 2)
    cl = torch.tensor([512, 300, 17, 1], dtype=torch.int32, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        x = (q.to(dtype), kc.to(dtype), vc.to(dtype))
        o, lam = k2.flashd_decode(*x, cl, return_lam=True)
        for _ in range(3):
            o2, lam2 = k2.flashd_decode(*x, cl, return_lam=True)
            assert torch.equal(o, o2) and torch.equal(lam, lam2)


def test_decode_wrapper_refuses_unaligned_views(cuda):
    """K2 copies 16-byte rows: a cache whose row stride is 129 floats, or
    a q whose base is one bf16 off, raises and launches nothing."""
    q = torch.randn(2, 4, 128, device=cuda)
    ok = torch.randn(2, 64, 2, 128, device=cuda).transpose(1, 2)
    bad = torch.randn(2, 64, 2, 129, device=cuda)[..., :128].transpose(1, 2)
    cl = torch.tensor([64, 10], dtype=torch.int32, device=cuda)
    before = k2.launches
    for args in ((q, bad, ok), (q, ok, bad)):
        with pytest.raises(ValueError, match="16 bytes"):
            k2.flashd_decode(*args, cl)
    off = torch.randn(2 * 4 * 128 + 1, device=cuda).bfloat16()[1:].reshape(2, 4, 128)
    with pytest.raises(ValueError, match="16 bytes"):
        k2.flashd_decode(off, ok.bfloat16(), ok.bfloat16(), cl)
    assert k2.launches == before


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


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("page", [4, 8, 16, 32, 64])
def test_paged_decode_kernel_pages_and_groups(cuda, page, group):
    """K3 at every page size the engine can choose (a split spans several
    small pages, or a page several splits) and every GQA group, in f32,
    bf16 and over an int8 pool: one launch, against the plain version in
    the reference's per-page order and in the kernel's split order."""
    gen = torch.Generator(device=cuda).manual_seed(page * 10 + group)
    hkv, d, s_max = 2, 128, 256
    n_tbl = s_max // page
    lengths = [0, 1, page - 1, page + 1, s_max // 2 + 3, s_max - 1, s_max]
    cl = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn(len(lengths), hkv * group, d, generator=gen, device=cuda)
    n = k2.gpu_decode_splits(len(lengths), hkv, s_max,
                             torch.cuda.get_device_properties(cuda).multi_processor_count)
    kp, vp, tbl, _, _ = _paged_pool(gen, cuda, lengths, n_tbl, page, hkv, d)
    k2.paged_launches = 0
    o = k2.flashd_decode_paged(q, kp, vp, tbl, cl)
    assert k2.paged_launches == 1
    assert torch.isfinite(o).all() and (o[0] == 0).all()
    _close(o, k2.flashd_decode_paged_plain(q, kp, vp, tbl, cl))
    _close(o, k2.flashd_decode_paged_plain(q, kp, vp, tbl, cl, n_splits=n))
    kb, vb = kp.bfloat16(), vp.bfloat16()
    _close(k2.flashd_decode_paged(q.bfloat16(), kb, vb, tbl, cl),
           k2.flashd_decode_paged_plain(q.bfloat16(), kb, vb, tbl, cl), BF16_TOL)
    ki, vi, tbl_i, ks, vs = _paged_pool(gen, cuda, lengths, n_tbl, page, hkv, d, torch.int8)
    for qx, tol in ((q, TOL), (q.bfloat16(), BF16_TOL)):
        oi = k2.flashd_decode_paged(qx, ki, vi, tbl_i, cl, k_scale=ks, v_scale=vs)
        assert torch.isfinite(oi).all()
        _close(oi, k2.flashd_decode_paged_plain(qx, ki, vi, tbl_i, cl, k_scale=ks, v_scale=vs),
               tol)


def _plan(kind: str) -> StepPlan:
    """A step plan of the mixed loop's kinds: decode rows only, prefill
    chunks only, whole prompts with a K+1 = 5-row verify segment."""
    one = lambda n: np.zeros(n, np.int32)
    segs = {
        "decode": [Segment(slot=i, tokens=one(1), start=st, emits=True)
                   for i, st in enumerate((150, 3, 300, 0))],
        "chunks": [Segment(slot=0, tokens=one(16), start=96, emits=False),
                   Segment(slot=1, tokens=one(24), start=200, emits=False)],
        "prompts+verify": [Segment(slot=0, tokens=one(37), start=0, emits=True),
                           Segment(slot=1, tokens=one(5), start=400, emits=True),
                           Segment(slot=2, tokens=one(100), start=0, emits=True)],
    }[kind]
    return StepPlan(segments=tuple(segs), n_tokens=sum(len(x.tokens) for x in segs))


@pytest.mark.parametrize("mask", [{}, dict(window=50), dict(chunk=64)])
@pytest.mark.parametrize("block_q", [8, 16])
@pytest.mark.parametrize("kind", ["decode", "chunks", "prompts+verify"])
def test_varlen_kernel_on_packer_packs(cuda, kind, block_q, mask):
    """K4 on packs built by the engine's packer (each segment on a block_q
    boundary, the pack a power of two, so all-padding blocks too), at
    qwen3-0.6b's group (G 2): decode rows and short verify segments take
    the CUDA-core body, chunks and prompts (≥ 16 rows a kv head) the tensor
    cores. f32, bf16, int8; padding rows exactly 0."""
    gen = torch.Generator(device=cuda).manual_seed(block_q + len(kind))
    hkv, group, d, page, n_tbl = 2, 2, 128, 64, 8
    _, sid_np, qpos_np, kvl_np, _ = pack_plan(_plan(kind), block_q, 4)
    sid, qp, kvl = (torch.as_tensor(x, device=cuda) for x in (sid_np, qpos_np, kvl_np))
    q = torch.randn(len(sid_np), hkv * group, d, generator=gen, device=cuda)
    kp, vp, tbl, _, _ = _paged_pool(gen, cuda, kvl_np.tolist(), n_tbl, page, hkv, d)
    kw = dict(block_q=block_q, **mask)
    k4.launches = 0
    o = k4.flashd_varlen(q, kp, vp, tbl, sid, qp, kvl, **kw)
    assert k4.launches == 1
    assert torch.isfinite(o).all() and (o[qp < 0] == 0).all()
    _close(o, k4.flashd_varlen_plain(q, kp, vp, tbl, sid, qp, kvl, **kw))
    n = k4.gpu_varlen_splits(len(sid_np) // block_q, block_q, group, hkv, n_tbl * page,
                             torch.cuda.get_device_properties(cuda).multi_processor_count)
    _close(o, k4.flashd_varlen_plain(q, kp, vp, tbl, sid, qp, kvl, n_splits=n, **kw))
    ob = k4.flashd_varlen(q.bfloat16(), kp.bfloat16(), vp.bfloat16(), tbl, sid, qp, kvl, **kw)
    assert (ob[qp < 0] == 0).all()
    _close(ob, k4.flashd_varlen_plain(q.bfloat16(), kp.bfloat16(), vp.bfloat16(), tbl, sid, qp,
                                      kvl, **kw), BF16_TOL)
    ki, vi, tbl_i, ks, vs = _paged_pool(gen, cuda, kvl_np.tolist(), n_tbl, page, hkv, d,
                                        torch.int8)
    for qx, tol in ((q, TOL), (q.bfloat16(), BF16_TOL)):
        oi = k4.flashd_varlen(qx, ki, vi, tbl_i, sid, qp, kvl, k_scale=ks, v_scale=vs, **kw)
        assert torch.isfinite(oi).all() and (oi[qp < 0] == 0).all()
        _close(oi, k4.flashd_varlen_plain(qx, ki, vi, tbl_i, sid, qp, kvl, k_scale=ks,
                                          v_scale=vs, **kw), tol)


def test_paged_kernels_are_bitwise_repeatable(cuda):
    """K3 and K4 merge their splits in split order whichever CTA arrives
    last: repeated calls are bitwise equal (f32, bf16, int8)."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    hkv, d, page, n_tbl = 8, 128, 16, 32
    lengths = [512, 300, 17, 1]
    cl = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn(4, 16, d, generator=gen, device=cuda)
    kp, vp, tbl, _, _ = _paged_pool(gen, cuda, lengths, n_tbl, page, hkv, d)
    ki, vi, tbl_i, ks, vs = _paged_pool(gen, cuda, lengths, n_tbl, page, hkv, d, torch.int8)
    _, sid_np, qpos_np, kvl_np, _ = pack_plan(_plan("prompts+verify"), 8, 4)
    sid, qp, kvl = (torch.as_tensor(x, device=cuda) for x in (sid_np, qpos_np, kvl_np))
    qv = torch.randn(len(sid_np), 16, d, generator=gen, device=cuda)
    kp4, vp4, tbl4, _, _ = _paged_pool(gen, cuda, kvl_np.tolist(), n_tbl, page, hkv, d)
    ki4, vi4, tbl4i, ks4, vs4 = _paged_pool(gen, cuda, kvl_np.tolist(), n_tbl, page, hkv, d,
                                            torch.int8)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert k2.gpu_decode_splits(4, hkv, n_tbl * page, n_sm) > 1  # the merge runs
    assert k4.gpu_varlen_splits(len(sid_np) // 8, 8, 2, hkv, n_tbl * page, n_sm) > 1
    calls = [lambda: k2.flashd_decode_paged(q, kp, vp, tbl, cl),
             lambda: k2.flashd_decode_paged(q.bfloat16(), kp.bfloat16(), vp.bfloat16(), tbl, cl),
             lambda: k2.flashd_decode_paged(q, ki, vi, tbl_i, cl, k_scale=ks, v_scale=vs),
             lambda: k4.flashd_varlen(qv, kp4, vp4, tbl4, sid, qp, kvl, block_q=8),
             lambda: k4.flashd_varlen(qv.bfloat16(), kp4.bfloat16(), vp4.bfloat16(), tbl4, sid,
                                      qp, kvl, block_q=8),
             lambda: k4.flashd_varlen(qv, ki4, vi4, tbl4i, sid, qp, kvl, block_q=8, k_scale=ks4,
                                      v_scale=vs4)]
    for fn in calls:
        first = fn()
        assert torch.isfinite(first).all()
        for _ in range(3):
            assert torch.equal(fn(), first)


def test_paged_wrappers_refuse_unaligned_views(cuda):
    """K3 and K4 copy 16-byte rows of q and the pools: a pool whose row
    stride is 129 floats, or a q whose base is one bf16 off, raises and
    launches nothing."""
    q = torch.randn(2, 4, 128, device=cuda)
    ok = torch.randn(5, 8, 2, 128, device=cuda)
    bad = torch.randn(5, 8, 2, 129, device=cuda)[..., :128]
    tbl = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=cuda)
    cl = torch.tensor([9, 16], dtype=torch.int32, device=cuda)
    idx = torch.tensor([0] * 4 + [1] * 4, dtype=torch.int32, device=cuda)
    pos = torch.tensor([5, 6, 7, 8, 12, 13, 14, 15], dtype=torch.int32, device=cuda)
    qv = torch.randn(8, 4, 128, device=cuda)
    off = torch.randn(8 * 4 * 128 + 1, device=cuda).bfloat16()[1:].reshape(8, 4, 128)
    before = (k2.paged_launches, k4.launches)
    for kp, vp in ((bad, ok), (ok, bad)):
        with pytest.raises(ValueError, match="16 bytes"):
            k2.flashd_decode_paged(q, kp, vp, tbl, cl)
        with pytest.raises(ValueError, match="16 bytes"):
            k4.flashd_varlen(qv, kp, vp, tbl, idx, pos, cl, block_q=4)
    with pytest.raises(ValueError, match="16 bytes"):
        k2.flashd_decode_paged(off[:2], ok.bfloat16(), ok.bfloat16(), tbl, cl)
    with pytest.raises(ValueError, match="16 bytes"):
        k4.flashd_varlen(off, ok.bfloat16(), ok.bfloat16(), tbl, idx, pos, cl, block_q=4)
    assert (k2.paged_launches, k4.launches) == before


def test_varlen_tc_path_holds_f32_at_large_scores(cuda):
    """Two whole prompts through K4's tensor-core body with q and k scaled
    ×4 (scores up to ±60), f32, split over the keys: held against float64
    softmax attention, within 5e-5 and no farther than the plain version
    (the rule of test_tc_fwd_kernels_hold_f32_at_large_scores)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    hkv, group, d, page, n_tbl, n = 2, 2, 128, 64, 8, 512
    plan = StepPlan(segments=tuple(Segment(slot=i, tokens=np.zeros(n, np.int32), start=0,
                                           emits=True) for i in range(2)), n_tokens=2 * n)
    _, sid_np, qpos_np, kvl_np, _ = pack_plan(plan, 8, 2)
    sid, qp, kvl = (torch.as_tensor(x, device=cuda) for x in (sid_np, qpos_np, kvl_np))
    kp, vp, tbl, _, _ = _paged_pool(gen, cuda, kvl_np.tolist(), n_tbl, page, hkv, d)
    kp = kp * 4
    q = torch.randn(2 * n, hkv * group, d, generator=gen, device=cuda) * 4
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert k4.gpu_varlen_splits(2 * n // 8, 8, group, hkv, n_tbl * page, n_sm) > 1  # split keys
    o = k4.flashd_varlen(q, kp, vp, tbl, sid, qp, kvl, block_q=8)
    o_p = k4.flashd_varlen_plain(q, kp, vp, tbl, sid, qp, kvl, block_q=8)
    # the truth: causal softmax attention per prompt in float64
    kg = tb_gather(kp, tbl).double()  # [2, S, Hkv, d]
    vg = tb_gather(vp, tbl).double()
    qs = q.double().reshape(2, n, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs, kg[:, :n]) / d ** 0.5
    causal = torch.ones(n, n, dtype=torch.bool, device=cuda).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    o_t = torch.einsum("bhgqk,bkhd->bqhgd", p, vg[:, :n]).reshape(2 * n, hkv * group, d)
    err, plain_err = float((o - o_t).abs().max()), float((o_p - o_t).abs().max())
    assert err <= min(TOL, plain_err), (err, plain_err)


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
