"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the `gpu` marker and skips without a CUDA device.
This file imports torch and the port only, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: O and Λ within 5e-5 in f32 (summation order only); bf16 O
within 2e-2 (one bf16 rounding of |O| < 4); engine tokens identical, the
engine's captured CUDA graphs against its eager steps too (with equal K2–K4
launch counts and host syncs; a replayed step's logits within 1e-3).
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
from repro_torch.models import encdec as ed
from repro_torch.models.transformer import (
    apply_lm,
    decode_step_lm,
    forward_packed,
    init_decode_cache,
    init_lm,
)
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.engine import pack_plan
from repro_torch.serve.graphs import StepGraphs, launch_counts
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
@pytest.mark.parametrize("d", [16, 32, 48, 64, 96, 128, 256])
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
@pytest.mark.parametrize("d", [16, 32, 48, 64, 96, 128, 256])
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


@pytest.mark.parametrize("d", [16, 96])
@pytest.mark.parametrize("case", FWD_CASES)
def test_fa2_kernel_at_head_dims_16_and_96(cuda, case, d):
    """K6 at head dim 16 (every A12 smoke config's) and 96 (phi-3-vision's
    at full width), f32 and bf16, against its plain version and K1."""
    kind, window, chunk, q_offset, _ = case
    gen = torch.Generator(device=cuda).manual_seed(d)
    args = tuple(torch.randn(2, s_, h, d, generator=gen, device=cuda).transpose(1, 2)
                 for s_, h in ((150, 4), (170, 2), (170, 2)))
    m = tb.MaskSpec(kind, window, chunk, q_offset)
    o, lam = k6.fa2_fwd(*args, mask=m)
    o_p, lam_p = k6.fa2_fwd_plain(*args, mask=m)
    _close(o, o_p)
    _close(lam, lam_p)
    _close(o, k1.flashd_fwd(*args, mask=m)[0])
    ob, _ = k6.fa2_fwd(*(x.bfloat16() for x in args), mask=m)
    _close(ob, k6.fa2_fwd_plain(*(x.bfloat16() for x in args), mask=m)[0], BF16_TOL)


@pytest.mark.parametrize("group", [1, 2, 4, 5, 8])
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
@pytest.mark.parametrize("group", [1, 2, 5, 8])
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


@pytest.mark.parametrize("d", [16, 32, 48, 64, 96, 256])
def test_decode_kernel_head_dims(cuda, d):
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(3, 4, d, generator=gen, device=cuda)
    kc = torch.randn(3, 4, 77, d, generator=gen, device=cuda)
    cl = torch.tensor([77, 5, 40], dtype=torch.int32, device=cuda)
    _close(k2.flashd_decode(q, kc, kc, cl, n_splits=4), k2.flashd_decode_plain(q, kc, kc, cl, n_splits=4))


K2_SWEEP = [(b, s_max) for b in (1, 4, 32) for s_max in (1, 64, 512, 4096)]


@pytest.mark.parametrize("b, s_max", K2_SWEEP)
@pytest.mark.parametrize("group", [1, 2, 3, 4, 5, 6, 7, 8])
def test_decode_kernel_default_splits_sweep(cuda, b, s_max, group):
    """K2 at its own split choice (`gpu_decode_splits` for this card)
    against the plain version at the same splits: cache_len 0, 1, full and
    a ragged one; head dims 32, 48, 64, 128; every group up to 8 (3, 5, 6
    and 7 leave rows of the group instance idle); f32 and bf16; fused and
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
    q = torch.randn(1, 2, 8, 80, device=cuda)  # a head dim no kernel builds
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
    dead table slot points at) filled with NaN — or, for a byte pool (int8,
    fp8 e4m3), NaN scales."""
    b = len(lengths)
    n_pages = b * n_tbl + 1
    shape = (n_pages, page, hkv, d)
    if dtype in (torch.int8, torch.float8_e4m3fn):
        if dtype == torch.int8:
            kp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            vp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        else:  # codes across e4m3's range, ±448 saturated
            kp, vp = ((torch.randn(shape, generator=gen, device=dev) * 100).clamp(-448, 448)
                      .to(dtype) for _ in range(2))
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
    (5, 16, 0, 0),
    (3, 32, 0, 20),
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
    (6, 16, 8, 0, 0),
    (7, 8, 16, 0, 12),
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


@pytest.mark.parametrize("group", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("page", [4, 8, 16, 32, 64])
def test_paged_decode_kernel_pages_and_groups(cuda, page, group):
    """K3 at every page size the engine can choose (a split spans several
    small pages, or a page several splits) and every GQA group up to 8
    (3, 5, 6 and 7 partly fill the group instance they run in), in f32,
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


@pytest.mark.parametrize("d", [16, 96])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("page", [4, 16, 64])
def test_paged_kernels_at_head_dims_16_and_96(cuda, page, group, pool, d):
    """K3 and K4 at head dim 16, where a byte-pool row is one 16-byte copy
    and a bf16 q row two (lanes past them idle), and at 96 (phi-3-vision's
    at full width: a byte-pool row is six copies, an f32 q row 24 chunks on
    a row of 32 lanes, a bf16 one 12 on 16): f32 and bf16 pools with q
    of their dtype, int8 and fp8 pools with f32 and bf16 q; K4 on a pack
    with decode rows, a verify chain (the CUDA-core body) and a prompt and a
    chunk (the tensor cores), under the causal, local and chunked masks.
    A byte pool's values reach |O| ≈ 7 here, so bf16 outputs are held to
    2^-7·max|O| — between one and two bf16 ulps of the largest |O| — or
    BF16_TOL if larger."""
    gen = torch.Generator(device=cuda).manual_seed(page * 10 + group + d)
    hkv, n_tbl = 2, 160 // page
    full = n_tbl * page
    lengths = [0, 1, page + 1, full - 3, full]
    byte = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(pool)
    kp, vp, tbl, ks, vs = _paged_pool(gen, cuda, lengths, n_tbl, page, hkv, d,
                                      byte or torch.float32)
    if byte is None:
        kp, vp = kp.to(getattr(torch, pool)), vp.to(getattr(torch, pool))
    cl = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn(len(lengths), hkv * group, d, generator=gen, device=cuda)
    seq_ids, q_pos = _pack(lengths, [0, 1, 5, 40, 37], 8)  # decode, verify, prompt, chunk
    sid, qp = (torch.tensor(x, dtype=torch.int32, device=cuda) for x in (seq_ids, q_pos))
    qv = torch.randn(len(seq_ids), hkv * group, d, generator=gen, device=cuda)
    q_types = (torch.float32, torch.bfloat16) if byte is not None else (kp.dtype,)
    sc = dict(k_scale=ks, v_scale=vs)
    k2.paged_launches = k4.launches = 0
    def bound(dt, want):
        return TOL if dt == torch.float32 else max(BF16_TOL, 2.0 ** -7 * float(want.abs().max()))

    for dt in q_types:
        for mask in ({}, dict(window=11), dict(chunk=24)):
            o = k2.flashd_decode_paged(q.to(dt), kp, vp, tbl, cl, **sc, **mask)
            want = k2.flashd_decode_paged_plain(q.to(dt), kp, vp, tbl, cl, **sc, **mask)
            assert torch.isfinite(o).all() and (o[0] == 0).all()
            _close(o, want, bound(dt, want))
            ov = k4.flashd_varlen(qv.to(dt), kp, vp, tbl, sid, qp, cl, block_q=8, **sc, **mask)
            want = k4.flashd_varlen_plain(qv.to(dt), kp, vp, tbl, sid, qp, cl, block_q=8, **sc,
                                          **mask)
            assert torch.isfinite(ov).all() and (ov[qp < 0] == 0).all()
            _close(ov, want, bound(dt, want))
    assert k2.paged_launches == k4.launches == 3 * len(q_types)


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
    # a byte pool needs scales; any other pool q's dtype: the text names both formats
    sc = torch.ones(5, 2, device=cuda)
    for wrong in (kp.half(), kp.to(torch.float8_e4m3fn)):
        with pytest.raises(ValueError, match="torch.int8 or torch.float8_e4m3fn"):
            if wrong.dtype == torch.float16:
                k2.flashd_decode_paged(q, wrong, wrong, tbl, cl, k_scale=sc, v_scale=sc)
            else:
                k4.flashd_varlen(q[:1].expand(4, 4, 64), wrong, wrong, tbl, cl.new_zeros(4),
                                 cl.new_zeros(4), cl, block_q=4)
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


A12_LOOPS = {
    "contiguous": dict(),
    "paged": dict(kv_layout="paged", prefix_cache=False),
    "mixed": dict(step_mode="mixed", page_size=8, prefix_cache=False),
}


@pytest.mark.parametrize("loop", sorted(A12_LOOPS))
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-9b", "mamba2-2.7b", "phi-3-vision-4.2b"])
def test_a12_engines_captured_eager_and_plain_agree(cuda, arch, loop):
    """The MoE + chunked-attention, MoE, RG-LRU + local-attention, Mamba-2
    and vision-stub stacks at smoke width (head dim 16), f32: on each loop
    (a stack the loop does not take falls back as the reference's engine
    does: mamba2 serves every loop on the contiguous one, with no kernel)
    the captured steps give the eager steps' tokens, launch counts and host
    syncs, and the plain route's tokens; K1 runs the forward under the
    stack's masks (phi-3: after its patch rows) and agrees with the plain
    route's logits."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_lm(cfg, device=cuda, seed=1)
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32) for n in (7, 37, 9, 30)]
    sc = ServeConfig(max_batch=2, max_len=64, decode_chunk=3, **A12_LOOPS[loop])
    captured = _served(Engine(params, cfg, sc, device=cuda), reqs, 8)
    eager = _served(Engine(params, cfg, sc, device=cuda, graphs=False), reqs, 8)
    for got, want in zip(captured[:3], eager[:3]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert captured[3:5] == eager[3:5] and (sum(captured[3]) > 0) == cfg.uses_attention
    plain_cfg = dataclasses.replace(cfg, attn_impl="flashd_plain")
    before = launch_counts()
    plain = Engine(params, plain_cfg, sc, device=cuda).serve(reqs, 8)
    assert launch_counts() == before
    for g, w in zip(captured[0], plain):
        np.testing.assert_array_equal(g, w)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 40)), device=cuda)  # S past the ring
    batch = {"tokens": toks}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.randn(3, cfg.frontend_tokens, cfg.d_model, device=cuda)
    k1.launches = 0
    with torch.inference_mode():
        logits, aux = apply_lm(params, batch, cfg)
        logits_p, aux_p = apply_lm(params, batch, plain_cfg)
    assert k1.launches == sum(m.startswith("attn") for m, _ in
                              (*cfg.pattern * cfg.n_blocks, *cfg.remainder))
    _close(logits[..., :cfg.vocab_size], logits_p[..., :cfg.vocab_size], 1e-4)
    for key in aux:
        assert abs(float(aux[key]) - float(aux_p[key])) <= 1e-5, key


@pytest.mark.parametrize("loop", ["paged", "mixed"])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "qwen3-moe-235b-a22b"])
def test_moe_pool_engines_repeat_beside_dead_slots(cuda, arch, loop):
    """MoE stacks on the pool, smoke width, f32: 7 requests of staggered
    prompt lengths on 4 slots, so later waves decode beside dead slots that
    step on the garbage page 0 (and pack padding rows that write it), whose
    rows feed the router. Duplicate writes to page 0 store their last
    writer's value, so a captured engine served twice, a second captured
    engine and an eager one give the same tokens."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_lm(cfg, device=cuda, seed=2)
    rng = np.random.default_rng(5)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
            for n in (3, 29, 11, 40, 7, 18, 33)]
    sc = ServeConfig(max_batch=4, max_len=64, decode_chunk=3, **A12_LOOPS[loop])
    first = Engine(params, cfg, sc, device=cuda)
    runs = [first.serve(reqs, 9), first.serve(reqs, 9),
            Engine(params, cfg, sc, device=cuda).serve(reqs, 9),
            Engine(params, cfg, sc, device=cuda, graphs=False).serve(reqs, 9)]
    for other in runs[1:]:
        for g, w in zip(other, runs[0]):
            np.testing.assert_array_equal(g, w)


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


def test_sharded_train_step_on_a_one_rank_nccl_mesh(cuda, tmp_path):
    """qwen3-0.6b SMOKE (f32) under `distributed.sharding` on a 1-rank NCCL
    process group and a (1, 1) ('data', 'model') mesh: the sharded step
    equals the unsharded one (loss and grad norm within 1e-5 relative,
    parameters within 1e-6), and K1 and K5 launch inside it, through the
    attention island (remat 'full': the forward twice a layer)."""
    import torch.distributed as dist

    from repro_torch.devices import make_mesh
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.train_step import train_state_specs

    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype="float32",
                              attn_impl="flashd_gpu")
    tc = TrainConfig(warmup_steps=0)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2))
    batch = {k: torch.as_tensor(x, device=cuda) for k, x in data.batch(0).items()}
    s_u, m_u = make_train_step(cfg, tc)(init_train_state(cfg, tc, device=cuda, seed=0), batch)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        ctx = shd.ShardingCtx(make_mesh((1, 1), ("data", "model"), device="cuda"))
        with shd.activate(ctx):
            state = init_train_state(cfg, tc, device=cuda, seed=0)
            state = shd.distribute_tree(state, train_state_specs(state))
            step = shd.sharded(make_train_step(cfg, tc), (None, shd.batch_specs(batch)))
        before = (k1.launches, k5.launches, k6.launches)
        s_s, m_s = step(state, batch)
        launched = [a - b for a, b in zip((k1.launches, k5.launches, k6.launches), before)]
        assert launched == [2 * cfg.n_layers, cfg.n_layers, 0], launched
        for key in ("loss", "grad_norm"):
            assert abs(float(m_s[key]) - float(m_u[key])) <= 1e-5 * abs(float(m_u[key])), key
        for a, b in zip(tree_leaves(s_s.params), tree_leaves(s_u.params)):
            assert float((a.full_tensor() - b).abs().max()) <= 1e-6
    finally:
        dist.destroy_process_group()


def test_adamw_chunked_update_is_the_whole_tree_update(cuda, monkeypatch):
    """AdamW on the card, each leaf in passes that write their outputs in
    place (`optim.adamw.UPDATE_CHUNK`, here 1000 elements: ragged on a
    4099-element leaf) against the reference's expressions as whole-tree
    passes: the same bits in f32 and bf16 optimizer state over two steps."""
    from repro_torch.optim import adamw

    gen = torch.Generator(device=cuda).manual_seed(26)
    params = {"embed": torch.randn(4099, generator=gen, device=cuda),
              "norm": torch.randn(7, generator=gen, device=cuda),
              "w": torch.randn(3, 40, 33, generator=gen, device=cuda)}
    grads = [{k: torch.randn(x.shape, generator=gen, device=cuda) for k, x in params.items()}
             for _ in range(2)]
    cfg, lr = adamw.AdamWConfig(clip_norm=50.0), torch.tensor(1e-2, device=cuda)

    def whole_tree(p, g, o):
        step = o.step + 1
        gn = adamw.global_norm(g)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        b1c, b2c = 1.0 - cfg.b1 ** step.float(), 1.0 - cfg.b2 ** step.float()
        g = {k: x.float() * scale for k, x in g.items()}
        m = {k: (cfg.b1 * o.m[k].float() + (1 - cfg.b1) * g[k]).to(o.m[k].dtype) for k in g}
        v = {k: (cfg.b2 * o.v[k].float() + (1 - cfg.b2) * g[k] * g[k]).to(o.v[k].dtype)
             for k in g}
        d = adamw._decay_mask(p, cfg)
        new = {k: (p[k].float() - lr * ((m[k].float() / b1c)
                                        / (torch.sqrt(v[k].float() / b2c) + cfg.eps)
                                        + cfg.weight_decay * d[k] * p[k].float())).to(p[k].dtype)
               for k in p}
        return new, adamw.OptState(m, v, step)

    monkeypatch.setattr(adamw, "UPDATE_CHUNK", 1000)
    for state_dtype in (None, "bfloat16"):
        runs = []
        for fn in (whole_tree, lambda p, g, o: adamw.apply_updates(p, g, o, cfg, lr=lr)[:2]):
            p, o = params, adamw.init_opt(params, state_dtype=state_dtype)
            for g in grads:
                p, o = fn(p, g, o)
            runs.append(tree_leaves(p) + tree_leaves(o.m) + tree_leaves(o.v))
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(*runs))


def test_decode_kernel_every_row_at_full_length(cuda):
    """K2 as cross attention reads it: cache_len equal to the buffer's
    length T in every row (the encoder memory), G 1, at the seamless smoke
    and full head dims (16, 64) and T 19 and 1024, f32 and bf16, the
    card's own splits, against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    for b, h, d, t in ((2, 4, 16, 19), (4, 16, 64, 1024)):
        q = torch.randn(b, h, d, generator=gen, device=cuda)
        kc, vc = (torch.randn(b, t, h, d, generator=gen, device=cuda).transpose(1, 2)
                  for _ in range(2))
        cl = torch.full((b,), t, dtype=torch.int32, device=cuda)
        n = k2.gpu_decode_splits(b, h, t, torch.cuda.get_device_properties(cuda)
                                 .multi_processor_count)
        for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
            x = (q.to(dtype), kc.to(dtype), vc.to(dtype))
            o, lam = k2.flashd_decode(*x, cl, return_lam=True)
            o_p, lam_p = k2.flashd_decode_plain(*x, cl, n_splits=n, return_lam=True)
            _close(o, o_p, tol)
            if dtype == torch.float32:
                _close(lam, lam_p)


def test_encdec_kernel_path_matches_plain(cuda):
    """The seamless smoke stack (2 + 2 layers, d 16), f32, T 19 frames and S
    12 tokens: the forward (K1: full, causal, and full at Sq ≠ Skv), one
    train step on the K1 + K5 and K6 + K5 paths and 8 greedy decode steps
    (K2 on the self and cross caches) against the plain path — logits
    within 1e-4, loss and grad norm within 1e-5 relative, tokens equal —
    with the kernels' launch counts per call."""
    cfg = dataclasses.replace(get_smoke_config("seamless-m4t-medium"), dtype="float32")
    plain = dataclasses.replace(cfg, attn_impl="flashd_plain")
    n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    gen = torch.Generator(device=cuda).manual_seed(24)
    params = ed.init_encdec(cfg, device=cuda, seed=0)
    batch = {"frame_embeds": torch.randn(2, 19, cfg.d_model, generator=gen, device=cuda),
             "tokens": torch.randint(0, cfg.vocab_size, (2, 12), generator=gen, device=cuda),
             "labels": torch.randint(0, cfg.vocab_size, (2, 12), generator=gen, device=cuda)}
    before = k1.launches
    with torch.inference_mode():
        lk, _ = ed.apply_encdec(params, batch, cfg)
        lp, _ = ed.apply_encdec(params, batch, plain)
    assert k1.launches - before == n_attn
    _close(lk, lp, 1e-4)

    tc = TrainConfig(warmup_steps=0)
    state0 = init_train_state(cfg, tc, device=cuda, seed=0)
    runs = {}
    for route in ("flashd_gpu", "fa2_gpu", "flashd_plain"):
        before = (k1.launches, k5.launches, k6.launches)
        runs[route] = make_train_step(dataclasses.replace(cfg, attn_impl=route), tc)(state0,
                                                                                     batch)[1]
        launched = [a - b for a, b in zip((k1.launches, k5.launches, k6.launches), before)]
        if route == "flashd_plain":
            assert launched == [0, 0, 0]
        else:  # remat 'full': the forward runs again in the backward
            fwd = 0 if route == "flashd_gpu" else 2
            assert launched[fwd] == 2 * n_attn and launched[1] == n_attn, (route, launched)
    for route in ("flashd_gpu", "fa2_gpu"):
        for key in ("loss", "grad_norm"):
            want = float(runs["flashd_plain"][key])
            assert abs(float(runs[route][key]) - want) <= 1e-5 * abs(want), (route, key)

    toks, logits = {}, {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        with torch.inference_mode():
            memory = ed.encode(params, batch["frame_embeds"], c)
            cache = ed.fill_cross_cache(params, memory, ed.init_encdec_cache(2, 16, 4, c,
                                                                              device=cuda), c)
            tok = batch["tokens"][:, 0]
            out, steps = [], []
            for t in range(8):
                before = k2.launches
                lg, cache = ed.decode_step_encdec(params, cache, tok, torch.full((2,), t,
                                                                                device=cuda), c)
                assert k2.launches - before == (2 * cfg.n_layers if name == "kernel" else 0)
                tok = lg[:, :cfg.vocab_size].argmax(-1)
                out.append(tok)
                steps.append(lg)
        toks[name], logits[name] = torch.stack(out, 1), torch.stack(steps)
    assert torch.equal(toks["kernel"], toks["plain"])
    _close(logits["kernel"], logits["plain"], 1e-4)


# ---- the serving steps as captured CUDA graphs ----

GRAPH_LOOPS = {  # the cache off: a second serve() then runs the first one's steps again
    "contiguous": dict(),
    "paged": dict(kv_layout="paged", prefix_cache=False),
    "mixed": dict(step_mode="mixed", page_size=8, prefix_cache=False),
}


def _served(eng, reqs, n_new):
    """(tokens of two serve() calls and a generate(), K2–K4 launches, host syncs,
    graphs captured by the second serve())."""
    before = launch_counts()
    first = eng.serve(reqs, n_new)
    captured = eng._steps.captures
    second = eng.serve(reqs, n_new)
    again = eng._steps.captures - captured
    gen = eng.generate(np.stack([r[:6] for r in reqs[:2]]), n_new)
    launched = tuple(a - b for a, b in zip(launch_counts(), before))
    return first, second, gen, launched, eng.host_syncs, again


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loop", sorted(GRAPH_LOOPS))
def test_captured_loops_match_eager(cuda, loop, dtype):
    """Smoke widths: the captured steps give the eager steps' tokens (both
    serve() calls and generate), the same K2–K4 launch counts and host
    syncs, and a second serve() captures nothing new."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype=dtype)
    params = init_lm(cfg, device=cuda, seed=4)
    rng = np.random.default_rng(5)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32) for n in (7, 37, 9, 30)]
    sc = ServeConfig(max_batch=2, max_len=64, decode_chunk=3, **GRAPH_LOOPS[loop])
    captured = _served(Engine(params, cfg, sc, device=cuda), reqs, 8)
    eager = _served(Engine(params, cfg, sc, device=cuda, graphs=False), reqs, 8)
    for got, want in zip(captured[:3], eager[:3]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert captured[3] == eager[3] and captured[3][1 if loop != "contiguous" else 0] > 0
    assert captured[4] == eager[4]
    assert captured[5] == 0 and eager[5] == 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_captured_decode_and_packed_steps_logits(cuda, layout):
    """One decode step (K2 / K3) and one packed step (K4) as graph replays:
    logits within 1e-3 of the same step run eagerly on the same inputs."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype="float32")
    params = init_lm(cfg, device=cuda, seed=6)
    kw = dict(layout="paged", page_size=8, n_pages=17) if layout == "paged" else {}
    cache = init_decode_cache(2, 64, cfg, device=cuda, **kw)
    if layout == "paged":
        for group in cache.values():
            for leaves in group.values():
                leaves["tbl"][:] = torch.arange(1, 17, device=cuda, dtype=torch.int32).reshape(2, 8)
    steps = StepGraphs(cuda, graphs=True)
    graphs, out = {}, {}
    tok = torch.tensor([3, 9], device=cuda)
    pos = torch.tensor([0, 0], device=cuda)
    with torch.inference_mode():
        for i in range(20):  # fill 20 positions, eagerly
            pos.fill_(i)
            decode_step_lm(params, cache, tok, pos, cfg)
        pos.fill_(20)
        want = decode_step_lm(params, cache, tok, pos, cfg)[0].clone()

        def step():
            out["decode"] = decode_step_lm(params, cache, tok, pos, cfg)[0]

        for _ in range(3):  # warm-up + capture, then two replays
            steps.run(graphs, "decode", step)
        err = float((out["decode"] - want).abs().max())
        print(f"captured decode step vs eager, {layout}: max |Δlogit| {err:.2e}")
        assert err <= 1e-3
        if layout != "paged":
            return
        plan = StepPlan(segments=(
            Segment(slot=0, tokens=np.arange(1, 17, dtype=np.int32), start=21, emits=True),
            Segment(slot=1, tokens=np.array([4], np.int32), start=21, emits=True)), n_tokens=17)
        pack = [torch.as_tensor(a, device=cuda).long() for a in pack_plan(plan, 8, 2)]
        want_p = forward_packed(params, *pack[:4], cache, cfg, pack[4], block_q=8)[0].clone()

        def packed():
            out["packed"] = forward_packed(params, *pack[:4], cache, cfg, pack[4], block_q=8)[0]

        for _ in range(3):
            steps.run(graphs, "packed", packed)
        err = float((out["packed"] - want_p).abs().max())
        print(f"captured packed step vs eager: max |Δlogit| {err:.2e}")
        assert err <= 1e-3


@pytest.mark.parametrize("mode", [dict(kv_layout="paged"), dict(step_mode="mixed")])
def test_captured_prefix_cache_matches_cache_off(cuda, mode):
    """Shared-prefix traffic, captured: the cache-on engine hits and gives
    the cache-off engine's tokens, on a cold and a warm serve()."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype="float32")
    params = init_lm(cfg, device=cuda, seed=9)
    rng = np.random.default_rng(10)
    system = rng.integers(0, cfg.vocab_size, (24,)).astype(np.int32)
    reqs = [np.concatenate([system, rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)])
            for n in (3, 9, 5, 12)]
    sc = ServeConfig(max_batch=2, max_len=64, decode_chunk=3, page_size=8, **mode)
    on = Engine(params, cfg, sc, device=cuda)
    off = Engine(params, cfg, dataclasses.replace(sc, prefix_cache=False), device=cuda)
    for _ in range(2):
        for g, w in zip(on.serve(reqs, 6), off.serve(reqs, 6)):
            np.testing.assert_array_equal(g, w)
    assert on.stats()["hit_tokens"] > 0 and off.stats()["hit_tokens"] == 0
    on._alloc.check()


def test_captured_temperature_sampling_is_seed_deterministic(cuda):
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype="float32")
    params = init_lm(cfg, device=cuda, seed=7)
    rng = np.random.default_rng(8)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32) for n in (5, 12, 9)]
    outs = []
    for _ in range(2):
        sc = ServeConfig(max_batch=2, max_len=64, decode_chunk=3, temperature=1.0, seed=11,
                         step_mode="mixed")
        eng = Engine(params, cfg, sc, device=cuda)
        outs.append(eng.serve(reqs, 10) + list(eng.generate(np.stack([r[:5] for r in reqs]), 6)))
        assert eng._steps.captures > 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
        assert a.max() < cfg.vocab_size


# ---- quantized pools (A8) and speculative decoding (A9) ----

@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [32, 48, 64, 96, 128])
def test_paged_kernels_on_fp8_pools(cuda, d, group):
    """K3 and K4 on an fp8 (e4m3) pool with NaN scales on the garbage page,
    f32 and bf16 q, every built head dim and group: one launch each, against
    their plain versions (which dequantize with the scales, x·scale)."""
    gen = torch.Generator(device=cuda).manual_seed(d * 10 + group)
    hkv, page, n_tbl = 2, 16, 6
    full = n_tbl * page
    lengths = [0, 1, page + 1, full - 3, full]
    kp, vp, tbl, ks, vs = _paged_pool(gen, cuda, lengths, n_tbl, page, hkv, d,
                                      torch.float8_e4m3fn)
    cl = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn(len(lengths), hkv * group, d, generator=gen, device=cuda)
    seq_ids, q_pos = _pack(lengths, [0, 1, 5, 16, 37], 8)  # decode, verify, chunk, prompt tail
    sid, qp = (torch.tensor(x, dtype=torch.int32, device=cuda) for x in (seq_ids, q_pos))
    qv = torch.randn(len(seq_ids), hkv * group, d, generator=gen, device=cuda)
    k2.paged_launches = k4.launches = 0
    for (qx, qvx), tol in (((q, qv), TOL), ((q.bfloat16(), qv.bfloat16()), BF16_TOL)):
        o = k2.flashd_decode_paged(qx, kp, vp, tbl, cl, k_scale=ks, v_scale=vs)
        assert torch.isfinite(o).all() and (o[0] == 0).all()
        _close(o, k2.flashd_decode_paged_plain(qx, kp, vp, tbl, cl, k_scale=ks, v_scale=vs), tol)
        ov = k4.flashd_varlen(qvx, kp, vp, tbl, sid, qp, cl, k_scale=ks, v_scale=vs, block_q=8)
        assert torch.isfinite(ov).all() and (ov[qp < 0] == 0).all()
        _close(ov, k4.flashd_varlen_plain(qvx, kp, vp, tbl, sid, qp, cl, k_scale=ks, v_scale=vs,
                                          block_q=8), tol)
    assert (k2.paged_launches, k4.launches) == (2, 2)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_kernels_on_engine_written_pools(cuda, kv_dtype):
    """A mixed serve writes a quantized pool through both write paths; K3
    and K4 then read the pages the allocator holds, through its own tables,
    and agree with their plain versions on those bytes."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype="float32")
    params = init_lm(cfg, device=cuda, seed=2)
    rng = np.random.default_rng(4)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32) for n in (21, 37, 9)]
    eng = Engine(params, cfg, ServeConfig(max_batch=2, max_len=64, page_size=8,
                                          step_mode="mixed", kv_dtype=kv_dtype), device=cuda)
    eng.serve(reqs, 8)
    eng._alloc.check(eng._paged.cache)
    chains = eng._alloc.cached_chains()
    tables = [eng._alloc.match_prefix(np.asarray(c)).pages for c in chains[:2]]
    lengths = [len(t) * 8 for t in tables]
    n_tbl = max(map(len, tables))
    tbl = torch.zeros(len(tables), n_tbl, dtype=torch.int32, device=cuda)
    for i, t in enumerate(tables):
        tbl[i, :len(t)] = torch.tensor(t, dtype=torch.int32)
    cl = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    leaves = eng._paged.cache["blocks"]["pos0"]
    g = torch.Generator(device=cuda).manual_seed(0)
    for layer in range(cfg.n_layers):
        kp, vp, ks, vs = (leaves[n][layer] for n in ("k_pages", "v_pages", "k_scale", "v_scale"))
        assert kp.dtype == (torch.int8 if kv_dtype == "int8" else torch.float8_e4m3fn)
        q = torch.randn(len(tables), cfg.n_heads, cfg.head_dim_, generator=g, device=cuda)
        _close(k2.flashd_decode_paged(q, kp, vp, tbl, cl, k_scale=ks, v_scale=vs),
               k2.flashd_decode_paged_plain(q, kp, vp, tbl, cl, k_scale=ks, v_scale=vs))
        seq_ids, q_pos = _pack(lengths, [3, 1], 8)
        sid, qp = (torch.tensor(x, dtype=torch.int32, device=cuda) for x in (seq_ids, q_pos))
        qv = torch.randn(len(seq_ids), cfg.n_heads, cfg.head_dim_, generator=g, device=cuda)
        _close(k4.flashd_varlen(qv, kp, vp, tbl, sid, qp, cl, k_scale=ks, v_scale=vs, block_q=8),
               k4.flashd_varlen_plain(qv, kp, vp, tbl, sid, qp, cl, k_scale=ks, v_scale=vs,
                                      block_q=8))


SPEC_LOOPS = {
    "paged-int8": dict(kv_layout="paged", kv_dtype="int8"),
    "mixed-fp8": dict(step_mode="mixed", kv_dtype="fp8"),
    "paged-spec": dict(kv_layout="paged", spec_tokens=3),
    "mixed-int8-spec": dict(step_mode="mixed", kv_dtype="int8", spec_tokens=4),
}


@pytest.mark.parametrize("loop", sorted(SPEC_LOOPS))
def test_captured_quantized_and_spec_loops_match_eager(cuda, loop):
    """Smoke widths, f32: under kv_dtype and spec_tokens (a self-draft: the
    DraftModel's prefill and K-step proposal graphs, K2, and the verify
    graphs, K4) the captured engine gives the eager engine's tokens, K2–K4
    launch counts and host syncs on two serve() calls; speculation gives
    the non-speculative tokens of the same pool."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype="float32")
    params = init_lm(cfg, device=cuda, seed=12)
    rng = np.random.default_rng(13)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32) for n in (7, 30, 9, 21)]
    kw = dict(SPEC_LOOPS[loop])
    sc = ServeConfig(max_batch=2, max_len=64, decode_chunk=3, page_size=8, prefix_cache=False,
                     **kw)
    draft = (params, cfg) if sc.spec_tokens else None
    runs = []
    for graphs in (None, False):
        eng = Engine(params, cfg, sc, device=cuda, graphs=graphs, draft=draft)
        before = launch_counts()
        outs = [eng.serve(reqs, 8), eng.serve(reqs, 8)]
        runs.append((outs, tuple(a - b for a, b in zip(launch_counts(), before)),
                     eng.host_syncs, eng.stats()))
    (c_out, c_n, c_sync, c_st), (e_out, e_n, e_sync, _) = runs
    for got, want in zip(c_out, e_out):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert c_n == e_n and c_sync == e_sync
    mixed, spec = sc.step_mode == "mixed", sc.spec_tokens > 0
    # K3: the paged loop's steps and the mixed loop's decode chunks (a
    # speculative mixed loop packs everything); K4: packed and verify steps
    assert (c_n[1] > 0) == (not (mixed and spec)) and (c_n[2] > 0) == (mixed or spec)
    if sc.spec_tokens:
        # the self-draft proposes on K2 over a native cache: it agrees with the
        # target wholly on a native pool; on a byte pool the target's logits
        # move with the rounding, so only some drafts pass
        assert c_n[0] > 0 and c_st["spec_accepted"] > 0
        assert c_st["spec_acceptance_rate"] == 1.0 or sc.kv_dtype
        base = Engine(params, cfg, dataclasses.replace(sc, spec_tokens=0), device=cuda)
        for g, w in zip(c_out[0], base.serve(reqs, 8)):
            np.testing.assert_array_equal(g, w)


# ---- fault-tolerant serving on the captured loops ----

CHAOS_LOOPS = {
    "contiguous": dict(),
    "paged": dict(kv_layout="paged"),
    "mixed": dict(step_mode="mixed", page_size=8),
}


@pytest.mark.parametrize("loop", sorted(CHAOS_LOOPS))
def test_captured_loops_under_faults_match_eager(cuda, loop):
    """Smoke widths, f32: the captured engine and the eager one under the
    same seeded faults, with the downgrade out of reach, give the same
    statuses, tokens, host syncs, checks per site and K2–K4 launch counts,
    and neither leaves the kernel route; DONE streams are the fault-free
    ones. Then a downgrade (three kernel_dispatch faults in a row after
    steps have run): the engine ends on the plain route with the
    fault-free tokens, and a second serve launches no K2–K4 kernel."""
    from repro_torch.runtime.resilience import FaultInjector

    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype="float32")
    params = init_lm(cfg, device=cuda, seed=4)
    rng = np.random.default_rng(5)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32) for n in (7, 37, 9, 30)]
    sc = ServeConfig(max_batch=2, max_len=64, decode_chunk=3, **CHAOS_LOOPS[loop])
    base = Engine(params, cfg, sc, device=cuda).serve(reqs, 8)
    runs = []
    sc_c = dataclasses.replace(sc, downgrade_after=1 << 20)  # above any reachable streak
    for graphs in (None, False):
        eng = Engine(params, cfg, sc_c, device=cuda, graphs=graphs,
                     fault_injector=FaultInjector(rate=0.15, seed=3))
        before = launch_counts()
        outs = eng.serve(reqs, 8)
        runs.append((outs, tuple(a - b for a, b in zip(launch_counts(), before)),
                     eng.host_syncs, eng.stats()))
        if eng._alloc is not None:
            eng._alloc.check(eng._paged.cache)
    (c_out, c_n, c_sync, c_st), (e_out, e_n, e_sync, e_st) = runs
    assert c_st["request_status"] == e_st["request_status"]
    assert c_st["fault_checks"] == e_st["fault_checks"]
    assert sum(c_st["injected_faults"].values()) > 0
    assert c_st["downgrades"] == e_st["downgrades"] == 0
    assert c_st["attn_impl"] == e_st["attn_impl"] == cfg.attn_impl
    assert c_n == e_n and c_sync == e_sync
    for i, (g, w, b) in enumerate(zip(c_out, e_out, base)):
        np.testing.assert_array_equal(g, w)
        if c_st["request_status"][i] == "done":
            np.testing.assert_array_equal(g, b)
    sc_d = dataclasses.replace(sc, downgrade_after=3, max_retries=8)
    eng = Engine(params, cfg, sc_d, device=cuda, fault_injector=FaultInjector(
        schedule=[("kernel_dispatch", i) for i in (4, 5, 6)]))
    before = launch_counts()
    for g, b in zip(eng.serve(reqs, 8), base):
        np.testing.assert_array_equal(g, b)
    st = eng.stats()
    assert st["downgrades"] == 1 and st["attn_impl"] == "flashd_plain"
    assert sum(launch_counts()) > sum(before)  # kernels ran before the switch
    eng._injector = None
    frozen = launch_counts()
    for g, b in zip(eng.serve(reqs, 8), base):
        np.testing.assert_array_equal(g, b)
    assert launch_counts() == frozen


def test_capture_runs_with_the_collector_off(cuda):
    """The garbage collector is off while a step is captured (and back on
    after): a dead engine in a reference cycle, collected in the middle of
    another capture, would reset its graphs there and invalidate the
    capture — phase 17's first run on the card failed so, when the engine
    held a bound method of itself."""
    import gc

    seen = []
    x = torch.zeros(4, device=cuda)

    def step():
        seen.append(gc.isenabled())
        x.add_(1)

    steps, graphs = StepGraphs(cuda, graphs=True), {}
    steps.run(graphs, "step", step)  # warm-up, then the capture
    steps.run(graphs, "step", step)  # a replay runs no Python
    torch.cuda.synchronize()
    assert seen == [True, False] and gc.isenabled()
    assert x.tolist() == [2.0] * 4  # the warm-up and the replay; the capture ran nothing


# ---- head dim 256 (recurrentgemma-9b) and groups of 9–16 (recurrentgemma-9b's
# and qwen3-moe-235b-a22b's 16) in K1 / K6, K2 / K3 and K4 ----

@pytest.mark.parametrize("case", FWD_CASES)
def test_tc_fwd_kernels_at_head_dim_256(cuda, case):
    """K1 and K6 at head dim 256 over a group of 16 (Hq 16 over Hkv 1, as
    recurrentgemma-9b), every mask kind, ragged lengths: f32 (the one-stage
    ring, P·V in passes of 64 columns) and bf16 (Q read per k step) against
    their plain versions, K6 against K1; repeat calls bitwise equal."""
    kind, window, chunk, q_offset, skip = case
    gen = torch.Generator(device=cuda).manual_seed(256 + len(kind))
    args = tuple(torch.randn(1, s_, h, 256, generator=gen, device=cuda).transpose(1, 2)
                 for s_, h in ((150, 16), (170, 1), (170, 1)))
    m = tb.MaskSpec(kind, window, chunk, q_offset)
    for fwd, plain in TC_FWD:
        kw = dict(skip=skip, block_k=64) if fwd is k1.flashd_fwd else {}
        o, lam = fwd(*args, mask=m, **kw)
        o_p, lam_p = plain(*args, mask=m, **kw)
        _close(o, o_p)
        _close(lam, lam_p)
        if not skip:
            _close(o, k1.flashd_fwd(*args, mask=m)[0])
        o2, lam2 = fwd(*args, mask=m, **kw)
        assert torch.equal(o, o2) and torch.equal(lam, lam2), fwd.__name__
        xb = tuple(x.bfloat16() for x in args)
        ob, _ = fwd(*xb, mask=m, **kw)
        _close(ob, plain(*xb, mask=m, **kw)[0], BF16_TOL)
        assert torch.equal(ob, fwd(*xb, mask=m, **kw)[0])


def test_tc_fwd_kernels_hold_f32_at_large_scores_at_head_dim_256(cuda):
    """As `test_tc_fwd_kernels_hold_f32_at_large_scores`, at head dim 256
    and a local window (recurrentgemma-9b's mask): q and k ×4, f32, S 512,
    held against float64 within 5e-5 and no farther than the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(44)
    q = torch.randn(1, 512, 4, 256, generator=gen, device=cuda).transpose(1, 2) * 4
    k = torch.randn(1, 512, 1, 256, generator=gen, device=cuda).transpose(1, 2) * 4
    v = torch.randn(1, 512, 1, 256, generator=gen, device=cuda).transpose(1, 2)
    for m in (tb.MaskSpec("causal"), tb.MaskSpec("local", window=200)):
        o_t, lam_t = _attention_f64(q, k, v, m)
        o_p, lam_p = k1.flashd_fwd_plain(q, k, v, mask=m)
        plain_err = max(float((o_p - o_t).abs().max()), float((lam_p - lam_t).abs().max()))
        for fwd, _ in TC_FWD:
            o, lam = fwd(q, k, v, mask=m)
            err = max(float((o - o_t).abs().max()), float((lam - lam_t).abs().max()))
            assert err <= min(TOL, plain_err), (fwd.__name__, m.kind, err, plain_err)


BWD_256_CASES = [
    # (mask kind, window, q_offset, sq, skv): recurrentgemma-9b's local mask
    # across several 32-key tiles; dead leading rows; ragged keys
    ("local", 40, 0, 150, 150),
    ("causal", 0, -12, 90, 90),
    ("full", 0, 0, 70, 170),
]


@pytest.mark.parametrize("case", BWD_256_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_at_head_dim_256(cuda, case, dtype):
    """K5 at head dim 256 over a group of 16 (Hq 16 over Hkv 1, as
    recurrentgemma-9b): the dQ kernel's 32-key tiles and the dK/dV
    kernel's 32-key blocks (f32 one-stage rings, bf16 two) against the
    plain version; dead rows get no gradient; a repeat call is bitwise
    equal."""
    kind, window, q_offset, sq, skv = case
    gen = torch.Generator(device=cuda).manual_seed(sq + skv + window)
    m = tb.MaskSpec(kind, window, 0, q_offset)
    args = _bwd_operands(gen, cuda, 1, 1, 16, sq, skv, 256, m, dtype)
    got = k5.flashd_bwd(*args, mask=m)
    _grads_close(got, k5.flashd_bwd_plain(*args, mask=m), dtype)
    for a, b_ in zip(got, k5.flashd_bwd(*args, mask=m)):
        assert torch.equal(a, b_)
    if q_offset < 0:
        assert (got[0][:, :, :-q_offset] == 0).all()


def test_bwd_kernel_holds_f32_at_large_scores_at_head_dim_256(cuda):
    """As `test_bwd_kernel_holds_f32_at_large_scores`, at head dim 256 over
    Hq 4 / Hkv 1, causal and local (recurrentgemma-9b's mask): q and k ×4,
    f32, S 512, the kernel's excess over rtol 1e-4 against float64 within
    atol 1e-5 or within the plain version's own."""
    gen = torch.Generator(device=cuda).manual_seed(46)
    q = torch.randn(1, 512, 4, 256, generator=gen, device=cuda).transpose(1, 2) * 4
    k = torch.randn(1, 512, 1, 256, generator=gen, device=cuda).transpose(1, 2) * 4
    v = torch.randn(1, 512, 1, 256, generator=gen, device=cuda).transpose(1, 2)
    do = torch.randn(1, 512, 4, 256, generator=gen, device=cuda).transpose(1, 2)
    for m in (tb.MaskSpec("causal"), tb.MaskSpec("local", window=200)):
        o, lam = k1.flashd_fwd_plain(q, k, v, mask=m)
        args = (q, k, v, o, lam, do)
        for got, plain, exact in zip(k5.flashd_bwd(*args, mask=m),
                                     k5.flashd_bwd_plain(*args, mask=m), _bwd_f64(*args, m)):
            assert _excess(got, exact) <= max(1e-5, _excess(plain, exact)), (
                m.kind, _excess(got, exact), _excess(plain, exact))


@pytest.mark.parametrize("group", [1, 2, 4, 8, 12, 16])
@pytest.mark.parametrize("d", [128, 256])
def test_decode_kernel_at_head_dim_256_and_large_groups(cuda, d, group):
    """K2 at head dims 128 and 256 and groups up to 16 (above 8 two CTAs
    of up to 8 heads each, 12 leaving 4 of the second idle): the splits of
    DECODE_CASES (window, chunk, start, fused and unfused, Λ), cache_len 0
    to full, f32 and bf16; an empty row exactly 0 / NEG_INF; repeat calls
    bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(d + group)
    b, hkv, s_max = 6, 2, 300
    q = torch.randn(b, hkv * group, d, generator=gen, device=cuda)
    kc = torch.randn(b, s_max, hkv, d, generator=gen, device=cuda).transpose(1, 2)
    vc = torch.randn(b, s_max, hkv, d, generator=gen, device=cuda).transpose(1, 2)
    cl = torch.tensor([0, 1, 130, 257, 299, 300], dtype=torch.int32, device=cuda)
    start = torch.tensor([0, 0, 40, 200, 10, 299], dtype=torch.int32, device=cuda)
    for n_splits, window, chunk, with_start, fused in DECODE_CASES:
        kw = dict(window=window, chunk=chunk, start=start if with_start else None, fused=fused,
                  return_lam=True,
                  n_splits=k2.gpu_decode_splits(b, hkv, s_max) if n_splits is None else n_splits)
        for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
            x = (q.to(dtype), kc.to(dtype), vc.to(dtype))
            o, lam = k2.flashd_decode(*x, cl, **kw)
            o_p, lam_p = k2.flashd_decode_plain(*x, cl, **kw)
            _close(o, o_p, tol)
            _close(lam, lam_p)
            assert (o[0] == 0).all() and (lam[0] == tb.NEG_INF).all()
    o, lam = k2.flashd_decode(q, kc, vc, cl, return_lam=True)
    o2, lam2 = k2.flashd_decode(q, kc, vc, cl, return_lam=True)
    assert torch.equal(o, o2) and torch.equal(lam, lam2)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("group", [1, 2, 8, 12, 16])
@pytest.mark.parametrize("d", [128, 256])
def test_paged_kernels_at_head_dim_256_and_large_groups(cuda, d, group, pool):
    """K3 and K4 at head dims 128 and 256 and groups up to 16, on f32 and
    bf16 pools (q of their dtype) and int8 and fp8 pools (f32 and bf16 q),
    pages of 16, under the causal, local and chunked masks. K3 at cache_len
    0 to full against its plain version in the reference's per-page order;
    K4 on a pack with decode rows and a verify chain (the CUDA-core body
    below 16 live rows a kv head; a group of 16 makes a decode row 16 rows:
    the tensor cores), a prompt and a chunk, at block_q 8 and at the
    reference's block_q 64 for a group of 16 (16 row groups a block).
    Padding rows exactly 0; repeat calls bitwise equal. A bf16 q over a
    byte pool is held to 2^-7 of the largest dequantized |V| (or BF16_TOL
    if larger): K4's tensor cores take the dequantized K and V tiles and P
    in bf16, each rounding bounded by 2^-9·max|V| in O, and the fp8 pool's
    values reach |V| ≈ 7 where |O| stays near 3 (2^-7·max|O|, the bound at
    head dims 16 and 96 with groups up to 4, was passed by one bf16 ulp at
    G 8 and 16, at head dim 128 as at 256)."""
    gen = torch.Generator(device=cuda).manual_seed(d + group * 10 + len(pool))
    hkv, page, n_tbl = 2, 16, 10
    full = n_tbl * page
    lengths = [0, 1, page + 1, full - 3, full]
    byte = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(pool)
    kp, vp, tbl, ks, vs = _paged_pool(gen, cuda, lengths, n_tbl, page, hkv, d,
                                      byte or torch.float32)
    if byte is None:
        kp, vp = kp.to(getattr(torch, pool)), vp.to(getattr(torch, pool))
    cl = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn(len(lengths), hkv * group, d, generator=gen, device=cuda)
    packs = [8] + ([64] if group == 16 else [])
    q_types = (torch.float32, torch.bfloat16) if byte is not None else (kp.dtype,)
    sc = dict(k_scale=ks, v_scale=vs)
    live = tbl[tbl > 0].long()
    v_max = float((vp[live].float() * (1.0 if vs is None else vs[live][:, None, :, None])).abs()
                  .max())

    def bound(dt, want):
        if dt == torch.float32:
            return TOL
        return max(BF16_TOL, 2.0 ** -7 * (v_max if byte is not None else float(want.abs().max())))

    k2.paged_launches = k4.launches = 0
    for dt in q_types:
        for mask in ({}, dict(window=11), dict(chunk=24)):
            o = k2.flashd_decode_paged(q.to(dt), kp, vp, tbl, cl, **sc, **mask)
            want = k2.flashd_decode_paged_plain(q.to(dt), kp, vp, tbl, cl, **sc, **mask)
            assert torch.isfinite(o).all() and (o[0] == 0).all()
            _close(o, want, bound(dt, want))
            assert torch.equal(o, k2.flashd_decode_paged(q.to(dt), kp, vp, tbl, cl, **sc, **mask))
            for bq in packs:
                seq_ids, q_pos = _pack(lengths, [0, 1, 5, 40, 37], bq)  # decode, verify, prompt, chunk
                sid, qp = (torch.tensor(x, dtype=torch.int32, device=cuda) for x in (seq_ids, q_pos))
                qv = torch.randn(len(seq_ids), hkv * group, d, generator=gen, device=cuda).to(dt)
                ov = k4.flashd_varlen(qv, kp, vp, tbl, sid, qp, cl, block_q=bq, **sc, **mask)
                want = k4.flashd_varlen_plain(qv, kp, vp, tbl, sid, qp, cl, block_q=bq, **sc,
                                              **mask)
                assert torch.isfinite(ov).all() and (ov[qp < 0] == 0).all()
                _close(ov, want, bound(dt, want))
                assert torch.equal(ov, k4.flashd_varlen(qv, kp, vp, tbl, sid, qp, cl, block_q=bq,
                                                        **sc, **mask))
    assert k2.paged_launches == 2 * 3 * len(q_types)
    assert k4.launches == 2 * 3 * len(q_types) * len(packs)


def test_varlen_row_groups_at_group_16(cuda):
    """K4's row-group geometry at a group of 16 (`_row_groups`): block_q 8
    makes 2 row groups of 64 a block, block_q 64 makes 16, and the launcher
    takes both; a mixed pack of decode rows and a 16-row chunk at head dim
    128 (qwen3-moe-235b-a22b's shape at Hkv 4) against plain."""
    assert k4._row_groups(8, 16) == (2, 1, 64)
    assert k4._row_groups(64, 16) == (16, 1, 64)
    gen = torch.Generator(device=cuda).manual_seed(16)
    hkv, group, d, page, n_tbl = 4, 16, 128, 64, 4
    plan = StepPlan(segments=tuple(
        Segment(slot=i, tokens=np.zeros(n, np.int32), start=st, emits=n == 1)
        for i, (n, st) in enumerate(((1, 150), (1, 3), (16, 96), (1, 200)))), n_tokens=19)
    for bq in (8, 64):
        _, sid_np, qpos_np, kvl_np, _ = pack_plan(plan, bq, 4)
        sid, qp, kvl = (torch.as_tensor(x, device=cuda) for x in (sid_np, qpos_np, kvl_np))
        q = torch.randn(len(sid_np), hkv * group, d, generator=gen, device=cuda)
        kp, vp, tbl, _, _ = _paged_pool(gen, cuda, kvl_np.tolist(), n_tbl, page, hkv, d)
        o = k4.flashd_varlen(q, kp, vp, tbl, sid, qp, kvl, block_q=bq)
        assert torch.isfinite(o).all() and (o[qp < 0] == 0).all()
        _close(o, k4.flashd_varlen_plain(q, kp, vp, tbl, sid, qp, kvl, block_q=bq))


# the A12 stacks at smoke depth with their full configs' heads: recurrentgemma
# Hq 16 over Hkv 1 of head dim 256, qwen3-moe Hq 32 over Hkv 2 of 128 (G 16)
WIDE_HEADS = {"recurrentgemma-9b": dict(n_heads=16, n_kv_heads=1, head_dim=256),
              "qwen3-moe-235b-a22b": dict(n_heads=32, n_kv_heads=2, head_dim=128)}


@pytest.mark.parametrize("loop", sorted(A12_LOOPS))
@pytest.mark.parametrize("arch", sorted(WIDE_HEADS))
def test_a12_engines_at_head_dim_256_and_group_16(cuda, arch, loop):
    """recurrentgemma-9b (head dim 256, G 16: K1 under the local mask, K2
    on the rings; no pool, so every loop serves on the contiguous one) and
    qwen3-moe-235b-a22b (G 16: K2, K3, K4) at smoke depth with their full
    configs' heads, f32: the captured steps give the eager steps' tokens,
    launch counts and host syncs, and the plain route's tokens; the forward's
    logits within 1e-4 of the plain route's."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **WIDE_HEADS[arch])
    params = init_lm(cfg, device=cuda, seed=1)
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32) for n in (7, 37, 9, 30)]
    sc = ServeConfig(max_batch=2, max_len=64, decode_chunk=3, **A12_LOOPS[loop])
    captured = _served(Engine(params, cfg, sc, device=cuda), reqs, 8)
    eager = _served(Engine(params, cfg, sc, device=cuda, graphs=False), reqs, 8)
    for got, want in zip(captured[:3], eager[:3]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert captured[3:5] == eager[3:5] and captured[3][0] > 0
    if arch == "qwen3-moe-235b-a22b" and loop != "contiguous":
        assert captured[3][1] > 0 and (captured[3][2] > 0) == (loop == "mixed")
    plain_cfg = dataclasses.replace(cfg, attn_impl="flashd_plain")
    before = launch_counts()
    plain = Engine(params, plain_cfg, sc, device=cuda).serve(reqs, 8)
    assert launch_counts() == before
    for g, w in zip(captured[0], plain):
        np.testing.assert_array_equal(g, w)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 40)), device=cuda)
    k1.launches = 0
    with torch.inference_mode():
        logits, _ = apply_lm(params, {"tokens": toks}, cfg)
        logits_p, _ = apply_lm(params, {"tokens": toks}, plain_cfg)
    assert k1.launches > 0
    _close(logits[..., :cfg.vocab_size], logits_p[..., :cfg.vocab_size], 1e-4)
