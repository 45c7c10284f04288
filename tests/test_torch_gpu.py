"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the `gpu` marker and skips without a CUDA device.
This file imports torch and the port only, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: O and Λ within 5e-5 in f32 (summation order only); bf16 O
within 2e-2 (one bf16 rounding of |O| < 4); engine tokens identical."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import blockwise as tb
from repro_torch.kernels import flashd_decode as k2
from repro_torch.kernels import flashd_fwd as k1
from repro_torch.models.transformer import apply_lm, init_lm
from repro_torch.serve import Engine, ServeConfig

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
    with pytest.raises(RuntimeError, match="A11"):
        k1.flashd_fwd(q, q, q)
    qd = torch.randn(1, 2, 64, device=cuda)
    kc = torch.randn(1, 2, 8, 64, device=cuda)
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
