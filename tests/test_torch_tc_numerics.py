"""The numerics of the tensor-core forward kernels (K1, K6), on the CPU.

`csrc/attn_tc.cuh` runs both products on the tensor cores. That changes
how operands are rounded, not what is computed:

- f32 operands go through the 3xTF32 split: x = hi + lo with
  hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x − hi) (10 mantissa bits,
  ties away from zero), and a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b;
- bf16 operands multiply exactly, and P is rounded to bf16 before P·V.

This file emulates that operand rounding in torch (the products summed in
float64, so only the rounding of the operands is modelled), runs it through
FLASH-D's tile loop over 64-key tiles, and holds the result against the JAX
reference `repro.kernels.ref.attention_ref`: 5e-5 in f32 (O and Λ) and
2e-2 in bf16 (O), on scores of ordinary and of large magnitude (q and k
scaled ×4), head dims 48 and 128, a causal mask with and without dead
leading rows. One-pass TF32 (hi·hi alone) breaks the f32 bound on the
large scores: that is why the kernels split. The emulation lives here, not
in the package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockwise as jb
from repro.kernels.ref import attention_ref
from repro_torch.core import blockwise as tb

F32_TOL = 5e-5
BF16_TOL = 2e-2
TILE = 64  # the kernels' physical KV tile


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, ties away from
    zero (half a TF32 ulp added to the magnitude bits, then truncated)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b with the kernel's operand rounding; products summed in f64."""
    if mode == "3xtf32":
        (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
        out = al.double() @ bh.double() + ah.double() @ bl.double() + ah.double() @ bh.double()
    elif mode == "tf32":
        out = tf32_rna(a).double() @ tf32_rna(b).double()
    else:  # bf16: operands already bf16-valued, exact products
        out = a.double() @ b.double()
    return out.float()


def flashd_tc_emulated(q, k, v, mask: tb.MaskSpec, mode: str):
    """FLASH-D's tile loop (the carry of csrc/flashd_fwd.cu) with the
    tensor cores' operand rounding. q [G, Sq, d], k / v [Skv, d], f32."""
    sq, skv, d = q.shape[-2], k.shape[-2], q.shape[-1]
    scale = 1.0 / d ** 0.5
    neg, dead = tb.NEG_INF, tb.NEG_INF / 2
    acc = torch.zeros(*q.shape[:-1], v.shape[-1])
    lam = torch.full(q.shape[:-1], neg)
    q_pos = torch.arange(sq)
    for k0 in range(0, skv, TILE):
        k1 = min(k0 + TILE, skv)
        s = _matmul(q, k[k0:k1].T, mode) * scale
        keep = mask.keep(q_pos, torch.arange(k0, k1))
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
        c = torch.where(tile_dead, 0.0, torch.exp(m_safe - ln))
        pc = p * c[..., None]
        if mode == "bf16":
            pc = pc.bfloat16().float()  # P rounded to bf16 for the mma
        acc = acc * (1.0 - w)[..., None] + _matmul(pc, v[k0:k1], mode)
        lam = ln
    return acc, lam


def _inputs(d, magnitude, dtype, seed=0, g=2, s=200):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((g, s, d)) * magnitude).astype(np.float32)
    k = (rng.standard_normal((s, d)) * magnitude).astype(np.float32)
    v = rng.standard_normal((s, d)).astype(np.float32)
    if dtype == "bf16":  # the kernel's inputs are bf16 values
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v))
    return q, k, v


def _reference(q, k, v, q_offset, dtype):
    """JAX attention_ref on [1, G, S, d] / [1, 1, S, d]; O in the input dtype."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    o, lam = attention_ref(jnp.asarray(q[None], jdt), jnp.asarray(k[None, None], jdt),
                           jnp.asarray(v[None, None], jdt),
                           mask=jb.MaskSpec("causal", q_offset=q_offset))
    return np.asarray(o[0], np.float32), np.asarray(lam[0], np.float32)


def test_tf32_rna_rounds_to_ten_bits_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.14159265,
                      -2.0 ** -100, 1e30])
    hi = tf32_rna(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    # 1 + 2^-11 is half a TF32 ulp above 1: ties go away from zero
    assert hi[0] == 1.0 + 2.0 ** -10 and hi[1] == -(1.0 + 2.0 ** -10) and hi[2] == 1.0
    hi, lo = split_tf32(x)
    assert ((x - hi - lo).abs() <= 2.0 ** -22 * x.abs()).all()


@pytest.mark.parametrize("q_offset", [0, -12])  # -12: dead leading rows
@pytest.mark.parametrize("magnitude", [1.0, 4.0])
@pytest.mark.parametrize("d", [48, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tc_operand_rounding_holds_the_bounds(dtype, d, magnitude, q_offset):
    q, k, v = _inputs(d, magnitude, dtype)
    mask = tb.MaskSpec("causal", q_offset=q_offset)
    mode = "3xtf32" if dtype == "f32" else "bf16"
    o, lam = flashd_tc_emulated(*(torch.from_numpy(x) for x in (q, k, v)), mask, mode)
    o_ref, lam_ref = _reference(q, k, v, q_offset, dtype)
    if dtype == "f32":
        np.testing.assert_allclose(o.numpy(), o_ref, rtol=0, atol=F32_TOL)
        np.testing.assert_allclose(lam.numpy(), lam_ref, rtol=0, atol=F32_TOL)
    else:
        np.testing.assert_allclose(o.bfloat16().float().numpy(), o_ref, rtol=0, atol=BF16_TOL)
    if q_offset < 0:
        assert (o[:, :-q_offset] == 0).all() and (lam[:, :-q_offset] == tb.NEG_INF).all()


@pytest.mark.parametrize("d", [48, 128])
def test_one_pass_tf32_breaks_the_f32_bound(d):
    q, k, v = _inputs(d, 4.0, "f32")
    mask = tb.MaskSpec("causal")
    args = [torch.from_numpy(x) for x in (q, k, v)]
    o_ref, lam_ref = _reference(q, k, v, 0, "f32")
    o1, lam1 = flashd_tc_emulated(*args, mask, "tf32")
    o3, lam3 = flashd_tc_emulated(*args, mask, "3xtf32")
    err1 = max(np.abs(o1.numpy() - o_ref).max(), np.abs(lam1.numpy() - lam_ref).max())
    err3 = max(np.abs(o3.numpy() - o_ref).max(), np.abs(lam3.numpy() - lam_ref).max())
    assert err1 > F32_TOL > err3, (err1, err3)
