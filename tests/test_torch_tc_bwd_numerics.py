"""The numerics of the tensor-core backward (K5), on the CPU.

`csrc/flashd_bwd.cu` runs all five products of the backward on the tensor
cores. That changes how operands are rounded, not what is computed:

- f32 operands go through the 3xTF32 split on every product (S = Q·Kᵀ,
  dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO): x = hi + lo with
  hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x − hi);
- bf16 operands multiply exactly, and P and dS are rounded to bf16 before
  the products that take them (dV = Pᵀ·dO, dQ = dS·K, dK = dSᵀ·Q).

This file emulates that operand rounding in torch (each product summed in
float64 and rounded to f32 once, so only the operands' rounding and the
per-tile f32 accumulation of the gradients are modelled), runs it through
the kernels' tile loops — dQ over 64-key tiles (32 at head dim 256, the
d-256 tile plan of `csrc/flashd_bwd.cuh`), dK and dV over the G heads ×
64-row q tiles — and holds dQ, dK and dV against the JAX reference's
backward from saved (O, Λ), `repro.core.blockwise.blockwise_backward`
(one call per q head, dK and dV summed over the group; O and Λ from
`repro.kernels.ref.attention_ref`), as the port's parity tests take it:
rtol 1e-4 / atol 1e-5 per entry in f32, 2^-7·max|grad| in bf16 (on the
same bf16-valued inputs, the reference in f32); on scores of ordinary and
of large magnitude (q and k scaled ×4, scores up to ±60), head dims 48,
128 and 256, a causal mask with and without dead leading rows. At ×1 the f32
emulation is also held to `jax.grad` of `attention_ref` itself.

At ×4 no two f32 evaluations of the backward agree within atol 1e-5: the
reference's own f32 `blockwise_backward` lies up to ~8e-5 beyond rtol
1e-4 from the exact (float64) evaluation of the same formula on the same
inputs. There both are held against that exact evaluation, and the
emulation must be no farther from it than the reference is (or within
atol 1e-5) — the bound the GPU test holds the kernel to against its
plain version. The emulation lives here, not in the package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockwise as jb
from repro.kernels.ref import attention_ref
from repro_torch.core import blockwise as tb
from test_torch_tc_numerics import _matmul

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
GRAD_BF16 = 2.0 ** -7
TILE = 64  # the kernels' q tiles, and the dQ kernel's KV tiles up to head dim 128


def key_tile(d):
    """The dQ kernel's KV tile: 32 keys at head dim 256 (`Plan::DQ_BN`)."""
    return TILE if d <= 128 else 32


def _mm(a, b, mode):
    """a @ b: exact in float64 for mode "f64", else `_matmul`'s rounding."""
    return a.double() @ b.double() if mode == "f64" else _matmul(a, b, mode)


def flashd_bwd_tc_emulated(q, k, v, lam, do, dsum, mask: tb.MaskSpec, mode: str):
    """K5's tile loops with the tensor cores' operand rounding. q / do
    [G, Sq, d], k / v [Skv, d], lam / dsum [G, Sq], f32 tensors; mode
    "3xtf32", "bf16" (operands already bf16-valued) or "f64" (float64
    tensors, exact products). Returns (dq, dk, dv)."""
    g_, sq, d = q.shape
    skv = k.shape[0]
    scale = 1.0 / d ** 0.5
    dead = tb.NEG_INF / 2

    def p_ds(qt, dot, lamt, dsumt, q0, k0, bk=TILE):
        """P and dS of a (q tile, key tile of bk keys) pair, rows = q."""
        s = _mm(qt, k[k0:k0 + bk].T, mode) * scale
        keep = mask.keep(torch.arange(q0, q0 + qt.shape[-2]), torch.arange(k0, min(k0 + bk, skv)))
        live = keep & (lamt > dead)[..., None]
        p = torch.where(live, torch.exp(s - lamt[..., None]), torch.zeros_like(s))
        dp = _mm(dot, v[k0:k0 + bk].T, mode)
        ds = p * (dp - dsumt[..., None]) * scale
        if mode == "bf16":  # rounded to bf16 for the mma that takes them
            return p.bfloat16().float(), ds.bfloat16().float()
        return p, ds

    dq = torch.zeros_like(q)  # the dQ kernel: per q block, over the KV tiles
    bk = key_tile(d)
    for k0 in range(0, skv, bk):
        _, ds = p_ds(q, do, lam, dsum, 0, k0, bk)
        dq = dq + _mm(ds, k[k0:k0 + bk], mode)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)  # the dK/dV kernel: per KV block
    for k0 in range(0, skv, TILE):
        for h in range(g_):  # the group's heads, then the q tiles
            for q0 in range(0, sq, TILE):
                sl = slice(q0, q0 + TILE)
                p, ds = p_ds(q[h, sl], do[h, sl], lam[h, sl], dsum[h, sl], q0, k0)
                dv[k0:k0 + TILE] += _mm(p.T, do[h, sl], mode)
                dk[k0:k0 + TILE] += _mm(ds.T, q[h, sl], mode)
    return dq, dk, dv


def _inputs(d, magnitude, dtype, seed=0, g=2, s=200):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((g, s, d)) * magnitude).astype(np.float32)
    k = (rng.standard_normal((s, d)) * magnitude).astype(np.float32)
    v = rng.standard_normal((s, d)).astype(np.float32)
    do = rng.standard_normal((g, s, d)).astype(np.float32)
    if dtype == "bf16":  # the kernel's inputs are bf16 values
        q, k, v, do = (torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v, do))
    return q, k, v, do


def _reference(q, k, v, do, q_offset):
    """JAX, f32: (O, Λ) of attention_ref on [1, G, S, d] / [1, 1, S, d];
    the gradients of blockwise_backward from them (per q head, dK and dV
    summed over the group); and jax.grad of Σ attention_ref∘dO."""
    mask = jb.MaskSpec("causal", q_offset=q_offset)
    args = [jnp.asarray(q[None]), jnp.asarray(k[None, None]), jnp.asarray(v[None, None])]
    o, lam = attention_ref(*args, mask=mask)
    o, lam = np.asarray(o[0]), np.asarray(lam[0])
    per_head = [jb.blockwise_backward(q[h], k, v, o[h], lam[h], do[h], mask=mask, block_k=TILE)
                for h in range(q.shape[0])]
    bwd = (np.stack([np.asarray(x[0]) for x in per_head]),
           sum(np.asarray(x[1]) for x in per_head), sum(np.asarray(x[2]) for x in per_head))
    loss = lambda q_, k_, v_: jnp.sum(attention_ref(q_, k_, v_, mask=mask)[0] * do[None])
    dq, dk, dv = (np.asarray(x, np.float32) for x in jax.grad(loss, argnums=(0, 1, 2))(*args))
    return o, lam, bwd, (dq[0], dk[0, 0], dv[0, 0])


def _excess(a, exact):
    """The largest error beyond rtol·|exact| (what atol must cover)."""
    a, exact = np.asarray(a, np.float64), np.asarray(exact, np.float64)
    return float((np.abs(a - exact) - GRAD_RTOL * np.abs(exact)).max())


@pytest.mark.parametrize("q_offset", [0, -12])  # -12: dead leading rows
@pytest.mark.parametrize("magnitude", [1.0, 4.0])
@pytest.mark.parametrize("d", [48, 128, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tc_bwd_operand_rounding_holds_the_bounds(dtype, d, magnitude, q_offset):
    q, k, v, do = _inputs(d, magnitude, dtype)
    o, lam, want, autodiff = _reference(q, k, v, do, q_offset)
    dsum = np.sum(do * o, axis=-1)  # D = rowsum(dO ∘ O), the wrapper's reduction
    x = [torch.from_numpy(np.array(a)) for a in (q, k, v, lam, do, dsum)]
    mask = tb.MaskSpec("causal", q_offset=q_offset)
    got = flashd_bwd_tc_emulated(*x, mask, "3xtf32" if dtype == "f32" else "bf16")
    exact = flashd_bwd_tc_emulated(*(a.double() for a in x), mask, "f64")
    for a, w, ad, t in zip(got, want, autodiff, exact):
        if dtype == "bf16":
            np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                       atol=GRAD_BF16 * float(np.abs(w).max()))
        elif magnitude == 1.0:
            np.testing.assert_allclose(a.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL)
            np.testing.assert_allclose(a.numpy(), ad, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        else:
            assert _excess(a, t) <= max(GRAD_ATOL, _excess(w, t)), (_excess(a, t), _excess(w, t))
    if q_offset < 0:  # dead rows: P = 0, so no gradient flows through them
        assert (got[0][:, :-q_offset] == 0).all()
