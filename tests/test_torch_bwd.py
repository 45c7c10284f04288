"""Port parity: the attention backward (K5's plain version, the autograd
Function) and the FA2 baseline (K6's plain version) against the JAX
reference on the same numpy inputs.

Tolerances (f32; the two sides sum in different orders, nothing else
differs): gradients within rtol 1e-4 / atol 1e-5, the reference's own
kernel-vs-autodiff bound (`tests/test_kernels.py`); O and Λ within 5e-5,
its kernel-vs-mirror bound. Pallas kernels run in interpret mode at the
reference tests' sizes (sq, skv ≤ 49, d 16)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as j_qwen3
from repro.core import attention as ja
from repro.core import blockwise as jb
from repro.kernels.fa2_fwd import fa2_fwd_pallas
from repro.kernels.flashd_bwd import flashd_bwd_pallas
from repro.kernels.ref import attention_ref
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.core import attention as ta
from repro_torch.core import blockwise as tb
from repro_torch.kernels import ops
from repro_torch.kernels.fa2_fwd import fa2_fwd_plain
from repro_torch.kernels.flashd_bwd import flashd_bwd_plain
from repro_torch.models import transformer as ttf

TOL = 5e-5

MASKS = [
    ("full", 0, 0, 0),
    ("causal", 0, 0, 0),
    ("causal", 0, 0, -9),  # the leading rows see no key: dead rows
    ("local", 7, 0, 0),
    ("chunked", 0, 8, 0),
]


def _masks(kind, window, chunk, q_offset):
    return (jb.MaskSpec(kind, window, chunk, q_offset),
            tb.MaskSpec(kind, window, chunk, q_offset))


def _grads_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   rtol=1e-4, atol=1e-5)


def _operands(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    shapes = ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("mask,group", [(MASKS[0], 1), (MASKS[1], 2), (MASKS[2], 4),
                                        (MASKS[3], 4), (MASKS[4], 2)])
def test_plain_bwd_matches_autodiff_of_the_reference(mask, group):
    """flashd_bwd_plain (K5's plain version) == jax.grad of `attention_ref`,
    ragged sq ≠ skv, dead rows included; Hq 4 over Hkv 4, 2, 1."""
    jm, tm = _masks(*mask)
    q, k, v, do = _operands(group, 2, 4, 4 // group, 33, 49, 16)
    o, lam = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm)

    def loss(q_, k_, v_):
        return jnp.sum(attention_ref(q_, k_, v_, mask=jm)[0] * do)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    got = flashd_bwd_plain(*(torch.from_numpy(np.asarray(x)) for x in (q, k, v, o, lam, do)),
                           mask=tm, block_q=16, block_k=16)
    _grads_close([g.numpy() for g in got], want)
    if mask[3] < 0:  # dead rows get P = 0: no gradient through them
        assert (got[0][:, :, :-mask[3]] == 0).all()


@pytest.mark.parametrize("mask,group,sq,skv", [
    (("full", 0, 0, 0), 1, 20, 36),
    (("local", 7, 0, 0), 4, 36, 29),
    (("causal", 0, 0, -9), 2, 30, 30),
])
def test_plain_bwd_matches_the_pallas_kernel(mask, group, sq, skv):
    """flashd_bwd_plain == flashd_bwd_pallas (interpret mode) on the same
    saved (O, Λ)."""
    jm, tm = _masks(*mask)
    q, k, v, do = _operands(sq + group, 1, 2 * group, 2, sq, skv, 16)
    o, lam = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm)
    want = flashd_bwd_pallas(*(jnp.asarray(x) for x in (q, k, v, o, lam, do)), mask=jm,
                             block_q=16, block_k=16, interpret=True)
    got = flashd_bwd_plain(*(torch.from_numpy(np.asarray(x)) for x in (q, k, v, o, lam, do)),
                           mask=tm, block_q=16, block_k=16)
    _grads_close([g.numpy() for g in got], want)


@pytest.mark.parametrize("mask", MASKS)
def test_blockwise_backward_and_fa2_match_the_reference(mask):
    """The single-head tile loops: `blockwise_backward` and `blockwise_fa2`
    against the reference's, at tiles that leave ragged edges."""
    jm, tm = _masks(*mask)
    rng = np.random.default_rng(3)
    q, do = (rng.standard_normal((23, 16)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((31, 16)).astype(np.float32) for _ in range(2))
    o, lam = jb.blockwise_flashd(q, k, v, mask=jm, block_q=8, block_k=8)
    want = jb.blockwise_backward(q, k, v, np.asarray(o), np.asarray(lam), do, mask=jm,
                                 block_k=8)
    got = tb.blockwise_backward(*(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lam, do)),
                                mask=tm, block_q=8, block_k=8)
    _grads_close([g.numpy() for g in got], want)
    o_j, lam_j = jb.blockwise_fa2(q, k, v, mask=jm, block_q=8, block_k=8)
    o_t, lam_t = tb.blockwise_fa2(*(torch.from_numpy(x) for x in (q, k, v)), mask=tm,
                                  block_q=8, block_k=8)
    np.testing.assert_allclose(o_t.numpy(), o_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(lam_t.numpy(), lam_j, rtol=0, atol=TOL)
    if mask[3] < 0:
        assert (o_t[:-mask[3]] == 0).all() and (lam_t[:-mask[3]] == tb.NEG_INF).all()


@pytest.mark.parametrize("mask,group", [
    (("causal", 0, 0, 0), 2), (("full", 0, 0, 0), 1), (("chunked", 0, 8, 0), 4),
    (("causal", 0, 0, -9), 2),
])
def test_plain_fa2_matches_the_pallas_kernel(mask, group):
    jm, tm = _masks(*mask)
    q, k, v, _ = _operands(7 + group, 2, 2 * group, 2, 36, 29, 16)
    o_j, lam_j = fa2_fwd_pallas(*(jnp.asarray(x) for x in (q, k, v)), mask=jm, block_q=16,
                                block_k=16, interpret=True)
    o_t, lam_t = fa2_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), mask=tm)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=0, atol=TOL)


IMPL_PAIRS = [  # (reference impl, port impl)
    ("flashd", "flashd"), ("flashd", "flashd_plain"), ("flashd_pallas", "flashd"),
    ("fa2", "fa2"), ("fa2", "fa2_plain"), ("naive", "naive"), ("xla", "xla"),
]


@pytest.mark.parametrize("impls,mask", [(p, ("causal", 0, 0, -4)) for p in IMPL_PAIRS]
                         + [(p, ("local", 5, 0, 0)) for p in IMPL_PAIRS[:1] + IMPL_PAIRS[3:4]],
                         ids=lambda x: "-".join(map(str, x)))
def test_flash_attention_grads_match_the_reference(impls, mask):
    """Every impl of `flash_attention` differentiates like the reference's
    (custom_vjp for all but 'xla', autodiff of plain softmax for 'xla')."""
    jimpl, timpl = impls
    jm, tm = _masks(*mask)
    rng = np.random.default_rng(0)
    q, w = (rng.standard_normal((2, 19, 4, 16)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, 19, 2, 16)).astype(np.float32) for _ in range(2))
    loss = lambda *x: jnp.sum(ja.flash_attention(*x, mask=jm, impl=jimpl) * w)
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    (ta.flash_attention(*xs, mask=tm, impl=timpl) * torch.from_numpy(w)).sum().backward()
    _grads_close([x.grad.numpy() for x in xs], want)


def test_skip_does_not_reach_the_backward():
    """With tile skip on, the forward is approximate but the backward
    recomputes exact probabilities, as the reference's does. Scores are
    sharpened 8× so that tiles do get skipped; the gradients then reach
    ~20 and are held to 1e-5 of their largest entry (plus rtol 1e-4)."""
    rng = np.random.default_rng(1)
    q = (8 * rng.standard_normal((1, 40, 2, 16))).astype(np.float32)
    k, v = (rng.standard_normal((1, 40, 2, 16)).astype(np.float32) for _ in range(2))
    loss = lambda *x: jnp.sum(ja.flash_attention(*x, impl="flashd", skip=True, block_k=8) ** 2)
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = ta.flash_attention(*xs, impl="flashd", skip=True, block_k=8)
    exact = ta.flash_attention(*xs, impl="flashd", block_k=8)
    assert float((o - exact).abs().max()) > 1e-6  # some tile was skipped
    (o ** 2).sum().backward()
    for x, w in zip(xs, want):
        w = np.asarray(w)
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())


def test_kernel_impls_refuse_cpu_tensors_in_both_directions():
    q = torch.zeros(1, 8, 2, 32, requires_grad=True)
    for impl in ("flashd_gpu", "fa2_gpu"):
        with pytest.raises(ValueError, match="CUDA kernel"):
            ta.flash_attention(q, q, q, impl=impl)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.get_op("attention_bwd")(q, q, q, q, torch.zeros(1, 2, 8), q,
                                    mask=tb.MaskSpec("causal"), scale=1.0)


@pytest.fixture(scope="module")
def qwen3_loss_and_grads():
    """qwen3-0.6b SMOKE (f32) weights, a batch with masked labels, and the
    reference's loss and gradients on them (remat changes no value)."""
    jcfg = dataclasses.replace(j_qwen3.SMOKE, dtype="float32")
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    labels = np.where(rng.random((2, 12)) < 0.2, -1,
                      rng.integers(0, jcfg.vocab_size, (2, 12))).astype(np.int32)
    batch = {"tokens": toks, "labels": labels}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.lm_loss(p, b, jcfg), has_aux=True))(jparams, batch)
    return jcfg, jparams, batch, float(loss), grads


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_loss_grads_match_the_reference_under_every_remat(qwen3_loss_and_grads, remat):
    """`lm_loss` is differentiable and rematerialization changes no value:
    loss and every parameter gradient equal the reference's (1e-5 relative
    to the loss and to each leaf's largest gradient)."""
    jcfg, jparams, batch, jl, jg = qwen3_loss_and_grads
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    for leaf in jax.tree.leaves(tparams):
        leaf.requires_grad_()
    tcfg = dataclasses.replace(bridge.config_from_reference(jcfg), remat=remat)
    tl, metrics = ttf.lm_loss(tparams, {k: torch.from_numpy(x) for k, x in batch.items()}, tcfg)
    tl.backward()
    assert abs(float(tl) - jl) <= 1e-5 * abs(jl)
    assert float(metrics["ce"]) == float(tl)
    for want, got in zip(jax.tree.leaves(jg), jax.tree.leaves(tparams)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
