"""Port parity: the dense decoder (repro_torch.models) against the JAX
reference on qwen3-0.6b SMOKE and paper-llama, f32, the same weights.

The reference initialises the weights (`init_lm(PRNGKey(0), cfg)`), the
bridge hands the same numbers to the port. Tolerance: logits within 1e-4
(f32; summation order only)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_llama as j_paper_llama
from repro.configs import qwen3_0_6b as j_qwen3
from repro.configs import seamless_m4t_medium as j_seamless
from repro.models import get_model as j_get_model
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import get_model
from repro_torch.models import transformer as ttf

LOGIT_TOL = 1e-4

CONFIGS = {
    "qwen3-0.6b-smoke": dataclasses.replace(j_qwen3.SMOKE, dtype="float32"),
    "paper-llama": j_paper_llama.CONFIG,
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = CONFIGS[request.param]
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, bridge.config_from_reference(jcfg), tparams


def _close(a, b, vocab, tol=LOGIT_TOL):
    a = np.asarray(a, np.float32)[..., :vocab]
    b = np.asarray(b, np.float32)[..., :vocab]
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_apply_lm_matches_reference(model):
    jcfg, jp, tcfg, tp = model
    toks = _tokens(jcfg, 2, 13, 1)
    lj, _ = jtf.apply_lm(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    lt, _ = ttf.apply_lm(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert lt.shape == lj.shape and lt.dtype == torch.float32
    _close(lj, lt, jcfg.vocab_size)
    assert (lt[..., jcfg.vocab_size:] == -1e30).all()  # padded vocab masked
    last, _ = ttf.apply_lm(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg, last_only=True)
    _close(lt[:, -1:], last, jcfg.vocab_size, 1e-5)


def test_lm_loss_matches_reference(model):
    jcfg, jp, tcfg, tp = model
    toks = _tokens(jcfg, 2, 9, 2)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    lj, _ = jtf.lm_loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}, jcfg)
    lt, metrics = ttf.lm_loss(tp, {"tokens": torch.from_numpy(toks).long(),
                                   "labels": torch.from_numpy(labels).long()}, tcfg)
    assert abs(float(lj) - float(lt)) < 1e-4
    assert float(metrics["ce"]) == float(lt)


def test_prefill_and_decode_match_reference(model):
    """prefill_lm's last logits, the filled cache, and the next decode step."""
    jcfg, jp, tcfg, tp = model
    b, s, max_len = 2, 10, 24
    toks = _tokens(jcfg, b, s, 3)
    jc = jtf.init_decode_cache(b, max_len, jcfg)
    lj, jc = jtf.prefill_lm(jp, jnp.asarray(toks), jc, jcfg)
    tc = ttf.init_decode_cache(b, max_len, tcfg, device="cpu")
    lt, tc2 = ttf.prefill_lm(tp, torch.from_numpy(toks).long(), tc, tcfg)
    assert tc2 is tc  # updated in place
    _close(lj, lt, jcfg.vocab_size)
    np.testing.assert_allclose(np.asarray(jc["blocks"]["pos0"]["k"]),
                               tc["blocks"]["pos0"]["k"].numpy(), rtol=0, atol=1e-5)
    nxt = np.argmax(np.asarray(lj)[:, : jcfg.vocab_size], axis=-1).astype(np.int32)
    pos = np.full((b,), s, np.int32)
    dj, _ = jtf.decode_step_lm(jp, jc, jnp.asarray(nxt), jnp.asarray(pos), jcfg)
    dt, _ = ttf.decode_step_lm(tp, tc, torch.from_numpy(nxt).long(), torch.from_numpy(pos).long(), tcfg)
    _close(dj, dt, jcfg.vocab_size)


def test_prefill_lengths_and_start_pos_match_reference(model):
    """Ragged `lengths` (padding rows frozen, logits at lengths−1) and a tail
    prefill from `start_pos` on top of a filled cache."""
    jcfg, jp, tcfg, tp = model
    b, s, max_len = 3, 9, 20
    toks = _tokens(jcfg, b, s, 4)
    lengths = np.array([9, 4, 1], np.int32)
    jc = jtf.init_decode_cache(b, max_len, jcfg)
    lj, jc = jtf.prefill_lm(jp, jnp.asarray(toks), jc, jcfg, lengths=jnp.asarray(lengths))
    tc = ttf.init_decode_cache(b, max_len, tcfg, device="cpu")
    lt, tc = ttf.prefill_lm(tp, torch.from_numpy(toks).long(), tc, tcfg,
                            lengths=torch.from_numpy(lengths))
    _close(lj, lt, jcfg.vocab_size)
    np.testing.assert_allclose(np.asarray(jc["blocks"]["pos0"]["v"]),
                               tc["blocks"]["pos0"]["v"].numpy(), rtol=0, atol=1e-5)
    assert (tc["blocks"]["pos0"]["k"][:, 2, 1:] == 0).all()  # frozen past length 1

    tail = _tokens(jcfg, b, 5, 5)
    lj2, _ = jtf.prefill_lm(jp, jnp.asarray(tail), jc, jcfg, start_pos=s)
    lt2, _ = ttf.prefill_lm(tp, torch.from_numpy(tail).long(), tc, tcfg, start_pos=s)
    _close(lj2, lt2, jcfg.vocab_size)


def test_bridge_round_trip_and_config_mapping():
    jcfg = dataclasses.replace(j_qwen3.SMOKE, attn_impl="flashd_pallas")
    tcfg = bridge.config_from_reference(jcfg)
    assert tcfg.attn_impl == "flashd_gpu"
    assert tcfg.compute_dtype == torch.bfloat16 and tcfg.master_dtype == torch.float32
    assert dataclasses.replace(tcfg, attn_impl="flashd") == get_smoke_config("qwen3-0.6b")
    import ml_dtypes

    leaf = np.arange(6, dtype=np.float32).reshape(2, 3).astype(ml_dtypes.bfloat16)
    t = bridge.params_from_numpy({"a": {"b": leaf}})
    assert t["a"]["b"].dtype == torch.bfloat16
    back = bridge.params_to_numpy(t)
    np.testing.assert_array_equal(back["a"]["b"], leaf.astype(np.float32))


def test_port_configs_are_the_reference_data():
    for name, jmod in (("qwen3-0.6b", j_qwen3), ("paper-llama", j_paper_llama),
                       ("seamless-m4t-medium", j_seamless)):
        for tc, jc in ((get_config(name), jmod.CONFIG), (get_smoke_config(name), jmod.SMOKE)):
            assert tc == bridge.config_from_reference(jc)
    # what is still refused: a name the reference does not know
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("seamless-m4t-large")


def test_init_lm_tree_matches_reference_structure():
    jcfg = dataclasses.replace(j_qwen3.SMOKE, dtype="float32")
    tcfg = bridge.config_from_reference(jcfg)
    jshapes = jax.tree.map(lambda x: x.shape, jax.eval_shape(
        lambda: j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)))
    tp = get_model(tcfg).init(tcfg, device="cpu", seed=0)

    def shapes(tree):
        return {k: shapes(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(tree.shape)

    assert shapes(tp) == jax.tree.map(tuple, jshapes, is_leaf=lambda x: isinstance(x, tuple))
    tp2 = ttf.init_lm(tcfg, device="cpu", seed=0)
    assert torch.equal(tp["blocks"]["pos0"]["mixer"]["wq"], tp2["blocks"]["pos0"]["mixer"]["wq"])
    assert tp["embed"].abs().max() <= 0.02 * 3 + 1e-6  # truncated at 3σ


def test_unported_mixers_raise():
    # a mixer outside the reference's list is still refused
    bad = dataclasses.replace(get_smoke_config("qwen3-0.6b"), pattern=(("attn_sparse", "swiglu"),))
    with pytest.raises(NotImplementedError, match="not a layer kind of the reference"):
        ttf.init_lm(bad, device="cpu")
    # a quantized pool (A8) needs the paged layout, as the reference's
    with pytest.raises(ValueError, match="requires layout='paged'"):
        ttf.init_decode_cache(1, 8, get_smoke_config("qwen3-0.6b"), kv_dtype="int8",
                              device="cpu")
    with pytest.raises(ValueError, match="layout"):
        ttf.init_decode_cache(1, 8, get_smoke_config("qwen3-0.6b"), layout="ring", device="cpu")
