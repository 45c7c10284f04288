"""Port parity for the vision stub (phi-3-vision-4.2b smoke: 2 dense
layers, 4 heads of 16, 8 patch rows), f32, on the reference's weights
(`init_lm(PRNGKey(0))` through the bridge).

`init_lm` adds `patch_proj` [D, D]; a batch with `patch_embeds` [B, P, D]
projects them and prepends them to the token embeddings, positions over
the whole sequence (the reference's `_embed_inputs`); `lm_loss` drops the
prefix's logits before the cross entropy. Logits within 1e-4, loss and one
train step within 1e-4 relative. Serving stays text-only, as in the
reference engine: greedy tokens on the three loops equal the reference's
and each other."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import get_model as j_get_model
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.models import get_model
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import train_step as tts
from test_torch_archs_serve import LOOPS, _prompts

ARCH = "phi-3-vision-4.2b"
LOGIT_TOL = 1e-4
REL = 1e-4


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
    """(reference cfg, reference params, port cfg, port params), f32."""
    jcfg = dataclasses.replace(j_get_smoke_config(ARCH), dtype="float32")
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, bridge.config_from_reference(jcfg), bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp))


def _batch(cfg, b, s, seed):
    """Tokens, labels and patch embeddings [B, frontend_tokens, D]."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "patch_embeds": rng.standard_normal((b, cfg.frontend_tokens, cfg.d_model))
            .astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def test_init_tree_has_patch_proj_as_reference(model):
    jcfg, jp, tcfg, _ = model
    tp = get_model(tcfg).init(tcfg, device="cpu", seed=0)
    assert tuple(tp["patch_proj"].shape) == (tcfg.d_model, tcfg.d_model)
    shapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    assert jax.tree.map(lambda x: tuple(x.shape), bridge.params_to_numpy(tp)) == shapes


def test_forward_with_patch_embeds_matches_reference(model):
    """S 13 tokens after 8 patch rows: logits [B, 21, V] and last_only; a
    batch without patch_embeds is the text-only forward."""
    jcfg, jp, tcfg, tp = model
    batch = _batch(jcfg, 2, 13, 1)
    del batch["labels"]
    lj, _ = jtf.apply_lm(jp, jax.tree.map(jnp.asarray, batch), jcfg)
    lt, _ = ttf.apply_lm(tp, _torch(batch), tcfg)
    v = jcfg.vocab_size
    assert lt.shape[1] == jcfg.frontend_tokens + 13
    np.testing.assert_allclose(lt.numpy()[..., :v], np.asarray(lj)[..., :v], rtol=0,
                               atol=LOGIT_TOL)
    last, _ = ttf.apply_lm(tp, _torch(batch), tcfg, last_only=True)
    np.testing.assert_allclose(last.numpy()[..., :v], lt.numpy()[:, -1:, :v], rtol=0, atol=1e-5)
    text = {"tokens": batch["tokens"]}
    lj, _ = jtf.apply_lm(jp, jax.tree.map(jnp.asarray, text), jcfg)
    lt, _ = ttf.apply_lm(tp, _torch(text), tcfg)
    assert lt.shape[1] == 13
    np.testing.assert_allclose(lt.numpy()[..., :v], np.asarray(lj)[..., :v], rtol=0,
                               atol=LOGIT_TOL)


def test_lm_loss_drops_the_prefix_as_reference(model):
    """The loss on the text rows only: against the reference's, and against
    the cross entropy of the forward's last S rows."""
    jcfg, jp, tcfg, tp = model
    batch = _batch(jcfg, 2, 13, 2)
    batch["labels"][0, :3] = -1  # masked labels
    lj, mj = jtf.lm_loss(jp, jax.tree.map(jnp.asarray, batch), jcfg)
    lt, mt = ttf.lm_loss(tp, _torch(batch), tcfg)
    assert abs(float(lt) - float(lj)) <= REL * abs(float(lj))
    assert abs(float(mt["ce"]) - float(mj["ce"])) <= REL * abs(float(mj["ce"]))
    logits, _ = ttf.apply_lm(tp, _torch(batch), tcfg)
    text = logits[:, jcfg.frontend_tokens:]
    labels = torch.from_numpy(batch["labels"]).long()
    keep = labels >= 0
    ce = torch.nn.functional.cross_entropy(text[keep], labels[keep])
    assert abs(float(ce) - float(lt)) <= 1e-5 * abs(float(lt))


def test_train_step_with_patch_embeds_matches_reference(model):
    """One AdamW step on a batch with patch rows: loss, ce and grad norm
    within 1e-4 relative; the loss's gradient reaches patch_proj, equal to
    the reference's within 1e-4 of its largest entry."""
    jcfg, jp, tcfg, tp = model
    jtc = jts.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10)
    ttc = tts.TrainConfig(optimizer=tadamw.AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jtc)._replace(params=jp)
    tstate = tts.init_train_state(tcfg, ttc, params=tp)
    batch = _batch(jcfg, 2, 16, 3)
    _, jm = jax.jit(jts.make_train_step(jcfg, jtc))(jstate, jax.tree.map(jnp.asarray, batch))
    _, tm = tts.make_train_step(tcfg, ttc)(tstate, _torch(batch))
    for key in ("loss", "ce", "grad_norm"):
        assert abs(float(jm[key]) - float(tm[key])) <= REL * abs(float(jm[key])), key
    gj = jax.grad(lambda p: jtf.lm_loss(p, jax.tree.map(jnp.asarray, batch), jcfg)[0])(jp)
    gj = np.asarray(gj["patch_proj"])
    w = tp["patch_proj"].clone().requires_grad_()
    loss, _ = ttf.lm_loss({**tp, "patch_proj": w}, _torch(batch), tcfg)
    (gt,) = torch.autograd.grad(loss, [w])
    scale = float(np.abs(gj).max())
    assert scale > 0
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=REL * scale)


def test_text_serving_on_the_three_loops_matches_reference(model):
    """Five requests on two slots, 6 new: each loop's tokens equal the
    reference engine's on the same loop, and the three loops agree."""
    jcfg, jp, tcfg, tp = model
    reqs = _prompts(jcfg, (5, 11, 7, 3, 9), 8)
    got = {}
    for loop, extra in LOOPS.items():
        kw = dict(max_batch=2, max_len=32, decode_chunk=3, **extra)
        want = JEngine(jp, jcfg, JServeConfig(**kw)).serve(reqs, 6)
        te = Engine(tp, tcfg, ServeConfig(**kw), device="cpu")
        got[loop] = te.serve(reqs, 6)
        assert (te._page_layout is None) == (loop == "contiguous")
        assert te._mixed_ok == (loop == "mixed")
        for g, w in zip(got[loop], want):
            np.testing.assert_array_equal(g, w)
    for loop in ("paged", "mixed"):
        for g, w in zip(got[loop], got["contiguous"]):
            np.testing.assert_array_equal(g, w)
