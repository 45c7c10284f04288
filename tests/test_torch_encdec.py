"""Port parity for the encoder-decoder stack (seamless-m4t-medium smoke: 2
encoder + 2 decoder layers, 4 heads of 16, the audio-frame stub), f32, on
the reference's weights (`init_encdec(PRNGKey(0))` through the bridge).

T 19 frames against S 12 tokens, so a mix-up of query and key lengths in
cross attention shows. Bounds (f32, summation order only): the encoder's
memory and the cross cache within 1e-5; logits within 1e-4; the loss and a
train step's loss and grad norm within 1e-4 relative, its parameters
within 1e-4 of the update's norm; decode logits within 1e-4 of the
reference's steps and 2e-3 of the port's own forward (the reference's
`tests/test_models.py` bound), the self caches within 1e-5. Serving stays
refused, as the reference's engine has no encoder-decoder path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import encdec as jed
from repro.models import get_model as j_get_model
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.runtime import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.models import encdec as ted
from repro_torch.models import get_model
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import checkpoint as tckpt
from repro_torch.train import train_step as tts
from repro_torch.tree import tree_flatten_with_names, tree_leaves

ARCH = "seamless-m4t-medium"
T, S, B = 19, 12, 2  # frames, tokens, batch
MEM_TOL = 1e-5
LOGIT_TOL = 1e-4
REL = 1e-4
FWD_TOL = 2e-3  # decode against the forward: the reference's tests/test_models.py:103


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


def _batch(cfg, seed, b=B, t=T, s=S):
    """Frame embeddings [B, T, D], tokens and labels [B, S]."""
    rng = np.random.default_rng(seed)
    return {"frame_embeds": rng.standard_normal((b, t, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _jax(batch):
    return jax.tree.map(jnp.asarray, batch)


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _close(got, want, tol, vocab=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _shapes(tree):
    return {k: _shapes(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(tree.shape)


def test_init_tree_matches_reference_structure(model):
    jcfg, jp, tcfg, _ = model
    api = get_model(tcfg)
    assert api.init is ted.init_encdec and api.decode_step is ted.decode_step_encdec
    tp = api.init(tcfg, device="cpu", seed=0)
    assert _shapes(tp) == _shapes(jax.tree.map(np.asarray, jp))
    assert tuple(tp["dec_blocks"]["cross"]["wk"].shape) == (2, 64, 64)
    assert all(x.dtype == torch.float32 for x in tree_leaves(tp))
    assert tp["embed"].abs().max() <= 0.02 * 3 + 1e-6  # truncated at 3σ
    again = ted.init_encdec(tcfg, device="cpu", seed=0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), tree_leaves(again)))


def test_encode_matches_reference(model):
    jcfg, jp, tcfg, tp = model
    frames = _batch(jcfg, 1)["frame_embeds"]
    want = jed.encode(jp, jnp.asarray(frames), jcfg)
    got = ted.encode(tp, torch.from_numpy(frames), tcfg)
    assert got.shape == (B, T, jcfg.d_model)
    _close(got, want, MEM_TOL)


def test_forward_matches_reference(model):
    """Logits [B, S, Vpad] and last_only; the aux values are zeros."""
    jcfg, jp, tcfg, tp = model
    batch = _batch(jcfg, 2)
    lj, aj = jed.apply_encdec(jp, _jax(batch), jcfg)
    lt, at = ted.apply_encdec(tp, _torch(batch), tcfg)
    assert lt.shape == (B, S, jcfg.padded_vocab) and lt.dtype == torch.float32
    _close(lt, lj, LOGIT_TOL, jcfg.vocab_size)
    last, _ = ted.apply_encdec(tp, _torch(batch), tcfg, last_only=True)
    assert last.shape == (B, 1, jcfg.padded_vocab)
    _close(last, lj[:, -1:], LOGIT_TOL, jcfg.vocab_size)
    assert sorted(at) == sorted(aj) and all(float(v) == 0.0 for v in at.values())


def test_loss_matches_reference_with_masked_labels(model):
    jcfg, jp, tcfg, tp = model
    batch = _batch(jcfg, 3)
    batch["labels"][0, :4] = -1
    batch["labels"][1, -3:] = -1
    lj, mj = jed.encdec_loss(jp, _jax(batch), jcfg)
    lt, mt = get_model(tcfg).loss(tp, _torch(batch), tcfg)
    assert sorted(mt) == sorted(mj)
    assert abs(float(lt) - float(lj)) <= REL * abs(float(lj))
    assert float(mt["ce"]) == float(lt)
    logits, _ = ted.apply_encdec(tp, _torch(batch), tcfg)
    labels = torch.from_numpy(batch["labels"]).long()
    keep = labels >= 0
    ce = torch.nn.functional.cross_entropy(logits[keep], labels[keep])
    assert abs(float(ce) - float(lt)) <= 1e-5 * abs(float(lt))


def test_train_step_matches_reference(model):
    """One AdamW step on a frame_embeds batch through both packages'
    `make_train_step`: loss, ce and grad norm within 1e-4 relative; every
    parameter moved, the whole tree within 1e-4 of the update's norm."""
    jcfg, jp, tcfg, tp = model
    # no warmup: the lr peaks at step 0, so the one step moves every leaf
    jtc = jts.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-2), warmup_steps=0, total_steps=10)
    ttc = tts.TrainConfig(optimizer=tadamw.AdamWConfig(lr=1e-2), warmup_steps=0, total_steps=10)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jtc)._replace(params=jp)
    tstate = tts.init_train_state(tcfg, ttc, params=tp)
    batch = _batch(jcfg, 4)
    jstate, jm = jax.jit(jts.make_train_step(jcfg, jtc))(jstate, _jax(batch))
    tstate, tm = tts.make_train_step(tcfg, ttc)(tstate, _torch(batch))
    assert sorted(tm) == sorted(jm)
    for key in ("loss", "ce", "grad_norm"):
        assert abs(float(jm[key]) - float(tm[key])) <= REL * abs(float(jm[key])), key
    assert float(tm["finite"]) == 1.0 and int(tstate.step) == 1
    want = [np.asarray(x) for x in jax.tree.leaves(jstate.params)]
    got = tree_leaves(bridge.params_to_numpy(tstate.params))
    init = [np.asarray(x) for x in jax.tree.leaves(jp)]
    assert all(not np.array_equal(w, i) for w, i in zip(want, init))
    dev = np.sqrt(sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want)))
    upd = np.sqrt(sum(float(((w - i) ** 2).sum()) for w, i in zip(want, init)))
    assert dev <= REL * upd, (dev, upd)


def test_fill_cross_cache_matches_reference(model):
    """The cross leaves take the memory's length T whatever the cache was
    sized to (here 8 < T and 4096 > T), as the reference's."""
    jcfg, jp, tcfg, tp = model
    frames = _batch(jcfg, 5)["frame_embeds"]
    memory = jed.encode(jp, jnp.asarray(frames), jcfg)
    tmem = torch.from_numpy(np.array(memory))
    want = jed.fill_cross_cache(jp, memory, jed.init_encdec_cache(B, 16, 8, jcfg), jcfg)
    for mem_len in (8, 4096):
        got = ted.fill_cross_cache(tp, tmem, ted.init_encdec_cache(B, 16, mem_len, tcfg,
                                                                   device="cpu"), tcfg)
        for key in ("cross_k", "cross_v"):
            assert got[key].shape == (jcfg.n_layers, B, T, jcfg.n_kv_heads, jcfg.head_dim_)
            _close(got[key], want[key], MEM_TOL)
        assert got["self_k"].shape == (jcfg.n_layers, B, 16, jcfg.n_kv_heads, jcfg.head_dim_)


def test_decode_steps_match_reference_and_forward(model):
    """encode → fill_cross_cache → 12 teacher-forced decode steps on the
    `get_model` cache (its paged keywords ignored): each step's logits
    against the reference's step and the port's forward, the self caches
    against the reference's; the cache is the one object, written in
    place."""
    jcfg, jp, tcfg, tp = model
    batch = _batch(jcfg, 6)
    memory = jed.encode(jp, jnp.asarray(batch["frame_embeds"]), jcfg)
    jcache = jed.fill_cross_cache(jp, memory, jed.init_encdec_cache(B, 16, T, jcfg), jcfg)
    tmem = ted.encode(tp, torch.from_numpy(batch["frame_embeds"]), tcfg)
    tcache = get_model(tcfg).init_cache(B, 16, tcfg, device="cpu", layout="paged", page_size=4)
    assert tcache["cross_k"].shape[2] == 16 and "k_pages" not in tcache
    tcache = ted.fill_cross_cache(tp, tmem, tcache, tcfg)
    full, _ = ted.apply_encdec(tp, _torch(batch), tcfg)
    toks = batch["tokens"]
    v = jcfg.vocab_size
    jstep = jax.jit(lambda p, c, tok, pos: jed.decode_step_encdec(p, c, tok, pos, jcfg))
    for t in range(S):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t]), jnp.full((B,), t, jnp.int32))
        tl, out = ted.decode_step_encdec(tp, tcache, torch.from_numpy(toks[:, t]).long(),
                                         torch.full((B,), t), tcfg)
        assert out is tcache and tl.shape == (B, jcfg.padded_vocab)
        _close(tl, jl, LOGIT_TOL, v)
        _close(tl, full[:, t], FWD_TOL, v)
    for key in ("self_k", "self_v"):
        _close(tcache[key], jcache[key], MEM_TOL)
    assert float(tcache["self_k"][:, :, S:].abs().max()) == 0.0  # nothing past the last step


def test_decoder_only_stack_with_bidirectional_layers_matches_reference(model):
    """An `attn_bidir` mixer in a decoder-only stack: the full mask in the
    forward, as the reference's `_attn_mask`."""
    jcfg = dataclasses.replace(j_get_smoke_config("qwen3-0.6b"), dtype="float32",
                               pattern=(("attn_bidir", "swiglu"), ("attn", "swiglu")))
    jp = jtf.init_lm(jax.random.PRNGKey(1), jcfg)
    tcfg = bridge.config_from_reference(jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = _batch(jcfg, 7)["tokens"]
    lj, _ = jtf.apply_lm(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    lt, _ = ttf.apply_lm(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    _close(lt, lj, LOGIT_TOL, jcfg.vocab_size)
    # the bidirectional layer sees the future: the first position's logits
    # change with the last token
    toks2 = toks.copy()
    toks2[:, -1] = (toks2[:, -1] + 1) % jcfg.vocab_size
    lt2, _ = ttf.apply_lm(tp, {"tokens": torch.from_numpy(toks2).long()}, tcfg)
    assert float((lt2[:, 0] - lt[:, 0]).abs().max()) > 1e-4


def _trained(model):
    """(reference TrainConfig, port state one step past init)."""
    jcfg, jp, tcfg, tp = model
    ttc = tts.TrainConfig(warmup_steps=0)
    state = tts.init_train_state(tcfg, ttc, params=tp)
    state, _ = tts.make_train_step(tcfg, ttc)(state, _torch(_batch(jcfg, 8)))
    return jts.TrainConfig(), state


def _assert_same_state(port_state, ref_state):
    names = [n for n, _ in tree_flatten_with_names(port_state)]
    flat = jax.tree_util.tree_flatten_with_path(ref_state)[0]
    assert names == ["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
                     for path, _ in flat]
    for t, (_, r) in zip(tree_leaves(port_state), flat):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def test_train_state_checkpoints_cross_the_packages(model, tmp_path):
    """The port saves an enc-dec train state that the reference restores, and
    restores one the reference saved; the bridge moves it both ways; every
    leaf name and bit equal."""
    jcfg, jp, tcfg, tp = model
    jtc, state = _trained(model)
    tckpt.save(str(tmp_path / "port"), 1, state, extra={"data_step": 1})
    template = jts.init_train_state(jax.random.PRNGKey(3), jcfg, jtc)
    jstate, extra = jckpt.restore(str(tmp_path / "port"), template)
    assert extra == {"data_step": 1}
    _assert_same_state(state, jstate)
    jstate = jstate._replace(step=jnp.int32(5), loss_scale=jnp.float32(0.5))
    jckpt.save(str(tmp_path / "ref"), 5, jstate, extra={"data_step": 5})
    back, extra = tckpt.restore(str(tmp_path / "ref"),
                                tts.init_train_state(tcfg, tts.TrainConfig(), device="cpu",
                                                     seed=2))
    assert extra == {"data_step": 5} and int(back.step) == 5
    _assert_same_state(back, jstate)
    moved = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    _assert_same_state(moved, jstate)


def test_serving_an_encoder_decoder_stack_is_refused(model):
    """The reference's engine dies in prefill_lm on an enc-dec tree; the
    port's refuses it by name on every loop, and so do both launchers at
    full width too."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.serve import Engine, ServeConfig

    _, _, tcfg, tp = model
    for kw in ({}, dict(kv_layout="paged"), dict(step_mode="mixed")):
        with pytest.raises(NotImplementedError, match="no encoder-decoder path"):
            Engine(tp, tcfg, ServeConfig(max_batch=2, max_len=32, **kw), device="cpu")
    for launcher in (serve_launcher, train_launcher):
        with pytest.raises(SystemExit, match="encoder-decoder"):
            launcher.main(["--arch", ARCH, "--device", "cpu"])


def test_bidirectional_layer_stack_serves_with_the_prefix_cache_as_reference():
    """A decoder-only stack with an `attn_bidir` layer decodes it as global
    attention and shares prompt prefixes on the paged loop, as the
    reference's engine (its prefix gate admits `attn_bidir`): greedy
    tokens and the prefix counters equal."""
    from repro.serve import Engine as JEngine
    from repro.serve import ServeConfig as JServeConfig
    from repro_torch.serve import Engine, ServeConfig

    jcfg = dataclasses.replace(j_get_smoke_config("qwen3-0.6b"), dtype="float32",
                               pattern=(("attn_bidir", "swiglu"), ("attn", "swiglu")))
    jp = jtf.init_lm(jax.random.PRNGKey(2), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(9)
    shared = rng.integers(0, jcfg.vocab_size, 16).astype(np.int32)
    reqs = [np.concatenate([shared, rng.integers(0, jcfg.vocab_size, n).astype(np.int32)])
            for n in (3, 5, 2, 4)]
    kw = dict(max_batch=2, max_len=40, kv_layout="paged", page_size=4)
    je = JEngine(jp, jcfg, JServeConfig(**kw))
    te = Engine(tp, bridge.config_from_reference(jcfg), ServeConfig(**kw), device="cpu")
    for g, w in zip(te.serve(reqs, 5), je.serve(reqs, 5)):
        np.testing.assert_array_equal(g, w)
    js, ts = je.stats(), te.stats()
    assert ts["prefix_cache_enabled"] and js["prefix_cache_enabled"]
    for key in ("hit_tokens", "prompt_tokens", "prefix_hits"):
        assert ts[key] == js[key] > 0, key
