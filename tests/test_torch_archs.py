"""Port parity for the reference's dense-GQA, MoE + chunked-attention,
RG-LRU + local-attention, Mamba-2 and vision-stub configs (deepseek-7b,
qwen2-1.5b, yi-34b, llama4-scout-17b-a16e, qwen3-moe-235b-a22b,
recurrentgemma-9b, mamba2-2.7b, phi-3-vision-4.2b) at smoke width, f32, on
the reference's weights (`init_lm(PRNGKey(0))` through the bridge): the
config data, the forward pass (text only; phi-3's patch rows in
`test_torch_phi3v.py`), and prefill and decode through contiguous, ring,
recurrent and paged caches. One train step is held to the
reference's in `test_torch_archs_train.py`, the serving engines in
`test_torch_archs_serve.py`.

Bounds (f32, summation order only): logits within 1e-4; the MoE aux
values within 1e-6; cache leaves within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import get_model as j_get_model
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import get_model
from repro_torch.models import transformer as ttf

ARCHS = ("deepseek-7b", "qwen2-1.5b", "yi-34b", "llama4-scout-17b-a16e",
         "qwen3-moe-235b-a22b", "recurrentgemma-9b", "mamba2-2.7b", "phi-3-vision-4.2b")
LOGIT_TOL = 1e-4
AUX_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(reference cfg, reference params, port cfg, port params) at smoke width, f32."""
    jcfg = dataclasses.replace(j_get_smoke_config(request.param), dtype="float32")
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, bridge.config_from_reference(jcfg), tparams


def _close(a, b, vocab, tol=LOGIT_TOL):
    a = np.asarray(a, np.float32)[..., :vocab]
    b = np.asarray(b, np.float32)[..., :vocab]
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _leaves_close(jtree, ttree, tol=1e-5):
    """Every leaf of the reference's tree against the port's, by path."""
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jtree))
    got = dict(jax.tree_util.tree_leaves_with_path(bridge.params_to_numpy(ttree)))
    assert len(want) == len(got)
    for path, w in want:
        g = got[path]
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32), rtol=0,
                                   atol=tol, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_data(arch):
    assert get_config(arch) == bridge.config_from_reference(j_get_config(arch))
    assert get_smoke_config(arch) == bridge.config_from_reference(j_get_smoke_config(arch))
    get_model(get_smoke_config(arch))  # every layer kind is ported


def test_the_other_archs_still_raise():
    """What is still refused: serving the encoder-decoder config (the
    reference's engine has no encoder-decoder path) through `Engine` and
    both launchers, and in `check_ported` a frontend or a layer kind outside
    the reference's lists."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.serve import Engine, ServeConfig

    seamless = get_smoke_config("seamless-m4t-medium")
    assert seamless == bridge.config_from_reference(j_get_smoke_config("seamless-m4t-medium"))
    params = get_model(seamless).init(seamless, device="cpu", seed=0)
    with pytest.raises(NotImplementedError, match=r"prefill_lm reads params\['blocks'\]"):
        Engine(params, seamless, ServeConfig(max_batch=2, max_len=32), device="cpu")
    for launcher in (serve_launcher, train_launcher):
        with pytest.raises(SystemExit, match="seamless-m4t-medium"):
            launcher.main(["--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu"])
    text = get_smoke_config("qwen3-0.6b")
    for cfg in (dataclasses.replace(text, frontend="speech"),
                dataclasses.replace(text, pattern=(("attn_sparse", "swiglu"),))):
        with pytest.raises(NotImplementedError, match="the port runs"):
            get_model(cfg)


def test_forward_logits_and_aux_match_reference(model):
    """apply_lm at S 21 (past recurrentgemma's window of 8 and llama4's
    chunk of 16): logits, the summed MoE aux values, and last_only."""
    jcfg, jp, tcfg, tp = model
    toks = _tokens(jcfg, 2, 21, 1)
    lj, aj = jtf.apply_lm(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    lt, at = ttf.apply_lm(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    _close(lj, lt, jcfg.vocab_size)
    assert sorted(at) == sorted(aj)
    for key in aj:
        assert abs(float(aj[key]) - float(at[key])) <= AUX_TOL, key
    assert (float(at["moe_dropped"]) > 0) == (jcfg.n_experts > 0 and float(aj["moe_dropped"]) > 0)
    last, _ = ttf.apply_lm(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg, last_only=True)
    _close(lt[:, -1:], last, jcfg.vocab_size, 1e-5)


def test_init_tree_matches_reference_structure(model):
    jcfg, jp, tcfg, _ = model
    tp = ttf.init_lm(tcfg, device="cpu", seed=0)
    shapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    assert jax.tree.map(lambda x: tuple(x.shape), bridge.params_to_numpy(tp)) == shapes


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_and_decode_match_reference(model, layout):
    """prefill_lm with ragged lengths (dead rows frozen: contiguous, ring and
    recurrent leaves), the whole cache tree after it, then decode steps
    that wrap the rings; a paged layout pages the global layers only."""
    jcfg, jp, tcfg, tp = model
    b, s, max_len = 3, 19, 32
    toks = _tokens(jcfg, b, s, 3)
    lengths = np.array([19, 12, 1], np.int32)
    kw = dict(layout=layout, page_size=4) if layout == "paged" else {}
    jc = jtf.init_decode_cache(b, max_len, jcfg, **kw)
    tc = ttf.init_decode_cache(b, max_len, tcfg, device="cpu", **kw)
    if layout == "paged" and "tbl" in str(jax.tree_util.tree_structure(jc)):
        row = np.arange(1, 1 + b * (max_len // 4), dtype=np.int32).reshape(b, -1)
        jc = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.broadcast_to(row, x.shape) if p[-1].key == "tbl" else x, jc)
        for group in tc.values():
            for leaves in group.values():
                if "tbl" in leaves:
                    leaves["tbl"][:] = torch.from_numpy(row)
    lj, jc = jtf.prefill_lm(jp, jnp.asarray(toks), jc, jcfg, lengths=jnp.asarray(lengths))
    lt, tc = ttf.prefill_lm(tp, torch.from_numpy(toks).long(), tc, tcfg,
                            lengths=torch.from_numpy(lengths))
    _close(lj, lt, jcfg.vocab_size)
    _leaves_close(jc, tc)
    pos = lengths.copy()
    nxt = np.argmax(np.asarray(lj)[:, : jcfg.vocab_size], axis=-1).astype(np.int32)
    decode = jax.jit(jtf.decode_step_lm, static_argnums=(4,))
    for _ in range(6):  # the long row crosses window 8 / chunk 16 slots again
        dj, jc = decode(jp, jc, jnp.asarray(nxt), jnp.asarray(pos), jcfg)
        dt, tc = ttf.decode_step_lm(tp, tc, torch.from_numpy(nxt).long(),
                                    torch.from_numpy(pos).long(), tcfg)
        _close(dj, dt, jcfg.vocab_size)
        nxt = np.argmax(np.asarray(dj)[:, : jcfg.vocab_size], axis=-1).astype(np.int32)
        pos = pos + 1
    _leaves_close(jc, tc)
