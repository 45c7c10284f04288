"""The engine's steps over static buffers (`repro_torch.serve.graphs`), on
the CPU path: the same step functions the card captures as CUDA graphs,
run eagerly over the same buffers.

Greedy tokens must be identical to the JAX reference engine's (attn_impl
'flashd', f32, qwen3-0.6b smoke widths, the same weights) for `generate`
and for `serve` on the contiguous, paged and mixed loops at chunk sizes 1
and 3; `generate` also equals a plain eager loop of `prefill_lm` and
`decode_step_lm`. A second serve() reuses the engine's caches and buffers
and gives the same tokens. Graphs on a CPU engine raise. The captured path
itself is tested on the card (`tests/test_torch_gpu.py`, `-m gpu`)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as j_qwen3
from repro.models import get_model as j_get_model
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.models.transformer import decode_step_lm, prefill_lm
from repro_torch.serve import Engine, ServeConfig, sample_token
from repro_torch.serve.graphs import StepGraphs

LOOPS = {
    "contiguous": dict(),
    "paged": dict(kv_layout="paged", page_size=8),
    "mixed": dict(step_mode="mixed", page_size=8, prefill_chunk=6),
}


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
    jcfg = dataclasses.replace(j_qwen3.SMOKE, dtype="float32")
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, bridge.config_from_reference(jcfg), tparams


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]


def test_generate_matches_reference_and_plain_loop(model):
    jcfg, jp, tcfg, tp = model
    prompts = np.stack(_prompts(jcfg.vocab_size, (9, 9, 9), 1))
    sc = dict(max_batch=3, max_len=40)
    want = JEngine(jp, jcfg, JServeConfig(**sc)).generate(prompts, 7)
    te = Engine(tp, tcfg, ServeConfig(**sc), device="cpu")
    got = te.generate(prompts, 7)
    np.testing.assert_array_equal(got, want)
    with torch.inference_mode():  # the eager loop the static steps replaced
        cache = te.api.init_cache(3, 40, tcfg, device="cpu")
        logits, _ = prefill_lm(tp, torch.as_tensor(prompts).long(), cache, tcfg)
        pos, plain = torch.full((3,), 9), []
        for _ in range(7):
            plain.append(sample_token(logits, None, te.sc))
            logits, _ = decode_step_lm(tp, cache, plain[-1], pos, tcfg)
            pos = pos + 1
    np.testing.assert_array_equal(got, torch.stack(plain, 1).numpy())
    bank = te._contig[3]
    np.testing.assert_array_equal(te.generate(prompts, 7), want)  # the cache, zeroed, reused
    assert te._contig[3] is bank and te.host_syncs == 2


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_static_steps_match_reference(model, loop, chunk):
    jcfg, jp, tcfg, tp = model
    sc = dict(max_batch=2, max_len=48, decode_chunk=chunk, **LOOPS[loop])
    reqs = _prompts(jcfg.vocab_size, (5, 21, 8, 3, 14), 2)
    want = JEngine(jp, jcfg, JServeConfig(**sc)).serve(reqs, 6)
    te = Engine(tp, tcfg, ServeConfig(**sc), device="cpu")
    got = te.serve(reqs, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    bank = te._paged if loop != "contiguous" else te._contig[2]
    bufs = {k: v.data_ptr() for k, v in bank._bufs.items()}
    for g, w in zip(te.serve(reqs, 6), want):  # a second call: the same buffers
        np.testing.assert_array_equal(g, w)
    assert (te._paged if loop != "contiguous" else te._contig[2]) is bank
    assert all(bank._bufs[k].data_ptr() == p for k, p in bufs.items())
    if loop == "mixed":  # packs of two or more power-of-two lengths, one buffer each
        assert len({k[1] for k in bank._bufs if k[0] == "pack"}) >= 2


def test_graphs_need_a_cuda_engine(model):
    _, _, tcfg, tp = model
    with pytest.raises(ValueError, match="CUDA graphs"):
        Engine(tp, tcfg, ServeConfig(), device="cpu", graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs"):
        StepGraphs(torch.device("cpu"), graphs=True)
    assert not Engine(tp, tcfg, ServeConfig(), device="cpu")._steps.graphs
