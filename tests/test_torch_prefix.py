"""Port parity for the radix prefix cache (A7) in the paged and mixed
loops, against the JAX reference engine at qwen3-0.6b smoke widths (f32,
the same weights), after `tests/test_preemption.py`.

On multi-turn traffic that shares a system prompt, and on an
oversubscribed pool that forces preemption (whose donated pages make the
resume a cache hit), the port's greedy tokens equal the reference's and
those of a port engine with the cache off; the prefix and page counters
(`prefix_lookups`, `prefix_hits`, `hit_tokens`, `prompt_tokens`,
`preemptions`, `evictions`, `donated_pages`) equal the reference's; the
allocator's invariants hold (`check()`)."""

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
from repro_torch.serve import Engine, ServeConfig

COUNTERS = ("prefix_lookups", "prefix_hits", "hit_tokens", "prompt_tokens", "preemptions",
            "evictions", "donated_pages")


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


def _engines(model, **sc):
    """(reference, port, port with the cache off) on the same weights."""
    jcfg, jp, tcfg, tp = model
    return (JEngine(jp, jcfg, JServeConfig(**sc)),
            Engine(tp, tcfg, ServeConfig(**sc), device="cpu"),
            Engine(tp, tcfg, ServeConfig(prefix_cache=False, **sc), device="cpu"))


def _same(model, engines, reqs, n_new, priorities=None):
    """Serve `reqs` on all three engines: tokens equal, counters the
    reference's, allocators consistent. Returns the reference's tokens."""
    je, te, off = engines
    want = je.serve(reqs, n_new, priorities=priorities)
    for eng in (te, off):
        for g, w in zip(eng.serve(reqs, n_new, priorities=priorities), want):
            np.testing.assert_array_equal(g, w)
        eng._alloc.check()
    js, ts = je.stats(), te.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["prefix_cache_enabled"] and not off.stats()["prefix_cache_enabled"]
    return want


@pytest.mark.parametrize("step_mode", ["sequential", "mixed"])
def test_multi_turn_shared_system_prompt_matches_reference(model, step_mode):
    """Turn 2 replays the whole first conversation, a sibling shares only
    the system prompt, then a burst of four siblings shares it while two
    run at once (live prompts are indexed as their prefill completes)."""
    vocab = model[0].vocab_size
    rng = np.random.default_rng(2)
    system = rng.integers(0, vocab, (17,)).astype(np.int32)
    u1, u2 = (rng.integers(0, vocab, (n,)).astype(np.int32) for n in (3, 4))
    engines = _engines(model, max_batch=2, max_len=48, page_size=4, kv_layout="paged",
                       step_mode=step_mode, prefill_chunk=4, token_budget=8, decode_chunk=3)
    turn1 = np.concatenate([system, u1])
    (w1,) = _same(model, engines, [turn1], 4)
    assert engines[1].stats()["hit_tokens"] == 0
    _same(model, engines, [np.concatenate([turn1, w1, u2])], 4)
    warm = engines[1].stats()
    assert warm["hit_tokens"] >= (len(system) // 4) * 4 and warm["prefix_hits"] == 1
    _same(model, engines, [np.concatenate([system, u2])], 4)
    burst = [np.concatenate([system, rng.integers(0, vocab, (n,)).astype(np.int32)])
             for n in (2, 6, 1, 5)]
    _same(model, engines, burst, 5)
    assert engines[1].stats()["prefix_hits"] > warm["prefix_hits"] + 1


@pytest.mark.parametrize("step_mode", ["sequential", "mixed"])
def test_oversubscribed_pool_resumes_from_donated_pages(model, step_mode):
    """A pool of 14 pages where the worst case needs 24: victims are
    preempted, their pages donated, and a resume hits the cache."""
    vocab = model[0].vocab_size
    rng = np.random.default_rng(1)
    reqs = [rng.integers(0, vocab, (13,)).astype(np.int32) for _ in range(4)]
    engines = _engines(model, max_batch=4, max_len=32, kv_layout="paged", page_size=4,
                       kv_pool_tokens=56, step_mode=step_mode, prefill_chunk=4,
                       token_budget=8)
    _same(model, engines, reqs, 10, priorities=[0, 1, 0, 1])
    st = engines[1].stats()
    assert st["preemptions"] > 0 and st["hit_tokens"] > 0 and st["donated_pages"] > 0
