"""Port parity: the serving engine (repro_torch.serve) against the JAX
reference `Engine` (attn_impl 'flashd') on the same weights, f32.

Greedy tokens must be identical: `generate`, and `serve` on the contiguous
sequential loop, including the EOS, max_new_tokens=1 and decode_chunk
edges and priority preemption; `serve` on the paged loop and the mixed
loop (preemption on and off, an oversubscribed pool that forces
preemption), which must also equal the port's contiguous loop and leave
the page allocator consistent. Temperature sampling uses a torch
Generator, which cannot match jax.random: it is tested for shape, range
and seed determinism only."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_llama as j_paper_llama
from repro.configs import qwen3_0_6b as j_qwen3
from repro.models import get_model as j_get_model
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.serve import Engine, ServeConfig, sample_token

CONFIGS = {
    "qwen3-0.6b-smoke": dataclasses.replace(j_qwen3.SMOKE, dtype="float32"),
    "paper-llama": j_paper_llama.CONFIG,
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jcfg = CONFIGS[request.param]
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, bridge.config_from_reference(jcfg), tparams


def _engines(model, **serve_kw):
    jcfg, jp, tcfg, tp = model
    return (JEngine(jp, jcfg, JServeConfig(**serve_kw)),
            Engine(tp, tcfg, ServeConfig(**serve_kw), device="cpu"))


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lengths]


def test_generate_matches_reference_with_one_host_sync(model):
    jcfg = model[0]
    je, te = _engines(model, max_len=32)
    prompts = np.stack(_prompts(jcfg, (7, 7, 7), 1))
    want = je.generate(prompts, max_new_tokens=6)
    before = te.host_syncs
    got = te.generate(prompts, max_new_tokens=6)
    assert te.host_syncs - before == 1  # the whole loop stays on the device
    np.testing.assert_array_equal(got, want)
    assert got.max() < jcfg.vocab_size
    np.testing.assert_array_equal(te.generate(prompts[:1], max_new_tokens=1), want[:1, :1])
    assert te.host_syncs - before == 2


def test_generate_eos_masking_matches_reference(model):
    jcfg = model[0]
    prompts = np.stack(_prompts(jcfg, (5, 5), 2))
    plain = _engines(model, max_len=32)[1].generate(prompts, max_new_tokens=6)
    je, te = _engines(model, max_len=32, eos_id=int(plain[0, 2]))
    want = je.generate(prompts, max_new_tokens=6)
    got = te.generate(prompts, max_new_tokens=6)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 3:] == plain[0, 2]).all()


@pytest.mark.parametrize("max_new,chunk", [(5, 3), (1, 8), (6, 1)])
def test_serve_matches_reference(model, max_new, chunk):
    jcfg = model[0]
    je, te = _engines(model, max_batch=2, max_len=32, decode_chunk=chunk)
    reqs = _prompts(jcfg, (4, 9, 6, 3, 7), 3)
    want = je.serve(reqs, max_new_tokens=max_new)
    before = te.host_syncs
    got = te.serve(reqs, max_new_tokens=max_new)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert te.peak_active == je.peak_active
    assert sorted(te.ttft) == list(range(len(reqs)))
    assert te.stats()["request_status"] == {i: "done" for i in range(len(reqs))}
    # one sync per prefill, one per decode chunk
    n_chunks = te.host_syncs - before - len(reqs)
    assert 0 <= n_chunks <= len(reqs) * -(-max_new // chunk)


def test_serve_eos_and_priorities_match_reference(model):
    jcfg = model[0]
    reqs = _prompts(jcfg, (6, 5, 8, 4), 4)
    plain = _engines(model, max_batch=2, max_len=32, decode_chunk=2)[1].serve(reqs, 6)
    kw = dict(max_batch=2, max_len=32, decode_chunk=2, eos_id=int(plain[1][1]))
    je, te = _engines(model, **kw)
    prios = [0, 0, 2, 1]  # later, more urgent arrivals preempt live slots
    want = je.serve(reqs, max_new_tokens=6, priorities=prios)
    got = te.serve(reqs, max_new_tokens=6, priorities=prios)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert te.stats()["preemptions"] == je.stats()["preemptions"]


def test_serve_matches_generate(model):
    jcfg = model[0]
    te = _engines(model, max_batch=3, max_len=32, decode_chunk=4)[1]
    reqs = _prompts(jcfg, (5, 8, 6, 5), 5)
    outs = te.serve(reqs, max_new_tokens=5)
    for r, o in zip(reqs, outs):
        np.testing.assert_array_equal(o, te.generate(r[None], 5)[0])


def test_sampling_temperature_shape_range_and_seed():
    logits = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    logits[:, 50:] = -1e30  # padded vocab is never drawn
    cfg = ServeConfig(temperature=0.8, top_k=5)
    a = sample_token(logits, torch.Generator().manual_seed(7), cfg)
    b = sample_token(logits, torch.Generator().manual_seed(7), cfg)
    assert a.shape == (4,) and torch.equal(a, b)
    top5 = torch.topk(logits, 5).indices
    assert all(int(t) in top5[i].tolist() for i, t in enumerate(a))
    draws = torch.stack([sample_token(logits, g, ServeConfig(temperature=1.0))
                         for g in [torch.Generator().manual_seed(1)] for _ in range(50)])
    assert draws.max() < 50 and len(set(draws[:, 0].tolist())) > 1
    assert torch.equal(sample_token(logits, None, ServeConfig()), logits.argmax(-1))


def test_engine_sampling_is_seed_deterministic(model):
    jcfg, _, tcfg, tp = model
    prompts = np.stack(_prompts(jcfg, (6, 6), 6))
    cfg = ServeConfig(max_len=32, temperature=1.0, seed=3)
    a = Engine(tp, tcfg, cfg, device="cpu").generate(prompts, 5)
    b = Engine(tp, tcfg, cfg, device="cpu").generate(prompts, 5)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 5) and a.max() < jcfg.vocab_size


def test_unported_serving_options_raise(model):
    _, _, tcfg, tp = model
    # the paged pools refuse the prefix cache (A7) — on by default, as the reference
    for kw, item in (({"kv_layout": "paged"}, "A7"), ({"step_mode": "mixed"}, "A7"),
                     ({"kv_dtype": "int8"}, "A8"), ({"spec_tokens": 2}, "A9"),
                     ({"fault_rate": 0.1}, "A10")):
        with pytest.raises(NotImplementedError, match=item):
            Engine(tp, tcfg, ServeConfig(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="prefix_cache=False"):
        Engine(tp, tcfg, ServeConfig(kv_layout="paged"), device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        Engine(tp, tcfg, ServeConfig(kv_layout="paged", prefix_cache=False, kv_dtype="int8"),
               device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        Engine(tp, tcfg, ServeConfig(), device="cpu").snapshot()
    # the contiguous loop ignores the prefix-cache flags, as the reference does
    Engine(tp, tcfg, ServeConfig(prefix_cache=True), device="cpu")


# ---- the paged and mixed loops ----

POOL_MODES = {
    "paged": dict(kv_layout="paged"),
    "paged-no-preemption": dict(kv_layout="paged", preemption=False),
    "mixed": dict(step_mode="mixed"),
    "mixed-no-preemption": dict(step_mode="mixed", preemption=False),
}


def _check_pool(te):
    te._alloc.check()
    assert te._alloc.pages_in_use == 0  # every page freed at the end
    st = te.stats()
    assert st["kv_pool_bytes"] > 0 and st["kv_dtype"] == "native"
    lay = te._page_layout
    assert st["kv_pool_bytes"] == st["kv_bytes_per_token"] * lay.n_pages * lay.page_size


@pytest.mark.parametrize("mode", sorted(POOL_MODES))
def test_paged_and_mixed_serve_match_reference(model, mode):
    jcfg = model[0]
    kw = dict(max_batch=2, max_len=40, decode_chunk=3, prefix_cache=False, **POOL_MODES[mode])
    je, te = _engines(model, **kw)
    reqs = _prompts(jcfg, (4, 19, 6, 3, 11), 3)
    want = je.serve(reqs, max_new_tokens=6)
    got = te.serve(reqs, max_new_tokens=6)
    contiguous = _engines(model, max_batch=2, max_len=40, decode_chunk=3)[1].serve(reqs, 6)
    for g, w, c in zip(got, want, contiguous):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, c)
    assert te.peak_active == je.peak_active
    assert te.stats()["request_status"] == {i: "done" for i in range(len(reqs))}
    _check_pool(te)
    # the pool lives on the engine: a second call reuses it, same tokens
    alloc = te._alloc
    again = te.serve(reqs[:2], max_new_tokens=6)
    assert te._alloc is alloc
    for g, w in zip(again, want[:2]):
        np.testing.assert_array_equal(g, w)
    _check_pool(te)


@pytest.mark.parametrize("mode", ["paged", "mixed", "mixed-no-preemption"])
def test_oversubscribed_pool_matches_reference(model, mode):
    """A pool of 8 usable 4-token pages for 2 slots that want up to 7 each:
    with preemption the victim re-queues and recomputes, without it the head
    waits for frees; tokens stay the reference's either way."""
    jcfg = model[0]
    kw = dict(max_batch=2, max_len=40, decode_chunk=3, prefix_cache=False, page_size=4,
              kv_pool_tokens=32, **POOL_MODES[mode])
    je, te = _engines(model, **kw)
    reqs = _prompts(jcfg, (4, 19, 6, 3, 11), 3)
    want = je.serve(reqs, max_new_tokens=6)
    got = te.serve(reqs, max_new_tokens=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert te.stats()["preemptions"] == je.stats()["preemptions"]
    assert (te.stats()["preemptions"] > 0) == te.sc.preemption
    _check_pool(te)


def test_paged_serve_priorities_and_eos_match_reference(model):
    jcfg = model[0]
    reqs = _prompts(jcfg, (6, 5, 8, 4), 4)
    plain = _engines(model, max_batch=2, max_len=32, decode_chunk=2)[1].serve(reqs, 6)
    prios = [0, 0, 2, 1]
    for mode in ("paged", "mixed"):
        kw = dict(max_batch=2, max_len=32, decode_chunk=2, eos_id=int(plain[1][1]),
                  prefix_cache=False, **POOL_MODES[mode])
        je, te = _engines(model, **kw)
        want = je.serve(reqs, max_new_tokens=6, priorities=prios)
        got = te.serve(reqs, max_new_tokens=6, priorities=prios)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert te.stats()["preemptions"] == je.stats()["preemptions"]
        _check_pool(te)


def test_pool_too_small_for_a_request_raises_and_recovers(model):
    from repro_torch.runtime import PageError

    jcfg = model[0]
    te = _engines(model, max_batch=2, max_len=40, kv_layout="paged", prefix_cache=False,
                  page_size=4, kv_pool_tokens=12)[1]
    with pytest.raises(PageError):
        te.serve(_prompts(jcfg, (30,), 5), max_new_tokens=4)
    out = te.serve(_prompts(jcfg, (5,), 6), max_new_tokens=4)  # a fresh pool
    assert len(out[0]) == 4
    _check_pool(te)
