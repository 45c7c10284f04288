"""Port parity: the serving engine on the reference's dense-GQA configs
(deepseek-7b, qwen2-1.5b, yi-34b; phi-3-vision-4.2b, text only) at smoke
width, f32, on the reference's weights, against the reference `Engine`
(attn_impl 'flashd'): greedy tokens identical on every loop the reference
runs for the config, and `generate`. The helpers here serve the MoE
configs (`test_torch_moe*.py`), recurrentgemma (`test_torch_rglru.py`)
and mamba2 (`test_torch_mamba2.py`) too, chaos parity included:
contiguous for all, paged where a global-attention layer takes the pool
(llama4's NoPE layer beside its chunked rings), mixed where every mixer is
global attention. A stack a loop does not take falls back as the
reference's does; the routing itself is compared config by config.

MoE capacity is shared by every row of a step, so a dead slot's rows and a
pack's padding rows steer which tokens are dropped: equal tokens on the
MoE configs also pin the values the port stages there."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import get_model as j_get_model
from repro.models.transformer import packed_mixers_ok as j_packed_mixers_ok
from repro.models.transformer import paged_mixers as j_paged_mixers
from repro.serve import Engine as JEngine
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.serve import Engine, FaultInjector, ServeConfig

ARCHS = ("deepseek-7b", "qwen2-1.5b", "yi-34b", "phi-3-vision-4.2b")
LOOPS = {"contiguous": {}, "paged": dict(kv_layout="paged"), "mixed": dict(step_mode="mixed")}


def _runs(arch: str, loop: str) -> bool:
    """Does the reference's engine run `loop` for `arch` (no fallback)?"""
    cfg = j_get_smoke_config(arch)
    if loop == "paged":
        return bool(j_paged_mixers(cfg))
    if loop == "mixed":
        return bool(j_paged_mixers(cfg)) and j_packed_mixers_ok(cfg)
    return True


def _cases(archs):
    return [(a, loop) for a in archs for loop in LOOPS if _runs(a, loop)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(arch: str):
    """(reference cfg, reference params, port cfg, port params), f32, cached."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(j_get_smoke_config(arch), dtype="float32")
        jp = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
        tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
        _MODELS[arch] = (jcfg, jp, bridge.config_from_reference(jcfg), tp)
    return _MODELS[arch]


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lengths]


def _check_serve(arch: str, loop: str) -> None:
    """Three requests on two slots (the third waits for a slot, so a dead
    slot steps beside a live one), 6 new tokens, decode chunks of 3."""
    jcfg, jp, tcfg, tp = _model(arch)
    kw = dict(max_batch=2, max_len=32, decode_chunk=3, **LOOPS[loop])
    reqs = _prompts(jcfg, (5, 11, 7), 3)
    want = JEngine(jp, jcfg, JServeConfig(**kw)).serve(reqs, 6)
    te = Engine(tp, tcfg, ServeConfig(**kw), device="cpu")
    got = te.serve(reqs, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert te.stats()["request_status"] == {i: "done" for i in range(len(reqs))}
    if te._alloc is not None:
        te._alloc.check(te._paged.cache)
        assert te._alloc.pages_in_use == te._alloc.cached_pages


def _check_routing_and_generate(arch: str) -> None:
    """Each loop setting picks the loop the reference's engine picks (pool,
    packed step, prefix cache); `generate` gives the reference's tokens."""
    jcfg, jp, tcfg, tp = _model(arch)
    for kw in LOOPS.values():
        je = JEngine(jp, jcfg, JServeConfig(max_len=32, **kw))
        te = Engine(tp, tcfg, ServeConfig(max_len=32, **kw), device="cpu")
        assert (te._page_layout is None) == (je._page_layout is None)
        assert te._mixed_ok == je._mixed_ok and te._cache_on == je._cache_on
    prompts = np.stack(_prompts(jcfg, (6, 6), 4))
    np.testing.assert_array_equal(te.generate(prompts, 5), je.generate(prompts, 5))



def _check_chaos(arch: str, loop: str) -> None:
    """The reference's chaos widths (`tests/test_chaos.py` `_sc`) and a
    schedule whose device_step fault hits after the third decode chunk has
    run (rings written, recurrent state advanced, a dead slot stepped) and
    whose host_sync fault hits later: the port puts back what the
    discarded step advanced in place, as the reference discards its new
    cache — statuses, tokens, checks, faults, counters and host syncs
    equal the reference's."""
    jcfg, jp, tcfg, tp = _model(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jcfg.vocab_size, (n,)).astype(np.int32) for n in (5, 9, 13, 7)]
    schedule = [("device_step", 2), ("host_sync", 5)]
    kw = dict(max_batch=2, max_len=32)
    if loop == "paged":
        kw.update(kv_layout="paged", page_size=4, kv_pool_tokens=96)
    je = JEngine(jp, jcfg, JServeConfig(**kw), fault_injector=JFaultInjector(schedule=schedule))
    te = Engine(tp, tcfg, ServeConfig(**kw), device="cpu",
                fault_injector=FaultInjector(schedule=schedule))
    want, got = je.serve(prompts, 6), te.serve(prompts, 6)
    js, ts = je.stats(), te.stats()
    assert ts["request_status"] == js["request_status"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ts["fault_checks"] == js["fault_checks"]
    assert ts["injected_faults"] == js["injected_faults"]
    assert ts["injected_faults"]["device_step"] == ts["injected_faults"]["host_sync"] == 1
    for key in ("failed", "retried", "expired", "preemptions"):
        assert ts[key] == js[key], key
    assert te.host_syncs == je.host_syncs


@pytest.mark.parametrize("arch, loop", _cases(ARCHS))
def test_serve_matches_reference(arch, loop):
    _check_serve(arch, loop)


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_generate_match_reference(arch):
    _check_routing_and_generate(arch)
