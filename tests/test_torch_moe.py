"""Port parity for the Mixture-of-Experts FFN and the MoE configs
(llama4-scout-17b-a16e: chunked attention + a NoPE global layer, top-1 of
4 experts at smoke width; qwen3-moe-235b-a22b: top-2 of 8), f32, on the
reference's weights.

`apply_moe` against the reference's: outputs and the three aux values
within 1e-6, on a batch that drops tokens past capacity, a top-2 batch,
a router whose probabilities all tie (the reference's top-k takes the
lowest expert index first), and one with room for every token. On
llama4 (its serving loops are held to the reference's in
`test_torch_moe_serve.py`): a chaos schedule whose faults hit after a step
has advanced its rings and its dead slot — statuses, tokens, fault checks
and counters equal the reference's; and an int8 pool — only the global
layer's pool quantizes, and its pages hold the reference engine's codes
(see the test for the one-code exception)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import moe as jmoe
from repro.serve import Engine as JEngine
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import OracleDraft as JOracleDraft
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.models import moe as tmoe
from repro_torch.serve import Engine, FaultInjector, ServeConfig
from repro_torch.serve.speculative import OracleDraft
from test_torch_archs_serve import _check_chaos, _model

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MOE_CASES = {  # (config, capacity_factor, router scale)
    "top1-drops": ("llama4-scout-17b-a16e", 0.5, 1.0),
    "top2": ("qwen3-moe-235b-a22b", 1.25, 1.0),
    "tied-router": ("qwen3-moe-235b-a22b", 1.25, 0.0),
    "no-drops": ("llama4-scout-17b-a16e", 8.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_matches_reference(case):
    arch, cf, router_scale = MOE_CASES[case]
    jcfg = dataclasses.replace(j_get_smoke_config(arch), dtype="float32", capacity_factor=cf)
    tcfg = bridge.config_from_reference(jcfg)
    jp = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
    jp = {**jp, "router": jp["router"] * router_scale}
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(2).standard_normal((3, 11, jcfg.d_model)).astype(np.float32)
    yj, aj = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    yt, at = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=TOL)
    for key in tmoe.AUX_KEYS:
        assert abs(float(at[key]) - float(aj[key])) <= TOL, key
    dropped = float(at["moe_dropped"])
    if case != "top2":
        assert (dropped > 0) == (case != "no-drops"), dropped
    if case == "tied-router":  # every token on experts 0 and 1: capacity keeps 2·cap of 66 choices
        cap = tmoe.capacity(33, tcfg)
        assert dropped == pytest.approx(1 - 2 * cap / 66, abs=1e-6)


def test_pool_write_takes_each_duplicate_from_its_last_writer():
    """On an MoE stack dead slots and padding rows write the garbage page 0
    at duplicate indices, and its rows feed the router: every duplicate
    takes its last writer's row, so the scatter stores what a sequential
    one does in any order of application."""
    from repro_torch.models.transformer import _last_writer, _write_pool

    dest = torch.tensor([4, 0, 4, 7, 0, 4])
    assert _last_writer(dest).tolist() == [5, 4, 5, 3, 4, 5]
    tcfg = _model("llama4-scout-17b-a16e")[2]
    pid, slot = torch.tensor([0, 2, 0, 0, 3]), torch.tensor([1, 0, 1, 1, 2])
    rows = torch.randn(2, 5, 2, 16, generator=torch.Generator().manual_seed(0))
    cache = {"k_pages": torch.zeros(4, 4, 2, 16), "v_pages": torch.zeros(4, 4, 2, 16)}
    _write_pool(cache, rows[0], rows[1], pid, slot, slot == 0, tcfg)
    for i in (1, 3, 4):  # row 3 is page 0's last writer
        assert torch.equal(cache["k_pages"][pid[i], slot[i]], rows[0, i])
        assert torch.equal(cache["v_pages"][pid[i], slot[i]], rows[1, i])


@pytest.mark.parametrize("loop", ["contiguous", "paged"])
def test_chaos_after_a_state_update_matches_reference(loop):
    """llama4's rings and its dead slot's rows (which feed the router)
    advanced by a faulted step come back before the retry."""
    _check_chaos("llama4-scout-17b-a16e", loop)


@pytest.mark.parametrize("mode", ["sequential", "mixed"])
def test_chaos_with_speculation_matches_reference(mode):
    """qwen3-moe on the paged pool with speculation (an `OracleDraft` at
    0.6, 3 drafts) under a schedule whose device_step faults discard
    verify rounds that ran: what a round wrote to page 0, which padding
    rows and dead slots read back into the router, comes back before the
    retry, as the reference discards the round's new cache — statuses,
    tokens, spec counters, fault checks and host syncs equal the
    reference's."""
    jcfg, jp, tcfg, tp = _model("qwen3-moe-235b-a22b")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jcfg.vocab_size, (n,)).astype(np.int32) for n in (5, 9, 13, 7)]
    sc = dict(max_batch=2, max_len=64, kv_layout="paged", page_size=8, step_mode=mode)
    base = JEngine(jp, jcfg, JServeConfig(**sc)).serve(prompts, 8)
    schedule = [("device_step", 3), ("device_step", 6), ("host_sync", 8)]
    je = JEngine(jp, jcfg, JServeConfig(**sc, spec_tokens=3),
                 draft=JOracleDraft(prompts, base, jcfg.vocab_size, accuracy=0.6, seed=4),
                 fault_injector=JFaultInjector(schedule=schedule))
    te = Engine(tp, tcfg, ServeConfig(**sc, spec_tokens=3), device="cpu",
                draft=OracleDraft(prompts, base, tcfg.vocab_size, accuracy=0.6, seed=4),
                fault_injector=FaultInjector(schedule=schedule))
    want, got = je.serve(prompts, 8), te.serve(prompts, 8)
    js, ts = je.stats(), te.stats()
    assert ts["request_status"] == js["request_status"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for key in ("fault_checks", "injected_faults", "failed", "retried", "spec_rounds",
                "spec_drafted", "spec_accepted"):
        assert ts[key] == js[key], key
    assert ts["injected_faults"]["device_step"] == 2 and ts["spec_rounds"] > 0
    assert te.host_syncs == je.host_syncs
    te._alloc.check(te._paged.cache)


def test_int8_pool_pages_match_reference():
    """llama4 on an int8 paged pool: the NoPE layer's pool holds int8 codes
    with per-(page, kv head) scales, the chunked layers' rings stay f32;
    the tokens are the reference's, and after the serve every page but the
    garbage page 0 holds the reference engine's codes (scales within 1e-6
    relative). The f32 K/V rows entering the quantizer come out of three
    MoE layers and agree with the reference's to ~1e-6, not bitwise, so a
    row within that distance of a rounding boundary takes the neighbouring
    code: codes may differ by one, in at most 1 of 1000 entries. The write
    path itself is byte-equal on the same rows
    (`test_torch_quant.py::test_write_paths_byte_equal_to_reference`)."""
    jcfg, jp, tcfg, tp = _model("llama4-scout-17b-a16e")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jcfg.vocab_size, (n,)).astype(np.int32) for n in (5, 9, 13, 7)]
    sc = dict(max_batch=2, max_len=64, kv_layout="paged", page_size=8, kv_dtype="int8")
    je = JEngine(jp, jcfg, JServeConfig(**sc))
    te = Engine(tp, tcfg, ServeConfig(**sc), device="cpu")
    want, got = je.serve(prompts, 8), te.serve(prompts, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    te._alloc.check(te._paged.cache)
    blocks = te._paged.cache["blocks"]
    for j in range(3):
        assert set(blocks[f"pos{j}"]) == {"k", "v"} and blocks[f"pos{j}"]["k"].dtype == torch.float32
    pool, jpool = blocks["pos3"], je._paged_cache["blocks"]["pos3"]
    assert pool["k_pages"].dtype == torch.int8
    for leaf in ("k_pages", "v_pages"):
        t = pool[leaf][:, 1:].numpy().astype(np.int32)
        j = np.asarray(jpool[leaf])[:, 1:].astype(np.int32)
        assert np.abs(t - j).max() <= 1 and (t != j).mean() <= 1e-3, leaf
    for leaf in ("k_scale", "v_scale"):
        np.testing.assert_allclose(pool[leaf][:, 1:].numpy(), np.asarray(jpool[leaf])[:, 1:],
                                   rtol=1e-6, atol=0, err_msg=leaf)
    assert te.stats()["kv_bytes_per_token"] == je.stats()["kv_bytes_per_token"]
