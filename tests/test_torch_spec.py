"""Port parity for speculative decoding (A9), after `tests/test_speculative.py`
(its chaos test is mirrored with the fault-tolerant engine's, in
`tests/test_torch_chaos.py`).

Speculative serving is token-identical to non-speculative greedy serving at
any acceptance rate: `OracleDraft` (the reference's seeded corruption,
draw for draw) sweeps accuracies 0, 0.5 and 1 at K 1 and 4 through the
paged and the mixed loops, on native and int8 pools, against the port's
non-speculative run and the reference's tokens; the `spec_*` counters
equal the reference engine's for the same oracle seed. A self-draft (the
target's own weights, through `DraftModel`) accepts everything; a draft
model of the target's first layer runs the whole sync / propose /
committed path; a draft proposing ids outside the vocab is harmless. After
every rollback the allocator's invariants hold, the radix tree never
indexes a page of unaccepted draft KV, and deadlines expire cleanly.

CPU, qwen3-0.6b smoke widths, f32, the reference's weights."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as j_qwen3
from repro.models import get_model as j_get_model
from repro.serve import Engine as JEngine
from repro.serve import OracleDraft as JOracleDraft
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.runtime import PagedKVAllocator, PageError
from repro_torch.serve import Engine, Scheduler, ServeConfig
from repro_torch.serve.engine import pack_verify
from repro_torch.serve.scheduler import DONE, EXPIRED, Segment, StepPlan
from repro_torch.serve.speculative import DraftModel, OracleDraft
from repro_torch.tree import tree_map

N_NEW = 8
MODES = ("paged", "mixed")
COUNTERS = ("spec_rounds", "spec_drafted", "spec_accepted")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sc(mode: str, **kw) -> dict:
    base = dict(max_batch=2, max_len=64, temperature=0.0, kv_layout="paged", page_size=8)
    if mode == "mixed":
        base["step_mode"] = "mixed"
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def spec_fixture():
    """Weights, prompts, and each (loop, pool) non-speculative run of the
    reference and of the port (which must agree)."""
    jcfg = dataclasses.replace(j_qwen3.SMOKE, dtype="float32")
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    tcfg = bridge.config_from_reference(jcfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jcfg.vocab_size, (n,)).astype(np.int32) for n in (5, 9, 13, 7)]
    base = {}
    for mode in MODES:
        for kv in ("", "int8"):
            want = JEngine(jp, jcfg, JServeConfig(**_sc(mode, kv_dtype=kv))).serve(prompts, N_NEW)
            got = Engine(tp, tcfg, ServeConfig(**_sc(mode, kv_dtype=kv)),
                         device="cpu").serve(prompts, N_NEW)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            base[mode, kv] = want
    return jcfg, jp, tcfg, tp, prompts, base


def _same(outs, ref):
    for i, (a, b) in enumerate(zip(ref, outs)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("accuracy", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("kv_dtype", ["", "int8"])
@pytest.mark.parametrize("mode", MODES)
def test_spec_token_identity(spec_fixture, mode, kv_dtype, accuracy, k):
    """Any acceptance rate, either loop, either pool: the tokens of the
    non-speculative run (the port's equals the reference's, fixture), and
    the allocator's invariants after the serve."""
    _, _, tcfg, tp, prompts, base = spec_fixture
    ref = base[mode, kv_dtype]
    oracle = OracleDraft(prompts, ref, tcfg.vocab_size, accuracy=accuracy, seed=5)
    eng = Engine(tp, tcfg, ServeConfig(**_sc(mode, kv_dtype=kv_dtype, spec_tokens=k)),
                 device="cpu", draft=oracle)
    _same(eng.serve(prompts, N_NEW), ref)
    eng._alloc.check(eng._paged.cache)
    s = eng.stats()
    assert s["spec_enabled"] and s["spec_drafted"] == s["spec_accepted"] + s["spec_rejected"]
    assert s["spec_drafted"] > 0
    if accuracy == 1.0:
        assert s["spec_acceptance_rate"] == 1.0
    if accuracy == 0.0:
        assert s["spec_accepted"] == 0


@pytest.mark.parametrize("accuracy", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("kv_dtype", ["", "int8"])
@pytest.mark.parametrize("mode", MODES)
def test_spec_counters_match_reference(spec_fixture, mode, kv_dtype, accuracy):
    """The same oracle seed through both engines: the same tokens, rounds,
    drafted and accepted counts, and host syncs per serve."""
    jcfg, jp, tcfg, tp, prompts, base = spec_fixture
    ref = base[mode, kv_dtype]
    sc = _sc(mode, kv_dtype=kv_dtype, spec_tokens=3)
    je = JEngine(jp, jcfg, JServeConfig(**sc),
                 draft=JOracleDraft(prompts, ref, jcfg.vocab_size, accuracy=accuracy, seed=9))
    te = Engine(tp, tcfg, ServeConfig(**sc), device="cpu",
                draft=OracleDraft(prompts, ref, tcfg.vocab_size, accuracy=accuracy, seed=9))
    want = je.serve(prompts, N_NEW)
    _same(te.serve(prompts, N_NEW), want)
    _same(want, ref)
    js, ts = je.stats(), te.stats()
    assert {c: ts[c] for c in COUNTERS} == {c: js[c] for c in COUNTERS}
    assert ts["spec_mean_accepted"] == js["spec_mean_accepted"]
    assert te.host_syncs == je.host_syncs


@pytest.mark.parametrize("mode", MODES)
def test_self_draft_identity(spec_fixture, mode):
    """The target as its own draft (a `DraftModel` of the same weights)
    accepts every proposal: acceptance exactly 1.0, more than one token a
    round, the tokens unchanged."""
    _, _, tcfg, tp, prompts, base = spec_fixture
    eng = Engine(tp, tcfg, ServeConfig(**_sc(mode, spec_tokens=3)), device="cpu",
                 draft=(tp, tcfg))
    assert isinstance(eng._spec.draft, DraftModel)
    _same(eng.serve(prompts, N_NEW), base[mode, ""])
    s = eng.stats()
    assert s["spec_acceptance_rate"] == 1.0 and s["spec_rounds"] > 0
    assert s["spec_mean_accepted"] > 1
    eng._alloc.check(eng._paged.cache)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
@pytest.mark.parametrize("mode", MODES)
def test_small_draft_model(spec_fixture, mode, kv_dtype):
    """A one-layer draft cut from the target (its first layer, embedding
    and head) through the whole sync / propose / committed path: tokens
    unchanged, and no host sync on the draft's side."""
    _, _, tcfg, tp, prompts, base = spec_fixture
    dcfg = dataclasses.replace(tcfg, n_layers=1)
    dparams = dict(tp, blocks=tree_map(lambda x: x[:1], tp["blocks"]))
    eng = Engine(tp, tcfg, ServeConfig(**_sc(mode, kv_dtype=kv_dtype, spec_tokens=4)),
                 device="cpu", draft=(dparams, dcfg))
    _same(eng.serve(prompts, N_NEW), base[mode, kv_dtype])
    s = eng.stats()
    assert s["spec_rounds"] > 0 and s["spec_drafted"] > 0
    draft = eng._spec.draft
    assert draft.runner.host_syncs == 0  # proposals never visit the host
    eng._alloc.check(eng._paged.cache)


def test_draft_with_mismatched_vocab_is_safe(spec_fixture):
    """Ids past the vocab are clamped before they embed, and acceptance
    compares the clamped id, so the stream is unchanged."""
    _, _, tcfg, tp, prompts, base = spec_fixture

    def junk_draft(rid, tokens, kk):
        return np.full((kk,), tcfg.vocab_size + 1000, np.int32)

    for mode in MODES:
        eng = Engine(tp, tcfg, ServeConfig(**_sc(mode, spec_tokens=3)), device="cpu",
                     draft=junk_draft)
        _same(eng.serve(prompts, N_NEW), base[mode, ""])
        assert eng.stats()["spec_drafted"] > 0


def test_allocator_invariants_after_every_rollback(spec_fixture, monkeypatch):
    _, _, tcfg, tp, prompts, base = spec_fixture
    calls = []
    orig = PagedKVAllocator.rollback

    def checked(self, seq, new_len):
        freed = orig(self, seq, new_len)
        self.check()
        calls.append(freed)
        return freed

    monkeypatch.setattr(PagedKVAllocator, "rollback", checked)
    for mode in MODES:
        oracle = OracleDraft(prompts, base[mode, ""], tcfg.vocab_size, accuracy=0.2, seed=3)
        eng = Engine(tp, tcfg, ServeConfig(**_sc(mode, spec_tokens=4)), device="cpu",
                     draft=oracle)
        _same(eng.serve(prompts, N_NEW), base[mode, ""])
    assert calls, "a 20%-accuracy draft must trigger rollbacks"
    assert any(f > 0 for f in calls), "some rollback must free whole pages"


def test_radix_tree_never_holds_draft_pages(spec_fixture):
    """Every chain the radix tree indexes after a rejection-heavy serve is a
    prefix of a committed stream; a warm second serve is identical."""
    _, _, tcfg, tp, prompts, base = spec_fixture
    for mode in MODES:
        oracle = OracleDraft(prompts, base[mode, ""], tcfg.vocab_size, accuracy=0.3, seed=9)
        eng = Engine(tp, tcfg, ServeConfig(**_sc(mode, spec_tokens=4)), device="cpu",
                     draft=oracle)
        outs = eng.serve(prompts, N_NEW)
        streams = [np.concatenate([p, np.asarray(o, np.int64)]) for p, o in zip(prompts, outs)]
        chains = eng._alloc.cached_chains()
        assert chains
        for chain in chains:
            assert any(len(chain) <= len(s_) and np.array_equal(chain, s_[:len(chain)])
                       for s_ in streams), f"cached chain {chain} is not a committed prefix"
        _same(eng.serve(prompts, N_NEW), outs)
        assert eng.stats()["hit_tokens"] > 0


def test_deadline_expiry_under_speculation(spec_fixture):
    _, _, tcfg, tp, prompts, base = spec_fixture
    for mode in MODES:
        oracle = OracleDraft(prompts, base[mode, ""], tcfg.vocab_size, accuracy=1.0, seed=0)
        eng = Engine(tp, tcfg, ServeConfig(**_sc(mode, spec_tokens=3)), device="cpu",
                     draft=oracle)
        outs = eng.serve(prompts, N_NEW, deadlines=[None, 0.0, None, 0.0])
        status = eng.stats()["request_status"]
        assert status[1] == EXPIRED and status[3] == EXPIRED, (mode, status)
        assert status[0] == DONE and status[2] == DONE
        for i in (0, 2):
            np.testing.assert_array_equal(base[mode, ""][i], outs[i])
        for i in (1, 3):
            np.testing.assert_array_equal(base[mode, ""][i][:len(outs[i])], outs[i])
        eng._alloc.check()


def test_spec_config_validation(spec_fixture):
    _, _, tcfg, tp, _, _ = spec_fixture
    with pytest.raises(ValueError, match="draft"):
        Engine(tp, tcfg, ServeConfig(**_sc("mixed", spec_tokens=3)), device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        Engine(tp, tcfg, ServeConfig(**_sc("mixed", spec_tokens=3, temperature=0.8)),
               device="cpu", draft=(tp, tcfg))
    with pytest.raises(ValueError, match="paged|packed"):
        Engine(tp, tcfg, ServeConfig(max_batch=2, max_len=64, spec_tokens=3), device="cpu",
               draft=(tp, tcfg))


def test_pack_verify_layout_by_hand():
    """Segments on block_q boundaries; a verify segment's rows are all its
    pack rows and its drafts its tokens after the pending one; a
    prefill-final segment reads only its last row; a mid-prompt chunk none."""
    plan = StepPlan(segments=[
        Segment(slot=1, tokens=np.asarray([7, 8, 9]), start=10, emits=True, n_draft=2),
        Segment(slot=0, tokens=np.asarray([1, 2, 3, 4, 5]), start=0, emits=True),
        Segment(slot=2, tokens=np.asarray([6, 6]), start=4, emits=False),
    ], n_tokens=10)
    tokens, seq_ids, positions, kv_len, rows, dmat = pack_verify(plan, 4, 3, 2, {0, 2})
    assert len(tokens) == 16  # 4 + 8 + 4 rows, a power of two
    np.testing.assert_array_equal(seq_ids[:4], [1, 1, 1, -1])
    np.testing.assert_array_equal(positions[:3], [10, 11, 12])
    np.testing.assert_array_equal(kv_len, [5, 13, 6])
    np.testing.assert_array_equal(rows, [[8, -1, -1], [0, 1, 2], [-1, -1, -1]])
    np.testing.assert_array_equal(dmat, [[-1, -1], [8, 9], [-1, -1]])


def test_allocator_rollback_unit():
    """rollback() (the allocator copied from the reference) is the inverse
    of extend(): whole pages past the target return to the free list and to
    the reservation; out-of-range targets raise."""
    alloc = PagedKVAllocator(n_pages=9, page_size=4)
    alloc.admit(1, prompt_len=6, reserve_tokens=24)
    free0, res0 = alloc.free_pages, alloc._reserved[1]
    alloc.extend(1, 14)
    assert alloc.rollback(1, 7) == 2
    assert alloc.free_pages == free0 and alloc._reserved[1] == res0
    assert alloc.seq_len(1) == 7 and len(alloc.table(1)) == 2
    alloc.check()
    for bad in ((1, 8), (1, -1), (2, 0)):
        with pytest.raises(PageError):
            alloc.rollback(*bad)


def test_draft_quota_clamps():
    """The scheduler (copied from the reference) clamps drafts by
    max_new_tokens, max_len and a deadline's remaining slack."""
    sched = Scheduler([np.asarray([1, 2, 3])], 6, 1, eos_id=-1)
    rid, prompt = sched.take_head()
    sched.admit_prefilling(0, rid, prompt)
    assert sched.draft_quota(0, 4, max_len=32) == 0  # prefilling: no drafts
    sched.commit(sched.plan_step(8, 8), np.asarray([5], np.int32))
    assert sched.draft_quota(0, 2, max_len=32) == 2
    assert sched.draft_quota(0, 10, max_len=32) == 4
    assert sched.draft_quota(0, 10, max_len=5) == 1
    sched.slots[0].deadline = sched.now() - 1.0
    assert sched.draft_quota(0, 10, max_len=32, per_row_s=0.01) == 0
