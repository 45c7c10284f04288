"""Port parity for fault-tolerant serving, after `tests/test_chaos.py`.

The port's engine and the JAX reference's run the same seeded
`FaultInjector` on the contiguous, paged and mixed loops (the reference's
`chaos_fixture` widths, f32, the reference's weights): the same terminal
statuses and tokens (survivors equal the fault-free run), the same checks
and faults per site, the same retry and failure counters and host syncs;
the pool's invariants hold after recovery. Fixed cases only: (seed, rate,
mode) triples and `schedule=` lists that hit each of the four sites.

Also mirrored: every request failing still terminates; a targeted fault
stays with its request; deadlines expire; `not_before` gates admission;
requests are accepted as objects; crash → `snapshot()` → a fresh engine's
`restore()` → `resume()` gives the uninterrupted tokens with the radix
cache re-warmed, at rest and mid-backoff too, and a snapshot of either
package restores into the other; `downgrade_after` kernel-site faults move
the engine to the plain route (a real error still raises). A chaos serve
leaves nothing uncommitted in the radix tree: a second serve on the same
engine, warm, gives the baseline tokens on native and int8 pools. The
reference's chaos tests of the int8 pool (`tests/test_quant.py:373`) and of
speculation (`tests/test_speculative.py:230`) get their port mirrors, and
the launcher's fault flags run on the CPU."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_llama
from repro.configs import qwen3_0_6b as j_qwen3
from repro.models import get_model as j_get_model
from repro.serve import EngineCrash as JEngineCrash
from repro.serve import Engine as JEngine
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.kernels.ops import fallback_impl, plain_impl
from repro_torch.serve import (
    DONE,
    EXPIRED,
    TERMINAL,
    Engine,
    EngineCrash,
    FaultInjector,
    Request,
    Scheduler,
    ServeConfig,
)
from repro_torch.serve.speculative import OracleDraft

MODES = ("contig", "paged", "mixed")
N_NEW = 6
FAULT_KEYS = ("failed", "retried", "expired", "preemptions", "hit_tokens", "prefix_lookups")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sc(mode: str, **kw) -> dict:
    """The reference's `_sc` (tests/test_chaos.py), as keyword arguments."""
    base = dict(max_batch=2, max_len=32)
    if mode == "paged":
        base.update(kv_layout="paged", page_size=4, kv_pool_tokens=96)
    elif mode == "mixed":
        base.update(kv_layout="paged", page_size=4, kv_pool_tokens=96, step_mode="mixed")
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def chaos_fixture():
    """The reference's chaos_fixture (1 layer, d 32, vocab 64, 4 prompts),
    its weights carried into the port, and each loop's fault-free tokens:
    the reference's, which the port's must equal."""
    jcfg = dataclasses.replace(
        paper_llama.CONFIG, n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
        d_ff=64, head_dim=16, vocab_size=64, vocab_pad_multiple=64,
    )
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    tcfg = bridge.config_from_reference(jcfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jcfg.vocab_size, (n,)).astype(np.int32) for n in (5, 9, 13, 7)]
    base = {}
    for mode in MODES:
        base[mode] = JEngine(jp, jcfg, JServeConfig(**_sc(mode))).serve(prompts, N_NEW)
        _same(Engine(tp, tcfg, ServeConfig(**_sc(mode)), device="cpu").serve(prompts, N_NEW),
              base[mode])
    return jcfg, jp, tcfg, tp, prompts, base


def _same(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def _port(fx, mode, injector=None, **kw):
    _, _, tcfg, tp, _, _ = fx
    return Engine(tp, tcfg, ServeConfig(**_sc(mode, **kw)), device="cpu",
                  fault_injector=injector)


def _survivors_hold(eng, outs, base):
    """Every request terminal, DONE streams the fault-free ones, the rest
    prefixes of them; the pool's invariants hold."""
    status = eng.stats()["request_status"]
    assert set(status) == set(range(len(base)))
    assert all(s in TERMINAL for s in status.values()), status
    for i, b in enumerate(base):
        if status[i] == DONE:
            np.testing.assert_array_equal(outs[i], b, err_msg=f"request {i}")
        else:
            np.testing.assert_array_equal(outs[i], b[: len(outs[i])], err_msg=f"request {i}")
    if eng._alloc is not None:
        eng._alloc.check(eng._paged.cache)
    return status


def _parity(fx, mode, make_injector):
    """The reference and the port under two copies of one injector."""
    jcfg, jp, _, _, prompts, base = fx
    je = JEngine(jp, jcfg, JServeConfig(**_sc(mode)), fault_injector=make_injector(JFaultInjector))
    te = _port(fx, mode, make_injector(FaultInjector))
    want, got = je.serve(prompts, N_NEW), te.serve(prompts, N_NEW)
    js, ts = je.stats(), te.stats()
    assert ts["request_status"] == js["request_status"]
    _same(got, want)
    assert ts["fault_checks"] == js["fault_checks"]
    assert ts["injected_faults"] == js["injected_faults"]
    assert {k: ts[k] for k in FAULT_KEYS} == {k: js[k] for k in FAULT_KEYS}
    assert te.host_syncs == je.host_syncs
    _survivors_hold(te, got, base[mode])
    return ts


# ---- chaos parity ----

@pytest.mark.parametrize("mode, seed, rate", [
    ("contig", 3, 0.2), ("contig", 11, 0.3),
    ("paged", 3, 0.2), ("paged", 11, 0.3),
    ("mixed", 3, 0.2), ("mixed", 11, 0.3),
])
def test_chaos_parity_rate(chaos_fixture, mode, seed, rate):
    ts = _parity(chaos_fixture, mode, lambda cls: cls(rate=rate, seed=seed))
    assert sum(ts["injected_faults"].values()) > 0


@pytest.mark.parametrize("mode, schedule", [
    ("mixed", [("page_alloc", 0), ("page_alloc", 3), ("page_alloc", 6)]),
    ("paged", [("kernel_dispatch", 1), ("kernel_dispatch", 4), ("kernel_dispatch", 5)]),
    ("contig", [("device_step", 0), ("device_step", 2), ("device_step", 3)]),
    ("contig", [("device_step", 2), ("host_sync", 5)]),  # two decode chunks, after they ran
    ("mixed", [("host_sync", 1), ("host_sync", 2), ("device_step", 4)]),
    ("paged", [("host_sync", 0), ("page_alloc", 7), ("device_step", 6)]),
])
def test_chaos_parity_schedule(chaos_fixture, mode, schedule):
    ts = _parity(chaos_fixture, mode, lambda cls: cls(schedule=schedule))
    for site, _ in schedule:
        assert ts["injected_faults"][site] > 0, (site, ts["injected_faults"])


# ---- the reference's lifecycle tests, mirrored ----

@pytest.mark.parametrize("mode", MODES)
def test_every_request_fails_still_terminates(chaos_fixture, mode):
    """rate 1: every request ends FAILED with no tokens; the engine stays
    usable, and a fault-free serve on it gives the baseline."""
    base = chaos_fixture[5][mode]
    eng = _port(chaos_fixture, mode, FaultInjector(rate=1.0, seed=0), max_retries=2)
    outs = eng.serve(chaos_fixture[4], N_NEW)
    status = eng.stats()["request_status"]
    assert all(s == "failed" for s in status.values()), status
    assert all(len(o) == 0 for o in outs)
    if eng._alloc is not None:
        eng._alloc.check()
    eng._injector = None
    _same(eng.serve(chaos_fixture[4], N_NEW), base)


@pytest.mark.parametrize("mode", MODES)
def test_targeted_fault_isolation(chaos_fixture, mode):
    """One fault on request 0's first admission with no retry budget fails
    it alone; its neighbours finish with the baseline tokens."""
    site = "page_alloc" if mode != "contig" else "kernel_dispatch"
    eng = _port(chaos_fixture, mode, FaultInjector(schedule=[(site, 0)]), max_retries=0)
    outs = eng.serve(chaos_fixture[4], N_NEW)
    status = eng.stats()["request_status"]
    assert status[0] == "failed" and all(status[i] == DONE for i in (1, 2, 3)), status
    _same(outs[1:], chaos_fixture[5][mode][1:])


@pytest.mark.parametrize("mode", MODES)
def test_deadline_expiry(chaos_fixture, mode):
    eng = _port(chaos_fixture, mode)
    outs = eng.serve(chaos_fixture[4], N_NEW, deadlines=[None, 0.0, None, 0.0])
    status = eng.stats()["request_status"]
    assert status[1] == EXPIRED and status[3] == EXPIRED, status
    assert status[0] == DONE and status[2] == DONE
    _survivors_hold(eng, outs, chaos_fixture[5][mode])


def test_not_before_gates_admission():
    req = Request(rid=0, prompt=np.asarray([1, 2, 3], np.int32), not_before=5.0, priority=9)
    sched = Scheduler([req], 4, 2, eos_id=-1)
    assert sched.head() is None  # gated: 5 s of backoff remain
    sched.queue[0].not_before = 0.0
    assert sched.head() is not None


@pytest.mark.parametrize("mode", MODES)
def test_serve_accepts_request_objects(chaos_fixture, mode):
    """Requests carrying two generated tokens each resume through
    recompute-on-resume to the baseline streams."""
    prompts, base = chaos_fixture[4], chaos_fixture[5][mode]
    half = [Request(rid=i, prompt=p, out=list(base[i][:2])) for i, p in enumerate(prompts)]
    _same(_port(chaos_fixture, mode).serve(half, N_NEW), base)


# ---- crash → snapshot → restore → resume ----

def _crash(eng, prompts, crash_type=EngineCrash):
    with pytest.raises(crash_type):
        eng.serve(prompts, N_NEW)


@pytest.mark.parametrize("mode", MODES)
def test_snapshot_restore_resume(chaos_fixture, tmp_path, mode):
    """A crash mid-serve keeps the pool consistent; the snapshot restores
    into a fresh engine whose resume gives the uninterrupted tokens, its
    radix cache re-warmed from the token chains alone."""
    prompts, base = chaos_fixture[4], chaos_fixture[5][mode]
    eng = _port(chaos_fixture, mode, FaultInjector(crash_after_checks=8))
    _crash(eng, prompts)
    if eng._alloc is not None:
        eng._alloc.check(eng._paged.cache)
    eng.snapshot(str(tmp_path))
    fresh = _port(chaos_fixture, mode)
    state = fresh.restore(str(tmp_path))
    assert state["pending"]
    results = fresh.resume()
    assert set(results) == set(range(len(prompts)))
    for i, b in enumerate(base):
        np.testing.assert_array_equal(results[i], b)
    if mode != "contig":
        assert state["chains"] and fresh.stats()["hit_tokens"] > 0
        fresh._alloc.check(fresh._paged.cache)


def test_snapshot_before_serve_and_resume_before_restore_raise(chaos_fixture):
    eng = _port(chaos_fixture, "paged")
    with pytest.raises(RuntimeError, match="before any serve"):
        eng.snapshot("unused")
    with pytest.raises(RuntimeError, match="before restore"):
        eng.resume()


def test_snapshot_at_rest(chaos_fixture, tmp_path):
    prompts, base = chaos_fixture[4], chaos_fixture[5]["paged"]
    eng = _port(chaos_fixture, "paged")
    eng.serve(prompts, N_NEW)
    eng.snapshot(str(tmp_path))
    fresh = _port(chaos_fixture, "paged")
    assert not fresh.restore(str(tmp_path))["pending"]
    results = fresh.resume()
    for i, b in enumerate(base):
        np.testing.assert_array_equal(results[i], b)
    _same(fresh.serve(prompts, N_NEW), base)  # the restored cache serves warm
    assert fresh.stats()["hit_tokens"] > 0


def test_snapshot_rebases_backoff_to_remaining(chaos_fixture, tmp_path):
    """A request mid-backoff snapshots its remaining gate, not the old
    scheduler's clock; resume waits it out and finishes."""
    prompts, base = chaos_fixture[4], chaos_fixture[5]["paged"]
    eng = _port(chaos_fixture, "paged", FaultInjector(crash_after_checks=8))
    _crash(eng, prompts)
    sched = eng._sched
    assert sched.queue
    victim = sched.queue[0]
    victim.retries = 1
    victim.not_before = sched.now() + 0.2
    eng.snapshot(str(tmp_path))
    fresh = _port(chaos_fixture, "paged")
    by_rid = {p["rid"]: p for p in fresh.restore(str(tmp_path))["pending"]}
    assert 0.0 < by_rid[victim.rid]["not_before"] <= 0.2
    assert all(p["not_before"] == 0.0 for r, p in by_rid.items() if r != victim.rid)
    results = fresh.resume()
    for i, b in enumerate(base):
        np.testing.assert_array_equal(results[i], b)


def _manifest_extra(path) -> dict:
    with open(os.path.join(path, "step_00000000", "manifest.json")) as f:
        return json.load(f)["extra"]


@pytest.mark.parametrize("mode", ["contig", "mixed"])
def test_snapshots_cross_packages(chaos_fixture, tmp_path, mode):
    """The same crash in both engines writes the same snapshot; the
    reference's restores into the port and the port's into the
    reference, each resuming to the uninterrupted tokens."""
    jcfg, jp, _, _, prompts, bases = chaos_fixture
    base = bases[mode]
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    je = JEngine(jp, jcfg, JServeConfig(**_sc(mode)),
                 fault_injector=JFaultInjector(crash_after_checks=8))
    _crash(je, prompts, JEngineCrash)
    je.snapshot(ref_dir)
    te = _port(chaos_fixture, mode, FaultInjector(crash_after_checks=8))
    _crash(te, prompts)
    te.snapshot(port_dir)
    assert _manifest_extra(ref_dir) == _manifest_extra(port_dir)
    fresh = _port(chaos_fixture, mode)
    fresh.restore(ref_dir)
    into_port = fresh.resume()
    back = JEngine(jp, jcfg, JServeConfig(**_sc(mode)))
    back.restore(port_dir)
    into_ref = back.resume()
    for i, b in enumerate(base):
        np.testing.assert_array_equal(into_port[i], b)
        np.testing.assert_array_equal(into_ref[i], b)
    if mode != "contig":
        assert fresh.stats()["hit_tokens"] == back.stats()["hit_tokens"] > 0


# ---- the kernel → plain downgrade ----

def test_plain_impl_maps_kernel_routes_to_plain_ones():
    assert plain_impl("flashd") == plain_impl("flashd_gpu") == "flashd_plain"
    assert plain_impl("fa2") == plain_impl("fa2_gpu") == "fa2_plain"
    for impl in ("flashd_plain", "fa2_plain", "naive", "xla"):
        assert plain_impl(impl) == impl
    assert fallback_impl("flashd_gpu") == "flashd"  # the ops registry's own map stays


@pytest.mark.parametrize("mode", MODES)
def test_kernel_faults_downgrade_to_plain(chaos_fixture, mode):
    """`downgrade_after` consecutive kernel-site faults switch the engine to
    the plain route once; the serve completes with the baseline tokens and
    the engine's graphs are dropped with the kernel route."""
    inj = FaultInjector(schedule=[("kernel_dispatch", i) for i in range(3)])
    eng = _port(chaos_fixture, mode, inj, downgrade_after=3, max_retries=8)
    outs = eng.serve(chaos_fixture[4], N_NEW)
    st = eng.stats()
    assert st["downgrades"] == 1 and st["attn_impl"] == "flashd_plain"
    assert all(s == DONE for s in st["request_status"].values())
    _same(outs, chaos_fixture[5][mode])


def test_faults_apart_do_not_downgrade(chaos_fixture):
    """The streak, not the total, triggers: faults separated by a synced
    step leave the kernel route in place."""
    inj = FaultInjector(schedule=[("kernel_dispatch", i) for i in (0, 1, 3, 4)])
    eng = _port(chaos_fixture, "contig", inj, downgrade_after=3, max_retries=8)
    _same(eng.serve(chaos_fixture[4], N_NEW), chaos_fixture[5]["contig"])
    assert eng.stats()["downgrades"] == 0 and eng.stats()["attn_impl"] == "flashd"


@pytest.mark.parametrize("mode", MODES)
def test_real_error_raises_and_never_downgrades(chaos_fixture, mode):
    """Only an injected fault counts toward the downgrade: a real error in
    a step propagates (crash recovery keeps the pool consistent) and the
    route stays."""
    eng = _port(chaos_fixture, mode, downgrade_after=1)
    calls = {"n": 0}
    decode_step = eng.api.decode_step

    def broken(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] > 3:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return decode_step(*args, **kwargs)

    eng.api = eng.api._replace(decode_step=broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.serve(chaos_fixture[4], N_NEW)
    st = eng.stats()
    assert st["downgrades"] == 0 and st["attn_impl"] == "flashd"
    if eng._alloc is not None:
        eng._alloc.check(eng._paged.cache)
        assert eng._alloc.pages_in_use == eng._alloc.cached_pages


# ---- nothing uncommitted reaches the radix tree ----

@pytest.fixture(scope="module")
def int8_base(chaos_fixture):
    _, _, tcfg, tp, prompts, _ = chaos_fixture
    return {mode: Engine(tp, tcfg, ServeConfig(**_sc(mode, kv_dtype="int8")),
                         device="cpu").serve(prompts, N_NEW)
            for mode in ("paged", "mixed")}


@pytest.mark.parametrize("seed, rate", [(3, 0.2), (5, 0.25)])
@pytest.mark.parametrize("kv_dtype", ["", "int8"])
@pytest.mark.parametrize("mode", ["paged", "mixed"])
def test_warm_pool_after_chaos_gives_the_baseline(chaos_fixture, int8_base, mode, kv_dtype,
                                                  seed, rate):
    """After a chaos serve every cached chain is a prefix of a committed
    stream (prompt + fault-free tokens), and a fault-free serve of the
    same prompts on the same, warm engine gives the baseline tokens:
    no row of a faulted or rolled-back step reached the tree."""
    prompts = chaos_fixture[4]
    base = int8_base[mode] if kv_dtype else chaos_fixture[5][mode]
    eng = _port(chaos_fixture, mode, FaultInjector(rate=rate, seed=seed), kv_dtype=kv_dtype)
    _survivors_hold(eng, eng.serve(prompts, N_NEW), base)
    assert sum(eng.stats()["injected_faults"].values()) > 0
    streams = [np.concatenate([p, b]).tolist() for p, b in zip(prompts, base)]
    for chain in eng._alloc.cached_chains():
        assert any(s[: len(chain)] == list(chain) for s in streams), chain
    eng._injector = None
    hits = eng.stats()["hit_tokens"]
    _same(eng.serve(prompts, N_NEW), base)
    assert eng.stats()["hit_tokens"] > hits
    eng._alloc.check(eng._paged.cache)


# ---- the reference's chaos tests of the int8 pool and of speculation ----

@pytest.mark.parametrize("mode, seed, rate", [
    ("sequential", 1, 0.1), ("sequential", 7, 0.3), ("mixed", 2, 0.15), ("mixed", 9, 0.3),
])
def test_chaos_int8_terminal_clean(chaos_fixture, mode, seed, rate):
    """`tests/test_quant.py::test_chaos_int8_terminal_clean`: an int8 pool
    under chaos, every request terminal, DONE streams the fault-free int8
    run's, the allocator's invariants — scale leaves included — hold."""
    _, _, tcfg, tp, prompts, _ = chaos_fixture
    sc = ServeConfig(max_batch=2, max_len=32, kv_layout="paged", page_size=4,
                     kv_pool_tokens=96, kv_dtype="int8", step_mode=mode)
    base = Engine(tp, tcfg, sc, device="cpu").serve(prompts, 4)
    eng = Engine(tp, tcfg, sc, device="cpu", fault_injector=FaultInjector(rate=rate, seed=seed))
    _survivors_hold(eng, eng.serve(prompts, 4), base)


@pytest.fixture(scope="module")
def spec_fixture():
    """qwen3-0.6b smoke widths, f32, the reference's weights, as
    `tests/test_speculative.py`; each loop's fault-free tokens."""
    jcfg = dataclasses.replace(j_qwen3.SMOKE, dtype="float32")
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    tcfg = bridge.config_from_reference(jcfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jcfg.vocab_size, (n,)).astype(np.int32) for n in (5, 9, 13, 7)]
    sc = dict(max_batch=2, max_len=64, kv_layout="paged", page_size=8)
    base = {mode: Engine(tp, tcfg, ServeConfig(**sc, step_mode=mode), device="cpu")
            .serve(prompts, 8) for mode in ("sequential", "mixed")}
    return tcfg, tp, prompts, sc, base


@pytest.mark.parametrize("mode, seed, rate", [
    ("sequential", 4, 0.1), ("sequential", 8, 0.2), ("mixed", 4, 0.1), ("mixed", 6, 0.2),
])
def test_chaos_with_speculation(spec_fixture, mode, seed, rate):
    """`tests/test_speculative.py::test_chaos_with_speculation`: an
    `OracleDraft` at 0.6 under chaos; DONE streams equal the fault-free
    non-speculative run's and the pool's invariants hold."""
    tcfg, tp, prompts, sc, base = spec_fixture
    oracle = OracleDraft(prompts, base[mode], tcfg.vocab_size, accuracy=0.6, seed=seed)
    eng = Engine(tp, tcfg, ServeConfig(**sc, step_mode=mode, spec_tokens=3), device="cpu",
                 draft=oracle, fault_injector=FaultInjector(rate=rate, seed=seed))
    _survivors_hold(eng, eng.serve(prompts, 8), base[mode])
    assert sum(eng.stats()["injected_faults"].values()) > 0


# ---- the launcher ----

def test_launcher_fault_flags(capsys):
    from repro_torch.launch import serve as launch_serve

    rc = launch_serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "5", "--max-new-tokens", "4",
                            "--kv-layout", "paged", "--fault-rate", "0.3", "--fault-seed", "2",
                            "--max-retries", "5", "--deadline-ms", "60000"])
    out = capsys.readouterr().out
    assert rc == 0
    line = next(x for x in out.splitlines() if x.startswith("fault tolerance:"))
    assert "faults fired" in line and "downgrades" in line
    assert all(f"request {i} [" in out for i in range(3))
