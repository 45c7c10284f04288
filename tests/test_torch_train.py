"""Port parity: the training path (optimizer, schedule, data, train step,
resilient loop, launcher) against the JAX reference, on the CPU.

Weights come from the reference's `init_lm(PRNGKey(0))` through the bridge,
batches from `SyntheticLM` (byte-equal on both sides). Bounds, f32:
- loss and grad norm per step within 1e-5 relative (summation order only);
- parameters after 3 AdamW steps: the port's total deviation from the
  reference's is ≤ 1e-3 of the reference's total update, and fewer than
  1e-4 of the entries differ by more than 1e-5. Adam divides by √v̂, so an
  entry whose gradient is rounding noise can move by up to lr in either
  direction; the bound is on the update as a whole, not on each entry.
- loss-scale / skip counters: equal.
The resilient loop's resume is held to bitwise equality with the port's
own uninterrupted run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_llama as j_paper_llama
from repro.configs import qwen3_0_6b as j_qwen3
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tschedule
from repro_torch.runtime.resilience import FaultInjector
from repro_torch.train import ResilienceConfig, train_resilient
from repro_torch.train import train_step as tts
from repro_torch.tree import tree_leaves, tree_map

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on the machine's cores, and torch's per-process thread pools
    oversubscribe them (a small train step then runs ~10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CONFIGS = {
    "qwen3-0.6b-smoke": dataclasses.replace(j_qwen3.SMOKE, dtype="float32"),
    "paper-llama": j_paper_llama.CONFIG,
}


def _torch_batch(b):
    return {k: torch.from_numpy(x) for k, x in b.items()}


def _run_both(jcfg, seq_len, steps, **tc_kw):
    """The same init, data and config through the reference's jitted step
    and the port's step → (per-step metrics of each, final states)."""
    jtc = jts.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-2), warmup_steps=1,
                          total_steps=10, **tc_kw)
    ttc = tts.TrainConfig(optimizer=tadamw.AdamWConfig(lr=1e-2), warmup_steps=1,
                          total_steps=10, **tc_kw)
    params = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jtc)._replace(params=params)
    tstate = tts.init_train_state(bridge.config_from_reference(jcfg), ttc,
                                  params=bridge.params_from_numpy(jax.tree.map(np.asarray, params)))
    jstep = jax.jit(jts.make_train_step(jcfg, jtc))
    tstep = tts.make_train_step(bridge.config_from_reference(jcfg), ttc)
    data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=seq_len, global_batch=4))
    jm, tm = [], []
    for s in range(steps):
        batch = data.batch(s)
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tstep(tstate, _torch_batch(batch))
        tm.append({k: float(v) for k, v in m.items()})
    return jm, tm, params, jstate, tstate


@pytest.mark.parametrize("arch,accum", [("qwen3-0.6b-smoke", 1), ("paper-llama", 1),
                                        ("qwen3-0.6b-smoke", 2)])
def test_train_step_matches_the_reference(arch, accum):
    jm, tm, p0, jstate, tstate = _run_both(CONFIGS[arch], 16, 3, accum_steps=accum)
    assert sorted(jm[0]) == sorted(tm[0])
    for a, b in zip(jm, tm):
        for key in ("loss", "ce", "grad_norm"):
            assert abs(a[key] - b[key]) <= REL * abs(a[key]), (key, a[key], b[key])
        for key in ("lr", "loss_scale", "skipped", "finite"):
            assert a[key] == pytest.approx(b[key], rel=1e-6), key
    want = [np.asarray(x) for x in jax.tree.leaves(jstate.params)]
    got = tree_leaves(bridge.params_to_numpy(tstate.params))
    init = [np.asarray(x) for x in jax.tree.leaves(p0)]
    dev = np.sqrt(sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want)))
    upd = np.sqrt(sum(float(((w - i) ** 2).sum()) for w, i in zip(want, init)))
    assert dev <= 1e-3 * upd, (dev, upd)
    n_off = sum(int((np.abs(g - w) > 1e-5).sum()) for g, w in zip(got, want))
    assert n_off < 1e-4 * sum(w.size for w in want), n_off
    assert int(tstate.step) == int(jstate.step) == 3
    assert int(tstate.opt.step) == int(jstate.opt.step) == 3


@pytest.mark.parametrize("opts", [dict(cast_params_once=True), dict(grad_dtype="bfloat16")],
                         ids=["cast_params_once", "bf16_grads"])
def test_mixed_precision_options_match_the_reference(opts):
    """qwen3-0.6b SMOKE in its own bf16 compute dtype, with the params cast
    once per step or the gradients taken in bf16: loss and grad norm within
    2e-2 relative of the reference's. bf16 keeps 8 significant bits
    (2^-8 ≈ 4e-3 per rounding) and the two frameworks round at different
    places; both bounds leave room for a few such roundings in a row."""
    jm, tm, _, _, tstate = _run_both(j_qwen3.SMOKE, 16, 2, **opts)
    for a, b in zip(jm, tm):
        for key in ("loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= 2e-2 * abs(a[key]), (key, a[key], b[key])
    assert all(np.isfinite(x.float().numpy()).all() for x in tree_leaves(tstate.params))
    assert tstate.params["embed"].dtype == torch.float32  # the masters stay f32


def test_overflow_backoff_and_skip_counters_match_the_reference():
    """An absurd initial scale overflows: both sides skip the same steps,
    halve to the same scale, grow it back at the same step."""
    jm, tm, _, jstate, tstate = _run_both(
        CONFIGS["qwen3-0.6b-smoke"], 8, 7, loss_scale_init=2.0 ** 127,
        loss_scale_growth_interval=2, loss_scale_max=2.0 ** 126)
    for key in ("finite", "skipped", "loss_scale"):
        assert [m[key] for m in jm] == [m[key] for m in tm], key
    assert jm[0]["finite"] == 0.0 and jm[-1]["finite"] == 1.0
    for name in ("skipped", "good_steps", "loss_scale", "step"):
        assert float(getattr(tstate, name)) == float(getattr(jstate, name)), name


def test_adamw_and_schedule_match_the_reference():
    """Two AdamW steps on a tree with stacked per-layer norms, a final norm
    and matrices (decay mask by substring, as the reference's), f32 and
    bf16 optimizer state; the warmup-cosine schedule step by step."""
    rng = np.random.default_rng(0)
    tree = {"embed": rng.standard_normal((16, 8)), "final_norm": rng.standard_normal(8),
            "blocks": {"pos0": {"norm1": rng.standard_normal((2, 8)),
                                "mixer": {"wq": rng.standard_normal((2, 8, 8)),
                                          "D": rng.standard_normal((2, 8))}}}}
    params = jax.tree.map(lambda x: x.astype(np.float32), tree)
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
             for _ in range(2)]
    cfg_j, cfg_t = jadamw.AdamWConfig(clip_norm=2.0), tadamw.AdamWConfig(clip_norm=2.0)
    assert (jax.tree.leaves(jadamw._decay_mask(params, cfg_j))
            == tree_leaves(tadamw._decay_mask(bridge.params_from_numpy(params), cfg_t))
            == [0.0, 1.0, 0.0, 1.0, 0.0])  # D, wq, stacked norm1 (by name only), embed, final_norm
    for state_dtype in (None, "bfloat16"):
        jp, jo = params, jadamw.init_opt(params, state_dtype=state_dtype)
        tp = bridge.params_from_numpy(params)
        to = tadamw.init_opt(tp, state_dtype=state_dtype)
        for g in grads:
            jp, jo, jmet = jadamw.apply_updates(jp, g, jo, cfg_j, lr=jnp.float32(1e-2))
            tp, to, tmet = tadamw.apply_updates(tp, bridge.params_from_numpy(g), to, cfg_t,
                                                lr=torch.tensor(1e-2))
            assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-6)
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
        for a, b in zip(jax.tree.leaves(jo.m), tree_leaves(to.m)):
            np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), rtol=0,
                                       atol=1e-6)
        assert int(to.step) == int(jo.step) == 2
    kw = dict(peak_lr=3e-3, warmup_steps=5, total_steps=40)
    for step in range(0, 45, 3):  # f32 cos of two libraries: within an ulp or two
        assert (float(tschedule.warmup_cosine(step, **kw))
                == pytest.approx(float(jschedule.warmup_cosine(step, **kw)), rel=1e-6))


def _adamw_whole_tree(params, grads, opt, cfg, lr):
    """The reference's AdamW as whole-tree passes, one expression a tree."""
    step = opt.step + 1
    gnorm = tadamw.global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    grads = tree_map(lambda g: g.float() * scale, grads)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    m = tree_map(lambda m, g: (cfg.b1 * m.float() + (1 - cfg.b1) * g).to(m.dtype), opt.m, grads)
    v = tree_map(lambda v, g: (cfg.b2 * v.float() + (1 - cfg.b2) * g * g).to(v.dtype), opt.v,
                 grads)

    def upd(p, m, v, d):
        step_ = (m.float() / b1c) / (torch.sqrt(v.float() / b2c) + cfg.eps) \
            + cfg.weight_decay * d * p.float()
        return (p.float() - lr * step_).to(p.dtype)

    return (tree_map(upd, params, m, v, tadamw._decay_mask(params, cfg)),
            tadamw.OptState(m, v, step))


def test_adamw_chunked_update_is_the_whole_leaf_update(monkeypatch):
    """`apply_updates` walks each leaf in passes of UPDATE_CHUNK elements
    (bounded temporaries beside a 1 B-parameter leaf), each pass writing its
    outputs in place: at the default chunk and at passes of 5 elements —
    ragged on every leaf, a gradient given as a transposed view — it gives
    the bits of the reference's expressions as whole-tree passes, in f32
    and bf16 optimizer state, over two steps."""
    rng = np.random.default_rng(1)
    params = {"embed": torch.from_numpy(rng.standard_normal((16, 9)).astype(np.float32)),
              "final_norm": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
              "blocks": {"pos0": {"wq": torch.from_numpy(
                  rng.standard_normal((2, 8, 8)).astype(np.float32))}}}
    grads = [tree_map(lambda x: torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)),
                      params) for _ in range(2)]
    grads[1]["embed"] = torch.from_numpy(rng.standard_normal((9, 16)).astype(np.float32)).T
    cfg = tadamw.AdamWConfig(clip_norm=2.0)
    lr = torch.tensor(1e-2)
    for state_dtype in (None, "bfloat16"):
        p, o = params, tadamw.init_opt(params, state_dtype=state_dtype)
        for g in grads:
            p, o = _adamw_whole_tree(p, g, o, cfg, lr)
        want = tree_leaves(p) + tree_leaves(o.m) + tree_leaves(o.v)
        for chunk in (tadamw.UPDATE_CHUNK, 5):
            monkeypatch.setattr(tadamw, "UPDATE_CHUNK", chunk)
            p, o = params, tadamw.init_opt(params, state_dtype=state_dtype)
            for g in grads:
                p, o, _ = tadamw.apply_updates(p, g, o, cfg, lr=lr)
            got = tree_leaves(p) + tree_leaves(o.m) + tree_leaves(o.v)
            assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))


def test_synthetic_batches_are_the_reference_bytes():
    for kw in (dict(vocab_size=512, seq_len=16, global_batch=4, seed=3),
               dict(vocab_size=97, seq_len=9, global_batch=6, seed=0, host_index=1,
                    host_count=3)):
        ours, theirs = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
        for step in (0, 1, 17):
            a, b = ours.batch(step), theirs.batch(step)
            assert sorted(a) == sorted(b)
            for key in a:
                assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes()


def test_unported_training_options_raise():
    with pytest.raises(NotImplementedError, match="A13"):
        tts.TrainConfig(compression="int8")


def _tiny(arch="paper-llama"):
    """The reference resilience tests' 1-layer paper-llama, or qwen3-0.6b
    SMOKE (qk-norm, GQA, remat 'full') at 2 × 48 tokens."""
    if arch == "qwen3-0.6b-smoke":
        cfg = bridge.config_from_reference(CONFIGS[arch])
        seq, batch = 48, 2
    else:
        cfg = dataclasses.replace(
            bridge.config_from_reference(j_paper_llama.CONFIG), n_layers=1, d_model=32,
            n_heads=2, n_kv_heads=2, d_ff=64, head_dim=16, vocab_size=64, vocab_pad_multiple=64)
        seq, batch = 16, 4
    tc = tts.TrainConfig(optimizer=tadamw.AdamWConfig(lr=1e-3), warmup_steps=2, total_steps=50)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    return cfg, tc, data


@pytest.mark.parametrize("arch,steps,schedule", [
    ("paper-llama", 20, [("data_batch", 7), ("grad_step", 9), ("optimizer_update", 11),
                         ("collective", 13), ("ckpt_save", 2)]),
    ("qwen3-0.6b-smoke", 10, [("grad_step", 6), ("ckpt_save", 1)]),
])
def test_resume_after_faults_is_bitwise_the_uninterrupted_run(tmp_path, arch, steps, schedule):
    """Scheduled faults (on paper-llama one at each train site): the loss
    curve and the final params equal the clean run's bit for bit."""
    cfg, tc, data = _tiny(arch)
    res = ResilienceConfig(ckpt_every=5)
    kw = dict(model_cfg=cfg, train_cfg=tc, data=data, total_steps=steps, res=res, device="cpu")
    clean, clean_hist, ctr = train_resilient(ckpt_dir=str(tmp_path / "clean"), **kw)
    assert ctr["restarts"] == 0
    inj = FaultInjector(schedule=schedule)
    got, hist, ctr = train_resilient(ckpt_dir=str(tmp_path / "faulted"), injector=inj, **kw)
    assert ctr["restarts"] == len(schedule) and ctr["faults"] == len(schedule)
    assert [h["loss"] for h in hist] == [h["loss"] for h in clean_hist]
    assert [h["step"] for h in hist] == list(range(steps))
    for a, b in zip(tree_leaves(clean.params), tree_leaves(got.params)):
        assert torch.equal(a, b)


def test_embedding_backward_is_deterministic():
    """The bitwise-resume contract needs a step that gives the same bits on
    every run. The embedding's backward sums many rows into few: with
    several threads, `table[ids]` accumulates them in a varying order on
    the CPU, `embed_lookup` (through `F.embedding`) in a fixed one."""
    from repro_torch.models.layers import embed_lookup

    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        gen = torch.Generator().manual_seed(0)
        table = torch.randn(64, 32, generator=gen, requires_grad=True)
        ids = torch.randint(0, 64, (8, 1024), generator=gen)
        w = torch.randn(8, 1024, 32, generator=gen)
        grads = [torch.autograd.grad((embed_lookup(table, ids, torch.float32) * w).sum(), table)[0]
                 for _ in range(5)]
    finally:
        torch.set_num_threads(n)
    assert all(torch.equal(grads[0], g) for g in grads[1:])


def test_spike_rollback_restores_the_clean_curve(tmp_path):
    cfg, tc, data = _tiny()
    res = ResilienceConfig(ckpt_every=5, spike_threshold=2.0, spike_window=8, spike_warmup=4)
    kw = dict(model_cfg=cfg, train_cfg=tc, data=data, total_steps=16, res=res, device="cpu")
    _, clean_hist, _ = train_resilient(ckpt_dir=str(tmp_path / "clean"), **kw)
    fired = []

    def corrupt_once(step, state):
        if step == 12 and not fired:
            fired.append(step)
            return state._replace(params=tree_map(lambda p: p * 100.0, state.params))
        return None

    _, hist, ctr = train_resilient(ckpt_dir=str(tmp_path / "bad"), chaos_hook=corrupt_once, **kw)
    assert fired == [12] and ctr["rollbacks"] >= 1 and ctr["restarts"] >= 1
    assert [h["loss"] for h in hist] == [h["loss"] for h in clean_hist]


def test_launcher_trains_on_the_cpu_when_asked(capsys, tmp_path):
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import checkpoint as ckpt

    rc = launch_train.main(["--smoke", "--device", "cpu", "--steps", "3", "--log-every", "1",
                            "--ckpt-dir", str(tmp_path), "--seq-len", "16",
                            "--global-batch", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and out.count("step ") >= 3 and "done: 3 committed steps" in out
    assert ckpt.valid_steps(str(tmp_path)) == [3]
    with pytest.raises(SystemExit, match="--resume"):
        launch_train.main(["--smoke", "--device", "cpu", "--steps", "3",
                           "--ckpt-dir", str(tmp_path)])
