"""Checkpoints: the port reads and writes the reference's on-disk format.

A reference-saved f32 `TrainState` restores into the port's and the port's
into the reference's, leaf names and bits equal; a corrupt newest shard
falls back to the newest good step; bf16 leaves round-trip in the port as
the reference's `|V2` bytes; a restored checkpoint serves the greedy tokens
of the weights it was saved from."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as j_qwen3
from repro.runtime import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.runtime import checkpoint as tckpt
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import train_step as tts
from repro_torch.tree import tree_flatten_with_names, tree_leaves

JCFG = dataclasses.replace(j_qwen3.SMOKE, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on the machine's cores, and torch's per-process thread pools
    oversubscribe them (a small train step then runs ~10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_state(seed, **tc_kw):
    return tts.init_train_state(bridge.config_from_reference(JCFG), tts.TrainConfig(**tc_kw),
                                device="cpu", seed=seed)


def _trained_port_state(**tc_kw):
    """A state one step past init, so m, v, step and the params all differ
    from any fresh template."""
    tcfg, tc = bridge.config_from_reference(JCFG), tts.TrainConfig(warmup_steps=0, **tc_kw)
    state = tts.init_train_state(tcfg, tc, device="cpu", seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 9)))
    state, _ = tts.make_train_step(tcfg, tc)(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return state


def _assert_equal_leaves(port_state, ref_state):
    names = [n for n, _ in tree_flatten_with_names(port_state)]
    flat = jax.tree_util.tree_flatten_with_path(ref_state)[0]
    ref_names = ["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
                 for path, _ in flat]
    assert names == ref_names
    for t, (_, r) in zip(tree_leaves(port_state), flat):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jtc = jts.TrainConfig()
    jstate = jts.init_train_state(jax.random.PRNGKey(0), JCFG, jtc)
    jstate = jstate._replace(step=jax.numpy.int32(7), loss_scale=jax.numpy.float32(0.5),
                             skipped=jax.numpy.int32(2))
    jckpt.save(str(tmp_path), 7, jstate, extra={"data_step": 7})
    state, extra = tckpt.restore(str(tmp_path), _port_state(seed=1))
    assert extra == {"data_step": 7}
    _assert_equal_leaves(state, jstate)
    assert int(state.step) == 7 and float(state.loss_scale) == 0.5
    assert state.step.dtype == torch.int32 and state.params["embed"].dtype == torch.float32


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    state = _trained_port_state()
    tckpt.save(str(tmp_path), 1, state, extra={"data_step": 1})
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert {".params/embed", ".params/blocks/pos0/mixer/wq", ".opt/.m/blocks/pos0/ffn/wd",
            ".opt/.step", ".step", ".loss_scale", ".good_steps", ".skipped"} <= set(
        manifest["leaves"])
    template = jts.init_train_state(jax.random.PRNGKey(3), JCFG, jts.TrainConfig())
    jstate, extra = jckpt.restore(str(tmp_path), template)
    assert extra == {"data_step": 1}
    _assert_equal_leaves(state, jstate)


def test_bridge_moves_a_train_state_both_ways():
    """The reference's TrainState → the port's (`train_state_from_numpy`) and
    back (`train_state_to_numpy` → the reference's NamedTuples), bit for bit."""
    jstate = jts.init_train_state(jax.random.PRNGKey(0), JCFG, jts.TrainConfig())
    jstate = jstate._replace(loss_scale=jax.numpy.float32(4.0), good_steps=jax.numpy.int32(3))
    state = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    _assert_equal_leaves(state, jstate)
    assert isinstance(state, tts.TrainState) and state.good_steps.dtype == torch.int32
    back = bridge.train_state_to_numpy(state)
    again = jts.TrainState(back.params, type(jstate.opt)(*back.opt), None, *back[3:])
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_corrupt_newest_shard_falls_back_to_the_newest_good_step(tmp_path):
    d = str(tmp_path)
    old, new = _port_state(seed=0), _trained_port_state()
    tckpt.save(d, 2, old, extra={"data_step": 2})
    tckpt.save(d, 4, new, extra={"data_step": 4})
    os.makedirs(tmp_path / "step_backup")  # malformed names are skipped, not fatal
    os.makedirs(tmp_path / "step_00000006.tmp")  # an unpublished save
    shard = tmp_path / "step_00000004" / "shard_0.npz"
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    shard.write_bytes(bytes(raw))
    assert tckpt.latest_step(d) == 4 and tckpt.valid_steps(d) == [2]
    assert not tckpt.verify_step(d, 4)
    got, extra = tckpt.restore(d, _port_state(seed=5))
    assert extra == {"data_step": 2}
    for a, b in zip(tree_leaves(got), tree_leaves(old)):
        assert torch.equal(a, b)
    with pytest.raises(tckpt.CheckpointCorrupt):
        tckpt.restore(d, _port_state(seed=5), step=4)


def test_bf16_leaves_round_trip_as_the_reference_bytes(tmp_path):
    """bf16 optimizer state is written as the reference writes bf16 (`np.load`
    gives `|V2`) and read back bit for bit. The reference itself cannot
    restore such a checkpoint (a ROADMAP reference gap): it raises."""
    state = _trained_port_state(opt_state_dtype="bfloat16")
    assert state.opt.m["embed"].dtype == torch.bfloat16
    tckpt.save(str(tmp_path), 1, state)
    with np.load(tmp_path / "step_00000001" / "shard_0.npz") as z:
        assert z[".opt/.m/embed"].dtype == np.dtype("V2")
        assert z[".params/embed"].dtype == np.float32
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert manifest["leaves"][".opt/.v/embed"]["dtype"] == "bfloat16"
    got, _ = tckpt.restore(str(tmp_path), _port_state(seed=2, opt_state_dtype="bfloat16"))
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    template = jts.init_train_state(jax.random.PRNGKey(0), JCFG,
                                    jts.TrainConfig(opt_state_dtype="bfloat16"))
    with pytest.raises(ValueError):
        jckpt.restore(str(tmp_path), template)


def test_async_manager_saves_collects_and_surfaces_errors(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), keep=2)
    state = _port_state(seed=0)
    for step in (1, 2, 3):
        mgr.save_async(step, state, extra={"data_step": step})
    mgr.wait()
    assert tckpt.valid_steps(str(tmp_path / "ck")) == [2, 3]
    (tmp_path / "file").write_text("not a directory")
    bad = tckpt.CheckpointManager(str(tmp_path / "file"), keep=2)
    bad.save_async(1, state)
    with pytest.raises(OSError):
        bad.wait()
    assert tckpt.valid_steps(str(tmp_path / "ck")) == [2, 3]


def test_restored_checkpoint_serves_the_saved_weights_tokens(tmp_path):
    state = _trained_port_state()
    tckpt.save(str(tmp_path), 1, state)
    restored, _ = tckpt.restore(str(tmp_path), _port_state(seed=9))
    cfg = bridge.config_from_reference(JCFG)
    prompts = np.random.default_rng(1).integers(0, JCFG.vocab_size, (2, 7)).astype(np.int32)
    sc = ServeConfig(max_batch=2, max_len=32)
    want = Engine(state.params, cfg, sc, device="cpu").generate(prompts, 6)
    got = Engine(restored.params, cfg, sc, device="cpu").generate(prompts, 6)
    assert np.array_equal(got, want)
    fresh = Engine(_port_state(seed=9).params, cfg, sc, device="cpu").generate(prompts, 6)
    assert not np.array_equal(fresh, want)  # the tokens do depend on the weights
