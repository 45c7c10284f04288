"""The port's sharding (`repro_torch.distributed`) across ranks, on the CPU:
one spawn of 4 gloo processes runs every sharded case, and each test reads
its results. The references are the JAX package's single-device outputs
(the outputs its own 8-device tests compare against) and the port's own
one-rank runs, computed in this process.

Cases, with their bounds:
(a) qwen3-0.6b smoke (bf16 compute), `TrainConfig()`, SyntheticLM seq 16 /
    batch 8, the reference's `PRNGKey(0)` weights, on a (data 2, model 2)
    mesh: against the JAX step loss rtol 1e-4, params rtol 2e-3 / atol
    2e-4 (the reference test's bounds); against the port's one-rank step
    loss rtol 1e-4 and grad norm rtol 1e-3 (measured ≤ 1.5e-5 and
    ≤ 2.0e-4: the shards round their bf16 partial products apart), params
    bitwise (lr is 0 at step 0). The same in f32 for two steps, the second
    with lr > 0: loss and grad norm rtol 1e-5, params atol 1e-5 (measured
    equal, equal, 4.4e-8).
(b) the same with `cast_params_once` and with `grad_dtype="bfloat16"`,
    against the port's one-rank step with that option: (a)'s bf16 bounds.
(c) (a) on a (1, 4) mesh, where Hkv 2 does not divide 'model' 4: the
    full-DP attention fallback, (a)'s bounds.
(d) qwen3-moe smoke `apply_moe`, x [4, 16, d] from seed 0, on the (2, 2)
    mesh (two token groups, each with its own capacity): against the JAX
    single-device output rtol / atol 3e-3 (its own bounds; measured
    1.3e-3), and against the port's unsharded two-group output atol 1e-5
    (measured 0).
(e) seamless smoke `encdec_loss` (bf16) on the (2, 2) mesh against the
    one-rank loss, rtol 2e-4 (measured 4.2e-5).
(f) a checkpoint of (a)'s state saved on the (2, 2) mesh restores bitwise
    with no sharding context, and onto the (1, 4) mesh with `shardings=`.
(g) `launch.train --arch qwen3-0.6b --smoke --device cpu --steps 3` on 4
    ranks (plan_mesh(4) → (1, 4)) against the one-rank launcher: losses
    rtol 1e-4, one checkpoint, its params as a whole (below).
(h) the vocab lookups (`embed_lookup`, the gold logit) with the
    embedding's width split over 'data', as FSDP splits it at full width
    (the smoke widths are too small for FSDP): against `F.embedding` /
    `gather`, forward and gradients, 1e-6.

The rank processes import no jax: this file is also their script (`python
tests/test_torch_sharded_train.py <dir> <ranks>`), and imports jax only
inside the fixture that computes the references.
"""

import contextlib
import dataclasses
import io
import json
import logging
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

RANKS = 4
TIMEOUT_S = 180
SEQ, BATCH = 16, 8
LAUNCH = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps", "3",
          "--log-every", "1", "--seq-len", str(SEQ), "--global-batch", str(BATCH)]
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the ranks (no jax)
# ---------------------------------------------------------------------------

def _configs():
    from repro_torch import configs

    return (configs.get_smoke_config("qwen3-0.6b"), configs.get_smoke_config("qwen3-moe-235b-a22b"),
            configs.get_smoke_config("seamless-m4t-medium"))


def _train_cfg(opt: str):
    from repro_torch.train import train_step as tts

    return tts.TrainConfig(**{"default": {}, "cast_once": {"cast_params_once": True},
                              "bf16_grads": {"grad_dtype": "bfloat16"},
                              "f32": {"warmup_steps": 1, "total_steps": 10}}[opt])


def _model_cfg(qcfg, opt: str):
    """The smoke config in its bf16 compute dtype, or in f32 for case 'f32'."""
    return dataclasses.replace(qcfg, dtype="float32") if opt == "f32" else qcfg


STEPS = {"f32": 2}  # two steps, the second with lr > 0; one elsewhere


def _flat(tree):
    from repro_torch.tree import tree_flatten_with_names

    def host(x):
        x = x.detach()
        return (x.full_tensor() if hasattr(x, "full_tensor") else x).float().cpu().numpy()

    return {name: host(x) for name, x in tree_flatten_with_names(tree)}


def _rank_main(rank: int, world: int, work: str):
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, "store"), world),
                            rank=rank, world_size=world)
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train as launch_train
    from repro_torch.models import encdec, moe
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.train import train_step as tts
    from repro_torch.tree import tree_map

    with np.load(os.path.join(work, "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    qcfg, mcfg, ecfg = _configs()
    meshes = {shape: shd.ShardingCtx(init_device_mesh("cpu", shape, mesh_dim_names=("data", "model")))
              for shape in ((2, 2), (1, 4))}
    out, text = {}, {}

    def params_of(prefix):
        return bridge.params_from_numpy(_tree(inputs, prefix))

    batches = [{k: torch.from_numpy(inputs[f"batch{i}/{k}"]) for k in ("tokens", "labels")}
               for i in range(2)]

    def train(shape, opt):
        ctx = meshes[shape]
        tc, cfg = _train_cfg(opt), _model_cfg(qcfg, opt)
        state = tts.init_train_state(cfg, tc, params=params_of("p0/"))
        with shd.activate(ctx):
            state = shd.distribute_tree(state, tts.train_state_specs(state))
            step = shd.sharded(tts.make_train_step(cfg, tc), (None, shd.batch_specs(batches[0])))
        for i in range(STEPS.get(opt, 1)):
            state, m = step(state, batches[i])
        return state, m

    for shape, opt in (((2, 2), "default"), ((2, 2), "cast_once"), ((2, 2), "bf16_grads"),
                       ((2, 2), "f32"), ((1, 4), "default")):
        tag = f"{shape[0]}x{shape[1]}_{opt}"
        state, m = train(shape, opt)
        out[f"{tag}/loss"] = np.float64(m["loss"])
        out[f"{tag}/grad_norm"] = np.float64(m["grad_norm"])
        for k, v in _flat(state.params).items():
            out[f"{tag}/params/{k}"] = v
        if tag == "2x2_default":  # (f): save on (2, 2), restore onto (1, 4)
            ckpt.save(os.path.join(work, "ckpt"), 1, state)
            with shd.activate(meshes[(1, 4)]):
                plain = tts.init_train_state(qcfg, _train_cfg("default"), params=params_of("p0/"))
                back, _ = ckpt.restore(os.path.join(work, "ckpt"), plain,
                                       shardings=tts.train_state_specs(plain))
            text["restored_placements"] = sorted({str(tuple(x.placements))
                                                  for x in back.params.values()
                                                  if hasattr(x, "placements")})
            got, want = _flat(back), _flat(state)
            out["restore_1x4_max_diff"] = np.float64(max(
                float(np.abs(got[k] - want[k]).max()) for k in want))

    # (h) the vocab lookups with an FSDP-split embedding width: the
    # embedding and the gold logit against their plain versions, with
    # their gradients
    from repro_torch.models.layers import embed_lookup
    from repro_torch.models.transformer import _gold_rows

    gen = torch.Generator().manual_seed(5)
    table, w = torch.randn(64, 32, generator=gen), torch.randn(4, 8, 32, generator=gen)
    logits, ids = torch.randn(4, 8, 64, generator=gen), torch.randint(0, 64, (4, 8), generator=gen)
    mesh = meshes[(2, 2)].mesh
    t_dt = shd.distribute_tree(table, shd.P("model", "data"), mesh).requires_grad_()
    l_dt = shd.distribute_tree(logits, shd.P("data", None, "model"), mesh).requires_grad_()
    i_dt = shd.distribute_tree(ids, shd.P("data", None), mesh)
    emb = embed_lookup(t_dt, i_dt, torch.float32)
    gold = shd.vocab_island(_gold_rows, l_dt, 2, i_dt)
    ((emb * shd.distribute_tree(w, shd.P("data", None, None), mesh)).sum() + gold.sum()).backward()
    t0, l0 = table.clone().requires_grad_(), logits.clone().requires_grad_()
    emb0 = torch.nn.functional.embedding(ids, t0)
    gold0 = torch.gather(l0, -1, ids[..., None])[..., 0]
    ((emb0 * w).sum() + gold0.sum()).backward()
    out["lookup_max_diff"] = np.float64(max(
        float((a.full_tensor() - b).abs().max())
        for a, b in ((emb, emb0), (gold, gold0), (t_dt.grad, t0.grad), (l_dt.grad, l0.grad))))
    text["lookup_placements"] = [str(tuple(t_dt.placements)), str(tuple(emb.placements))]

    # (d) MoE expert parallelism
    with shd.activate(meshes[(2, 2)]):
        mp_ = params_of("moe/")
        mp_ = shd.distribute_tree(mp_, shd.param_specs(mp_))
        x = shd.distribute_tree(torch.from_numpy(inputs["moe_x"]), shd.P(("data",), None, None))
        y, _ = moe.apply_moe(mp_, x, mcfg)
    out["moe_y"] = y.detach().full_tensor().float().numpy()

    # (e) the encoder-decoder loss
    ebatch = {k: torch.from_numpy(inputs[f"ebatch/{k}"])
              for k in ("frame_embeds", "tokens", "labels")}
    with shd.activate(meshes[(2, 2)]):
        ep = params_of("enc/")
        ep = shd.distribute_tree(ep, shd.param_specs(ep))
        loss = shd.sharded(lambda p, b: encdec.encdec_loss(p, b, ecfg)[0],
                           (None, shd.batch_specs(ebatch)))(ep, ebatch)
    out["encdec_loss"] = np.float64(loss.full_tensor())

    # (g) the launcher on every rank
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_train.main(LAUNCH + ["--ckpt-dir", os.path.join(work, "launch")])
    text["launch_rc"], text["launch_out"] = rc, buf.getvalue()

    text["jax_imported"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    gathered = [None] * world
    dist.all_gather_object(gathered, text["jax_imported"])
    if rank == 0:
        text["any_rank_imported_jax"] = any(gathered)
        np.savez(os.path.join(work, "results.npz"), **out)
        with open(os.path.join(work, "results.json"), "w") as f:
            json.dump(text, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the references (this process) and the one spawn
# ---------------------------------------------------------------------------

def _inputs(work: str):
    """The ranks' inputs, written to `work`: the reference's `PRNGKey(0)`
    weights and batch, its MoE weights and x, an encoder-decoder init and
    batch. Returns what `_expected` needs of them."""
    import jax

    from repro import configs as jconfigs
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.models import moe as jmoe
    from repro.train.train_step import TrainConfig as JTrainConfig
    from repro.train.train_step import init_train_state as j_init_train_state
    from repro_torch import bridge
    from repro_torch.models import encdec
    from repro_torch.tree import tree_flatten_with_names

    _, _, ecfg = _configs()
    inputs = {}

    def put(prefix, tree):
        for n, v in tree_flatten_with_names(bridge.params_to_numpy(
                bridge.params_from_numpy(jax.tree.map(np.asarray, tree)))):
            inputs[f"{prefix}/{n}"] = v

    jcfg = jconfigs.get_smoke_config("qwen3-0.6b")
    data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH))
    batch = data.batch(0)
    state0 = j_init_train_state(jax.random.PRNGKey(0), jcfg, JTrainConfig())
    put("p0", state0.params)
    for i in range(2):
        for k in ("tokens", "labels"):
            inputs[f"batch{i}/{k}"] = data.batch(i)[k]
    jm_cfg = jconfigs.get_smoke_config("qwen3-moe-235b-a22b")
    jm_params = jmoe.init_moe(jax.random.PRNGKey(0), jm_cfg)
    put("moe", jm_params)
    inputs["moe_x"] = np.random.default_rng(0).normal(
        size=(4, 16, jm_cfg.d_model)).astype(np.float32)
    put("enc", encdec.init_encdec(ecfg, device="cpu", seed=0))
    rng = np.random.default_rng(3)
    inputs["ebatch/frame_embeds"] = rng.standard_normal((4, 8, ecfg.d_model)).astype(np.float32)
    inputs["ebatch/tokens"] = rng.integers(0, ecfg.vocab_size, (4, 8)).astype(np.int32)
    inputs["ebatch/labels"] = rng.integers(0, ecfg.vocab_size, (4, 8)).astype(np.int32)
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    return jcfg, state0, batch, jm_cfg, jm_params, inputs


def _expected(work: str, jcfg, state0, batch, jm_cfg, jm_params, inputs) -> dict:
    """The JAX single-device outputs and the port's one-rank outputs."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    from repro.train.train_step import TrainConfig as JTrainConfig
    from repro.train.train_step import make_train_step as j_make_train_step
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train as launch_train
    from repro_torch.models import encdec, moe
    from repro_torch.train import train_step as tts
    from repro_torch.tree import tree_flatten_with_names

    ref = {}
    qcfg, mcfg, ecfg = _configs()
    sref, mref = jax.jit(j_make_train_step(jcfg, JTrainConfig()))(
        state0, jax.tree.map(jnp.asarray, batch))
    ref["jax_loss"] = float(mref["loss"])
    ref["jax_params"] = {n: np.asarray(x, np.float32) for n, x in tree_flatten_with_names(
        bridge.params_to_numpy(bridge.params_from_numpy(jax.tree.map(np.asarray, sref.params))))}

    p0 = jax.tree.map(np.asarray, state0.params)
    for opt in ("default", "cast_once", "bf16_grads", "f32"):
        tc, cfg = _train_cfg(opt), _model_cfg(qcfg, opt)
        state = tts.init_train_state(cfg, tc, params=bridge.params_from_numpy(p0))
        step = tts.make_train_step(cfg, tc)
        for i in range(STEPS.get(opt, 1)):
            state, m = step(state, {k: torch.from_numpy(inputs[f"batch{i}/{k}"])
                                    for k in ("tokens", "labels")})
        ref[f"one/{opt}"] = (float(m["loss"]), float(m["grad_norm"]), _flat(state.params))

    x = inputs["moe_x"]
    ref["jax_moe_y"] = np.asarray(jmoe.apply_moe(jm_params, jnp.asarray(x), jm_cfg)[0],
                                  np.float32)
    # the port's unsharded output with the (2, 2) mesh's two token groups
    fake = shd.ShardingCtx.__new__(shd.ShardingCtx)
    fake.mesh, fake.axis_sizes, fake.has_pod = None, {"data": 2, "model": 2}, False
    with shd.activate(fake):
        ref["moe_y_two_groups"] = moe.apply_moe(
            bridge.params_from_numpy(jax.tree.map(np.asarray, jm_params)),
            torch.from_numpy(x), mcfg)[0].float().numpy()

    ep = bridge.params_from_numpy(_tree(inputs, "enc/"))
    ebatch = {k: torch.from_numpy(inputs[f"ebatch/{k}"]) for k in ("frame_embeds", "tokens",
                                                                  "labels")}
    ref["encdec_loss"] = float(encdec.encdec_loss(ep, ebatch, ecfg)[0])

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_train.main(LAUNCH + ["--ckpt-dir", os.path.join(work, "launch_one")])
    ref["launch_one_out"] = buf.getvalue()
    return ref


def _tree(flat, prefix):
    """The nested dict of the `prefix`ed entries of a flat name → array map."""
    tree = {}
    for key in flat:
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return tree


def _spawn(work: str) -> subprocess.Popen:
    """Start the one run of RANKS processes, in a session of its own (so a
    run past TIMEOUT_S is killed whole)."""
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", work),
           "PYTHONPATH": os.path.join(_REPO, "src"), "OMP_NUM_THREADS": "1",
           "TMPDIR": work}
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), work, str(RANKS)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                            cwd=_REPO, start_new_session=True)


def _join(proc: subprocess.Popen, timeout: float) -> None:
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the {RANKS}-rank run passed {TIMEOUT_S} s")
    assert proc.returncode == 0, log.decode()[-6000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks start as soon as their inputs exist; the references are
    computed here while they run."""
    import time

    work = str(tmp_path_factory.mktemp("sharded"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.monotonic()
    try:
        made = _inputs(work)
        proc = _spawn(work)
        try:
            ref = _expected(work, *made)
        except BaseException:
            os.killpg(proc.pid, signal.SIGKILL)
            raise
    finally:
        torch.set_num_threads(n)
    _join(proc, TIMEOUT_S - (time.monotonic() - t0))
    with np.load(os.path.join(work, "results.npz")) as z:
        got = {k: z[k] for k in z.files}
    with open(os.path.join(work, "results.json")) as f:
        text = json.load(f)
    return ref, got, text, work


def _params(got, tag):
    head = f"{tag}/params/"
    return {k[len(head):]: v for k, v in got.items() if k.startswith(head)}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_sharded_train_step_matches_the_single_device_reference(runs, mesh):
    ref, got, _, _ = runs
    tag = f"{mesh}_default"
    np.testing.assert_allclose(float(got[f"{tag}/loss"]), ref["jax_loss"], rtol=1e-4)
    params = _params(got, tag)
    assert sorted(params) == sorted(ref["jax_params"])
    for name, want in ref["jax_params"].items():
        np.testing.assert_allclose(params[name], want, rtol=2e-3, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("mesh,opt", [("2x2", "default"), ("1x4", "default"),
                                      ("2x2", "cast_once"), ("2x2", "bf16_grads")])
def test_sharded_train_step_matches_the_one_rank_step(runs, mesh, opt):
    """bf16 compute: the shards round their partial products apart from the
    one-rank step's (measured: loss ≤ 1.5e-5, grad norm ≤ 2.0e-4 relative).
    lr is 0 at step 0 of `TrainConfig()`, so the params are the init's on
    both sides, bit for bit."""
    ref, got, _, _ = runs
    loss, gnorm, params = ref[f"one/{opt}"]
    tag = f"{mesh}_{opt}"
    np.testing.assert_allclose(float(got[f"{tag}/loss"]), loss, rtol=1e-4)
    np.testing.assert_allclose(float(got[f"{tag}/grad_norm"]), gnorm, rtol=1e-3)
    mine = _params(got, tag)
    for name, want in params.items():
        np.testing.assert_array_equal(mine[name], want, err_msg=name)


def test_sharded_f32_steps_match_the_one_rank_steps(runs):
    """f32 compute, two steps, the second with lr > 0, on the (2, 2) mesh
    (measured: loss and grad norm equal, params ≤ 4.4e-8)."""
    ref, got, _, _ = runs
    loss, gnorm, params = ref["one/f32"]
    np.testing.assert_allclose(float(got["2x2_f32/loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(float(got["2x2_f32/grad_norm"]), gnorm, rtol=1e-5)
    mine = _params(got, "2x2_f32")
    assert any(np.abs(mine[n] - ref["jax_params"][n]).max() > 0 for n in params)  # moved
    for name, want in params.items():
        np.testing.assert_allclose(mine[name], want, rtol=0, atol=1e-5, err_msg=name)


def test_moe_expert_parallel_matches_the_reference(runs):
    ref, got, _, _ = runs
    np.testing.assert_allclose(got["moe_y"], ref["jax_moe_y"], rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(got["moe_y"], ref["moe_y_two_groups"], rtol=0, atol=1e-5)


def test_sharded_encdec_loss_matches_one_rank(runs):
    """bf16 compute (measured 4.2e-5 relative)."""
    ref, got, _, _ = runs
    np.testing.assert_allclose(float(got["encdec_loss"]), ref["encdec_loss"], rtol=2e-4)


def test_sharded_checkpoint_restores_bitwise_and_onto_another_mesh(runs):
    from repro_torch import configs
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.train import train_step as tts

    _, got, text, work = runs
    cfg = configs.get_smoke_config("qwen3-0.6b")
    template = tts.init_train_state(cfg, tts.TrainConfig(), device="cpu")
    state, _ = ckpt.restore(os.path.join(work, "ckpt"), template)
    for name, x in _flat(state.params).items():
        np.testing.assert_array_equal(x, got[f"2x2_default/params/{name}"], err_msg=name)
    assert float(got["restore_1x4_max_diff"]) == 0.0
    assert any("Shard" in p for p in text["restored_placements"])


def test_launcher_on_four_ranks_ends_at_the_one_rank_loss(runs):
    """Three steps with lr > 0 after the first: the 4-rank run's losses and
    its checkpoint at step 3 against the 1-rank launcher's. bf16 compute
    and lr 3e-3: Adam moves an entry whose gradient is rounding noise by up
    to lr either way, so the params are held as a whole — their deviation
    ≤ 0.1 of the update (measured 0.031)."""
    from repro_torch import configs
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.train import train_step as tts

    ref, _, text, work = runs

    def losses(out):
        return [float(x) for x in re.findall(r"step +\d+ loss (\S+)", out)]

    assert text["launch_rc"] == 0
    assert "mesh" in text["launch_out"] and "done: 3 committed steps" in text["launch_out"]
    np.testing.assert_allclose(losses(text["launch_out"]), losses(ref["launch_one_out"]),
                               rtol=1e-4)
    assert len(losses(text["launch_out"])) == 3
    assert sorted(os.listdir(os.path.join(work, "launch"))) == ["step_00000003"]
    template = tts.init_train_state(configs.get_smoke_config("qwen3-0.6b"), tts.TrainConfig(),
                                    device="cpu")
    four, _ = ckpt.restore(os.path.join(work, "launch"), template)
    one, _ = ckpt.restore(os.path.join(work, "launch_one"), template)
    init = _flat(template.params)
    got, want = _flat(four.params), _flat(one.params)
    dev = np.sqrt(sum(float(((got[n] - want[n]) ** 2).sum()) for n in want))
    upd = np.sqrt(sum(float(((want[n] - init[n]) ** 2).sum()) for n in want))
    assert dev <= 0.1 * upd, (dev, upd)


def test_vocab_lookups_with_a_split_embedding_width(runs):
    """(h) `embed_lookup` on a table split over 'model' (vocab) and 'data'
    (width, as FSDP splits a full-width embedding) and the gold-logit
    lookup on vocab-split logits, forward and gradients, against the plain
    `F.embedding` / `gather`: within 1e-6 (the table's gradient sums a
    row's ids across the batch shards in another order; measured 4.8e-7)."""
    _, got, text, _ = runs
    assert float(got["lookup_max_diff"]) <= 1e-6
    assert text["lookup_placements"][0] == "(Shard(dim=1), Shard(dim=0))"


def test_ranks_import_no_jax(runs):
    assert runs[2]["any_rank_imported_jax"] is False


if __name__ == "__main__":
    import torch.multiprocessing as mp

    work_dir, world = sys.argv[1], int(sys.argv[2])
    mp.spawn(_rank_main, args=(world, work_dir), nprocs=world)
