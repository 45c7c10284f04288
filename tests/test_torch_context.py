"""Context parallelism of the port (`repro_torch.distributed.context`) on
the CPU: one spawn of 4 gloo processes runs every multi-rank case, and each
test reads its results. The references are the JAX package's single-device
outputs on the same numpy inputs (the outputs its own 8-device tests
compare against), computed in this process while the ranks run.

Rank cases, with their bounds:
(a) `ring_prefill` on ('data',) 4 (shards of 16) for causal, local
    (window 13), chunked (chunk = shard) and full masks, impls flashd and
    fa2, against the reference's `flash_attention`: rtol 1e-4 / atol 1e-5.
    Each rank sends 2·(n_hops − 1) messages, each one KV shard, and
    gathers nothing; a gradient-carrying input raises.
(b) `cp_decode` on ragged cache_len (a full row, one inside shard 0, an
    empty row, one across two shards), no mask / window 12 / chunk 16,
    K2's route (its plain version here) and the plain partial, against
    `repro.kernels.ref.decode_ref`: 2e-5; O bitwise equal on every rank;
    log₂ 4 = 2 butterfly rounds of (O, Λ) messages, no gather.
(c) batch and sequence: a (data 2, model 2) mesh, Hkv 1, so the kv_cache
    rule splits the batch over 'data' and the sequence over 'model';
    `decode_attention` under the context against `decode_ref`: 2e-5.
(d) a 3-rank mesh of ranks 0–2 (not a power of two): one all_gather of
    the partials, no point-to-point message, against `decode_ref`: 2e-5.
(e) routing: `flash_attention` under a context with `cp_prefill=True`
    takes the ring, without it the single-device path (both against the
    reference, 1e-4 / 1e-5); `decode_attention` at B 2 (which 'data' 4
    does not divide) takes `cp_decode`: 2e-5.
(f) the paged decode step (`prefill_lm` on a replicated page pool) under
    the context takes `maybe_cp_decode` on the gathered pages: logits
    against the reference's unsharded `prefill_lm`, 1e-4.
(g) `Engine.generate` at B 2 on ('data',) 4 — a sequence-sharded cache —
    gives the reference's unsharded tokens with one host sync; the
    sequential contiguous `serve` (max_batch 2) the reference's streams,
    and so does rank 0 alone on a (1,) mesh (the batch split over one rank).

In-process cases: `ring_hop` at every hop against the reference's
`_shard_fwd`, `decode_partial` against its `_jnp_shard_partial` (1e-5),
the butterfly's merge order, and the engine's refusals on a context.

The rank processes import no jax: this file is also their script (`python
tests/test_torch_context.py <dir> <ranks>`), and imports jax only inside
the fixture and the in-process tests.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

RANKS = 4
TIMEOUT_S = 150
RING = dict(b=1, s=64, hq=4, hkv=2, d=16)
MASKS = {"causal": dict(kind="causal"), "local": dict(kind="local", window=13),
         "chunked": dict(kind="chunked", chunk=RING["s"] // RANKS), "full": dict(kind="full")}
DECODE_LEN = [64, 5, 0, 23]  # full; inside shard 0; empty; across shards 0 and 1
DECODE_MASKS = [(0, 0), (12, 0), (0, 16)]
GATHER_S = 48
N_NEW = 8
SERVE_LENS, SERVE_NEW = (6, 4, 3), 6
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_cfg(paper_llama_config):
    """The reference's own CP test model: paper-llama at 2 layers, d 32."""
    return dataclasses.replace(paper_llama_config, n_layers=2, d_model=32, n_heads=4,
                               n_kv_heads=2, d_ff=64, head_dim=8, vocab_size=64,
                               vocab_pad_multiple=32)


def _paged_tables():
    return np.asarray([np.arange(1, 9), np.arange(9, 17)], np.int32)  # distinct pages per row


# ---------------------------------------------------------------------------
# the ranks (no jax)
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, work: str):
    import logging

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, "store"), world),
                            rank=rank, world_size=world)
    from repro_torch import bridge
    from repro_torch.configs import paper_llama
    from repro_torch.core.attention import MaskSpec, decode_attention, flash_attention
    from repro_torch.distributed import context as cpx
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tree import tree_map

    with np.load(os.path.join(work, "inputs.npz")) as z:
        inp = {k: torch.from_numpy(z[k]) for k in z.files}
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    mesh3 = DeviceMesh("cpu", [0, 1, 2], mesh_dim_names=("data",))  # every rank builds it
    out, text = {}, {"wire": {}}

    def wire(key):
        text["wire"][key] = [cpx.sends, sorted(list(s) for s in cpx.send_shapes), cpx.gathers]
        cpx.reset_wire()

    # (a) the ring
    q, k, v = inp["ring_q"], inp["ring_k"], inp["ring_v"]
    for name, kw in MASKS.items():
        for impl in ("flashd", "fa2"):
            cpx.reset_wire()
            out[f"ring/{name}/{impl}"] = cpx.ring_prefill(q, k, v, axis="data", mesh=mesh,
                                                          mask=MaskSpec(**kw), impl=impl).numpy()
            wire(f"ring/{name}/{impl}")
    try:
        cpx.ring_prefill(q.clone().requires_grad_(), k, v, axis="data", mesh=mesh)
        text["grad_refused"] = False
    except RuntimeError:
        text["grad_refused"] = True
    wire("ring/grad")

    # (b) cp_decode
    dq, dk, dv, dl = inp["dec_q"], inp["dec_k"], inp["dec_v"], inp["dec_len"]
    for w, c in DECODE_MASKS:
        for use_kernel in (True, False):
            key = f"decode/{w}_{c}_{int(use_kernel)}"
            out[key] = cpx.cp_decode(dq, dk, dv, dl, axis="data", mesh=mesh, window=w, chunk=c,
                                     use_kernel=use_kernel).numpy()
            wire(key)

    # (c) batch over 'data', sequence over 'model'
    with shd.activate(shd.ShardingCtx(mesh22)):
        text["bs_axes"] = [shd.cp_axis_for_cache(tuple(inp["bs_k"].shape)),
                           shd.cp_batch_axes_for_cache(tuple(inp["bs_k"].shape))]
        out["bs"] = decode_attention(inp["bs_q"], inp["bs_k"], inp["bs_v"], inp["bs_len"]).numpy()
    wire("bs")

    # (d) three ranks: the gather
    if rank < 3:
        out["gather"] = cpx.cp_decode(dq, dk[:, :GATHER_S], dv[:, :GATHER_S],
                                      torch.clamp(dl, max=GATHER_S), axis="data", mesh=mesh3,
                                      use_kernel=False).numpy()
        wire("gather")

    # (e) routing
    causal = MaskSpec("causal")
    with shd.activate(shd.ShardingCtx(mesh, cp_prefill=True)):
        out["route/prefill_on"] = flash_attention(q, k, v, mask=causal).numpy()
        wire("route/prefill_on")
    with shd.activate(shd.ShardingCtx(mesh)):
        out["route/prefill_off"] = flash_attention(q, k, v, mask=causal).numpy()
        wire("route/prefill_off")
        text["route_axis"] = shd.cp_axis_for_cache(tuple(inp["rt_k"].shape))
        out["route/decode"] = decode_attention(inp["rt_q"], inp["rt_k"], inp["rt_v"],
                                               inp["rt_len"]).numpy()
        wire("route/decode")

    # (f) the paged decode step under the context
    cfg = _tiny_cfg(paper_llama.CONFIG)
    params = bridge.params_from_numpy(_tree(inp, "p/"))
    prompts = inp["prompts"]
    ctx = shd.ShardingCtx(mesh)
    with torch.no_grad(), shd.activate(ctx):
        cache = tf.init_decode_cache(2, 64, cfg, layout="paged", page_size=8, device="cpu")
        for leaf in (layer["tbl"] for layer in cache["blocks"].values()):
            leaf[:] = torch.from_numpy(_paged_tables())[None]
        cache = shd.distribute_tree(cache, tree_map(lambda x: shd.P(*([None] * x.ndim)), cache))
        dparams = shd.distribute_tree(params, shd.param_specs(params))
        logits, _ = tf.prefill_lm(dparams, prompts, cache, cfg)
        out["paged_logits"] = logits.full_tensor().numpy()
    wire("paged")

    # (g) the engine on the CP mesh
    eng = Engine(params, cfg, ServeConfig(max_len=64, temperature=0.0), device="cpu",
                 sharding_ctx=ctx)
    out["gen"] = eng.generate(prompts.numpy(), N_NEW)
    text["gen_host_syncs"] = eng.host_syncs
    text["gen_placements"] = str(tuple(eng._contig[2].cache["blocks"]["pos0"]["k"].placements))
    wire("gen")
    reqs = [inp[f"req{i}"].numpy() for i in range(len(SERVE_LENS))]
    got = Engine(params, cfg, ServeConfig(max_len=64, temperature=0.0, max_batch=2),
                 device="cpu", sharding_ctx=ctx).serve(reqs, SERVE_NEW)
    for i, toks in enumerate(got):
        out[f"serve{i}"] = toks
    wire("serve")
    mesh1 = DeviceMesh("cpu", [0], mesh_dim_names=("data",))  # every rank builds it
    if rank == 0:  # one rank: the batch split over a mesh dim of size 1 (no CP axis)
        got = Engine(params, cfg, ServeConfig(max_len=64, temperature=0.0, max_batch=2),
                     device="cpu", sharding_ctx=shd.ShardingCtx(mesh1)).serve(reqs, SERVE_NEW)
        for i, toks in enumerate(got):
            out[f"serve_one_rank{i}"] = toks
        wire("serve_one_rank")

    text["jax_imported"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    np.savez(os.path.join(work, f"results{rank}.npz"), **out)
    with open(os.path.join(work, f"results{rank}.json"), "w") as f:
        json.dump(text, f)
    dist.barrier()
    dist.destroy_process_group()


def _tree(flat, prefix):
    """The nested dict of the `prefix`ed entries of a flat name → array map."""
    tree = {}
    for key in flat:
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(flat[key])
    return tree


# ---------------------------------------------------------------------------
# the inputs and references (this process) and the one spawn
# ---------------------------------------------------------------------------

def _inputs(work: str) -> dict:
    """The ranks' numpy inputs, written to `work`: the ring's q / k / v, the
    decode caches, the reference's `PRNGKey(0)` weights of the tiny model,
    its prompts."""
    import jax

    from repro.configs import paper_llama as j_paper_llama
    from repro.models import get_model as j_get_model
    from repro_torch.tree import tree_flatten_with_names

    f32 = lambda rng, *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    inp = {}
    rng = np.random.default_rng(0)
    r = RING
    inp["ring_q"] = f32(rng, r["b"], r["s"], r["hq"], r["d"])
    inp["ring_k"] = f32(rng, r["b"], r["s"], r["hkv"], r["d"])
    inp["ring_v"] = f32(rng, r["b"], r["s"], r["hkv"], r["d"])
    rng = np.random.default_rng(2)
    inp["dec_q"], inp["dec_k"], inp["dec_v"] = (f32(rng, 4, 8, 16), f32(rng, 4, 64, 2, 16),
                                                f32(rng, 4, 64, 2, 16))
    inp["dec_len"] = np.asarray(DECODE_LEN, np.int64)
    rng = np.random.default_rng(5)
    inp["bs_q"], inp["bs_k"], inp["bs_v"] = (f32(rng, 2, 1, 4, 16), f32(rng, 2, 64, 1, 16),
                                             f32(rng, 2, 64, 1, 16))
    inp["bs_len"] = np.asarray([64, 11], np.int64)
    rng = np.random.default_rng(3)
    inp["rt_q"], inp["rt_k"], inp["rt_v"] = (f32(rng, 2, 1, 4, 16), f32(rng, 2, 64, 2, 16),
                                             f32(rng, 2, 64, 2, 16))
    inp["rt_len"] = np.asarray([40, 0], np.int64)
    jcfg = _tiny_cfg(j_paper_llama.CONFIG)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    for name, x in tree_flatten_with_names(jax.tree.map(np.asarray, jparams)):
        inp[f"p/{name}"] = x
    inp["prompts"] = np.random.default_rng(4).integers(0, 64, (2, 6)).astype(np.int64)
    rng = np.random.default_rng(6)
    for i, n in enumerate(SERVE_LENS):
        inp[f"req{i}"] = rng.integers(0, 64, (n,)).astype(np.int64)
    np.savez(os.path.join(work, "inputs.npz"), **inp)
    return inp


def _expected(inp: dict) -> dict:
    """The JAX package's single-device outputs."""
    import jax
    import jax.numpy as jnp

    from repro.configs import paper_llama as j_paper_llama
    from repro.core.attention import MaskSpec as JMaskSpec
    from repro.core.attention import flash_attention as j_flash_attention
    from repro.kernels.ref import decode_ref as j_decode_ref
    from repro.kernels.tuning import choose_ring_schedule as j_schedule
    from repro.models import get_model as j_get_model
    from repro.models.transformer import init_decode_cache as j_init_cache
    from repro.models.transformer import prefill_lm as j_prefill_lm
    from repro.serve import Engine as JEngine
    from repro.serve import ServeConfig as JServeConfig

    ref = {}
    q, k, v = (jnp.asarray(inp[f"ring_{x}"]) for x in "qkv")
    for name, kw in MASKS.items():
        ref[f"ring/{name}"] = np.asarray(j_flash_attention(q, k, v, mask=JMaskSpec(**kw),
                                                           impl="flashd", block_q=16,
                                                           block_k=16))
        s_sh = RING["s"] // RANKS
        ref[f"hops/{name}"] = j_schedule(s_sh, s_sh, RING["d"], RING["d"], n_devices=RANKS,
                                         mask=JMaskSpec(**kw)).n_hops

    def dref(q_, k_, v_, cl, **kw):
        return np.asarray(j_decode_ref(jnp.asarray(q_), jnp.asarray(k_).transpose(0, 2, 1, 3),
                                       jnp.asarray(v_).transpose(0, 2, 1, 3),
                                       jnp.asarray(cl, jnp.int32), **kw))

    for w, c in DECODE_MASKS:
        ref[f"decode/{w}_{c}"] = dref(inp["dec_q"], inp["dec_k"], inp["dec_v"], inp["dec_len"],
                                      window=w, chunk=c)
    ref["bs"] = dref(inp["bs_q"][:, 0], inp["bs_k"], inp["bs_v"], inp["bs_len"])
    ref["gather"] = dref(inp["dec_q"], inp["dec_k"][:, :GATHER_S], inp["dec_v"][:, :GATHER_S],
                         np.minimum(inp["dec_len"], GATHER_S))
    ref["route/decode"] = dref(inp["rt_q"][:, 0], inp["rt_k"], inp["rt_v"], inp["rt_len"])

    jcfg = _tiny_cfg(j_paper_llama.CONFIG)
    jparams = jax.tree.map(jnp.asarray, _tree(inp, "p/"))
    prompts = jnp.asarray(inp["prompts"], jnp.int32)
    cache = j_init_cache(2, 64, jcfg, layout="paged", page_size=8)
    tbl = jnp.asarray(_paged_tables())
    cache = jax.tree_util.tree_map_with_path(
        lambda p, x: x.at[:].set(tbl[None]) if any(getattr(e, "key", None) == "tbl" for e in p)
        else x, cache)
    ref["paged_logits"] = np.asarray(j_prefill_lm(jparams, prompts, cache, jcfg)[0])
    ref["gen"] = JEngine(jparams, jcfg, JServeConfig(max_len=64, temperature=0.0)).generate(
        np.asarray(inp["prompts"], np.int32), N_NEW)
    reqs = [np.asarray(inp[f"req{i}"], np.int32) for i in range(len(SERVE_LENS))]
    ref["serve"] = JEngine(jparams, jcfg, JServeConfig(max_len=64, temperature=0.0,
                                                       max_batch=2)).serve(reqs, SERVE_NEW)
    assert j_get_model(jcfg) is not None
    return ref


def _spawn(work: str) -> subprocess.Popen:
    """Start the RANKS processes in a session of their own (so a run past
    TIMEOUT_S is killed whole)."""
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", work),
           "PYTHONPATH": os.path.join(_REPO, "src"), "OMP_NUM_THREADS": "1", "TMPDIR": work}
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), work, str(RANKS)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                            cwd=_REPO, start_new_session=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks start as soon as their inputs exist; the references are
    computed here while they run. → (ref, [per-rank arrays], [per-rank
    json], inputs)."""
    import time

    work = str(tmp_path_factory.mktemp("context"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.monotonic()
    try:
        inp = _inputs(work)
        proc = _spawn(work)
        try:
            ref = _expected(inp)
        except BaseException:
            os.killpg(proc.pid, signal.SIGKILL)
            raise
    finally:
        torch.set_num_threads(n)
    try:
        log, _ = proc.communicate(timeout=max(TIMEOUT_S - (time.monotonic() - t0), 1))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the {RANKS}-rank run passed {TIMEOUT_S} s")
    assert proc.returncode == 0, log.decode()[-6000:]
    got, text = [], []
    for r in range(RANKS):
        with np.load(os.path.join(work, f"results{r}.npz")) as z:
            got.append({k: z[k] for k in z.files})
        with open(os.path.join(work, f"results{r}.json")) as f:
            text.append(json.load(f))
    return ref, got, text, inp


# ---------------------------------------------------------------------------
# the rank cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["flashd", "fa2"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_ring_prefill_matches_the_single_device_reference(runs, mask, impl):
    ref, got, _, _ = runs
    for r in range(RANKS):
        np.testing.assert_allclose(got[r][f"ring/{mask}/{impl}"], ref[f"ring/{mask}"],
                                   rtol=1e-4, atol=1e-5, err_msg=f"rank {r}")


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_ring_wire_is_one_kv_shard_a_hop(runs, mask):
    """2·(n_hops − 1) sends per rank, each one K or V shard; no gather. The
    hop count is the reference's schedule on this mesh (causal 4, local 2,
    chunked 1, full 4)."""
    from repro_torch.core.blockwise import MaskSpec
    from repro_torch.kernels.tuning import choose_ring_schedule

    ref, _, text, _ = runs
    s_sh = RING["s"] // RANKS
    hops = choose_ring_schedule(s_sh, s_sh, RING["d"], RING["d"], n_devices=RANKS,
                                mask=MaskSpec(**MASKS[mask])).n_hops
    assert hops == ref[f"hops/{mask}"] == {"causal": 4, "local": 2, "chunked": 1, "full": 4}[mask]
    shard = [RING["b"], s_sh, RING["hkv"], RING["d"]]
    for r in range(RANKS):
        for impl in ("flashd", "fa2"):
            sends, shapes, gathers = text[r]["wire"][f"ring/{mask}/{impl}"]
            assert sends == 2 * (hops - 1) and gathers == 0, (r, sends, gathers)
            assert shapes in ([], [shard]), shapes


def test_ring_hop_counts_match_the_references_wire_contract():
    """The reference's 8-device wire contract (8 / 3 / 1 hops at shards of
    8) from the port's copied schedule and the reference's own."""
    from repro.core.attention import MaskSpec as JMaskSpec
    from repro.kernels.tuning import choose_ring_schedule as j_schedule
    from repro_torch.core.blockwise import MaskSpec
    from repro_torch.kernels.tuning import choose_ring_schedule

    for kw, want in ((dict(kind="causal"), 8), (dict(kind="local", window=13), 3),
                     (dict(kind="chunked", chunk=8), 1)):
        got = choose_ring_schedule(8, 8, 16, 16, n_devices=8, mask=MaskSpec(**kw))
        jref = j_schedule(8, 8, 16, 16, n_devices=8, mask=JMaskSpec(**kw))
        assert got.n_hops == jref.n_hops == want
        assert (got.block_q, got.block_k) == (jref.block_q, jref.block_k)


def test_ring_prefill_refuses_a_gradient(runs):
    _, _, text, _ = runs
    assert all(t["grad_refused"] for t in text)
    assert all(t["wire"]["ring/grad"][0] == 0 for t in text)  # refused before any message


@pytest.mark.parametrize("use_kernel", [True, False], ids=["k2_route", "plain_partial"])
@pytest.mark.parametrize("w,c", DECODE_MASKS, ids=["none", "window12", "chunk16"])
def test_cp_decode_matches_decode_ref_bitwise_on_every_rank(runs, w, c, use_kernel):
    ref, got, text, _ = runs
    key = f"decode/{w}_{c}_{int(use_kernel)}"
    np.testing.assert_allclose(got[0][key], ref[f"decode/{w}_{c}"], rtol=2e-5, atol=2e-5)
    for r in range(1, RANKS):
        np.testing.assert_array_equal(got[r][key], got[0][key], err_msg=f"rank {r}")
    for r in range(RANKS):  # log2(4) rounds of one O and one Λ message
        assert text[r]["wire"][key] == [4, [[4, 8], [4, 8, 16]], 0], text[r]["wire"][key]


def test_cp_decode_on_a_batch_and_sequence_mesh(runs):
    ref, got, text, _ = runs
    assert text[0]["bs_axes"] == ["model", ["data"]]
    for r in range(RANKS):
        np.testing.assert_allclose(got[r]["bs"][:, 0], ref["bs"], rtol=2e-5, atol=2e-5)
        assert text[r]["wire"]["bs"][0] == 2  # one round over 'model' 2: O and Λ


def test_cp_decode_gathers_on_a_non_power_of_two_axis(runs):
    ref, got, text, _ = runs
    for r in range(3):
        np.testing.assert_allclose(got[r]["gather"], ref["gather"], rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(got[r]["gather"], got[0]["gather"])
        assert text[r]["wire"]["gather"] == [0, [], 1]
    assert "gather" not in got[3]


def test_attention_routes_through_context_parallelism(runs):
    ref, got, text, _ = runs
    for r in range(RANKS):
        for key in ("route/prefill_on", "route/prefill_off"):
            np.testing.assert_allclose(got[r][key], ref["ring/causal"], rtol=1e-4, atol=1e-5)
        assert text[r]["wire"]["route/prefill_on"][0] == 2 * (RANKS - 1)  # the ring
        assert text[r]["wire"]["route/prefill_off"][0] == 0  # cp_prefill is off by default
        assert text[r]["route_axis"] == "data"
        np.testing.assert_allclose(got[r]["route/decode"][:, 0], ref["route/decode"],
                                   rtol=2e-5, atol=2e-5)
        assert text[r]["wire"]["route/decode"][0] == 4


def test_paged_decode_step_routes_through_cp_under_a_context(runs):
    ref, got, text, _ = runs
    for r in range(RANKS):
        np.testing.assert_allclose(got[r]["paged_logits"], ref["paged_logits"], rtol=1e-4,
                                   atol=1e-4)
        # 6 positions × 2 layers × 2 rounds × (O, Λ)
        assert text[r]["wire"]["paged"][0] == 6 * 2 * 4


def test_engine_generate_on_a_cp_mesh_matches_the_reference(runs):
    ref, got, text, _ = runs
    for r in range(RANKS):
        np.testing.assert_array_equal(got[r]["gen"], ref["gen"])
        assert text[r]["gen_host_syncs"] == 1
        assert text[r]["gen_placements"] == "(Shard(dim=2),)"  # [L, B, S, H, hd]: the sequence
        # (6 prompt positions + 7 decode steps) × 2 layers × 2 rounds × (O, Λ)
        assert text[r]["wire"]["gen"][0] == (6 + N_NEW - 1) * 2 * 4


def test_engine_serve_on_a_cp_mesh_matches_the_reference(runs):
    ref, got, text, _ = runs
    for r in range(RANKS):
        for i, want in enumerate(ref["serve"]):
            np.testing.assert_array_equal(got[r][f"serve{i}"], want)
        assert text[r]["wire"]["serve"][0] > 0
    for i, want in enumerate(ref["serve"]):  # rank 0 on a (1,) mesh: no message
        np.testing.assert_array_equal(got[0][f"serve_one_rank{i}"], want)
    assert text[0]["wire"]["serve_one_rank"] == [0, [], 0]


def test_ranks_import_no_jax(runs):
    assert not any(t["jax_imported"] for t in runs[2])


# ---------------------------------------------------------------------------
# in-process cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["flashd", "fa2"])
@pytest.mark.parametrize("mask", ["causal", "local", "chunked", "full"])
def test_ring_hop_matches_the_references_shard_fwd(mask, impl):
    """Rank 3's hops (no wrapped shard) against the reference's `_shard_fwd`
    on the same shards and hop masks; wrapped shards launch nothing."""
    import jax.numpy as jnp

    from repro.core.attention import MaskSpec as JMaskSpec
    from repro.distributed import context as jctx
    from repro_torch.core.blockwise import MaskSpec
    from repro_torch.distributed.context import ring_hop

    rng = np.random.default_rng(7)
    s_sh, n = 16, RANKS
    q = rng.normal(size=(1, 4, s_sh, 16)).astype(np.float32)  # kernel layout
    ks = rng.normal(size=(n, 1, 2, s_sh, 16)).astype(np.float32)
    vs = rng.normal(size=(n, 1, 2, s_sh, 16)).astype(np.float32)
    kw = MASKS[mask]
    scale = 0.25
    for h in range(n):
        got = ring_hop(torch.from_numpy(q), torch.from_numpy(ks[h]), torch.from_numpy(vs[h]),
                       idx=n - 1, h=h, mask=MaskSpec(**kw), scale=scale, impl=impl,
                       block_q=8, block_k=8)
        jm = JMaskSpec(**kw)
        hop = dataclasses.replace(jm, kind="full" if jctx._hop_fully_visible(jm, h, s_sh, s_sh)
                                  else jm.kind, q_offset=h * s_sh)
        want = jctx._shard_fwd(jnp.asarray(q), jnp.asarray(ks[h]), jnp.asarray(vs[h]), mask=hop,
                               scale=scale, impl=impl, block_q=8, block_k=8, skip=False,
                               interpret=True)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
        if h:  # rank h − 1 holds a wrapped shard at hop h
            wrapped = ring_hop(torch.from_numpy(q), torch.from_numpy(ks[h]),
                               torch.from_numpy(vs[h]), idx=h - 1, h=h, mask=MaskSpec(**kw),
                               scale=scale, impl=impl, block_q=8, block_k=8)
            assert (wrapped is None) == (mask != "full")


@pytest.mark.parametrize("use_kernel", [True, False], ids=["k2_route", "plain_partial"])
def test_decode_partial_matches_the_references_shard_partial(use_kernel):
    """Each shard's partial against the reference's `_jnp_shard_partial` on
    the clip the reference computes (`_lo_bound`, window 12)."""
    import jax.numpy as jnp

    from repro.distributed import context as jctx
    from repro_torch.distributed.context import decode_partial

    rng = np.random.default_rng(8)
    q = rng.normal(size=(4, 8, 16)).astype(np.float32)
    kc = rng.normal(size=(4, 64, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(4, 64, 2, 16)).astype(np.float32)
    cl = np.asarray(DECODE_LEN)
    s_sh = 16
    for idx in range(RANKS):
        sl = slice(idx * s_sh, (idx + 1) * s_sh)
        o, lam = decode_partial(torch.from_numpy(q), torch.from_numpy(kc[:, sl]),
                                torch.from_numpy(vc[:, sl]), torch.from_numpy(cl), idx=idx,
                                scale=0.25, window=12, use_kernel=use_kernel)
        lo = np.maximum(cl - 12, 0)
        start = np.clip(lo - idx * s_sh, 0, s_sh)
        hi = np.clip(cl - idx * s_sh, 0, s_sh)
        wo, wl = jctx._jnp_shard_partial(jnp.asarray(q), jnp.asarray(kc[:, sl]),
                                         jnp.asarray(vc[:, sl]), jnp.asarray(hi),
                                         jnp.asarray(start), 0.25)
        np.testing.assert_allclose(o.numpy(), np.asarray(wo), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lam.numpy(), np.asarray(wl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["flashd_gpu", "fa2_gpu"])
def test_ring_hop_on_the_kernel_route_refuses_a_cpu_tensor(impl):
    """No fallback hides the card: the kernel impls launch or raise."""
    from repro_torch.core.blockwise import MaskSpec
    from repro_torch.distributed.context import ring_hop

    x = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ring_hop(x, x, x, idx=1, h=1, mask=MaskSpec("causal"), scale=0.25, impl=impl,
                 block_q=8, block_k=8)


def test_butterfly_merge_gives_both_partners_the_same_bits():
    from repro_torch.core.blockwise import merge_pair
    from repro_torch.distributed.context import butterfly_merge

    gen = torch.Generator().manual_seed(9)
    a = (torch.randn(3, 5, 7, generator=gen), torch.randn(3, 5, generator=gen) * 4)
    b = (torch.randn(3, 5, 7, generator=gen), torch.randn(3, 5, generator=gen) * 4)
    for step in (1, 2, 4):
        lo = butterfly_merge(a, b, 0, step)  # rank 0 holds a; its partner rank `step` holds b
        hi = butterfly_merge(b, a, step, step)
        for x, y in zip(lo, hi):
            assert torch.equal(x, y)
        for x, y in zip(lo, merge_pair(a, b)):
            assert torch.equal(x, y)


def test_engine_refuses_what_a_context_does_not_serve_yet():
    from repro_torch.configs import paper_llama
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.resilience import FaultInjector
    from repro_torch.serve import Engine, ServeConfig

    cfg = _tiny_cfg(paper_llama.CONFIG)
    params = tf.init_lm(cfg, device="cpu", seed=0)
    ctx = shd.ShardingCtx.__new__(shd.ShardingCtx)  # a context; no mesh is reached
    for kw, row in ((dict(kv_layout="paged"), "A13 d"), (dict(step_mode="mixed"), "A13 d"),
                    (dict(fault_rate=0.1), "A13 f")):
        with pytest.raises(NotImplementedError, match=row):
            Engine(params, cfg, ServeConfig(**kw), device="cpu", sharding_ctx=ctx)
    with pytest.raises(NotImplementedError, match="A13 f"):
        Engine(params, cfg, ServeConfig(), device="cpu", sharding_ctx=ctx,
               fault_injector=FaultInjector(0.1, 0))
    with pytest.raises(NotImplementedError, match="A13 e"):
        Engine(params, cfg, ServeConfig(), device="cpu", sharding_ctx=ctx, graphs=True)


if __name__ == "__main__":
    import torch.multiprocessing as mp

    work_dir, world = sys.argv[1], int(sys.argv[2])
    mp.spawn(_rank_main, args=(world, work_dir), nprocs=world)
