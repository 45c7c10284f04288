"""The port's sharding rules engine (`repro_torch.distributed.sharding`)
against the reference's (`repro.distributed.sharding`), exactly, in one
process: the rules read shapes only, so both run on fake meshes of any
size (the reference's own tests build such contexts).

Covered: `param_specs` of all 11 configs at full size (meta tensors built
from the reference's `jax.eval_shape` tree) on four meshes with both FSDP
axes; `spec_for` of every kind over a grid of shapes with sequence
parallelism and tensor-parallel activations on and off, and the
reference's `test_activation_rules_fallbacks` cases; `batch_specs`;
`cache_specs_tree` of every config's decode cache; the context-parallel
selectors; `plan_mesh` for 1–512 devices; `placements()` of tuple
entries; `shard` on a plain tensor under a context.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.models import get_model as j_get_model
from repro.runtime import resilience as jres
from repro_torch.distributed import sharding as tshd
from repro_torch.runtime import resilience as tres
from repro_torch.tree import tree_flatten_with_names

MESHES = [{"pod": 2, "data": 16, "model": 16}, {"data": 16, "model": 16},
          {"data": 4, "model": 2}, {"data": 2, "model": 4}]
FSDP = ["data", ("pod", "data")]
KINDS_3D = ("residual", "hidden", "ff", "logits", "moe_groups")


class _FakeMesh:
    """What each package's ShardingCtx reads of a mesh: the reference's
    `axis_names` / `devices.shape`, the port's `mesh_dim_names` /
    `mesh.shape`."""

    def __init__(self, sizes):
        self.axis_names = self.mesh_dim_names = tuple(sizes)
        self.devices = self.mesh = np.empty(tuple(sizes.values()), dtype=object)


def _ctx_pair(sizes, fsdp="data", use_sp=True, tp=True):
    mesh = _FakeMesh(sizes)
    j, t = jshd.ShardingCtx(mesh, use_sp=use_sp, fsdp_axis=fsdp), \
        tshd.ShardingCtx(mesh, use_sp=use_sp, fsdp_axis=fsdp)
    j.tp_activations = t.tp_activations = tp
    return j, t


def _norm(spec):
    """A spec as a plain tuple, one-name tuples as the name (JAX's own
    normal form)."""
    if spec is None:
        return None
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in tuple(spec))


def _both(j, t, fn_j, fn_t):
    with jshd.activate(j):
        a = fn_j()
    with tshd.activate(t):
        b = fn_t()
    return a, b


def _shapes(arch):
    """The reference's full-size params as ShapeDtypeStructs, and the same
    tree as the port's meta tensors."""
    cfg = jconfigs.get_config(arch)
    api = j_get_model(cfg)
    shapes = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0), cfg))
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    return shapes, meta


def _named_j(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", p)) for p in path): _norm(s) for path, s in flat}


def _named_t(tree):
    return {n: _norm(s) for n, s in tree_flatten_with_names(tree)}


@pytest.mark.parametrize("arch", sorted(jconfigs._MODULES))
def test_param_specs_equal_the_reference(arch):
    shapes, meta = _shapes(arch)
    n = 0
    for sizes, fsdp in itertools.product(MESHES, FSDP):
        j, t = _ctx_pair(sizes, fsdp)
        a, b = _both(j, t, lambda: jshd.param_specs(shapes), lambda: tshd.param_specs(meta))
        a, b = _named_j(a), _named_t(b)
        assert a == b, (arch, sizes, fsdp)
        n += sum(any(e is not None for e in s) for s in b.values())
    assert n > 0  # something was sharded


def _shape_grid():
    bs, ss, hs = (1, 2, 6, 8, 32, 256), (1, 16, 100, 4096), (1, 2, 8, 12, 56, 64)
    for b, s, h in itertools.product(bs, ss, hs):
        yield "heads", (b, s, h, 128)
        yield "kv_cache", (b, s, h, 128)
        yield "moe_dispatch", (b, h, s, 64)
        yield "experts", (h, s, 64)
        for kind in KINDS_3D:
            yield kind, (b, s, h * 64)


@pytest.mark.parametrize("use_sp,tp", [(True, True), (False, True), (True, False),
                                       (False, False)])
def test_spec_for_every_kind_equals_the_reference(use_sp, tp):
    n = 0
    for sizes in MESHES:
        j, t = _ctx_pair(sizes, use_sp=use_sp, tp=tp)
        for kind, shape in _shape_grid():
            a, b = _both(j, t, lambda: jshd.spec_for(kind, shape),
                         lambda: tshd.spec_for(kind, shape))
            assert _norm(a) == _norm(b), (sizes, kind, shape)
            n += 1
    assert n > 1000
    assert tshd.spec_for("heads", (8, 16, 4, 32)) is None  # no ctx: no spec


def test_activation_rules_fallbacks_as_the_reference():
    """The reference's `test_activation_rules_fallbacks`, on a ctx built
    from axis sizes alone (`ShardingCtx.__new__`)."""
    ctx = tshd.ShardingCtx.__new__(tshd.ShardingCtx)
    ctx.mesh = None
    ctx.axis_sizes = {"data": 16, "model": 16}
    ctx.use_sp = True
    ctx.fsdp_axis = "data"
    ctx.has_pod = False
    with tshd.activate(ctx):
        assert tshd.spec_for("heads", (256, 4096, 32, 128)) == tshd.P(("data",), None, "model",
                                                                       None)
        s = tshd.spec_for("heads", (256, 4096, 56, 128))
        assert s == tshd.P(("data", "model"), None, None, None)
        s = tshd.spec_for("kv_cache", (1, 524288, 8, 128))
        assert s[1] == "data"
        assert tshd.cp_axis_for_cache((1, 524288, 8, 128)) is None  # mesh None: no CP
        assert tshd.param_specs({"w": torch.empty((64, 2048), device="meta")}) == {
            "w": tshd.P(None, "data")}


@pytest.mark.parametrize("arch", sorted(jconfigs._MODULES))
def test_batch_and_cache_specs_equal_the_reference(arch):
    cfg = jconfigs.get_config(arch)
    api = j_get_model(cfg)
    for (b, s), sizes in itertools.product(((1, 1024), (8, 512), (32, 256), (6, 64)), MESHES):
        caches = jax.eval_shape(lambda: api.init_cache(b, s, cfg))
        meta = jax.tree.map(lambda x: torch.empty(x.shape, device="meta"), caches)
        batch = {"tokens": np.zeros((b, s), np.int32), "labels": np.zeros((b, s), np.int32),
                 "frame_embeds": np.zeros((b, 8, 16), np.float32)}
        j, t = _ctx_pair(sizes)
        a, c = _both(j, t, lambda: jshd.cache_specs_tree(caches),
                     lambda: tshd.cache_specs_tree(meta))
        assert _named_j(a) == _named_t(c), (arch, b, s, sizes)
        a, c = _both(j, t, lambda: jshd.batch_specs(batch), lambda: tshd.batch_specs(batch))
        assert _named_j(a) == _named_t(c), (b, sizes)


def test_context_parallel_selectors_equal_the_reference():
    n = 0
    for sizes, use_cp in itertools.product(MESHES + [{"data": 8}], (True, False)):
        j, t = _ctx_pair(sizes)
        j.use_cp = t.use_cp = use_cp
        for b, s, h in itertools.product((1, 2, 4, 8, 32), (1, 16, 100, 4096), (1, 2, 8, 56)):
            shape = (b, s, h, 128)
            for fj, ft in ((jshd.cp_axis_for_cache, tshd.cp_axis_for_cache),
                           (jshd.cp_batch_axes_for_cache, tshd.cp_batch_axes_for_cache)):
                a, c = _both(j, t, lambda: fj(shape), lambda: ft(shape))
                assert a == c, (sizes, use_cp, shape, fj.__name__)
                n += a is not None
        for fj, ft in ((jshd.cp_axis_for_cache, tshd.cp_axis_for_cache),
                       (jshd.cp_batch_axes_for_cache, tshd.cp_batch_axes_for_cache)):
            assert _both(j, t, lambda: fj((2, 16, 8)), lambda: ft((2, 16, 8))) == (None, None)
    assert n > 0
    assert tshd.cp_axis_for_cache((1, 4096, 8, 128)) is None  # no ctx


def test_plan_mesh_equals_the_reference():
    for n in range(1, 513):
        a, b = jres.plan_mesh(n), tres.plan_mesh(n)
        assert (a.mesh_shape, a.axis_names) == (b.mesh_shape, b.axis_names), n
    assert tres.plan_mesh(4) == tres.ElasticPlan((1, 4), ("data", "model"))
    assert tres.plan_mesh(512).axis_names == ("pod", "data", "model")


class _NamesOnly:
    def __init__(self, *names):
        self.mesh_dim_names = names


def test_placements_of_tuple_entries():
    P = tshd.P
    mesh = _NamesOnly("pod", "data", "model")
    assert tshd.placements(P(("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0),
                                                                        Shard(2))
    assert tshd.placements(P(None, ("data",), None), mesh) == (Replicate(), Shard(1),
                                                               Replicate())
    assert tshd.placements(P(("data", "model"), None), _NamesOnly("data", "model")) == (
        Shard(0), Shard(0))
    assert tshd.placements(P(), _NamesOnly("data", "model")) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="order"):
        tshd.placements(P(("model", "data")), _NamesOnly("data", "model"))


def test_shard_is_the_identity_without_a_ctx_and_raises_on_a_plain_tensor_under_one():
    x = torch.zeros((8, 16, 64))
    assert tshd.shard(x, "residual") is x
    _, t = _ctx_pair({"data": 2, "model": 2})
    with tshd.activate(t):
        with pytest.raises(TypeError, match="plain tensor"):
            tshd.shard(x, "residual")
    assert tshd.active_ctx() is None


def test_make_mesh_needs_a_card_or_a_process_group(monkeypatch):
    """`cuda` (the default) without a card raises; nothing falls back to
    gloo or the CPU. On the CPU without a process group or the torchrun
    environment it raises too."""
    from repro_torch.devices import make_mesh

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), ("data", "model"))
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh((1, 1), ("data", "model"), device="cpu")


def test_the_active_ctx_is_seen_from_another_thread():
    """On the card the autograd engine runs the backward — and remat's
    recompute, which calls `shard` — on a thread of its own: the active
    context must be visible there, not thread-local."""
    import threading

    _, t = _ctx_pair({"data": 2, "model": 2})
    seen = []
    with tshd.activate(t):
        th = threading.Thread(target=lambda: seen.append(tshd.active_ctx()))
        th.start()
        th.join()
    assert seen == [t] and tshd.active_ctx() is None
