"""Sharding rules engine: logical axes → mesh axes, with divisibility guards
— the port of `repro/distributed/sharding.py` onto a torch `DeviceMesh`
and DTensor.

Strategy (DESIGN.md §4), rule for rule the reference's:
  batch               → ('pod', 'data')      data parallel across pods
  seq (residual SP)   → 'model'              Megatron-style sequence parallel
  heads / ff / vocab  → 'model'              tensor parallel
  experts             → 'model'              expert parallel
  fsdp (param in-dim) → 'data'               ZeRO-3 within a pod

Every rule is divisibility-checked against the active mesh; non-divisible
dims fall back to replication. Models call `shard(x, kind)` at activation
boundaries: with no active context it is the identity (single-device runs
never see a DTensor); under one it redistributes a DTensor to
`spec_for(kind, x.shape)` and raises on a plain tensor, so a step never
runs half sharded unseen.

A spec is a `P`: one entry per tensor dim — None, a mesh axis name, or a
tuple of names that shard that dim over several mesh dims, major to minor
(as in JAX). `placements(spec, mesh)` turns it into one `Shard(dim)` /
`Replicate()` per mesh dim; `distribute_tree(tree, specs)` places a tree of
tensors on the active mesh (the reference's `jax.device_put(tree,
to_named(specs))`).

The reference's `mesh_ctx` and `sharded_jit` are shims over jax versions'
ambient-mesh and jit APIs; eager DTensor has neither, so they have no
counterpart. `sharded(fn, in_specs)` takes `sharded_jit`'s place: it
distributes a step's inputs to their specs and runs `fn` under
`activate(ctx)`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch

__all__ = [
    "P",
    "ShardingCtx",
    "activate",
    "active_ctx",
    "shard",
    "spec_for",
    "param_specs",
    "batch_specs",
    "cache_specs_tree",
    "cp_axis_for_cache",
    "cp_batch_axes_for_cache",
    "placements",
    "distribute_tree",
    "replicate_like",
    "sharded",
    "is_dtensor",
]

# The active context is process-wide, not thread-local as the reference's:
# the autograd engine runs a CUDA backward — and with it remat's recompute,
# which calls `shard` again — on a thread of its own per device.
_ACTIVE: list = [None]


class P(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name, or a
    tuple of axis names). A leaf of the port's trees (`tree.tree_map`)."""

    is_tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class ShardingCtx:
    def __init__(self, mesh, *, use_sp: bool = True, fsdp_axis="data",
                 use_cp: bool = True, cp_prefill: bool = False):
        """mesh: a `DeviceMesh` with `mesh_dim_names`. fsdp_axis: 'data'
        (params replicate across pods) or ('pod', 'data') (ZeRO across
        pods too). use_cp / cp_prefill: the reference's context-parallel
        switches, read by `cp_axis_for_cache` (the CP routes themselves
        come with context parallelism)."""
        self.mesh = mesh
        self.axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        self.use_sp = use_sp
        if isinstance(fsdp_axis, str):
            fsdp_axis = (fsdp_axis,)
        fsdp_axis = tuple(a for a in (fsdp_axis or ()) if a in self.axis_sizes)
        self.fsdp_axis = fsdp_axis or None
        self.has_pod = "pod" in self.axis_sizes
        # constrain mixer / FFN outputs to the seq-sharded residual spec (the
        # row-parallel products' reduce-scatter placement)
        self.rs_outputs = True
        # tensor-parallel activations; False keeps them full-DP
        self.tp_activations = True
        self.use_cp = use_cp
        self.cp_prefill = cp_prefill

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return ("pod", "data") if self.has_pod else ("data",)

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            return self.axis_sizes.get(axes, 1)
        return int(math.prod(self.axis_sizes.get(a, 1) for a in axes))


def active_ctx() -> Optional[ShardingCtx]:
    return _ACTIVE[0]


@contextlib.contextmanager
def activate(ctx: Optional[ShardingCtx]):
    prev = _ACTIVE[0]
    _ACTIVE[0] = ctx
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def _fit(ctx: ShardingCtx, dim_size: int, axes):
    """Return axes if dim_size divides by their product, else None.

    Axes absent from the active mesh never shard: their size defaults to 1
    (always divides), but naming them in a spec would be a mesh-resolution
    error."""
    if axes is None:
        return None
    if isinstance(axes, str):
        if axes not in ctx.axis_sizes:
            return None
        return axes if dim_size % ctx.axis_size(axes) == 0 else None
    axes = tuple(a for a in axes if a in ctx.axis_sizes)
    if not axes:
        return None
    if dim_size % ctx.axis_size(axes) == 0:
        return axes
    # try a prefix (e.g. ('pod','data') → ('pod',)) before giving up
    for cut in range(len(axes) - 1, 0, -1):
        sub = axes[:cut]
        if dim_size % ctx.axis_size(sub) == 0:
            return sub
    return None


def _heads_spec(c: ShardingCtx, s):
    """[B, S, H, hd] attention activations: heads over 'model', or, when the
    head count does not divide it, full-DP attention — batch over as many
    mesh axes as divide it, the remaining axes onto the sequence dim."""
    b = _fit(c, s[0], c.batch_axes)
    h = _fit(c, s[2], "model")
    if h is not None:
        return P(b, None, h, None)
    axes_all = c.batch_axes + ("model",)
    b2 = _fit(c, s[0], axes_all)
    used = set(b2) if isinstance(b2, tuple) else ({b2} if b2 else set())
    rest = tuple(a for a in axes_all if a not in used)
    sspec = _fit(c, s[1], rest) if rest else None
    return P(b2, sspec, None, None)


# activation kinds → per-dim logical roles
_ACT_RULES = {
    # [B, S, D] residual stream between layers (SP shards S over model)
    "residual": lambda c, s: P(_fit(c, s[0], c.batch_axes), _fit(c, s[1], "model") if c.use_sp else None, None),
    # [B, S, D] inside a block (seq gathered for attention/mixing)
    "hidden": lambda c, s: P(_fit(c, s[0], c.batch_axes), None, None),
    # [B, S, H, hd] attention activations — heads over model
    "heads": _heads_spec,
    # [B, S, F] ffn hidden — ff over model
    "ff": lambda c, s: P(_fit(c, s[0], c.batch_axes), None, _fit(c, s[2], "model")),
    # [B, S, V] logits — vocab over model
    "logits": lambda c, s: P(_fit(c, s[0], c.batch_axes), None, _fit(c, s[2], "model")),
    # [E, C, D] expert dispatch buffers — experts over model
    "experts": lambda c, s: P(_fit(c, s[0], "model"), None, None),
    # [G, t, D] MoE token groups — groups over the batch axes
    "moe_groups": lambda c, s: P(_fit(c, s[0], c.batch_axes), None, None),
    # [G, E, C, D] group-local dispatch buffers — G over batch, E over model
    "moe_dispatch": lambda c, s: P(
        _fit(c, s[0], c.batch_axes), _fit(c, s[1], "model"), None, None
    ),
    # KV cache [B, S, H, hd]: batch if divisible, else seq (context parallel)
    "kv_cache": lambda c, s: _kv_cache_spec(c, s),
}


def _kv_cache_spec(c: ShardingCtx, s):
    b_axes = _fit(c, s[0], c.batch_axes)
    h = _fit(c, s[2], "model")
    if b_axes is not None:
        if h is not None:
            return P(b_axes, None, h, None)
        # heads don't divide TP: context-parallel the cache sequence over 'model'
        return P(b_axes, _fit(c, s[1], "model"), None, None)
    # batch too small (long-context, B=1): context-parallel over 'data'
    return P(None, _fit(c, s[1], "data"), h, None)


def cp_axis_for_cache(shape) -> Optional[str]:
    """Mesh axis the kv_cache rule puts on the SEQUENCE dim of a
    [B, S, H, hd] cache (context parallelism), or None."""
    ctx = active_ctx()
    if ctx is None or ctx.mesh is None or not getattr(ctx, "use_cp", True):
        return None
    if len(shape) != 4:
        return None
    spec = _kv_cache_spec(ctx, tuple(shape))
    ax = spec[1] if len(spec) > 1 else None
    if isinstance(ax, tuple):
        ax = ax[0] if len(ax) == 1 else None
    if ax is None:
        return None
    n = ctx.axis_size(ax)
    return ax if n > 1 and shape[1] % n == 0 else None


def cp_batch_axes_for_cache(shape) -> Optional[Tuple[str, ...]]:
    """Mesh axes the kv_cache rule puts on the BATCH dim of a [B, S, H, hd]
    cache."""
    ctx = active_ctx()
    if ctx is None or ctx.mesh is None or len(shape) != 4:
        return None
    ax = _kv_cache_spec(ctx, tuple(shape))[0]
    if ax is None:
        return None
    return (ax,) if isinstance(ax, str) else tuple(ax)


_TP_KINDS = ("ff", "heads", "logits", "experts", "moe_dispatch")


def spec_for(kind: str, shape: Sequence[int]) -> Optional[P]:
    ctx = active_ctx()
    if ctx is None:
        return None
    if not getattr(ctx, "tp_activations", True) and kind in _TP_KINDS:
        # full-DP activations: batch over every axis that divides
        b = _fit(ctx, shape[0], ctx.batch_axes + ("model",))
        return P(b, *([None] * (len(shape) - 1)))
    return _ACT_RULES[kind](ctx, tuple(shape))


# ---------------------------------------------------------------------------
# specs → DTensor placements
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def placements(spec: Sequence, mesh) -> tuple:
    """One placement per mesh dim: `Shard(d)` where tensor dim d names that
    mesh dim, `Replicate()` elsewhere. A tuple entry shards its dim over
    its mesh dims major to minor (listed order), as JAX does; DTensor
    shards a dim held by several mesh dims in mesh-dim order, so the names
    of a tuple entry must follow the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def shard(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Apply a logical sharding constraint; identity with no active ctx.
    Under a ctx the input must be a DTensor: a plain tensor raises."""
    spec = spec_for(kind, x.shape)
    if spec is None:
        return x
    if not is_dtensor(x):
        raise TypeError(f"shard({kind!r}) under an active sharding context got a plain "
                        f"tensor of shape {tuple(x.shape)}: distribute the step's inputs "
                        f"(param_specs / batch_specs) before running it")
    want = placements(spec, x.device_mesh)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def vocab_island(fn, x, dim: int, ids):
    """`fn(x_local, ids_local, first, rows)` on each rank's shard of DTensor
    `x` split along `dim` (a vocab dim) with the int DTensor `ids` [B, S],
    whole over the mesh dims that split `dim`; `first` and `rows` are this
    rank's vocab range. `fn` returns [B, S, ...] with zeros for ids outside
    its range, so the result is a partial sum over those mesh dims, here
    reduced. DTensor's own masked lookups (embedding, gather) are not used:
    torch 2.11 reduces their partial sums with a stale mask once the batch
    is regathered (an IndexError on a (2, 2) mesh of four H100s)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    vocab = [p == Shard(dim) for p in x.placements]
    if not any(vocab):
        raise ValueError(f"dim {dim} of x is not sharded: {x.placements}")
    ids_pl = tuple(Replicate() if v else p for v, p in zip(vocab, ids.placements))
    # off the vocab dims x is whole (an FSDP shard of an embedding's width
    # gathered), or split along the batch with the ids (logits)
    x_pl = tuple(Shard(dim) if v else (Shard(0) if dim and p == i == Shard(0) else Replicate())
                 for v, p, i in zip(vocab, x.placements, ids_pl))
    part_pl = tuple(Partial() if v else p for v, p in zip(vocab, ids_pl))
    # x's gradient: exact on its vocab rows and batch shards; partial sums
    # where x is whole beside a split batch
    grad_pl = tuple(Partial() if p.is_replicate() and i.is_shard() else p
                    for p, i in zip(x_pl, ids_pl))
    coord = mesh.get_coordinate()
    first, rows = 0, x.shape[dim]
    for i, v in enumerate(vocab):  # DTensor splits a dim over its mesh dims in order
        if v:
            rows //= mesh.size(i)
            first += coord[i] * rows
    out = local_map(lambda x_, i_: fn(x_, i_, first, rows), out_placements=(part_pl,),
                    in_placements=(x_pl, ids_pl), in_grad_placements=(grad_pl, ids_pl),
                    device_mesh=mesh, redistribute_inputs=True)(x, ids)
    return out.redistribute(mesh, tuple(Replicate() if v else p for v, p in zip(vocab, ids_pl)))


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A constant built inside a step (positions, masks, rope tables) as a
    replicated DTensor on `like`'s mesh when `like` is a DTensor; else `t`."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


# ---------------------------------------------------------------------------
# Parameter sharding: path-name driven rules
# ---------------------------------------------------------------------------

def _param_rule(ctx: ShardingCtx, path: str, shape: Tuple[int, ...]) -> P:
    """TP dim from the weight's role; FSDP on the largest remaining dim."""
    fsdp = ctx.fsdp_axis
    nd = len(shape)
    tp_dim = None  # which dim gets 'model'

    def last(*names):
        return any(path.endswith(n) or f".{n}." in path or f"/{n}" in path for n in names)

    # embeddings / lm head: vocab over model
    if last("embed", "lm_head"):
        tp_dim = 0 if shape[0] > shape[-1] else nd - 1
    # column-parallel (out-dim sharded): q/k/v/gate/up, moe wi, router
    elif last("wq", "wk", "wv", "wg", "wu", "w_in", "w_gate"):
        tp_dim = nd - 1
    # row-parallel (in-dim sharded): output projections / down proj
    elif last("wo", "wd", "w_out"):
        tp_dim = nd - 2 if nd >= 2 else None
    elif last("router"):
        tp_dim = None  # small; replicate
    # moe expert stacks [E, d, f]: shard E over model
    if last("experts") and nd == 3:
        tp_dim = 0

    spec = [None] * nd
    if tp_dim is not None and nd >= 1 and "model" in ctx.axis_sizes:
        if shape[tp_dim] % ctx.axis_size("model") == 0:
            spec[tp_dim] = "model"
    # FSDP: biggest dim not already sharded (params ≥ 2 dims, skip tiny)
    if fsdp and nd >= 2 and int(math.prod(shape)) >= 2 ** 16:
        cands = sorted(range(nd), key=lambda i: -shape[i])
        for i in cands:
            if spec[i] is None and shape[i] % ctx.axis_size(fsdp) == 0:
                spec[i] = fsdp
                break
    return P(*spec)


def param_specs(params_shapes):
    """P tree for a params(-shaped) tree (leaves with `.shape`). Requires
    an active ctx. Stacked `blocks` / `enc_blocks` / `dec_blocks` leaves
    get a leading None and the rule on the rest."""
    from repro_torch.tree import tree_flatten_with_names, tree_unflatten_like

    ctx = active_ctx()
    if ctx is None:
        raise RuntimeError("param_specs needs an active sharding context")
    specs = []
    for name, leaf in tree_flatten_with_names(params_shapes):
        shape = tuple(leaf.shape)
        if (name.startswith("blocks") or "/blocks/" in name or name.startswith("enc_blocks")
                or name.startswith("dec_blocks")):
            specs.append(P(None, *_param_rule(ctx, name, shape[1:])))
        else:
            specs.append(_param_rule(ctx, name, shape))
    return tree_unflatten_like(params_shapes, specs)


# ---------------------------------------------------------------------------
# batch / decode-cache sharding
# ---------------------------------------------------------------------------

def batch_specs(batch_shapes):
    """Inputs [B, ...]: batch over ('pod','data') when divisible."""
    from repro_torch.tree import tree_map

    ctx = active_ctx()

    def rule(leaf):
        b = _fit(ctx, leaf.shape[0], ctx.batch_axes)
        return P(b, *([None] * (len(leaf.shape) - 1)))

    return tree_map(rule, batch_shapes)


def cache_specs_tree(cache_shapes):
    """Decode caches: leading [n_blocks] unsharded; KV [nb,B,S,H,hd] shards
    batch (or seq when B=1 — context parallel) + heads; recurrent states
    [nb,B,...] shard batch."""
    from repro_torch.tree import tree_map

    ctx = active_ctx()

    def rule(leaf):
        s = leaf.shape
        if len(s) == 5:  # [nb, B, S, H, hd] attention KV
            return P(None, *_kv_cache_spec(ctx, s[1:]))
        if len(s) >= 2:  # recurrent state [nb, B, ...]
            b = _fit(ctx, s[1], ctx.batch_axes)
            return P(None, b, *([None] * (len(s) - 2)))
        return P(*([None] * len(s)))

    return tree_map(rule, cache_shapes)


def distribute_tree(tree, specs, mesh=None):
    """Place every tensor leaf of `tree` on the mesh (default: the active
    ctx's) with the matching P leaf of `specs` (a tree of the same
    structure). A leaf that is already a DTensor is redistributed; a plain
    leaf is taken as the whole tensor, the same on every rank (seeded data,
    a restored checkpoint)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.tree import tree_map

    if mesh is None:
        ctx = active_ctx()
        if ctx is None:
            raise RuntimeError("distribute_tree needs a mesh or an active sharding context")
        mesh = ctx.mesh

    def place(x, spec):
        pl = placements(spec, mesh)
        if is_dtensor(x):
            return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
        return distribute_tensor(x.detach().to(mesh.device_type), mesh, pl)

    return tree_map(place, tree, specs)


def sharded(fn, in_specs, ctx: Optional[ShardingCtx] = None):
    """`fn` with its positional inputs distributed to `in_specs` (one spec
    tree per input; None leaves the input as it is) and run under
    `activate(ctx)` (default: the ctx active when this is called) — what
    the reference's `sharded_jit(fn, in_shardings=...)` does under jit."""
    ctx = ctx if ctx is not None else active_ctx()
    if ctx is None:
        raise RuntimeError("sharded() needs a sharding context")

    def run(*args):
        args = [a if s is None else distribute_tree(a, s, ctx.mesh)
                for a, s in zip(args, in_specs)]
        with activate(ctx):
            return fn(*args)

    return run
