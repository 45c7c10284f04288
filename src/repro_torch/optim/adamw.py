"""AdamW with decoupled weight decay + global-norm clipping — the port of
`repro/optim/adamw.py`.

Optimizer state is a tree shaped like the parameters (m, v) plus a step
counter. Updates are functional, as the reference's: `apply_updates`
returns new trees and leaves its inputs alone, so the train step can
select the old state back when a step is skipped.

Sharded state (DTensor leaves, `distributed.sharding`): m and v take their
parameter's placements (FSDP shards the optimizer state for free, as in
the reference); `global_norm` is one norm over the whole tree, each
replicated leaf counted once, so the clip scale is the same on every rank;
the update is elementwise and runs on each leaf's local shard with the
same expressions, so its values are those of the unsharded update.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.distributed.sharding import is_dtensor, replicate_like
from repro_torch.models.config import _torch_dtype
from repro_torch.tree import tree_flatten_with_names, tree_leaves, tree_map, tree_unflatten_like

__all__ = ["AdamWConfig", "OptState", "init_opt", "apply_updates", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # names never decayed (norm scales, biases, per-channel gates)
    no_decay_keywords: tuple = ("norm", "bias", "lam", "A_log", "D", "dt_bias")


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor  # int32 scalar


def init_opt(params, state_dtype=None) -> OptState:
    """state_dtype='bfloat16' stores m/v at half width (the math stays f32)."""
    if state_dtype is None:
        zeros = lambda p: tree_map(torch.zeros_like, p)
    else:
        dt = _torch_dtype(state_dtype) if isinstance(state_dtype, str) else state_dtype
        zeros = lambda p: tree_map(lambda x: torch.zeros(x.shape, dtype=dt, device=x.device), p)
    dev = tree_leaves(params)[0].device
    return OptState(m=zeros(params), v=zeros(params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """√(Σ x²) over every leaf. DTensor leaves give a replicated DTensor
    scalar: each leaf's sum is reduced over its shards, and a replicated
    leaf counts once."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if is_dtensor(leaves[0]):
        leaves = [x.full_tensor() for x in leaves]
        return replicate_like(torch.sqrt(torch.sum(torch.stack(leaves))), tree_leaves(tree)[0])
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _local(x):
    """A DTensor's shard on this rank (a replicated scalar: its value); a
    plain tensor or number as it is."""
    return x.to_local() if is_dtensor(x) else x


def _decay_mask(params, cfg: AdamWConfig):
    flat = tree_flatten_with_names(params)
    mask = []
    for name, leaf in flat:
        nd = any(k in name for k in cfg.no_decay_keywords) or leaf.ndim <= 1
        mask.append(0.0 if nd else 1.0)
    return tree_unflatten_like(params, mask)


# elements of a leaf updated in one pass: the pass's f32 temporaries stay
# ~256 MB each whatever the leaf's size (recurrentgemma-9b's embedding and head
# are 1.05 B parameters: whole-leaf temporaries of 4.2 GB each)
UPDATE_CHUNK = 1 << 26


def apply_updates(
    params,
    grads,
    opt: OptState,
    cfg: AdamWConfig,
    lr: Optional[torch.Tensor] = None,
):
    """One AdamW step. Returns (new_params, new_opt, metrics).

    Leaf by leaf, UPDATE_CHUNK elements at a time: each element's clipped
    gradient, new moments and new parameter come from the reference's
    expressions in its order, so the values are those of whole-tree passes,
    while what lives at once is the old and new parameters and moments and
    the gradients (20 B a parameter with bf16 moments) — no clipped copy of
    every gradient, no whole-leaf temporaries."""
    lr = cfg.lr if lr is None else lr
    step = opt.step + 1

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    scale, b1c, b2c, lr_ = (_local(x) for x in (scale, b1c, b2c, lr))

    def update(p, g, m, v, d):
        if is_dtensor(p):  # the same update on this rank's shard of each leaf
            from torch.distributed.tensor import DTensor

            g = g.redistribute(p.device_mesh, p.placements)
            out = update(*(x.to_local() for x in (p, g, m, v)), d)
            return [DTensor.from_local(x, p.device_mesh, p.placements, run_check=False,
                                       shape=p.shape, stride=p.stride()) for x in out]
        out = [torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (p, m, v)]
        flat = [x.reshape(-1) for x in (p, g, m, v)]
        new_p, new_m, new_v = (x.view(-1) for x in out)
        for i in range(0, p.numel(), UPDATE_CHUNK):
            at = slice(i, i + UPDATE_CHUNK)
            p_, g_, m_, v_ = (x[at] for x in flat)
            g_ = g_.float() * scale
            # each last operation writes its chunk of the output, rounding
            # to the output's dtype as `.to` would: no temporary to copy
            torch.add(cfg.b1 * m_.float(), (1 - cfg.b1) * g_, out=new_m[at])
            torch.add(cfg.b2 * v_.float(), (1 - cfg.b2) * g_ * g_, out=new_v[at])
            mhat = new_m[at].float() / b1c
            vhat = new_v[at].float() / b2c
            step_ = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * d * p_.float()
            torch.sub(p_.float(), lr_ * step_, out=new_p[at])
        return out

    leaves = [update(*x) for x in zip(*(tree_leaves(t) for t in
                                        (params, grads, opt.m, opt.v, _decay_mask(params, cfg))))]
    new_params, new_m, new_v = (tree_unflatten_like(params, [x[i] for x in leaves])
                                for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": torch.as_tensor(lr, dtype=torch.float32,
                                                         device=gnorm.device)}
    return new_params, OptState(new_m, new_v, step), metrics
