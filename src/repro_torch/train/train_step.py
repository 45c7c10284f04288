"""Training step: loss → grads → numerics guard → AdamW — the port of
`repro/train/train_step.py`.

`make_train_step(model_cfg, train_cfg)` returns `train_step(state, batch)
-> (state, metrics)`, a function of a `TrainState` and a batch of tensors
that leaves its inputs untouched (as the reference's jitted step). Attention
inside the loss runs through `core.attention.flash_attention`, whose
autograd Function routes the kernel impls to K1/K6 forward and K5 backward;
nothing [S, S]-sized is saved. Microbatches (`accum_steps > 1`) run one
after another, their f32 gradients summed into one accumulator.

Numerics guard (`numerics_guard=True`, the default): the loss is scaled by
the carried `loss_scale` before differentiation, gradients are unscaled
(power-of-two scales: exact), and one fused all-leaves-finite check gates
the update on the device — a non-finite step selects the old params and
optimizer state back leaf by leaf (`torch.where`, no host sync), bumps
`skipped` and halves the scale; after `loss_scale_growth_interval`
consecutive finite steps the scale doubles. The step never syncs the host:
its metrics stay tensors, and the caller reads them once (the reference's
`float(metrics["loss"])`).

Gradient compression (`compression != "none"`) waits for the multi-device
slice (A13) and raises here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import ModelConfig, get_model
from repro_torch.optim import AdamWConfig, OptState, apply_updates, init_opt, warmup_cosine
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

__all__ = ["TrainConfig", "TrainState", "init_train_state", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    compression: str = "none"  # int8 / topk: multi-device slice (A13)
    warmup_steps: int = 100
    total_steps: int = 10000
    accum_steps: int = 1  # microbatch gradient accumulation
    opt_state_dtype: str = "float32"  # 'bfloat16' halves Adam m/v memory
    # cast ≥2-D f32 masters to the compute dtype once at step start (numerics
    # identical: the model casts at use regardless)
    cast_params_once: bool = False
    # differentiate w.r.t. the compute-dtype cast tree, so the gradients of
    # ≥2-D leaves are bf16; the f32 masters get the upcast copy
    grad_dtype: str = "float32"  # or 'bfloat16'
    numerics_guard: bool = True
    loss_scale_init: float = 1.0
    loss_scale_growth_interval: int = 0  # 0 → static scale
    loss_scale_min: float = 2.0 ** -14
    loss_scale_max: float = 2.0 ** 16

    def __post_init__(self):
        if self.compression != "none":
            raise NotImplementedError(f"gradient compression {self.compression!r} is not "
                                      "ported yet (multi-device slice, A13)")


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    residual: Optional[dict]  # error-feedback state of compression: always None here
    step: torch.Tensor  # int32
    loss_scale: torch.Tensor  # f32 dynamic loss scale (numerics guard)
    good_steps: torch.Tensor  # int32 consecutive finite steps since the last growth
    skipped: torch.Tensor  # int32 total non-finite updates skipped


def init_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig, *, device=None,
                     seed: int = 0, params: Optional[dict] = None) -> TrainState:
    """Fresh state: `params` as given (e.g. the reference's tree through the
    bridge) or the model's init (`init_lm`, or `init_encdec` for an
    encoder-decoder stack) drawn from a torch.Generator seeded with `seed`
    on `device` (default the card)."""
    if params is None:
        params = get_model(model_cfg).init(model_cfg, device=device, seed=seed)
    dev = tree_leaves(params)[0].device
    dt = None if train_cfg.opt_state_dtype == "float32" else train_cfg.opt_state_dtype

    def scalar(x, dtype):
        return torch.tensor(x, dtype=dtype, device=dev)

    return TrainState(
        params, init_opt(params, state_dtype=dt), None, scalar(0, torch.int32),
        scalar(train_cfg.loss_scale_init, torch.float32), scalar(0, torch.int32),
        scalar(0, torch.int32),
    )


def _cast_params(params, cdt: torch.dtype):
    """≥2-D f32 masters in the compute dtype; 1-D leaves (norm scales) stay f32."""
    return tree_map(lambda p: p.to(cdt) if p.ndim >= 2 and p.dtype == torch.float32 else p,
                    params)


def _select_tree(pred, new, old):
    """Leafwise `pred ? new : old` — the guard's skip-update selection."""
    return tree_map(lambda a, b: torch.where(pred, a, b), new, old)


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics)."""
    api = get_model(model_cfg)
    cdt = model_cfg.compute_dtype
    bf16_grads = train_cfg.grad_dtype == "bfloat16"
    if train_cfg.grad_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"grad_dtype {train_cfg.grad_dtype!r} (float32, bfloat16)")
    guard = train_cfg.numerics_guard

    def grads_of(params, batch, scale):
        """(scaled loss, metrics), grads of the SCALED loss (grad_dtype)."""
        with torch.enable_grad():
            src = _cast_params(params, cdt) if bf16_grads else params
            wrt = tree_map(lambda p: p.detach().requires_grad_(), src)
            cast_once = train_cfg.cast_params_once and not bf16_grads
            used = _cast_params(wrt, cdt) if cast_once else wrt
            loss, metrics = api.loss(used, batch, model_cfg)
            loss = loss * scale
            leaves = tree_leaves(wrt)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        metrics = {k: torch.as_tensor(v, dtype=torch.float32, device=loss.device).detach()
                   for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten_like(params, grads)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        scale = state.loss_scale if guard else torch.ones_like(state.loss_scale)
        n = train_cfg.accum_steps
        if n > 1:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state.params)
            loss, metrics = 0.0, None
            for i in range(n):
                mb = {k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]
                      for k, x in batch.items()}
                l_i, m_i, g_i = grads_of(state.params, mb, scale)
                grads = tree_map(torch.add, grads, g_i)  # f32 accumulator
                loss = loss + l_i
                metrics = m_i if metrics is None else {k: metrics[k] + m_i[k] for k in m_i}
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
            metrics = {k: m / n for k, m in metrics.items()}
        else:
            loss, metrics, grads = grads_of(state.params, batch, scale)

        # unscale (exact: power-of-two scales); Inf/NaN survive the divide
        inv = 1.0 / scale
        grads = tree_map(lambda g: g * inv.to(g.dtype), grads)
        loss = loss * inv
        finite = torch.stack([torch.isfinite(loss)]
                             + [torch.isfinite(g).all() for g in tree_leaves(grads)]).all()

        lr = warmup_cosine(state.step, peak_lr=train_cfg.optimizer.lr,
                           warmup_steps=train_cfg.warmup_steps,
                           total_steps=train_cfg.total_steps)
        params, opt, opt_metrics = apply_updates(state.params, grads, state.opt,
                                                 train_cfg.optimizer, lr=lr)
        if guard:
            params = _select_tree(finite, params, state.params)
            opt = _select_tree(finite, opt, state.opt)
            good = torch.where(finite, state.good_steps + 1, 0).to(torch.int32)
            interval = train_cfg.loss_scale_growth_interval
            if interval > 0:
                ripe = finite & (good >= interval)
                # grow only while doubling stays ≤ max (halving is the only way down)
                grow = ripe & (scale * 2.0 <= train_cfg.loss_scale_max)
                scale_ok = torch.where(grow, scale * 2.0, scale)
                good = torch.where(ripe, 0, good).to(torch.int32)
            else:
                scale_ok = scale
            new_scale = torch.where(finite, scale_ok,
                                    torch.clamp(scale * 0.5, min=train_cfg.loss_scale_min))
            skipped = state.skipped + torch.where(finite, 0, 1).to(torch.int32)
        else:
            good, new_scale, skipped = state.good_steps, state.loss_scale, state.skipped
        new_state = TrainState(params, opt, state.residual, state.step + 1, new_scale, good,
                               skipped)
        guard_metrics = {"loss_scale": scale, "skipped": skipped.float(),
                         "finite": finite.float()}
        return new_state, {"loss": loss, **metrics, **opt_metrics, **guard_metrics}

    return train_step
