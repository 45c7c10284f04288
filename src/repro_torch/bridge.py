"""Move weights and configs between the JAX reference and the port.

The reference keeps parameters as a nested dict of arrays (a decoder's
`blocks/pos{j}/...`, an encoder-decoder's `enc_blocks` / `dec_blocks`);
`jax.tree.map(np.asarray, params)` turns it into numpy, and
`params_from_numpy` turns that into the port's dict of tensors (and
`params_to_numpy` back), whatever the nesting. numpy
has no bfloat16 that torch reads, so a bf16 leaf (ml_dtypes' bfloat16)
goes through float32 — exact, bf16 ⊂ f32 — and is cast back to bf16 on the
torch side; `params_to_numpy` returns bf16 leaves as float32.

`train_state_from_numpy` / `train_state_to_numpy` do the same for a whole
training state: the reference's `TrainState` (params, `OptState(m, v,
step)`, residual, step, loss_scale, good_steps, skipped) with numpy leaves
becomes the port's `TrainState`, read by field name.

`config_from_reference` copies a reference `ModelConfig` field by field into
the port's, mapping the Pallas impl names onto the CUDA ones
('flashd_pallas' → 'flashd_gpu'). Nothing here imports the reference: it
reads the object it is given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

__all__ = [
    "params_from_numpy",
    "params_to_numpy",
    "train_state_from_numpy",
    "train_state_to_numpy",
    "config_from_reference",
]


def params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays → nested dict of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)  # writable, owned


def params_to_numpy(tree):
    """Nested dict of tensors → nested dict of numpy arrays (bf16 → f32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def train_state_from_numpy(state, device="cpu"):
    """A reference `TrainState` with numpy leaves (`jax.tree.map(np.asarray,
    state)`) → the port's `TrainState` on `device`."""
    from repro_torch.optim import OptState
    from repro_torch.train.train_step import TrainState

    if state.residual is not None:
        raise NotImplementedError("gradient-compression residuals are not ported (A13)")
    scalar = lambda x: torch.as_tensor(np.asarray(x)).to(device)
    opt = state.opt
    return TrainState(
        params=params_from_numpy(state.params, device),
        opt=OptState(params_from_numpy(opt.m, device), params_from_numpy(opt.v, device),
                     scalar(opt.step)),
        residual=None, step=scalar(state.step), loss_scale=scalar(state.loss_scale),
        good_steps=scalar(state.good_steps), skipped=scalar(state.skipped),
    )


def train_state_to_numpy(state):
    """The port's `TrainState` → the same NamedTuples with numpy leaves
    (bf16 → f32), whose fields the reference's `TrainState` / `OptState`
    take as they are."""
    scalar = lambda t: t.detach().cpu().numpy()
    opt = state.opt
    return type(state)(
        params=params_to_numpy(state.params),
        opt=type(opt)(params_to_numpy(opt.m), params_to_numpy(opt.v), scalar(opt.step)),
        residual=None, step=scalar(state.step), loss_scale=scalar(state.loss_scale),
        good_steps=scalar(state.good_steps), skipped=scalar(state.skipped),
    )


def config_from_reference(cfg) -> ModelConfig:
    """The port's ModelConfig with the reference config's field values."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    impl = fields["attn_impl"]
    if impl.endswith("_pallas"):
        fields["attn_impl"] = impl[: -len("_pallas")] + "_gpu"
    return ModelConfig(**fields)
