"""Move weights and configs between the JAX reference and the port.

The reference keeps parameters as a nested dict of arrays; `jax.tree.map(
np.asarray, params)` turns it into numpy, and `params_from_numpy` turns
that into the port's dict of tensors (and `params_to_numpy` back). numpy
has no bfloat16 that torch reads, so a bf16 leaf (ml_dtypes' bfloat16)
goes through float32 — exact, bf16 ⊂ f32 — and is cast back to bf16 on the
torch side; `params_to_numpy` returns bf16 leaves as float32.

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

__all__ = ["params_from_numpy", "params_to_numpy", "config_from_reference"]


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


def config_from_reference(cfg) -> ModelConfig:
    """The port's ModelConfig with the reference config's field values."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    impl = fields["attn_impl"]
    if impl.endswith("_pallas"):
        fields["attn_impl"] = impl[: -len("_pallas")] + "_gpu"
    return ModelConfig(**fields)
