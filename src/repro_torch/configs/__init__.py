"""Config registry: --arch <id> resolves here. The port carries copies of
the reference's config data for the architectures this slice runs; the
others raise "not ported" (A12)."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
    "paper-llama": "paper_llama",
}
# the reference's other architectures, queued for A12
_NOT_PORTED = (
    "deepseek-7b", "qwen2-1.5b", "yi-34b", "mamba2-2.7b", "phi-3-vision-4.2b",
    "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "seamless-m4t-medium",
    "recurrentgemma-9b",
)


def _module(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} not ported yet (A12); have {sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["get_config", "get_smoke_config", "ModelConfig"]
