"""Config registry: --arch <id> resolves here. The port carries copies of
the reference's config data for all of its architectures (dense GQA, MoE
with chunked attention, RG-LRU with local attention, the Mamba-2 SSM, the
vision stub, the encoder-decoder stack with the audio stub)."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "deepseek-7b": "deepseek_7b",
    "qwen2-1.5b": "qwen2_1_5b",
    "yi-34b": "yi_34b",
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-2.7b": "mamba2_2_7b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "paper-llama": "paper_llama",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


ARCHS = tuple(sorted(_MODULES))  # the architectures the port runs


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ARCHS", "get_config", "get_smoke_config", "ModelConfig"]
