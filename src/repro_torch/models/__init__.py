"""Model facade: the port of `repro/models/__init__.py`, decoder only."""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import transformer as _tf
from repro_torch.models.config import ModelConfig


class ModelApi(NamedTuple):
    init: Callable  # (cfg, *, device, seed | generator) -> params
    apply: Callable  # (params, batch, cfg) -> (logits, aux)
    loss: Callable  # (params, batch, cfg) -> (loss, metrics)
    init_cache: Callable  # (batch, max_len, cfg, *, layout, page_size, n_pages, device) -> cache
    decode_step: Callable  # (params, cache, token, pos, cfg) -> (logits, cache)


def get_model(cfg: ModelConfig) -> ModelApi:
    _tf.check_ported(cfg)  # encoder-decoder and non-attention stacks: A12
    return ModelApi(
        init=_tf.init_lm,
        apply=_tf.apply_lm,
        loss=_tf.lm_loss,
        init_cache=_tf.init_decode_cache,
        decode_step=_tf.decode_step_lm,
    )


__all__ = ["ModelConfig", "ModelApi", "get_model"]
