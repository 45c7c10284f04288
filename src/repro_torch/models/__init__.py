"""Model facade: the port of `repro/models/__init__.py` — one init / loss /
decode API over the decoder-only stacks and the encoder-decoder one."""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import encdec as _encdec
from repro_torch.models import transformer as _tf
from repro_torch.models.config import ModelConfig


class ModelApi(NamedTuple):
    init: Callable  # (cfg, *, device, seed | generator) -> params
    apply: Callable  # (params, batch, cfg) -> (logits, aux)
    loss: Callable  # (params, batch, cfg) -> (loss, metrics)
    init_cache: Callable  # (batch, max_len, cfg, *, layout, page_size, n_pages, kv_dtype, device)
    decode_step: Callable  # (params, cache, token, pos, cfg) -> (logits, cache)


def _encdec_cache(batch: int, max_len: int, cfg: ModelConfig, *, device=None, **_paged):
    """The enc-dec cache: self K/V of max_len positions, cross K/V capped at
    4096 frames (`fill_cross_cache` resizes them to the memory). The paged
    keyword arguments are taken and ignored, as the reference's: an
    encoder-decoder stack keeps the contiguous layout."""
    return _encdec.init_encdec_cache(batch, max_len, min(max_len, 4096), cfg, device=device)


def get_model(cfg: ModelConfig) -> ModelApi:
    _tf.check_ported(cfg)  # a layer kind or frontend outside the reference's
    if cfg.is_encdec:
        return ModelApi(
            init=_encdec.init_encdec,
            apply=_encdec.apply_encdec,
            loss=_encdec.encdec_loss,
            init_cache=_encdec_cache,
            decode_step=_encdec.decode_step_encdec,
        )
    return ModelApi(
        init=_tf.init_lm,
        apply=_tf.apply_lm,
        loss=_tf.lm_loss,
        init_cache=_tf.init_decode_cache,
        decode_step=_tf.decode_step_lm,
    )


__all__ = ["ModelConfig", "ModelApi", "get_model"]
