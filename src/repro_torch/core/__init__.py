"""FLASH-D attention math and ops (PyTorch port of `repro/core`)."""

from repro_torch.core.attention import decode_attention, flash_attention
from repro_torch.core.blockwise import (
    DEFAULT_SKIP_THETA,
    NEG_INF,
    MaskSpec,
    blockwise_flashd,
    merge_pair,
    merge_partials,
    tile_live,
)

__all__ = [
    "DEFAULT_SKIP_THETA", "NEG_INF", "MaskSpec", "blockwise_flashd", "merge_pair",
    "merge_partials", "tile_live", "flash_attention", "decode_attention",
]
