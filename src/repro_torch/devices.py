"""Device selection for the port's entry points.

`Engine`, `init_lm`, `init_decode_cache` and `launch.serve` run on the
card unless the caller asks for the CPU: with no CUDA device and no
explicit `device="cpu"` they raise instead of quietly running elsewhere.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device`, defaulting to "cuda"; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
