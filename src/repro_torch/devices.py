"""Device selection for the port's entry points.

`Engine`, `init_lm`, `init_decode_cache` and `launch.serve` run on the
card unless the caller asks for the CPU: with no CUDA device and no
explicit `device="cpu"` they raise instead of quietly running elsewhere.
`make_mesh` builds the multi-device layer's `DeviceMesh` the same way: NCCL
on the card, gloo only when the CPU is asked for.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import torch

__all__ = ["resolve_device", "make_mesh"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device`, defaulting to "cuda"; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def make_mesh(shape: Sequence[int], names: Sequence[str], *, device=None):
    """A `DeviceMesh` of `shape` with `mesh_dim_names` `names` over the
    default process group, on `device` (default the card).

    With no process group yet, one is started from the torchrun
    environment (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT; without it
    this raises): NCCL for `cuda`, gloo for `cpu`. On
    `cuda` the process binds LOCAL_RANK's card first. `cuda` without a card
    or without NCCL raises; nothing falls back to gloo or the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no mesh on {dev.type}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a mesh on cuda needs NCCL, which this torch lacks")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        if "MASTER_ADDR" not in os.environ:
            raise RuntimeError("no process group: run under torchrun, or call "
                               "torch.distributed.init_process_group first")
        dist.init_process_group(backend)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}; a mesh on "
                           f"{dev.type} needs {backend}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))
