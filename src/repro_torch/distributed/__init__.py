"""Multi-device layer of the port (`repro/distributed`): the sharding rules
engine on a torch `DeviceMesh` / DTensor, and context parallelism (ring
prefill and the cross-rank decode merge over `torch.distributed`). The
pipeline is not ported yet."""

from repro_torch.distributed import context, sharding
from repro_torch.distributed.context import cp_decode, ring_prefill

__all__ = ["context", "sharding", "cp_decode", "ring_prefill"]
