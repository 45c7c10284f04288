"""Multi-device layer of the port (`repro/distributed`): the sharding rules
engine on a torch `DeviceMesh` / DTensor. Context parallelism and the
pipeline are not ported yet."""

from repro_torch.distributed import sharding

__all__ = ["sharding"]
