"""Runtime of the port: the paged KV allocator (a copy of
`repro/runtime/kvcache.py`), checkpoints in the reference's format and the
training fault-tolerance supervisor (`checkpoint`, `resilience`)."""

from repro_torch.runtime import checkpoint
from repro_torch.runtime.kvcache import (
    CachePolicy,
    CowCopy,
    PagedKVAllocator,
    PageError,
    PrefixMatch,
    pages_for,
)
from repro_torch.runtime.resilience import StragglerMonitor, run_resilient

__all__ = [
    "checkpoint", "CachePolicy", "CowCopy", "PagedKVAllocator", "PageError", "PrefixMatch",
    "pages_for", "StragglerMonitor", "run_resilient",
]
