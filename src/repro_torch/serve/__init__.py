"""Serving: the contiguous continuous-batching engine (port of `repro/serve`)."""

from repro_torch.serve.engine import Engine, ServeConfig, sample_token
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["Engine", "ServeConfig", "sample_token", "Request", "Scheduler"]
