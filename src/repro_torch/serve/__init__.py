"""Serving: the continuous-batching engine (port of `repro/serve`)."""

from repro_torch.runtime.resilience import EngineCrash, FaultInjector, InjectedFault
from repro_torch.serve.engine import Engine, ServeConfig, sample_token
from repro_torch.serve.scheduler import (
    DONE,
    EXPIRED,
    FAILED,
    TERMINAL,
    Request,
    Scheduler,
)

__all__ = ["Engine", "ServeConfig", "sample_token", "Request", "Scheduler",
           "DONE", "EXPIRED", "FAILED", "TERMINAL",
           "FaultInjector", "InjectedFault", "EngineCrash"]
