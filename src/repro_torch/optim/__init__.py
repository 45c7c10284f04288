"""Optimizer of the port: AdamW and its LR schedule (`repro/optim`).
Gradient compression (`optim/compress.py`) waits for the pipeline and
compression slice (A13 c)."""

from repro_torch.optim.adamw import AdamWConfig, OptState, apply_updates, global_norm, init_opt
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "OptState", "apply_updates", "global_norm", "init_opt", "warmup_cosine"]
