"""LR schedules: linear warmup + cosine decay — the port of
`repro/optim/schedule.py` (f32 arithmetic, as the reference's)."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)
