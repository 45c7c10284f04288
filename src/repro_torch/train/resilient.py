"""Resilient training orchestration: chaos in, bitwise-identical curve out —
the port of `repro/train/resilient.py`.

`train_resilient` layers training-specific fault policy on top of the
generic `repro_torch.runtime.resilience.run_resilient` supervisor:

* **Fault sites** — a `FaultInjector` is checked once per step at each
  train site: `data_batch` before the batch is built, `grad_step` and
  `optimizer_update` before the step that contains both, `collective`
  after it (a lost reduction loses the step), and `ckpt_save` inside the
  supervisor's `on_save` hook. Every site raises before the step's result
  is committed to history, so a restart replays from the latest verified
  checkpoint and — `SyntheticLM.batch(step)` being a pure function of
  (seed, step), all mutable state living in the checkpoint and the step
  deterministic (K5 sums without atomics) — the resumed loss curve is
  bitwise identical to an uninterrupted run.

* **Loss-spike rollback** — each committed loss is compared with the
  median of the trailing `spike_window` losses; a spike beyond
  `spike_threshold`× raises `DivergenceRollback` (retryable), and a
  per-step rollback cap accepts a persistent shift.

* **Counters** — restarts / rollbacks / injected faults / on-device
  skipped updates.

The step carries the numerics guard (non-finite skip + dynamic loss
scaling), see `repro_torch.train.train_step`. `init_state_fn` / `step_fn`
replace the default state and step, as in the reference: the launcher's
mesh passes a sharded state and a step that distributes each batch
(`distributed.sharding.sharded`); checkpoints gather and restore it. It never syncs the host; the
loop reads all of a step's metrics in one transfer, where the reference's
`float(metrics["loss"])` syncs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.devices import resolve_device
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.runtime.resilience import (
    DivergenceRollback,
    FaultInjector,
    RetryPolicy,
    run_resilient,
)
from repro_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    make_train_step,
)

__all__ = ["ResilienceConfig", "train_resilient"]


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Policy knobs for the supervised train loop."""

    ckpt_every: int = 10
    keep_checkpoints: Optional[int] = None  # None → keep all
    max_restarts: int = 50
    retry: RetryPolicy = RetryPolicy()
    # loss-spike divergence detector (0 → disabled)
    spike_threshold: float = 0.0  # loss > threshold * trailing median ⇒ spike
    spike_window: int = 8
    spike_warmup: int = 8  # committed steps before detection arms
    max_rollbacks_per_step: int = 2  # then accept: real shift, not corruption


def train_resilient(
    *,
    ckpt_dir: str,
    model_cfg,
    train_cfg: TrainConfig,
    data,
    total_steps: int,
    seed: int = 0,
    res: ResilienceConfig = ResilienceConfig(),
    injector: Optional[FaultInjector] = None,
    chaos_hook: Optional[Callable[[int, object], object]] = None,
    on_step: Optional[Callable[[int, Dict[str, float], Dict[str, int]], None]] = None,
    device=None,
    init_state_fn: Optional[Callable[[], object]] = None,
    step_fn: Optional[Callable] = None,
) -> Tuple[object, List[Dict], Dict[str, int]]:
    """Train `total_steps` under the resilience policy; returns
    (final_state, history, counters).

    `data.batch(step)` must be a pure function of step (the bitwise-resume
    contract). `chaos_hook(step, state) -> state | None` is a test hook
    that can silently corrupt state before a step — the spike detector's
    adversary. The state starts as `init_state_fn()` (default:
    `init_train_state` seeded with `seed`) and steps through `step_fn`
    (default: `make_train_step`); it and the batches live on `device`
    (default the card).
    """
    dev = resolve_device(device)
    if step_fn is None:
        step_fn = make_train_step(model_cfg, train_cfg)
    if init_state_fn is None:
        init_state_fn = lambda: init_train_state(model_cfg, train_cfg, device=dev, seed=seed)

    counters = {"restarts": 0, "rollbacks": 0, "faults": 0, "skipped": 0}
    losses: Dict[int, float] = {}  # committed loss per data step (replay-safe)
    rollbacks_at: Dict[int, int] = {}

    def _spike_check(step: int, loss: float) -> None:
        if res.spike_threshold <= 0 or step < res.spike_warmup:
            return
        window = [losses[s] for s in range(max(0, step - res.spike_window), step)
                  if s in losses]
        if not window:
            return
        ref = float(np.median(window))
        if np.isfinite(loss) and loss <= res.spike_threshold * ref:
            return
        if rollbacks_at.get(step, 0) >= res.max_rollbacks_per_step:
            return  # persistent across clean replays ⇒ genuine shift: accept
        rollbacks_at[step] = rollbacks_at.get(step, 0) + 1
        counters["rollbacks"] += 1
        raise DivergenceRollback(step, loss, ref)

    def supervised_step(state, data_step: int):
        if injector is not None:
            injector.check("data_batch")
        batch = {k: torch.as_tensor(x, device=dev) for k, x in data.batch(data_step).items()}
        if chaos_hook is not None:
            corrupted = chaos_hook(data_step, state)
            if corrupted is not None:
                state = corrupted
        if injector is not None:
            injector.check("grad_step")
            injector.check("optimizer_update")
        new_state, metrics = step_fn(state, batch)
        if injector is not None:
            injector.check("collective")  # a lost reduction loses the step
        # the step's one host sync, the commit point: every metric in one transfer
        values = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev)
                              for v in metrics.values()]).tolist()
        metrics = dict(zip(metrics, values))
        loss = metrics["loss"]
        _spike_check(data_step, loss)
        losses[data_step] = loss
        if on_step is not None:
            if injector is not None:
                counters["faults"] = injector.total_fired
            on_step(data_step, metrics, counters)
        return new_state, metrics

    def on_save(step: int, state) -> None:
        if injector is not None:
            injector.check("ckpt_save")

    def on_restart(n: int, exc: BaseException) -> None:
        counters["restarts"] = n

    state, history = run_resilient(
        ckpt_dir=ckpt_dir,
        init_state_fn=init_state_fn,
        step_fn=supervised_step,
        total_steps=total_steps,
        ckpt_every=res.ckpt_every,
        max_restarts=res.max_restarts,
        retry=res.retry,
        keep=res.keep_checkpoints,
        on_save=on_save,
        on_restart=on_restart,
    )
    if injector is not None:
        counters["faults"] = injector.total_fired
    if hasattr(state, "skipped"):
        skipped = state.skipped
        counters["skipped"] = int(skipped.full_tensor() if is_dtensor(skipped) else skipped)
    return state, history, counters
