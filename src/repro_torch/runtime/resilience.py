"""Fault tolerance for training — the port of `repro/runtime/resilience.py`
(framework-free: the reference module with its unused `jax` import gone and
checkpoints through `repro_torch.runtime.checkpoint`).

* `run_resilient` — the restart loop: train inside a supervisor that, on a
  failure, restores the latest VERIFIED checkpoint — including the data-
  iterator step — and continues. The loss curve is identical to an
  uninterrupted run (bitwise, given deterministic data and a deterministic
  step), because all step state lives in the checkpoint; a corrupted
  newest checkpoint (failed CRC) falls back one interval.
  `repro_torch.train.resilient.train_resilient` layers the training policy
  (fault sites, loss-spike rollback, counters) on top.

* `RetryPolicy` — which exception types are retryable, how many times, and
  the backoff between attempts (exponential with deterministic jitter).

* `FaultInjector` — deterministic, seeded chaos: raises `InjectedFault` at
  named sites, probabilistically (`rate`) or on an explicit per-site
  occurrence `schedule`. The training sites (`TRAIN_SITES`) are checked by
  the resilient train loop, the serving sites (page_alloc,
  kernel_dispatch, device_step, host_sync) by the serve loops
  (`repro_torch.serve.engine`); `crash_after_checks` raises one
  `EngineCrash`, which the engine does not absorb.

* `DivergenceRollback` — raised by the train loop's loss-spike detector;
  retryable, so the supervisor restores the last good checkpoint.

* `StragglerMonitor` — per-step wall-time EWMA + robust z-score; flags slow
  steps and invokes a callback.

* `ElasticPlan` / `plan_mesh` — the mesh shape for a device count (the
  launcher's mesh; a checkpoint restores onto any plan through
  `checkpoint.restore(shardings=)`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Type

import numpy as np

from repro_torch.runtime import checkpoint as ckpt

__all__ = [
    "run_resilient",
    "RetryPolicy",
    "FaultInjector",
    "InjectedFault",
    "EngineCrash",
    "DivergenceRollback",
    "StragglerMonitor",
    "ElasticPlan",
    "plan_mesh",
]


# ---------------------------------------------------------------------------
# retry policy (shared by training restarts and the serving retry path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How failures are retried: which exception types, how many attempts,
    and the exponential-backoff/jitter schedule between them.

    Jitter is deterministic (seeded per (seed, attempt)) so retries stay
    reproducible — the same property the FaultInjector relies on.
    """

    max_retries: int = 3
    backoff_base_s: float = 0.0  # 0 → no sleeping (unit-test friendly)
    backoff_max_s: float = 30.0
    jitter: float = 0.0  # ±fraction of the delay
    retryable: Tuple[Type[BaseException], ...] = (RuntimeError,)

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retryable)

    def delay_s(self, attempt: int, *, seed: int = 0) -> float:
        """Backoff before retry number `attempt` (1-based)."""
        if self.backoff_base_s <= 0:
            return 0.0
        d = min(self.backoff_base_s * (2 ** max(attempt - 1, 0)), self.backoff_max_s)
        if self.jitter > 0:
            u = float(np.random.default_rng((seed, attempt)).random())
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return d


# ---------------------------------------------------------------------------
# deterministic chaos injection
# ---------------------------------------------------------------------------

class InjectedFault(RuntimeError):
    """A simulated recoverable failure raised by `FaultInjector.check`."""

    def __init__(self, site: str, rid: Optional[int] = None, index: int = -1):
        super().__init__(f"injected fault at {site!r} (occurrence {index}, rid={rid})")
        self.site = site
        self.rid = rid
        self.index = index


class EngineCrash(RuntimeError):
    """A simulated *unrecoverable* failure — the engine must not absorb it.

    Used to exercise the crash-recovery path: the serve loop's exception
    handler rolls live requests back into the queue (pages donated), the
    exception propagates, and `Engine.snapshot()/restore()` resumes warm.
    """


class DivergenceRollback(RuntimeError):
    """Loss-spike divergence detected by the resilient train loop.

    A RuntimeError subclass, so the default `RetryPolicy` treats it as
    retryable: `run_resilient` restores the last good checkpoint and
    replays — rolling back past silently-corrupted state instead of
    training through it (DESIGN.md §6)."""

    def __init__(self, step: int, loss: float, reference: float):
        super().__init__(
            f"loss spike at step {step}: {loss:.4g} vs reference {reference:.4g}"
        )
        self.step = step
        self.loss = loss
        self.reference = reference


class FaultInjector:
    """Deterministic, seeded fault source for the serving AND training
    loops.

    Two triggering modes, composable:

    * `rate` — each `check(site)` call fires with probability `rate`, drawn
      from one seeded stream (deterministic given the call sequence).
    * `schedule` — explicit `(site, occurrence_index)` pairs; the N-th
      `check` at that site fires regardless of `rate`. This is what the
      chaos tests use to target a specific request or step.

    Sites: the first four are the serve-loop sites; the train sites
    model where a training-pipeline failure surfaces — the input pipeline
    (`data_batch`), the fwd/bwd dispatch (`grad_step`), the optimizer
    apply (`optimizer_update`), the checkpoint write (`ckpt_save`), and a
    cross-device reduction (`collective`). The resilient train loop checks
    them once per step in that order (repro.train.resilient).

    `crash_after_checks=N` raises `EngineCrash` on the N-th check overall
    (0-based), once — simulating a hard crash mid-serve.
    """

    SITES = (
        "page_alloc", "kernel_dispatch", "device_step", "host_sync",
        "data_batch", "grad_step", "optimizer_update", "ckpt_save",
        "collective",
    )
    TRAIN_SITES = (
        "data_batch", "grad_step", "optimizer_update", "ckpt_save",
        "collective",
    )

    def __init__(
        self,
        rate: float = 0.0,
        seed: int = 0,
        *,
        sites: Optional[Iterable[str]] = None,
        schedule: Iterable[Tuple[str, int]] = (),
        crash_after_checks: Optional[int] = None,
    ):
        self.rate = float(rate)
        self.seed = int(seed)
        self.sites = frozenset(sites) if sites is not None else frozenset(self.SITES)
        unknown = self.sites - set(self.SITES)
        if unknown:
            raise ValueError(f"unknown fault sites: {sorted(unknown)}")
        self._rng = np.random.default_rng(seed)
        self._schedule: Dict[str, set] = {}
        for site, idx in schedule:
            if site not in self.SITES:
                raise ValueError(f"unknown fault site in schedule: {site!r}")
            self._schedule.setdefault(site, set()).add(int(idx))
        self.crash_after_checks = crash_after_checks
        self._crashed = False
        self.calls: Dict[str, int] = {s: 0 for s in self.SITES}
        self.fired: Dict[str, int] = {s: 0 for s in self.SITES}

    @property
    def total_calls(self) -> int:
        return sum(self.calls.values())

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())

    def check(self, site: str, rid: Optional[int] = None) -> None:
        """Raise `InjectedFault` if this occurrence of `site` is faulted."""
        if site not in self.SITES:
            raise ValueError(f"unknown fault site: {site!r}")
        total = self.total_calls
        idx = self.calls[site]
        self.calls[site] += 1
        if (
            self.crash_after_checks is not None
            and not self._crashed
            and total >= self.crash_after_checks
        ):
            self._crashed = True
            raise EngineCrash(f"injected crash at check #{total} (site {site!r})")
        fire = idx in self._schedule.get(site, ())
        if not fire and self.rate > 0.0 and site in self.sites:
            fire = float(self._rng.random()) < self.rate
        if fire:
            self.fired[site] += 1
            raise InjectedFault(site, rid=rid, index=idx)


# ---------------------------------------------------------------------------
# restart-driven fault tolerance
# ---------------------------------------------------------------------------

def run_resilient(
    *,
    ckpt_dir: str,
    init_state_fn: Callable[[], object],
    step_fn: Callable[[object, int], Tuple[object, Dict]],
    total_steps: int,
    ckpt_every: int = 50,
    max_restarts: int = 10,
    fail_at: Optional[Callable[[int], bool]] = None,
    retry: Optional[RetryPolicy] = None,
    keep: Optional[int] = None,
    on_save: Optional[Callable[[int, object], None]] = None,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
) -> Tuple[object, List[Dict]]:
    """Supervised training loop. `step_fn(state, data_step)` returns
    (state, metrics). `fail_at(step)` raising simulates node failure.

    `retry` controls which exception types trigger a restart (default:
    `RuntimeError` only, the historical behavior) and the jittered backoff
    slept between restarts; `max_restarts` still caps the restart count.

    Restores go through checksum verification with fallback: the newest
    checkpoint that VERIFIES wins, so a torn/corrupted save costs at most
    one checkpoint interval. `keep=N` garbage-collects all but the newest
    N checkpoints after each successful save. `on_save(step, state)` runs
    just before each checkpoint write (a fault-injection point: an
    exception there aborts the save and is handled like any step failure);
    `on_restart(restart_index, exc)` observes each supervised restart.
    """
    policy = retry if retry is not None else RetryPolicy()
    history: List[Dict] = []
    restarts = 0
    while True:
        # (re)start: restore the newest VERIFIED checkpoint, or init fresh
        valid = ckpt.valid_steps(ckpt_dir)
        if valid:
            template = init_state_fn()
            state, extra = ckpt.restore(ckpt_dir, template, step=valid[-1])
            step = int(extra["data_step"])
        else:
            state = init_state_fn()
            step = 0
        try:
            while step < total_steps:
                if fail_at is not None and fail_at(step):
                    raise RuntimeError(f"simulated node failure at step {step}")
                state, metrics = step_fn(state, step)
                history.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
                step += 1
                if step % ckpt_every == 0 or step == total_steps:
                    if on_save is not None:
                        on_save(step, state)
                    ckpt.save(ckpt_dir, step, state, extra={"data_step": step})
                    if keep is not None:
                        for s in ckpt.valid_steps(ckpt_dir)[:-keep]:
                            import shutil as _sh

                            _sh.rmtree(
                                f"{ckpt_dir}/step_{s:08d}", ignore_errors=True
                            )
            return state, history
        except policy.retryable as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
            delay = policy.delay_s(restarts)
            if delay > 0:
                time.sleep(delay)
            # truncate unpersisted history (those steps will be replayed)
            persisted = ckpt.valid_steps(ckpt_dir)
            last_good = persisted[-1] if persisted else 0
            history = [h for h in history if h["step"] < last_good]


# ---------------------------------------------------------------------------
# straggler mitigation
# ---------------------------------------------------------------------------

class StragglerMonitor:
    """EWMA + MAD-based step-time anomaly detector with an action hook."""

    def __init__(
        self,
        *,
        threshold: float = 3.0,
        warmup: int = 5,
        ewma_alpha: float = 0.2,
        on_straggler: Optional[Callable[[int, float, float], None]] = None,
    ):
        self.threshold = threshold
        self.warmup = warmup
        self.alpha = ewma_alpha
        self.on_straggler = on_straggler
        self.ewma: Optional[float] = None
        self.deviations: List[float] = []
        self.flagged: List[int] = []
        self._n = 0
        self._t0: Optional[float] = None

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self, step: int, elapsed: Optional[float] = None):
        if elapsed is None:
            if self._t0 is None:  # end without start: nothing to measure
                return
            elapsed = time.monotonic() - self._t0
        self._t0 = None
        self.observe(step, elapsed)

    def observe(self, step: int, dt: float):
        self._n += 1
        if self.ewma is None:
            self.ewma = dt
            return
        dev = abs(dt - self.ewma)
        self.deviations.append(dev)
        mad = float(np.median(self.deviations[-100:])) if self.deviations else 0.0
        if self._n > self.warmup and mad > 0 and (dt - self.ewma) / (1.4826 * mad) > self.threshold:
            self.flagged.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
        # EWMA updated with clipped sample so one straggler doesn't poison it
        clipped = min(dt, self.ewma * 3)
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * clipped


# ---------------------------------------------------------------------------
# elastic scaling
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def plan_mesh(n_devices: int, *, prefer_model: int = 16, pod_size: int = 256) -> ElasticPlan:
    """Largest power-of-two model axis ≤ prefer_model that divides n_devices;
    remaining factor → data; >1 pod_size multiples get an explicit pod axis."""
    model = prefer_model
    while model > 1 and n_devices % model:
        model //= 2
    rest = n_devices // model
    if n_devices > pod_size and rest % (n_devices // pod_size) == 0:
        pods = n_devices // pod_size
        data = rest // pods
        return ElasticPlan((pods, data, model), ("pod", "data", "model"))
    return ElasticPlan((rest, model), ("data", "model"))
