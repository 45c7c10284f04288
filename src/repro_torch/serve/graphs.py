"""The serving engine's steps as captured CUDA graphs — the port's
counterpart of the reference engine's jitted programs
(`repro/serve/engine.py` `_build_jits`: `_chunk_fn`, `_gen_fn`, the
bucketed `_prefill`, `_mixed_fn`).

A step is a function over static buffers: it reads its inputs from
tensors whose addresses never change and writes its results into others,
in place. `StepGraphs.run(graphs, key, fn)` runs one step:

  * graphs on (a CUDA engine's default): the first run of a key is the
    step itself, eager, on a side stream — the warm-up, where kernel
    builds, library loads, `cudaFuncSetAttribute` and cuBLAS set-up
    happen — and is followed by a capture of the same function into a
    `torch.cuda.CUDAGraph`; every later run of the key replays the graph.
    All graphs share one memory pool: they are replayed one at a time, on
    one stream, and write what they return into buffers allocated outside
    the pool;
  * graphs off (a CPU engine, or `Engine(graphs=False)` on the card, the
    oracle): every run is the same function, eager.

A capture that fails raises; nothing falls back to the eager step. The
garbage collector is off during a capture: a dead object that holds
graphs (an engine in a reference cycle) freed by the collector in the
middle of a capture would reset its graphs there, which invalidates the
capture (torch no longer collects before a capture).

Launch counters. The kernel wrappers count their launches in Python
(`flashd_decode.launches`, `.paged_launches`, `flashd_varlen.launches`),
so a replay, which runs no Python, would count nothing and the capture,
which launches nothing, would count once. The capture's count is taken
back and kept as the graph's delta, and each replay adds it: a captured
run reports the launches an eager run of the same steps reports.

Host data enters the static buffers through `put`, a `copy_` from a
pinned staging twin of the buffer (a copy from pageable memory cannot be
captured and would block the host).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Hashable, Optional

import numpy as np
import torch

from repro_torch.kernels import flashd_decode, flashd_varlen

__all__ = ["StepGraphs", "launch_counts"]

_COUNTERS = ((flashd_decode, "launches"), (flashd_decode, "paged_launches"),
             (flashd_varlen, "launches"))


def launch_counts() -> tuple:
    """(K2, K3, K4) launch counters, in that order."""
    return tuple(getattr(mod, name) for mod, name in _COUNTERS)


def _add_counts(delta) -> None:
    for (mod, name), d in zip(_COUNTERS, delta):
        setattr(mod, name, getattr(mod, name) + d)


class StepGraphs:
    """Runs the engine's steps eagerly or as graph replays (module doc).

    `generator` is the sampling generator; with graphs on it is registered
    with every graph, so temperature sampling stays a function of the seed."""

    def __init__(self, device: torch.device, *, graphs: bool,
                 generator: Optional[torch.Generator] = None):
        if graphs and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA engine, not {device}")
        self.device = device
        self.graphs = graphs
        self.captures = 0  # graphs captured over this object's life
        self.capture_s = 0.0  # host seconds of their warm-up runs and captures
        self._gen = generator
        self._pool = torch.cuda.graph_pool_handle() if graphs else None
        self._side = torch.cuda.Stream(device) if graphs else None
        self._stage: Dict[int, tuple] = {}  # buffer address → (pinned twin, copy event)

    def run(self, graphs: Dict[Hashable, tuple], key: Hashable, fn: Callable[[], None]) -> None:
        """Run step `key` (`fn` over static buffers); `graphs` holds the
        captures of the object that owns those buffers."""
        if not self.graphs:
            fn()
            return
        hit = graphs.get(key)
        if hit is not None:
            graph, delta = hit
            graph.replay()
            _add_counts(delta)
            return
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            fn()  # the step itself: the warm-up
        cur.wait_stream(self._side)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        if self._gen is not None:
            graph.register_generator_state(self._gen)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                fn()
        finally:
            if collecting:
                gc.enable()
        delta = tuple(a - b for a, b in zip(launch_counts(), before))
        _add_counts(tuple(-d for d in delta))  # the capture launched nothing
        graphs[key] = (graph, delta)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def put(self, dst: torch.Tensor, values) -> None:
        """dst ← values (host data of dst's shape), through a pinned twin of
        dst on the card. The twin is rewritten only after its last copy
        has completed."""
        src = torch.from_numpy(np.ascontiguousarray(values)).reshape(dst.shape).to(dst.dtype)
        if not dst.is_cuda:
            dst.copy_(src)
            return
        twin, done = self._stage.get(dst.data_ptr(), (None, None))
        if twin is None or twin.shape != dst.shape or twin.dtype != dst.dtype:
            twin = torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True)
            done = torch.cuda.Event()
        done.synchronize()
        twin.copy_(src)
        dst.copy_(twin, non_blocking=True)
        done.record(torch.cuda.current_stream(self.device))
        self._stage[dst.data_ptr()] = (twin, done)
