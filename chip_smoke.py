#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Run from the root of a checkout (it puts ./src on sys.path). Phases, one
line each with its seconds; any failure raises and the exit code is
non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. building the CUDA kernels from src/repro_torch/csrc with nvcc, one
     process per translation unit, all at once (nvcc seconds per library);
     per library the tensor-core (HGMMA, HMMA) and FFMA instruction counts
     of its SASS (cuobjdump), asserting that K1, K4, K5 and K6 run on the
     tensor cores; the registers and spills of its head-dim-96 and -256
     kernels and of K2 / K3's group-8 instance (groups of 9–16 run it as
     two CTAs);
  3. K1 `flashd_fwd` against `flashd_fwd_plain` at qwen3-0.6b widths
     (Hq 16, Hkv 8, d 128, Sq = Skv = 2048): four mask kinds, q_offset,
     skip on/off, fully masked rows; f32 and bf16; timed in both dtypes
     beside the plain version and one `scaled_dot_product_attention` call
     in the same dtype, with three bounds (f32 on the CUDA cores, 3xTF32
     and bf16 on the tensor cores) and the achieved TFLOP/s;
  4. K2 `flashd_decode` against `flashd_decode_plain` (B 8, S_max 4096,
     ragged cache_len with 0 and 1; window, chunk, start, return_lam,
     fused and unfused, bf16), timed at the engine's decode shape (f32 and
     bf16; phases 7, 8 and 10 time bf16 beside f32 too), by CUDA events
     around the call and by the device time of what it launches (phases 7
     and 8 too), beside the byte bound of each dtype;
  5. full-width qwen3-0.6b cut to QWEN_LAYERS (14 of its 28) layers —
     the depth of phases 5–17 — in f32 on seeded random weights: apply_lm
     (last_only) and the engine (`generate`, `serve`), kernels against
     the plain path — greedy tokens identical, logits within bound, both
     kernels launched on the main path; the engine's steps replayed as
     CUDA graphs (the default) against fresh engines captured and run
     eagerly (`graphs=False`) on a short workload (the 2 shortest
     requests and 2 of generate's prompts cut to 32, 8 new): tokens, K2–K4
     launch counts and host syncs equal; tok/s and TTFT, and a decode
     step's breakdown (host ms, device busy, idle share) eager and
     captured;
  6. the same engine run in bf16, the model's own dtype;
  7. K3 `flashd_decode_paged` against `flashd_decode_paged_plain` at
     qwen3-0.6b widths (B 8, shuffled pages, NaN on the garbage page 0,
     pages of 64, 16 and 4, cache_len 0 … full, window, chunk; bf16, an
     int8 pool), against the plain version in the kernel's split order and
     against K2 on the gathered view; timed at the engine's paged decode
     shape with pages of 64 and of 16, beside K2 on the gathered pages
     (the same live tokens);
  8. K4 `flashd_varlen` against `flashd_varlen_plain` on packs built by
     the engine's packer (decode rows + a mid-sequence prefill chunk; whole
     prompts + verify rows + a padding block; four whole prompts of 512),
     block_q 8 and 16, bf16 and int8; padding rows exactly 0; timed on the
     mixed-step pack and on the four-prompt pack (the tensor-core body);
  9. the paged and the mixed serving loops at full width, f32, on phase
     5's weights and requests, the prefix cache on: kernel path captured,
     tokens identical to phase 5's contiguous loop, K3 / K4 launched, the
     page allocator consistent; captured = eager (tokens, launches, host
     syncs) = the plain path's tokens on phase 5's short workload; paged
     decode step and packed step breakdowns, eager and captured; a
     shared-prefix workload (8 requests, a 256-token system prompt) with
     the cache on and off, captured: tokens identical, hits counted, and
     one request's TTFT cold and warm; then one bf16 mixed serve;
 10. K5 `flashd_bwd` against `flashd_bwd_plain` at qwen3-0.6b training
     widths (B 2, Hq 16, Hkv 8, d 128, S 1024): four mask kinds, a ragged
     S of 1000, dead rows; f32 and bf16; deterministic; timed beside the
     plain version and the backward of one `scaled_dot_product_attention`,
     with three bounds (f32 on the CUDA cores, 3xTF32, bf16) and TFLOP/s;
 11. K6 `fa2_fwd` against `fa2_fwd_plain` and against K1 (O and Λ), and
     K1 and K6 timed in turns at phase 3's shape in f32 and in bf16 (the
     paper's FLASH-D vs FA2 comparison on this card), beside SDPA in both
     dtypes and the three bounds;
 12. full-width qwen3-0.6b training, f32: the same 4 `make_train_step`
     steps on the kernel path (K1 forward, K5 backward), the plain path
     and the FA2 path (K6 + K5), loss and grad norm agreeing step by step;
     one bf16 step; tokens/s per step and a profile of one step;
 13. the lifecycle at full width and 2 layers: `train_resilient` with a
     scheduled `grad_step` fault gives the clean run's loss curve (the same
     steps, no checkpoint) bit for bit, and the restored checkpoint serves
     the in-memory weights' tokens;
 15. the quantized pool (`kv_dtype` int8 and fp8) at full width, f32: phase
     9's requests through the paged and the mixed loops, captured (K3 / K4
     launched), and captured = eager (tokens, launches, host syncs, the
     allocator) on phase 5's short workload (2 requests, 8 new); the 4
     shortest requests alone on the int8 paged loop (phase 17's baseline);
     the sequential and packed write paths fed the
     same K/V rows store byte-equal pages and scales (an identity-weight
     layer, so the packed step's K/V are its rows); K3 and K4 on the pages
     the engines wrote against their plain versions; teacher-forced, the
     kernel path's log-probabilities on a byte pool within 0.1 of the
     plain path's (the reference's int8 drift bound). A byte pool rounds
     ulp-level differences of K/V (summation order, the GEMMs' row counts)
     into whole codes now and then, so token streams of the kernel and
     plain paths, of the two loops and of other batches are compared and
     printed, not required equal; so is the share of equal bytes in the
     two loops' pools. kv_bytes_per_token; K3 / K4 device time on int8 and
     fp8 pools beside native, and K4 on a verify pack;
 16. speculative decoding (`spec_tokens` 4) in the paged and mixed loops
     with a self-draft (acceptance 1.0), `OracleDraft` at accuracy 0.5 and
     a draft model of the target's first 2 layers (K2 proposals): tokens
     equal the non-speculative run's, the allocator consistent; once more
     on an int8 pool, its streams compared with phase 15's int8 run;
     acceptance, tokens per round, tok/s against phase 9's
     non-speculative run, K2 / K3 / K4 launches;
 17. fault-tolerant serving at full width, f32, phase 9's requests, on
     the three captured loops (`_fault_phase`): seeded chaos (every
     request terminal, DONE streams equal phase 5's tokens, the allocator
     consistent, no downgrade, faults by site, retries, failures, tok/s
     beside the fault-free first serve); a crash, `snapshot()`, a fresh
     engine's `restore()` and `resume()` (phase 5's tokens, prefix hits
     after the re-warm; restore, re-warm and recapture seconds); a kernel →
     plain downgrade (one switch, phase 5's tokens, then a serve without
     faults that launches no K2–K4 kernel); the 4 shortest requests under
     chaos, no downgrade, on an int8 pool (against phase 15's run of them)
     and with `OracleDraft` speculation;
 18. llama4-scout-17b-a16e at full width (d 5120, 40 / 8 heads of 128, 16
     experts of d_ff 8192, top-1, vocab 202048), cut to 4 layers — one
     period of the pattern, 3 `attn_chunked` + 1 `attn_nope`, all MoE —
     in f32 on seeded random weights (`_a12_phase`): the forward at S 8704
     across the 8192-token chunk boundary, kernels against plain (logits
     at the boundary's last position and the sequence's last); K1 under
     the chunked mask at that shape, timed beside SDPA; 6 requests on 4
     slots through the contiguous and the paged loop, captured, kernel =
     plain tokens (paged: also a second serve and an eager engine), K2
     (the rings) and K3 (the NoPE layer's pages) launched, and each held
     to its plain version on the served engine's ring and pool; a decode
     step's breakdown, parameter bytes and peak memory;
 19. two lines. phi-3-vision-4.2b at full width (d 3072, Hq = Hkv = 32 of
     head dim 96, d_ff 8192, vocab 32064, 256 patch rows), f32, seeded
     random weights (`_phi3_phase`): K1, K6 and K5 at its attention shape
     (B 1, S 2048, causal) against plain in f32 and bf16, timed beside SDPA
     and their bounds; one train step with `patch_embeds` on the kernel,
     plain and FA2 paths at the depth whose train state fits the card
     (printed); the forward at all 32 layers with 256 patch rows, kernel
     vs plain logits; text requests through the captured contiguous, paged
     and mixed loops, kernel = plain tokens, K2 / K3 / K4 launched and each
     held to plain (and timed) on the served engine's cache, pool or a pack
     over it. Then mamba2-2.7b at full width and depth (64 `ssm` layers),
     f32 (`_mamba2_phase`): the chunked forward against the captured
     decode chain, the contiguous loop captured = eager, paged and mixed
     engines routed to it, no kernel launched;
 20. seamless-m4t-medium at full width and depth (12 encoder + 12
     decoder layers, d 1024, 16 heads of 64, vocab 256206, the audio-frame
     stub), f32, seeded random weights (`_encdec_phase`): K1, K6 and K5 at
     the encoder's shape (T 1024 against T 1024, full) and cross
     attention's (S 256 against T 1024, full) against plain, timed beside
     SDPA and their bounds; `apply_encdec` at B 2 (1024 frames, 256
     tokens), kernels against plain, 36 K1 launches; one train step on the
     kernel, FA2 and plain paths; encode, the cross cache and 64 greedy
     decode steps at B 4 from a 16-token prompt, kernel = plain tokens, 24
     K2 launches a step, decode logits against the forward, K2 against
     plain (and timed) on the self cache and the cross cache (cache_len T);
     an eager decode step's breakdown;
 21. two lines. recurrentgemma-9b at full width and depth (38 layers, d
     4096, Hq 16 over Hkv 1 of head dim 256: a group of 16, local window
     2048, vocab 256000), f32, seeded random weights (`_rgemma_phase`): K1
     K6 and K5 at its attention shape (B 1, S 4096, local 2048) against
     plain in f32 and bf16, bitwise repeats, timed beside SDPA (K5: its
     backward) with the mask as a boolean one and their bounds; the forward
     at S 4096 across the window, kernel against plain logits at positions
     2047 and 4095; 6 requests on the contiguous loop (no global layer, so
     no pool), captured = eager = plain tokens, K2 launched; a captured
     decode step's breakdown; K2 on a 2048-slot ring filled past a wrap
     against plain, timed; one train step (B 1 × S 2560, across the
     window) at full width on the kernel (K1 + K5), FA2 (K6 + K5) and plain
     paths, cut to the whole periods whose train state fits the card (bf16
     AdamW moments, no numerics guard), loss and grad norm against plain,
     peak memory printed. Then qwen3-moe-235b-a22b at
     full width (Hq 64 over Hkv 4: G 16, 128 experts top-8), 2 of 94
     layers (`_qwen3moe_phase`): 6 requests through the captured
     contiguous, paged and mixed loops, kernel = plain tokens in each, K2,
     K3 and K4 launched at G 16 and each held to plain (and timed) on the
     served cache or pool;
 22. the sharded train step (`repro_torch.distributed`) on a 1-rank NCCL
     process group and a (1, 1) ('data', 'model') mesh (`_sharded_phase`):
     phase 12's qwen3-0.6b (full width, QWEN_LAYERS layers, f32, B 2 x S
     1024), 2 sharded steps against 2 unsharded ones from the same init —
     loss and grad norm within TRAIN_REL, each parameter leaf's largest
     relative gap printed, K1 and K5 launched through the attention island
     with the plain routes refused, K6 not launched; host and device-busy
     ms per step of both;
 14. (last) the kernels line (JSON) and the total seconds, then the result
     line (JSON).

It exits with code 2, printing no result, when no CUDA device is visible
or when the port's sources are not beside it.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

F32_TOL = 5e-5  # O and Λ, f32: summation order only
BF16_TOL = 2e-2  # O in bf16: one bf16 rounding of |O| < 4 (2^-7 · 2 + slack)
LOGIT_TOL = 1e-3  # full-width f32 logits after 14–28 layers, attention order only
QWEN_LAYERS = 14  # qwen3-0.6b's depth cut (of 28) in phases 5–17: the run fits the limit
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # K5 f32: the reference's kernel-vs-autodiff bound
GRAD_BF16 = 2.0 ** -7  # K5 bf16: one bf16 rounding of the largest gradient entry
TRAIN_REL = (1e-5, 1e-4)  # loss / grad norm, kernel vs plain: step 0, after AdamW updates
BF16_LOSS_REL = 1e-2  # bf16 step-0 loss vs f32: 8-bit mantissa, averaged over 2048 tokens
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# dense peaks: f32 on the CUDA cores; TF32 and bf16 on the tensor cores
PEAK_OPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
TC_KERNELS = ("flashd_fwd", "fa2_fwd", "flashd_bwd", "flashd_varlen")  # products on the tensor cores


def _line(phase: int, text: str) -> None:
    print(f"[phase {phase}] {text}", flush=True)


def _time_ms(fn, reps: int = 10, flush=None) -> float:
    """Median device time of `fn` over `reps` calls (CUDA events), after a
    warm-up; with `flush`, the L2 cache is overwritten before each call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _device_ms(fn, flush, reps: int = 20) -> float:
    """Device time of `fn` per call: the kernels and memsets it launches,
    summed by torch.profiler, with the L2 cache overwritten before each
    call (the flush's own fill kernel left out). Unlike `_time_ms` it
    leaves out the host's launch overhead, which exceeds the flush for a
    small kernel behind a Python wrapper."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "FillFunctor<int>" not in e.key) / reps / 1e3


def _graph_ms(fn, flush, reps: int = 20, rounds: int = 7) -> float:
    """Device time of `fn` per call without the host's launch cost: `reps`
    calls, each after an L2 flush, captured in one CUDA graph, against the
    flushes alone captured the same way; the median over `rounds` pairs of
    replays (CUDA events) of the difference, per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    graphs = []
    for with_fn in (True, False):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                flush.zero_()
                if with_fn:
                    fn()
        graphs.append(g)

    def replay_ms(g):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    diffs = sorted(replay_ms(graphs[0]) - replay_ms(graphs[1]) for _ in range(rounds))
    return diffs[rounds // 2] / reps


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _agreement(a, b) -> str:
    """Two runs' token streams: how many are equal, and where the others part."""
    parts = [next((i for i, (x, y) in enumerate(zip(u, w)) if x != y), None) for u, w in zip(a, b)]
    n_eq = sum(p is None for p in parts)
    where = [p for p in parts if p is not None]
    return f"{n_eq}/{len(parts)} streams equal" + (f", the others part at tokens {where}"
                                                    if where else "")


def _cuobjdump(nvcc: str) -> str:
    """cuobjdump beside nvcc, else the copy in Triton's package; raises if
    neither exists (phase 2's tensor-core check does not skip)."""
    cand = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if os.path.exists(cand):
        return cand
    try:
        import triton

        cand = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                            "cuobjdump")
    except ImportError:
        cand = ""
    if cand and os.path.exists(cand):
        return cand
    raise RuntimeError("cuobjdump not found beside nvcc nor in triton/backends/nvidia/bin")


def _sass_counts(cuobjdump: str, libs: dict) -> dict:
    """Tensor-core (HGMMA, HMMA) and FFMA instructions in each library's
    SASS ({name: path}), one cuobjdump process per library, all at once."""
    import re

    counts = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(next(iter(libs.values())))) as tmp:
        procs = {}
        for name, path in libs.items():  # output to files: pipes would serialise the dumps
            with open(os.path.join(tmp, name), "w") as out:
                procs[name] = subprocess.Popen([cuobjdump, "-sass", path], stdout=out,
                                               stderr=subprocess.PIPE, text=True)
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"cuobjdump -sass {libs[name]} failed: {err}")
            with open(os.path.join(tmp, name)) as f:
                found = re.findall(r"\b(HGMMA|HMMA|FFMA)\b", f.read())
            counts[name] = {op: found.count(op) for op in ("HGMMA", "HMMA", "FFMA")}
    return counts


def _attn_bounds(ops: float, bytes_f32: float, bytes_bf16: float) -> dict:
    """(ms, "operations" or "bytes") bounds of a forward attention of `ops`
    flops (both products): f32 on the CUDA cores, f32 as 3xTF32 (three TF32
    products) and bf16 on the tensor cores, each the larger of its
    operations and its bytes."""
    def bound(op_s, byte_s):
        return (1e3 * max(op_s, byte_s), "operations" if op_s >= byte_s else "bytes")

    return {"f32_cuda": bound(ops / PEAK_OPS["float32"], bytes_f32 / HBM_BYTES_PER_S),
            "3xtf32": bound(3 * ops / PEAK_OPS["tf32"], bytes_f32 / HBM_BYTES_PER_S),
            "bf16": bound(ops / PEAK_OPS["bfloat16"], bytes_bf16 / HBM_BYTES_PER_S)}


def _bytes_bound(n_bytes: float, ops: float) -> float:
    """ms: the larger of `n_bytes` over HBM bandwidth and `ops` f32 FMA
    flops over the CUDA cores' rate (the decode kernels: bytes bound it)."""
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"])


def _fmt_bounds(bounds: dict, ops: float, ms: dict) -> str:
    """The three bounds and the achieved TFLOP/s of the timed calls in `ms`."""
    rates = ", ".join(f"{name} {ops / (t * 1e-3) / 1e12:.1f}" for name, t in ms.items())
    named = {"f32_cuda": "f32 on the CUDA cores", "3xtf32": "3xTF32", "bf16": "bf16"}
    return ("bounds " + ", ".join(f"{named[k]} {t:.4f} ms ({by})" for k, (t, by) in bounds.items())
            + f"; achieved TFLOP/s {rates}")


def _launches() -> dict:
    """The six kernels' launch counters, by kernel name."""
    from repro_torch.kernels import fa2_fwd as k6
    from repro_torch.kernels import flashd_bwd as k5
    from repro_torch.kernels import flashd_decode as k2
    from repro_torch.kernels import flashd_fwd as k1
    from repro_torch.kernels import flashd_varlen as k4

    return {"flashd_fwd": k1.launches, "flashd_decode": k2.launches,
            "flashd_decode_paged": k2.paged_launches, "flashd_varlen": k4.launches,
            "flashd_bwd": k5.launches, "fa2_fwd": k6.launches}


def _zero_launches() -> None:
    """Set every launch counter to 0 (just before a main-path run)."""
    from repro_torch.kernels import fa2_fwd as k6
    from repro_torch.kernels import flashd_bwd as k5
    from repro_torch.kernels import flashd_decode as k2
    from repro_torch.kernels import flashd_fwd as k1
    from repro_torch.kernels import flashd_varlen as k4

    k1.launches = k2.launches = k2.paged_launches = k4.launches = k5.launches = 0
    k6.launches = 0


class _Phase:
    """Seconds of one phase, for its line."""

    def __init__(self):
        self.t = time.perf_counter()

    def __str__(self) -> str:
        import torch

        return (f"[{time.perf_counter() - self.t:.1f} s, "
                f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated]")


def _paged_pool(gen, dev, lengths, n_tbl, page, hkv, d, dtype):
    """A pool of distinct shuffled pages with page 0 — where every table slot
    past a row's live pages points — filled with NaN (a byte pool, int8 or
    fp8 e4m3: NaN scales on page 0). Returns (k_pages, v_pages, tbl,
    k_scale, v_scale)."""
    import torch

    n_pages = len(lengths) * n_tbl + 1
    shape = (n_pages, page, hkv, d)
    ks = vs = None
    if dtype in (torch.int8, torch.float8_e4m3fn):
        if dtype == torch.int8:
            kp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            vp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        else:  # codes across e4m3's range
            kp, vp = ((torch.randn(shape, generator=gen, device=dev) * 100).clamp(-448, 448)
                      .to(dtype) for _ in range(2))
        ks = torch.rand(n_pages, hkv, generator=gen, device=dev) / 64 + 1e-3
        vs = torch.rand(n_pages, hkv, generator=gen, device=dev) / 64 + 1e-3
        ks[0] = vs[0] = float("nan")
    else:
        kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
        vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
        kp[0] = vp[0] = float("nan")
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tbl = perm.reshape(len(lengths), n_tbl).to(torch.int32)
    for i, n in enumerate(lengths):
        tbl[i, -(-n // page):] = 0
    return kp, vp, tbl, ks, vs


def _breakdown(label: str, step, steps: int = 10, train: bool = False, watch=()) -> str:
    """`step()` of the engine's (or the trainer's) shape: host wall time per
    step, device-busy time per step (torch.profiler kernel time), the
    device's idle share, the span from the first step's start to the last
    step's end on the device (CUDA events), and the kernels that take the
    device time (with the share and ms per step of each kernel whose name
    contains a string of `watch`). A trace with no kernel gives no busy
    time and no idle share."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with contextlib.nullcontext() if train else torch.inference_mode():
        step()
        torch.cuda.synchronize()
        first, last = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        first.record()
        for _ in range(steps):
            step()
        last.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
        span_ms = first.elapsed_time(last) / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    # kernel rows only: an operator row's self device time repeats its kernels'
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total_us = sum(us for _, us in rows)
    if total_us == 0:
        return (f"{label}: host {wall_ms:.2f} ms/step, device span {span_ms:.3f} ms/step (CUDA "
                f"events); device busy and idle share not measured: torch.profiler traced no "
                f"kernel")
    busy_ms = total_us / 1e3 / steps
    rows.sort(key=lambda r: -r[1])
    top = ", ".join(f"{name[:48]} {100 * us / total_us:.1f}%" for name, us in rows[:5])
    classes = {"FLASH-D/FA2 kernels": 0.0, "GEMM": 0.0, "other": 0.0}
    for name, us in rows:
        if name.startswith(("void (anonymous namespace)::", "void flashd::")):  # csrc/*.cu
            classes["FLASH-D/FA2 kernels"] += us
        elif "gemm" in name.lower() or "xmma" in name or "splitKreduce" in name:
            classes["GEMM"] += us
        else:
            classes["other"] += us
    by_class = ", ".join(f"{k} {100 * us / total_us:.1f}%" for k, us in classes.items())
    watched = "".join(
        f"; {w} {100 * us / total_us:.1f}% ({us / 1e3 / steps:.3f} ms/step)"
        for w, us in ((w, sum(t for name, t in rows if w in name)) for w in watch))
    return (f"{label}: host {wall_ms:.2f} ms/step, device busy {busy_ms:.3f} ms/step, device "
            f"idle {100 * (1 - busy_ms / wall_ms):.1f}% (device span {span_ms:.3f} ms/step, CUDA "
            f"events); device time by class: {by_class}; by kernel: {top}{watched}")


CHAOS_RATE, CHAOS_SEED = 0.1, 17  # phase 17's injector
# phase 17's chaos runs test the kernels under faults, not the downgrade: its
# trigger sits above any streak a serve here can reach (a few hundred
# kernel-site checks in all), and each run asserts no switch
CHAOS_DOWNGRADE_AFTER = 1 << 20
CRASH_AFTER = 40  # phase 17's crash: the 41st fault-site check of the serve
# phase 17's downgrade: three kernel_dispatch faults in a row once four
# dispatches have run (each loop has launched its kernels by then)
DOWNGRADE_SCHEDULE = [("kernel_dispatch", i) for i in (4, 5, 6)]


def _fault_phase(params, cfg, reqs, base, fault_free_tps, int8_short, dev):
    """Phase 17: fault-tolerant serving at full width on the three captured
    loops (contiguous, paged, mixed; max_batch 4, max_len 512, 32 new):

      * chaos: a seeded `FaultInjector` at CHAOS_RATE, no downgrade
        (CHAOS_DOWNGRADE_AFTER) — every request terminal, DONE streams equal
        to the fault-free `base`, partial ones prefixes of it, the allocator
        consistent; faults by site, retries, failures and tok/s beside
        `fault_free_tps` (the same loop's captured first serve on a fresh
        engine, phases 5 and 9);
      * crash: `EngineCrash` after CRASH_AFTER checks, `snapshot()`, a fresh
        engine's `restore()` (the radix chains re-warmed through its
        prefill graphs) and `resume()`: the `base` tokens, prefix hits in
        the paged loops; restore, re-warm and recapture seconds;
      * downgrade: DOWNGRADE_SCHEDULE — one switch to `flashd_plain`, the
        `base` tokens; a second serve without faults (the 4 shortest
        requests, 8 new) launches no K2–K4 kernel;
      * the 4 shortest requests under chaos, no downgrade, on an int8 pool
        (the paged loop, against `int8_short`, phase 15's captured run of
        the same requests) and with `OracleDraft` speculation at 0.5 (paged
        and mixed).

    Every run on a fresh engine, counts reset just before it; each run's
    kernels must launch. Returns (the report, K2–K4 launches of all runs)."""
    import numpy as np
    import torch

    from repro_torch.kernels import flashd_decode as k2
    from repro_torch.kernels import flashd_varlen as k4
    from repro_torch.runtime.resilience import EngineCrash, FaultInjector
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.graphs import launch_counts
    from repro_torch.serve.speculative import OracleDraft

    total = {"K2": 0, "K3": 0, "K4": 0}
    report = []
    snap_root = os.path.join(HERE, "build", "chip_smoke_snapshots")
    shutil.rmtree(snap_root, ignore_errors=True)

    def reset():
        k2.launches = k2.paged_launches = k4.launches = 0

    def launched(label, need):
        """This run's K2–K4 launches; the loop's kernels must have run."""
        got = dict(zip(("K2", "K3", "K4"), launch_counts()))
        for key in need:
            assert got[key] > 0, (label, got)
        for key in total:
            total[key] += got[key]
        return got

    def held(label, eng, outs, want):
        """Terminal statuses; DONE streams `want`, the rest prefixes of it;
        the allocator's invariants; no downgrade."""
        st = eng.stats()
        assert st["downgrades"] == 0 and st["attn_impl"] == cfg.attn_impl, (label, st["attn_impl"])
        status = st["request_status"]
        assert all(v in ("done", "failed", "expired") for v in status.values()), (label, status)
        for i, (o, w) in enumerate(zip(outs, want)):
            full = status[i] == "done"
            assert np.array_equal(o, w if full else w[: len(o)]), f"{label}: request {i} differs"
        if eng._alloc is not None:
            eng._alloc.check(eng._paged.cache)
        return st

    def timed_serve(eng, requests):
        t = time.perf_counter()
        outs = eng.serve(requests, 32)
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t

    def by_site(counts):
        return {k: counts[k] for k in ("page_alloc", "kernel_dispatch", "device_step", "host_sync")}

    n_serve = sum(len(o) for o in base)
    short = sorted(range(len(reqs)), key=lambda i: len(reqs[i]))[:4]
    s_reqs, s_base = [reqs[i] for i in short], [base[i] for i in short]
    # (mode, config, kernels of a whole serve, kernels before the downgrade:
    # the mixed loop's first steps are packed, its decode chunks come later)
    loops = (("contiguous", {}, ("K2",), ("K2",)),
             ("paged", dict(kv_layout="paged"), ("K3",), ("K3",)),
             ("mixed", dict(step_mode="mixed"), ("K3", "K4"), ("K4",)))
    for mode, kw, need, down_need in loops:
        sc = ServeConfig(max_batch=4, max_len=512, **kw)
        # chaos
        eng = Engine(params, cfg, dataclasses.replace(sc, downgrade_after=CHAOS_DOWNGRADE_AFTER),
                     device=dev, fault_injector=FaultInjector(CHAOS_RATE, CHAOS_SEED))
        reset()
        outs, dt = timed_serve(eng, reqs)
        got = launched(f"{mode} chaos", need)
        st = held(f"{mode} chaos", eng, outs, base)
        assert sum(st["injected_faults"].values()) > 0, st["injected_faults"]
        n_done = sum(v == "done" for v in st["request_status"].values())
        chaos = (f"chaos {n_done}/8 done, {st['failed']} failed, {st['retried']} retries, "
                 f"{st['downgrades']} downgrades, faults "
                 f"{by_site(st['injected_faults'])} of checks {by_site(st['fault_checks'])}, "
                 f"{sum(map(len, outs)) / dt:.1f} tok/s against {fault_free_tps[mode]:.1f} "
                 f"fault-free ({n_serve} tokens), {eng.host_syncs} host syncs, "
                 f"{eng._steps.captures} graphs, launches {got}")
        # crash, snapshot, restore into a fresh engine, resume
        eng = Engine(params, cfg, sc, device=dev,
                     fault_injector=FaultInjector(crash_after_checks=CRASH_AFTER))
        reset()
        try:
            eng.serve(reqs, 32)
        except EngineCrash:
            pass
        else:
            raise AssertionError(f"{mode}: the crash did not fire")
        if eng._alloc is not None:
            eng._alloc.check(eng._paged.cache)
        path = os.path.join(snap_root, mode)
        eng.snapshot(path)
        del eng
        fresh = Engine(params, cfg, sc, device=dev)
        t = time.perf_counter()
        state = fresh.restore(path)
        torch.cuda.synchronize()
        restore_s, rewarm_capture_s = time.perf_counter() - t, fresh._steps.capture_s
        t = time.perf_counter()
        results = fresh.resume()
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t
        got = launched(f"{mode} crash + resume", need)
        for i, w in enumerate(base):
            assert np.array_equal(results[i], w), f"{mode}: resumed request {i} differs"
        fst = fresh.stats()
        if mode != "contiguous":
            assert fst["hit_tokens"] > 0, (mode, fst["hit_tokens"])
            fresh._alloc.check(fresh._paged.cache)
        crash = (f"crash after {CRASH_AFTER} checks: {len(state['pending'])} pending, "
                 f"{len(state['done'])} done, {len(state['chains'])} chains "
                 f"({sum(map(len, state['chains']))} tokens); restore (re-warm included) "
                 f"{restore_s:.2f} s, of which graph captures {rewarm_capture_s:.2f} s; resume "
                 f"{resume_s:.2f} s, of which recapture {fresh._steps.capture_s - rewarm_capture_s:.2f}"
                 f" s; {fst['hit_tokens']} resumed prompt tokens cached; tokens equal; launches "
                 f"{got}")
        del fresh
        # the kernel → plain downgrade
        eng = Engine(params, cfg, dataclasses.replace(sc, downgrade_after=3, max_retries=8),
                     device=dev, fault_injector=FaultInjector(schedule=DOWNGRADE_SCHEDULE))
        reset()
        outs, dt = timed_serve(eng, reqs)
        st = eng.stats()
        assert st["downgrades"] == 1 and st["attn_impl"] == "flashd_plain", st["attn_impl"]
        got = launched(f"{mode} downgrade", down_need)  # the kernels ran before the switch
        for i, w in enumerate(base):
            assert np.array_equal(outs[i], w), f"{mode}: request {i} differs after the downgrade"
        eng._injector = None
        frozen = launch_counts()
        for i, o in enumerate(eng.serve(s_reqs, 8)):
            assert np.array_equal(o, s_base[i][:8]), f"{mode}: plain re-serve request {i} differs"
        torch.cuda.synchronize()
        assert launch_counts() == frozen, (mode, launch_counts(), frozen)
        down = (f"downgrade: 1 switch to {st['attn_impl']}, launches {got}, tokens equal, "
                f"{n_serve / dt:.1f} tok/s, {eng._steps.captures} graphs; a second serve "
                f"(4 shortest, 8 new, no faults) launched no K2–K4 kernel")
        del eng
        report.append(f"{mode}: {chaos}; {crash}; {down}")
    shutil.rmtree(snap_root, ignore_errors=True)
    # the 4 shortest requests: an int8 pool and speculation under chaos
    cases = [("int8 paged", dict(kv_layout="paged", kv_dtype="int8"), None, int8_short, ("K3",))]
    for mode, kw in (("paged", dict(kv_layout="paged")), ("mixed", dict(step_mode="mixed"))):
        cases.append((f"OracleDraft 0.5 {mode}", dict(kw, spec_tokens=4),
                      OracleDraft(s_reqs, s_base, cfg.vocab_size, accuracy=0.5, seed=0), s_base,
                      ("K4",)))
    for seed, (label, kw, draft, want, need) in enumerate(cases, CHAOS_SEED + 1):
        eng = Engine(params, cfg, ServeConfig(max_batch=4, max_len=512,
                                              downgrade_after=CHAOS_DOWNGRADE_AFTER, **kw),
                     device=dev, draft=draft, fault_injector=FaultInjector(CHAOS_RATE, seed))
        reset()
        outs, dt = timed_serve(eng, s_reqs)
        got = launched(label, need)
        st = held(label, eng, outs, want)
        n_done = sum(v == "done" for v in st["request_status"].values())
        report.append(f"{label}, 4 shortest: {n_done}/4 done, {st['failed']} failed, "
                      f"{st['retried']} retries, {st['downgrades']} downgrades, faults "
                      f"{by_site(st['injected_faults'])}, "
                      f"{sum(map(len, outs)) / dt:.1f} tok/s, launches {got}"
                      + (f", acceptance {st['spec_acceptance_rate']:.3f}" if draft else ""))
        del eng
    text = (f"fault-tolerant serving, qwen3-0.6b f32 full width, phase 9's 8 requests, 32 new, "
            f"captured, fault rate {CHAOS_RATE} (seed {CHAOS_SEED}): {'; '.join(report)}")
    return text, total


def _oracle(eng, gen_prompts, requests, n_new: int = 8) -> dict:
    """One engine on a short workload (`generate` on `gen_prompts` unless
    None, then `serve`): tokens, seconds, K2–K4 launches, host syncs and
    graphs captured — the captured-vs-eager check of phases 5 and 9."""
    import torch

    from repro_torch.serve.graphs import launch_counts

    before = launch_counts()
    t = time.perf_counter()
    gen = None if gen_prompts is None else eng.generate(gen_prompts, n_new)
    toks = eng.serve(requests, n_new)
    torch.cuda.synchronize()
    return dict(gen=gen, toks=toks, s=time.perf_counter() - t, syncs=eng.host_syncs,
                launched=tuple(a - b for a, b in zip(launch_counts(), before)),
                captures=eng._steps.captures)


def _check_oracle(label: str, oracle: dict) -> str:
    """Assert captured = eager (`_oracle` runs keyed None and False):
    tokens, K2–K4 launches and host syncs; → the text for the phase line."""
    import numpy as np

    cap, eag = oracle[None], oracle[False]
    if cap["gen"] is not None:
        assert np.array_equal(cap["gen"], eag["gen"]), f"{label}: generate tokens differ"
    for a, b in zip(cap["toks"], eag["toks"]):
        assert np.array_equal(a, b), f"{label}: captured and eager tokens differ"
    assert cap["launched"] == eag["launched"], (label, cap, eag)
    assert cap["syncs"] == eag["syncs"] and eag["captures"] == 0 < cap["captures"]
    n = sum(map(len, cap["toks"])) + (0 if cap["gen"] is None else cap["gen"].size)
    return (f"captured = eager on {len(cap['toks'])} requests"
            f"{'' if cap['gen'] is None else ' and a generate of 2 x 32'}, 8 new (fresh engines: "
            f"captured {cap['s']:.2f} s with {cap['captures']} captures, eager {eag['s']:.2f} s "
            f"for {n} tokens; K2–K4 launches {cap['launched']} = {eag['launched']}, host syncs "
            f"{cap['syncs']} = {eag['syncs']})")


A12_LAYERS = 4  # llama4-scout's depth cut: one whole period (3 attn_chunked + 1 attn_nope)
A12_SEQ = 8704  # phase 18's forward: past the 8192 chunk boundary by 512 positions


def _a12_phase(dev, card: str, flush):
    """Phase 18: llama4-scout-17b-a16e at full width (d 5120, Hq 40 / Hkv 8,
    head dim 128, 16 experts of d_ff 8192 top-1, vocab 202048, chunk 8192),
    A12_LAYERS layers, f32, seeded random weights:

      * forward: `forward_hidden` at B 1 × S A12_SEQ on the kernel path (K1
        under the chunked mask of the three chunked layers, the causal mask
        of the NoPE one) against the plain path; logits at the last position
        of the first chunk and at the last position, within LOGIT_TOL (never
        the [S, V] logits); K1 alone at the chunked layers' shape against
        its plain version, timed beside one SDPA call with the same mask as
        a boolean [S, S] one, and its bound; the MoE aux values;
      * serving: 6 requests (prompts 32–128, 16 new, max_batch 4, max_len
        256: the last two decode beside two dead slots, which step on page
        0 and feed the router) through the contiguous and the paged loop,
        captured, on the kernel path and the plain path: tokens identical
        within each loop; on the paged loop also the kernel engine's second
        serve and an eager kernel engine; K2 launches in both loops (the
        chunked layers' rings), K3 in the paged loop (the NoPE layer's
        pages), K4 never; tok/s, TTFT, a decode step's breakdown, parameter
        bytes and peak memory;
      * K2 on the served engine's ring of a chunked layer (B 4, Hq 40 /
        Hkv 8, 256 slots) at the ring's read lengths pos % 256 + 1 of
        positions past a wrap, and K3 on its NoPE layer's pool through a
        block table over its pages, each against its plain version in the
        kernel's split order within F32_TOL (outside the counted runs).

    Counts are reset just before each kernel-path run. Returns (the report,
    the launches of each kernel over the phase's kernel-path runs, the
    K1 timing row, the max|Δ| of K2 and K3 at the engines' shapes)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.blockwise import MaskSpec
    from repro_torch.kernels import flashd_decode as k2
    from repro_torch.kernels import flashd_fwd as k1
    from repro_torch.kernels import flashd_varlen as k4
    from repro_torch.models.layers import logits_from_hidden
    from repro_torch.models.transformer import (
        decode_step_lm,
        forward_hidden,
        init_decode_cache,
        init_lm,
    )
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"), n_layers=A12_LAYERS,
                              dtype="float32")
    plain_cfg = dataclasses.replace(cfg, attn_impl="flashd_plain")
    # K1 at the chunked layers' shape (before the weights take the card's memory):
    # kernel, plain, SDPA with the mask as a boolean one
    gen = torch.Generator(device=dev).manual_seed(18)
    hq, hkv, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, A12_SEQ
    q, k, v_ = (torch.randn(1, s, h_, d, generator=gen, device=dev) for h_ in (hq, hkv, hkv))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v_.transpose(1, 2)
    chunked = MaskSpec("chunked", chunk=cfg.attn_chunk)
    o, lam = k1.flashd_fwd(qt, kt, vt, mask=chunked)
    o_p, lam_p = k1.flashd_fwd_plain(qt, kt, vt, mask=chunked)
    k1_err = max(_err(o, o_p), _err(lam, lam_p))
    assert k1_err <= F32_TOL, ("K1 chunked", k1_err)
    del o, lam, o_p, lam_p
    k1_ms = _time_ms(lambda: k1.flashd_fwd(qt, kt, vt, mask=chunked), flush=flush)
    k1_plain_ms = _time_ms(lambda: k1.flashd_fwd_plain(qt, kt, vt, mask=chunked), reps=3,
                           flush=flush)
    pos = torch.arange(s, device=dev)
    vis = (pos[None] <= pos[:, None]) & (pos[None] // cfg.attn_chunk == pos[:, None] // cfg.attn_chunk)
    # the K/V heads repeated for the group: SDPA's memory-efficient kernel
    # takes a boolean mask in f32, its grouped-query path does not
    sd = [x.repeat_interleave(hq // x.shape[2], dim=2).transpose(1, 2).contiguous()
          for x in (q, k, v_)]
    k1_lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(*sd, attn_mask=vis),
                         flush=flush)
    n_vis = int(vis.sum())
    del sd, vis, q, k, v_, qt, kt, vt
    k1_ops = 4 * d * hq * n_vis
    k1_bounds = _attn_bounds(k1_ops, 4 * s * d * (2 * hq + 2 * hkv), 2 * s * d * (2 * hq + 2 * hkv))
    k1_row = {"ms": k1_ms, "plain_ms": k1_plain_ms, "library_ms": k1_lib_ms,
              "bound_ms": k1_bounds["3xtf32"][0], "bound_by": k1_bounds["3xtf32"][1],
              "max_abs_err": k1_err,
              "shape": f"B1 Hq{hq} Hkv{hkv} d{d} S{s} chunked {cfg.attn_chunk} f32 (3xTF32)"}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(cfg, device=dev, seed=0)
    param_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    launched = {"flashd_fwd": 0, "flashd_decode": 0, "flashd_decode_paged": 0, "flashd_varlen": 0}

    def counts():
        return {"flashd_fwd": k1.launches, "flashd_decode": k2.launches,
                "flashd_decode_paged": k2.paged_launches, "flashd_varlen": k4.launches}

    def reset():
        k1.launches = k2.launches = k2.paged_launches = k4.launches = 0

    # forward across the chunk boundary, kernels against plain
    rng = np.random.default_rng(18)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, A12_SEQ)), device=dev)
    rows = torch.tensor([cfg.attn_chunk - 1, A12_SEQ - 1], device=dev)
    head = params["lm_head"]
    fwd = {}
    for name, c in (("kernel", cfg), ("plain", plain_cfg)):
        if name == "kernel":
            reset()
        with torch.inference_mode():
            t = time.perf_counter()
            h, aux = forward_hidden(params, {"tokens": toks}, c)
            logits = logits_from_hidden(h[:, rows], head, cfg.vocab_size)[0]
            torch.cuda.synchronize()
            fwd[name] = (logits, {k: float(v) for k, v in aux.items()}, time.perf_counter() - t)
        del h
        if name == "kernel":
            got = counts()
            assert got["flashd_fwd"] == A12_LAYERS, got
            launched["flashd_fwd"] += got["flashd_fwd"]
    v = cfg.vocab_size
    logit_err = [_err(fwd["kernel"][0][i, :v], fwd["plain"][0][i, :v]) for i in range(2)]
    assert max(logit_err) <= LOGIT_TOL, ("llama4 logits", logit_err)
    n_moe = A12_LAYERS  # every layer's FFN is MoE
    dropped = fwd["kernel"][1]["moe_dropped"] / n_moe


    # serving: 6 requests on 4 slots (the second wave decodes beside dead slots)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
            for n in (32, 57, 96, 128, 33, 40)]
    n_new = 16
    report = []
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    qd = torch.randn(4, cfg.n_heads, cfg.head_dim_, generator=gen, device=dev)
    direct = {}
    for loop, kw in (("contiguous", {}), ("paged", dict(kv_layout="paged"))):
        sc = ServeConfig(max_batch=4, max_len=256, **kw)
        runs = {}
        paths = [("kernel", cfg, None), ("plain", plain_cfg, None)]
        if loop == "paged":
            paths.append(("eager", cfg, False))
        for name, c, graphs in paths:
            eng = Engine(params, c, sc, device=dev, graphs=graphs)
            reset()
            t = time.perf_counter()
            out = eng.serve(reqs, n_new)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            runs[name] = (out, dt, float(np.mean(list(eng.ttft.values()))), counts(),
                          eng._steps.captures)
            if eng._alloc is not None:
                eng._alloc.check()
            if name == "kernel" and loop == "paged":  # served twice: the same tokens
                for a, b_ in zip(out, eng.serve(reqs, n_new)):
                    assert np.array_equal(a, b_), "llama4 paged: a second serve differs"
            if name == "kernel":  # K2 / K3 on this engine's ring and pool
                blocks = (eng._paged if loop == "paged" else eng._contig[4]).cache["blocks"]
                with torch.inference_mode():
                    if loop == "paged":
                        direct[loop] = _served_direct(blocks["pos3"], qd, n_sm, loop,
                                                      (150, 1, 256, 77), "the NoPE layer's pool")
                    else:
                        direct[loop] = _served_direct(blocks["pos0"], qd, n_sm, loop,
                                                      (143, 300, 511, 700), "a chunked layer's ring")
            del eng
        (out, dt, ttft, got, graphs), plain = runs["kernel"], runs["plain"]
        for other in runs:
            for a, b_ in zip(out, runs[other][0]):
                assert np.array_equal(a, b_), f"llama4 {loop}: kernel and {other} tokens differ"
        assert sum(plain[3].values()) == 0, f"llama4 {loop}: the plain path launched a kernel"
        assert got["flashd_decode"] > 0 and got["flashd_varlen"] == 0, (loop, got)
        assert (got["flashd_decode_paged"] > 0) == (loop == "paged"), (loop, got)
        for key in launched:
            launched[key] += got[key]
        n_tok = sum(map(len, out))
        same = " = ".join(runs) + (" = a second serve" if loop == "paged" else "")
        report.append(f"{loop}: tokens identical {same}; {n_tok / dt:.1f} tok/s (plain "
                      f"{n_tok / plain[1]:.1f}), mean TTFT {ttft * 1e3:.1f} ms (plain "
                      f"{plain[2] * 1e3:.1f}), {graphs} graphs captured; launches {got}")
    # one decode step's breakdown at the loops' shape (B 4, pos 150), captured
    cache = init_decode_cache(4, 256, cfg, device=dev)
    tok4 = torch.zeros(4, dtype=torch.long, device=dev)
    at = torch.full((4,), 150, dtype=torch.long, device=dev)
    from repro_torch.serve.graphs import StepGraphs

    steps, captured = StepGraphs(dev, graphs=True), {}
    bd = _breakdown("captured decode step B4 pos150",
                    lambda: steps.run(captured, "decode",
                                      lambda: decode_step_lm(params, cache, tok4, at, cfg)))
    del steps, captured, cache, params
    peak = torch.cuda.max_memory_allocated()
    text = (f"llama4-scout-17b-a16e f32 full width, {A12_LAYERS} layers (one period: 3 "
            f"attn_chunked + 1 attn_nope, MoE 16 experts top-1), {param_bytes / 1e9:.2f} GB of "
            f"parameters, peak {peak / 1e9:.2f} GB allocated, on {card}: forward B1 S{A12_SEQ} "
            f"kernel {fwd['kernel'][2]:.2f} s, plain {fwd['plain'][2]:.2f} s, max|Δlogit| at "
            f"positions {rows.tolist()} {logit_err[0]:.2e} / {logit_err[1]:.2e} (bound "
            f"{LOGIT_TOL}); aux {fwd['kernel'][1]} (plain {fwd['plain'][1]}), MoE dropped "
            f"fraction {dropped:.4f} per layer; K1 chunked at S {s}: max|Δ| {k1_err:.2e}, kernel "
            f"{k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms, sdpa with the boolean mask "
            f"{k1_lib_ms:.3f} ms, " + _fmt_bounds(k1_bounds, k1_ops, {"kernel f32": k1_ms})
            + f"; serving {len(reqs)} requests (prompts {[len(r) for r in reqs]}, {n_new} new, "
            f"max_batch 4, max_len 256, captured): {'; '.join(report)}; "
            + "; ".join(d_[1] for d_ in direct.values()) + f"; {bd}")
    return text, launched, k1_row, {"flashd_decode": direct["contiguous"][0],
                                    "flashd_decode_paged": direct["paged"][0]}


def _served_direct(layer: dict, q, n_sm: int, loop: str, reads, what: str, gen=None,
                   flush=None, local: bool = False):
    """One kernel on one layer of a served engine's cache, at the engine's
    shapes, against its plain version in the kernel's split order (outside
    the counted runs). q [B, Hq, d]; the layer's leaves carry the stacked
    layer axis.

      * contiguous: K2 on the layer's cache or ring, each row read at
        position `reads[i]` over pos % len + 1 slots (a chunked ring; with
        `local`, min(pos + 1, len) slots: a local-attention ring) with no
        window or chunk passed, as the decode step reads a ring;
      * paged: K3 on the layer's pool through a block table over its pages,
        cache lengths `reads`;
      * mixed: K4 on the same kind of pool with a mixed step's pack (the
        engine's packer, `pack_plan`): a decode row at each position of
        `reads` and a 16-row prefill chunk at positions 96–111 of one more
        slot; rows drawn from `gen`.

    With `flush`, also the kernel's device time (graph replays,
    `_graph_ms`), the plain version's and one SDPA call's over the same keys
    with a boolean mask (CUDA events; the gather is set-up), and the bound:
    the live keys and values, q and o, over the HBM rate (f32).
    Returns (max|Δ|, a report, the timing row or None)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.attention import gather_pages
    from repro_torch.kernels import flashd_decode as k2
    from repro_torch.kernels import flashd_varlen as k4
    from repro_torch.kernels.tuning import bucket_pow2, choose_varlen_blocks
    from repro_torch.serve.engine import pack_plan
    from repro_torch.serve.scheduler import Segment, StepPlan

    b, hq, d = q.shape
    dev = q.device
    if loop == "contiguous":
        kc, vc = (layer[x][0].transpose(1, 2) for x in ("k", "v"))  # [B, Hkv, len, d]
        hkv, n = kc.shape[1], kc.shape[2]
        pos = torch.tensor(reads, device=dev)[:b]
        eff = (torch.clamp(pos + 1, max=n) if local else pos % n + 1).to(torch.int32)
        call = lambda: k2.flashd_decode(q, kc, vc, eff)
        plain = lambda: k2.flashd_decode_plain(q, kc, vc, eff,
                                               n_splits=k2.gpu_decode_splits(b, hkv, n, n_sm))
        qs, kg, vg, lens, live = q[:, :, None], kc, vc, eff, int(eff.sum())
        rows, n_q = None, b
        label = (f"K2 on {what} (B{b} Hq{hq} Hkv{hkv} d{d}, {n} slots, positions "
                 f"{pos.tolist()} read over {eff.tolist()} slots)")
    else:
        kp, vp = layer["k_pages"][0], layer["v_pages"][0]  # [P, page, Hkv, d]
        n_pages, page, hkv = kp.shape[0], kp.shape[1], kp.shape[2]
        n_tbl = layer["tbl"].shape[-1]
        n_seq = b if loop == "paged" else len(reads) + 1
        tbl = (torch.arange(n_seq * n_tbl, device=dev) % (n_pages - 1) + 1).to(torch.int32)
        tbl = tbl.reshape(n_seq, n_tbl)
        if loop == "paged":
            lens = torch.tensor(reads, dtype=torch.int32, device=dev)[:b]
            call = lambda: k2.flashd_decode_paged(q, kp, vp, tbl, lens)
            plain = lambda: k2.flashd_decode_paged_plain(
                q, kp, vp, tbl, lens, n_splits=k2.gpu_decode_splits(b, hkv, n_tbl * page, n_sm))
            qs, rows, n_q, live = q[:, :, None], None, b, int(lens.sum())
            label = (f"K3 on {what} (B{b} Hq{hq} Hkv{hkv} d{d}, {n_pages} pages of {page}, "
                     f"{n_tbl} a row, lengths {lens.tolist()})")
        else:
            one = lambda n_, st: Segment(slot=n_, tokens=np.zeros(1, np.int32), start=st,
                                         emits=True)
            plan = StepPlan(segments=tuple(one(i, st) for i, st in enumerate(reads)) + (
                Segment(slot=len(reads), tokens=np.zeros(16, np.int32), start=96, emits=False),),
                n_tokens=len(reads) + 16)
            bq = choose_varlen_blocks(bucket_pow2(plan.n_tokens, lo=8), d, d, group=hq // hkv,
                                      page=page, segment_hint=1).block_q
            _, sid_np, qpos_np, kvl_np, _ = pack_plan(plan, bq, n_seq)
            sid, qp = torch.as_tensor(sid_np, device=dev), torch.as_tensor(qpos_np, device=dev)
            kvl = torch.as_tensor(kvl_np, device=dev)
            qv = torch.randn(len(sid_np), hq, d, generator=gen, device=dev)
            call = lambda: k4.flashd_varlen(qv, kp, vp, tbl, sid, qp, kvl, block_q=bq)
            plain = lambda: k4.flashd_varlen_plain(qv, kp, vp, tbl, sid, qp, kvl, block_q=bq)
            rows = torch.clamp(sid.long(), min=0)
            qs, lens, n_q, live = qv[:, :, None], kvl, int((qp >= 0).sum()), int(kvl.sum())
            label = (f"K4 on {what} (T{len(sid_np)} block_q {bq}: {len(reads)} decode rows at "
                     f"{list(reads)} + a 16-row chunk; Hq{hq} Hkv{hkv} d{d}, {n_pages} pages of "
                     f"{page}, kv_len {kvl_np.tolist()})")
        if flush is not None:  # SDPA's keys: the pages gathered per sequence (set-up)
            kg, vg = (gather_pages(x, tbl).transpose(1, 2) for x in (kp, vp))
            if rows is not None:
                kg, vg = kg[rows], vg[rows]
    o, o_p = call(), plain()
    err = _err(o, o_p)
    assert torch.isfinite(o).all() and err <= F32_TOL, (label, err)
    report = f"{label}: max|Δ| against plain {err:.2e} (bound {F32_TOL})"
    if flush is None:
        return err, report, None
    at = torch.arange(kg.shape[2], device=dev)
    if rows is None:  # one query row per sequence: keys before its length
        vis, pairs = (at[None] < lens.long()[:, None])[:, None, None], live
    else:  # packed rows: causal within the row's sequence
        qpl = qp.long()
        keep = (at[None] <= qpl[:, None]) & (at[None] < kvl.long()[rows][:, None])
        vis, pairs = keep[:, None, None], int(keep[qpl >= 0].sum())
    lib = lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=vis, enable_gqa=True)
    row = {"device_ms": _graph_ms(call, flush), "plain_ms": _time_ms(plain, reps=3, flush=flush),
           "library_ms": _time_ms(lib, flush=flush),
           "bound_ms": _bytes_bound(2 * live * hkv * d * 4 + 2 * n_q * hq * d * 4,
                                    4 * d * hq * pairs),
           "max_abs_err": err, "shape": label}
    del kg, vg
    return err, (f"{report}; device {row['device_ms'] * 1e3:.2f} us (graph replays), plain "
                 f"{row['plain_ms']:.3f} ms, sdpa with a boolean mask "
                 f"{row['library_ms'] * 1e3:.2f} us, byte bound {row['bound_ms'] * 1e3:.2f} us"), row


PHI3_SEQ = 2048  # phase 19: K1 / K5 / K6's S, and the forward's (256 patch rows + 1792 tokens)
PHI3_TRAIN_TEXT = 1024  # phase 19's train step: B 1, 256 patch rows + 1024 tokens
# phase 19's train depth: at most TRAIN_COPIES copies of the cut stack's
# parameters live at once in a step (the parameters, two AdamW moments, the
# gradients and their clipped copy, the new parameters and moments, the
# numerics guard's selected trees), within TRAIN_MEM_SHARE of the card's memory
TRAIN_COPIES, TRAIN_MEM_SHARE = 10, 0.75
MAMBA2_SEQ = 512  # phase 19's mamba2 forward and decode chain: B 2 x S 512


def _ptxas_hd(name: str, tag: str) -> str:
    """Registers and spill bytes of the kernels of one library whose mangled
    name holds `tag` (a template argument: 'Li96E' for head dim 96), read
    from the build's ptxas log."""
    import re

    from repro_torch.kernels import _build

    regs, stores, loads, fn = [], 0, 0, ""
    for ln in _build.lib_path(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'|Function properties for (\S+)", ln)
        if m:
            fn = m.group(1) or m.group(2)
        if tag not in fn:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            stores, loads = stores + int(m.group(1)), loads + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            regs.append(int(m.group(1)))
    if not regs:
        return "no kernel"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, spill stores {stores} B, "
            f"loads {loads} B")


def _attn_kernels(dev, flush, *, b: int, hq: int, hkv: int, d: int, sq: int, skv: int,
                  mask: str, seed: int, window: int = 0):
    """K1, K6 and K5 at one attention shape ([B, H, S, d]
    views of model-layout tensors, Sq query rows against Skv keys, the
    `mask` kind 'full', or 'causal' or 'local' (of `window` keys) at Sq =
    Skv) against their plain versions: O and Λ within F32_TOL in f32 (K6's
    O against K1's too), O within BF16_TOL in bf16; dQ, dK, dV within
    GRAD_RTOL / GRAD_ATOL per entry in f32 and GRAD_BF16·max|grad| in bf16;
    a repeat call of each kernel bitwise equal. Each timed (CUDA events, L2
    flushed) in both dtypes beside its plain version (f32), one SDPA call in
    the same dtype (its backward for K5; a local mask as a boolean one over
    the kv heads repeated for the group) and its bounds. Returns ({kernel
    name: row}, report)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.blockwise import MaskSpec
    from repro_torch.kernels import fa2_fwd as k6
    from repro_torch.kernels import flashd_bwd as k5
    from repro_torch.kernels import flashd_fwd as k1

    causal, local = mask == "causal", mask == "local"
    assert not (causal or local) or sq == skv, "SDPA's is_causal aligns a causal mask top-left"
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = MaskSpec(mask, window=window)
    # q, k, v, dO as [B, H, S, d] views of model-layout tensors
    x32 = [torch.randn(b, s_, h, d, generator=gen, device=dev).transpose(1, 2)
           for s_, h in ((sq, hq), (skv, hkv), (skv, hkv), (sq, hq))]
    if local:  # row i sees min(i + 1, window) keys
        w = min(window, sq)
        pairs = b * (w * (w + 1) // 2 + (sq - w) * w)
        at = torch.arange(sq, device=dev)
        vis = (at[None] <= at[:, None]) & (at[:, None] - at[None] < window)
    else:
        pairs = b * (sq * (sq + 1) // 2 if causal else sq * skv)
    shape = (f"B{b} Hq{hq} Hkv{hkv} d{d} Sq{sq} Skv{skv} {mask}"
             f"{f' {window}' if local else ''}, f32 (3xTF32 on the tensor cores) and bf16")
    elems = 2 * b * sq * hq * d + 2 * b * skv * hkv * d  # q, O; k, v
    k5_elems = b * d * (4 * sq * hq + 4 * skv * hkv)  # q, O, dO, dQ; k, v, dK, dV
    ops = {"fwd": 4 * d * hq * pairs, "bwd": 10 * d * hq * pairs}
    lam_bytes = 4 * b * hq * sq
    bounds = {"fwd": _attn_bounds(ops["fwd"], 4 * elems + lam_bytes, 2 * elems + lam_bytes),
              "bwd": _attn_bounds(ops["bwd"], 4 * k5_elems + lam_bytes,
                                  2 * k5_elems + lam_bytes)}
    rows, report = {}, []
    kernels = [("flashd_fwd", k1.flashd_fwd, k1.flashd_fwd_plain, "fwd"),
               ("fa2_fwd", k6.fa2_fwd, k6.fa2_fwd_plain, "fwd"),
               ("flashd_bwd", k5.flashd_bwd, k5.flashd_bwd_plain, "bwd")]
    for name, kern, plain, kind in kernels:
        row = {}
        for dt, tag in ((torch.float32, ""), (torch.bfloat16, "bf16_")):
            q, k, v, do = (x.to(dt) for x in x32)
            if kind == "fwd":
                args = (q, k, v)
                (o, lam), (o_p, lam_p) = kern(*args, mask=spec), plain(*args, mask=spec)
                if dt == torch.float32:
                    err = max(_err(o, o_p), _err(lam, lam_p))
                    if name == "fa2_fwd":
                        err = max(err, _err(o, k1.flashd_fwd(*args, mask=spec)[0]))
                    ok = err <= F32_TOL
                else:
                    err = _err(o, o_p)
                    ok = err <= BF16_TOL
                o2, lam2 = kern(*args, mask=spec)
                ok = ok and bool(torch.isfinite(o).all()) and torch.equal(o, o2) and torch.equal(
                    lam, lam2)
                del o2, lam2
                if local:
                    lib_x = (q.contiguous(), *(x.repeat_interleave(hq // hkv, dim=1).contiguous()
                                               for x in (k, v)))
                    lib = lambda: F.scaled_dot_product_attention(*lib_x, attn_mask=vis)
                else:
                    lib_x = tuple(x.contiguous() for x in args)
                    lib = lambda: F.scaled_dot_product_attention(*lib_x, is_causal=causal,
                                                                 enable_gqa=True)
            else:
                args = (q, k, v, *k1.flashd_fwd_plain(q, k, v, mask=spec), do)
                got, want = kern(*args, mask=spec), plain(*args, mask=spec)
                err, ok = 0.0, True
                for a, w in zip(got, want):
                    diff = (a.float() - w.float()).abs()
                    if dt == torch.float32:
                        ok = ok and bool((diff <= GRAD_ATOL + GRAD_RTOL * w.float().abs()).all())
                    else:
                        ok = ok and float(diff.max()) <= GRAD_BF16 * float(w.float().abs().max())
                    ok = ok and bool(torch.isfinite(a).all())
                    err = max(err, float(diff.max()))
                ok = ok and all(torch.equal(a, a2) for a, a2 in zip(got, kern(*args, mask=spec)))
                del got, want
                # detached: at Hkv 1 the view is contiguous, and its grad flag would stick
                q_l, k_l, v_l = (x.detach().contiguous().requires_grad_() for x in (q, k, v))
                if local:  # the kv heads repeated inside the graph: their gradients summed
                    o_l = F.scaled_dot_product_attention(
                        q_l, *(x.repeat_interleave(hq // hkv, dim=1) for x in (k_l, v_l)),
                        attn_mask=vis)
                else:
                    o_l = F.scaled_dot_product_attention(q_l, k_l, v_l, is_causal=causal,
                                                         enable_gqa=True)
                do_l = do.contiguous()
                lib = lambda: torch.autograd.grad(o_l, (q_l, k_l, v_l), do_l, retain_graph=True)
            assert ok, (name, shape, dt, err)
            row[f"{tag}max_abs_err"] = err
            row[f"{tag}ms"] = _time_ms(lambda: kern(*args, mask=spec), flush=flush)
            row[f"{tag}library_ms"] = _time_ms(lib, flush=flush)
            if dt == torch.float32:
                row["plain_ms"] = _time_ms(lambda: plain(*args, mask=spec), reps=3, flush=flush)
            del args, lib
        row["bound_ms"], row["bound_by"] = bounds[kind]["3xtf32"]
        row["bf16_bound_ms"] = bounds[kind]["bf16"][0]
        row["shape"] = shape
        rows[name] = row
        report.append(
            f"{name} max|Δ| f32 {row['max_abs_err']:.2e}, bf16 {row['bf16_max_abs_err']:.2e}; "
            f"kernel {row['ms']:.4f} / {row['bf16_ms']:.4f} ms (f32 / bf16), plain "
            f"{row['plain_ms']:.3f} ms, sdpa{' backward' if kind == 'bwd' else ''} "
            f"{row['library_ms']:.4f} / {row['bf16_library_ms']:.4f} ms; "
            + _fmt_bounds(bounds[kind], ops[kind], {"kernel f32": row["ms"],
                                                    "kernel bf16": row["bf16_ms"]}))
    text = (f"K1, K6, K5 at {shape} against plain (bounds: f32 O, Λ "
            f"{F32_TOL}, gradients rtol {GRAD_RTOL} atol {GRAD_ATOL}; bf16 O {BF16_TOL}, "
            f"gradients {GRAD_BF16:.4f}·max|grad|; repeats bitwise equal): "
            + "; ".join(report))
    return rows, text


def _train_paths(cfg, tc, state, batch, label: str):
    """One train step from `state` on the kernel (K1 + K5), plain and FA2
    (K6 + K5) paths of `cfg`, the launch counters set to 0 just before
    each: the plain path launches nothing; the kernel and FA2 paths launch
    their forward kernel and K5, not the other forward; loss and grad norm
    within TRAIN_REL[0] of plain. Returns ({path: (loss, grad norm,
    seconds)}, {path: launches}) — phases 19, 20 and 21."""
    import numpy as np
    import torch

    from repro_torch.train import make_train_step

    train, launched = {}, {}
    for name, impl in (("kernel", "flashd_gpu"), ("plain", "flashd_plain"), ("fa2", "fa2_gpu")):
        step = make_train_step(dataclasses.replace(cfg, attn_impl=impl), tc)
        torch.cuda.synchronize()
        _zero_launches()
        t = time.perf_counter()
        new, m = step(state, batch)
        loss, gnorm = torch.stack([m["loss"], m["grad_norm"]]).tolist()
        train[name] = (loss, gnorm, time.perf_counter() - t)
        got = launched[name] = _launches()
        del new, m, step
        if name == "plain":
            assert sum(got.values()) == 0, (f"{label} train: the plain path launched", got)
        else:
            fwd, other = (("flashd_fwd", "fa2_fwd") if name == "kernel"
                          else ("fa2_fwd", "flashd_fwd"))
            assert got[fwd] > 0 and got["flashd_bwd"] > 0 and got[other] == 0, (label, name, got)
    for name in ("kernel", "fa2"):
        for i, what in ((0, "loss"), (1, "grad norm")):
            x, y = train[name][i], train["plain"][i]
            assert np.isfinite(x) and abs(x - y) <= TRAIN_REL[0] * abs(y), (label, name, what, x, y)
    return train, launched


def _phi3_phase(dev, card: str, flush):
    """Phase 19, phi-3-vision-4.2b at full width (d 3072, Hq = Hkv = 32 of
    head dim 96, d_ff 8192, vocab 32064, 256 patch rows), f32, seeded random
    weights:

      * K1, K6 and K5 at its attention shape (B 1, Hq = Hkv = 32, head dim
        96, S PHI3_SEQ, causal; `_attn_kernels`);
      * one train step with `patch_embeds` (B 1, 256 patch rows + 1024
        tokens) on the kernel path (K1 + K5), the plain path and the FA2
        path (K6 + K5) from the same seeded weights: loss and grad norm
        within TRAIN_REL[0] of plain. The stack is cut to the depth whose
        train state fits the card (TRAIN_COPIES, TRAIN_MEM_SHARE);
      * the forward at all 32 layers, 256 patch rows + 1792 tokens, kernel
        against plain: the last position's logits within LOGIT_TOL;
      * serving text (6 requests on 4 slots, prompts 32–128, 16 new,
        max_len 256) through the captured contiguous, paged and mixed loops
        on the kernel and the plain path: tokens identical; K2, K3, K4
        launched, each also held to plain on the served engine's cache,
        pool or a pack over its pool (`_served_direct`, timed); a captured
        decode step's breakdown.

    Counts are reset just before each kernel-path run. Returns (report,
    launches per kernel over the kernel-path runs, {kernel: phi3_d96_* row})."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.transformer import apply_lm, decode_step_lm, init_decode_cache, init_lm
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.graphs import StepGraphs
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("phi-3-vision-4.2b"), dtype="float32")
    plain_cfg = dataclasses.replace(cfg, attn_impl="flashd_plain")
    attn_rows, attn_text = _attn_kernels(dev, flush, b=1, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                                         d=cfg.head_dim_, sq=PHI3_SEQ, skv=PHI3_SEQ,
                                         mask="causal", seed=19)
    rows = {kernel: {f"phi3_d96_{key}": val for key, val in row.items()}
            for kernel, row in attn_rows.items()}

    counts, reset = _launches, _zero_launches
    launched = dict.fromkeys(counts(), 0)

    def add(got):
        for key in launched:
            launched[key] += got[key]

    gen = torch.Generator(device=dev).manual_seed(191)
    patches = lambda n: torch.randn(n, cfg.frontend_tokens, cfg.d_model, generator=gen, device=dev)

    # one train step, the stack cut to the depth whose train state fits
    total = torch.cuda.get_device_properties(dev).total_memory
    one = dataclasses.replace(cfg, n_layers=1).param_count()
    per_layer = dataclasses.replace(cfg, n_layers=2).param_count() - one
    n_train = min(cfg.n_layers, int((TRAIN_MEM_SHARE * total / (TRAIN_COPIES * 4)
                                     - (one - per_layer)) // per_layer))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=PHI3_TRAIN_TEXT,
                                  global_batch=1, seed=0)).batch(0)
    batch = {k_: torch.as_tensor(x, device=dev) for k_, x in data.items()}
    batch["patch_embeds"] = patches(1)
    tc = TrainConfig(warmup_steps=0, total_steps=4)  # the lr peaks at step 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c = dataclasses.replace(cfg, n_layers=n_train)
    train, got = _train_paths(c, tc, init_train_state(c, tc, device=dev, seed=0), batch, "phi-3")
    add(got["kernel"])
    add(got["fa2"])
    train_peak = torch.cuda.max_memory_allocated()
    train_text = (
        f"train step B1 x ({cfg.frontend_tokens} patch rows + {PHI3_TRAIN_TEXT} tokens), "
        f"{n_train} of {cfg.n_layers} layers (the depth whose {TRAIN_COPIES} copies of the "
        f"parameters fit {TRAIN_MEM_SHARE} of the card's {total / 1e9:.1f} GB; peak "
        f"{train_peak / 1e9:.2f} GB allocated): loss / grad norm kernel {train['kernel'][:2]}, "
        f"fa2 {train['fa2'][:2]}, plain {train['plain'][:2]} (bound {TRAIN_REL[0]} relative); "
        f"seconds kernel {train['kernel'][2]:.2f}, fa2 {train['fa2'][2]:.2f}, plain "
        f"{train['plain'][2]:.2f}")

    # the forward at full depth, patch rows first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(cfg, device=dev, seed=0)
    param_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    rng = np.random.default_rng(19)
    fb = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                 (1, PHI3_SEQ - cfg.frontend_tokens)), device=dev),
          "patch_embeds": patches(1)}
    fwd = {}
    for name, c in (("kernel", cfg), ("plain", plain_cfg)):
        reset()
        with torch.inference_mode():
            t = time.perf_counter()
            logits, _ = apply_lm(params, fb, c, last_only=True)
            torch.cuda.synchronize()
            fwd[name] = (logits[0, -1, :cfg.vocab_size], time.perf_counter() - t)
        got = counts()
        if name == "kernel":
            assert got["flashd_fwd"] == cfg.n_layers, got
            add(got)
        else:
            assert sum(got.values()) == 0, ("phi-3 forward: the plain path launched a kernel", got)
    logit_err = _err(fwd["kernel"][0], fwd["plain"][0])
    assert logit_err <= LOGIT_TOL, ("phi-3 logits", logit_err)

    # serving text through the three captured loops
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
            for n in (32, 57, 96, 128, 33, 40)]
    n_new = 16
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    qd = torch.randn(4, cfg.n_heads, cfg.head_dim_, generator=gen, device=dev)
    loops = {"contiguous": ({}, "flashd_decode", (150, 0, 255, 76), "the first layer's cache"),
             "paged": (dict(kv_layout="paged"), "flashd_decode_paged", (150, 1, 256, 77),
                       "the first layer's pool"),
             "mixed": (dict(step_mode="mixed"), "flashd_varlen", (150, 221, 100),
                       "the first layer's pool")}
    report, direct, first = [], {}, None
    for loop, (kw, kernel, reads, what) in loops.items():
        sc = ServeConfig(max_batch=4, max_len=256, **kw)
        runs = {}
        for name, c in (("kernel", cfg), ("plain", plain_cfg)):
            eng = Engine(params, c, sc, device=dev)
            reset()
            t = time.perf_counter()
            out = eng.serve(reqs, n_new)
            torch.cuda.synchronize()
            runs[name] = (out, time.perf_counter() - t, float(np.mean(list(eng.ttft.values()))),
                          counts(), eng._steps.captures)
            if eng._alloc is not None:
                eng._alloc.check()
            if name == "kernel":
                layer = (eng._contig[4] if loop == "contiguous" else eng._paged).cache["blocks"]
                with torch.inference_mode():
                    direct[kernel] = _served_direct(layer["pos0"], qd, n_sm, loop, reads, what,
                                                    gen=gen, flush=flush)
            del eng
        (out, dt, ttft, got, graphs), plain = runs["kernel"], runs["plain"]
        for a, b_ in zip(out, plain[0]):
            assert np.array_equal(a, b_), f"phi-3 {loop}: kernel and plain tokens differ"
        assert sum(plain[3].values()) == 0, f"phi-3 {loop}: the plain path launched a kernel"
        assert got[kernel] > 0, (loop, got)
        add(got)
        first = out if first is None else first
        n_tok = sum(map(len, out))
        report.append(f"{loop}: tokens identical kernel = plain, against the contiguous loop's "
                      f"{_agreement(out, first)}; {n_tok / dt:.1f} tok/s (plain "
                      f"{n_tok / plain[1]:.1f}), mean TTFT {ttft * 1e3:.1f} ms (plain "
                      f"{plain[2] * 1e3:.1f}), {graphs} graphs captured; launches {got}")
    cache = init_decode_cache(4, 256, cfg, device=dev)
    tok4 = torch.zeros(4, dtype=torch.long, device=dev)
    at = torch.full((4,), 150, dtype=torch.long, device=dev)
    steps, captured = StepGraphs(dev, graphs=True), {}
    bd = _breakdown("captured decode step B4 pos150",
                    lambda: steps.run(captured, "decode",
                                      lambda: decode_step_lm(params, cache, tok4, at, cfg)),
                    watch=("decode_kernel",))
    del steps, captured, cache, params
    peak = torch.cuda.max_memory_allocated()
    for kernel, (_, _, row) in direct.items():
        rows[kernel] = {f"phi3_d96_{key}": val for key, val in row.items()}
    text = (f"phi-3-vision-4.2b f32 full width (d {cfg.d_model}, Hq = Hkv = {cfg.n_heads}, head dim "
            f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), on {card}: {attn_text}; "
            f"{train_text}; {cfg.n_layers} layers, {param_bytes / 1e9:.2f} GB of parameters, peak "
            f"{peak / 1e9:.2f} GB allocated: forward B1 x ({cfg.frontend_tokens} patch rows + "
            f"{PHI3_SEQ - cfg.frontend_tokens} tokens) kernel {fwd['kernel'][1]:.2f} s, plain "
            f"{fwd['plain'][1]:.2f} s, last position max|Δlogit| {logit_err:.2e} (bound "
            f"{LOGIT_TOL}); serving {len(reqs)} text requests (prompts {[len(r) for r in reqs]}, "
            f"{n_new} new, max_batch 4, max_len 256, captured): {'; '.join(report)}; "
            + "; ".join(d_[1] for d_ in direct.values()) + f"; {bd}")
    return text, launched, rows


def _mamba2_phase(dev, card: str):
    """Phase 19, mamba2-2.7b at full width and depth (64 `ssm` layers, d
    2560, 80 heads of 64, state 128, chunk 64, vocab 50280), f32, seeded
    random weights; it runs no FLASH-D kernel (attention-free):

      * the chunked forward (B 2 x S MAMBA2_SEQ) against the step-by-step
        decode chain from a zeroed cache (each step a captured graph
        replay): the last position's logits within LOGIT_TOL;
      * 6 requests on 4 slots (prompts 16–40, 16 new, max_len 128) through
        the contiguous loop captured and eager: tokens, host syncs equal; a
        paged engine serves them on the contiguous loop (no pool), the
        same tokens, and a mixed one takes no packed step; no kernel
        launched; a captured decode step's breakdown.

    Returns the report."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import fa2_fwd as k6
    from repro_torch.kernels import flashd_bwd as k5
    from repro_torch.kernels import flashd_decode as k2
    from repro_torch.kernels import flashd_fwd as k1
    from repro_torch.kernels import flashd_varlen as k4
    from repro_torch.models.transformer import (
        apply_lm,
        decode_hidden_lm,
        decode_step_lm,
        init_decode_cache,
        init_lm,
        logits_lm,
    )
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.graphs import StepGraphs
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("mamba2-2.7b"), dtype="float32")
    counts = lambda: (k1.launches, k2.launches, k2.paged_launches, k4.launches, k5.launches,
                      k6.launches)
    before = counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(cfg, device=dev, seed=0)
    param_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    rng = np.random.default_rng(20)
    b, s, v = 2, MAMBA2_SEQ, cfg.vocab_size
    toks = torch.as_tensor(rng.integers(0, v, (b, s)), device=dev)
    with torch.inference_mode():
        t = time.perf_counter()
        full = apply_lm(params, {"tokens": toks}, cfg, last_only=True)[0][:, -1, :v]
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t
        cache = init_decode_cache(b, s, cfg, device=dev)
        tok, pos = (torch.zeros(b, dtype=torch.long, device=dev) for _ in range(2))
        h = torch.zeros(b, 1, cfg.d_model, device=dev)
        steps, captured = StepGraphs(dev, graphs=True), {}
        step = lambda: h.copy_(decode_hidden_lm(params, cache, tok, pos, cfg))
        t = time.perf_counter()
        for i in range(s):
            tok.copy_(toks[:, i])
            pos.fill_(i)
            steps.run(captured, "step", step)
        chain = logits_lm(params, h, cfg)[:, :v]
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t
        del steps, captured, cache
    err = _err(full, chain)
    assert torch.isfinite(chain).all() and err <= LOGIT_TOL, ("mamba2 chunked vs chain", err)

    reqs = [rng.integers(0, v, (int(n),)).astype(np.int32) for n in (16, 24, 32, 40, 20, 28)]
    n_new, runs = 16, {}
    for name, graphs, kw in (("captured", None, {}), ("eager", False, {}),
                             ("paged", None, dict(kv_layout="paged"))):
        eng = Engine(params, cfg, ServeConfig(max_batch=4, max_len=128, **kw), device=dev,
                     graphs=graphs)
        t = time.perf_counter()
        out = eng.serve(reqs, n_new)
        torch.cuda.synchronize()
        runs[name] = (out, time.perf_counter() - t, eng._steps.captures, eng.host_syncs)
        assert eng._page_layout is None and eng._alloc is None, (name, "took a pool")
        del eng
    mixed = Engine(params, cfg, ServeConfig(max_batch=4, max_len=128, step_mode="mixed"),
                   device=dev)
    assert mixed._page_layout is None and not mixed._mixed_ok and not mixed._cache_on
    del mixed
    out = runs["captured"][0]
    for name in ("eager", "paged"):
        for a, b_ in zip(out, runs[name][0]):
            assert np.array_equal(a, b_), f"mamba2: captured and {name} tokens differ"
    assert runs["captured"][3] == runs["eager"][3] and runs["eager"][2] == 0 < runs["captured"][2]
    assert counts() == before, "mamba2 launched a FLASH-D kernel"
    cache = init_decode_cache(4, 128, cfg, device=dev)
    tok4 = torch.zeros(4, dtype=torch.long, device=dev)
    at = torch.full((4,), 60, dtype=torch.long, device=dev)
    steps, captured = StepGraphs(dev, graphs=True), {}
    bd = _breakdown("captured decode step B4",
                    lambda: steps.run(captured, "decode",
                                      lambda: decode_step_lm(params, cache, tok4, at, cfg)))
    del steps, captured, cache, params
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(map(len, out))
    rate = lambda name: f"{n_tok / runs[name][1]:.1f} tok/s"
    return (f"mamba2-2.7b f32 full width and depth ({cfg.n_layers} ssm layers, d {cfg.d_model}, "
            f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
            f"{cfg.ssm_chunk}, vocab {v}), {param_bytes / 1e9:.2f} GB of parameters, peak "
            f"{peak / 1e9:.2f} GB allocated, on {card}: chunked forward B{b} S{s} {fwd_s:.2f} s "
            f"against the decode chain ({s} captured steps, {chain_s:.2f} s): last position "
            f"max|Δlogit| {err:.2e} (bound {LOGIT_TOL}); serving {len(reqs)} requests (prompts "
            f"{[len(r) for r in reqs]}, {n_new} new, max_batch 4, max_len 128): tokens identical "
            f"captured = eager = a paged engine on the contiguous loop (no pool; a mixed engine "
            f"takes no packed step), host syncs {runs['captured'][3]} = {runs['eager'][3]}, "
            f"captured {rate('captured')} ({runs['captured'][2]} graphs), eager {rate('eager')}, "
            f"paged {rate('paged')}; no FLASH-D kernel launched; {bd}")


SEAMLESS_T, SEAMLESS_S = 1024, 256  # phase 20: audio frames and decoder tokens (B 2)
SEAMLESS_PROMPT, SEAMLESS_NEW = 16, 64  # phase 20's decode chain at B 4


def _encdec_phase(dev, card: str, flush):
    """Phase 20, seamless-m4t-medium at full width and depth (12 encoder + 12
    decoder layers, d 1024, Hq = Hkv = 16 of head dim 64, d_ff 4096, vocab
    256206, the audio-frame stub), f32, seeded random weights:

      * K1, K6 and K5 at the encoder's attention shape (B 1, T 1024 against
        T 1024, full) and cross attention's (S 256 against T 1024, full)
        against plain, timed beside SDPA and their bounds (`_attn_kernels`);
      * the forward (`apply_encdec`, B 2, T SEAMLESS_T frames, S SEAMLESS_S
        tokens), kernels against plain: logits within LOGIT_TOL; 36 K1
        launches (12 encoder, 12 causal self, 12 cross at Sq ≠ Skv);
      * one train step on the kernel (K1 + K5), FA2 (K6 + K5) and plain
        paths from the same state on that batch: loss and grad norm within
        TRAIN_REL[0] of plain, the launches remat 'full' gives; peak memory;
      * `encode` → `fill_cross_cache` → SEAMLESS_PROMPT prompt positions and
        SEAMLESS_NEW greedy tokens of `decode_step_encdec` at B 4, kernels
        and plain: tokens identical, 24 K2 launches a step; the kernel
        path's decode logits against its forward over the same tokens
        within LOGIT_TOL; K2 against plain on the served self cache and on
        the cross cache (cache_len T in every row), timed (`_served_direct`);
      * an eager decode step's breakdown.

    Counts are reset just before each kernel-path run. Returns (report,
    launches per kernel over the kernel-path runs, {kernel: seamless_* row})."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import encdec as ed
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("seamless-m4t-medium"), dtype="float32")
    plain_cfg = dataclasses.replace(cfg, attn_impl="flashd_plain")
    v, dm, t_mem = cfg.vocab_size, cfg.d_model, SEAMLESS_T
    n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers  # K1 calls a forward
    rows, attn_text = {}, []
    for tag, sq in (("enc", t_mem), ("cross", SEAMLESS_S)):
        got, text = _attn_kernels(dev, flush, b=1, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                                  d=cfg.head_dim_, sq=sq, skv=t_mem, mask="full", seed=20)
        for kernel, row in got.items():
            rows.setdefault(kernel, {}).update({f"seamless_{tag}_{k}": x for k, x in row.items()})
        attn_text.append(f"{tag}: {text}")
    launched = dict.fromkeys(_launches(), 0)

    def add(got):
        for key in launched:
            launched[key] += got[key]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = ed.init_encdec(cfg, device=dev, seed=0)
    param_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(20)
    rng = np.random.default_rng(20)
    batch = {"frame_embeds": torch.randn(2, t_mem, dm, generator=gen, device=dev),
             "tokens": torch.as_tensor(rng.integers(0, v, (2, SEAMLESS_S)), device=dev),
             "labels": torch.as_tensor(rng.integers(0, v, (2, SEAMLESS_S)), device=dev)}

    # the forward, kernels against plain
    fwd = {}
    for name, c in (("kernel", cfg), ("plain", plain_cfg)):
        _zero_launches()
        with torch.inference_mode():
            t = time.perf_counter()
            logits = ed.apply_encdec(params, batch, c)[0][..., :v]
            torch.cuda.synchronize()
            fwd[name] = (logits, time.perf_counter() - t)
        got = _launches()
        if name == "kernel":
            assert got["flashd_fwd"] == n_attn and sum(got.values()) == n_attn, got
            add(got)
        else:
            assert sum(got.values()) == 0, ("seamless forward: the plain path launched", got)
    logit_err = _err(fwd["kernel"][0], fwd["plain"][0])
    assert torch.isfinite(fwd["kernel"][0]).all() and logit_err <= LOGIT_TOL, logit_err
    fwd_s = {name: x[1] for name, x in fwd.items()}
    del fwd, logits

    # one train step on each path from the same state
    tc = TrainConfig(warmup_steps=0, total_steps=4)  # the lr peaks at step 0
    train, got = _train_paths(cfg, tc, init_train_state(cfg, tc, params=params), batch,
                              "seamless")
    for name, fwd_k in (("kernel", "flashd_fwd"), ("fa2", "fa2_fwd")):
        # remat 'full': each block's forward runs again in the backward
        n = got[name]
        assert n[fwd_k] == 2 * n_attn and n["flashd_bwd"] == n_attn, (name, n)
        assert sum(n.values()) == 3 * n_attn, (name, n)
        add(n)
    train_peak = torch.cuda.max_memory_allocated()

    # the decode chain: encode, the cross cache, a prompt, greedy tokens
    b, n_prompt = 4, SEAMLESS_PROMPT
    n_steps = n_prompt + SEAMLESS_NEW - 1  # the last new token is not fed back
    max_len = n_steps + 17  # a self cache longer than the chain
    frames = torch.randn(b, t_mem, dm, generator=gen, device=dev)
    prompt = torch.as_tensor(rng.integers(0, v, (b, n_prompt)), device=dev)
    chains = {}
    for name, c in (("kernel", cfg), ("plain", plain_cfg)):
        _zero_launches()
        per_step, step_logits, new_toks = set(), [], []
        with torch.inference_mode():
            t = time.perf_counter()
            cache = ed.fill_cross_cache(params, ed.encode(params, frames, c),
                                        ed.init_encdec_cache(b, max_len, 8, c, device=dev), c)
            tok = prompt[:, 0]
            for i in range(n_steps):
                before = _launches()["flashd_decode"]
                lg, cache = ed.decode_step_encdec(params, cache, tok,
                                                  torch.full((b,), i, device=dev), c)
                per_step.add(_launches()["flashd_decode"] - before)
                lg = lg[:, :v]
                step_logits.append(lg)
                if i + 1 >= n_prompt:
                    new_toks.append(lg.argmax(-1))
                tok = prompt[:, i + 1] if i + 1 < n_prompt else new_toks[-1]
            torch.cuda.synchronize()
            chains[name] = (torch.stack(new_toks, 1), time.perf_counter() - t, cache,
                            torch.stack(step_logits, 1))
        del step_logits
        got = _launches()
        if name == "kernel":
            assert per_step == {2 * cfg.n_layers}, ("K2 launches a step", per_step)
            assert got["flashd_decode"] == 2 * cfg.n_layers * n_steps, got
            assert got["flashd_fwd"] == cfg.n_encoder_layers, got  # encode
            add(got)
        else:
            assert sum(got.values()) == 0, ("seamless decode: the plain path launched", got)
    toks, chain_s, cache, step_logits = chains["kernel"]
    plain_chain_s = chains["plain"][1]
    assert toks.shape == (b, SEAMLESS_NEW) and torch.equal(toks, chains["plain"][0]), \
        "seamless decode: kernel and plain tokens differ"
    assert cache["cross_k"].shape[2] == t_mem  # the memory's length, not the buffer's 8
    with torch.inference_mode():  # teacher-forced: the forward over the fed tokens
        fed = torch.cat([prompt, toks[:, :-1]], 1)
        full = ed.apply_encdec(params, {"frame_embeds": frames, "tokens": fed}, cfg)[0][..., :v]
        tf_err = _err(full, step_logits)
        del full, step_logits
        assert tf_err <= LOGIT_TOL, ("seamless decode vs forward", tf_err)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        qd = torch.randn(b, cfg.n_heads, cfg.head_dim_, generator=gen, device=dev)
        direct = {
            "self": _served_direct({"k": cache["self_k"], "v": cache["self_v"]}, qd, n_sm,
                                   "contiguous", (n_steps - 1, 40, n_prompt - 1, 0),
                                   "the first decoder layer's self cache", flush=flush),
            "cross": _served_direct({"k": cache["cross_k"], "v": cache["cross_v"]}, qd, n_sm,
                                    "contiguous", (t_mem - 1,) * b,
                                    "the first decoder layer's cross cache", flush=flush)}
    for tag, (_, _, row) in direct.items():
        rows.setdefault("flashd_decode", {}).update(
            {f"seamless_{tag}_{k}": x for k, x in row.items()})
    tok4 = torch.zeros(b, dtype=torch.long, device=dev)
    at = torch.full((b,), 40, dtype=torch.long, device=dev)
    bd = _breakdown(f"eager decode step B{b} pos40 (self cache {max_len}, cross cache {t_mem})",
                    lambda: ed.decode_step_encdec(params, cache, tok4, at, cfg),
                    watch=("decode_kernel",))
    del cache, chains, params, batch
    peak = torch.cuda.max_memory_allocated()
    tr = lambda name: f"{train[name][:2]} in {train[name][2]:.2f} s"
    n_new = b * SEAMLESS_NEW
    return (f"seamless-m4t-medium f32 full width and depth ({cfg.n_encoder_layers} encoder + "
            f"{cfg.n_layers} decoder layers, d {dm}, Hq = Hkv = {cfg.n_heads} of head dim "
            f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {v}), {param_bytes / 1e9:.2f} GB of "
            f"parameters, peak {peak / 1e9:.2f} GB allocated, on {card}: "
            + "; ".join(attn_text)
            + f"; forward B2 x (T {t_mem} frames, S {SEAMLESS_S} tokens) kernel "
            f"{fwd_s['kernel']:.2f} s, plain {fwd_s['plain']:.2f} s, {n_attn} K1 launches, "
            f"max|Δlogit| {logit_err:.2e} (bound {LOGIT_TOL}); train step on that batch, loss / "
            f"grad norm kernel {tr('kernel')}, fa2 {tr('fa2')}, plain {tr('plain')} (bound "
            f"{TRAIN_REL[0]} relative), peak {train_peak / 1e9:.2f} GB allocated; decode B{b}: "
            f"encode, fill_cross_cache, {n_prompt} prompt positions and {SEAMLESS_NEW} greedy "
            f"tokens, tokens identical kernel = plain, {2 * cfg.n_layers} K2 launches a step, "
            f"kernel {n_new / chain_s:.1f} tok/s ({chain_s:.2f} s), plain "
            f"{n_new / plain_chain_s:.1f} tok/s; teacher-forced against the forward max|Δlogit| "
            f"{tf_err:.2e} (bound {LOGIT_TOL}); "
            + "; ".join(d_[1] for d_ in direct.values()) + f"; {bd}"), launched, rows


RGEMMA_SEQ = 4096  # phase 21: K1 / K6's S and the forward's, two local windows of 2048
RGEMMA_MEM_SHARE = 0.7  # its f32 weights' share of the card, beyond which whole periods are cut
RGEMMA_RING_READS = (2100, 4095, 3000, 1500)  # K2 on a 2048-slot ring: three past a wrap
RGEMMA_TRAIN_SEQ = 2560  # phase 21's train step: B 1 x S 2560, past the 2048 window
# phase 21's train state, bytes a parameter live at once in the step with bf16
# AdamW moments and no numerics guard: the parameters, their gradients and the
# new parameters (f32, 4 each), the moments and the new moments (2 + 2 each)
RGEMMA_TRAIN_BYTES = 20
# what the step holds beyond that state at B 1 x S 2560 — activations, AdamW's
# pass temporaries: 2.34 GB over a one-period state measured on an H100 80GB
RGEMMA_TRAIN_HEADROOM = 4e9
QWEN3MOE_LAYERS = 2  # qwen3-moe-235b-a22b's depth cut (of 94): its full width fits the card


def _serve_paths(params, cfg, sc, reqs, n_new: int, dev, paths):
    """`serve` on fresh engines, one per (name, config, graphs) of `paths`,
    the launch counters set to 0 just before each: {name: (tokens, seconds,
    mean TTFT, launches, graphs captured, the engine)}. The caller drops
    the engines it does not keep."""
    import numpy as np
    import torch

    from repro_torch.serve import Engine

    runs = {}
    for name, c, graphs in paths:
        eng = Engine(params, c, sc, device=dev, graphs=graphs)
        _zero_launches()
        t = time.perf_counter()
        out = eng.serve(reqs, n_new)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if eng._alloc is not None:
            eng._alloc.check()
        runs[name] = (out, dt, float(np.mean(list(eng.ttft.values()))), _launches(),
                      eng._steps.captures, eng)
    return runs


def _rgemma_phase(dev, card: str, flush):
    """Phase 21 (a): recurrentgemma-9b at full width (d 4096, Hq 16 over
    Hkv 1 of head dim 256 — a group of 16 —, local window 2048, d_ff 12288,
    vocab 256000, untied head) and depth (38 layers: 12 periods of rglru,
    rglru, attn_local, and 2 rglru), f32, seeded random weights — whole
    periods cut only if its weights would pass RGEMMA_MEM_SHARE of the card:

      * K1, K6 and K5 at its attention shape (B 1, S RGEMMA_SEQ, local 2048)
        in f32 and bf16 against plain, repeats bitwise equal, timed beside
        one SDPA call (K5: its backward) with the local mask as a boolean
        one, and their bounds (`_attn_kernels`);
      * the forward at B 1 × S RGEMMA_SEQ (across the window), kernel path
        against plain path: logits at the window's last position and at the
        last position within LOGIT_TOL (never the [S, V] logits), one K1
        launch per attention layer;
      * serving 6 requests (prompts 32–128, 16 new, 4 slots) on the
        contiguous loop — its only loop: no global layer, so no pool —
        captured, the plain path and an eager kernel engine: tokens
        identical, K2 launched; tok/s, TTFT, a captured decode step's
        breakdown;
      * K2 on a 2048-slot ring of an attention layer filled past a wrap
        (B 4, positions RGEMMA_RING_READS read over min(pos + 1, 2048)
        slots) against plain in the kernel's split order, timed
        (`_served_direct`);
      * one train step at full width (`_rgemma_train`).

    Returns (report, launches per kernel over the kernel-path runs,
    {kernel: rgemma_* row})."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import logits_from_hidden
    from repro_torch.models.transformer import decode_step_lm, forward_hidden, init_decode_cache, init_lm
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.graphs import StepGraphs
    from repro_torch.tree import tree_leaves

    full = dataclasses.replace(get_config("recurrentgemma-9b"), dtype="float32")
    period = len(full.pattern)
    total = torch.cuda.get_device_properties(dev).total_memory
    n_layers = full.n_layers
    while (4 * dataclasses.replace(full, n_layers=n_layers).param_count()
           > RGEMMA_MEM_SHARE * total and n_layers > period):
        n_layers -= period
    cfg = dataclasses.replace(full, n_layers=n_layers)
    plain_cfg = dataclasses.replace(cfg, attn_impl="flashd_plain")
    hq, hkv, d, win = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.attn_window
    attn_rows, attn_text = _attn_kernels(dev, flush, b=1, hq=hq, hkv=hkv, d=d, sq=RGEMMA_SEQ,
                                         skv=RGEMMA_SEQ, mask="local", window=win, seed=21)
    rows = {kernel: {f"rgemma_d256_{key}": val for key, val in row.items()}
            for kernel, row in attn_rows.items()}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_lm(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    param_bytes = sum(x_.numel() * x_.element_size() for x_ in tree_leaves(params))
    launched = dict.fromkeys(_launches(), 0)

    def add(got):
        for key in launched:
            launched[key] += got[key]

    n_attn = sum(m.startswith("attn") for m, _ in (*cfg.pattern * cfg.n_blocks, *cfg.remainder))
    rng = np.random.default_rng(21)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, RGEMMA_SEQ)), device=dev)
    at_rows = torch.tensor([win - 1, RGEMMA_SEQ - 1], device=dev)
    fwd = {}
    for name, c in (("kernel", cfg), ("plain", plain_cfg)):
        _zero_launches()
        with torch.inference_mode():
            t = time.perf_counter()
            h, _ = forward_hidden(params, {"tokens": toks}, c)
            logits = logits_from_hidden(h[:, at_rows], params["lm_head"], cfg.vocab_size)[0]
            torch.cuda.synchronize()
            fwd[name] = (logits[:, :cfg.vocab_size], time.perf_counter() - t)
        del h
        got = _launches()
        if name == "kernel":
            assert got["flashd_fwd"] == n_attn, got
            add(got)
        else:
            assert sum(got.values()) == 0, ("rgemma forward: the plain path launched a kernel", got)
    logit_err = [_err(fwd["kernel"][0][i], fwd["plain"][0][i]) for i in range(2)]
    assert max(logit_err) <= LOGIT_TOL, ("rgemma logits", logit_err)
    fwd_text = (f"forward B1 S{RGEMMA_SEQ} kernel {fwd['kernel'][1]:.2f} s ({n_attn} K1 launches), "
                f"plain {fwd['plain'][1]:.2f} s, max|Δlogit| at positions {at_rows.tolist()} "
                f"{logit_err[0]:.2e} / {logit_err[1]:.2e} (bound {LOGIT_TOL}); peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated by here")
    del fwd

    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
            for n in (32, 57, 96, 128, 33, 40)]
    n_new = 16
    sc = ServeConfig(max_batch=4, max_len=256)
    runs = _serve_paths(params, cfg, sc, reqs, n_new, dev,
                        (("kernel", cfg, None), ("eager", cfg, False), ("plain", plain_cfg, None)))
    (out, dt, ttft, got, graphs), plain = runs["kernel"][:5], runs["plain"][:5]
    for other in ("eager", "plain"):
        for a, b_ in zip(out, runs[other][0]):
            assert np.array_equal(a, b_), f"rgemma: kernel and {other} tokens differ"
    assert runs["eager"][3] == got and runs["eager"][4] == 0 < graphs, "captured vs eager"
    assert sum(plain[3].values()) == 0, "rgemma: the plain path launched a kernel"
    assert got["flashd_decode"] > 0 and got["flashd_decode_paged"] == got["flashd_varlen"] == 0, got
    add(got)
    del runs
    n_tok = sum(map(len, out))
    serve_text = (f"serving {len(reqs)} requests (prompts {[len(r) for r in reqs]}, {n_new} new, "
                  f"max_batch 4, max_len 256, contiguous loop: no pool without a global layer): "
                  f"tokens identical kernel captured = kernel eager = plain; captured "
                  f"{n_tok / dt:.1f} tok/s (plain {n_tok / plain[1]:.1f}), mean TTFT "
                  f"{ttft * 1e3:.1f} ms (plain {plain[2] * 1e3:.1f}), {graphs} graphs captured; "
                  f"launches {got}")
    cache = init_decode_cache(4, 256, cfg, device=dev)
    tok4 = torch.zeros(4, dtype=torch.long, device=dev)
    pos4 = torch.full((4,), 150, dtype=torch.long, device=dev)
    steps, captured = StepGraphs(dev, graphs=True), {}
    bd = _breakdown("captured decode step B4 pos150",
                    lambda: steps.run(captured, "decode",
                                      lambda: decode_step_lm(params, cache, tok4, pos4, cfg)),
                    watch=("decode_kernel",))
    del steps, captured, cache, params
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    # K2 on a ring of `win` slots filled past a wrap: every slot written
    gen = torch.Generator(device=dev).manual_seed(211)
    ring = {x_: torch.randn(1, 4, win, hkv, d, generator=gen, device=dev) for x_ in ("k", "v")}
    qd = torch.randn(4, hq, d, generator=gen, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.inference_mode():
        _, ring_text, ring_row = _served_direct(
            ring, qd, n_sm, "contiguous", RGEMMA_RING_READS,
            f"a {win}-slot local-attention ring filled past a wrap", flush=flush, local=True)
    rows["flashd_decode"] = {f"rgemma_ring_{key}": val for key, val in ring_row.items()}
    del ring
    train_text, train_launched = _rgemma_train(full, dev, total)
    add(train_launched)
    depth = (f"{cfg.n_layers} layers" if cfg.n_layers == full.n_layers else
             f"{cfg.n_layers} of {full.n_layers} layers (whole periods cut: the f32 weights "
             f"would pass {RGEMMA_MEM_SHARE} of the card's {total / 1e9:.1f} GB)")
    text = (f"recurrentgemma-9b f32 full width (d {cfg.d_model}, Hq {hq} / Hkv {hkv} of head dim "
            f"{d}, window {win}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), {depth}, "
            f"{param_bytes / 1e9:.2f} GB of parameters (init {init_s:.1f} s), peak "
            f"{peak / 1e9:.2f} GB allocated, on {card}: {attn_text}; {fwd_text}; "
            f"{serve_text}; {bd}; {ring_text}; {train_text}")
    return text, launched, rows


def _rgemma_train(full, dev, total: int):
    """Phase 21's train step: recurrentgemma-9b at full width (`full`),
    f32, cut to the whole periods (rglru, rglru, attn_local) whose train
    state — RGEMMA_TRAIN_BYTES a parameter: bf16 AdamW moments and no
    numerics guard, the reference's own knobs — fits TRAIN_MEM_SHARE of the
    card (`total` bytes) and, less RGEMMA_TRAIN_HEADROOM, the memory free
    when it starts; one SyntheticLM batch of B 1 × S RGEMMA_TRAIN_SEQ
    (past the 2048 window, so K5's local-mask edge is in play); the lr at
    its peak at step 0. The kernel path (K1 + K5), the FA2 path (K6 + K5)
    and the plain path from one seeded state (`_train_paths`). Returns
    (report, launches per kernel over the kernel and FA2 steps)."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import TrainConfig, init_train_state

    period = len(full.pattern)
    count = lambda n: dataclasses.replace(full, n_layers=n).param_count()
    gc.collect()
    torch.cuda.empty_cache()
    held, free = torch.cuda.memory_allocated(dev), torch.cuda.mem_get_info(dev)[0]
    # the share of the card, and what is free now less the step's headroom
    budget = min(TRAIN_MEM_SHARE * total, free - RGEMMA_TRAIN_HEADROOM)
    n_layers = period
    while (n_layers + period <= full.n_layers
           and RGEMMA_TRAIN_BYTES * count(n_layers + period) <= budget):
        n_layers += period
    assert RGEMMA_TRAIN_BYTES * count(n_layers) <= budget, (count(n_layers), held, free)
    data = SyntheticLM(DataConfig(vocab_size=full.vocab_size, seq_len=RGEMMA_TRAIN_SEQ,
                                  global_batch=1, seed=0)).batch(0)
    batch = {k_: torch.as_tensor(x, device=dev) for k_, x in data.items()}
    tc = TrainConfig(warmup_steps=0, total_steps=4, opt_state_dtype="bfloat16",
                     numerics_guard=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(full, n_layers=n_layers)
    train, got = _train_paths(cfg, tc, init_train_state(cfg, tc, device=dev, seed=0), batch,
                              "rgemma")
    launched = {key: got["kernel"][key] + got["fa2"][key] for key in got["kernel"]}
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    text = (f"train step B1 x S{RGEMMA_TRAIN_SEQ}, {n_layers} of {full.n_layers} layers "
            f"({count(n_layers) / 1e9:.3f} B parameters: the whole periods whose "
            f"{RGEMMA_TRAIN_BYTES} B a parameter — f32 parameters, gradients and new parameters, "
            f"bf16 AdamW moments old and new, no numerics guard — fit {budget / 1e9:.1f} GB: "
            f"the least of {TRAIN_MEM_SHARE} of the card's {total / 1e9:.1f} GB and the "
            f"{free / 1e9:.1f} GB free less {RGEMMA_TRAIN_HEADROOM / 1e9:.0f} GB for "
            f"activations, with {held / 1e9:.2f} GB still allocated before the step; one more "
            f"period would take {RGEMMA_TRAIN_BYTES * count(n_layers + period) / 1e9:.1f} GB), peak "
            f"{peak / 1e9:.2f} GB allocated: loss / grad norm kernel {train['kernel'][:2]}, fa2 "
            f"{train['fa2'][:2]}, plain {train['plain'][:2]} (bound {TRAIN_REL[0]} relative); "
            f"seconds kernel {train['kernel'][2]:.2f}, fa2 {train['fa2'][2]:.2f}, plain "
            f"{train['plain'][2]:.2f}; launches (kernel + fa2) {launched}")
    return text, launched


def _qwen3moe_phase(dev, card: str, flush):
    """Phase 21 (b): qwen3-moe-235b-a22b at full width (d 4096, Hq 64 over
    Hkv 4 of head dim 128 — a group of 16 —, 128 experts of d_ff 1536 top-8,
    qk-norm, vocab 151936), cut to QWEN3MOE_LAYERS of its 94 layers (the
    whole model, 235 B parameters, fits no card), f32, seeded random
    weights: 6 requests (prompts 32–128, 16 new, 4 slots) through the
    captured contiguous, paged and mixed loops on the kernel path and the
    plain path — tokens identical within each loop; K2 (contiguous), K3
    (paged) and K4 (mixed) launched at G 16 — and each held to plain (and
    timed) on the served engine's cache, pool or a pack over its pool
    (`_served_direct`). Returns (report, launches per kernel over the
    kernel-path runs, {kernel: qwen3moe_g16_* row})."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import ServeConfig
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), n_layers=QWEN3MOE_LAYERS,
                              dtype="float32")
    plain_cfg = dataclasses.replace(cfg, attn_impl="flashd_plain")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(cfg, device=dev, seed=0)
    param_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    launched = dict.fromkeys(_launches(), 0)
    rng = np.random.default_rng(212)
    gen = torch.Generator(device=dev).manual_seed(212)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
            for n in (32, 57, 96, 128, 33, 40)]
    n_new = 16
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    qd = torch.randn(4, cfg.n_heads, cfg.head_dim_, generator=gen, device=dev)
    loops = {"contiguous": ({}, "flashd_decode", (150, 0, 255, 76), "the first layer's cache"),
             "paged": (dict(kv_layout="paged"), "flashd_decode_paged", (150, 1, 256, 77),
                       "the first layer's pool"),
             "mixed": (dict(step_mode="mixed"), "flashd_varlen", (150, 221, 100),
                       "the first layer's pool")}
    report, direct, rows = [], [], {}
    for loop, (kw, kernel, reads, what) in loops.items():
        sc = ServeConfig(max_batch=4, max_len=256, **kw)
        runs = _serve_paths(params, cfg, sc, reqs, n_new, dev,
                            (("kernel", cfg, None), ("plain", plain_cfg, None)))
        (out, dt, ttft, got, graphs, eng), plain = runs["kernel"], runs["plain"][:5]
        for a, b_ in zip(out, plain[0]):
            assert np.array_equal(a, b_), f"qwen3-moe {loop}: kernel and plain tokens differ"
        assert sum(plain[3].values()) == 0, f"qwen3-moe {loop}: the plain path launched a kernel"
        assert got[kernel] > 0, (loop, got)
        for key in launched:
            launched[key] += got[key]
        layer = (eng._contig[4] if loop == "contiguous" else eng._paged).cache["blocks"]["pos0"]
        with torch.inference_mode():
            _, text, row = _served_direct(layer, qd, n_sm, loop, reads, what, gen=gen,
                                          flush=flush)
        del runs, eng, layer
        direct.append(text)
        rows[kernel] = {f"qwen3moe_g16_{key}": val for key, val in row.items()}
        n_tok = sum(map(len, out))
        report.append(f"{loop}: tokens identical kernel = plain; {n_tok / dt:.1f} tok/s (plain "
                      f"{n_tok / plain[1]:.1f}), mean TTFT {ttft * 1e3:.1f} ms (plain "
                      f"{plain[2] * 1e3:.1f}), {graphs} graphs captured; launches {got}")
    del params
    peak = torch.cuda.max_memory_allocated()
    text = (f"qwen3-moe-235b-a22b f32 full width (d {cfg.d_model}, Hq {cfg.n_heads} / Hkv "
            f"{cfg.n_kv_heads} of head dim {cfg.head_dim_}: G {cfg.n_heads // cfg.n_kv_heads}, "
            f"{cfg.n_experts} experts top-{cfg.n_experts_active}, vocab {cfg.vocab_size}), "
            f"{cfg.n_layers} of 94 layers, {param_bytes / 1e9:.2f} GB of parameters, peak "
            f"{peak / 1e9:.2f} GB allocated, on {card}: serving {len(reqs)} requests (prompts "
            f"{[len(r) for r in reqs]}, {n_new} new, max_batch 4, max_len 256, captured): "
            f"{'; '.join(report)}; " + "; ".join(direct))
    return text, launched, rows


def _sharded_phase(dev, bt: int = 2, st: int = 1024):
    """Phase 22: the sharded train step (`repro_torch.distributed`) on a
    1-rank NCCL process group and a (1, 1) ('data', 'model') mesh, against
    the unsharded step, at phase 12's model and batches (qwen3-0.6b at full
    width, QWEN_LAYERS layers, f32, B bt x S st, K1 forward and K5
    backward): 2 unsharded steps from the seeded init, then 2 sharded ones
    from the same init (one state freed before the next is made). Loss and
    grad norm per step within TRAIN_REL, every parameter leaf's largest
    relative gap printed, K1 and K5 launched in the sharded steps (through
    the attention island, on each rank's local heads), K6 not, and no
    plain route taken (the plain fallbacks raise while the sharded steps
    run). Host and device-busy ms per step of both, reported. Returns
    (text, {kernel: sharded launches})."""
    import logging

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.devices import make_mesh
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.train_step import train_state_specs
    from repro_torch.tree import tree_flatten_with_names

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=QWEN_LAYERS, dtype="float32",
                              attn_impl="flashd_gpu")
    tc = TrainConfig(warmup_steps=0, total_steps=4)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=st, global_batch=bt, seed=0))
    batches = [{k: torch.as_tensor(x, device=dev) for k, x in data.batch(i).items()}
               for i in range(2)]
    store = os.path.join(HERE, "build", f"phase22_store_{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    # DTensor warns of two all-reduces where a mesh of two dims reduces a
    # scalar: trivial on one rank
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1)
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    ctx = shd.ShardingCtx(mesh)

    def run(step, state):
        curve, secs = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            curve.append(torch.stack([m["loss"], m["grad_norm"]]).tolist())
            secs.append(time.perf_counter() - t)
        return state, curve, secs

    step_u = make_train_step(cfg, tc)
    state, curve_u, secs_u = run(step_u, init_train_state(cfg, tc, device=dev, seed=0))
    prof_u = _breakdown("unsharded", lambda: step_u(state, batches[0]), steps=2, train=True)
    params_u = dict(tree_flatten_with_names(state.params))
    del state
    gc.collect()

    with shd.activate(ctx):
        state = init_train_state(cfg, tc, device=dev, seed=0)
        state = shd.distribute_tree(state, train_state_specs(state))
        step_s = shd.sharded(make_train_step(cfg, tc), (None, shd.batch_specs(batches[0])))
    plain = dict(ops._FALLBACKS)

    def refuse(name):
        def fallback(*args, **kwargs):
            raise AssertionError(f"phase 22: the plain {name} route ran in a sharded step")
        return fallback

    ops._FALLBACKS.update({name: refuse(name) for name in plain})
    _zero_launches()
    state, curve_s, secs_s = run(step_s, state)
    launched = _launches()
    ops._FALLBACKS.update(plain)
    assert launched["flashd_fwd"] > 0 and launched["flashd_bwd"] > 0, launched
    assert launched["fa2_fwd"] == 0, launched
    prof_s = _breakdown("sharded", lambda: step_s(state, batches[0]), steps=2, train=True)
    for i, (a, w) in enumerate(zip(curve_s, curve_u)):
        rel = TRAIN_REL[0] if i == 0 else TRAIN_REL[1]
        for x, y, what in ((a[0], w[0], "loss"), (a[1], w[1], "grad norm")):
            assert np.isfinite(x) and abs(x - y) <= rel * abs(y), ("phase 22", i, what, x, y)
    gaps = {}
    for name, x in tree_flatten_with_names(state.params):
        x, want = x.full_tensor(), params_u[name]
        gaps[name] = float((x - want).abs().max() / want.abs().max().clamp(min=1e-30))
    rel_curve = max(abs(a[j] - w[j]) / abs(w[j]) for a, w in zip(curve_s, curve_u) for j in (0, 1))
    del state, params_u, step_s
    dist.destroy_process_group()
    os.remove(store)
    text = (f"sharded train step, 1-rank NCCL group, mesh {dict(ctx.axis_sizes)}: qwen3-0.6b f32 "
            f"{cfg.n_layers} layers B {bt} x S {st}, 2 steps each: loss/grad norm sharded "
            f"{curve_s}, unsharded {curve_u}, largest relative gap {rel_curve:.2e} (bounds "
            f"{TRAIN_REL[0]} at step 0, {TRAIN_REL[1]} after); each parameter leaf's largest "
            f"gap over its largest entry {', '.join(f'{n} {g:.2e}' for n, g in gaps.items())}; "
            f"launches in the sharded steps "
            f"{launched}, plain routes refused; seconds per step sharded "
            f"{[round(x, 3) for x in secs_s]}, unsharded {[round(x, 3) for x in secs_u]}; "
            f"{prof_s}; {prof_u}")
    return text, launched


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        print(f"chip_smoke: the port's sources are not under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.blockwise import NEG_INF, MaskSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels import flashd_decode as k2
    from repro_torch.core.attention import gather_pages
    from repro_torch.kernels import fa2_fwd as k6
    from repro_torch.kernels import flashd_bwd as k5
    from repro_torch.kernels import flashd_fwd as k1
    from repro_torch.kernels import flashd_varlen as k4
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.resilience import FaultInjector
    from repro_torch.tree import tree_leaves
    from repro_torch.train import (
        ResilienceConfig,
        TrainConfig,
        init_train_state,
        make_train_step,
        train_resilient,
    )
    from repro_torch.kernels.tuning import bucket_pow2, choose_varlen_blocks
    from repro_torch.models.transformer import (
        apply_lm,
        decode_step_lm,
        forward_packed,
        init_decode_cache,
        init_lm,
    )
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.engine import pack_plan
    from repro_torch.serve.graphs import StepGraphs, launch_counts
    from repro_torch.serve.scheduler import Segment, StepPlan

    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)  # 256 MB > L2

    # ---- 1. card ----
    ph = _Phase()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _line(1, f"card {card!r}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
             f"device {torch.cuda.get_device_name(0)} {ph}")

    # ---- 2. build ----
    ph = _Phase()
    t0 = time.perf_counter()
    secs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = "; ".join(f"{n}: " + _build.ptxas_report(n).replace("\n", " | ") for n in _build.SOURCES)
    ptxas_hd = "; ".join(f"{n}: d96 {_ptxas_hd(n, 'Li96E')}, d256 {_ptxas_hd(n, 'Li256E')}"
                         for n in _build.SOURCES)
    # groups of 9–16 run the group-8 instance (two CTAs): its registers at d 128 and 256
    ptxas_g8 = "; ".join(f"d{hd} {_ptxas_hd('flashd_decode', f'Li{hd}ELi8E')}" for hd in (128, 256))
    cuobjdump = _cuobjdump(_build.nvcc())
    sass = _sass_counts(cuobjdump, {n: str(_build.lib_path(n)) for n in _build.SOURCES})
    for n in TC_KERNELS:
        assert sass[n]["HGMMA"] + sass[n]["HMMA"] > 0, ("no tensor-core instruction", n, sass[n])
    _line(2, f"built {sorted(secs)} in {build_s:.1f} s (nvcc seconds per library, its "
             f"translation units at once: {', '.join(f'{n} {t:.1f}' for n, t in secs.items())}); "
             f"SASS instruction counts (cuobjdump -sass) {sass}; head dims 96 and 256 (ptxas): "
             f"{ptxas_hd}; K2 / K3's group-8 instance (G 5–16): {ptxas_g8}; ptxas: {ptxas} {ph}")

    # ---- 3. K1 against its plain version ----
    ph = _Phase()
    gen = torch.Generator(device=dev).manual_seed(0)
    b, hq, hkv, d, s = 1, 16, 8, 128, 2048
    q = torch.randn(b, s, hq, d, generator=gen, device=dev)  # model layout
    k = torch.randn(b, s, hkv, d, generator=gen, device=dev)
    v = torch.randn(b, s, hkv, d, generator=gen, device=dev)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    cases = [
        ("causal", MaskSpec("causal"), False),
        ("causal+skip", MaskSpec("causal"), True),
        ("full", MaskSpec("full"), False),
        ("local256+skip", MaskSpec("local", window=256), True),
        ("chunked512", MaskSpec("chunked", chunk=512), False),
        ("causal q_offset=-100 (dead rows)", MaskSpec("causal", q_offset=-100), False),
    ]
    k1_err, report = 0.0, []
    for name, mask, skip in cases:
        o, lam = k1.flashd_fwd(qt, kt, vt, mask=mask, skip=skip, block_k=64)
        o_p, lam_p = k1.flashd_fwd_plain(qt, kt, vt, mask=mask, skip=skip, block_k=64)
        torch.cuda.synchronize()
        e = max(_err(o, o_p), _err(lam, lam_p))
        assert torch.isfinite(o).all() and e <= F32_TOL, (name, e)
        k1_err = max(k1_err, e)
        report.append(f"{name} {e:.2e}")
    # a q block of Sq < Skv with q_offset, as a chunk of a longer prefill
    o, lam = k1.flashd_fwd(qt[:, :, 1024:], kt, vt, mask=MaskSpec("causal", q_offset=1024))
    o_p, lam_p = k1.flashd_fwd_plain(qt[:, :, 1024:], kt, vt, mask=MaskSpec("causal", q_offset=1024))
    e = max(_err(o, o_p), _err(lam, lam_p))
    assert e <= F32_TOL, ("q_offset", e)
    k1_err = max(k1_err, e)
    report.append(f"Sq1024 q_offset=1024 {e:.2e}")
    o, lam = k1.flashd_fwd(qt, kt, vt, mask=MaskSpec("causal", q_offset=-100))
    assert (o[:, :, :100] == 0).all() and (lam[:, :, :100] == NEG_INF).all(), "dead rows"
    qb, kb, vb = (x.bfloat16() for x in (qt, kt, vt))
    ob, _ = k1.flashd_fwd(qb, kb, vb)
    ob_p, _ = k1.flashd_fwd_plain(qb, kb, vb, block_k=64)
    e_bf16 = _err(ob, ob_p)
    assert e_bf16 <= BF16_TOL, ("bf16", e_bf16)

    causal = MaskSpec("causal")
    k1_ms = _time_ms(lambda: k1.flashd_fwd(qt, kt, vt, mask=causal), flush=flush)
    k1_plain_ms = _time_ms(lambda: k1.flashd_fwd_plain(qt, kt, vt, mask=causal), flush=flush)
    k1_bf16_ms = _time_ms(lambda: k1.flashd_fwd(qb, kb, vb, mask=causal), flush=flush)
    # SDPA's own operands, contiguous [B, H, S, d], kept for phase 11 too
    sdpa_x = {torch.float32: tuple(x.transpose(1, 2).contiguous() for x in (q, k, v))}
    sdpa_x[torch.bfloat16] = tuple(x.bfloat16() for x in sdpa_x[torch.float32])

    def sdpa_ms(dtype):
        x = sdpa_x[dtype]
        return _time_ms(lambda: F.scaled_dot_product_attention(*x, is_causal=True, enable_gqa=True),
                        flush=flush)

    k1_lib_ms, k1_lib_bf16_ms = sdpa_ms(torch.float32), sdpa_ms(torch.bfloat16)
    pairs = b * s * (s + 1) // 2  # causal (q, k) pairs this run computes
    k1_ops = 4 * d * pairs * hq  # QKᵀ and PV, 2 flops per multiply-add
    k1_elems = 2 * b * s * hq * d + 2 * b * s * hkv * d  # q, O; k, v
    fwd_bounds = _attn_bounds(k1_ops, 4 * k1_elems + 4 * b * hq * s, 2 * k1_elems + 4 * b * hq * s)
    k1_bound, k1_bound_by = fwd_bounds["3xtf32"]  # the f32 kernels' datapath
    _line(3, f"K1 flashd_fwd f32 max|Δ| vs plain: {', '.join(report)} (bound {F32_TOL}); "
             f"bf16 {e_bf16:.2e} (bound {BF16_TOL}); causal S={s}: f32 kernel {k1_ms:.4f} ms, "
             f"plain {k1_plain_ms:.3f} ms, sdpa {k1_lib_ms:.4f} ms; bf16 kernel {k1_bf16_ms:.4f} "
             f"ms, sdpa {k1_lib_bf16_ms:.4f} ms; "
             + _fmt_bounds(fwd_bounds, k1_ops, {"kernel f32": k1_ms, "kernel bf16": k1_bf16_ms,
                                                "sdpa f32": k1_lib_ms, "sdpa bf16": k1_lib_bf16_ms})
             + f" {ph}")

    # ---- 4. K2 against its plain version ----
    ph = _Phase()
    bd, s_max = 8, 4096
    qd = torch.randn(bd, hq, d, generator=gen, device=dev)
    kc = torch.randn(bd, s_max, hkv, d, generator=gen, device=dev)  # cache layout
    vc = torch.randn(bd, s_max, hkv, d, generator=gen, device=dev)
    kct, vct = kc.transpose(1, 2), vc.transpose(1, 2)
    cl = torch.tensor([0, 1, 17, 1000, 2049, 3333, 4095, 4096], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 0, 5, 900, 0, 3000, 4000, 100], dtype=torch.int32, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_default = k2.gpu_decode_splits(bd, hkv, s_max, n_sm)
    dcases = [
        ("default", dict(n_splits=n_default)),
        ("unfused", dict(n_splits=n_default, fused=False)),
        ("n_splits=7", dict(n_splits=7)),
        ("window512", dict(n_splits=n_default, window=512)),
        ("chunk1024", dict(n_splits=n_default, chunk=1024)),
        ("start", dict(n_splits=n_default, start=start)),
        ("n_splits=1", dict(n_splits=1)),
    ]
    k2_err, dreport = 0.0, []
    for name, kw in dcases:
        o, lam = k2.flashd_decode(qd, kct, vct, cl, return_lam=True, **kw)
        o_p, lam_p = k2.flashd_decode_plain(qd, kct, vct, cl, return_lam=True, **kw)
        torch.cuda.synchronize()
        e = max(_err(o, o_p), _err(lam, lam_p))
        assert torch.isfinite(o).all() and e <= F32_TOL, (name, e)
        assert (o[0] == 0).all() and (lam[0] == NEG_INF).all(), "empty cache row"
        k2_err = max(k2_err, e)
        dreport.append(f"{name} {e:.2e}")
    fused_vs_unfused = _err(k2.flashd_decode(qd, kct, vct, cl),
                            k2.flashd_decode(qd, kct, vct, cl, fused=False))
    repeat_equal = all(torch.equal(x, y) for x, y in zip(
        k2.flashd_decode(qd, kct, vct, cl, return_lam=True),
        k2.flashd_decode(qd, kct, vct, cl, return_lam=True)))
    assert repeat_equal, "K2 is not bitwise repeatable"
    ob = k2.flashd_decode(qd.bfloat16(), kct.bfloat16(), vct.bfloat16(), cl)
    ob_p = k2.flashd_decode_plain(qd.bfloat16(), kct.bfloat16(), vct.bfloat16(), cl, n_splits=n_default)
    e2_bf16 = _err(ob, ob_p)
    assert e2_bf16 <= BF16_TOL, ("bf16 decode", e2_bf16)

    # timed at the engine's decode shape: B 4 slots, S_max 512, full caches
    be, se = 4, 512
    qe = torch.randn(be, hq, d, generator=gen, device=dev)
    ke = torch.randn(be, se, hkv, d, generator=gen, device=dev)
    ve = torch.randn(be, se, hkv, d, generator=gen, device=dev)
    cle = torch.full((be,), se, dtype=torch.int32, device=dev)
    ket, vet = ke.transpose(1, 2), ve.transpose(1, 2)
    n_engine = k2.gpu_decode_splits(be, hkv, se, n_sm)
    qe4 = qe[:, :, None]
    qeb, keb, veb = qe.bfloat16(), ket.bfloat16(), vet.bfloat16()
    k2_calls = {  # (kernel, library) per dtype
        "f32": (lambda: k2.flashd_decode(qe, ket, vet, cle),
                lambda: F.scaled_dot_product_attention(qe4, ket, vet, enable_gqa=True)),
        "bf16": (lambda: k2.flashd_decode(qeb, keb, veb, cle),
                 lambda: F.scaled_dot_product_attention(qeb[:, :, None], keb, veb,
                                                        enable_gqa=True)),
    }
    k2_t = {(dt, who): (_time_ms(fn, reps=20, flush=flush), _device_ms(fn, flush))
            for dt, fns in k2_calls.items() for who, fn in zip(("kernel", "sdpa"), fns)}
    k2_ms, k2_dev_ms = k2_t["f32", "kernel"]
    k2_bf16_ms, k2_bf16_dev_ms = k2_t["bf16", "kernel"]
    k2_lib_ms, k2_lib_bf16_ms = k2_t["f32", "sdpa"][0], k2_t["bf16", "sdpa"][0]
    k2_plain_ms = _time_ms(lambda: k2.flashd_decode_plain(qe, ket, vet, cle, n_splits=n_engine),
                           reps=20, flush=flush)
    live = int(cle.sum())
    k2_ops = 4 * d * live * hq
    k2_bounds = {dt: _bytes_bound(2 * live * hkv * d * size + 2 * be * hq * d * size, k2_ops)
                 for dt, size in (("f32", 4), ("bf16", 2))}
    k2_bound = k2_bounds["f32"]
    times = "; ".join(
        f"{dt} {who} {ev * 1e3:.2f} us (device {dv * 1e3:.2f} us)" for (dt, who), (ev, dv) in k2_t.items())
    _line(4, f"K2 flashd_decode f32 max|Δ| vs plain (B {bd}, S_max {s_max}, {n_default} splits, "
             f"cache_len {cl.tolist()}): {', '.join(dreport)} (bound {F32_TOL}); fused vs unfused "
             f"{fused_vs_unfused:.2e}; bitwise equal on a second call: {repeat_equal}; bf16 "
             f"{e2_bf16:.2e} (bound {BF16_TOL}); at B {be}, S_max {se}, {n_engine} splits "
             f"({n_engine * be * hkv} CTAs on {n_sm} SMs), {live} live tokens, events (device "
             f"time): {times}; plain f32 {k2_plain_ms * 1e3:.1f} us; byte bounds f32 "
             f"{k2_bounds['f32'] * 1e3:.2f} us, bf16 {k2_bounds['bf16'] * 1e3:.2f} us {ph}")

    # ---- 5. full-width qwen3-0.6b, f32: kernels vs plain, tokens identical ----
    ph = _Phase()
    qwen = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=QWEN_LAYERS)
    cfg = dataclasses.replace(qwen, dtype="float32")
    plain_cfg = dataclasses.replace(cfg, attn_impl="flashd_plain")
    params = init_lm(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 2048)), device=dev)
    gen_prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
            for n in rng.integers(17, 201, 8)]
    sc = ServeConfig(max_batch=4, max_len=512)

    def run(model_cfg, graphs=None, apply=True):
        """apply_lm (twice), then one engine's generate and serve; the
        engine's K2–K4 launches, host syncs and captures."""
        out = {}
        if apply:
            with torch.inference_mode():
                for _ in range(2):  # the first call pays one-time library set-up
                    t = time.perf_counter()
                    out["logits"], _ = apply_lm(params, {"tokens": toks}, model_cfg,
                                                last_only=True)
                    torch.cuda.synchronize()
                    out["apply_s"] = time.perf_counter() - t
        eng = Engine(params, model_cfg, sc, device=dev, graphs=graphs)
        before = launch_counts()
        t = time.perf_counter()
        out["gen"] = eng.generate(gen_prompts, 32)
        out["gen_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["serve"] = eng.serve(reqs, 32)
        out["serve_s"] = time.perf_counter() - t
        out["ttft"] = float(np.mean(list(eng.ttft.values())))
        out["launched"] = tuple(a - b for a, b in zip(launch_counts(), before))
        out["syncs"] = eng.host_syncs
        out["captures"] = eng._steps.captures
        out["capture_s"] = eng._steps.capture_s
        return out

    def counts():
        return (k1.launches, k2.launches, k2.paged_launches, k4.launches, k5.launches,
                k6.launches)

    def reset_counts():
        k1.launches = k2.launches = k2.paged_launches = k4.launches = 0
        k5.launches = k6.launches = 0

    def same_tokens(label, a, b_):
        assert np.array_equal(a["gen"], b_["gen"]), f"{label}: generate tokens differ"
        for x, y in zip(a["serve"], b_["serve"]):
            assert np.array_equal(x, y), f"{label}: serve tokens differ"

    def rates(r):
        n_gen, n_srv = r["gen"].size, sum(len(o) for o in r["serve"])
        return (f"generate {n_gen / r['gen_s']:.1f} tok/s, serve {n_srv / r['serve_s']:.1f} "
                f"tok/s, mean TTFT {r['ttft'] * 1e3:.1f} ms")

    reset_counts()  # the contiguous path's run starts here (captured steps, the default)
    kern = run(cfg)
    launches = {"flashd_fwd": k1.launches, "flashd_decode": k2.launches}
    assert launches["flashd_fwd"] > 0 and launches["flashd_decode"] > 0, launches
    # the eager oracle on a short workload (the GPU tests hold captured = eager
    # at smoke width): the same steps on fresh engines, captured and eager
    short = sorted(reqs, key=len)[:2]
    oracle = {g: _oracle(Engine(params, cfg, sc, device=dev, graphs=g), gen_prompts[:2, :32],
                         short) for g in (None, False)}
    oracle_text = _check_oracle("contiguous", oracle)
    seen = counts()
    plain = run(plain_cfg)
    assert counts() == seen, "plain path launched a kernel"
    v = cfg.vocab_size
    logit_err = _err(kern["logits"][..., :v], plain["logits"][..., :v])
    assert logit_err <= LOGIT_TOL, ("logits", logit_err)
    same_tokens("kernel vs plain", kern, plain)
    n_gen, n_serve = kern["gen"].size, sum(len(o) for o in kern["serve"])
    cache = init_decode_cache(4, 512, cfg, device=dev)
    tok4 = torch.zeros(4, dtype=torch.long, device=dev)
    at = torch.full((4,), 300, dtype=torch.long, device=dev)
    decode = lambda: decode_step_lm(params, cache, tok4, at, cfg)
    breakdown = _breakdown("eager decode step B4 S_max512 pos300", decode)
    steps, captured = StepGraphs(dev, graphs=True), {}
    breakdown_g = _breakdown("captured", lambda: steps.run(captured, "decode", decode))
    del cache, steps, captured
    _line(5, f"qwen3-0.6b f32 full width ({cfg.n_layers} layers): apply_lm S 2048 max|Δlogit| "
             f"{logit_err:.2e} (bound {LOGIT_TOL}), kernel {kern['apply_s']:.3f} s vs plain "
             f"{plain['apply_s']:.3f} s; generate 4x128+32 and serve 8 requests (prompts "
             f"{min(map(len, reqs))}-{max(map(len, reqs))}, 32 new) tokens identical captured = "
             f"plain; captured ({kern['captures']} graphs, {kern['capture_s']:.2f} s of "
             f"warm-up runs and captures included): {rates(kern)}; plain (captured): "
             f"{rates(plain)}; K2–K4 launches {kern['launched']}, host syncs {kern['syncs']}; "
             f"{oracle_text}; launches {launches}; {breakdown}; {breakdown_g} {ph}")

    # ---- 6. the same engine in bf16 ----
    ph = _Phase()
    bcfg = qwen  # compute dtype bfloat16, f32 master weights
    reset_counts()
    eng = Engine(params, bcfg, sc, device=dev)
    t = time.perf_counter()
    out_b = eng.serve(reqs, 32)
    serve_b = time.perf_counter() - t
    ttft_b = float(np.mean(list(eng.ttft.values())))
    same = sum(int(np.array_equal(a, b_)) for a, b_ in zip(out_b, kern["serve"]))
    assert k2.launches > 0
    _line(6, f"qwen3-0.6b bf16 serve 8 requests, captured steps: "
             f"{sum(map(len, out_b)) / serve_b:.1f} tok/s, "
             f"mean TTFT {ttft_b * 1e3:.1f} ms, K2 launches {k2.launches}; "
             f"{same}/8 streams equal to the f32 run {ph}")

    # ---- 7. K3 against its plain version and against K2 ----
    ph = _Phase()
    max_len = 512
    lengths = [0, 1, 63, 64, 65, 200, max_len - 1, max_len]
    cl3 = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q3 = torch.randn(len(lengths), hq, d, generator=gen, device=dev)
    k3_err, k3_report = 0.0, []
    for page in (64, 16, 4):
        n_tbl = max_len // page
        n3 = k2.gpu_decode_splits(len(lengths), hkv, max_len, n_sm)  # the kernel's split order
        kp, vp, tbl, _, _ = _paged_pool(gen, dev, lengths, n_tbl, page, hkv, d, torch.float32)
        for name, kw in (("", {}), (" window100", dict(window=100)),
                         (" chunk128", dict(chunk=128))):
            o = k2.flashd_decode_paged(q3, kp, vp, tbl, cl3, **kw)
            o_p = k2.flashd_decode_paged_plain(q3, kp, vp, tbl, cl3, **kw)
            o_s = k2.flashd_decode_paged_plain(q3, kp, vp, tbl, cl3, n_splits=n3, **kw)
            # K2 on the gathered contiguous view (page 0's NaN lies past every cache_len)
            kc3 = gather_pages(kp, tbl).transpose(1, 2)
            vc3 = gather_pages(vp, tbl).transpose(1, 2)
            o_2 = k2.flashd_decode(q3, kc3, vc3, cl3, **kw)
            torch.cuda.synchronize()
            e, e_s, e2 = _err(o, o_p), _err(o, o_s), _err(o, o_2)
            assert torch.isfinite(o).all() and max(e, e_s, e2) <= F32_TOL, (page, name, e, e_s, e2)
            assert (o[0] == 0).all(), "empty cache row"
            k3_err = max(k3_err, e)
            k3_report.append(f"page {page}{name} {e:.2e} (split order {e_s:.2e}, vs K2 {e2:.2e})")
        kb, vb = kp.bfloat16(), vp.bfloat16()
        e3_bf16 = _err(k2.flashd_decode_paged(q3.bfloat16(), kb, vb, tbl, cl3),
                       k2.flashd_decode_paged_plain(q3.bfloat16(), kb, vb, tbl, cl3))
        assert e3_bf16 <= BF16_TOL, ("bf16 paged", page, e3_bf16)
        ki, vi, tbl_i, ks, vs = _paged_pool(gen, dev, lengths, n_tbl, page, hkv, d, torch.int8)
        oi = k2.flashd_decode_paged(q3, ki, vi, tbl_i, cl3, k_scale=ks, v_scale=vs)
        e3_int8 = _err(oi, k2.flashd_decode_paged_plain(q3, ki, vi, tbl_i, cl3, k_scale=ks,
                                                        v_scale=vs))
        assert torch.isfinite(oi).all() and e3_int8 <= F32_TOL, ("int8 paged", page, e3_int8)
        k3_report.append(f"page {page} bf16 {e3_bf16:.2e} int8 {e3_int8:.2e}")
    k3_repeat = all(torch.equal(k2.flashd_decode_paged(q3, kp, vp, tbl, cl3),
                                k2.flashd_decode_paged(q3, kp, vp, tbl, cl3)) for _ in range(2))
    assert k3_repeat, "K3 is not bitwise repeatable"
    # timed at the engine's paged decode shape: B 4, max_len 512, full caches,
    # pages of 64 (the engine's) and of 16
    cle3 = torch.full((be,), max_len, dtype=torch.int32, device=dev)
    n3e = k2.gpu_decode_splits(be, hkv, max_len, n_sm)
    k3_t = {}
    for page in (64, 16):
        kp, vp, tbl, _, _ = _paged_pool(gen, dev, [max_len] * be, max_len // page, page, hkv, d,
                                        torch.float32)
        kpb, vpb = kp.bfloat16(), vp.bfloat16()
        for dt, args in (("f32", (qe, kp, vp)), ("bf16", (qeb, kpb, vpb))):
            fn = lambda args=args, tbl=tbl: k2.flashd_decode_paged(*args, tbl, cle3)
            k3_t[page, dt] = (_time_ms(fn, reps=20, flush=flush), _device_ms(fn, flush))
        if page == 64:
            pool64 = (kp, vp, kpb, vpb, tbl)
    kp, vp, kpb, vpb, tbl = pool64
    k3_ms, k3_dev_ms = k3_t[64, "f32"]
    k3_bf16_ms, k3_bf16_dev_ms = k3_t[64, "bf16"]
    k3_plain_ms = _time_ms(lambda: k2.flashd_decode_paged_plain(qe, kp, vp, tbl, cle3), reps=20,
                           flush=flush)
    k3_gather_ms = _time_ms(lambda: (gather_pages(kp, tbl), gather_pages(vp, tbl)), reps=20,
                            flush=flush)
    kg, vg = gather_pages(kp, tbl).transpose(1, 2), gather_pages(vp, tbl).transpose(1, 2)
    k3_sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(qe4, kg, vg, enable_gqa=True),
                          reps=20, flush=flush)
    k3_lib_ms = k3_gather_ms + k3_sdpa_ms
    kgb, vgb = gather_pages(kpb, tbl).transpose(1, 2), gather_pages(vpb, tbl).transpose(1, 2)
    k3_lib_bf16_ms = _time_ms(lambda: (gather_pages(kpb, tbl), gather_pages(vpb, tbl)), reps=20,
                              flush=flush) + _time_ms(lambda: F.scaled_dot_product_attention(
                                  qeb[:, :, None], kgb, vgb, enable_gqa=True), reps=20, flush=flush)
    # K2 on the gathered contiguous view of the same pages, timed beside K3
    k2_t7 = {dt: _device_ms(lambda x=x: k2.flashd_decode(*x, cle3), flush)
             for dt, x in (("f32", (qe, kg, vg)), ("bf16", (qeb, kgb, vgb)))}
    live3 = be * max_len
    k3_ops = 4 * d * live3 * hq
    k3_bound, k3_bf16_bound = (_bytes_bound(2 * live3 * hkv * d * size + 2 * be * hq * d * size,
                                            k3_ops) for size in (4, 2))
    times3 = "; ".join(f"page {pg} {dt} {ev * 1e3:.2f} us (device {dv * 1e3:.2f} us)"
                       for (pg, dt), (ev, dv) in k3_t.items())
    _line(7, f"K3 flashd_decode_paged f32 max|Δ| vs plain (B {len(lengths)}, cache_len {lengths}, "
             f"NaN page 0): {', '.join(k3_report)} (bound {F32_TOL}; bf16 {BF16_TOL}); bitwise "
             f"equal on repeat calls: {k3_repeat}; at B {be}, max_len {max_len}, {n3e} splits "
             f"({n3e * be * hkv} CTAs), {live3} live tokens, events (device time): {times3}; "
             f"K2 on the gathered pages device {k2_t7['f32'] * 1e3:.2f} us f32, "
             f"{k2_t7['bf16'] * 1e3:.2f} us bf16; page 64 f32: plain {k3_plain_ms * 1e3:.1f} us, "
             f"library {k3_lib_ms * 1e3:.1f} us (gather_pages {k3_gather_ms * 1e3:.1f} us + sdpa "
             f"{k3_sdpa_ms * 1e3:.1f} us), bound {k3_bound * 1e3:.2f} us (bytes); bf16 library "
             f"{k3_lib_bf16_ms * 1e3:.1f} us, bound {k3_bf16_bound * 1e3:.2f} us (bytes) {ph}")

    # ---- 8. K4 against its plain version, on packs from the engine's packer ----
    ph = _Phase()
    n_tbl, page = max_len // 64, 64
    mixed_bq = choose_varlen_blocks(bucket_pow2(4 + 16, lo=8), d, d, group=hq // hkv, page=page,
                                    segment_hint=1).block_q
    # a mixed step of the engine's shape: 3 decode rows and one 16-row
    # prefill chunk mid-sequence (positions 96-111)
    mixed_plan = StepPlan(segments=(
        Segment(slot=0, tokens=np.zeros(1, np.int32), start=150, emits=True),
        Segment(slot=1, tokens=np.zeros(1, np.int32), start=221, emits=True),
        Segment(slot=2, tokens=np.zeros(1, np.int32), start=300, emits=True),
        Segment(slot=3, tokens=np.zeros(16, np.int32), start=96, emits=False),
    ), n_tokens=19)
    # whole prompts, a K+1 = 5-row verify segment, and (from the pow2 bucket) padding blocks
    prompt_plan = StepPlan(segments=(
        Segment(slot=0, tokens=np.zeros(37, np.int32), start=0, emits=True),
        Segment(slot=1, tokens=np.zeros(5, np.int32), start=400, emits=True),
        Segment(slot=2, tokens=np.zeros(100, np.int32), start=0, emits=True),
    ), n_tokens=142)
    k4_err, k4_report = 0.0, []
    for plan_name, plan in (("mixed", mixed_plan), ("prompts+verify", prompt_plan)):
        for bq in (8, 16):
            _, sid_np, qpos_np, kvl_np, _ = pack_plan(plan, bq, 4)
            sid, qp = torch.as_tensor(sid_np, device=dev), torch.as_tensor(qpos_np, device=dev)
            kvl = torch.as_tensor(kvl_np, device=dev)
            assert plan is mixed_plan or (sid_np[-bq:] < 0).all(), "no all-padding block"
            kp, vp, tbl, _, _ = _paged_pool(gen, dev, kvl_np.tolist(), n_tbl, page, hkv, d,
                                            torch.float32)
            qv = torch.randn(len(sid_np), hq, d, generator=gen, device=dev)
            o = k4.flashd_varlen(qv, kp, vp, tbl, sid, qp, kvl, block_q=bq)
            o_p = k4.flashd_varlen_plain(qv, kp, vp, tbl, sid, qp, kvl, block_q=bq)
            ow = k4.flashd_varlen(qv, kp, vp, tbl, sid, qp, kvl, block_q=bq, window=50)
            ow_p = k4.flashd_varlen_plain(qv, kp, vp, tbl, sid, qp, kvl, block_q=bq, window=50)
            torch.cuda.synchronize()
            e = max(_err(o, o_p), _err(ow, ow_p))
            assert torch.isfinite(o).all() and e <= F32_TOL, (plan_name, bq, e)
            assert (o[qp < 0] == 0).all(), "padding rows not exactly 0"
            kb, vb = kp.bfloat16(), vp.bfloat16()
            ob = k4.flashd_varlen(qv.bfloat16(), kb, vb, tbl, sid, qp, kvl, block_q=bq)
            e_bf16 = _err(ob, k4.flashd_varlen_plain(qv.bfloat16(), kb, vb, tbl, sid, qp, kvl,
                                                     block_q=bq))
            assert e_bf16 <= BF16_TOL and (ob[qp < 0] == 0).all(), ("bf16 varlen", e_bf16)
            ki, vi, tbl_i, ks, vs = _paged_pool(gen, dev, kvl_np.tolist(), n_tbl, page, hkv, d,
                                                torch.int8)
            oi = k4.flashd_varlen(qv, ki, vi, tbl_i, sid, qp, kvl, block_q=bq, k_scale=ks,
                                  v_scale=vs)
            e_int8 = _err(oi, k4.flashd_varlen_plain(qv, ki, vi, tbl_i, sid, qp, kvl, block_q=bq,
                                                     k_scale=ks, v_scale=vs))
            assert torch.isfinite(oi).all() and e_int8 <= F32_TOL, ("int8 varlen", e_int8)
            k4_err = max(k4_err, e, e_int8)
            k4_report.append(f"{plan_name} T{len(sid_np)} block_q {bq}: {e:.2e} bf16 "
                             f"{e_bf16:.2e} int8 {e_int8:.2e}")
    # timed on the mixed-step pack at the engine's block_q, f32
    _, sid_np, qpos_np, kvl_np, _ = pack_plan(mixed_plan, mixed_bq, 4)
    sid, qp = torch.as_tensor(sid_np, device=dev), torch.as_tensor(qpos_np, device=dev)
    kvl = torch.as_tensor(kvl_np, device=dev)
    kp, vp, tbl, _, _ = _paged_pool(gen, dev, kvl_np.tolist(), n_tbl, page, hkv, d, torch.float32)
    qv = torch.randn(len(sid_np), hq, d, generator=gen, device=dev)
    k4_ms = _time_ms(lambda: k4.flashd_varlen(qv, kp, vp, tbl, sid, qp, kvl, block_q=mixed_bq),
                     reps=20, flush=flush)
    k4_plain_ms = _time_ms(lambda: k4.flashd_varlen_plain(qv, kp, vp, tbl, sid, qp, kvl,
                                                          block_q=mixed_bq), reps=20, flush=flush)
    # the library yardstick: one SDPA call with a boolean mask over each
    # row's gathered sequence (the gather is set-up, not timed)
    rows = torch.clamp(sid.long(), min=0)
    kg = gather_pages(kp, tbl)[rows].transpose(1, 2)  # [T, Hkv, S, d]
    vg = gather_pages(vp, tbl)[rows].transpose(1, 2)
    pos = torch.arange(max_len, device=dev)
    vis = (pos[None] <= qp.long()[:, None]) & (pos[None] < kvl.long()[rows][:, None])
    k4_lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qv[:, :, None], kg, vg, attn_mask=vis[:, None, None, :], enable_gqa=True),
        reps=20, flush=flush)
    qvb, kpb, vpb = qv.bfloat16(), kp.bfloat16(), vp.bfloat16()
    k4_bf16_ms = _time_ms(lambda: k4.flashd_varlen(qvb, kpb, vpb, tbl, sid, qp, kvl,
                                                   block_q=mixed_bq), reps=20, flush=flush)
    kgb, vgb = kg.bfloat16(), vg.bfloat16()
    k4_lib_bf16_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qvb[:, :, None], kgb, vgb, attn_mask=vis[:, None, None, :], enable_gqa=True),
        reps=20, flush=flush)
    del kgb, vgb
    n_vis = int(vis[qp >= 0].sum())  # (row, key) pairs this pack needs
    k4_ops = 4 * d * hq * n_vis
    live_tok = sum(int(kvl_np[sl]) for sl in {seg.slot for seg in mixed_plan.segments})
    n_rows = int((qp >= 0).sum())
    k4_bytes = 2 * live_tok * hkv * d * 4 + 2 * n_rows * hq * d * 4
    k4_bound = _bytes_bound(k4_bytes, k4_ops)
    k4_bf16_bound = _bytes_bound(k4_bytes / 2, k4_ops)
    k4_bound_by = "operations" if k4_ops / PEAK_OPS["float32"] > k4_bytes / HBM_BYTES_PER_S \
        else "bytes"
    k4_dev_ms = _device_ms(lambda: k4.flashd_varlen(qv, kp, vp, tbl, sid, qp, kvl,
                                                    block_q=mixed_bq), flush)
    k4_bf16_dev_ms = _device_ms(lambda: k4.flashd_varlen(qvb, kpb, vpb, tbl, sid, qp, kvl,
                                                         block_q=mixed_bq), flush)
    k4_repeat = all(torch.equal(k4.flashd_varlen(qv, kp, vp, tbl, sid, qp, kvl, block_q=mixed_bq),
                                k4.flashd_varlen(qv, kp, vp, tbl, sid, qp, kvl, block_q=mixed_bq))
                    for _ in range(2))
    assert k4_repeat, "K4 is not bitwise repeatable"
    # four whole prompts of 512 at the engine's block_q: every block takes the
    # tensor-core body; SDPA's causal call on the gathered prompts is the yardstick
    n_pr, s_pr = 4, 512
    prompts_plan = StepPlan(segments=tuple(
        Segment(slot=i, tokens=np.zeros(s_pr, np.int32), start=0, emits=True)
        for i in range(n_pr)), n_tokens=n_pr * s_pr)
    _, sid_np4, qpos_np4, kvl_np4, _ = pack_plan(prompts_plan, mixed_bq, n_pr)
    sid4, qp4, kvl4 = (torch.as_tensor(x, device=dev) for x in (sid_np4, qpos_np4, kvl_np4))
    kp4, vp4, tbl4, _, _ = _paged_pool(gen, dev, kvl_np4.tolist(), n_tbl, page, hkv, d,
                                       torch.float32)
    q4 = torch.randn(len(sid_np4), hq, d, generator=gen, device=dev)
    pr_args = {"f32": (q4, kp4, vp4), "bf16": (q4.bfloat16(), kp4.bfloat16(), vp4.bfloat16())}
    pr_err = {}
    for dt, x in pr_args.items():
        o4 = k4.flashd_varlen(*x, tbl4, sid4, qp4, kvl4, block_q=mixed_bq)
        pr_err[dt] = _err(o4, k4.flashd_varlen_plain(*x, tbl4, sid4, qp4, kvl4, block_q=mixed_bq))
        assert torch.isfinite(o4).all() and pr_err[dt] <= (F32_TOL if dt == "f32" else BF16_TOL), \
            ("prompt pack", dt, pr_err[dt])
    k4_err = max(k4_err, pr_err["f32"])
    pr_t = {}
    for dt, x in pr_args.items():
        fn = lambda x=x: k4.flashd_varlen(*x, tbl4, sid4, qp4, kvl4, block_q=mixed_bq)
        pr_t[dt] = (_time_ms(fn, reps=20, flush=flush), _device_ms(fn, flush))
    sd = [x.reshape(n_pr, s_pr, hq, d).transpose(1, 2).contiguous() for x in (q4,)]
    sd += [gather_pages(p_, tbl4).transpose(1, 2).contiguous() for p_ in (kp4, vp4)]
    pr_lib = {dt: _time_ms(lambda x=[y.to(dtype) for y in sd]: F.scaled_dot_product_attention(
        *x, is_causal=True, enable_gqa=True), reps=20, flush=flush)
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    del sd
    pr_ops = 4 * d * hq * n_pr * s_pr * (s_pr + 1) // 2
    pr_elems = 2 * n_pr * s_pr * hq * d + 2 * n_pr * s_pr * hkv * d  # q, O; live K, V
    pr_bounds = _attn_bounds(pr_ops, 4 * pr_elems, 2 * pr_elems)
    _line(8, f"K4 flashd_varlen f32 max|Δ| vs plain (NaN page 0, page {page}, window 50 too): "
             f"{'; '.join(k4_report)} (bound {F32_TOL}; bf16 {BF16_TOL}); padding rows exactly 0; "
             f"mixed-step pack (T {len(sid_np)}, block_q {mixed_bq}, {n_rows} rows, {live_tok} "
             f"live tokens) f32: kernel {k4_ms * 1e3:.1f} us, plain {k4_plain_ms * 1e3:.1f} us, "
             f"sdpa with a boolean mask over the gathered rows {k4_lib_ms * 1e3:.1f} us, bound "
             f"{k4_bound * 1e3:.2f} us ({k4_bound_by}); bf16: kernel {k4_bf16_ms * 1e3:.1f} us, "
             f"sdpa {k4_lib_bf16_ms * 1e3:.1f} us, bound {k4_bf16_bound * 1e3:.2f} us; device time "
             f"of the kernel {k4_dev_ms * 1e3:.2f} us f32, {k4_bf16_dev_ms * 1e3:.2f} us bf16; "
             f"bitwise equal on repeat calls: {k4_repeat}; {n_pr} whole prompts of {s_pr} (T "
             f"{len(sid_np4)}, block_q {mixed_bq}): max|Δ| vs plain f32 {pr_err['f32']:.2e}, bf16 "
             f"{pr_err['bf16']:.2e}; "
             + "; ".join(f"{dt} kernel {ev * 1e3:.1f} us (device {dv * 1e3:.1f} us), sdpa causal "
                         f"{pr_lib[dt] * 1e3:.1f} us" for dt, (ev, dv) in pr_t.items())
             + "; " + _fmt_bounds({k_: pr_bounds[k_] for k_ in ("3xtf32", "bf16")}, pr_ops,
                                  {"kernel f32": pr_t["f32"][1], "kernel bf16": pr_t["bf16"][1]})
             + f" {ph}")

    # ---- 9. the paged and mixed loops at full width: kernels vs plain ----
    ph = _Phase()
    pool_report = []
    pool_launches = {"flashd_decode_paged": 0, "flashd_varlen": 0}
    pool_tps = {}  # captured tok/s per loop, beside phase 16's speculative runs

    def pool_serve(eng, requests):
        """One serve() of a paged or mixed engine: tokens, seconds, TTFT, and
        what the call added to the engine's counters."""
        before, st0, graphs0 = launch_counts(), eng.stats(), eng._steps.captures
        t = time.perf_counter()
        toks_out = eng.serve(requests, 32)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        eng._alloc.check()
        st = eng.stats()
        assert st["pages_in_use"] == st["cached_pages"], "pages leaked"  # the tree's alone
        return dict(toks=toks_out, s=dt, ttft=float(np.mean(list(eng.ttft.values()))),
                    syncs=eng.host_syncs, stats=st, captures=eng._steps.captures,
                    capture_s=eng._steps.capture_s, new_graphs=eng._steps.captures - graphs0,
                    hits=st["prefix_hits"] - st0["prefix_hits"],
                    hit_tokens=st["hit_tokens"] - st0["hit_tokens"],
                    launched=tuple(a - b for a, b in zip(launch_counts(), before)),
                    layout=eng._page_layout)

    for mode, kw in (("paged", dict(kv_layout="paged")), ("mixed", dict(step_mode="mixed"))):
        psc = ServeConfig(max_batch=4, max_len=512, **kw)
        reset_counts()  # this path's main-path run (captured steps) starts here
        out = {"captured": pool_serve(Engine(params, cfg, psc, device=dev), reqs)}
        got = dict(zip(pool_launches, counts()[2:4]))
        assert got["flashd_decode_paged"] > 0, (mode, got)
        assert (got["flashd_varlen"] > 0) == (mode == "mixed"), (mode, got)
        for name in pool_launches:
            pool_launches[name] += got[name]
        oracle = {g: _oracle(Engine(params, cfg, psc, device=dev, graphs=g), None, short)
                  for g in (None, False)}
        oracle_text = _check_oracle(mode, oracle)
        # the plain path (captured) on the oracle's short workload: the kernel
        # path's tokens there, and no launch
        seen = counts()
        plain_short = _oracle(Engine(params, plain_cfg, psc, device=dev), None, short)
        assert counts() == seen, f"{mode}: the plain path launched a kernel"
        for a, c in zip(oracle[None]["toks"], plain_short["toks"]):
            assert np.array_equal(a, c), f"{mode}: kernel and plain tokens differ"
        k = out["captured"]
        pool_tps[mode] = n_serve / k["s"]
        for a, d_ in zip(k["toks"], kern["serve"]):
            assert np.array_equal(a, d_), f"{mode}: tokens differ from the contiguous loop"
        st = k["stats"]
        n_short = sum(map(len, plain_short["toks"]))
        pool_report.append(
            f"{mode}: tokens identical (captured = contiguous; kernel = plain on the short "
            f"workload); captured ({k['captures']} graphs, {k['capture_s']:.2f} s of warm-up "
            f"runs and captures included) {n_serve / k['s']:.1f} tok/s, mean TTFT "
            f"{k['ttft'] * 1e3:.1f} ms; plain (captured, the short workload, fresh engine) "
            f"{n_short / plain_short['s']:.1f} tok/s; "
            f"K3/K4 launches {k['launched'][1:]}, host syncs {k['syncs']}; "
            f"{oracle_text}; pool {st['kv_pool_bytes']} B "
            f"({st['kv_bytes_per_token']:.0f} B/token, {st['kv_dtype']}), preemptions "
            f"{st['preemptions']}, prefix lookups {st['prefix_lookups']}, hit tokens "
            f"{st['hit_tokens']}")
    # one paged decode step (K3) and one packed step (K4) of the loops' shapes
    # (phase 8's mixed-step pack), eager and captured
    lay = out["captured"]["layout"]
    del out
    pcache = init_decode_cache(4, 512, cfg, layout="paged", page_size=lay.page_size,
                               n_pages=lay.n_pages, device=dev)
    rows_tbl = torch.arange(1, lay.n_pages, dtype=torch.int32, device=dev)
    rows_tbl = rows_tbl[: 4 * lay.pages_per_seq].reshape(4, lay.pages_per_seq)
    for group in pcache.values():
        for leaves in group.values():
            leaves["tbl"][:] = rows_tbl
    pack = [torch.as_tensor(a, device=dev).long() for a in pack_plan(mixed_plan, mixed_bq, 4)]
    pack[0] = torch.as_tensor(rng.integers(0, cfg.vocab_size, len(sid_np)), device=dev)
    paged_step = lambda: decode_step_lm(params, pcache, tok4, at, cfg)
    packed_step = lambda: forward_packed(params, pack[0], pack[1], pack[2], pack[3], pcache, cfg,
                                         pack[4], block_q=mixed_bq)
    steps, captured = StepGraphs(dev, graphs=True), {}
    paged_bd = [_breakdown("eager paged decode step B4 pos300", paged_step),
                _breakdown("captured", lambda: steps.run(captured, "paged", paged_step))]
    packed_bd = [
        _breakdown(f"eager packed step T{len(sid_np)} (3 decode rows + a 16-row chunk, block_q "
                   f"{mixed_bq})", packed_step),
        _breakdown("captured", lambda: steps.run(captured, "packed", packed_step))]
    del pcache, steps, captured
    # shared-prefix traffic: 8 requests, one 256-token system prompt, 16-64-token
    # tails. Each engine first serves the same tails behind another system
    # prompt, so the timed call finds its graphs captured and only its own
    # system prompt uncached. Then the cache-on engine's TTFT of a lone
    # request, cold and warm.
    tails = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
             for n in rng.integers(16, 65, 8)]
    primer, system = (rng.integers(0, cfg.vocab_size, (256,)).astype(np.int32) for _ in range(2))
    shared = [np.concatenate([system, x]) for x in tails]
    shared_report = []
    for mode, kw in (("paged", dict(kv_layout="paged")), ("mixed", dict(step_mode="mixed"))):
        psc = ServeConfig(max_batch=4, max_len=512, **kw)
        on, off = (Engine(params, cfg, c, device=dev)
                   for c in (psc, dataclasses.replace(psc, prefix_cache=False)))
        for eng in (on, off):
            eng.serve([np.concatenate([primer, x]) for x in tails], 32)
        run_on, run_off = (pool_serve(eng, shared) for eng in (on, off))
        for a, b_ in zip(run_on["toks"], run_off["toks"]):
            assert np.array_equal(a, b_), f"{mode}: the prefix cache changed the tokens"
        st = run_on["stats"]
        assert run_on["hit_tokens"] > 0 and run_off["stats"]["hit_tokens"] == 0, (mode, st)
        # one request alone, cold (a system prompt the engine has not seen), then
        # one sharing its prompt, warm; the second such pair is the one timed
        for fresh in (rng.integers(0, cfg.vocab_size, (256,)).astype(np.int32)
                      for _ in range(2)):
            pair = {}
            for name, tail in (("cold", tails[0]), ("warm", tails[1])):
                hits0, graphs0 = on.stats()["hit_tokens"], on._steps.captures
                on.serve([np.concatenate([fresh, tail])], 32)
                pair[name] = (on.ttft[0], on.stats()["hit_tokens"] - hits0,
                              on._steps.captures - graphs0)
        assert pair["cold"][1] == 0 and pair["warm"][1] > 0, (mode, pair)
        n_sh = sum(len(o) for o in run_on["toks"])
        shared_report.append(
            f"{mode}: cache on {n_sh / run_on['s']:.1f} tok/s, mean TTFT "
            f"{run_on['ttft'] * 1e3:.1f} ms, {run_on['hits']} of 8 admissions hit, "
            f"{run_on['hit_tokens']} of {sum(map(len, shared))} prompt tokens cached; cache off "
            f"{n_sh / run_off['s']:.1f} tok/s, mean TTFT {run_off['ttft'] * 1e3:.1f} ms; "
            f"graphs captured by the timed calls {run_on['new_graphs']} / "
            f"{run_off['new_graphs']}; tokens identical; one request alone: cold TTFT "
            f"{pair['cold'][0] * 1e3:.1f} ms ({len(tails[0]) + 256} prompt tokens prefilled), "
            f"warm TTFT {pair['warm'][0] * 1e3:.1f} ms ({pair['warm'][1]} of "
            f"{len(tails[1]) + 256} cached), graphs captured by the pair "
            f"{pair['cold'][2] + pair['warm'][2]}")
    del on, off, eng
    reset_counts()
    eng = Engine(params, bcfg, ServeConfig(max_batch=4, max_len=512, step_mode="mixed"),
                 device=dev)
    t = time.perf_counter()
    out_mb = eng.serve(reqs, 32)
    serve_mb = time.perf_counter() - t
    assert k4.launches > 0 and k2.paged_launches > 0
    ttft_mb = float(np.mean(list(eng.ttft.values())))
    del eng
    _line(9, f"qwen3-0.6b f32 full width, 8 requests as phase 5, max_batch 4, max_len 512, "
             f"prefix cache on: {'; '.join(pool_report)}; launches {pool_launches}; "
             f"{'; '.join(paged_bd)}; {'; '.join(packed_bd)}; shared-prefix traffic (8 requests, "
             f"a 256-token system prompt + {min(map(len, shared)) - 256}-"
             f"{max(map(len, shared)) - 256}-token tails, 32 new, captured): "
             f"{'; '.join(shared_report)}; bf16 mixed (captured): "
             f"{sum(map(len, out_mb)) / serve_mb:.1f} tok/s, mean TTFT {ttft_mb * 1e3:.1f} ms "
             f"(contiguous bf16, phase 6: {sum(map(len, out_b)) / serve_b:.1f} tok/s, "
             f"{ttft_b * 1e3:.1f} ms) {ph}")

    # ---- 10. K5 against its plain version, at the training widths ----
    ph = _Phase()
    bt, st = 2, 1024

    def bwd_operands(sq, skv, dtype, mask):
        """[B, H, S, d] views of model-layout tensors, with the forward's
        saved (O, Λ) from the plain version."""
        qv, dov = (torch.randn(bt, sq, hq, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
                   for _ in range(2))
        kv, vv = (torch.randn(bt, skv, hkv, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
                  for _ in range(2))
        o_, lam_ = k1.flashd_fwd_plain(qv, kv, vv, mask=mask)
        return qv, kv, vv, o_, lam_, dov

    def grad_err(got, want, dtype):
        """max |Δ| over dQ, dK, dV; asserts the bound of `dtype`."""
        worst = 0.0
        for a, w in zip(got, want):
            diff = (a.float() - w.float()).abs()
            if dtype == torch.float32:
                ok = bool((diff <= GRAD_ATOL + GRAD_RTOL * w.float().abs()).all())
            else:
                ok = float(diff.max()) <= GRAD_BF16 * float(w.float().abs().max())
            assert ok and torch.isfinite(a).all(), ("K5", dtype, float(diff.max()))
            worst = max(worst, float(diff.max()))
        return worst

    bcases = [
        ("causal", st, st, MaskSpec("causal")),
        ("full", st, st, MaskSpec("full")),
        ("local256", st, st, MaskSpec("local", window=256)),
        ("chunked512", st, st, MaskSpec("chunked", chunk=512)),
        ("ragged S=1000 causal", 1000, 1000, MaskSpec("causal")),
        ("causal q_offset=-100 (dead rows)", st, st, MaskSpec("causal", q_offset=-100)),
    ]
    k5_err, k5_report = 0.0, []
    for dtype in (torch.float32, torch.bfloat16):
        for name, sq_, skv_, mask in bcases:
            args = bwd_operands(sq_, skv_, dtype, mask)
            got = k5.flashd_bwd(*args, mask=mask)
            e = grad_err(got, k5.flashd_bwd_plain(*args, mask=mask), dtype)
            if mask.q_offset < 0:
                assert (got[0][:, :, :-mask.q_offset] == 0).all(), "dead rows carry a gradient"
            if dtype == torch.float32:
                k5_err = max(k5_err, e)
            k5_report.append(f"{name} {'f32' if dtype == torch.float32 else 'bf16'} {e:.2e}")
    args = bwd_operands(st, st, torch.float32, causal)
    first = k5.flashd_bwd(*args, mask=causal)
    deterministic = all(torch.equal(a, b_) for a, b_ in zip(first, k5.flashd_bwd(*args, mask=causal)))
    assert deterministic, "K5 is not deterministic"
    k5_ms = _time_ms(lambda: k5.flashd_bwd(*args, mask=causal), flush=flush)
    k5_plain_ms = _time_ms(lambda: k5.flashd_bwd_plain(*args, mask=causal), flush=flush)
    q_l, k_l, v_l = (x.contiguous().requires_grad_() for x in args[:3])
    o_l = F.scaled_dot_product_attention(q_l, k_l, v_l, is_causal=True, enable_gqa=True)
    do_l = args[5].contiguous()
    k5_lib_ms = _time_ms(lambda: torch.autograd.grad(o_l, (q_l, k_l, v_l), do_l, retain_graph=True),
                         flush=flush)
    del q_l, k_l, v_l, o_l, do_l
    args_b = bwd_operands(st, st, torch.bfloat16, causal)
    k5_bf16_ms = _time_ms(lambda: k5.flashd_bwd(*args_b, mask=causal), flush=flush)
    q_l, k_l, v_l = (x.contiguous().requires_grad_() for x in args_b[:3])
    o_l = F.scaled_dot_product_attention(q_l, k_l, v_l, is_causal=True, enable_gqa=True)
    do_l = args_b[5].contiguous()
    k5_lib_bf16_ms = _time_ms(lambda: torch.autograd.grad(o_l, (q_l, k_l, v_l), do_l,
                                                          retain_graph=True), flush=flush)
    del q_l, k_l, v_l, o_l, do_l, args_b
    k5_pairs = bt * st * (st + 1) // 2
    k5_ops = 10 * d * k5_pairs * hq  # s, dO·Vᵀ, dQ, dK, dV: 2·d flops each per visible pair
    # q, O, dO, k, v read once and dQ, dK, dV written once (operand dtype); Λ read (f32)
    k5_elems = bt * st * d * (3 * hq + 2 * hkv) + bt * st * d * (hq + 2 * hkv)
    k5_bounds = _attn_bounds(k5_ops, 4 * k5_elems + 4 * bt * hq * st,
                             2 * k5_elems + 4 * bt * hq * st)
    k5_bound, k5_bound_by = k5_bounds["3xtf32"]  # the f32 kernel's datapath
    _line(10, f"K5 flashd_bwd max|Δ| vs plain (B {bt}, Hq {hq}, Hkv {hkv}, d {d}): "
              f"{', '.join(k5_report)} (f32 bound rtol {GRAD_RTOL} atol {GRAD_ATOL} per entry; "
              f"bf16 {GRAD_BF16:.4f}·max|grad|); bitwise equal on a second run: {deterministic}; "
              f"causal S={st} f32: kernel {k5_ms:.3f} ms, plain {k5_plain_ms:.3f} ms, sdpa "
              f"backward {k5_lib_ms:.3f} ms; bf16: kernel {k5_bf16_ms:.3f} ms, sdpa backward "
              f"{k5_lib_bf16_ms:.3f} ms; "
              + _fmt_bounds(k5_bounds, k5_ops, {"kernel f32": k5_ms, "kernel bf16": k5_bf16_ms,
                                                "sdpa bwd f32": k5_lib_ms,
                                                "sdpa bwd bf16": k5_lib_bf16_ms})
              + f" {ph}")

    # ---- 11. K6 against its plain version and K1; K1 vs K6 at phase 3's shape ----
    ph = _Phase()
    k6_err, k6_report = 0.0, []
    for name, mask in (("causal", MaskSpec("causal")), ("full", MaskSpec("full")),
                       ("local256", MaskSpec("local", window=256)),
                       ("chunked512", MaskSpec("chunked", chunk=512)),
                       ("causal q_offset=-100 (dead rows)", MaskSpec("causal", q_offset=-100))):
        o, lam = k6.fa2_fwd(qt, kt, vt, mask=mask)
        o_p, lam_p = k6.fa2_fwd_plain(qt, kt, vt, mask=mask)
        o_1, lam_1 = k1.flashd_fwd(qt, kt, vt, mask=mask)
        torch.cuda.synchronize()
        e, e1 = max(_err(o, o_p), _err(lam, lam_p)), max(_err(o, o_1), _err(lam, lam_1))
        assert torch.isfinite(o).all() and e <= F32_TOL and e1 <= F32_TOL, (name, e, e1)
        if mask.q_offset < 0:
            assert (o[:, :, :100] == 0).all() and (lam[:, :, :100] == NEG_INF).all(), "dead rows"
        k6_err = max(k6_err, e)
        k6_report.append(f"{name} {e:.2e} (vs K1 {e1:.2e})")
    # at the FA2 training path's own shape (phase 12: B 2 x S 1024, model-layout views)
    qv, kv, vv = (torch.randn(bt, st, h, d, generator=gen, device=dev).transpose(1, 2)
                  for h in (hq, hkv, hkv))
    o, lam = k6.fa2_fwd(qv, kv, vv, mask=causal)
    o_p, lam_p = k6.fa2_fwd_plain(qv, kv, vv, mask=causal)
    e6_train = max(_err(o, o_p), _err(lam, lam_p))
    assert torch.isfinite(o).all() and e6_train <= F32_TOL, ("fa2 at the training shape", e6_train)
    k6_err = max(k6_err, e6_train)
    k6_report.append(f"causal B{bt} S{st} (training shape) {e6_train:.2e}")
    del qv, kv, vv, o, lam, o_p, lam_p
    q16, k16, v16 = qt.bfloat16(), kt.bfloat16(), vt.bfloat16()
    e6_bf16 = _err(k6.fa2_fwd(q16, k16, v16)[0], k6.fa2_fwd_plain(q16, k16, v16)[0])
    assert e6_bf16 <= BF16_TOL, ("bf16 fa2", e6_bf16)
    turns = {}  # (kernel, dtype) → ms, in turns K1 K6 K6 K1 on one card
    for dtype, x in (("f32", (qt, kt, vt)), ("bf16", (q16, k16, v16))):
        for who in ("K1", "K6", "K6", "K1"):
            fn = k1.flashd_fwd if who == "K1" else k6.fa2_fwd
            turns.setdefault((who, dtype), []).append(
                _time_ms(lambda: fn(*x, mask=causal), flush=flush))
    best = {key: min(ts) for key, ts in turns.items()}
    k1_turn_ms, k6_ms, k6_bf16_ms = best["K1", "f32"], best["K6", "f32"], best["K6", "bf16"]
    k6_lib_ms, k6_lib_bf16_ms = sdpa_ms(torch.float32), sdpa_ms(torch.bfloat16)
    k6_plain_ms = _time_ms(lambda: k6.fa2_fwd_plain(qt, kt, vt, mask=causal), flush=flush)
    in_turns = "; ".join(f"{who} {dt} {ts}" for (who, dt), ts in turns.items())
    _line(11, f"K6 fa2_fwd f32 max|Δ| vs plain: {', '.join(k6_report)} (bound {F32_TOL}); bf16 "
              f"{e6_bf16:.2e} (bound {BF16_TOL}); causal S={s}, timed in turns K1 K6 K6 K1 (ms): "
              f"{in_turns}; FLASH-D / FA2 = {k1_turn_ms / k6_ms:.3f} f32, "
              f"{best['K1', 'bf16'] / k6_bf16_ms:.3f} bf16; plain FA2 {k6_plain_ms:.3f} ms; sdpa "
              f"{k6_lib_ms:.4f} ms f32, {k6_lib_bf16_ms:.4f} ms bf16; "
              + _fmt_bounds(fwd_bounds, k1_ops, {"K6 f32": k6_ms, "K6 bf16": k6_bf16_ms,
                                                 "K1 f32": k1_turn_ms,
                                                 "K1 bf16": best["K1", "bf16"]})
              + f" {ph}")

    # ---- 12. full-width qwen3-0.6b training: kernel, plain and FA2 paths ----
    ph = _Phase()
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=st, global_batch=bt, seed=0))
    t = time.perf_counter()
    batches = [{k_: torch.as_tensor(x, device=dev) for k_, x in data.batch(i).items()}
               for i in range(4)]
    data_s = time.perf_counter() - t
    tc = TrainConfig(warmup_steps=0, total_steps=4)  # the lr peaks at step 0: every step updates

    def train(model_cfg, steps=4):
        """`steps` steps from the seeded init → (state, step fn, [(loss,
        grad norm)], seconds per step); one host sync per step."""
        state = init_train_state(model_cfg, tc, device=dev, seed=0)
        step_fn = make_train_step(model_cfg, tc)
        curve, secs = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step_fn(state, batches[i])
            curve.append(torch.stack([m["loss"], m["grad_norm"]]).tolist())
            secs.append(time.perf_counter() - t)
        return state, step_fn, curve, secs

    def agree(label, got, want):
        for i, (a, w) in enumerate(zip(got, want)):
            rel = TRAIN_REL[0] if i == 0 else TRAIN_REL[1]
            for x, y, what in ((a[0], w[0], "loss"), (a[1], w[1], "grad norm")):
                assert np.isfinite(x) and abs(x - y) <= rel * abs(y), (label, i, what, x, y)
        return max(abs(a[j] - w[j]) / abs(w[j]) for a, w in zip(got, want) for j in (0, 1))

    tok = bt * st
    reset_counts()  # the training kernel path's run starts here
    state_k, step_k, curve_k, secs_k = train(dataclasses.replace(cfg, attn_impl="flashd_gpu"))
    train_launches = {"flashd_fwd": k1.launches, "flashd_bwd": k5.launches}
    assert min(train_launches.values()) > 0 and k6.launches == 0, train_launches
    train_profile = _breakdown(f"train step B{bt} S{st}", lambda: step_k(state_k, batches[0]),
                               steps=2, train=True,
                               watch=("flashd_fwd_kernel", "flashd_bwd_"))
    del state_k, step_k
    seen = counts()
    _, _, curve_p, secs_p = train(dataclasses.replace(cfg, attn_impl="flashd_plain"))
    assert counts() == seen, "the plain training path launched a kernel"
    reset_counts()  # the FA2 training path's run starts here
    _, _, curve_f, secs_f = train(dataclasses.replace(cfg, attn_impl="fa2_gpu"))
    train_launches["fa2_fwd"] = k6.launches
    assert k6.launches > 0 and k5.launches > 0 and k1.launches == 0
    rel_k, rel_f = agree("kernel", curve_k, curve_p), agree("fa2", curve_f, curve_p)
    bcfg_train = dataclasses.replace(qwen, attn_impl="flashd_gpu")  # bf16 compute
    _, _, curve_b, secs_b = train(bcfg_train)
    loss_b = curve_b[0][0]
    assert np.isfinite(loss_b) and abs(loss_b - curve_p[0][0]) <= BF16_LOSS_REL * curve_p[0][0], \
        ("bf16 loss", loss_b, curve_p[0][0])
    fmt = lambda secs: ", ".join(f"{tok / x:.0f}" for x in secs)
    med = lambda secs: tok / float(np.median(secs))
    _line(12, f"qwen3-0.6b f32 training, {cfg.n_layers} layers, B {bt} x S {st} SyntheticLM "
              f"(4 batches built in {data_s:.1f} s of host time), AdamW lr peak "
              f"{tc.optimizer.lr}, remat {cfg.remat}: loss/grad norm per step kernel "
              f"{curve_k}, plain {curve_p}, fa2 {curve_f}; largest relative gap vs plain kernel "
              f"{rel_k:.2e}, fa2 {rel_f:.2e} (bounds {TRAIN_REL[0]} at step 0, {TRAIN_REL[1]} "
              f"after); tokens/s per step kernel [{fmt(secs_k)}], plain [{fmt(secs_p)}], fa2 "
              f"[{fmt(secs_f)}]; bf16 step 0 loss {loss_b:.6f} vs f32 {curve_p[0][0]:.6f} "
              f"(bound {BF16_LOSS_REL} relative), tokens/s per step bf16 [{fmt(secs_b)}]; "
              f"median of the 4 steps kernel f32 {med(secs_k):.0f}, bf16 {med(secs_b):.0f} "
              f"tokens/s; launches "
              f"{train_launches}; {train_profile} {ph}")

    # ---- 13. lifecycle: bitwise resume after a fault, checkpoint → serve ----
    ph = _Phase()
    lcfg = dataclasses.replace(cfg, n_layers=2, attn_impl="flashd_gpu")
    ldata = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=bt, seed=1))
    n_life, every, fault_at = 4, 2, 3  # steps; checkpoints of the faulted run; its fault
    ltc = TrainConfig(warmup_steps=0, total_steps=n_life)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=os.path.join(HERE, "build"))
    try:
        # the clean run: the same steps with no checkpoint (train_resilient's fault-free
        # path runs them so, and would only add a final checkpoint); the faulted run
        # restores from the checkpoint before its fault and replays from there
        clean = init_train_state(lcfg, ltc, device=dev, seed=0)
        clean_step, clean_curve = make_train_step(lcfg, ltc), []
        for i in range(n_life):
            clean, cm = clean_step(clean, {k_: torch.as_tensor(x, device=dev)
                                           for k_, x in ldata.batch(i).items()})
            clean_curve.append(float(cm["loss"]))
        del clean_step, cm
        inj = FaultInjector(schedule=[("grad_step", fault_at)])
        got, hist, ctr = train_resilient(
            ckpt_dir=os.path.join(root, "faulted"), injector=inj, model_cfg=lcfg, train_cfg=ltc,
            data=ldata, total_steps=n_life, device=dev,
            res=ResilienceConfig(ckpt_every=every, keep_checkpoints=1))
        assert ctr["restarts"] == 1 and ctr["faults"] == 1, ctr
        got_curve = [h["loss"] for h in hist]
        assert got_curve == clean_curve, ("resume is not bitwise", got_curve, clean_curve)
        assert all(torch.equal(a, b_) for a, b_ in zip(tree_leaves(clean), tree_leaves(got))), \
            "the resumed run's final state differs"
        restored, extra = ckpt.restore(os.path.join(root, "faulted"),
                                       init_train_state(lcfg, ltc, device=dev, seed=7))
        prompts = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        lsc = ServeConfig(max_batch=2, max_len=64)
        want = Engine(got.params, lcfg, lsc, device=dev).generate(prompts, 16)
        served = Engine(restored.params, lcfg, lsc, device=dev).generate(prompts, 16)
        assert np.array_equal(served, want), "restored weights serve other tokens"
        ck_bytes = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(root)
                       for f in fs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _line(13, f"lifecycle, qwen3-0.6b full width at {lcfg.n_layers} layers, B {bt} x S 256, "
              f"{n_life} steps, checkpoint every {every}: a grad_step fault at step {fault_at} "
              f"→ {ctr['restarts']} "
              f"restart, loss curve bitwise equal to the clean run {got_curve}; checkpoint "
              f"(step {extra['data_step']}, {ck_bytes / 2**30:.2f} GiB on disk at the end) "
              f"restored into serve.Engine gives the in-memory weights' 2x16 greedy tokens {ph}")
    del clean, got, restored, batches  # three train states no later phase reads

    # ---- 15. the quantized pool (A8): int8 and fp8 through the paged and mixed loops ----
    ph = _Phase()
    from repro_torch.models.transformer import _packed_attn, _paged_attn_step
    from repro_torch.runtime import quant

    short = [reqs[i] for i in sorted(range(len(reqs)), key=lambda i: len(reqs[i]))[:4]]
    quant_report, quant_launches, quant_toks, quant_engines = [], {}, {}, {}
    quant_short = {}  # the captured int8 paged run on the 4 shortest (phase 17's baseline)
    for kv in ("int8", "fp8"):
        for mode, kw in (("paged", dict(kv_layout="paged")), ("mixed", dict(step_mode="mixed"))):
            qsc = ServeConfig(max_batch=4, max_len=512, kv_dtype=kv, **kw)
            eng = Engine(params, cfg, qsc, device=dev)
            reset_counts()  # this path's main-path run (captured steps) starts here
            run = pool_serve(eng, reqs)
            got = (k2.paged_launches, k4.launches)
            assert got[0] > 0 and (got[1] > 0) == (mode == "mixed"), (kv, mode, got)
            quant_launches[kv, mode] = got
            seen = counts()
            plain_run = pool_serve(Engine(params, plain_cfg, qsc, device=dev), reqs)
            assert counts() == seen, f"{kv} {mode}: the plain path launched a kernel"
            # kernel and plain attention differ by summation order (≤ 5e-5); on a
            # byte pool that can move a later layer's K/V across a rounding edge,
            # so the streams are compared (and held teacher-forced below)
            vs_plain = _agreement(run["toks"], plain_run["toks"])
            # the eager oracle on phase 5's short workload (fresh engines, both)
            oracle_engines = {g: Engine(params, cfg, qsc, device=dev, graphs=g)
                              for g in (None, False)}
            oracle = {g: _oracle(e, None, short[:2]) for g, e in oracle_engines.items()}
            oracle_text = _check_oracle(f"{kv} {mode}", oracle)
            for e in oracle_engines.values():
                e._alloc.check()
                assert e.stats()["pages_in_use"] == e.stats()["cached_pages"], "pages leaked"
            del oracle_engines
            if (kv, mode) == ("int8", "paged"):  # phase 17's baseline: the 4 shortest alone
                quant_short[kv, mode] = pool_serve(Engine(params, cfg, qsc, device=dev),
                                                   short)["toks"]
                by_req = {id(r): t for r, t in zip(reqs, run["toks"])}
                in_8 = [by_req[id(r)] for r in short]
                oracle_text += (f"; the 4 shortest alone against the same requests in the "
                                f"8-request run: {_agreement(quant_short[kv, mode], in_8)}")
            qst = run["stats"]
            assert qst["kv_dtype"] == kv and eng._paged.cache["blocks"]["pos0"]["k_pages"].dtype \
                == quant.get_spec(kv).dtype
            eng._alloc.check(eng._paged.cache)
            quant_toks[kv, mode], quant_engines[kv, mode] = run["toks"], eng
            quant_report.append(
                f"{kv} {mode}: captured {n_serve / run['s']:.1f} tok/s, mean TTFT "
                f"{run['ttft'] * 1e3:.1f} ms ({oracle_text}); "
                f"kernel vs plain tokens {vs_plain}; vs the native pool's "
                f"{_agreement(run['toks'], kern['serve'])}; kv_bytes_per_token "
                f"{qst['kv_bytes_per_token']:.1f} (page {eng._page_layout.page_size}, "
                f"{eng._page_layout.n_pages} pages)")
        quant_report.append(f"{kv} paged vs mixed tokens "
                            f"{_agreement(quant_toks[kv, 'paged'], quant_toks[kv, 'mixed'])}")
    # teacher-forced: the 4 shortest requests' prompt + paged-loop tokens, one
    # decode step a position on a page-64 pool, the kernel path on a byte pool
    # against the plain path on the same format (the drift a summation order
    # causes through the rounding) and against the native pool (the format's
    # own drift); max |Δ log p| over the vocab, the reference's int8 bound 0.1
    # (tests/test_quant.py::test_logprob_drift_bound)
    drift = {}
    for kv in ("int8", "fp8"):
        streams = [np.concatenate([r, t_]) for r, t_ in zip(reqs, quant_toks[kv, "paged"])
                   if any(r is x for x in short)]
        n_f = min(map(len, streams))
        streams = torch.as_tensor(np.stack([x[:n_f] for x in streams]), device=dev).long()
        n_tf = -(-n_f // 64)
        caches = {}
        for key, fmt in (("kernel", kv), ("plain", kv), ("native", "")):
            fc = init_decode_cache(4, n_tf * 64, cfg, layout="paged", page_size=64,
                                   n_pages=4 * n_tf + 1, kv_dtype=fmt, device=dev)
            for group in fc.values():
                for lv in group.values():
                    lv["tbl"][:] = torch.arange(1, 4 * n_tf + 1, dtype=torch.int32,
                                                device=dev).reshape(4, n_tf)
            caches[key] = fc
        d_plain = d_native = 0.0
        with torch.inference_mode():
            for t_ in range(n_f):
                at_ = torch.full((4,), t_, device=dev)
                lp = {key: torch.log_softmax(decode_step_lm(
                    params, fc, streams[:, t_], at_, plain_cfg if key == "plain" else cfg)[0]
                    [:, :cfg.vocab_size], -1) for key, fc in caches.items()}
                d_plain = max(d_plain, _err(lp["kernel"], lp["plain"]))
                d_native = max(d_native, _err(lp["kernel"], lp["native"]))
        del caches
        assert d_plain <= 0.1, (kv, "kernel vs plain log p drift", d_plain)
        drift[kv] = (n_f, d_plain, d_native)
    native_bpt = 2 * cfg.n_layers * hkv * d * 4  # f32 pages, no scales
    # the write paths on the same rows: an identity-weight attn_nope layer at
    # full width (Hq = Hkv = 8, d 128, d_model 1024), two sequences of 200
    # positions of rising magnitude (later rows of a page saturate), one
    # position a step through _paged_attn_step (K3) against packs of chunks
    # through _packed_attn (K4); every mapped page byte-equal
    icfg = dataclasses.replace(cfg, n_heads=hkv, n_kv_heads=hkv, d_model=hkv * d,
                               qk_norm=False, pattern=(("attn_nope", "swiglu"),))
    eye = torch.eye(hkv * d, device=dev)
    ip = {n: eye for n in ("wq", "wk", "wv", "wo")}
    wpage, wn, wtbl_n = quant_engines["int8", "paged"]._page_layout.page_size, 200, 4
    n_wp = 2 * wtbl_n + 1
    wtbl = (torch.randperm(n_wp - 1, generator=gen, device=dev) + 1).reshape(2, wtbl_n)
    wtbl = wtbl.to(torch.int32)
    wx = torch.randn(2, wn, hkv * d, generator=gen, device=dev)
    wx *= torch.linspace(0.5, 3.0, wn, device=dev)[None, :, None]
    write_eq = {}
    with torch.inference_mode():
        for kv in ("int8", "fp8"):
            dt = quant.get_spec(kv).dtype
            pools = []
            for _ in range(2):
                pools.append({"k_pages": torch.zeros(n_wp, wpage, hkv, d, dtype=dt, device=dev),
                              "v_pages": torch.zeros(n_wp, wpage, hkv, d, dtype=dt, device=dev),
                              "tbl": wtbl.clone(), "k_scale": torch.ones(n_wp, hkv, device=dev),
                              "v_scale": torch.ones(n_wp, hkv, device=dev)})
            seq, pk = pools
            for t_ in range(wn):
                kt = wx[:, t_].reshape(2, 1, hkv, d)
                _paged_attn_step(kt, kt, kt, icfg, seq, torch.full((2,), t_, device=dev))
            for lo, hi in ((0, 37), (37, 38), (38, 130), (130, 200)):
                plan = StepPlan(segments=tuple(
                    Segment(slot=s_, tokens=np.zeros(hi - lo, np.int32), start=lo, emits=True)
                    for s_ in range(2)), n_tokens=2 * (hi - lo))
                _, psid_np, pos_np, kvl_np, _ = pack_plan(plan, 8, 2)
                rows_x = torch.zeros(len(psid_np), hkv * d, device=dev)
                for s_ in range(2):
                    rows_x[torch.as_tensor(psid_np == s_, device=dev)] = wx[s_, lo:hi]
                _packed_attn(ip, rows_x[None], icfg, "attn_nope", pk,
                             torch.as_tensor(pos_np, device=dev).long(),
                             torch.as_tensor(psid_np, device=dev).long(),
                             torch.as_tensor(kvl_np, device=dev).long(), 8)
            wlive = wtbl.flatten().long()
            for leaf in ("k_pages", "v_pages", "k_scale", "v_scale"):
                a_, b_ = seq[leaf][wlive], pk[leaf][wlive]
                if a_.element_size() == 1:
                    a_, b_ = a_.view(torch.uint8), b_.view(torch.uint8)
                assert torch.equal(a_, b_), f"{kv}: {leaf} differs between the write paths"
            write_eq[kv] = True
    # the two loops' pools: the share of equal bytes on the pages of each
    # cached chain (the loops' GEMMs see different row counts, so their f32
    # K/V rows may differ in the last bits before quantization)
    pool_eq = {}
    for kv in ("int8", "fp8"):
        a_eng, b_eng = quant_engines[kv, "paged"], quant_engines[kv, "mixed"]
        eq = tot = 0
        for chain in a_eng._alloc.cached_chains():
            ma = a_eng._alloc.match_prefix(np.asarray(chain))
            mb = b_eng._alloc.match_prefix(np.asarray(chain))
            n_ = min(len(ma.pages), len(mb.pages))
            if n_ == 0:
                continue
            pa, pb = (torch.tensor(m_.pages[:n_], device=dev) for m_ in (ma, mb))
            for leaf in ("k_pages", "v_pages"):
                xa = a_eng._paged.cache["blocks"]["pos0"][leaf][:, pa].view(torch.uint8)
                xb = b_eng._paged.cache["blocks"]["pos0"][leaf][:, pb].view(torch.uint8)
                eq += int((xa == xb).sum())
                tot += xa.numel()
        pool_eq[kv] = eq / max(tot, 1)
    # K3 and K4 on the pages the engines wrote (layers 0 and 27), through the
    # allocator's tables: 4 cached chains; K3 decode rows, K4 5-row verify segments
    engine_err = {}
    for kv in ("int8", "fp8"):
        eng = quant_engines[kv, "paged"]
        chains = sorted(eng._alloc.cached_chains(), key=len)[-4:]
        tabs = [eng._alloc.match_prefix(np.asarray(c)).pages for c in chains]
        lens = [len(t_) * eng._page_layout.page_size for t_ in tabs]
        etbl = torch.zeros(len(tabs), eng._page_layout.pages_per_seq, dtype=torch.int32,
                           device=dev)
        for i, t_ in enumerate(tabs):
            etbl[i, :len(t_)] = torch.tensor(t_, dtype=torch.int32)
        ecl = torch.tensor(lens, dtype=torch.int32, device=dev)
        vplan = StepPlan(segments=tuple(
            Segment(slot=i, tokens=np.zeros(5, np.int32), start=n_ - 5, emits=True)
            for i, n_ in enumerate(lens)), n_tokens=5 * len(lens))
        _, psid_np, pos_np, _, _ = pack_plan(vplan, 8, len(lens))
        esid, epos = (torch.as_tensor(x, device=dev) for x in (psid_np, pos_np))
        err = 0.0
        for layer in (0, cfg.n_layers - 1):
            lv = {n: eng._paged.cache["blocks"]["pos0"][n][layer]
                  for n in ("k_pages", "v_pages", "k_scale", "v_scale")}
            sc_kw = dict(k_scale=lv["k_scale"], v_scale=lv["v_scale"])
            qd = torch.randn(len(lens), hq, d, generator=gen, device=dev)
            err = max(err, _err(k2.flashd_decode_paged(qd, lv["k_pages"], lv["v_pages"], etbl,
                                                       ecl, **sc_kw),
                                k2.flashd_decode_paged_plain(qd, lv["k_pages"], lv["v_pages"],
                                                             etbl, ecl, **sc_kw)))
            qv = torch.randn(len(psid_np), hq, d, generator=gen, device=dev)
            ov = k4.flashd_varlen(qv, lv["k_pages"], lv["v_pages"], etbl, esid, epos, ecl,
                                  block_q=8, **sc_kw)
            err = max(err, _err(ov, k4.flashd_varlen_plain(qv, lv["k_pages"], lv["v_pages"],
                                                           etbl, esid, epos, ecl, block_q=8,
                                                           **sc_kw)))
            assert torch.isfinite(ov).all()
        assert err <= F32_TOL, (kv, "kernels on the engine's pages", err)
        engine_err[kv] = err
    k3_err = max(k3_err, *engine_err.values())
    k4_err = max(k4_err, *engine_err.values())
    del quant_engines, eng, a_eng, b_eng
    # device time on byte pools beside native, at phase 7's and 8's shapes:
    # K3 at B 4 × max_len 512 (pages of 64, full caches), K4 on the mixed-step
    # pack and on a verify pack (4 slots × K + 1 = 5 rows at the spec block_q)
    qbytes = {"f32": (torch.float32, 4), "int8": (torch.int8, 1), "fp8": (torch.float8_e4m3fn, 1)}
    spec_bq = choose_varlen_blocks(bucket_pow2(4 * 5, lo=8), d, d, group=hq // hkv, page=64,
                                   segment_hint=5).block_q
    vplan = StepPlan(segments=tuple(
        Segment(slot=i, tokens=np.zeros(5, np.int32), start=st_, emits=True)
        for i, st_ in enumerate((150, 221, 300, 400))), n_tokens=20)
    packs = {"mixed": pack_plan(mixed_plan, mixed_bq, 4) + (mixed_bq,),
             "verify": pack_plan(vplan, spec_bq, 4) + (spec_bq,)}
    # timed as graph replays (`_graph_ms`): torch.profiler's sums this late in
    # the run, after the serving phases' graphs, came out below the byte bound
    q_t, q_bound = {}, {}
    for name, (dt, size) in qbytes.items():
        kp, vp, tbl, ks, vs = _paged_pool(gen, dev, [max_len] * be, max_len // 64, 64, hkv, d, dt)
        sc_kw = {} if ks is None else dict(k_scale=ks, v_scale=vs)
        side = 0 if ks is None else 2 * 4 * hkv  # scales of a page, K and V
        q_t["K3", name] = _graph_ms(lambda: k2.flashd_decode_paged(qe, kp, vp, tbl, cle3,
                                                                      **sc_kw), flush)
        n_live = be * max_len
        q_bound["K3", name] = _bytes_bound(2 * n_live * hkv * d * size + n_live // 64 * side
                                           + 2 * be * hq * d * 4, 4 * d * n_live * hq)
        for pname, (_, psid_np, qpos_np, kvl_np, _, bq) in packs.items():
            sid_, qp_, kvl_ = (torch.as_tensor(x, device=dev) for x in (psid_np, qpos_np, kvl_np))
            kp4_, vp4_, tbl4_, ks4, vs4 = _paged_pool(gen, dev, kvl_np.tolist(), max_len // 64,
                                                      64, hkv, d, dt)
            sc4 = {} if ks4 is None else dict(k_scale=ks4, v_scale=vs4)
            qv = torch.randn(len(psid_np), hq, d, generator=gen, device=dev)
            fn = lambda qv=qv, a=(kp4_, vp4_, tbl4_, sid_, qp_, kvl_), bq=bq, sc4=sc4: \
                k4.flashd_varlen(qv, *a, block_q=bq, **sc4)
            o4 = fn()
            assert _err(o4, k4.flashd_varlen_plain(qv, kp4_, vp4_, tbl4_, sid_, qp_, kvl_,
                                                   block_q=bq, **sc4)) <= F32_TOL, (pname, name)
            q_t["K4 " + pname, name] = _graph_ms(fn, flush)
            rows_ = int((qp_ >= 0).sum())
            live_ = sum(int(kvl_np[sl]) for sl in set(psid_np[psid_np >= 0].tolist()))
            vis_ = sum(min(int(kvl_np[s_]), int(p_) + 1)  # (row, key) pairs the pack needs
                       for s_, p_ in zip(psid_np, qpos_np) if p_ >= 0)
            q_bound["K4 " + pname, name] = _bytes_bound(
                2 * live_ * hkv * d * size + -(-live_ // 64) * side + 2 * rows_ * hq * d * 4,
                4 * d * hq * vis_)
    q_times = "; ".join(f"{k_} {n_} device {v_ * 1e3:.2f} us (bound {q_bound[k_, n_] * 1e3:.2f} us)"
                        for (k_, n_), v_ in q_t.items())
    _line(15, f"quantized pool, qwen3-0.6b f32 full width, phase 9's 8 requests, 32 new, "
              f"max_batch 4, max_len 512: {'; '.join(quant_report)}; teacher-forced max "
              f"|Δ log p| (4 streams, positions, kernel vs plain on the same format, kernel vs "
              f"native; bound 0.1 on the first): "
              + "; ".join(f"{kv} {n_} positions {a_:.2e}, {b_:.2e}"
                          for kv, (n_, a_, b_) in drift.items())
              + f"; native f32 pages "
              f"{native_bpt} B/token; K3/K4 launches on the main paths {quant_launches}; write "
              f"paths byte-equal on the same rows (page {wpage}, 2 x {wn} positions, K3 steps "
              f"vs K4 packs): {write_eq}; equal bytes between the paged and the mixed loops' "
              f"pools on shared chains {pool_eq}; K3/K4 on the engines' pages vs plain max|Δ| "
              f"{engine_err} (bound {F32_TOL}); device time (graph replays, L2 flushed): "
              f"{q_times} {ph}")

    # ---- 16. speculative decoding (A9): K + 1-row verify through K4 ----
    ph = _Phase()
    from repro_torch.serve.speculative import OracleDraft
    from repro_torch.tree import tree_map

    dcfg = dataclasses.replace(cfg, n_layers=2)
    dparams = dict(params, blocks=tree_map(lambda x: x[:2], params["blocks"]))
    spec_report, spec_launches = [], {"flashd_decode": 0, "flashd_decode_paged": 0,
                                      "flashd_varlen": 0}
    cases = [("self-draft", "", lambda: (params, cfg)),
             ("oracle 0.5", "", lambda: OracleDraft(reqs, kern["serve"], cfg.vocab_size,
                                                    accuracy=0.5, seed=0)),
             ("2-layer draft", "", lambda: (dparams, dcfg))]
    for mode, kw in (("paged", dict(kv_layout="paged")), ("mixed", dict(step_mode="mixed"))):
        mode_cases = cases + [("oracle 0.5 int8", "int8", lambda m=mode: OracleDraft(
            reqs, quant_toks["int8", m], cfg.vocab_size, accuracy=0.5, seed=0))]
        for name, kv, mk in mode_cases:
            ssc = ServeConfig(max_batch=4, max_len=512, spec_tokens=4, kv_dtype=kv, **kw)
            eng = Engine(params, cfg, ssc, device=dev, draft=mk())
            reset_counts()  # this path's main-path run (captured steps) starts here
            run = pool_serve(eng, reqs)
            got = {"flashd_decode": k2.launches, "flashd_decode_paged": k2.paged_launches,
                   "flashd_varlen": k4.launches}
            assert got["flashd_varlen"] > 0, (mode, name, got)
            assert (got["flashd_decode"] > 0) == ("draft" in name), (mode, name, got)
            for key in got:
                spec_launches[key] += got[key]
            if kv:  # against the int8 non-speculative run: a verify step's GEMMs see
                # other row counts than a decode step's, so its K/V may round to
                # other codes (phase 15); the streams are compared
                same = f"tokens vs the int8 run {_agreement(run['toks'], quant_toks['int8', mode])}"
            else:
                for a, b_ in zip(run["toks"], kern["serve"]):
                    assert np.array_equal(a, b_), f"{mode} {name}: speculative tokens differ"
                same = "tokens equal"
            sst = run["stats"]
            if name == "self-draft":
                assert sst["spec_acceptance_rate"] == 1.0, sst["spec_acceptance_rate"]
            spec_report.append(
                f"{mode} {name}: {same}; acceptance {sst['spec_acceptance_rate']:.3f}, "
                f"{sst['spec_mean_accepted']:.2f} accepted a verify segment "
                f"({sst['spec_rounds']} segments, {sst['host_syncs']} host syncs), "
                f"{n_serve / run['s']:.1f} tok/s (non-speculative, phase 9: "
                f"{pool_tps[mode]:.1f}), mean TTFT {run['ttft'] * 1e3:.1f} ms, launches "
                f"K2/K3/K4 {tuple(got.values())}, graphs {run['captures']}")
            del eng
    _line(16, f"speculative decoding, spec_tokens 4, qwen3-0.6b f32 full width, phase 9's 8 "
              f"requests, 32 new, captured; native pools: tokens equal the non-speculative "
              f"run, allocator consistent: {'; '.join(spec_report)}; launches {spec_launches} "
              f"{ph}")

    # ---- 17. fault-tolerant serving (A10) on the three captured loops ----
    ph = _Phase()
    fault_tps = {"contiguous": n_serve / kern["serve_s"], **pool_tps}
    chaos_text, chaos_launches = _fault_phase(params, cfg, reqs, kern["serve"], fault_tps,
                                              quant_short["int8", "paged"], dev)
    _line(17, f"{chaos_text} {ph}")

    # ---- 18. llama4-scout at full width, 4 layers (A12: MoE + chunked attention) ----
    ph = _Phase()
    del params
    gc.collect()
    a12_text, a12_launches, a12_k1, a12_err = _a12_phase(dev, card, flush)
    _line(18, f"{a12_text} {ph}")

    # ---- 19. phi-3-vision (head dim 96 in K1–K6) and mamba2 at full width ----
    ph = _Phase()
    gc.collect()
    phi3_text, phi3_launches, phi3_rows = _phi3_phase(dev, card, flush)
    _line(19, f"{phi3_text} {ph}")
    ph = _Phase()
    gc.collect()
    _line(19, f"{_mamba2_phase(dev, card)} {ph}")

    # ---- 20. seamless-m4t-medium (encoder-decoder) at full width and depth ----
    ph = _Phase()
    gc.collect()
    ed_text, ed_launches, ed_rows = _encdec_phase(dev, card, flush)
    _line(20, f"{ed_text} {ph}")

    # ---- 21. head dim 256 and groups of 16: recurrentgemma-9b, qwen3-moe-235b-a22b ----
    ph = _Phase()
    gc.collect()
    rg_text, rg_launches, rg_rows = _rgemma_phase(dev, card, flush)
    _line(21, f"{rg_text} {ph}")
    ph = _Phase()
    gc.collect()
    qm_text, qm_launches, qm_rows = _qwen3moe_phase(dev, card, flush)
    _line(21, f"{qm_text} {ph}")

    # ---- 22. the sharded train step on a 1-rank NCCL mesh ----
    ph = _Phase()
    gc.collect()
    sh_text, sh_launches = _sharded_phase(dev)
    _line(22, f"{sh_text} {ph}")

    # ---- 14. kernels line, result line ----
    kernels = [
        {"name": "flashd_fwd", "route": "cuda", "source": "src/repro_torch/csrc/flashd_fwd.cu",
         "replaces": "src/repro/kernels/flashd_fwd.py:166", "launches": launches["flashd_fwd"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": k1_lib_ms, "bf16_ms": k1_bf16_ms,
         "bf16_library_ms": k1_lib_bf16_ms, "bf16_bound_ms": fwd_bounds["bf16"][0],
         "f32_cuda_core_bound_ms": fwd_bounds["f32_cuda"][0],
         "shape": f"B{b} Hq{hq} Hkv{hkv} d{d} Sq=Skv={s} causal f32 (3xTF32 on the tensor "
                  f"cores; bound_ms is its 3xTF32 bound) and bf16"},
        {"name": "flashd_decode", "route": "cuda", "source": "src/repro_torch/csrc/flashd_decode.cu",
         "replaces": "src/repro/kernels/flashd_decode.py:205",
         "launches": launches["flashd_decode"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": "bytes",
         "library_ms": k2_lib_ms, "bf16_ms": k2_bf16_ms, "bf16_library_ms": k2_lib_bf16_ms,
         "bf16_bound_ms": k2_bounds["bf16"], "device_ms": k2_dev_ms,
         "bf16_device_ms": k2_bf16_dev_ms, "library_device_ms": k2_t["f32", "sdpa"][1],
         "bf16_library_device_ms": k2_t["bf16", "sdpa"][1],
         "shape": f"B{be} Hq{hq} Hkv{hkv} d{d} S_max{se} {live} live tokens, {n_engine} "
                  f"splits, f32 and bf16 (ms: CUDA events around the call; device_ms: what it "
                  f"launches, torch.profiler)"},
        {"name": "flashd_decode_paged", "route": "cuda",
         "source": "src/repro_torch/csrc/flashd_decode.cu",
         "replaces": "src/repro/kernels/flashd_decode.py:380",
         "launches": pool_launches["flashd_decode_paged"], "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": "bytes",
         "library_ms": k3_lib_ms, "bf16_ms": k3_bf16_ms, "bf16_library_ms": k3_lib_bf16_ms,
         "bf16_bound_ms": k3_bf16_bound, "device_ms": k3_dev_ms, "bf16_device_ms": k3_bf16_dev_ms,
         "page16_ms": k3_t[16, "f32"][0], "page16_device_ms": k3_t[16, "f32"][1],
         "page16_bf16_ms": k3_t[16, "bf16"][0], "page16_bf16_device_ms": k3_t[16, "bf16"][1],
         "k2_device_ms": k2_t7["f32"], "k2_bf16_device_ms": k2_t7["bf16"],
         "shape": f"B{be} Hq{hq} Hkv{hkv} d{d} page 64 (8 pages/seq; page16_*: 32 pages/seq), "
                  f"{live3} live tokens, {n3e} splits, f32 and bf16 (ms: CUDA events; device_ms: "
                  f"torch.profiler; k2_*: K2 on the gathered pages, same live tokens)"},
        {"name": "flashd_varlen", "route": "cuda",
         "source": "src/repro_torch/csrc/flashd_varlen.cu",
         "replaces": "src/repro/kernels/flashd_varlen.py:159",
         "launches": pool_launches["flashd_varlen"], "max_abs_err": k4_err, "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_bound_by,
         "library_ms": k4_lib_ms, "bf16_ms": k4_bf16_ms, "bf16_library_ms": k4_lib_bf16_ms,
         "bf16_bound_ms": k4_bf16_bound, "device_ms": k4_dev_ms, "bf16_device_ms": k4_bf16_dev_ms,
         "prompts_ms": pr_t["f32"][0], "prompts_device_ms": pr_t["f32"][1],
         "prompts_bf16_ms": pr_t["bf16"][0], "prompts_bf16_device_ms": pr_t["bf16"][1],
         "prompts_library_ms": pr_lib["f32"], "prompts_bf16_library_ms": pr_lib["bf16"],
         "prompts_bound_ms": pr_bounds["3xtf32"][0], "prompts_bf16_bound_ms": pr_bounds["bf16"][0],
         "shape": f"T{len(sid_np)} block_q {mixed_bq} ({n_rows} rows: 3 decode + a 16-row chunk) "
                  f"Hq{hq} Hkv{hkv} d{d} page 64, {live_tok} live tokens, f32 and bf16; prompts_*: "
                  f"{n_pr} whole prompts of {s_pr} at block_q {mixed_bq} (tensor cores; library: "
                  f"SDPA causal on the gathered prompts; bounds, the larger of operations and "
                  f"bytes: 3xTF32 {pr_bounds['3xtf32'][1]}, bf16 {pr_bounds['bf16'][1]})"},
        {"name": "flashd_bwd", "route": "cuda", "source": "src/repro_torch/csrc/flashd_bwd.cu",
         "replaces": "src/repro/kernels/flashd_bwd.py:120",
         "launches": train_launches["flashd_bwd"], "max_abs_err": k5_err, "ms": k5_ms,
         "plain_ms": k5_plain_ms, "bound_ms": k5_bound, "bound_by": k5_bound_by,
         "library_ms": k5_lib_ms, "bf16_ms": k5_bf16_ms, "bf16_library_ms": k5_lib_bf16_ms,
         "bf16_bound_ms": k5_bounds["bf16"][0],
         "f32_cuda_core_bound_ms": k5_bounds["f32_cuda"][0],
         "shape": f"B{bt} Hq{hq} Hkv{hkv} d{d} Sq=Skv={st} causal (dQ, dK, dV) f32 (3xTF32 on "
                  f"the tensor cores; bound_ms is its 3xTF32 bound) and bf16"},
        {"name": "fa2_fwd", "route": "cuda", "source": "src/repro_torch/csrc/fa2_fwd.cu",
         "replaces": "src/repro/kernels/fa2_fwd.py:101", "launches": train_launches["fa2_fwd"],
         "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": k6_lib_ms, "bf16_ms": k6_bf16_ms,
         "bf16_library_ms": k6_lib_bf16_ms, "bf16_bound_ms": fwd_bounds["bf16"][0],
         "f32_cuda_core_bound_ms": fwd_bounds["f32_cuda"][0],
         "shape": f"B{b} Hq{hq} Hkv{hkv} d{d} Sq=Skv={s} causal f32 and bf16 (K1 in the same "
                  f"turns: {k1_turn_ms:.4f} ms f32, {best['K1', 'bf16']:.4f} ms bf16)"},
    ]
    kernels[0]["train_launches"] = train_launches["flashd_fwd"]
    # phases 15 and 16: launches on the quantized and speculative main paths,
    # device time on byte pools (bounds at 1 B/element plus the page scales)
    kernels[1]["spec_launches"] = spec_launches["flashd_decode"]
    for row, key in ((kernels[2], "K3"), (kernels[3], "K4 mixed")):
        for kv in ("int8", "fp8"):
            row[f"{kv}_device_ms"] = q_t[key, kv]
            row[f"{kv}_bound_ms"] = q_bound[key, kv]
        row["native_device_ms_beside_byte_pools"] = q_t[key, "f32"]
    kernels[2]["quantized_launches"] = sum(v[0] for v in quant_launches.values())
    kernels[3]["quantized_launches"] = sum(v[1] for v in quant_launches.values())
    kernels[2]["spec_launches"] = spec_launches["flashd_decode_paged"]
    kernels[3]["spec_launches"] = spec_launches["flashd_varlen"]
    for kv in ("f32", "int8", "fp8"):
        kernels[3][f"verify_{kv}_device_ms"] = q_t["K4 verify", kv]
        kernels[3][f"verify_{kv}_bound_ms"] = q_bound["K4 verify", kv]
    for row, key in ((kernels[1], "K2"), (kernels[2], "K3"), (kernels[3], "K4")):
        row["fault_phase_launches"] = chaos_launches[key]
    # phase 18: llama4-scout's main path (forward and the two serving loops)
    for row in kernels[:4]:
        row["llama4_launches"] = a12_launches[row["name"]]
    kernels[0].update({f"llama4_{key}": val for key, val in a12_k1.items()})
    for row in kernels[1:3]:
        row["llama4_max_abs_err"] = a12_err[row["name"]]
    # phase 19: phi-3-vision's main path at head dim 96 (forward, train step,
    # the three serving loops) and each kernel at its shapes
    for row in kernels:
        row["phi3_launches"] = phi3_launches[row["name"]]
        row.update(phi3_rows[row["name"]])
    # phase 20: seamless-m4t-medium's main path (forward, train steps, decode
    # chain) and K1 / K6 / K5 / K2 at its shapes
    for row in kernels:
        row["seamless_launches"] = ed_launches[row["name"]]
        row.update(ed_rows.get(row["name"], {}))
    # phase 21: recurrentgemma-9b's main path (forward, contiguous loop) at head
    # dim 256 and G 16, qwen3-moe-235b-a22b's three loops at G 16; K1 / K6 / K2
    # at the first's shapes, K2 / K3 / K4 on the second's cache and pools
    for row in kernels:
        row["rgemma_launches"] = rg_launches[row["name"]]
        row["qwen3moe_launches"] = qm_launches[row["name"]]
        row.update(rg_rows.get(row["name"], {}))
        row.update(qm_rows.get(row["name"], {}))
    # phase 22: the sharded train step's launches (K1 forward, K5 backward)
    kernels[0]["sharded_launches"] = sh_launches["flashd_fwd"]
    kernels[4]["sharded_launches"] = sh_launches["flashd_bwd"]
    _line(14, f"{len(kernels)} ported kernels: {[kk['name'] for kk in kernels]}; all phases "
              f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
