#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Run from the root of a checkout (it puts ./src on sys.path). Phases, one
line each with its seconds; any failure raises and the exit code is
non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. building the CUDA kernels from src/repro_torch/csrc with nvcc, one
     process per source, all at once;
  3. K1 `flashd_fwd` against `flashd_fwd_plain` at qwen3-0.6b widths
     (Hq 16, Hkv 8, d 128, Sq = Skv = 2048): four mask kinds, q_offset,
     skip on/off, fully masked rows; f32 and bf16; timed beside the
     plain version and one `scaled_dot_product_attention` call;
  4. K2 `flashd_decode` against `flashd_decode_plain` (B 8, S_max 4096,
     ragged cache_len with 0 and 1; window, chunk, start, return_lam,
     fused and unfused, bf16), timed at the engine's decode shape;
  5. full-width qwen3-0.6b in f32 on seeded random weights: apply_lm
     (last_only) and the engine (`generate`, `serve`), kernels against
     the plain path — greedy tokens identical, logits within bound, both
     kernels launched on the main path;
  6. the same engine run in bf16, the model's own dtype;
  7. K3 `flashd_decode_paged` against `flashd_decode_paged_plain` at
     qwen3-0.6b widths (B 8, shuffled pages, NaN on the garbage page 0,
     pages of 64 and 16, cache_len 0 … full, window, chunk; bf16, an int8
     pool) and against K2 on the gathered view; timed at the engine's
     paged decode shape;
  8. K4 `flashd_varlen` against `flashd_varlen_plain` on packs built by
     the engine's packer (decode rows + a mid-sequence prefill chunk; whole
     prompts + verify rows + a padding block), block_q 8 and 16, bf16 and
     int8; padding rows exactly 0; timed on the mixed-step pack;
  9. the paged and the mixed serving loops at full width, f32, on phase
     5's weights and requests: kernel path vs plain path, tokens identical
     to each other and to phase 5's contiguous loop, K3 / K4 launched, the
     page allocator consistent; then one bf16 mixed serve;
 10. K5 `flashd_bwd` against `flashd_bwd_plain` at qwen3-0.6b training
     widths (B 2, Hq 16, Hkv 8, d 128, S 1024): four mask kinds, a ragged
     S of 1000, dead rows; f32 and bf16; deterministic; timed beside the
     plain version and the backward of one `scaled_dot_product_attention`;
 11. K6 `fa2_fwd` against `fa2_fwd_plain` and against K1 (O and Λ), and
     K1 and K6 timed in turns at phase 3's shape (the paper's FLASH-D vs
     FA2 comparison on this card);
 12. full-width qwen3-0.6b training, f32: the same 4 `make_train_step`
     steps on the kernel path (K1 forward, K5 backward), the plain path
     and the FA2 path (K6 + K5), loss and grad norm agreeing step by step;
     one bf16 step; tokens/s per step and a profile of one step;
 13. the lifecycle at full width and 2 layers: `train_resilient` with a
     scheduled `grad_step` fault gives the clean run's loss curve bit for
     bit, and the restored checkpoint serves the in-memory weights' tokens;
 14. the kernels line (JSON), then the result line (JSON).

It exits with code 2, printing no result, when no CUDA device is visible
or when the port's sources are not beside it.
"""

from __future__ import annotations

import dataclasses
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
LOGIT_TOL = 1e-3  # full-width f32 logits after 28 layers, attention order only
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # K5 f32: the reference's kernel-vs-autodiff bound
GRAD_BF16 = 2.0 ** -7  # K5 bf16: one bf16 rounding of the largest gradient entry
TRAIN_REL = (1e-5, 1e-4)  # loss / grad norm, kernel vs plain: step 0, after AdamW updates
BF16_LOSS_REL = 1e-2  # bf16 step-0 loss vs f32: 8-bit mantissa, averaged over 2048 tokens
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores; bf16 tensor cores


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


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


class _Phase:
    """Seconds of one phase, for its line."""

    def __init__(self):
        self.t = time.perf_counter()

    def __str__(self) -> str:
        return f"[{time.perf_counter() - self.t:.1f} s]"


def _paged_pool(gen, dev, lengths, n_tbl, page, hkv, d, dtype):
    """A pool of distinct shuffled pages with page 0 — where every table slot
    past a row's live pages points — filled with NaN (an int8 pool: NaN
    scales on page 0). Returns (k_pages, v_pages, tbl, k_scale, v_scale)."""
    import torch

    n_pages = len(lengths) * n_tbl + 1
    shape = (n_pages, page, hkv, d)
    ks = vs = None
    if dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
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


def _breakdown(label: str, step, steps: int = 10, train: bool = False) -> str:
    """`step()` of the engine's (or the trainer's) shape: host wall time per
    step, device-busy time per step (torch.profiler kernel time), the
    device's idle share, and the kernels that take the device time."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with contextlib.nullcontext() if train else torch.inference_mode():
        step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    # kernel rows only: an operator row's self device time repeats its kernels'
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total_us = sum(us for _, us in rows)
    if total_us == 0:
        return f"{label}: host {wall_ms:.2f} ms; device time not measured (no kernels traced)"
    busy_ms = total_us / 1e3 / steps
    rows.sort(key=lambda r: -r[1])
    top = ", ".join(f"{name[:48]} {100 * us / total_us:.1f}%" for name, us in rows[:5])
    classes = {"FLASH-D/FA2 kernels": 0.0, "GEMM": 0.0, "other": 0.0}
    for name, us in rows:
        if name.startswith("void (anonymous namespace)::") or "decode_merge" in name:  # csrc/*.cu
            classes["FLASH-D/FA2 kernels"] += us
        elif "gemm" in name.lower() or "xmma" in name or "splitKreduce" in name:
            classes["GEMM"] += us
        else:
            classes["other"] += us
    by_class = ", ".join(f"{k} {100 * us / total_us:.1f}%" for k, us in classes.items())
    return (f"{label}: host {wall_ms:.2f} ms/step, device busy {busy_ms:.3f} ms/step, device "
            f"idle {100 * (1 - busy_ms / wall_ms):.1f}%; device time by class: {by_class}; "
            f"by kernel: {top}")


def main() -> int:
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
    _line(2, f"built {sorted(secs)} in {build_s:.1f} s (per source {secs}); ptxas: {ptxas} {ph}")

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
    qs, ks, vs = q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    k1_lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                                enable_gqa=True), flush=flush)
    pairs = b * s * (s + 1) // 2  # causal (q, k) pairs this run computes
    k1_ops = 4 * d * pairs * hq  # QKᵀ and PV, 2 flops per multiply-add
    k1_bytes = 4 * (2 * b * s * hq * d + 2 * b * s * hkv * d) + 4 * b * hq * s
    k1_bound = 1e3 * max(k1_ops / PEAK_OPS["float32"], k1_bytes / HBM_BYTES_PER_S)
    k1_bound_by = "operations" if k1_ops / PEAK_OPS["float32"] > k1_bytes / HBM_BYTES_PER_S else "bytes"
    _line(3, f"K1 flashd_fwd f32 max|Δ| vs plain: {', '.join(report)} (bound {F32_TOL}); "
             f"bf16 {e_bf16:.2e} (bound {BF16_TOL}); causal S={s} f32: kernel {k1_ms:.3f} ms, "
             f"plain {k1_plain_ms:.3f} ms, sdpa {k1_lib_ms:.3f} ms, bound {k1_bound:.3f} ms "
             f"({k1_bound_by}); bf16 kernel {k1_bf16_ms:.3f} ms {ph}")

    # ---- 4. K2 against its plain version ----
    ph = _Phase()
    bd, s_max = 8, 4096
    qd = torch.randn(bd, hq, d, generator=gen, device=dev)
    kc = torch.randn(bd, s_max, hkv, d, generator=gen, device=dev)  # cache layout
    vc = torch.randn(bd, s_max, hkv, d, generator=gen, device=dev)
    kct, vct = kc.transpose(1, 2), vc.transpose(1, 2)
    cl = torch.tensor([0, 1, 17, 1000, 2049, 3333, 4095, 4096], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 0, 5, 900, 0, 3000, 4000, 100], dtype=torch.int32, device=dev)
    n_default = k2.gpu_decode_splits(s_max)
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
    k2_ms = _time_ms(lambda: k2.flashd_decode(qe, ket, vet, cle), reps=20, flush=flush)
    k2_plain_ms = _time_ms(lambda: k2.flashd_decode_plain(qe, ket, vet, cle, n_splits=k2.gpu_decode_splits(se)),
                           reps=20, flush=flush)
    qe4 = qe[:, :, None]
    k2_lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qe4, ket, vet, enable_gqa=True), reps=20, flush=flush)
    live = int(cle.sum())
    k2_bytes = 2 * live * hkv * d * 4 + 2 * be * hq * d * 4
    k2_ops = 4 * d * live * hq
    k2_bound = 1e3 * max(k2_bytes / HBM_BYTES_PER_S, k2_ops / PEAK_OPS["float32"])
    _line(4, f"K2 flashd_decode f32 max|Δ| vs plain (B {bd}, S_max {s_max}, cache_len "
             f"{cl.tolist()}): {', '.join(dreport)} (bound {F32_TOL}); fused vs unfused "
             f"{fused_vs_unfused:.2e}; bf16 {e2_bf16:.2e} (bound {BF16_TOL}); at B {be}, "
             f"S_max {se}, {live} live tokens f32: kernel {k2_ms * 1e3:.1f} us, plain "
             f"{k2_plain_ms * 1e3:.1f} us, sdpa {k2_lib_ms * 1e3:.1f} us, bound "
             f"{k2_bound * 1e3:.2f} us (bytes) {ph}")

    # ---- 5. full-width qwen3-0.6b, f32: kernels vs plain, tokens identical ----
    ph = _Phase()
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype="float32")
    plain_cfg = dataclasses.replace(cfg, attn_impl="flashd_plain")
    params = init_lm(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 2048)), device=dev)
    gen_prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    reqs = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
            for n in rng.integers(17, 201, 8)]
    sc = ServeConfig(max_batch=4, max_len=512)

    def run(model_cfg):
        out = {}
        with torch.inference_mode():
            for _ in range(2):  # the first call pays one-time library set-up
                t = time.perf_counter()
                out["logits"], _ = apply_lm(params, {"tokens": toks}, model_cfg, last_only=True)
                torch.cuda.synchronize()
                out["apply_s"] = time.perf_counter() - t
        eng = Engine(params, model_cfg, sc, device=dev)
        t = time.perf_counter()
        out["gen"] = eng.generate(gen_prompts, 32)
        out["gen_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["serve"] = eng.serve(reqs, 32)
        out["serve_s"] = time.perf_counter() - t
        out["ttft"] = float(np.mean(list(eng.ttft.values())))
        out["syncs"] = eng.host_syncs
        return out

    def counts():
        return (k1.launches, k2.launches, k2.paged_launches, k4.launches, k5.launches,
                k6.launches)

    def reset_counts():
        k1.launches = k2.launches = k2.paged_launches = k4.launches = 0
        k5.launches = k6.launches = 0

    reset_counts()  # the contiguous path's run starts here
    kern = run(cfg)
    launches = {"flashd_fwd": k1.launches, "flashd_decode": k2.launches}
    assert launches["flashd_fwd"] > 0 and launches["flashd_decode"] > 0, launches
    seen = counts()
    plain = run(plain_cfg)
    assert counts() == seen, "plain path launched a kernel"
    v = cfg.vocab_size
    logit_err = _err(kern["logits"][..., :v], plain["logits"][..., :v])
    assert logit_err <= LOGIT_TOL, ("logits", logit_err)
    assert np.array_equal(kern["gen"], plain["gen"]), "generate tokens differ"
    for a, b_ in zip(kern["serve"], plain["serve"]):
        assert np.array_equal(a, b_), "serve tokens differ"
    n_gen, n_serve = kern["gen"].size, sum(len(o) for o in kern["serve"])
    cache = init_decode_cache(4, 512, cfg, device=dev)
    tok4 = torch.zeros(4, dtype=torch.long, device=dev)
    at = torch.full((4,), 300, dtype=torch.long, device=dev)
    breakdown = _breakdown("decode step B4 S_max512 pos300",
                           lambda: decode_step_lm(params, cache, tok4, at, cfg))
    del cache
    _line(5, f"qwen3-0.6b f32 full width ({cfg.n_layers} layers): apply_lm S 2048 max|Δlogit| "
             f"{logit_err:.2e} (bound {LOGIT_TOL}), kernel {kern['apply_s']:.3f} s vs plain "
             f"{plain['apply_s']:.3f} s; generate 4x128+32 tokens identical, "
             f"{n_gen / kern['gen_s']:.1f} tok/s (plain {n_gen / plain['gen_s']:.1f}); serve 8 "
             f"requests (prompts {min(map(len, reqs))}-{max(map(len, reqs))}) tokens identical, "
             f"{n_serve / kern['serve_s']:.1f} tok/s (plain {n_serve / plain['serve_s']:.1f}), "
             f"mean TTFT {kern['ttft'] * 1e3:.1f} ms (plain {plain['ttft'] * 1e3:.1f}); "
             f"launches {launches}; host syncs {kern['syncs']}; {breakdown} {ph}")

    # ---- 6. the same engine in bf16 ----
    ph = _Phase()
    bcfg = get_config("qwen3-0.6b")  # compute dtype bfloat16, f32 master weights
    reset_counts()
    eng = Engine(params, bcfg, sc, device=dev)
    t = time.perf_counter()
    out_b = eng.serve(reqs, 32)
    serve_b = time.perf_counter() - t
    ttft_b = float(np.mean(list(eng.ttft.values())))
    same = sum(int(np.array_equal(a, b_)) for a, b_ in zip(out_b, kern["serve"]))
    assert k2.launches > 0
    _line(6, f"qwen3-0.6b bf16 serve 8 requests: {sum(map(len, out_b)) / serve_b:.1f} tok/s, "
             f"mean TTFT {ttft_b * 1e3:.1f} ms, K2 launches {k2.launches}; "
             f"{same}/8 streams equal to the f32 run {ph}")

    # ---- 7. K3 against its plain version and against K2 ----
    ph = _Phase()
    max_len = 512
    lengths = [0, 1, 63, 64, 65, 200, max_len - 1, max_len]
    cl3 = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q3 = torch.randn(len(lengths), hq, d, generator=gen, device=dev)
    k3_err, k3_report = 0.0, []
    for page in (64, 16):
        n_tbl = max_len // page
        kp, vp, tbl, _, _ = _paged_pool(gen, dev, lengths, n_tbl, page, hkv, d, torch.float32)
        for name, kw in (("", {}), (" window100", dict(window=100)),
                         (" chunk128", dict(chunk=128))):
            o = k2.flashd_decode_paged(q3, kp, vp, tbl, cl3, **kw)
            o_p = k2.flashd_decode_paged_plain(q3, kp, vp, tbl, cl3, **kw)
            # K2 on the gathered contiguous view (page 0's NaN lies past every cache_len)
            kc3 = gather_pages(kp, tbl).transpose(1, 2)
            vc3 = gather_pages(vp, tbl).transpose(1, 2)
            o_2 = k2.flashd_decode(q3, kc3, vc3, cl3, **kw)
            torch.cuda.synchronize()
            e, e2 = _err(o, o_p), _err(o, o_2)
            assert torch.isfinite(o).all() and e <= F32_TOL and e2 <= F32_TOL, (page, name, e, e2)
            assert (o[0] == 0).all(), "empty cache row"
            k3_err = max(k3_err, e)
            k3_report.append(f"page {page}{name} {e:.2e} (vs K2 {e2:.2e})")
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
    # timed at the engine's paged decode shape: B 4, max_len 512, page 64, full caches
    page, n_tbl = 64, max_len // 64
    kp, vp, tbl, _, _ = _paged_pool(gen, dev, [max_len] * be, n_tbl, page, hkv, d, torch.float32)
    cle3 = torch.full((be,), max_len, dtype=torch.int32, device=dev)
    k3_ms = _time_ms(lambda: k2.flashd_decode_paged(qe, kp, vp, tbl, cle3), reps=20, flush=flush)
    k3_plain_ms = _time_ms(lambda: k2.flashd_decode_paged_plain(qe, kp, vp, tbl, cle3), reps=20,
                           flush=flush)
    k3_gather_ms = _time_ms(lambda: (gather_pages(kp, tbl), gather_pages(vp, tbl)), reps=20,
                            flush=flush)
    kg, vg = gather_pages(kp, tbl).transpose(1, 2), gather_pages(vp, tbl).transpose(1, 2)
    k3_sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(qe4, kg, vg, enable_gqa=True),
                          reps=20, flush=flush)
    k3_lib_ms = k3_gather_ms + k3_sdpa_ms
    live3 = be * max_len
    k3_bytes = 2 * live3 * hkv * d * 4 + 2 * be * hq * d * 4
    k3_ops = 4 * d * live3 * hq
    k3_bound = 1e3 * max(k3_bytes / HBM_BYTES_PER_S, k3_ops / PEAK_OPS["float32"])
    _line(7, f"K3 flashd_decode_paged f32 max|Δ| vs plain (B {len(lengths)}, cache_len {lengths}, "
             f"NaN page 0): {', '.join(k3_report)} (bound {F32_TOL}; bf16 {BF16_TOL}); at B {be}, "
             f"max_len {max_len}, page {page}, {live3} live tokens f32: kernel "
             f"{k3_ms * 1e3:.1f} us, plain {k3_plain_ms * 1e3:.1f} us, library {k3_lib_ms * 1e3:.1f} us (gather_pages "
             f"{k3_gather_ms * 1e3:.1f} us + sdpa {k3_sdpa_ms * 1e3:.1f} us), bound "
             f"{k3_bound * 1e3:.2f} us (bytes) {ph}")

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
    n_vis = int(vis[qp >= 0].sum())  # (row, key) pairs this pack needs
    k4_ops = 4 * d * hq * n_vis
    live_tok = sum(int(kvl_np[sl]) for sl in {seg.slot for seg in mixed_plan.segments})
    n_rows = int((qp >= 0).sum())
    k4_bytes = 2 * live_tok * hkv * d * 4 + 2 * n_rows * hq * d * 4
    k4_bound = 1e3 * max(k4_ops / PEAK_OPS["float32"], k4_bytes / HBM_BYTES_PER_S)
    k4_bound_by = "operations" if k4_ops / PEAK_OPS["float32"] > k4_bytes / HBM_BYTES_PER_S \
        else "bytes"
    _line(8, f"K4 flashd_varlen f32 max|Δ| vs plain (NaN page 0, page {page}, window 50 too): "
             f"{'; '.join(k4_report)} (bound {F32_TOL}; bf16 {BF16_TOL}); padding rows exactly 0; "
             f"mixed-step pack (T {len(sid_np)}, block_q {mixed_bq}, {n_rows} rows, {live_tok} "
             f"live tokens) f32: kernel {k4_ms * 1e3:.1f} us, plain {k4_plain_ms * 1e3:.1f} us, "
             f"sdpa with a boolean mask over the gathered rows {k4_lib_ms * 1e3:.1f} us, bound "
             f"{k4_bound * 1e3:.2f} us ({k4_bound_by}) {ph}")

    # ---- 9. the paged and mixed loops at full width: kernels vs plain ----
    ph = _Phase()
    pool_runs, pool_report = {}, []
    pool_launches = {"flashd_decode_paged": 0, "flashd_varlen": 0}
    for mode, kw in (("paged", dict(kv_layout="paged")), ("mixed", dict(step_mode="mixed"))):
        psc = ServeConfig(max_batch=4, max_len=512, prefix_cache=False, **kw)
        out = {}
        for path, model_cfg in (("kernel", cfg), ("plain", plain_cfg)):
            if path == "kernel":
                reset_counts()  # this path's main-path run starts here
            else:
                seen = counts()
            eng = Engine(params, model_cfg, psc, device=dev)
            t = time.perf_counter()
            toks_out = eng.serve(reqs, 32)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            eng._alloc.check()
            assert eng._alloc.pages_in_use == 0, "pages leaked"
            st = eng.stats()
            out[path] = dict(toks=toks_out, s=dt, ttft=float(np.mean(list(eng.ttft.values()))),
                             syncs=eng.host_syncs, stats=st)
            if path == "kernel":
                got = dict(zip(pool_launches, counts()[2:4]))
                assert got["flashd_decode_paged"] > 0, (mode, got)
                assert (got["flashd_varlen"] > 0) == (mode == "mixed"), (mode, got)
                for name in pool_launches:
                    pool_launches[name] += got[name]
            else:
                assert counts() == seen, f"{mode}: the plain path launched a kernel"
        for a, b_, c in zip(out["kernel"]["toks"], out["plain"]["toks"], kern["serve"]):
            assert np.array_equal(a, b_), f"{mode}: kernel and plain tokens differ"
            assert np.array_equal(a, c), f"{mode}: tokens differ from the contiguous loop"
        pool_runs[mode] = out
        k, p_ = out["kernel"], out["plain"]
        st = k["stats"]
        pool_report.append(
            f"{mode}: tokens identical (kernel = plain = contiguous), {n_serve / k['s']:.1f} tok/s "
            f"(plain {n_serve / p_['s']:.1f}), mean TTFT {k['ttft'] * 1e3:.1f} ms (plain "
            f"{p_['ttft'] * 1e3:.1f}), host syncs {k['syncs']}, pool {st['kv_pool_bytes']} B "
            f"({st['kv_bytes_per_token']:.0f} B/token, {st['kv_dtype']}), preemptions "
            f"{st['preemptions']}")
    # one packed step of the mixed loop's shape (phase 8's mixed-step pack)
    lay = eng._page_layout
    pcache = init_decode_cache(4, 512, cfg, layout="paged", page_size=lay.page_size,
                               n_pages=lay.n_pages, device=dev)
    rows_tbl = torch.arange(1, lay.n_pages, dtype=torch.int32, device=dev)
    rows_tbl = rows_tbl[: 4 * lay.pages_per_seq].reshape(4, lay.pages_per_seq)
    for group in pcache.values():
        for leaves in group.values():
            leaves["tbl"][:] = rows_tbl
    pack = [torch.as_tensor(a, device=dev) for a in pack_plan(mixed_plan, mixed_bq, 4)]
    pack[0] = torch.as_tensor(rng.integers(0, cfg.vocab_size, len(sid_np)), device=dev)
    packed = _breakdown(
        f"packed step T{len(sid_np)} (3 decode rows + a 16-row chunk, block_q {mixed_bq})",
        lambda: forward_packed(params, pack[0], pack[1], pack[2], pack[3], pcache, cfg, pack[4],
                               block_q=mixed_bq))
    del pcache
    reset_counts()
    eng = Engine(params, bcfg, ServeConfig(max_batch=4, max_len=512, prefix_cache=False,
                                           step_mode="mixed"), device=dev)
    t = time.perf_counter()
    out_mb = eng.serve(reqs, 32)
    serve_mb = time.perf_counter() - t
    assert k4.launches > 0 and k2.paged_launches > 0
    ttft_mb = float(np.mean(list(eng.ttft.values())))
    _line(9, f"qwen3-0.6b f32 full width, 8 requests as phase 5, max_batch 4, max_len 512, "
             f"prefix_cache off: {'; '.join(pool_report)}; launches {pool_launches}; {packed}; "
             f"bf16 mixed: "
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
    k5_pairs = bt * st * (st + 1) // 2
    k5_ops = 10 * d * k5_pairs * hq  # s, dO·Vᵀ, dQ, dK, dV: 2·d flops each per visible pair
    # q, O, dO, k, v and Λ read once; dQ, dK, dV written once
    k5_bytes = 4 * (bt * st * d * (3 * hq + 2 * hkv) + bt * hq * st) + 4 * bt * st * d * (hq + 2 * hkv)
    k5_bound = 1e3 * max(k5_ops / PEAK_OPS["float32"], k5_bytes / HBM_BYTES_PER_S)
    k5_bound_by = "operations" if k5_ops / PEAK_OPS["float32"] > k5_bytes / HBM_BYTES_PER_S else "bytes"
    _line(10, f"K5 flashd_bwd max|Δ| vs plain (B {bt}, Hq {hq}, Hkv {hkv}, d {d}): "
              f"{', '.join(k5_report)} (f32 bound rtol {GRAD_RTOL} atol {GRAD_ATOL} per entry; "
              f"bf16 {GRAD_BF16:.4f}·max|grad|); bitwise equal on a second run: {deterministic}; "
              f"causal S={st} f32: kernel {k5_ms:.3f} ms, plain {k5_plain_ms:.3f} ms, sdpa "
              f"backward {k5_lib_ms:.3f} ms, bound {k5_bound:.3f} ms ({k5_bound_by}) {ph}")

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
    turns = {"K1": [], "K6": []}
    for who in ("K1", "K6", "K6", "K1"):  # in turns, on one card
        fn = k1.flashd_fwd if who == "K1" else k6.fa2_fwd
        turns[who].append(_time_ms(lambda: fn(qt, kt, vt, mask=causal), flush=flush))
    k1_turn_ms, k6_ms = min(turns["K1"]), min(turns["K6"])
    k6_plain_ms = _time_ms(lambda: k6.fa2_fwd_plain(qt, kt, vt, mask=causal), flush=flush)
    _line(11, f"K6 fa2_fwd f32 max|Δ| vs plain: {', '.join(k6_report)} (bound {F32_TOL}); bf16 "
              f"{e6_bf16:.2e} (bound {BF16_TOL}); causal S={s} f32, timed in turns K1 K6 K6 K1: "
              f"K1 {turns['K1']} ms, K6 {turns['K6']} ms (FLASH-D / FA2 = "
              f"{k1_turn_ms / k6_ms:.3f}), plain FA2 {k6_plain_ms:.3f} ms, sdpa {k1_lib_ms:.3f} "
              f"ms (phase 3), bound {k1_bound:.3f} ms {ph}")

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
                               steps=2, train=True)
    del state_k, step_k
    seen = counts()
    _, _, curve_p, secs_p = train(dataclasses.replace(cfg, attn_impl="flashd_plain"))
    assert counts() == seen, "the plain training path launched a kernel"
    reset_counts()  # the FA2 training path's run starts here
    _, _, curve_f, secs_f = train(dataclasses.replace(cfg, attn_impl="fa2_gpu"))
    train_launches["fa2_fwd"] = k6.launches
    assert k6.launches > 0 and k5.launches > 0 and k1.launches == 0
    rel_k, rel_f = agree("kernel", curve_k, curve_p), agree("fa2", curve_f, curve_p)
    bcfg_train = dataclasses.replace(get_config("qwen3-0.6b"), attn_impl="flashd_gpu")  # bf16 compute
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
    ltc = TrainConfig(warmup_steps=0, total_steps=6)
    res = ResilienceConfig(ckpt_every=3, keep_checkpoints=1)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=os.path.join(HERE, "build"))
    try:
        kw = dict(model_cfg=lcfg, train_cfg=ltc, data=ldata, total_steps=6, res=res, device=dev)
        clean, clean_hist, ctr0 = train_resilient(ckpt_dir=os.path.join(root, "clean"), **kw)
        inj = FaultInjector(schedule=[("grad_step", 4)])
        got, hist, ctr = train_resilient(ckpt_dir=os.path.join(root, "faulted"), injector=inj,
                                         **kw)
        assert ctr0["restarts"] == 0 and ctr["restarts"] == 1 and ctr["faults"] == 1, ctr
        clean_curve, got_curve = [h["loss"] for h in clean_hist], [h["loss"] for h in hist]
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
              f"6 steps, checkpoint every 3: a grad_step fault at step 4 → {ctr['restarts']} "
              f"restart, loss curve bitwise equal to the clean run {got_curve}; checkpoint "
              f"(step {extra['data_step']}, {ck_bytes / 2**30:.2f} GiB on disk at the end) "
              f"restored into serve.Engine gives the in-memory weights' 2x16 greedy tokens {ph}")

    # ---- 14. kernels line, result line ----
    kernels = [
        {"name": "flashd_fwd", "route": "cuda", "source": "src/repro_torch/csrc/flashd_fwd.cu",
         "replaces": "src/repro/kernels/flashd_fwd.py:166", "launches": launches["flashd_fwd"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": k1_lib_ms,
         "shape": f"B{b} Hq{hq} Hkv{hkv} d{d} Sq=Skv={s} causal f32"},
        {"name": "flashd_decode", "route": "cuda", "source": "src/repro_torch/csrc/flashd_decode.cu",
         "replaces": "src/repro/kernels/flashd_decode.py:205",
         "launches": launches["flashd_decode"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": "bytes",
         "library_ms": k2_lib_ms,
         "shape": f"B{be} Hq{hq} Hkv{hkv} d{d} S_max{se} {live} live tokens f32"},
        {"name": "flashd_decode_paged", "route": "cuda",
         "source": "src/repro_torch/csrc/flashd_decode.cu",
         "replaces": "src/repro/kernels/flashd_decode.py:380",
         "launches": pool_launches["flashd_decode_paged"], "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": "bytes",
         "library_ms": k3_lib_ms,
         "shape": f"B{be} Hq{hq} Hkv{hkv} d{d} page 64, 8 pages/seq, {live3} live tokens f32"},
        {"name": "flashd_varlen", "route": "cuda",
         "source": "src/repro_torch/csrc/flashd_varlen.cu",
         "replaces": "src/repro/kernels/flashd_varlen.py:159",
         "launches": pool_launches["flashd_varlen"], "max_abs_err": k4_err, "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_bound_by,
         "library_ms": k4_lib_ms,
         "shape": f"T{len(sid_np)} block_q {mixed_bq} ({n_rows} rows: 3 decode + a 16-row chunk) "
                  f"Hq{hq} Hkv{hkv} d{d} page 64, {live_tok} live tokens f32"},
        {"name": "flashd_bwd", "route": "cuda", "source": "src/repro_torch/csrc/flashd_bwd.cu",
         "replaces": "src/repro/kernels/flashd_bwd.py:120",
         "launches": train_launches["flashd_bwd"], "max_abs_err": k5_err, "ms": k5_ms,
         "plain_ms": k5_plain_ms, "bound_ms": k5_bound, "bound_by": k5_bound_by,
         "library_ms": k5_lib_ms,
         "shape": f"B{bt} Hq{hq} Hkv{hkv} d{d} Sq=Skv={st} causal f32 (dQ, dK, dV)"},
        {"name": "fa2_fwd", "route": "cuda", "source": "src/repro_torch/csrc/fa2_fwd.cu",
         "replaces": "src/repro/kernels/fa2_fwd.py:101", "launches": train_launches["fa2_fwd"],
         "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": k1_lib_ms,
         "shape": f"B{b} Hq{hq} Hkv{hkv} d{d} Sq=Skv={s} causal f32 (K1 in the same turns: "
                  f"{k1_turn_ms:.3f} ms)"},
    ]
    kernels[0]["train_launches"] = train_launches["flashd_fwd"]
    _line(14, f"{len(kernels)} ported kernels: {[kk['name'] for kk in kernels]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
