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
 10. the kernels line (JSON), then the result line (JSON).

It exits with code 2, printing no result, when no CUDA device is visible
or when the port's sources are not beside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

F32_TOL = 5e-5  # O and Λ, f32: summation order only
BF16_TOL = 2e-2  # O in bf16: one bf16 rounding of |O| < 4 (2^-7 · 2 + slack)
LOGIT_TOL = 1e-3  # full-width f32 logits after 28 layers, attention order only
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


def _breakdown(label: str, step, steps: int = 10) -> str:
    """`step()` of the engine's shape: host wall time per step, device-busy
    time per step (torch.profiler kernel time), the device's idle share,
    and the kernels that take the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
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
    return (f"{label}: host {wall_ms:.2f} ms/step, device busy {busy_ms:.3f} ms/step, device "
            f"idle {100 * (1 - busy_ms / wall_ms):.1f}%; device time by kernel: {top}")


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
    from repro_torch.kernels import flashd_fwd as k1
    from repro_torch.kernels import flashd_varlen as k4
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
        return (k1.launches, k2.launches, k2.paged_launches, k4.launches)

    def reset_counts():
        k1.launches = k2.launches = k2.paged_launches = k4.launches = 0

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
                got = dict(zip(pool_launches, counts()[2:]))
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

    # ---- 10. kernels line, result line ----
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
    ]
    _line(10, f"{len(kernels)} ported kernels: {[kk['name'] for kk in kernels]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
