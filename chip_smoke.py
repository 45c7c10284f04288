#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Run from the root of a checkout (it puts ./src on sys.path). Phases, one
line each; any failure raises and the exit code is non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. building both CUDA kernels from src/repro_torch/csrc with nvcc;
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
  7. the kernels line (JSON), then the result line (JSON).

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


def _decode_breakdown(params, cfg, dev, batch: int = 4, max_len: int = 512, pos: int = 300) -> str:
    """One decode step of the engine's shape: host wall time per step,
    device-busy time per step (torch.profiler kernel time), the device's
    idle share, and the kernels that take the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import decode_step_lm, init_decode_cache

    cache = init_decode_cache(batch, max_len, cfg, device=dev)
    tok = torch.zeros(batch, dtype=torch.long, device=dev)
    at = torch.full((batch,), pos, dtype=torch.long, device=dev)
    steps = 10
    with torch.inference_mode():
        decode_step_lm(params, cache, tok, at, cfg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            decode_step_lm(params, cache, tok, at, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                decode_step_lm(params, cache, tok, at, cfg)
            torch.cuda.synchronize()
    # kernel rows only: an operator row's self device time repeats its kernels'
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total_us = sum(us for _, us in rows)
    if total_us == 0:
        return f"decode step: host {wall_ms:.2f} ms; device time not measured (no kernels traced)"
    busy_ms = total_us / 1e3 / steps
    rows.sort(key=lambda r: -r[1])
    top = ", ".join(f"{name[:48]} {100 * us / total_us:.1f}%" for name, us in rows[:5])
    return (f"decode step B{batch} S_max{max_len} pos{pos}: host {wall_ms:.2f} ms/step, device "
            f"busy {busy_ms:.3f} ms/step, device idle {100 * (1 - busy_ms / wall_ms):.1f}%; "
            f"device time by kernel: {top}")


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
    from repro_torch.kernels import flashd_fwd as k1
    from repro_torch.models.transformer import apply_lm, init_lm
    from repro_torch.serve import Engine, ServeConfig

    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)  # 256 MB > L2

    # ---- 1. card ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _line(1, f"card {card!r}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
             f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    secs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = "; ".join(f"{n}: " + _build.ptxas_report(n).replace("\n", " | ") for n in _build.SOURCES)
    _line(2, f"built {sorted(secs)} in {build_s:.1f} s (per source {secs}); ptxas: {ptxas}")

    # ---- 3. K1 against its plain version ----
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
             f"({k1_bound_by}); bf16 kernel {k1_bf16_ms:.3f} ms")

    # ---- 4. K2 against its plain version ----
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
             f"{k2_bound * 1e3:.2f} us (bytes)")

    # ---- 5. full-width qwen3-0.6b, f32: kernels vs plain, tokens identical ----
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

    k1.launches = k2.launches = 0  # the main path's run starts here
    kern = run(cfg)
    launches = {"flashd_fwd": k1.launches, "flashd_decode": k2.launches}
    assert launches["flashd_fwd"] > 0 and launches["flashd_decode"] > 0, launches
    plain = run(plain_cfg)
    assert (k1.launches, k2.launches) == tuple(launches.values()), "plain path launched a kernel"
    v = cfg.vocab_size
    logit_err = _err(kern["logits"][..., :v], plain["logits"][..., :v])
    assert logit_err <= LOGIT_TOL, ("logits", logit_err)
    assert np.array_equal(kern["gen"], plain["gen"]), "generate tokens differ"
    for a, b_ in zip(kern["serve"], plain["serve"]):
        assert np.array_equal(a, b_), "serve tokens differ"
    n_gen, n_serve = kern["gen"].size, sum(len(o) for o in kern["serve"])
    breakdown = _decode_breakdown(params, cfg, dev)
    _line(5, f"qwen3-0.6b f32 full width ({cfg.n_layers} layers): apply_lm S 2048 max|Δlogit| "
             f"{logit_err:.2e} (bound {LOGIT_TOL}), kernel {kern['apply_s']:.3f} s vs plain "
             f"{plain['apply_s']:.3f} s; generate 4x128+32 tokens identical, "
             f"{n_gen / kern['gen_s']:.1f} tok/s (plain {n_gen / plain['gen_s']:.1f}); serve 8 "
             f"requests (prompts {min(map(len, reqs))}-{max(map(len, reqs))}) tokens identical, "
             f"{n_serve / kern['serve_s']:.1f} tok/s (plain {n_serve / plain['serve_s']:.1f}), "
             f"mean TTFT {kern['ttft'] * 1e3:.1f} ms (plain {plain['ttft'] * 1e3:.1f}); "
             f"launches {launches}; host syncs {kern['syncs']}; {breakdown}")

    # ---- 6. the same engine in bf16 ----
    bcfg = get_config("qwen3-0.6b")  # compute dtype bfloat16, f32 master weights
    k1.launches = k2.launches = 0
    eng = Engine(params, bcfg, sc, device=dev)
    t = time.perf_counter()
    out_b = eng.serve(reqs, 32)
    serve_b = time.perf_counter() - t
    ttft_b = float(np.mean(list(eng.ttft.values())))
    same = sum(int(np.array_equal(a, b_)) for a, b_ in zip(out_b, kern["serve"]))
    assert k2.launches > 0
    _line(6, f"qwen3-0.6b bf16 serve 8 requests: {sum(map(len, out_b)) / serve_b:.1f} tok/s, "
             f"mean TTFT {ttft_b * 1e3:.1f} ms, K2 launches {k2.launches}; "
             f"{same}/8 streams equal to the f32 run")

    # ---- 7. kernels line, result line ----
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
    ]
    _line(7, f"{len(kernels)} ported kernels: {[kk['name'] for kk in kernels]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
