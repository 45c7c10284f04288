"""Serving launcher: init seeded random weights, run the engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --requests 8 --prompt-len 64 --max-new-tokens 32 --max-batch 4
    # the paged loop / the mixed chunked-prefill loop (the prefix cache is
    # not ported, so both need --no-prefix-cache):
    ... --kv-layout paged --no-prefix-cache
    ... --step-mode mixed --no-prefix-cache --prefill-chunk 16

Runs on the card unless `--device cpu` is given (then at `--smoke` widths,
as a check of the control flow). Prints each request's tokens, the
throughput and the per-request time-to-first-token, as the reference
launcher does. Real checkpoints are not in the repository: the weights
are drawn from `--seed`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.devices import resolve_device
from repro_torch.models.transformer import init_lm
from repro_torch.serve import Engine, ServeConfig


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="paper-llama")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kv-layout", choices=("contiguous", "paged"), default="contiguous",
                   help="paged: page-pool KV, admission by free pages")
    p.add_argument("--page-size", type=int, default=0, help="tokens per KV page (0 → tuned)")
    p.add_argument("--kv-pool-tokens", type=int, default=0,
                   help="paged pool size in tokens (0 → max_batch·max_len)")
    p.add_argument("--step-mode", choices=("sequential", "mixed"), default="sequential",
                   help="mixed: chunked-prefill continuous batching, one packed varlen step "
                        "per iteration")
    p.add_argument("--token-budget", type=int, default=0,
                   help="packed tokens per mixed step (0 → max_batch + prefill chunk)")
    p.add_argument("--prefill-chunk", type=int, default=16,
                   help="max prompt tokens one sequence feeds per mixed step")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable the radix prefix cache (not ported: the paged and mixed "
                        "loops need this flag)")
    p.add_argument("--no-preemption", action="store_true",
                   help="reserve each request's worst case at admission instead of "
                        "preempting under page pressure")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    params = init_lm(cfg, device=device, seed=args.seed)
    eng = Engine(params, cfg, ServeConfig(
        max_batch=args.max_batch,
        max_len=args.prompt_len + args.max_new_tokens + 8,
        temperature=args.temperature,
        seed=args.seed,
        kv_layout=args.kv_layout,
        page_size=args.page_size,
        kv_pool_tokens=args.kv_pool_tokens,
        step_mode=args.step_mode,
        token_budget=args.token_budget,
        prefill_chunk=args.prefill_chunk,
        prefix_cache=not args.no_prefix_cache,
        preemption=not args.no_preemption,
    ), device=device)
    rng = np.random.default_rng(args.seed)
    reqs = [rng.integers(0, cfg.vocab_size, (args.prompt_len,)).astype(np.int32)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = eng.serve(reqs, max_new_tokens=args.max_new_tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    status = eng.stats().get("request_status", {})
    for i, o in enumerate(outs):
        print(f"request {i} [{status.get(i, '?'):>7}]: {o.tolist()}")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    layout = "paged pool" if eng._page_layout is not None else "contiguous slots"
    mode = "mixed varlen steps" if eng._mixed_ok else "sequential chunks"
    print(f"{total} tokens in {dt:.2f}s → {total / max(dt, 1e-9):.1f} tok/s "
          f"(batched decode over {args.max_batch} slots, {layout}, {mode}, on {where}, "
          f"attn_impl {cfg.attn_impl}, peak {eng.peak_active} concurrent)")
    if eng.ttft:
        print("time-to-first-token (enqueue → first token, per request):")
        for rid in sorted(eng.ttft):
            print(f"  request {rid}: {eng.ttft[rid] * 1e3:8.1f} ms")
        ttft = [eng.ttft[r] for r in sorted(eng.ttft)]
        print(f"  mean {np.mean(ttft) * 1e3:.1f} ms, max {np.max(ttft) * 1e3:.1f} ms")
    st = eng.stats()
    if "kv_pool_bytes" in st:
        print(f"kv pool: {st['kv_dtype']}, {st['kv_pool_bytes'] / 1024:.1f} KiB "
              f"({st['kv_bytes_per_token']:.0f} B/token), {st['preemptions']} preemptions, "
              f"{st['host_syncs']} host syncs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
