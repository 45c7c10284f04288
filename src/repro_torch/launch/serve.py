"""Serving launcher: init seeded random weights, run the engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --requests 8 --prompt-len 64 --max-new-tokens 32 --max-batch 4
    # the paged loop / the mixed chunked-prefill loop (the radix prefix cache
    # on, as the reference's default; --no-prefix-cache turns it off):
    ... --kv-layout paged
    ... --step-mode mixed --prefill-chunk 16
    # a quantized page pool; speculative decoding with a draft model:
    ... --kv-layout paged --kv-dtype int8
    ... --step-mode mixed --spec-tokens 4 --draft-config qwen3-0.6b
    # seeded chaos at the four fault sites, lifecycle budgets per request:
    ... --kv-layout paged --fault-rate 0.1 --fault-seed 3 --max-retries 3 \
        --deadline-ms 60000

Runs on the card unless `--device cpu` is given (then at `--smoke` widths,
as a check of the control flow). On the card the engine replays its steps
as captured CUDA graphs. Prints each request's tokens and terminal
status (done / failed / expired), the retry and downgrade counters, the
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
    p.add_argument("--arch", default="paper-llama", choices=configs.ARCHS)
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
    p.add_argument("--kv-dtype", default="",
                   help='quantize the paged KV pool: "int8" or "fp8" (e4m3) stores pages at '
                        '1 B/element with a per-(page, kv head) f32 scale side-band; needs '
                        '--kv-layout paged or --step-mode mixed; "" → the compute dtype')
    p.add_argument("--step-mode", choices=("sequential", "mixed"), default="sequential",
                   help="mixed: chunked-prefill continuous batching, one packed varlen step "
                        "per iteration")
    p.add_argument("--token-budget", type=int, default=0,
                   help="packed tokens per mixed step (0 → max_batch + prefill chunk)")
    p.add_argument("--prefill-chunk", type=int, default=16,
                   help="max prompt tokens one sequence feeds per mixed step")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable the radix prefix cache of the paged and mixed loops (on by "
                        "default: an admission reuses the cached full pages of its prompt)")
    p.add_argument("--no-preemption", action="store_true",
                   help="reserve each request's worst case at admission instead of "
                        "preempting under page pressure")
    p.add_argument("--spec-tokens", type=int, default=0,
                   help="speculative decoding: draft tokens verified per round through one "
                        "packed step; 0 → off. Greedy only; needs --kv-layout paged or "
                        "--step-mode mixed")
    p.add_argument("--draft-config", default="qwen3-0.6b",
                   help="architecture of the draft model proposing spec tokens (its smoke "
                        "config under --smoke; weights drawn from --seed + 1)")
    p.add_argument("--no-spec", action="store_true",
                   help="force speculation off even if --spec-tokens is set (an A/B against "
                        "the same command line)")
    p.add_argument("--deadline-ms", type=float, default=0.0,
                   help="per-request deadline in milliseconds (0 → none); an overdue request "
                        "is cancelled like EOS with status 'expired'")
    p.add_argument("--max-retries", type=int, default=3,
                   help="fault-retry budget per request before it goes terminal-FAILED")
    p.add_argument("--fault-rate", type=float, default=0.0,
                   help="chaos injection: probability each fault-site check fires (0 → none)")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed of the deterministic fault injector")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    if cfg.is_encdec:
        raise SystemExit(f"--arch {args.arch}: the serving engine runs decoder-only stacks; the "
                         f"reference serves no encoder-decoder model (its prefill_lm reads "
                         f"params['blocks'])")
    device = resolve_device(args.device)
    params = init_lm(cfg, device=device, seed=args.seed)
    spec_tokens = 0 if args.no_spec else args.spec_tokens
    draft = None
    if spec_tokens > 0:
        # random draft weights still drive the whole verify / rollback path
        # (most proposals are rejected; the tokens are the same by construction)
        dcfg = (configs.get_smoke_config(args.draft_config) if args.smoke
                else configs.get_config(args.draft_config))
        draft = (init_lm(dcfg, device=device, seed=args.seed + 1), dcfg)
        print(f"speculative decoding: draft={args.draft_config} k={spec_tokens}")
    eng = Engine(params, cfg, ServeConfig(
        max_batch=args.max_batch,
        max_len=args.prompt_len + args.max_new_tokens + 8,
        temperature=args.temperature,
        seed=args.seed,
        kv_layout=args.kv_layout,
        page_size=args.page_size,
        kv_pool_tokens=args.kv_pool_tokens,
        kv_dtype=args.kv_dtype,
        step_mode=args.step_mode,
        token_budget=args.token_budget,
        prefill_chunk=args.prefill_chunk,
        prefix_cache=not args.no_prefix_cache,
        preemption=not args.no_preemption,
        spec_tokens=spec_tokens,
        max_retries=args.max_retries,
        deadline_s=args.deadline_ms / 1e3,
        fault_rate=args.fault_rate,
        fault_seed=args.fault_seed,
    ), device=device, draft=draft)
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
              f"{st['host_syncs']} host syncs; prefix cache "
              f"{'on' if st['prefix_cache_enabled'] else 'off'}, {st['hit_tokens']} of "
              f"{st['prompt_tokens']} prompt tokens cached")
    if args.fault_rate > 0 or args.deadline_ms > 0 or st["retried"]:
        n_done = sum(s == "done" for s in status.values())
        print(f"fault tolerance: {n_done}/{len(outs)} done, {st['failed']} failed, "
              f"{st['expired']} expired, {st['retried']} retries, {st['downgrades']} downgrades "
              f"(impl now {st['attn_impl']}), faults fired {st.get('injected_faults', {})} "
              f"of checks {st.get('fault_checks', {})}")
    if st["spec_enabled"]:
        print(f"speculation: {st['spec_rounds']} rounds, {st['spec_accepted']} of "
              f"{st['spec_drafted']} drafts accepted (rate {st['spec_acceptance_rate']:.2f}, "
              f"{st['spec_mean_accepted']:.2f} a round)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
