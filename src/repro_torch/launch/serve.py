"""Serving launcher: init seeded random weights, run the contiguous engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --requests 8 --prompt-len 64 --max-new-tokens 32 --max-batch 4

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
    print(f"{total} tokens in {dt:.2f}s → {total / max(dt, 1e-9):.1f} tok/s "
          f"(batched decode over {args.max_batch} contiguous slots on {where}, "
          f"attn_impl {cfg.attn_impl}, peak {eng.peak_active} concurrent)")
    if eng.ttft:
        print("time-to-first-token (enqueue → first token, per request):")
        for rid in sorted(eng.ttft):
            print(f"  request {rid}: {eng.ttft[rid] * 1e3:8.1f} ms")
        ttft = [eng.ttft[r] for r in sorted(eng.ttft)]
        print(f"  mean {np.mean(ttft) * 1e3:.1f} ms, max {np.max(ttft) * 1e3:.1f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
