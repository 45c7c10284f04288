#!/usr/bin/env python3
"""K3 and K4 of two checkouts timed on one GPU in one call, in turns.

    python3 tools/ab_paged_kernels.py OLD_ROOT NEW_ROOT

Each ROOT is a checkout of this repository (for example a `git archive`
of a parent commit unpacked under the gitignored build/). The script first
builds both trees' flashd_decode and flashd_varlen sources at once, then
runs one process per tree in the order old, new, new, old. Each process
puts its ROOT/src first on sys.path and measures, on the same seeded
inputs, with chip_smoke.py's helpers (device time by torch.profiler, the
L2 flushed before each call):
  - K3 `flashd_decode_paged` at the engine's paged decode shape (B 4,
    max_len 512, full caches, Hq 16, Hkv 8, d 128) through pages of 64
    and of 16, f32 and bf16;
  - K4 `flashd_varlen` on the mixed-step pack (3 decode rows and a 16-row
    chunk at the engine's block_q) and on 4 whole prompts of 512, f32 and
    bf16;
  - the packed step of qwen3-0.6b at full width (28 layers, f32, seeded
    random weights) on that pack: device-busy ms per step.
Each process prints one JSON line; the last line holds each number's mean
over the tree's two runs and the new / old ratio.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)  # chip_smoke's helpers


def _measure(root: str) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import flashd_decode as k2
    from repro_torch.kernels import flashd_varlen as k4
    from repro_torch.kernels.tuning import bucket_pow2, choose_page_layout, choose_varlen_blocks
    from repro_torch.models.transformer import forward_packed, init_decode_cache, init_lm
    from repro_torch.serve.engine import pack_plan
    from repro_torch.serve.scheduler import Segment, StepPlan

    assert k2.__file__.startswith(os.path.abspath(root)), k2.__file__
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    be, max_len, hq, hkv, d = 4, 512, 16, 8, 128
    out = {"root": root}
    qe = torch.randn(be, hq, d, generator=gen, device=dev)
    cle = torch.full((be,), max_len, dtype=torch.int32, device=dev)
    for page in (64, 16):
        kp, vp, tbl, _, _ = cs._paged_pool(gen, dev, [max_len] * be, max_len // page, page, hkv,
                                           d, torch.float32)
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = (qe.to(dtype), kp.to(dtype), vp.to(dtype))
            out[f"k3_page{page}_{dt}_us"] = 1e3 * cs._device_ms(
                lambda x=x, tbl=tbl: k2.flashd_decode_paged(*x, tbl, cle), flush)

    page = 64
    bq = choose_varlen_blocks(bucket_pow2(4 + 16, lo=8), d, d, group=hq // hkv, page=page,
                              segment_hint=1).block_q
    mixed = StepPlan(segments=(
        Segment(slot=0, tokens=np.zeros(1, np.int32), start=150, emits=True),
        Segment(slot=1, tokens=np.zeros(1, np.int32), start=221, emits=True),
        Segment(slot=2, tokens=np.zeros(1, np.int32), start=300, emits=True),
        Segment(slot=3, tokens=np.zeros(16, np.int32), start=96, emits=False),
    ), n_tokens=19)
    prompts = StepPlan(segments=tuple(
        Segment(slot=i, tokens=np.zeros(512, np.int32), start=0, emits=True) for i in range(4)),
        n_tokens=2048)
    for name, plan in (("mixed", mixed), ("prompts", prompts)):
        _, sid, qp, kvl, _ = (torch.as_tensor(a, device=dev) for a in pack_plan(plan, bq, 4))
        kp, vp, tbl, _, _ = cs._paged_pool(gen, dev, kvl.tolist(), max_len // page, page, hkv, d,
                                           torch.float32)
        q = torch.randn(len(sid), hq, d, generator=gen, device=dev)
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = (q.to(dtype), kp.to(dtype), vp.to(dtype))
            out[f"k4_{name}_{dt}_us"] = 1e3 * cs._device_ms(
                lambda x=x, a=(tbl, sid, qp, kvl): k4.flashd_varlen(*x, *a, block_q=bq), flush)

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype="float32")
    params = init_lm(cfg, device=dev, seed=0)
    lay = choose_page_layout(max_len, cfg.head_dim_, cfg.head_dim_,
                             group=cfg.n_heads // cfg.n_kv_heads, pool_tokens=be * max_len)
    pcache = init_decode_cache(be, max_len, cfg, layout="paged", page_size=lay.page_size,
                               n_pages=lay.n_pages, device=dev)
    rows_tbl = torch.arange(1, lay.n_pages, dtype=torch.int32, device=dev)
    rows_tbl = rows_tbl[: be * lay.pages_per_seq].reshape(be, lay.pages_per_seq)
    for group in pcache.values():
        for leaves in group.values():
            leaves["tbl"][:] = rows_tbl
    pack = [torch.as_tensor(a, device=dev) for a in pack_plan(mixed, bq, be)]
    pack[0] = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, len(pack[1])),
                              device=dev)
    line = cs._breakdown("packed step", lambda: forward_packed(
        params, pack[0], pack[1], pack[2], pack[3], pcache, cfg, pack[4], block_q=bq),
        watch=("varlen",))
    out["packed_busy_ms"] = float(line.split("device busy ")[1].split(" ms")[0])
    out["packed_k4_ms"] = float(line.split("(")[-1].split(" ms")[0])
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(_measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (os.path.abspath(r) for r in sys.argv[1:])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    code = ("import sys; sys.path.insert(0, sys.argv[1] + '/src'); "
            "from repro_torch.kernels import _build; _build.build(['flashd_decode', 'flashd_varlen'])")
    builds = [subprocess.Popen([sys.executable, "-c", code, r]) for r in (old, new)]
    if [p.wait() for p in builds] != [0, 0]:
        return 1
    runs = {old: [], new: []}
    for root in (old, new, new, old):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[root].append(json.loads(line))
    med = {}
    for key in runs[new][0]:
        if key == "root":
            continue
        o, n = (sum(r[key] for r in runs[t]) / len(runs[t]) for t in (old, new))
        med[key] = {"old": o, "new": n, "new/old": n / o}
    print(json.dumps(med), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
