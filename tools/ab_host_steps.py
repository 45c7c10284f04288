#!/usr/bin/env python3
"""The host cost of the eager steps of two checkouts, on one GPU in one
call, in turns.

    python3 tools/ab_host_steps.py OLD_ROOT NEW_ROOT

Each ROOT is a checkout of this repository (for example a `git archive`
of a parent commit unpacked under the gitignored build/). The script
builds both trees' flashd_fwd, flashd_bwd and flashd_decode sources at
once, then runs one process per tree in the order old, new, new, old.
Each process puts its ROOT/src first on sys.path and reads, with
chip_smoke.py's `_breakdown` (host ms per step, device busy by
torch.profiler), on qwen3-0.6b at full width (28 layers, f32, seeded
random weights):
  - the training step of chip_smoke's phase 12 (B 2 x S 1024
    SyntheticLM, AdamW, remat 'full', K1 forward and K5 backward);
  - one eager decode step of chip_smoke's phase 5 (B 4, S_max 512, at
    position 300, K2).
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


def _host_and_busy(line: str) -> tuple:
    host = float(line.split("host ")[1].split(" ms")[0])
    return host, float(line.split("device busy ")[1].split(" ms")[0])


def _measure(root: str) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    import dataclasses

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import flashd_fwd as k1
    from repro_torch.models.transformer import decode_step_lm, init_decode_cache
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    assert k1.__file__.startswith(os.path.abspath(root)), k1.__file__
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype="float32")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, global_batch=2, seed=0))
    batch = {k: torch.as_tensor(x, device=dev) for k, x in data.batch(0).items()}
    tc = TrainConfig(warmup_steps=0, total_steps=4)
    state = init_train_state(dataclasses.replace(cfg, attn_impl="flashd_gpu"), tc, device=dev,
                             seed=0)
    step = make_train_step(dataclasses.replace(cfg, attn_impl="flashd_gpu"), tc)
    out = {"root": root}
    out["train_host_ms"], out["train_busy_ms"] = _host_and_busy(cs._breakdown(
        "train step", lambda: step(state, batch), steps=2, train=True))
    params = state.params
    del state, step
    cache = init_decode_cache(4, 512, cfg, device=dev)
    tok = torch.zeros(4, dtype=torch.long, device=dev)
    at = torch.full((4,), 300, dtype=torch.long, device=dev)
    out["decode_host_ms"], out["decode_busy_ms"] = _host_and_busy(cs._breakdown(
        "decode step", lambda: decode_step_lm(params, cache, tok, at, cfg)))
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
            "from repro_torch.kernels import _build; "
            "_build.build(['flashd_fwd', 'flashd_bwd', 'flashd_decode'])")
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
    means = {}
    for key in runs[new][0]:
        if key == "root":
            continue
        o, n = (sum(r[key] for r in runs[t]) / len(runs[t]) for t in (old, new))
        means[key] = {"old": o, "new": n, "new/old": n / o}
    print(json.dumps(means), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
