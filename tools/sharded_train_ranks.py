"""The sharded train step across 4 ranks on a (2, 2) ('data', 'model') mesh
against the unsharded step on every rank, from the same seeded init and
batches: qwen3-0.6b at full width cut to 14 layers, f32, B 4 x S 1024, two
steps at peak lr (`--smoke`: the smoke config at S 64). Rank 0 prints one
JSON line: both loss / grad norm curves, their largest relative gap, the
parameters' largest absolute gap, each rank's K1 / K5 / K6 launches, the
seconds per step. The exit code is 1 when the curves part by more than
1e-4 or, on the card, K1 or K5 did not launch (or K6 did). Run from the
root of a checkout:

    torchrun --nproc_per_node 4 tools/sharded_train_ranks.py cuda      # NCCL, 4 cards
    torchrun --nproc_per_node 4 tools/sharded_train_ranks.py cpu --smoke  # gloo
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.getcwd(), "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.devices import make_mesh  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import fa2_fwd as k6  # noqa: E402
from repro_torch.kernels import flashd_bwd as k5  # noqa: E402
from repro_torch.kernels import flashd_fwd as k1  # noqa: E402
from repro_torch.train import TrainConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.train.train_step import train_state_specs  # noqa: E402
from repro_torch.tree import tree_flatten_with_names  # noqa: E402


def main(dev_type: str, smoke: bool) -> int:
    # DTensor warns of two all-reduces where a 2-D mesh reduces a scalar
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    on_card = dev_type == "cuda"
    if not on_card:
        torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"), device=dev_type)
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    base = (get_smoke_config("qwen3-0.6b") if smoke
            else dataclasses.replace(get_config("qwen3-0.6b"), n_layers=14))
    cfg = dataclasses.replace(base, dtype="float32",
                              attn_impl="flashd_gpu" if on_card else "flashd")
    tc = TrainConfig(warmup_steps=0, total_steps=4)
    seq = 64 if smoke else 1024
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=4, seed=0))
    batches = [{k: torch.as_tensor(x, device=dev) for k, x in data.batch(i).items()}
               for i in range(2)]

    def run(step, state):
        curve, secs = [], []
        for batch in batches:
            if on_card:
                torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            curve.append(torch.stack([m["loss"], m["grad_norm"]]).tolist())
            secs.append(time.perf_counter() - t)
        return state, curve, secs

    state, curve_u, secs_u = run(make_train_step(cfg, tc),
                                 init_train_state(cfg, tc, device=dev, seed=0))
    params_u = dict(tree_flatten_with_names(state.params))
    del state
    ctx = shd.ShardingCtx(mesh)
    with shd.activate(ctx):
        state = init_train_state(cfg, tc, device=dev, seed=0)
        state = shd.distribute_tree(state, train_state_specs(state))
        step = shd.sharded(make_train_step(cfg, tc), (None, shd.batch_specs(batches[0])))
    before = (k1.launches, k5.launches, k6.launches)
    state, curve_s, secs_s = run(step, state)
    launched = [a - b for a, b in zip((k1.launches, k5.launches, k6.launches), before)]
    gap, placed = 0.0, {}
    for name, x in tree_flatten_with_names(state.params):
        placed[name] = str(tuple(x.placements))
        gap = max(gap, float((x.full_tensor() - params_u[name]).abs().max()))
    rel = max(abs(a[j] - w[j]) / abs(w[j]) for a, w in zip(curve_s, curve_u) for j in (0, 1))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, launched)
    if dist.get_rank() == 0:
        cards = ""
        if on_card:
            cards = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip().replace("\n", " | ")
        print(json.dumps({
            "cards": cards, "world": dist.get_world_size(), "mesh": dict(ctx.axis_sizes),
            "layers": cfg.n_layers, "B": 4, "S": seq, "curve_sharded": curve_s,
            "curve_unsharded": curve_u, "largest_rel_gap": rel, "param_max_abs_gap": gap,
            "launches_k1_k5_k6_per_rank": every, "secs_sharded": secs_s,
            "secs_unsharded": secs_u, "wq_placements": placed["blocks/pos0/mixer/wq"],
            "embed_placements": placed["embed"]}), flush=True)
    ok = rel <= 1e-4 and (not on_card or (launched[0] > 0 and launched[1] > 0
                                          and launched[2] == 0))
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], "--smoke" in sys.argv[2:]))
