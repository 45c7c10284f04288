"""Context parallelism across 4 ranks on a ('data',) mesh against the
unsharded model on every rank: qwen3-0.6b at full width cut to 14 layers,
f32, seeded random weights (`--smoke`: the smoke config, S 256, prompt 32,
8 new).

1. `apply_lm` at B 1 x S 8192 under a context with `cp_prefill=True` (B 1
   does not divide 'data', so the kv_cache rule splits the sequence and
   every attention layer runs the ring: K1 at hop offsets, KV shards on the
   wire) against the unsharded `apply_lm`: logits within 1e-3.
2. `Engine.generate` at B 1, prompt 512, 32 new, on the same context (a
   sequence-sharded cache: K2 on each rank's shard, the butterfly merge)
   against the unsharded engine: tokens equal, one host sync.

Rank 0 prints one JSON line: the cards, each rank's logits gap, K1 / K2 /
K6 launches, point-to-point messages and bytes (per ring hop and per
decode step), the seconds of each part sharded and unsharded. The exit
code is 1 when a rank's logits part by more than 1e-3, the tokens differ,
or (on the card) the ring launched no K1 or the decode no K2. Run from the
root of a checkout:

    torchrun --nproc_per_node 4 tools/cp_ranks.py cuda          # NCCL, 4 cards
    torchrun --nproc_per_node 4 tools/cp_ranks.py cpu --smoke   # gloo
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.getcwd(), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.devices import make_mesh  # noqa: E402
from repro_torch.distributed import context as cpx  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import fa2_fwd as k6  # noqa: E402
from repro_torch.kernels import flashd_decode as k2  # noqa: E402
from repro_torch.kernels import flashd_fwd as k1  # noqa: E402
from repro_torch.models.transformer import apply_lm, init_lm  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

LOGIT_TOL = 1e-3


def _launches():
    return {"k1": k1.launches, "k2": k2.launches, "k6": k6.launches}


def main(dev_type: str, smoke: bool) -> int:
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    on_card = dev_type == "cuda"
    if not on_card:
        torch.set_num_threads(1)
    mesh = make_mesh((int(os.environ["WORLD_SIZE"]),), ("data",), device=dev_type)
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    base = get_smoke_config("qwen3-0.6b") if smoke else dataclasses.replace(
        get_config("qwen3-0.6b"), n_layers=14)
    cfg = dataclasses.replace(base, dtype="float32")
    seq, prompt_len, n_new = (256, 32, 8) if smoke else (8192, 512, 32)
    params = init_lm(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, seq)), device=dev)
    prompt = rng.integers(0, cfg.vocab_size, (1, prompt_len)).astype(np.int32)

    def timed(fn):
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t

    out = {}
    # 1. prefill: the ring in every attention layer
    with torch.no_grad():
        apply_lm(params, {"tokens": tokens}, cfg)  # first call: one-time library set-up
        want, out["apply_unsharded_s"] = timed(lambda: apply_lm(params, {"tokens": tokens}, cfg)[0])
        ctx = shd.ShardingCtx(mesh, cp_prefill=True)
        with shd.activate(ctx):
            dparams = shd.distribute_tree(params, shd.param_specs(params))
            batch = shd.distribute_tree({"tokens": tokens}, shd.batch_specs({"tokens": tokens}))
            apply_lm(dparams, batch, cfg)  # first call: DTensor's sharding propagation
            before = _launches()
            cpx.reset_wire()
            got, out["apply_sharded_s"] = timed(lambda: apply_lm(dparams, batch, cfg)[0])
            out["apply_launches"] = {k: v - before[k] for k, v in _launches().items()}
            out["apply_wire"] = [cpx.sends, cpx.sent_bytes, cpx.gathers]
            got = got.full_tensor()
    v = cfg.vocab_size
    out["logit_gap"] = float((got[..., :v] - want[..., :v]).abs().max())
    del got, want, dparams
    # 2. decode: the engine on a sequence-sharded cache
    sc = ServeConfig(max_len=prompt_len + n_new, temperature=0.0)
    want, out["gen_unsharded_s"] = timed(lambda: Engine(params, cfg, sc, device=dev).generate(
        prompt, n_new))  # captured on the card (its captures included)
    eager, out["gen_unsharded_eager_s"] = timed(
        lambda: Engine(params, cfg, sc, device=dev, graphs=False).generate(prompt, n_new))
    eng = Engine(params, cfg, sc, device=dev, sharding_ctx=shd.ShardingCtx(mesh))
    before = _launches()
    cpx.reset_wire()
    toks, out["gen_sharded_s"] = timed(lambda: eng.generate(prompt, n_new))
    out["gen_launches"] = {k: v - before[k] for k, v in _launches().items()}
    out["gen_wire"] = [cpx.sends, cpx.sent_bytes, cpx.gathers]
    out["tokens_equal"] = bool(np.array_equal(toks, want) and np.array_equal(eager, want))
    out["host_syncs"] = eng.host_syncs
    out["cache_placements"] = str(tuple(eng._contig[1].cache["blocks"]["pos0"]["k"].placements))

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    ok = all(o["logit_gap"] <= LOGIT_TOL and o["tokens_equal"] and o["host_syncs"] == 1
             for o in every)
    if on_card:
        ok = ok and all(o["apply_launches"]["k1"] > 0 and o["gen_launches"]["k2"] > 0
                        for o in every)
    if dist.get_rank() == 0:
        cards = ""
        if on_card:
            cards = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip().replace("\n", " | ")
        steps = prompt_len + n_new - 1
        n_hops = mesh.size() - 1  # causal: every rank posts n − 1 hops of K and V
        print(json.dumps({
            "cards": cards, "world": dist.get_world_size(), "layers": cfg.n_layers,
            "apply": {"B": 1, "S": seq}, "generate": {"B": 1, "prompt": prompt_len,
                                                      "new": n_new},
            "ok": ok, "ranks": every,
            "ring_bytes_per_hop_per_layer": every[0]["apply_wire"][1] / (n_hops * cfg.n_layers),
            "decode_bytes_per_step_per_layer": every[0]["gen_wire"][1] / (steps * cfg.n_layers),
            "s_per_token_sharded": [o["gen_sharded_s"] / steps for o in every],
            "s_per_token_unsharded": [o["gen_unsharded_s"] / steps for o in every],
            "s_per_token_unsharded_eager": [o["gen_unsharded_eager_s"] / steps for o in every]}),
            flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], "--smoke" in sys.argv[2:]))
