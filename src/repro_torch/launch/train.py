"""Training launcher: config → resilient loop → checkpoints — the port of
`repro/launch/train.py` on one device.

The loop runs under the `train_resilient` supervisor: verified checkpoints
with newest-good fallback, the non-finite-grad skip and dynamic loss
scaling inside the step, loss-spike rollback, and — with `--fault-rate` —
deterministic chaos at the five train sites. Restarting after a crash
with `--resume` replays to a bitwise-identical loss curve.

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-llama \\
        --steps 200 --global-batch 8 --seq-len 128 --ckpt-dir /path/to/ckpt

    # on the CPU, at the smoke widths (a check of the control flow)
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 3

Runs on the card unless `--device cpu` is given. The reference's flags,
without `--compression` (gradient compression: the multi-device slice, A13)
and without a mesh: one device.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.devices import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.resilience import FaultInjector, StragglerMonitor
from repro_torch.train import ResilienceConfig, train_resilient
from repro_torch.train.train_step import TrainConfig


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="paper-llama", choices=configs.ARCHS)
    p.add_argument("--smoke", action="store_true", help="use the reduced config")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--attn-impl", default=None)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default: fresh temp dir)")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--keep-checkpoints", type=int, default=3,
                   help="garbage-collect all but the newest N (0 → keep all)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest verified checkpoint in --ckpt-dir "
                        "(without this flag a non-empty dir is an error, so nothing "
                        "resumes silently)")
    p.add_argument("--fault-rate", type=float, default=0.0,
                   help="chaos injection: probability each train-site check fires "
                        "(0 → no injection)")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed for the deterministic fault injector")
    p.add_argument("--spike-threshold", type=float, default=0.0,
                   help="loss-spike rollback: loss > T × trailing median restores the "
                        "last good checkpoint (0 → off)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    if cfg.is_encdec:
        raise SystemExit(f"--arch {args.arch}: an encoder-decoder stack trains on frame_embeds, "
                         f"which the data pipeline (SyntheticLM: tokens and labels) does not "
                         f"feed, as the reference's does not; train it through "
                         f"train.make_train_step with a frame_embeds batch")
    dev = resolve_device(args.device)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    tc = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr),
        warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps,
        accum_steps=args.accum,
    )

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_ckpt_")
    existing = ckpt.valid_steps(ckpt_dir)
    if existing and not args.resume:
        raise SystemExit(
            f"{ckpt_dir} already holds checkpoints (steps {existing}); "
            f"pass --resume to continue or point --ckpt-dir elsewhere"
        )
    if args.resume and existing:
        print(f"resuming from step {existing[-1]} in {ckpt_dir}")

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=args.seed,
    ))
    injector = None
    if args.fault_rate > 0:
        injector = FaultInjector(args.fault_rate, args.fault_seed,
                                 sites=FaultInjector.TRAIN_SITES)

    monitor = StragglerMonitor(
        on_straggler=lambda s, dt, mu: print(
            f"[straggler] step {s}: {dt*1e3:.0f}ms vs EWMA {mu*1e3:.0f}ms"
        )
    )
    last_t = [time.monotonic()]

    def on_step(step, metrics, counters):
        now = time.monotonic()
        monitor.observe(step, now - last_t[0])
        last_t[0] = now
        if step % args.log_every == 0 or step == args.steps - 1:
            moe = (f"moe aux {metrics['moe_aux_loss']:.4f} z {metrics['moe_z_loss']:.4f} "
                   f"dropped {metrics['moe_dropped']:.3f} " if cfg.n_experts else "")
            print(
                f"step {step:5d} loss {metrics['loss']:.4f} "
                f"gnorm {metrics['grad_norm']:.3f} "
                f"lr {metrics['lr']:.2e} "
                f"scale {metrics['loss_scale']:.3g} {moe}| "
                f"skipped={int(metrics['skipped'])} "
                f"rollbacks={counters['rollbacks']} "
                f"restarts={counters['restarts']} "
                f"faults={counters['faults']}",
                flush=True,
            )

    res = ResilienceConfig(
        ckpt_every=args.ckpt_every,
        keep_checkpoints=args.keep_checkpoints or None,
        spike_threshold=args.spike_threshold,
    )
    t0 = time.time()
    state, history, counters = train_resilient(
        ckpt_dir=ckpt_dir, model_cfg=cfg, train_cfg=tc, data=data,
        total_steps=args.steps, seed=args.seed, res=res, injector=injector,
        on_step=on_step, device=dev,
    )
    print(
        f"done: {len(history)} committed steps in {time.time() - t0:.1f}s on {dev.type} "
        f"(skipped={counters['skipped']} rollbacks={counters['rollbacks']} "
        f"restarts={counters['restarts']} faults={counters['faults']} "
        f"stragglers={len(monitor.flagged)}) — checkpoints in {ckpt_dir}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
