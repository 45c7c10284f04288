"""Batched serving engine on the contiguous KV cache — the port of
`repro/serve/engine.py` (`ServeConfig`, `sample_token`, `Engine.generate`,
and `Engine.serve` on the sequential contiguous loop).

Requests join a slot array; finished slots are refilled from a priority
queue (FIFO within a class). The slot lifecycle — queue, per-slot outputs,
EOS / max-token completion, refill, priority preemption, peak concurrency
and per-request TTFT — is the reference's `Scheduler`, copied verbatim in
`repro_torch.serve.scheduler`; this module owns the device work.

Device work runs eagerly on the engine's device (the card by default).
The attention of every prompt token and every generated token runs in the
K2 decode kernel: prefill is `prefill_lm`, one decode step per prompt
position. PyTorch has no compile step to bucket for, so the port prefills
exactly the real prompt length (the reference pads to a power of two and
masks the padding with `lengths=`, which gives the same result).

Host syncs: `generate` keeps every token on the device and copies them to
the host once (`host_syncs` counts each device→host copy); `serve` syncs
once per prefill (the first sampled token) and once per `decode_chunk`
decode steps.

Not ported yet, and refused at construction: the paged and mixed loops
(A5, A6), the prefix cache (A7), quantized KV (A8), speculation (A9),
fault injection and snapshot / restore (A10).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.devices import resolve_device
from repro_torch.models import ModelConfig, get_model
from repro_torch.models.transformer import prefill_lm
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["ServeConfig", "Engine", "sample_token"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0
    eos_id: int = -1  # <0: run to max_new_tokens
    seed: int = 0
    decode_chunk: int = 8  # decode steps between host syncs in `serve`
    kv_layout: str = "contiguous"  # "paged": A5
    kv_dtype: str = ""  # quantized pool: A8
    step_mode: str = "sequential"  # "mixed": A6
    spec_tokens: int = 0  # speculative decoding: A9
    preemption: bool = True  # priority preemption of a live slot
    deadline_s: float = 0.0  # default per-request deadline; 0 → none
    fault_rate: float = 0.0  # chaos injection: A10


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 cfg: ServeConfig) -> torch.Tensor:
    """logits [B, V] → token [B] (int64), on the logits' device.

    Greedy is argmax (first maximum, like jnp.argmax). Temperature sampling
    is Gumbel-max with noise from `generator`: a deterministic function of
    the seed, but not the reference's `jax.random` stream."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _slot_view(cache: dict, slot: int) -> dict:
    """Batch-1 view of one slot of a stacked [L, B, ...] cache tree."""
    if isinstance(cache, dict):
        return {k: _slot_view(v, slot) for k, v in cache.items()}
    return cache[:, slot:slot + 1]


class Engine:
    def __init__(self, params: dict, model_cfg: ModelConfig, serve_cfg: ServeConfig,
                 *, device=None):
        unported = {
            "kv_layout": (serve_cfg.kv_layout != "contiguous", "A5"),
            "step_mode": (serve_cfg.step_mode != "sequential", "A6"),
            "kv_dtype": (bool(serve_cfg.kv_dtype), "A8"),
            "spec_tokens": (serve_cfg.spec_tokens > 0, "A9"),
            "fault_rate": (serve_cfg.fault_rate > 0, "A10"),
        }
        for name, (asked, item) in unported.items():
            if asked:
                raise NotImplementedError(f"ServeConfig.{name} not ported ({item})")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"parameters are on {params['embed'].device}, the engine on {self.device}"
            )
        self.params = params
        self.mc = model_cfg
        self.sc = serve_cfg
        self.api = get_model(model_cfg)
        self._gen = torch.Generator(device=self.device).manual_seed(serve_cfg.seed)
        self.host_syncs = 0  # device→host copies issued by this engine
        self.peak_active = 0  # max concurrent sequences observed by `serve`
        self.ttft = {}  # rid → time-to-first-token of the last serve() call
        self._stats = {"preemptions": 0, "failed": 0, "retried": 0, "expired": 0}
        self._sched: Optional[Scheduler] = None

    def _to_host(self, x: torch.Tensor) -> np.ndarray:
        """The engine's ONLY device→host copy (counted for tests)."""
        self.host_syncs += 1
        return x.cpu().numpy()

    def _await_backoff(self, sched: Scheduler) -> bool:
        """No live slot: sleep until the earliest queued request is
        eligible; False when the queue is empty too (serving is over)."""
        if not sched.queue:
            return False
        wait = sched.next_ready_in()
        if wait is not None and wait > 0:
            time.sleep(wait)
        return True

    def _make_sched(self, requests, max_new_tokens: int, priorities, deadlines) -> Scheduler:
        if deadlines is None and self.sc.deadline_s > 0:
            deadlines = [self.sc.deadline_s] * len(requests)
        sched = Scheduler(
            requests, max_new_tokens, self.sc.max_batch, self.sc.eos_id,
            priorities=priorities, deadlines=deadlines,
        )
        self._sched = sched
        return sched

    def _finish_serve(self, sched: Scheduler) -> None:
        self.ttft = dict(sched.first_token_at)
        self._stats["preemptions"] += sched.preemptions
        self._stats["retried"] += sched.retried
        self._stats["failed"] += sched.failed
        self._stats["expired"] += sched.expired

    def stats(self) -> dict:
        """Serving counters, cumulative over this engine's lifetime, plus the
        last serve() call's per-request TTFT and statuses."""
        s = dict(self._stats)
        s["peak_active"] = self.peak_active
        s["ttft"] = dict(self.ttft)
        s["attn_impl"] = self.mc.attn_impl
        s["host_syncs"] = self.host_syncs
        if self._sched is not None:
            s["request_status"] = dict(self._sched.status)
        return s

    def snapshot(self, *_args, **_kwargs):
        raise NotImplementedError("snapshot / restore not ported (A10)")

    restore = resume = snapshot

    # ---- single-prompt-batch generation (prefill + n decode steps) ----
    def generate(self, prompts: np.ndarray, max_new_tokens: int) -> np.ndarray:
        """prompts [B, S_prompt] int → generated tokens [B, max_new_tokens].

        The whole loop stays on the device — sampling and early-EOS masking
        included (after a row samples eos_id, its later tokens are eos_id) —
        and the tokens are copied to the host once."""
        b, s = prompts.shape
        if s + max_new_tokens > self.sc.max_len:
            raise ValueError(f"prompt {s} + {max_new_tokens} exceeds max_len {self.sc.max_len}")
        eos = self.sc.eos_id
        with torch.inference_mode():
            cache = self.api.init_cache(b, self.sc.max_len, self.mc, device=self.device)
            toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=self.device)
            logits, cache = prefill_lm(self.params, toks, cache, self.mc)
            pos = torch.full((b,), s, dtype=torch.long, device=self.device)
            done = torch.zeros((b,), dtype=torch.bool, device=self.device)
            out = []
            for i in range(max_new_tokens):
                tok = sample_token(logits, self._gen, self.sc)
                if eos >= 0:
                    out.append(torch.where(done, eos, tok))
                    done = done | (tok == eos)
                else:
                    out.append(tok)
                if i + 1 < max_new_tokens:  # the last token needs no decode step
                    logits, cache = self.api.decode_step(self.params, cache, tok, pos, self.mc)
                    pos = pos + 1
            if not out:
                return np.zeros((b, 0), np.int64)
            return self._to_host(torch.stack(out, dim=1))

    # ---- continuous batching over a request queue ----
    def serve(self, requests: Sequence[Union[np.ndarray, Request]], max_new_tokens: int,
              priorities: Optional[Sequence[int]] = None,
              deadlines: Optional[Sequence[Optional[float]]] = None) -> List[np.ndarray]:
        """Each request: a 1-D prompt array (or a `Request`). Returns the
        generated arrays in request order. `priorities` (higher = more
        urgent) steer admission and let a higher-priority arrival preempt a
        live slot; `deadlines` (seconds from enqueue) cancel overdue requests
        like EOS. Runs the sequential contiguous loop."""
        with torch.inference_mode():
            return self._serve_impl(requests, max_new_tokens, priorities, deadlines)

    def _check_len(self, rid: int, n_prompt: int, max_new_tokens: int) -> None:
        if n_prompt + max_new_tokens > self.sc.max_len:
            raise ValueError(f"request {rid}: prompt {n_prompt} + {max_new_tokens}"
                             f" exceeds max_len {self.sc.max_len}")

    def _serve_impl(self, requests, max_new_tokens: int, priorities=None,
                    deadlines=None) -> List[np.ndarray]:
        b = self.sc.max_batch
        dev = self.device
        sched = self._make_sched(requests, max_new_tokens, priorities, deadlines)
        cache = self.api.init_cache(b, self.sc.max_len, self.mc, device=dev)
        tok = torch.zeros((b,), dtype=torch.long, device=dev)
        pos = torch.zeros((b,), dtype=torch.long, device=dev)
        chunk_n = max(1, min(self.sc.decode_chunk, max_new_tokens))

        def assign(slot: int):
            """Prefill the next queued request straight into `slot`'s cache
            region (zeroed first, as the reference's fresh one-row cache).
            The prefill's sampled token is output token 0; a resumed request
            replays its pre-preemption tokens. Requests that complete at
            once are finalized and the next is taken."""
            while (req := sched.take_head()) is not None:
                toks = req.tokens
                self._check_len(req.rid, len(req.prompt), max_new_tokens)
                view = _slot_view(cache, slot)
                for group in view.values():
                    for leaves in group.values():
                        for leaf in leaves.values():
                            leaf.zero_()
                prompt = torch.as_tensor(np.asarray(toks), dtype=torch.long, device=dev)
                logits, _ = prefill_lm(self.params, prompt[None], view, self.mc)
                t0 = int(self._to_host(sample_token(logits, self._gen, self.sc))[0])
                if not sched.admit_request(slot, req, t0):
                    continue
                tok[slot] = t0
                pos[slot] = len(toks)
                return

        def preempt_for_priority():
            """A queued request of strictly higher priority than a live slot
            evicts that slot (lowest priority, youngest first): the victim
            re-queues with recompute-on-resume, the arrival takes its place."""
            if not self.sc.preemption:
                return
            while (req := sched.head()) is not None and sched.free_slot() is None:
                v = sched.victim_slot(below=req.priority)
                if v is None:
                    return
                sched.preempt(v)
                assign(v)

        def refill():
            for s in range(b):
                if not sched.slots[s].live:
                    assign(s)
            preempt_for_priority()

        refill()
        self.peak_active = sched.note_peak()
        while sched.has_active() or sched.queue:
            for s in sched.expire_overdue():
                sched.retire(s)  # the slot's cache region just goes stale
            if not sched.has_active():
                if not self._await_backoff(sched):
                    break
                refill()
                continue
            chunk = []
            for _ in range(chunk_n):  # dead slots step in lockstep; ignored
                logits, cache = self.api.decode_step(self.params, cache, tok, pos, self.mc)
                tok = sample_token(logits, self._gen, self.sc)
                pos = pos + 1
                chunk.append(tok)
            toks_np = self._to_host(torch.stack(chunk))  # one sync per chunk
            for s in sched.absorb_chunk(toks_np):
                sched.retire(s)
                assign(s)  # overwrites the slot's cache / tok / pos
            preempt_for_priority()
            self.peak_active = sched.note_peak()
        self._finish_serve(sched)
        return sched.results_list()
