"""Batched serving engine — the port of `repro/serve/engine.py`:
`ServeConfig`, `sample_token`, `Engine.generate`, and `Engine.serve` on the
reference's three loops:

  contiguous (default) — each slot owns a fixed max_len-wide cache region;
    prefill is `prefill_lm`, one decode step per prompt position (K2).
  paged (kv_layout="paged") — KV lives in a global page pool with
    per-sequence block tables (`repro_torch.runtime.kvcache`, copied from
    the reference); admission is by free pages, decode and prefill run K3.
  mixed (step_mode="mixed") — chunked-prefill continuous batching over the
    paged pool: every step packs each decoding slot's pending token with
    the next `prefill_chunk`-token pieces of admitted prompts into one flat
    batch and runs ONE `forward_packed` step (K4); steps with no prefill in
    flight take the decode fast path, `decode_chunk` decode steps (K3).

Requests join a slot array; finished slots are refilled from a priority
queue (FIFO within a class). The slot lifecycle — queue, per-slot outputs,
EOS / max-token completion, refill, priority preemption, mixed-step plans,
peak concurrency and per-request TTFT — is the reference's `Scheduler`,
copied verbatim in `repro_torch.serve.scheduler`; this module owns memory
admission and the device work.

The paged loops keep both of the reference's admission modes: with
`preemption` (default) a request is admitted when its PROMPT fits, growth
draws the free pool and page pressure preempts the lowest-priority,
youngest slot (recompute-on-resume keeps every stream token-identical);
without, the worst case is reserved up front and a blocked head waits for
frees. The allocator and the device page pool live on the engine across
serve() calls. Prefix reuse (the radix prefix cache, A7) is not wired:
paged and mixed engines need `prefix_cache=False`, so every prompt
prefills in full.

Device work runs eagerly on the engine's device (the card by default).
PyTorch has no compile step to bucket for, so the port prefills exactly
the real prompt length (the reference pads to a power of two and masks the
padding with `lengths=`, which gives the same result); packed steps keep
the reference's power-of-two pack lengths, so both packers yield the same
layout.

Host syncs: `generate` keeps every token on the device and copies them to
the host once (`host_syncs` counts each device→host copy); the sequential
loops sync once per prefill and once per `decode_chunk` decode steps; the
mixed loop once per packed step or decode chunk. Caches are updated in
place, so a step is committed before its sync (the reference commits after
it; fault retry, A10, needs that back).

Not ported yet, and refused at construction: the prefix cache on the
paged pool (A7), quantized KV (A8), speculation (A9), fault injection and
snapshot / restore (A10).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.devices import resolve_device
from repro_torch.kernels.tuning import bucket_pow2, choose_page_layout, choose_varlen_blocks
from repro_torch.models import ModelConfig, get_model
from repro_torch.models.transformer import (
    forward_packed,
    packed_mixers_ok,
    paged_mixers,
    prefill_lm,
)
from repro_torch.runtime.kvcache import CachePolicy, PagedKVAllocator, PageError, pages_for
from repro_torch.serve.scheduler import Request, Scheduler, StepPlan

__all__ = ["ServeConfig", "Engine", "sample_token", "pack_plan"]

_POOL_LEAVES = ("k_pages", "v_pages")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0
    eos_id: int = -1  # <0: run to max_new_tokens
    seed: int = 0
    decode_chunk: int = 8  # decode steps between host syncs in `serve`
    # ---- paged KV cache ----
    kv_layout: str = "contiguous"  # "paged": page-pool KV in `serve`
    page_size: int = 0  # 0 → tuning heuristic
    kv_pool_tokens: int = 0  # pool size in tokens; 0 → max_batch·max_len
    kv_dtype: str = ""  # quantized pool: A8
    # prefix reuse (the radix prefix cache) is A7: a paged or mixed engine
    # refuses prefix_sharing and prefix_cache both on (the reference's
    # defaults, under which it would reuse prefixes)
    prefix_sharing: bool = True
    prefix_cache: bool = True
    cache_min_free_pages: int = -1  # prefix-cache eviction watermark (A7)
    cache_max_pages: int = -1  # prefix-cache retained-page cap (A7)
    preemption: bool = True  # optimistic admission + victim preemption
    # ---- mixed varlen step ----
    step_mode: str = "sequential"  # "mixed": chunked-prefill packed steps
    token_budget: int = 0  # packed tokens per mixed step; 0 → max_batch + prefill_chunk
    prefill_chunk: int = 16  # max prompt tokens one sequence feeds per step
    spec_tokens: int = 0  # speculative decoding: A9
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
    """Batch-1 view of one slot of a stacked [L, B, ...] cache tree; page
    pools (no batch axis) are shared whole."""
    return {k: (_slot_view(v, slot) if isinstance(v, dict)
                else v if k in _POOL_LEAVES else v[:, slot:slot + 1])
            for k, v in cache.items()}


def _leaves(tree: dict):
    """(leaf name, tensor) pairs of a cache tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield k, v


def pack_plan(plan: StepPlan, block_q: int, max_batch: int):
    """The mixed step's packer: a plan's segments → flat numpy arrays
    (tokens, seq_ids, positions, kv_len, last_rows).

    Each segment starts on a `block_q` boundary (so every q block of the
    pack belongs to one sequence, K4's contract) and the pack is padded to
    a power of two ≥ block_q; padding rows carry seq_id −1, position −1.
    kv_len [max_batch] is each slot's KV length after the pack; last_rows
    [max_batch] the pack row sampled for an emitting segment, −1 elsewhere."""
    off = 0
    spans = []
    for seg in plan.segments:
        spans.append(off)
        off += -(-len(seg.tokens) // block_q) * block_q
    total = bucket_pow2(max(off, 1), lo=block_q)
    tokens = np.zeros((total,), np.int32)
    seq_ids = np.full((total,), -1, np.int32)
    positions = np.full((total,), -1, np.int32)
    kv_len = np.zeros((max_batch,), np.int32)
    last_rows = np.full((max_batch,), -1, np.int32)
    for seg, o in zip(plan.segments, spans):
        n = len(seg.tokens)
        tokens[o:o + n] = seg.tokens
        seq_ids[o:o + n] = seg.slot
        positions[o:o + n] = np.arange(seg.start, seg.start + n)
        kv_len[seg.slot] = seg.start + n
        if seg.emits:
            last_rows[seg.slot] = o + n - 1
    return tokens, seq_ids, positions, kv_len, last_rows


class _PoolCtx:
    """Mutable per-serve() context of the paged loops: the device cache
    tree plus the slot → allocator-sequence map."""

    __slots__ = ("cache", "seq_of")

    def __init__(self, cache):
        self.cache = cache
        self.seq_of: dict = {}


class Engine:
    def __init__(self, params: dict, model_cfg: ModelConfig, serve_cfg: ServeConfig,
                 *, device=None):
        if serve_cfg.kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {serve_cfg.kv_layout!r}")
        if serve_cfg.step_mode not in ("sequential", "mixed"):
            raise ValueError(f"unknown step_mode {serve_cfg.step_mode!r}")
        pooled = serve_cfg.kv_layout == "paged" or serve_cfg.step_mode == "mixed"
        unported = {
            "prefix_cache": (pooled and serve_cfg.prefix_sharing and serve_cfg.prefix_cache,
                             "A7; pass prefix_cache=False"),
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
        # paged geometry (paged or mixed engines with a global-attention layer)
        self._page_layout = None
        if pooled and paged_mixers(model_cfg):
            self._page_layout = choose_page_layout(
                serve_cfg.max_len, model_cfg.head_dim_, model_cfg.head_dim_,
                group=model_cfg.n_heads // model_cfg.n_kv_heads,
                pool_tokens=serve_cfg.kv_pool_tokens or serve_cfg.max_batch * serve_cfg.max_len,
                page_size=serve_cfg.page_size or None,
            )
        self._mixed_ok = (serve_cfg.step_mode == "mixed" and self._page_layout is not None
                          and packed_mixers_ok(model_cfg))
        # engine-lifetime paged state: allocator + device page pool
        self._alloc: Optional[PagedKVAllocator] = None
        self._paged_cache: Optional[dict] = None
        self._seq_base = 0  # allocator sequence ids, unique across calls

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
        s["preemption_enabled"] = bool(self.sc.preemption)
        s["prefix_cache_enabled"] = False  # A7
        if self._alloc is not None:
            s.update(evictions=self._alloc.evictions, donated_pages=self._alloc.donated_pages,
                     cached_pages=self._alloc.cached_pages,
                     pages_in_use=self._alloc.pages_in_use, free_pages=self._alloc.free_pages)
        if self._paged_cache is not None:
            seen = sum(x.numel() * x.element_size() for name, x in _leaves(self._paged_cache)
                       if name in _POOL_LEAVES)
            pool_tokens = self._page_layout.n_pages * self._page_layout.page_size
            s["kv_pool_bytes"] = int(seen)
            s["kv_bytes_per_token"] = seen / max(pool_tokens, 1)
            s["kv_dtype"] = self.sc.kv_dtype or "native"
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
        like EOS.

        Routing as the reference: `step_mode="mixed"` runs the mixed loop,
        otherwise `kv_layout` picks the paged or contiguous sequential loop.
        All three give the same tokens under greedy sampling."""
        with torch.inference_mode():
            if self._mixed_ok:
                return self._serve_mixed(requests, max_new_tokens, priorities, deadlines)
            if self._page_layout is not None and self.sc.kv_layout == "paged":
                return self._serve_paged(requests, max_new_tokens, priorities, deadlines)
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
                for _, leaf in _leaves(view):
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

    # ---- paged-pool shared machinery ----
    def _paged_state(self):
        """Engine-lifetime paged state: the allocator and the device page
        pool, created on first use and reused across serve() calls. With
        the prefix cache unported (A7) the allocator retains no pages."""
        if self._alloc is None:
            lay = self._page_layout
            self._alloc = PagedKVAllocator(lay.n_pages, lay.page_size,
                                           cache_policy=CachePolicy(max_cached_pages=0))
            self._paged_cache = self.api.init_cache(
                self.sc.max_batch, self.sc.max_len, self.mc, layout="paged",
                page_size=lay.page_size, n_pages=lay.n_pages, device=self.device,
            )
        return self._alloc, self._paged_cache

    def _drop_paged_state(self) -> None:
        """A serve() that raised leaves its sequences in the allocator: drop
        the pool and start the next call cold (the reference folds live
        slots back into the queue and keeps the pool warm — A10)."""
        self._alloc = self._paged_cache = None

    def _set_tbl_row(self, cache, slot: int, table: List[int]):
        """Mirror one slot's allocator block table into every layer's `tbl`
        leaf, in place (zero-padded: unmapped logical pages point at the
        garbage page)."""
        row = np.zeros((self._page_layout.pages_per_seq,), np.int32)
        row[: len(table)] = table
        row_t = torch.as_tensor(row, device=self.device)
        for name, leaf in _leaves(cache):
            if name == "tbl":
                leaf[:, slot] = row_t
        return cache

    def _copy_pages(self, cache, cows):
        """pages[:, dst] ← pages[:, src] for every owed copy-on-write copy."""
        if not cows:
            return cache
        srcs = torch.as_tensor([cw.src for cw in cows], device=self.device)
        dsts = torch.as_tensor([cw.dst for cw in cows], device=self.device)
        for name, leaf in _leaves(cache):
            if name in _POOL_LEAVES:
                leaf[:, dsts] = leaf[:, srcs]
        return cache

    def _pool_release(self, alloc, ctx: _PoolCtx, s: int) -> None:
        """Free slot s's pages and park its table row on the garbage page
        before the pages can be reassigned (the prefix cache, A7, would
        donate them instead)."""
        alloc.free(ctx.seq_of.pop(s))
        ctx.cache = self._set_tbl_row(ctx.cache, s, [])

    def _pool_retire(self, sched: Scheduler, alloc, ctx: _PoolCtx, s: int) -> None:
        self._pool_release(alloc, ctx, s)
        sched.retire(s)

    def _pool_preempt(self, sched: Scheduler, alloc, ctx: _PoolCtx, s: int) -> None:
        """Victim preemption: free the slot's pages and re-queue the request
        (recompute-on-resume)."""
        self._pool_release(alloc, ctx, s)
        sched.preempt(s)

    def _pool_grow(self, sched: Scheduler, alloc, ctx: _PoolCtx, s: int, want: int) -> bool:
        """Materialize pages so slot `s` can write up to `want` positions,
        preempting victims under page pressure. Returns False when `s`
        itself was the victim."""
        while True:
            seq = ctx.seq_of[s]
            before = len(alloc.table(seq))
            try:
                cows = alloc.extend(seq, want)
            except PageError:
                v = sched.victim_slot() if self.sc.preemption else None
                if v is None or sched.active_count() == 1:
                    raise
                self._pool_preempt(sched, alloc, ctx, v)
                if v == s:
                    return False
                continue
            ctx.cache = self._copy_pages(ctx.cache, cows)
            if cows or len(alloc.table(seq)) != before:
                ctx.cache = self._set_tbl_row(ctx.cache, s, alloc.table(seq))
            return True

    def _grow_live(self, sched: Scheduler, alloc, ctx: _PoolCtx, chunk_n: int) -> None:
        """Pages for the next `chunk_n` decode writes of every live slot
        (clamped to max_len: writes past the table land on page 0)."""
        for s in range(self.sc.max_batch):
            sl = sched.slots[s]
            if sl.live:
                self._pool_grow(sched, alloc, ctx, s, min(sl.kv + chunk_n, self.sc.max_len))

    def _pool_reserve(self, req: Request, max_new_tokens: int, chunk_n: int) -> int:
        """Admission reservation: just the prompt under preemption
        (optimistic growth) or the worst case without (prompt + remaining
        new tokens + one chunk of lockstep slack, clamped to max_len)."""
        n = len(req.tokens)
        if self.sc.preemption:
            return n
        return min(n + max_new_tokens - len(req.out) + chunk_n, self.sc.max_len)

    def _preempting_could_admit(self, sched: Scheduler, alloc, ctx: _PoolCtx, req: Request,
                                reserve: int) -> bool:
        """Even rolling back EVERY strictly-lower-priority victim frees at
        most their table pages: if that cannot cover the arrival, the head
        waits instead of discarding running work for nothing."""
        bound = alloc.free_pages + alloc.evictable_pages
        for s, sl in enumerate(sched.slots):
            if sl.live and sl.priority < req.priority:
                bound += len(alloc.table(ctx.seq_of[s]))
        return pages_for(reserve, alloc.page_size) <= bound

    def _admit_to_pool(self, sched: Scheduler, alloc, ctx: _PoolCtx, req: Request,
                       max_new_tokens: int, chunk_n: int) -> Optional[int]:
        """Page admission of the head request: evict / preempt lower-priority
        victims as needed. Returns the new allocator sequence (the request
        taken off the queue), or None when the head must wait (then nothing
        changed) — raising when nothing live could ever free enough."""
        while True:
            self._check_len(req.rid, len(req.prompt), max_new_tokens)
            reserve = self._pool_reserve(req, max_new_tokens, chunk_n)
            if alloc.can_admit(reserve):
                break
            if self.sc.preemption and self._preempting_could_admit(
                    sched, alloc, ctx, req, reserve) and (
                    v := sched.victim_slot(below=req.priority)) is not None:
                self._pool_preempt(sched, alloc, ctx, v)
                continue
            if sched.has_active():
                return None  # live sequences will free pages
            raise PageError(f"request {req.rid} needs {pages_for(reserve, alloc.page_size)}"
                            f" pages but the pool holds {self._page_layout.n_pages - 1}")
        sched.take_head()
        seq = self._seq_base
        self._seq_base += 1
        alloc.admit(seq, prompt_len=len(req.tokens), reserve_tokens=reserve)
        return seq

    # ---- paged sequential loop ----
    def _serve_paged(self, requests, max_new_tokens: int, priorities=None,
                     deadlines=None) -> List[np.ndarray]:
        """Sequential continuous batching over the page pool: admission by
        free pages; before every chunk the allocator materializes pages
        for the chunk's writes (preempting under pressure) and the tables
        are mirrored to the device; finished slots free their pages and
        park their table row on the garbage page, so lockstep writes of
        dead slots stay harmless."""
        b = self.sc.max_batch
        dev = self.device
        sched = self._make_sched(requests, max_new_tokens, priorities, deadlines)
        alloc, cache0 = self._paged_state()
        ctx = _PoolCtx(cache0)
        tok = torch.zeros((b,), dtype=torch.long, device=dev)
        pos = torch.zeros((b,), dtype=torch.long, device=dev)
        chunk_n = max(1, min(self.sc.decode_chunk, max_new_tokens))

        def assign(slot: int) -> bool:
            """Admit the head request into `slot` if the pool can cover it
            and prefill it there; False (queue intact) when it must wait."""
            while (req := sched.head()) is not None:
                seq = self._admit_to_pool(sched, alloc, ctx, req, max_new_tokens, chunk_n)
                if seq is None:
                    return False
                toks = req.tokens
                ctx.cache = self._set_tbl_row(ctx.cache, slot, alloc.table(seq))
                prompt = torch.as_tensor(np.asarray(toks), dtype=torch.long, device=dev)
                logits, _ = prefill_lm(self.params, prompt[None], _slot_view(ctx.cache, slot),
                                       self.mc)
                t0 = int(self._to_host(sample_token(logits, self._gen, self.sc))[0])
                if not sched.admit_request(slot, req, t0):  # done on its first token
                    alloc.free(seq)
                    ctx.cache = self._set_tbl_row(ctx.cache, slot, [])
                    continue
                ctx.seq_of[slot] = seq
                tok[slot] = t0
                pos[slot] = len(toks)
                return True
            return False

        def refill():
            for s in range(b):
                if not sched.slots[s].live and sched.head() is not None:
                    if not assign(s):
                        break
            if not self.sc.preemption:
                return
            # a higher-priority arrival may evict a lower-priority victim
            while (req := sched.head()) is not None and sched.free_slot() is None:
                v = sched.victim_slot(below=req.priority)
                if v is None:
                    return
                self._pool_preempt(sched, alloc, ctx, v)
                if not assign(v):
                    return

        try:
            refill()
            self.peak_active = sched.note_peak()
            while sched.has_active() or sched.queue:
                for s in sched.expire_overdue():
                    self._pool_retire(sched, alloc, ctx, s)
                if not sched.has_active():
                    if not self._await_backoff(sched):
                        break
                    refill()
                    self.peak_active = sched.note_peak()
                    continue
                self._grow_live(sched, alloc, ctx, chunk_n)
                chunk = []
                for _ in range(chunk_n):  # dead slots step in lockstep on page 0
                    logits, ctx.cache = self.api.decode_step(self.params, ctx.cache, tok, pos,
                                                             self.mc)
                    tok = sample_token(logits, self._gen, self.sc)
                    pos = pos + 1
                    chunk.append(tok)
                toks_np = self._to_host(torch.stack(chunk))  # one sync per chunk
                for s in sched.absorb_chunk(toks_np):
                    self._pool_retire(sched, alloc, ctx, s)
                refill()
                self.peak_active = sched.note_peak()
        except Exception:
            self._drop_paged_state()
            raise
        self._finish_serve(sched)
        return sched.results_list()

    # ---- mixed varlen loop ----
    def _mixed_blocks(self, budget: int, pchunk: int) -> int:
        """The packer's block_q (the reference's heuristic): decode rows
        share packs when max_batch > 1, so segments are ~1 row; a lone slot
        packs one prefill chunk per step."""
        hd = self.mc.head_dim_
        return choose_varlen_blocks(
            bucket_pow2(budget, lo=8), hd, hd, group=self.mc.n_heads // self.mc.n_kv_heads,
            page=self._page_layout.page_size,
            segment_hint=1 if self.sc.max_batch > 1 else pchunk,
        ).block_q

    def _serve_mixed(self, requests, max_new_tokens: int, priorities=None,
                     deadlines=None) -> List[np.ndarray]:
        """Chunked-prefill continuous batching: one packed varlen step per
        iteration carries every decoding slot's pending token and the next
        prefill chunks of admitted prompts; iterations with no prefill in
        flight run `decode_chunk` decode steps instead (the sequential
        loops' fast path). Admission is by free pages, as `_serve_paged`."""
        b = self.sc.max_batch
        dev = self.device
        sched = self._make_sched(requests, max_new_tokens, priorities, deadlines)
        alloc, cache0 = self._paged_state()
        ctx = _PoolCtx(cache0)
        budget = self.sc.token_budget or (b + self.sc.prefill_chunk)
        pchunk = max(1, min(self.sc.prefill_chunk, budget))
        chunk_n = max(1, min(self.sc.decode_chunk, max_new_tokens))
        block_q = self._mixed_blocks(budget, pchunk)

        def try_admit():
            while (req := sched.head()) is not None:
                slot = sched.free_slot()
                if slot is None:
                    if self.sc.preemption and (
                            v := sched.victim_slot(below=req.priority)) is not None:
                        self._pool_preempt(sched, alloc, ctx, v)
                        slot = v
                    else:
                        return
                seq = self._admit_to_pool(sched, alloc, ctx, req, max_new_tokens, chunk_n)
                if seq is None:
                    return
                ctx.cache = self._set_tbl_row(ctx.cache, slot, alloc.table(seq))
                sched.admit_request_prefilling(slot, req, fed0=0)
                ctx.seq_of[slot] = seq

        def plan_grown() -> StepPlan:
            """Plan a packed step and materialize its pages; a victim
            preemption invalidates the plan (a dead slot's segment must not
            run), so re-plan until a growth pass is stable."""
            while True:
                plan = sched.plan_step(budget, pchunk)
                r0 = sched.rollbacks
                for seg in plan.segments:
                    end = min(seg.start + len(seg.tokens), self.sc.max_len)
                    if end > alloc.seq_len(ctx.seq_of[seg.slot]):
                        self._pool_grow(sched, alloc, ctx, seg.slot, end)
                    if sched.rollbacks != r0:
                        break
                if sched.rollbacks == r0:
                    return plan

        def dispatch(plan: StepPlan) -> np.ndarray:
            arrays = pack_plan(plan, block_q, b)
            tokens, seq_ids, positions, kv_len, last_rows = (
                torch.as_tensor(a, device=dev) for a in arrays)
            logits, ctx.cache = forward_packed(self.params, tokens, seq_ids, positions, kv_len,
                                               ctx.cache, self.mc, last_rows, block_q=block_q)
            return self._to_host(sample_token(logits, self._gen, self.sc))  # one sync per step

        def decode_chunk_phase() -> np.ndarray:
            """No prefill in flight: `chunk_n` decode steps, tok / pos rebuilt
            from the scheduler's host state; dead slots' zeroed table rows
            send their lockstep writes to the garbage page."""
            self._grow_live(sched, alloc, ctx, chunk_n)
            tok = torch.as_tensor([sl.pending for sl in sched.slots], dtype=torch.long, device=dev)
            pos = torch.as_tensor([sl.kv for sl in sched.slots], dtype=torch.long, device=dev)
            chunk = []
            for _ in range(chunk_n):
                logits, ctx.cache = self.api.decode_step(self.params, ctx.cache, tok, pos, self.mc)
                tok = sample_token(logits, self._gen, self.sc)
                pos = pos + 1
                chunk.append(tok)
            return self._to_host(torch.stack(chunk))  # one sync per chunk

        try:
            try_admit()
            self.peak_active = sched.note_peak()
            while sched.has_active() or sched.queue:
                for s in sched.expire_overdue():
                    self._pool_retire(sched, alloc, ctx, s)
                if not sched.has_active():
                    if not self._await_backoff(sched):
                        break
                    try_admit()
                    self.peak_active = sched.note_peak()
                    continue
                if not any(sl.prefilling for sl in sched.slots):
                    finished = sched.absorb_chunk(decode_chunk_phase())
                else:
                    plan = plan_grown()
                    finished = sched.commit(plan, dispatch(plan)) if plan.segments else []
                for s in finished:
                    self._pool_retire(sched, alloc, ctx, s)
                try_admit()
                self.peak_active = sched.note_peak()
        except Exception:
            self._drop_paged_state()
            raise
        self._finish_serve(sched)
        return sched.results_list()
