"""Batched serving engine — the port of `repro/serve/engine.py`:
`ServeConfig`, `sample_token`, `Engine.generate`, and `Engine.serve` on the
reference's three loops:

  contiguous (default) — each slot owns a fixed max_len-wide cache region;
    prefill is one decode step per prompt position (K2), as the
    reference's `prefill_lm`.
  paged (kv_layout="paged") — KV lives in a global page pool with
    per-sequence block tables (`repro_torch.runtime.kvcache`, copied from
    the reference); admission is by free pages, decode and prefill run K3.
  mixed (step_mode="mixed") — chunked-prefill continuous batching over the
    paged pool: every step packs each decoding slot's pending token with
    the next `prefill_chunk`-token pieces of admitted prompts into one flat
    batch and runs ONE `forward_packed` step (K4); steps with no prefill in
    flight take the decode fast path, `decode_chunk` decode steps (K3).

As the reference's engine, a stack with no global-attention layer to page
(recurrentgemma's rings and RG-LRU) serves on the contiguous loop whatever
the layout asked, and a stack with ring or recurrent layers (llama4's
chunked layers) takes no packed step: `step_mode="mixed"` falls back to
the sequential loop of its `kv_layout`. In a paged hybrid tree only the
global layers take pages; ring and recurrent state stay per slot, zeroed
when a request is admitted. The prefix cache and speculation need every
mixer to read the paged cache alone, as the reference's.

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
frees. The allocator, its radix prefix cache and the device page pool live
on the engine across serve() calls. With the prefix cache on (the default,
as the reference's), an admission aliases the cached full pages of its
prompt and prefills only the tail: the paged loop from `start_pos`, the
mixed loop from `fed0`; retirement and preemption donate a slot's clean
token stream's pages to the cache, and a live prompt is indexed once its
prefill completes.

Device work runs on the engine's device (the card by default) as steps
over static buffers (`repro_torch.serve.graphs`): the reference's jitted
programs become one graph each — `decode_chunk` decode steps with their
sampling (`_chunk_fn`; `generate` replays the one-step graph), one prompt
position of a slot's prefill (`_prefill`, replayed per position from
`start_pos`) and the sampling of its last position, and the packed step
per power-of-two pack length (`_mixed_fn`). A CUDA engine captures each
step on first use and replays it after (`graphs=None`, the default);
`graphs=False` runs the same steps eagerly (the oracle), and a CPU engine
always does. The caches, the buffers and the graphs live on the engine
and are reused across serve() and generate() calls. PyTorch has no
compile step to bucket for, so the port prefills exactly the real prompt
length (the reference pads to a power of two and masks the padding with
`lengths=`, which gives the same result); packed steps keep the
reference's power-of-two pack lengths, so both packers yield the same
layout.

A quantized pool (`kv_dtype` "int8" or "fp8") stores pages at one byte an
element with per-(page, kv head) f32 scales, written by the slot-0 rule
(`models/transformer.py` `_write_pool`) and read by K3 / K4. Speculative
decoding (`spec_tokens` with `Engine(draft=...)`) replaces the paged loop's
decode chunks and the mixed loop's steps with rounds: the draft proposes K
tokens per decoding slot (`serve/speculative.py`), one packed verify step
(`_verify`, K4) scores every row, the longest accepted prefix commits and
the rejected rows' pages roll back through the allocator.

Host syncs: `generate` keeps every token on the device and copies them to
the host once (`host_syncs` counts each device→host copy); the sequential
loops sync once per prefill and once per `decode_chunk` decode steps; the
mixed loop once per packed step or decode chunk; a speculative round once.

Sharded serving, as the reference's: `Engine(..., sharding_ctx=ctx)` places
the parameters by `param_specs` and the contiguous caches by
`cache_specs_tree`, and runs every step under the context (`_scope`), so a
cache the kv_cache rule splits by sequence (a batch the batch axes do not
divide) is read through the cross-rank FLASH-D merge
(`distributed.context.cp_decode`). `generate` and the contiguous
sequential loop run so, eagerly; the paged and mixed loops, captured
graphs, fault injection and speculation on a context raise.

Fault tolerance, as the reference's: every request ends DONE, FAILED
(retry budget `max_retries` spent) or EXPIRED (deadline). A seeded
`FaultInjector` (`fault_rate` / `fault_seed`, or `Engine(fault_injector=)`)
is checked at the reference's four sites in the reference's order:
`page_alloc` before an admission or a growth, `kernel_dispatch` before a
step, `device_step` after it, `host_sync` at its sync (`_sync`). A fault in
one request's work (an admission, a prefill, a growth) re-queues that
request alone; a step-wide fault discards the step and retries it, and
after `max_retries` faulted steps in a row the scheduler's victim is
charged a retry. Commit-after-sync: the host state (scheduler, allocator,
radix tree) advances only after a step's sync, and the device state a step
advances in place beyond what its re-run rewrites — the sequential loops'
decode state `tok` / `pos`, ring slots and RG-LRU state, and on an MoE
stack every per-batch leaf and page 0 of the pool, which dead slots feed
to the router — is saved by the step itself and put back after a faulted
one (`_Bank.save` / `undo`; the mixed loop stages its decode state from
the scheduler, `_restage`); the global K/V rows a faulted step wrote
sit at positions at or past each slot's committed length, which the retry
rewrites before any row reads them (a byte pool's slot-0 scale included)
and which no donation covers (only the full pages of the committed stream
reach the radix tree). A crash (any other exception) folds the live slots
back into the queue and keeps the pool, the tree and the captured graphs
warm; `snapshot()` / `restore()` / `resume()` carry the unfinished
requests and the tree's token chains through `runtime/checkpoint.py` in
the reference's format, and `restore()` recomputes the chains' KV. After
`downgrade_after` consecutive kernel-site faults the engine switches to
the plain attention route (`kernels.ops.plain_impl`) and drops every
graph it captured; only an `InjectedFault` counts, a real error raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Sequence, Set, Union

import numpy as np
import torch

from repro_torch.devices import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.ops import plain_impl
from repro_torch.kernels.tuning import (
    bucket_pow2,
    choose_cache_policy,
    choose_page_layout,
    choose_varlen_blocks,
    padded_rows,
)
from repro_torch.models import ModelConfig, get_model
from repro_torch.models.transformer import (
    POOL_LEAVES,
    cache_leaves,
    decode_hidden_lm,
    forward_packed,
    logits_lm,
    packed_mixers_ok,
    paged_mixers,
    rows_interact,
    undo_leaves,
)
from repro_torch.runtime import quant
from repro_torch.runtime.kvcache import CachePolicy, PagedKVAllocator, PageError, pages_for
from repro_torch.runtime.resilience import FaultInjector, InjectedFault, StragglerMonitor
from repro_torch.serve.graphs import StepGraphs
from repro_torch.serve.scheduler import Request, Scheduler, StepPlan

__all__ = ["ServeConfig", "Engine", "sample_token", "pack_plan", "pack_verify"]


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
    # quantized page pool: "" keeps the compute dtype; a name from
    # `runtime.quant.available()` ("int8", "fp8") stores pages in that format
    # with per-(page, kv head) f32 scale leaves, dequantized in K3 / K4
    kv_dtype: str = ""
    # prefix reuse: `prefix_sharing` is the soundness gate (global-attention
    # stacks), `prefix_cache` the radix prefix cache across requests
    prefix_sharing: bool = True
    prefix_cache: bool = True
    cache_min_free_pages: int = -1  # eviction watermark; <0 → choose_cache_policy
    cache_max_pages: int = -1  # retained-page cap; <0 → choose_cache_policy
    preemption: bool = True  # optimistic admission + victim preemption
    # ---- mixed varlen step ----
    step_mode: str = "sequential"  # "mixed": chunked-prefill packed steps
    token_budget: int = 0  # packed tokens per mixed step; 0 → max_batch + prefill_chunk
    prefill_chunk: int = 16  # max prompt tokens one sequence feeds per step
    # speculative decoding: K draft tokens verified per round through one
    # packed step; 0 disables. Needs Engine(draft=...), greedy sampling and
    # a paged, packed-capable stack
    spec_tokens: int = 0
    # ---- fault tolerance ----
    max_retries: int = 3  # per-request fault-retry budget (then FAILED)
    retry_backoff_s: float = 0.0  # base of the exponential requeue backoff
    deadline_s: float = 0.0  # default per-request deadline; 0 → none
    fault_rate: float = 0.0  # chaos: per-site injected-fault probability
    fault_seed: int = 0  # chaos: the injector's stream seed
    downgrade_after: int = 3  # consecutive kernel-site faults before the plain route


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
    pools (no batch axis) are shared whole. A DTensor leaf must not split
    its batch over more than one rank: a slice of a split dim would be a
    copy, and the slot's writes would be lost."""
    for name, leaf in cache_leaves(cache):
        if name not in POOL_LEAVES and shd.is_dtensor(leaf) and any(
                p.is_shard(1) and leaf.device_mesh.size(i) > 1
                for i, p in enumerate(leaf.placements)):
            raise NotImplementedError(
                "a serve slot of a batch-sharded cache: the contiguous serve loop under a "
                "sharding context needs a max_batch the batch axes do not divide (the kv_cache "
                "rule then splits the sequence); ROADMAP A13 d")
    return {k: (_slot_view(v, slot) if isinstance(v, dict)
                else v if k in POOL_LEAVES else v[:, slot:slot + 1])
            for k, v in cache.items()}


def _put_back(region, saved) -> None:
    """Copy `saved` (clones of `region`'s tensors, or None) back in place."""
    for leaf, old in zip(region, saved or ()):
        leaf.copy_(old)


def _pack(plan: StepPlan, block_q: int, max_batch: int):
    """A plan's segments → (tokens, seq_ids, positions, kv_len, offsets).

    Each segment starts on a `block_q` boundary (so every q block of the
    pack belongs to one sequence, K4's contract) and the pack is padded to
    a power of two ≥ block_q; padding rows carry seq_id −1, position −1.
    kv_len [max_batch] is each slot's KV length after the pack; offsets the
    segments' first rows."""
    off = 0
    spans = []
    for seg in plan.segments:
        spans.append(off)
        off += padded_rows(len(seg.tokens), block_q)
    total = bucket_pow2(max(off, 1), lo=block_q)
    tokens = np.zeros((total,), np.int32)
    seq_ids = np.full((total,), -1, np.int32)
    positions = np.full((total,), -1, np.int32)
    kv_len = np.zeros((max_batch,), np.int32)
    for seg, o in zip(plan.segments, spans):
        n = len(seg.tokens)
        tokens[o:o + n] = seg.tokens
        seq_ids[o:o + n] = seg.slot
        positions[o:o + n] = np.arange(seg.start, seg.start + n)
        kv_len[seg.slot] = seg.start + n
    return tokens, seq_ids, positions, kv_len, spans


def pack_plan(plan: StepPlan, block_q: int, max_batch: int):
    """The mixed step's packer: a plan's segments → flat numpy arrays
    (tokens, seq_ids, positions, kv_len, last_rows), laid out by `_pack`;
    last_rows [max_batch] is the pack row sampled for an emitting segment,
    −1 elsewhere."""
    tokens, seq_ids, positions, kv_len, spans = _pack(plan, block_q, max_batch)
    last_rows = np.full((max_batch,), -1, np.int32)
    for seg, o in zip(plan.segments, spans):
        if seg.emits:
            last_rows[seg.slot] = o + len(seg.tokens) - 1
    return tokens, seq_ids, positions, kv_len, last_rows


def pack_verify(plan: StepPlan, block_q: int, max_batch: int, k: int, prefilling):
    """The speculative round's packer (the reference's `_spec_round` pack):
    `_pack`'s (tokens, seq_ids, positions, kv_len), then rows [max_batch,
    k + 1] — each verify segment's pack rows (row 0 the pending token, rows
    1… its drafts; a prefill-final segment of a slot in `prefilling` only
    its last row; −1 pads) — and dmat [max_batch, k], the drafts the plan
    carries (−1 = none; placeholders when the draft lives on the device)."""
    tokens, seq_ids, positions, kv_len, spans = _pack(plan, block_q, max_batch)
    rows = np.full((max_batch, k + 1), -1, np.int32)
    dmat = np.full((max_batch, k), -1, np.int32)
    for seg, o in zip(plan.segments, spans):
        n = len(seg.tokens)
        if not seg.emits:
            continue
        if seg.slot in prefilling:
            rows[seg.slot, 0] = o + n - 1
        else:
            rows[seg.slot, :n] = np.arange(o, o + n)
            dmat[seg.slot, :n - 1] = seg.tokens[1:]
    return tokens, seq_ids, positions, kv_len, rows, dmat


class _Bank:
    """One device cache and the static buffers of the steps that run on it:
    the decode state `tok` / `pos` [B] (rows of one [2, B] buffer, so the
    mixed loop stages both in one copy), named buffers created on first
    use, the graphs of its steps, and the undo pairs: each tensor a step
    overwrites in place beyond what its re-run rewrites (the decode state,
    and `transformer.undo_leaves` when `faults`: only an engine with a
    fault injector discards a step that ran), beside the copy the step
    saves of it first (`save`), which `undo` puts back after a faulted
    step — only when the step ran (`ran`: cleared before a step is
    attempted, set once it ran; a fault raised before the launch leaves
    nothing to undo)."""

    def __init__(self, cache: dict, rows: int, device: torch.device, cfg: ModelConfig,
                 faults: bool):
        self.cache = cache
        self.rows = rows
        self.state = torch.zeros((2, rows), dtype=torch.long, device=device)
        self.tok, self.pos = self.state[0], self.state[1]
        self.graphs: dict = {}
        self._device = device
        self._bufs: dict = {}
        leaves = undo_leaves(cache, cfg) if faults else []
        self._undo = [(t, torch.empty_like(t)) for t in (self.state, *leaves)]
        self.ran = False

    def save(self) -> None:
        """Copy the undo set aside (the first thing a step does)."""
        for live, saved in self._undo:
            saved.copy_(live)

    def undo(self) -> None:
        """Put back what the faulted step saved, if it ran."""
        if self.ran:
            for live, saved in self._undo:
                live.copy_(saved)
        self.ran = False

    def buf(self, name, shape, dtype: torch.dtype = torch.long) -> torch.Tensor:
        t = self._bufs.get(name)
        if t is None:
            t = self._bufs[name] = torch.zeros(shape, dtype=dtype, device=self._device)
        return t


class _PoolCtx:
    """Mutable per-serve() context of the paged loops: the device cache
    tree plus the slot → allocator-sequence map and which slots' prompts
    are already indexed in the radix tree."""

    __slots__ = ("cache", "seq_of", "inserted")

    def __init__(self, cache):
        self.cache = cache
        self.seq_of: dict = {}
        self.inserted: Set[int] = set()


class Engine:
    def __init__(self, params: dict, model_cfg: ModelConfig, serve_cfg: ServeConfig,
                 *, device=None, graphs: Optional[bool] = None, draft=None,
                 fault_injector: Optional[FaultInjector] = None, sharding_ctx=None):
        """`graphs`: replay the steps as captured CUDA graphs (None → on a
        CUDA engine, eager on the CPU; False → eager on the card too, the
        oracle; True on the CPU raises). `draft` (with `spec_tokens` > 0):
        a (params, ModelConfig) pair for a draft model, a `DraftModel`, or a
        host callable fn(rid, tokens, k) → proposals. `fault_injector`:
        the chaos source (default: one of `fault_rate` / `fault_seed` when
        the rate is above 0, else none). `sharding_ctx`: a
        `distributed.sharding.ShardingCtx` to serve on (`_scope`)."""
        if model_cfg.is_encdec:
            raise NotImplementedError(
                f"{model_cfg.name}: the engine serves decoder-only stacks. The reference's "
                f"engine has no encoder-decoder path (its prefill_lm reads params['blocks'], "
                f"which an encoder-decoder tree lacks), so the port adds none: decode with "
                f"models.encdec (encode, fill_cross_cache, decode_step_encdec)")
        if serve_cfg.kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {serve_cfg.kv_layout!r}")
        if serve_cfg.step_mode not in ("sequential", "mixed"):
            raise ValueError(f"unknown step_mode {serve_cfg.step_mode!r}")
        pooled = serve_cfg.kv_layout == "paged" or serve_cfg.step_mode == "mixed"
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"parameters are on {params['embed'].device}, the engine on {self.device}"
            )
        self.ctx = sharding_ctx
        if sharding_ctx is not None:
            self._check_sharded(serve_cfg, graphs, draft, fault_injector)
            graphs = False
        self.params = params
        self.mc = model_cfg
        self.sc = serve_cfg
        self.api = get_model(model_cfg)
        self._gen = torch.Generator(device=self.device).manual_seed(serve_cfg.seed)
        if sharding_ctx is not None:
            with self._scope():
                self.params = shd.distribute_tree(params, shd.param_specs(params))
        if graphs is None:
            graphs = self.device.type == "cuda"
        self._steps = StepGraphs(self.device, graphs=graphs, generator=self._gen)
        self.host_syncs = 0  # device→host copies issued by this engine
        self.peak_active = 0  # max concurrent sequences observed by `serve`
        self.ttft = {}  # rid → time-to-first-token of the last serve() call
        self._stats = {"prefix_lookups": 0, "prefix_hits": 0, "hit_tokens": 0,
                       "prompt_tokens": 0, "preemptions": 0, "failed": 0, "retried": 0,
                       "expired": 0, "downgrades": 0,
                       "spec_rounds": 0, "spec_drafted": 0, "spec_accepted": 0}
        self._sched: Optional[Scheduler] = None  # the last or current serve()'s
        # fault tolerance: the injector, the consecutive kernel-site faults
        # (downgrade) and faulted steps (victim charging), the step watchdog,
        # and a restored snapshot waiting for resume()
        if fault_injector is None and serve_cfg.fault_rate > 0:
            fault_injector = FaultInjector(serve_cfg.fault_rate, serve_cfg.fault_seed)
        self._injector = fault_injector
        self._kernel_faults = 0
        self._step_faults = 0
        self._step_no = 0
        self._watchdog = StragglerMonitor()  # its flagged steps are stats()["slow_steps"]
        self._resume_state: Optional[dict] = None
        # paged geometry (paged or mixed engines with a global-attention layer)
        self._page_layout = None
        if pooled and paged_mixers(model_cfg):
            self._page_layout = choose_page_layout(
                serve_cfg.max_len, model_cfg.head_dim_, model_cfg.head_dim_,
                group=model_cfg.n_heads // model_cfg.n_kv_heads,
                pool_tokens=serve_cfg.kv_pool_tokens or serve_cfg.max_batch * serve_cfg.max_len,
                page_size=serve_cfg.page_size or None,
                kv_itemsize=quant.kv_itemsize(serve_cfg.kv_dtype),
            )
        self._mixed_ok = (serve_cfg.step_mode == "mixed" and self._page_layout is not None
                          and packed_mixers_ok(model_cfg))
        self._rows_interact = rows_interact(model_cfg)  # MoE: dead slots feed the router
        # prefix reuse skips the shared positions' prefill steps, sound only
        # when every mixer reads the paged cache alone (global attention,
        # `attn_bidir` decoded as global too); the radix prefix cache
        # addresses pages by content on the same condition
        self._cache_on = (self._page_layout is not None and serve_cfg.prefix_sharing
                          and all(m in ("attn", "attn_nope", "attn_bidir")
                                  for m, _ in (*model_cfg.pattern, *model_cfg.remainder))
                          and serve_cfg.prefix_cache)
        # engine-lifetime state: the allocator (radix tree included) and the
        # page pool, the contiguous caches by batch size, and their steps
        self._alloc: Optional[PagedKVAllocator] = None
        self._paged: Optional[_Bank] = None
        self._contig: dict = {}
        self._seq_base = 0  # allocator sequence ids, unique across calls
        self._spec = None
        if serve_cfg.spec_tokens > 0:
            self._spec = self._spec_state(draft)

    def _check_sharded(self, sc: ServeConfig, graphs: Optional[bool], draft, injector) -> None:
        """What an engine on a sharding context serves: `generate` and the
        contiguous sequential loop, eagerly. The rest is refused, naming its
        ROADMAP row."""
        if sc.kv_layout == "paged" or sc.step_mode == "mixed":
            raise NotImplementedError("the paged and mixed loops on a sharding context are not "
                                      "ported (ROADMAP A13 d): use kv_layout='contiguous', "
                                      "step_mode='sequential'")
        if draft is not None or sc.spec_tokens > 0 or injector is not None or sc.fault_rate > 0:
            raise NotImplementedError("speculation and fault injection on a sharding context "
                                      "are not ported (ROADMAP A13 f)")
        if graphs:
            raise NotImplementedError("captured CUDA graphs of sharded steps (NCCL and DTensor "
                                      "dispatch inside a capture) are not ported (ROADMAP A13 "
                                      "e): pass graphs=None or False")
        if self.ctx.mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {self.ctx.mesh.device_type}, the engine on "
                             f"{self.device}")

    @contextlib.contextmanager
    def _scope(self):
        """The scope of every step: inference mode, or under a sharding
        context that context active with gradients off (a DTensor view
        cannot be taken in inference mode), so the rules engine and the
        context-parallel routes see it."""
        if self.ctx is None:
            with torch.inference_mode():
                yield
        else:
            with torch.no_grad(), shd.activate(self.ctx):
                yield

    @staticmethod
    def _whole(x: torch.Tensor) -> torch.Tensor:
        """A step's DTensor output (logits, hidden) whole on every rank."""
        return x.full_tensor() if shd.is_dtensor(x) else x

    def _spec_state(self, draft):
        """Validate speculative decoding as the reference does and build its
        state: greedy only, a paged or mixed engine on a packed-capable
        stack (the verify step is the packed step), and a draft."""
        from repro_torch.serve.speculative import DraftModel, SpecState  # lazy: no cycle

        sc = self.sc
        if draft is None:
            raise ValueError("spec_tokens > 0 needs Engine(draft=...): a (params, "
                             "ModelConfig) pair for a draft model or a host callable")
        if sc.temperature > 0:
            raise ValueError("speculative decoding is greedy-only: the accept rule compares "
                             "draft tokens against the target's argmax, so temperature must be 0")
        if self._page_layout is None or not packed_mixers_ok(self.mc) \
                or not (self._mixed_ok or sc.kv_layout == "paged"):
            raise ValueError("speculative decoding verifies drafts through the packed varlen "
                             "step over the paged pool — needs kv_layout='paged' or "
                             "step_mode='mixed' on a packed-capable stack")
        if isinstance(draft, tuple):
            dparams, dcfg = draft
            draft = DraftModel(dparams, dcfg, max_batch=sc.max_batch, max_len=sc.max_len,
                               device=self.device, graphs=self._steps.graphs)
        return SpecState(k=int(sc.spec_tokens), draft=draft)

    def _to_host(self, x: torch.Tensor) -> np.ndarray:
        """The engine's ONLY device→host copy (counted for tests)."""
        self.host_syncs += 1
        return x.cpu().numpy()

    # ---- fault injection and the downgrade (the reference's sites) ----
    def _inj(self, site: str, rid: Optional[int] = None) -> None:
        if self._injector is not None:
            self._injector.check(site, rid=rid)

    def _sync(self, x: torch.Tensor, rid: Optional[int] = None) -> np.ndarray:
        """A serve loop's device→host copy: the host_sync fault site."""
        self._inj("host_sync", rid)
        return self._to_host(x)

    def _step_done(self) -> None:
        """A step synced: the watchdog times it and the fault streaks end."""
        self._step_no += 1
        self._watchdog.end_step(self._step_no)
        self._clear_fault_streak()

    def _note_fault(self, exc: InjectedFault) -> None:
        """Count an injected fault; `downgrade_after` consecutive kernel-site
        faults switch a kernel route to its plain one."""
        if exc.site in ("kernel_dispatch", "device_step"):
            self._kernel_faults += 1
            if self._kernel_faults >= self.sc.downgrade_after:
                self._downgrade()

    def _clear_fault_streak(self) -> None:
        self._kernel_faults = 0
        self._step_faults = 0

    def _downgrade(self) -> None:
        """Switch attention to the plain route for the engine's life
        (`plain_impl`: flashd, flashd_gpu → flashd_plain; fa2, fa2_gpu →
        fa2_plain) and drop every captured graph — they hold the kernels'
        launches — so the next run of each step captures the plain one. A
        draft model's engine switches with it. Counted in
        `stats()["downgrades"]`, the route in `["attn_impl"]`."""
        from repro_torch.serve.speculative import DraftModel  # lazy: no cycle

        fb = plain_impl(self.mc.attn_impl)
        if fb == self.mc.attn_impl:
            return
        self._stats["downgrades"] += 1
        self.mc = dataclasses.replace(self.mc, attn_impl=fb)
        self.api = get_model(self.mc)
        for bank in (*self._contig.values(), self._paged):
            if bank is not None:
                bank.graphs.clear()
        if self._spec is not None and isinstance(self._spec.draft, DraftModel):
            self._spec.draft.runner._downgrade()
        self._kernel_faults = 0

    def _on_step_fault(self, sched: Scheduler, exc: InjectedFault, release) -> None:
        """A step-wide injected fault: the step is discarded and retried
        (its host state never advanced). After `max_retries` faulted steps
        in a row the scheduler's victim is charged one retry through
        `release`, which also gives its memory back, so a hostile schedule
        still makes progress."""
        self._note_fault(exc)
        self._step_faults += 1
        if self._step_faults > sched.max_retries:
            self._step_faults = 0
            v = sched.victim_slot()
            if v is not None:
                release(v)

    def _restage(self, bank: _Bank, sched: Scheduler) -> None:
        """Stage the decode state tok / pos from the scheduler's committed
        host state (each slot's pending token and KV length; dead slots 0):
        the mixed loop's chunk input, and the sequential loops' undo of a
        faulted chunk, which advanced them in place."""
        self._steps.put(bank.state, [[sl.pending for sl in sched.slots],
                                     [sl.kv for sl in sched.slots]])

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
            max_retries=self.sc.max_retries, retry_backoff_s=self.sc.retry_backoff_s,
        )
        self._sched = sched
        return sched

    def _finish_serve(self, sched: Scheduler) -> None:
        self.ttft = dict(sched.first_token_at)
        self._stats["preemptions"] += sched.preemptions
        self._stats["retried"] += sched.retried
        self._stats["failed"] += sched.failed
        self._stats["expired"] += sched.expired
        self._stats["spec_rounds"] += sched.spec_rounds
        self._stats["spec_drafted"] += sched.spec_drafted
        self._stats["spec_accepted"] += sched.spec_accepted

    def stats(self) -> dict:
        """Serving counters, cumulative over this engine's lifetime: prefix-
        cache hit rate (token-weighted), preemption / eviction / donation
        counts, pool occupancy; plus the last serve() call's per-request
        TTFT and statuses."""
        s = dict(self._stats)
        s["hit_rate"] = s["hit_tokens"] / max(s["prompt_tokens"], 1)
        s["prefix_cache_enabled"] = self._cache_on
        s["preemption_enabled"] = bool(self.sc.preemption)
        s["spec_enabled"] = self._spec is not None
        s["spec_rejected"] = s["spec_drafted"] - s["spec_accepted"]
        s["spec_acceptance_rate"] = s["spec_accepted"] / max(s["spec_drafted"], 1)
        # accepted drafts per verify round (each round also emits a bonus token)
        s["spec_mean_accepted"] = s["spec_accepted"] / max(s["spec_rounds"], 1)
        s["peak_active"] = self.peak_active
        s["ttft"] = dict(self.ttft)
        s["attn_impl"] = self.mc.attn_impl
        s["host_syncs"] = self.host_syncs
        s["slow_steps"] = len(self._watchdog.flagged)
        if self._injector is not None:
            s["injected_faults"] = dict(self._injector.fired)
            s["fault_checks"] = dict(self._injector.calls)
        if self._alloc is not None:
            s.update(evictions=self._alloc.evictions, donated_pages=self._alloc.donated_pages,
                     cached_pages=self._alloc.cached_pages,
                     pages_in_use=self._alloc.pages_in_use, free_pages=self._alloc.free_pages)
        if self._paged is not None:
            # the pool's device footprint (a quantized pool's scales included)
            seen = sum(x.numel() * x.element_size() for name, x in cache_leaves(self._paged.cache)
                       if name in POOL_LEAVES)
            pool_tokens = self._page_layout.n_pages * self._page_layout.page_size
            s["kv_pool_bytes"] = int(seen)
            s["kv_bytes_per_token"] = seen / max(pool_tokens, 1)
            s["kv_dtype"] = self.sc.kv_dtype or "native"
        if self._sched is not None:
            s["request_status"] = dict(self._sched.status)
        return s

    # ---- crash recovery: snapshot / restore / resume (the reference's format) ----
    def snapshot(self, ckpt_dir: str, *, step: int = 0) -> str:
        """Write the last serve() call's surviving state as a metadata-only
        checkpoint (`runtime/checkpoint.py`, no arrays): the unfinished
        requests (a live slot folds in as a preemption would: prompt and
        the tokens generated so far), the finished results and statuses,
        the radix tree's token chains and the pool geometry. No KV: it is
        a function of the token stream, which `restore()` recomputes.
        Valid after a crash (serve() folds live slots into the queue
        before it re-raises) or between serves."""
        from repro_torch.runtime import checkpoint as ckpt

        sched = self._sched
        if sched is None:
            raise RuntimeError("snapshot() before any serve()")
        now = sched.now()
        pending = [Request(rid=sl.rid, prompt=np.asarray(sl.orig_prompt), out=list(sl.out),
                           priority=sl.priority, deadline=sl.deadline, retries=sl.retries)
                   for sl in sched.slots if sl.live] + list(sched.queue)
        state = {
            "pending": sorted((
                {"rid": int(r.rid),
                 "prompt": np.asarray(r.prompt).astype(int).tolist(),
                 "out": [int(t) for t in r.out],
                 "priority": int(r.priority),
                 # deadlines and backoff gates persist as the seconds still
                 # remaining: a restored scheduler's clock starts at zero
                 "deadline": (max(0.0, float(r.deadline) - now)
                              if r.deadline is not None else None),
                 "not_before": max(0.0, float(r.not_before) - now),
                 "retries": int(r.retries)}
                for r in pending), key=lambda d: d["rid"]),
            "done": {str(i): np.asarray(r).astype(int).tolist()
                     for i, r in enumerate(sched.results) if r is not None},
            "status": {str(k): v for k, v in sched.status.items()},
            "max_new_tokens": int(sched.max_new_tokens),
            "seq_base": int(self._seq_base),
            "chains": (self._alloc.cached_chains()
                       if self._alloc is not None and self._cache_on else []),
            "pool": ({"page_size": self._page_layout.page_size,
                      "n_pages": self._page_layout.n_pages}
                     if self._page_layout is not None else None),
        }
        return ckpt.save(ckpt_dir, step, None, extra={"engine_serve": state})

    def restore(self, ckpt_dir: str, *, step: Optional[int] = None) -> dict:
        """Load a `snapshot()` (the port's or the reference's) into this
        engine, usually a fresh one: keep its pending requests for
        `resume()` and re-warm the radix prefix cache by replaying the
        token chains through prefill (`_rewarm`), on a pool of the same
        page size only. Returns the raw state dict."""
        from repro_torch.runtime import checkpoint as ckpt

        _, extra = ckpt.restore(ckpt_dir, None, step=step)
        state = extra["engine_serve"]
        self._seq_base = max(self._seq_base, int(state.get("seq_base", 0)))
        pool = state.get("pool")
        chains = state.get("chains") or []
        if (chains and self._cache_on and pool is not None
                and int(pool["page_size"]) == self._page_layout.page_size):
            self._rewarm(chains)
        self._resume_state = state
        return state

    def resume(self) -> dict:
        """Finish the restored snapshot's pending requests in one serve()
        (deadlines, backoff gates and retry budgets carried over) and return
        every result keyed by its original request id; finished requests
        come from the snapshot. Resumed requests recompute their streams, so
        the tokens are the uninterrupted run's."""
        state = self._resume_state
        if state is None:
            raise RuntimeError("resume() before restore()")
        self._resume_state = None
        done = {int(k): np.asarray(v, np.int32) for k, v in state["done"].items()}
        pending = state["pending"]
        if pending:
            reqs = [Request(rid=i, prompt=np.asarray(p["prompt"], np.int32), out=list(p["out"]),
                            priority=int(p["priority"]), deadline=p["deadline"],
                            retries=int(p["retries"]),
                            not_before=float(p.get("not_before", 0.0)))
                    for i, p in enumerate(pending)]
            outs = self.serve(reqs, int(state["max_new_tokens"]),
                              deadlines=[p["deadline"] for p in pending])
            for p, o in zip(pending, outs):
                done[int(p["rid"])] = o
        return done

    def _rewarm(self, chains) -> None:
        """Replay radix-tree token chains into the pool: a scratch sequence
        on slot 0's table row prefills each chain's full pages through the
        prefill graphs and donates them to the tree. Longest first, so
        shorter chains ride their cached prefixes; a chain that no longer
        fits is skipped (the cache is performance state, not correctness)."""
        with torch.inference_mode():
            alloc, bank = self._paged_state()
            page = self._page_layout.page_size
            cap = (self.sc.max_len // page) * page
            for chain in sorted(chains, key=len, reverse=True):
                toks = np.asarray(chain[:cap], np.int64)
                n = (len(toks) // page) * page
                if n < page:
                    continue
                toks = toks[:n]
                m = alloc.match_prefix(toks)
                if m.n_tokens >= n:
                    continue  # covered by a longer chain's replay
                cached = m if m.n_tokens > 0 else None
                if not alloc.can_admit(n, cached=cached):
                    continue
                seq = self._seq_base
                self._seq_base += 1
                alloc.admit(seq, prompt_len=n, reserve_tokens=n, cached=cached)
                start = cached.n_tokens if cached is not None else 0
                self._set_tbl_row(bank.cache, 0, alloc.table(seq))
                self._prefill(bank, 0, toks[None, start:], start)
                alloc.donate(seq, toks)
                self._set_tbl_row(bank.cache, 0, [])

    # ---- the steps, over static buffers (one graph each on the card) ----
    def _contiguous(self, b: int) -> _Bank:
        """The contiguous cache of batch size b, created on first use."""
        bank = self._contig.get(b)
        if bank is None:
            cache = self.api.init_cache(b, self.sc.max_len, self.mc, device=self.device)
            if self.ctx is not None:  # the kv_cache rule's placements, sequence split or not
                with self._scope():
                    cache = shd.distribute_tree(cache, shd.cache_specs_tree(cache))
            bank = self._contig[b] = _Bank(cache, b, self.device, self.mc,
                                           faults=self._injector is not None)
        return bank

    def _decode_chunk(self, bank: _Bank, n: int) -> torch.Tensor:
        """`n` decode steps with their sampling from bank.tok / bank.pos,
        which advance in place (the reference's `_chunk_fn`); dead slots
        step in lockstep. The undo set is saved first (`_Bank.save`).
        Returns the static [n, B] tokens buffer."""
        out = bank.buf(("chunk", n), (n, bank.rows))

        def chunk():
            bank.save()
            for i in range(n):
                logits, _ = self.api.decode_step(self.params, bank.cache, bank.tok, bank.pos,
                                                 self.mc)
                out[i].copy_(sample_token(self._whole(logits), self._gen, self.sc))
                bank.tok.copy_(out[i])
                bank.pos.add_(1)

        self._steps.run(bank.graphs, ("chunk", n), chunk)
        bank.ran = True
        return out

    def _prefill(self, bank: _Bank, slot: Optional[int], tokens: np.ndarray,
                 start: int) -> torch.Tensor:
        """Prefill `tokens` [rows, n] at positions start … start + n − 1 into
        `slot`'s view of the bank (rows 1), or into every row (slot None:
        `generate`), one step per position as the reference's
        `prefill_lm`; then sample the last position. Returns the sampled
        tokens' static buffer [rows] (bank.tok for slot None)."""
        rows, n = tokens.shape
        view = bank.cache if slot is None else _slot_view(bank.cache, slot)  # one graph a slot
        pre = bank.buf(("prompt", rows), (rows, self.sc.max_len + 2))  # tokens | pos | index
        h_last = bank.buf(("hidden", rows), (rows, 1, self.mc.d_model), self.mc.compute_dtype)
        out = bank.tok if slot is None else bank.buf("first", (1,))
        staged = np.zeros(pre.shape, np.int64)
        staged[:, :n] = tokens
        staged[:, -2] = start
        self._steps.put(pre, staged)

        def position():
            tok = pre.gather(1, pre[:, -1:])[:, 0]
            h_last.copy_(self._whole(decode_hidden_lm(self.params, view, tok, pre[:, -2], self.mc)))
            pre[:, -2:].add_(1)

        def first():
            out.copy_(sample_token(self._whole(logits_lm(self.params, h_last, self.mc)), self._gen,
                                   self.sc))

        for _ in range(n):
            self._steps.run(bank.graphs, ("prefill", slot), position)
        self._steps.run(bank.graphs, ("first", slot is None), first)
        return out

    # ---- single-prompt-batch generation (prefill + n decode steps) ----
    def generate(self, prompts: np.ndarray, max_new_tokens: int) -> np.ndarray:
        """prompts [B, S_prompt] int → generated tokens [B, max_new_tokens].

        The whole loop stays on the device and the tokens are copied to the
        host once; early-EOS masking (after a row samples eos_id, its later
        tokens are eos_id) is applied to that copy."""
        prompts = np.asarray(prompts)
        b, s = prompts.shape
        if s + max_new_tokens > self.sc.max_len:
            raise ValueError(f"prompt {s} + {max_new_tokens} exceeds max_len {self.sc.max_len}")
        if max_new_tokens == 0:
            return np.zeros((b, 0), np.int64)
        with self._scope():
            bank = self._contiguous(b)
            for _, leaf in cache_leaves(bank.cache):
                leaf.zero_()
            self._prefill(bank, None, prompts, 0)  # the first tokens land in bank.tok
            bank.pos.fill_(s)
            out = torch.empty((max_new_tokens, b), dtype=torch.long, device=self.device)
            out[0].copy_(bank.tok)
            for i in range(1, max_new_tokens):
                out[i].copy_(self._decode_chunk(bank, 1)[0])
            toks = self._to_host(out).T
        eos = self.sc.eos_id
        if eos >= 0:
            hit = toks == eos
            toks = np.where(np.cumsum(hit, axis=1) - hit > 0, eos, toks)
        return toks

    # ---- continuous batching over a request queue ----
    def serve(self, requests: Sequence[Union[np.ndarray, Request]], max_new_tokens: int,
              priorities: Optional[Sequence[int]] = None,
              deadlines: Optional[Sequence[Optional[float]]] = None) -> List[np.ndarray]:
        """Each request: a 1-D prompt array (or a `Request`). Returns the
        generated arrays in request order. `priorities` (higher = more
        urgent) steer admission and let a higher-priority arrival preempt a
        live slot; `deadlines` (seconds from enqueue) cancel overdue requests
        like EOS.

        Routing as the reference: `step_mode="mixed"` runs the mixed loop
        on a packed-capable stack (every mixer global attention), otherwise
        `kv_layout` picks the paged loop (a stack with a global-attention
        layer to page) or the contiguous sequential loop.
        All three give the same tokens under greedy sampling, with the
        prefix cache and preemption on or off."""
        with self._scope():
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
        sched = self._make_sched(requests, max_new_tokens, priorities, deadlines)
        bank = self._contiguous(b)
        bank.state.zero_()
        chunk_n = max(1, min(self.sc.decode_chunk, max_new_tokens))

        def assign(slot: int):
            """Prefill the next queued request straight into `slot`'s cache
            region (zeroed first, as the reference's fresh one-row cache).
            The prefill's sampled token is output token 0; a resumed request
            replays its pre-preemption tokens. Requests that complete at
            once are finalized and the next is taken. An injected fault
            re-queues the request in hand (or fails it) and takes the next:
            the live slots never see it. On an MoE stack the region's old
            rows are put back when the request does not take the slot (the
            reference writes its one-row cache into the slot only then):
            the dead slot's rows keep feeding the router."""
            region = [leaf for _, leaf in cache_leaves(_slot_view(bank.cache, slot))]
            while (req := sched.take_head()) is not None:
                toks = np.asarray(req.tokens)
                self._check_len(req.rid, len(req.prompt), max_new_tokens)
                saved = None
                try:
                    self._inj("kernel_dispatch", req.rid)
                    if self._rows_interact:  # the slot keeps its old rows unless admitted
                        saved = [leaf.clone() for leaf in region]
                    for leaf in region:
                        leaf.zero_()
                    first = self._prefill(bank, slot, toks[None], 0)
                    self._inj("device_step", req.rid)
                    t0 = int(self._sync(first, rid=req.rid)[0])
                except InjectedFault as e:
                    self._note_fault(e)
                    _put_back(region, saved)
                    sched.retry_request(req)
                    continue
                self._clear_fault_streak()
                if not sched.admit_request(slot, req, t0):
                    _put_back(region, saved)
                    continue
                bank.tok[slot] = t0
                bank.pos[slot] = len(toks)
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

        try:
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
                self._watchdog.start_step()
                bank.ran = False
                try:
                    self._inj("kernel_dispatch")
                    out = self._decode_chunk(bank, chunk_n)
                    self._inj("device_step")
                    toks_np = self._sync(out)  # one sync per chunk
                except InjectedFault as e:
                    # discard the step: undo its tok / pos (and the ring and
                    # recurrent state it advanced), then retry it
                    self._on_step_fault(sched, e, sched.fault_slot)
                    bank.undo()
                    continue
                self._step_done()
                for s in sched.absorb_chunk(toks_np):
                    sched.retire(s)
                    assign(s)  # overwrites the slot's cache / tok / pos
                preempt_for_priority()
                self.peak_active = sched.note_peak()
        except Exception:
            # crash recovery: fold the live slots back into the queue, so a
            # snapshot() sees every unfinished request
            for s, sl in enumerate(sched.slots):
                if sl.live:
                    sched.preempt(s)
            raise
        self._finish_serve(sched)
        return sched.results_list()

    # ---- paged-pool shared machinery ----
    def _paged_state(self):
        """Engine-lifetime paged state: the allocator (radix tree included)
        and the device page pool with its steps, created on first use and
        reused across serve() calls, so cached prefixes persist between
        request batches."""
        if self._alloc is None:
            lay = self._page_layout
            if self._cache_on:
                policy = choose_cache_policy(
                    lay.n_pages, lay.page_size,
                    min_free_pages=(None if self.sc.cache_min_free_pages < 0
                                    else self.sc.cache_min_free_pages),
                    max_cached_pages=(None if self.sc.cache_max_pages < 0
                                      else self.sc.cache_max_pages),
                )
            else:
                policy = CachePolicy(max_cached_pages=0)
            self._alloc = PagedKVAllocator(lay.n_pages, lay.page_size, cache_policy=policy)
            cache = self.api.init_cache(
                self.sc.max_batch, self.sc.max_len, self.mc, layout="paged",
                page_size=lay.page_size, n_pages=lay.n_pages, kv_dtype=self.sc.kv_dtype,
                device=self.device,
            )
            self._paged = _Bank(cache, self.sc.max_batch, self.device, self.mc,
                                faults=self._injector is not None)
        return self._alloc, self._paged

    def _recover_paged(self, sched: Scheduler, alloc, ctx: _PoolCtx) -> None:
        """Crash recovery (the reference's `_recover_paged`): roll every
        live slot back into the queue, its pages donated (their KV is
        committed state), free the sequences admitted but never bound to a
        slot, park every table row on the garbage page, and keep the
        allocator, the radix tree, the pool and the captured graphs: the
        next serve() — or a snapshot's successor — starts warm, and
        `alloc.check()` holds."""
        for s, sl in enumerate(sched.slots):
            if sl.live and s in ctx.seq_of:
                try:
                    self._pool_preempt(sched, alloc, ctx, s)
                except Exception:  # unstructured damage: the sweep below frees it
                    ctx.seq_of.pop(s, None)
            elif sl.live:
                sched.preempt(s)  # bound to the slot but not to the pool
        alloc.reset_live()
        for s in range(len(sched.slots)):
            self._set_tbl_row(ctx.cache, s, [])

    def _pool_fault_slot(self, sched: Scheduler, alloc, ctx: _PoolCtx, s: int) -> None:
        """Fault rollback of a live slot: `_pool_preempt`'s memory motion,
        but the requeue is charged to the request's retry budget (FAILED
        when it is spent)."""
        self._pool_release(sched, alloc, ctx, s)
        sched.fault_slot(s)

    def _set_tbl_row(self, cache, slot: int, table: List[int]) -> None:
        """Mirror one slot's allocator block table into every layer's `tbl`
        leaf, in place (zero-padded: unmapped logical pages point at the
        garbage page)."""
        row = np.zeros((self._page_layout.pages_per_seq,), np.int32)
        row[: len(table)] = table
        row_t = torch.as_tensor(row, device=self.device)
        for name, leaf in cache_leaves(cache):
            if name == "tbl":
                leaf[:, slot] = row_t

    def _copy_pages(self, cache, cows) -> None:
        """pages[:, dst] ← pages[:, src] for every owed copy-on-write copy."""
        if not cows:
            return
        srcs = torch.as_tensor([cw.src for cw in cows], device=self.device)
        dsts = torch.as_tensor([cw.dst for cw in cows], device=self.device)
        for name, leaf in cache_leaves(cache):
            if name in POOL_LEAVES:
                leaf[:, dsts] = leaf[:, srcs]

    def _pool_drop(self, alloc, seq: int, stream) -> None:
        """Retire allocator sequence `seq`: donate the full pages of its
        clean token stream to the radix tree (plain-free them with the cache
        off)."""
        if self._cache_on:
            alloc.donate(seq, stream)
        else:
            alloc.free(seq)

    def _pool_release(self, sched: Scheduler, alloc, ctx: _PoolCtx, s: int) -> None:
        """Give slot s's pages back (`_pool_drop`) and park its table row on
        the garbage page before the pages can be reassigned."""
        stream = sched.slots[s].cache_tokens()
        ctx.inserted.discard(s)
        self._pool_drop(alloc, ctx.seq_of.pop(s), stream)
        self._set_tbl_row(ctx.cache, s, [])

    def _pool_retire(self, sched: Scheduler, alloc, ctx: _PoolCtx, s: int) -> None:
        self._pool_release(sched, alloc, ctx, s)
        sched.retire(s)

    def _pool_preempt(self, sched: Scheduler, alloc, ctx: _PoolCtx, s: int) -> None:
        """Victim preemption: donate the slot's pages (a resumed match makes
        recompute-on-resume nearly free) and re-queue the request."""
        self._pool_release(sched, alloc, ctx, s)
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
            self._copy_pages(ctx.cache, cows)
            if cows or len(alloc.table(seq)) != before:
                self._set_tbl_row(ctx.cache, s, alloc.table(seq))
            return True

    def _grow_live(self, sched: Scheduler, alloc, ctx: _PoolCtx, chunk_n: int) -> None:
        """Pages for the next `chunk_n` decode writes of every live slot
        (clamped to max_len: writes past the table land on page 0). A
        growth fault rolls back that slot alone."""
        for s in range(self.sc.max_batch):
            sl = sched.slots[s]
            if not sl.live:
                continue
            try:
                self._inj("page_alloc", sl.rid)
                self._pool_grow(sched, alloc, ctx, s, min(sl.kv + chunk_n, self.sc.max_len))
            except InjectedFault as e:
                self._note_fault(e)
                self._pool_fault_slot(sched, alloc, ctx, s)

    def _pool_reserve(self, req: Request, max_new_tokens: int, chunk_n: int) -> int:
        """Admission reservation: just the prompt under preemption
        (optimistic growth) or the worst case without (prompt + remaining
        new tokens + slack, clamped to max_len). The slack is one chunk of
        lockstep writes, or with speculation a whole K + 1-row verify
        segment: rejected rows give their pages back (`alloc.rollback`), so
        one verify's overhang is enough."""
        n = len(req.tokens)
        if self.sc.preemption:
            return n
        slack = max(chunk_n, self._spec.k + 1 if self._spec else 0)
        return min(n + max_new_tokens - len(req.out) + slack, self.sc.max_len)

    def _pool_match(self, alloc, toks: np.ndarray):
        """Radix lookup for an admission, capped so ≥ 1 token prefills."""
        if not self._cache_on:
            return None
        return alloc.match_prefix(toks, max_tokens=len(toks) - 1)

    def _preempting_could_admit(self, sched: Scheduler, alloc, ctx: _PoolCtx, req: Request,
                                reserve: int, cached) -> bool:
        """Even rolling back EVERY strictly-lower-priority victim frees at
        most their table pages: if that cannot cover the arrival (less its
        cached pages), the head waits instead of discarding running work
        for nothing."""
        need = pages_for(reserve, alloc.page_size)
        if cached is not None:
            need -= len(cached.pages)
        bound = alloc.free_pages + alloc.evictable_pages
        for s, sl in enumerate(sched.slots):
            if sl.live and sl.priority < req.priority:
                bound += len(alloc.table(ctx.seq_of[s]))
        return need <= bound

    def _note_admission(self, toks, cached) -> None:
        self._stats["prefix_lookups"] += 1
        self._stats["prompt_tokens"] += len(toks)
        if cached is not None and cached.n_tokens > 0:
            self._stats["prefix_hits"] += 1
            self._stats["hit_tokens"] += cached.n_tokens

    def _admit_to_pool(self, sched: Scheduler, alloc, ctx: _PoolCtx, req: Request,
                       max_new_tokens: int, chunk_n: int):
        """Page admission of the head request, aliasing its cached prefix:
        evict / preempt lower-priority victims as needed. Returns (the new
        allocator sequence, the cached prefix or None) — the request taken
        off the queue — or None when the head must wait (then nothing
        changed), raising when nothing live could ever free enough. The
        page_alloc site sits between taking the head and admitting it: an
        `InjectedFault` leaves the request in the caller's hands, off the
        queue, with nothing allocated."""
        toks = req.tokens
        while True:
            self._check_len(req.rid, len(req.prompt), max_new_tokens)
            reserve = self._pool_reserve(req, max_new_tokens, chunk_n)
            cached = self._pool_match(alloc, toks)
            if alloc.can_admit(reserve, cached=cached):
                break
            if self.sc.preemption and self._preempting_could_admit(
                    sched, alloc, ctx, req, reserve, cached) and (
                    v := sched.victim_slot(below=req.priority)) is not None:
                self._pool_preempt(sched, alloc, ctx, v)
                continue  # re-match: the donation may extend the prefix
            if sched.has_active():
                return None  # live sequences will free pages
            raise PageError(f"request {req.rid} needs {pages_for(reserve, alloc.page_size)}"
                            f" pages but the pool holds {self._page_layout.n_pages - 1}")
        sched.take_head()
        self._inj("page_alloc", req.rid)
        seq = self._seq_base
        self._seq_base += 1
        alloc.admit(seq, prompt_len=len(toks), reserve_tokens=reserve, cached=cached)
        return seq, cached

    # ---- packed-step planning and speculative rounds ----
    def _plan_grown(self, sched: Scheduler, alloc, ctx: _PoolCtx, budget: int, pchunk: int,
                    drafts=None) -> StepPlan:
        """Plan a packed step and materialize its pages; any slot rollback —
        a victim preemption, a growth fault's requeue, a spent retry budget
        — invalidates the plan (a dead slot's segment must not run), so
        re-plan until a growth pass is stable. `drafts` adds speculative
        draft rows (plan_step funds them from leftover budget only)."""
        while True:
            plan = sched.plan_step(budget, pchunk, drafts=drafts)
            r0 = sched.rollbacks
            for seg in plan.segments:
                end = min(seg.start + len(seg.tokens), self.sc.max_len)
                try:
                    if end > alloc.seq_len(ctx.seq_of[seg.slot]):
                        self._inj("page_alloc", sched.slots[seg.slot].rid)
                        self._pool_grow(sched, alloc, ctx, seg.slot, end)
                except InjectedFault as e:
                    self._note_fault(e)
                    self._pool_fault_slot(sched, alloc, ctx, seg.slot)
                if sched.rollbacks != r0:
                    break
            if sched.rollbacks == r0:
                return plan

    def _verify(self, bank: _Bank, arrays, drafts: Optional[torch.Tensor],
                block_q: int) -> torch.Tensor:
        """ONE speculative verify step (the reference's `_verify_fn`), a
        graph per pack length: the packer's arrays (`pack_verify`) enter one
        static buffer; the drafts are clamped into the vocab (an
        out-of-range id would embed as garbage) and scattered into the
        pack's placeholder token rows — masked entries go to a dump row past
        the pack, never wrapping — with device proposals (`drafts` [B, K], a
        DraftModel's static buffer) taken where the plan funded a row; then
        the packed forward with logits at every verify row, argmax, and the
        accepted count, the length of the leading run of rows whose argmax
        equals the next draft (cumprod). Returns the static [B, R + 1]
        buffer: the target's token at every row, the count last."""
        tokens, seq_ids, positions, kv_len, rows, dmat = arrays
        t, b = len(tokens), self.sc.max_batch
        r = rows.shape[1]
        k = r - 1
        pack = bank.buf(("verify", t, r), (t + 1 + 2 * t + b + b * r + b * k,))
        self._steps.put(pack, np.concatenate([tokens, [0], seq_ids, positions, kv_len,
                                              rows.ravel(), dmat.ravel()]))
        out = bank.buf(("verified", r), (b, r + 1))

        def step():
            bank.save()
            fed = pack[:t + 1]  # the pack's tokens, then the dump row t
            o = t + 1
            sid, pos = pack[o:o + t], pack[o + t:o + 2 * t]
            o += 2 * t
            kvl = pack[o:o + b]
            rws = pack[o + b:o + b + b * r].view(b, r)
            dm = pack[o + b + b * r:].view(b, k)
            dt = dm if drafts is None else torch.where(dm >= 0, drafts, -1)
            dt = torch.clamp(dt, max=self.mc.vocab_size - 1)  # negatives stay −1: no draft
            ok = (rws[:, 1:] >= 0) & (dt >= 0)
            fed.index_put_((torch.where(ok, rws[:, 1:], t).reshape(-1),),
                           torch.where(ok, dt, 0).reshape(-1))
            logits, _ = forward_packed(self.params, fed[:t], sid, pos, kvl, bank.cache,
                                       self.mc, rws, block_q=block_q)  # [B, R, Vpad]
            g = torch.argmax(logits, dim=-1)
            match = (g[:, :-1] == dt) & (dt >= 0)
            out[:, :r].copy_(g)
            out[:, r].copy_(torch.cumprod(match.long(), dim=1).sum(dim=1))

        self._steps.run(bank.graphs, ("verify", t, r, block_q, drafts is not None), step)
        bank.ran = True
        return out

    def _spec_round(self, sched: Scheduler, alloc, ctx: _PoolCtx, bank: _Bank, *,
                    budget: int, pchunk: int, block_q: int) -> List[int]:
        """One speculative round (the reference's `_spec_round`): propose K
        tokens per decoding slot, verify them all (with any prefill chunks
        in flight) in ONE packed step and ONE host sync, commit each chain's
        longest accepted prefix, and roll the allocator back past every
        rejected row — those pages are freed, never donated, so the radix
        tree only ever holds committed KV (stale rows inside the boundary
        page sit at positions ≥ kv_len, masked, and are overwritten before
        any row reads them)."""
        from repro_torch.serve.speculative import DraftModel  # lazy: no cycle

        spec = self._spec
        k = spec.k
        # 1. per-slot draft quota, clamped by max_new_tokens, max_len and deadlines
        quota = {s: sched.draft_quota(s, k, max_len=self.sc.max_len, per_row_s=spec.row_ewma)
                 for s, sl in enumerate(sched.slots) if sl.live and not sl.prefilling}
        # 2. propose
        dev_drafts = None
        drafts = {}
        if isinstance(spec.draft, DraftModel):
            spec.draft.sync(sched)
            dev_drafts = spec.draft.propose(sched, k)  # [B, K], on the device
            drafts = {s: np.zeros((q,), np.int32) for s, q in quota.items() if q > 0}
        else:
            for s, q in quota.items():
                if q <= 0:
                    continue
                sl = sched.slots[s]
                stream = np.concatenate([np.asarray(sl.prompt, np.int64),
                                         np.asarray(sl.out[sl.resumed:], np.int64)])
                prop = np.asarray(spec.draft(sl.rid, stream, q), np.int32)
                if len(prop):
                    drafts[s] = prop[:q]
        # 3. plan and grow (re-plan on any slot rollback)
        plan = self._plan_grown(sched, alloc, ctx, budget, pchunk, drafts=drafts)
        if not plan.segments:
            return []
        # 4. one verify step, one sync; a fault here discards the round
        #    before anything below commits it (the draft's state included)
        t0 = time.monotonic()
        prefilling = {s for s, sl in enumerate(sched.slots) if sl.live and sl.prefilling}
        arrays = pack_verify(plan, block_q, self.sc.max_batch, k, prefilling)
        self._inj("kernel_dispatch")
        res = self._verify(bank, arrays, dev_drafts, block_q)
        self._inj("device_step")
        out = self._sync(res)
        # 5. commit the accepted prefixes, then roll back past rejected rows
        finished = sched.commit(plan, out[:, :k + 1], n_acc=out[:, k + 1])
        if isinstance(spec.draft, DraftModel):
            spec.draft.committed(sched)
        for seg in plan.segments:
            sl = sched.slots[seg.slot]
            if not sl.live or seg.slot not in ctx.seq_of:
                continue
            seq = ctx.seq_of[seg.slot]
            if alloc.seq_len(seq) > sl.kv:
                alloc.rollback(seq, sl.kv)
        per_row = (time.monotonic() - t0) / max(plan.n_tokens, 1)
        spec.row_ewma = per_row if spec.row_ewma is None else 0.7 * spec.row_ewma + 0.3 * per_row
        return finished

    # ---- paged sequential loop ----
    def _serve_paged(self, requests, max_new_tokens: int, priorities=None,
                     deadlines=None) -> List[np.ndarray]:
        """Sequential continuous batching over the page pool: admission by
        free pages; a prompt's cached full pages are aliased into its block
        table and only the tail is prefilled (`start_pos`); before every
        chunk the allocator materializes pages for the chunk's writes
        (preempting under pressure) and the tables are mirrored to the
        device; finished slots donate their pages and park their table row
        on the garbage page, so lockstep writes of dead slots stay
        harmless."""
        b = self.sc.max_batch
        sched = self._make_sched(requests, max_new_tokens, priorities, deadlines)
        alloc, bank = self._paged_state()
        ctx = _PoolCtx(bank.cache)
        bank.state.zero_()
        chunk_n = max(1, min(self.sc.decode_chunk, max_new_tokens))

        def fault_slot(v: int) -> None:
            self._pool_fault_slot(sched, alloc, ctx, v)

        spec_budget = spec_block_q = 0
        if self._spec is not None:  # a round verifies up to K + 1 rows a slot
            spec_budget = b * (self._spec.k + 1)
            spec_block_q = self._varlen_block_q(spec_budget, self._spec.k + 1)

        def assign(slot: int) -> bool:
            """Admit the head request into `slot` if the pool can cover it
            and prefill its uncached tail there; False (queue intact) when
            it must wait. An injected fault re-queues the request in hand;
            a faulted prefill's pages are freed, never donated (they may
            hold rows of a step that did not commit)."""
            while (req := sched.head()) is not None:
                try:
                    got = self._admit_to_pool(sched, alloc, ctx, req, max_new_tokens, chunk_n)
                except InjectedFault as e:
                    self._note_fault(e)
                    sched.retry_request(req)
                    continue
                if got is None:
                    return False
                seq, cached = got
                toks = np.asarray(req.tokens)
                start = cached.n_tokens if cached is not None else 0
                self._set_tbl_row(ctx.cache, slot, alloc.table(seq))
                try:
                    self._inj("kernel_dispatch", req.rid)
                    for name, leaf in cache_leaves(_slot_view(bank.cache, slot)):
                        if name not in POOL_LEAVES and name != "tbl":
                            leaf.zero_()  # ring and recurrent state start empty
                    first = self._prefill(bank, slot, toks[None, start:], start)
                    self._inj("device_step", req.rid)
                    t0 = int(self._sync(first, rid=req.rid)[0])
                except InjectedFault as e:
                    self._note_fault(e)
                    alloc.free(seq)
                    self._set_tbl_row(ctx.cache, slot, [])
                    sched.retry_request(req)
                    continue
                self._clear_fault_streak()
                self._note_admission(toks, cached)
                if not sched.admit_request(slot, req, t0):
                    # done on its first token: its pages hold the whole prompt's KV
                    self._pool_drop(alloc, seq, toks)
                    self._set_tbl_row(ctx.cache, slot, [])
                    continue
                ctx.seq_of[slot] = seq
                if self._cache_on:  # index the live prompt (its KV is valid now)
                    alloc.insert(seq, toks)
                    ctx.inserted.add(slot)
                bank.tok[slot] = t0
                bank.pos[slot] = len(toks)
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
                if self._spec is not None:
                    # a speculative round replaces the decode chunk; pages
                    # grow per verify segment inside the round
                    self._watchdog.start_step()
                    bank.ran = False
                    try:
                        finished = self._spec_round(sched, alloc, ctx, bank, budget=spec_budget,
                                                    pchunk=1, block_q=spec_block_q)
                    except InjectedFault as e:
                        self._on_step_fault(sched, e, fault_slot)
                        bank.undo()
                        continue
                    self._step_done()
                    for s in finished:
                        self._pool_retire(sched, alloc, ctx, s)
                    refill()
                    self.peak_active = sched.note_peak()
                    continue
                self._grow_live(sched, alloc, ctx, chunk_n)
                if not sched.has_active():
                    continue
                # dead slots step in lockstep on page 0; one sync per chunk
                self._watchdog.start_step()
                bank.ran = False
                try:
                    self._inj("kernel_dispatch")
                    out = self._decode_chunk(bank, chunk_n)
                    self._inj("device_step")
                    toks_np = self._sync(out)
                except InjectedFault as e:
                    # discard the step: undo its tok / pos (and the ring and
                    # recurrent state it advanced), then retry it
                    self._on_step_fault(sched, e, fault_slot)
                    bank.undo()
                    continue
                self._step_done()
                for s in sched.absorb_chunk(toks_np):
                    self._pool_retire(sched, alloc, ctx, s)
                refill()
                self.peak_active = sched.note_peak()
        except Exception:
            self._recover_paged(sched, alloc, ctx)
            raise
        self._finish_serve(sched)
        return sched.results_list()

    # ---- mixed varlen loop ----
    def _varlen_block_q(self, budget: int, segment_hint: int) -> int:
        """The packer's block_q for packs of `budget` tokens whose segments
        are ~`segment_hint` rows (the reference's heuristic)."""
        hd = self.mc.head_dim_
        return choose_varlen_blocks(
            bucket_pow2(budget, lo=8), hd, hd, group=self.mc.n_heads // self.mc.n_kv_heads,
            page=self._page_layout.page_size, segment_hint=segment_hint,
        ).block_q

    def _serve_mixed(self, requests, max_new_tokens: int, priorities=None,
                     deadlines=None) -> List[np.ndarray]:
        """Chunked-prefill continuous batching: one packed varlen step per
        iteration carries every decoding slot's pending token and the next
        prefill chunks of admitted prompts; iterations with no prefill in
        flight run `decode_chunk` decode steps instead (the sequential
        loops' fast path). Admission is by free pages, as `_serve_paged`;
        chunked prefill starts at a prompt's first uncached token (`fed0`),
        so a warm shared prefix skips its chunks."""
        b = self.sc.max_batch
        sched = self._make_sched(requests, max_new_tokens, priorities, deadlines)
        alloc, bank = self._paged_state()
        ctx = _PoolCtx(bank.cache)
        budget = self.sc.token_budget or (b + self.sc.prefill_chunk)
        if self._spec is not None and not self.sc.token_budget:
            # the default budget funds every slot's K + 1-row verify chain
            # on top of a prefill chunk, or drafts would never be planned
            budget = b * (self._spec.k + 1) + self.sc.prefill_chunk
        pchunk = max(1, min(self.sc.prefill_chunk, budget))
        chunk_n = max(1, min(self.sc.decode_chunk, max_new_tokens))
        # segments: with > 1 slot decode rows share every pack (~1 row); a
        # lone slot packs one prefill chunk; with speculation, verify chains
        seg_hint = (self._spec.k + 1 if self._spec is not None
                    else 1 if b > 1 else pchunk)
        block_q = self._varlen_block_q(budget, seg_hint)

        def fault_slot(v: int) -> None:
            self._pool_fault_slot(sched, alloc, ctx, v)

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
                try:
                    got = self._admit_to_pool(sched, alloc, ctx, req, max_new_tokens, chunk_n)
                except InjectedFault as e:  # only the request in hand rolls back
                    self._note_fault(e)
                    sched.retry_request(req)
                    continue
                if got is None:
                    return
                seq, cached = got
                self._note_admission(req.tokens, cached)
                self._set_tbl_row(ctx.cache, slot, alloc.table(seq))
                sched.admit_request_prefilling(
                    slot, req, fed0=cached.n_tokens if cached is not None else 0)
                ctx.seq_of[slot] = seq

        def note_prefilled():
            """Index prompts whose prefill just completed (their pages hold
            valid KV from here on) so concurrent admissions match them."""
            if not self._cache_on:
                return
            for s, sl in enumerate(sched.slots):
                if sl.live and not sl.prefilling and s not in ctx.inserted:
                    alloc.insert(ctx.seq_of[s], sl.prompt)
                    ctx.inserted.add(s)

        def dispatch(plan: StepPlan) -> np.ndarray:
            """The packed step (the reference's `_mixed_fn`), one graph per
            pack length: the packer's arrays enter one static buffer."""
            arrays = pack_plan(plan, block_q, b)
            t = len(arrays[0])
            pack = bank.buf(("pack", t), (3 * t + 2 * b,))
            self._steps.put(pack, np.concatenate(arrays))
            out = bank.buf("sampled", (b,))

            def step():
                bank.save()
                tokens, seq_ids, positions = pack[:t], pack[t:2 * t], pack[2 * t:3 * t]
                kv_len, last_rows = pack[3 * t:3 * t + b], pack[3 * t + b:]
                logits, _ = forward_packed(self.params, tokens, seq_ids, positions, kv_len,
                                           bank.cache, self.mc, last_rows, block_q=block_q)
                out.copy_(sample_token(logits, self._gen, self.sc))

            self._inj("kernel_dispatch")
            self._steps.run(bank.graphs, ("packed", t, block_q), step)
            bank.ran = True
            self._inj("device_step")
            return self._sync(out)  # one sync per step

        def decode_chunk_phase() -> Optional[np.ndarray]:
            """No prefill in flight: `chunk_n` decode steps, tok / pos staged
            from the scheduler's host state; dead slots' zeroed table rows
            send their lockstep writes to the garbage page. None when growth
            faults emptied the batch."""
            self._grow_live(sched, alloc, ctx, chunk_n)
            if not sched.has_active():
                return None
            self._restage(bank, sched)
            self._inj("kernel_dispatch")
            out = self._decode_chunk(bank, chunk_n)
            self._inj("device_step")
            return self._sync(out)  # one sync per chunk

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
                self._watchdog.start_step()
                bank.ran = False
                try:
                    if self._spec is not None:
                        # speculative rounds carry verify chains and prefill chunks
                        finished = self._spec_round(sched, alloc, ctx, bank, budget=budget,
                                                    pchunk=pchunk, block_q=block_q)
                    elif not any(sl.prefilling for sl in sched.slots):
                        toks_np = decode_chunk_phase()
                        finished = sched.absorb_chunk(toks_np) if toks_np is not None else []
                    else:
                        plan = self._plan_grown(sched, alloc, ctx, budget, pchunk)
                        finished = sched.commit(plan, dispatch(plan)) if plan.segments else []
                except InjectedFault as e:
                    # discard the step (its inputs are staged anew, what it
                    # saved is put back) and retry it
                    self._on_step_fault(sched, e, fault_slot)
                    bank.undo()
                    continue
                self._step_done()
                note_prefilled()
                for s in finished:
                    self._pool_retire(sched, alloc, ctx, s)
                try_admit()
                self.peak_active = sched.note_peak()
        except Exception:
            self._recover_paged(sched, alloc, ctx)
            raise
        self._finish_serve(sched)
        return sched.results_list()
