"""Speculative decoding draft proposers — the port of
`repro/serve/speculative.py`.

The engine verifies K proposed tokens per round through ONE packed step
(`Engine._verify`): each speculation is a packed segment of K + 1 rows
with explicit per-row positions, which `forward_packed` (K4 on the card)
already takes — a draft chain is a mid-sequence chunk. This module owns
the other half: where the K proposals come from.

Two proposer kinds, by what `Engine(draft=...)` receives:

  * `DraftModel` — a small model with its own CONTIGUOUS cache on the
    engine's device, one slot per engine slot, run by a contiguous
    `Engine` of its own: a slot's catch-up replays that engine's prefill
    graph per position, and the K greedy proposals are one captured graph
    of K decode steps (K2 on the card), replayed over a static bank. The
    proposals stay on the device: the verify step reads them from the
    bank's static buffer, so a round still costs one host sync. The draft
    cache needs no rollback: positions past a slot's committed length are
    stale but never read (decode reads below its position), and accepted
    drafts ARE the committed tokens, so after a round the draft KV below
    min(kv, old + K) is already right; `sync()` feeds the missing tail and
    re-prefills on a new request or after a preemption rewind.

  * any callable `fn(rid, tokens, k) -> np.ndarray` — a host proposer fed
    the request's visible stream (effective prompt + every generated
    token, the last being the pending one). `OracleDraft` is the test
    instance: the known greedy continuation with a seeded per-token
    corruption, so acceptance is an exact dial.

The proposals are hints only: the target's greedy argmax at every verify
row decides what commits, so the output equals non-speculative greedy
decoding at any acceptance rate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models import ModelConfig

__all__ = ["DraftModel", "OracleDraft", "SpecState"]


@dataclasses.dataclass
class SpecState:
    """Engine-side speculative state: the proposer, the static draft length
    K, and the measured wall time per verify row (EWMA) that feeds the
    scheduler's deadline clamp (`draft_quota`)."""

    k: int
    draft: object  # DraftModel | callable(rid, tokens, k) -> np.ndarray
    row_ewma: Optional[float] = None


class DraftModel:
    """Draft proposer backed by a small model with a contiguous cache.

    Per-slot host state: `pos[s]` — how many leading positions of slot s's
    draft cache hold KV of the target's committed stream — and `rid[s]`,
    the request that content belongs to. Per round: `sync()`, `propose()`
    (K greedy steps, tokens on the device), and after the engine commits
    the verify results, `committed()`.

    `device` / `graphs` are the engine's (the target engine passes its
    own); the draft's weights must be on that device."""

    def __init__(self, params: dict, cfg: ModelConfig, *, max_batch: int, max_len: int,
                 device=None, graphs: Optional[bool] = None):
        from repro_torch.serve.engine import Engine, ServeConfig  # lazy: the engine imports us

        self.b = max_batch
        # a greedy contiguous engine runs the draft's steps (and their graphs)
        self.runner = Engine(params, cfg, ServeConfig(max_batch=max_batch, max_len=max_len),
                             device=device, graphs=graphs)
        self.bank = self.runner._contiguous(max_batch)
        self.pos = np.zeros(max_batch, np.int64)  # committed-valid KV length
        self.rid = np.full(max_batch, -1, np.int64)  # cache content owner
        self._last_k = 0

    def sync(self, sched) -> None:
        """Bring every decoding slot's draft KV up to the target's committed
        length: a slot serving a new request (or rewound past the draft's
        valid length by a preemption resume) re-prefills its whole committed
        stream into a zeroed region; otherwise only the missing tail is fed
        (from `start`). Device work only, no host sync."""
        from repro_torch.models.transformer import cache_leaves
        from repro_torch.serve.engine import _slot_view  # lazy: no cycle

        for s, sl in enumerate(sched.slots):
            if not sl.live or sl.prefilling:
                continue
            fresh = self.rid[s] != sl.rid or self.pos[s] > sl.kv
            start = 0 if fresh else int(self.pos[s])
            if start == sl.kv:
                self.rid[s] = sl.rid
                continue
            stream = np.asarray(sl.cache_tokens())  # token ids at positions [0, kv)
            if fresh:
                for _, leaf in cache_leaves(_slot_view(self.bank.cache, s)):
                    leaf.zero_()
            self.runner._prefill(self.bank, s, stream[None, start:], start)
            self.pos[s] = len(stream)
            self.rid[s] = sl.rid

    def propose(self, sched, k: int) -> torch.Tensor:
        """Greedy-propose `k` tokens for every decoding slot from its pending
        token at its committed position: one replay of the draft's k-step
        decode graph. Returns a device [B, k] view of the graph's static
        output buffer — the verify step reads it in place, so draft tokens
        never visit the host. Dead and prefilling slots step from position
        0 (their writes land where a later occupant re-prefills first)."""
        state = np.zeros((2, self.b), np.int64)  # tok | pos
        for s, sl in enumerate(sched.slots):
            if sl.live and not sl.prefilling:
                state[:, s] = (sl.pending, sl.kv)
        self.runner._steps.put(self.bank.state, state)
        self._last_k = int(k)
        return self.runner._decode_chunk(self.bank, int(k)).T

    def committed(self, sched) -> None:
        """Advance each synced slot's valid length past the round's accepted
        prefix: `propose` wrote draft KV at [old, old + K) with exactly the
        tokens that committed, so positions below min(kv, old + K) are
        right. The bonus token's position was never fed: `sync` feeds it
        next round."""
        for s, sl in enumerate(sched.slots):
            if sl.live and not sl.prefilling and self.rid[s] == sl.rid:
                self.pos[s] = min(sl.kv, int(self.pos[s]) + self._last_k)


class OracleDraft:
    """Host-callable proposer with an exactly controlled acceptance rate.

    Proposes the known continuation of each request (the non-speculative
    greedy output, computed once by the caller), corrupting each token
    independently with probability 1 − accuracy to a guaranteed-wrong id
    (seeded). The corruption is the reference's, draw for draw, so the same
    seed gives the same acceptance pattern in both packages."""

    def __init__(self, prompts: Sequence[np.ndarray], refs: Sequence[np.ndarray],
                 vocab_size: int, *, accuracy: float = 1.0, seed: int = 0):
        self.plen = {i: len(p) for i, p in enumerate(prompts)}
        self.refs = {i: np.asarray(r, np.int64) for i, r in enumerate(refs)}
        self.vocab = int(vocab_size)
        self.accuracy = float(accuracy)
        self.seed = int(seed)

    def __call__(self, rid: int, tokens: np.ndarray, k: int) -> np.ndarray:
        done = len(tokens) - self.plen[rid]  # output tokens emitted so far
        ref = self.refs[rid]
        prop = np.array(ref[done: done + k], np.int64)
        if self.accuracy < 1.0 and len(prop):
            # a pure function of (seed, rid, position): a re-proposal after a
            # rejection or a preemption corrupts the same positions the same way
            rng = np.random.default_rng((self.seed, rid, done))
            flip = rng.random(len(prop)) >= self.accuracy
            junk = rng.integers(0, self.vocab, len(prop))
            junk = np.where(junk == prop, (junk + 1) % self.vocab, junk)
            prop = np.where(flip, junk, prop)
        return prop.astype(np.int32)
