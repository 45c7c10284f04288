# Copied verbatim from repro/serve/scheduler.py (numpy only), so the port's
# slot lifecycle is the reference's.
"""Continuous-batching scheduler: slot lifecycle, priority classes,
preemption, and token-budget step plans.

The host-side state machine shared by EVERY serve path (DESIGN.md §3.5,
§3.6). The engine's three loops — contiguous chunked decode, paged chunked
decode, and the mixed varlen step — used to each carry their own copy of
the same bookkeeping (request queue, per-slot output accumulation, EOS /
max-token completion, refill, peak-concurrency tracking). That now lives
here exactly once; the engine keeps only what actually differs per path:
how memory is admitted (slot width vs free pages) and what gets
dispatched.

Priority + preemption (DESIGN.md §3.6):

  * every request carries a priority class (higher value = more urgent;
    default 0 for all = pure FIFO). `head()` returns the highest-priority
    queued request, FIFO (arrival order) within a class — admission is
    still strictly head-of-line *per the priority order*: later requests
    never jump an equal-or-higher-priority blocked head.
  * `victim_slot()` implements victim selection: the lowest-priority live
    slot, decoding slots before prefilling ones (a decoding slot holds
    more reclaimable KV), youngest admission first — so the oldest
    highest-priority work is never the one rolled back.
  * `preempt(slot)` rolls a live slot back into the queue with
    *recompute-on-resume*: its already-generated tokens are appended to
    its prompt, so the resumed prefill replays exactly the token stream
    greedy decoding would have produced and the final outputs are
    token-identical to an unpreempted run (the engine frees / donates the
    slot's memory). `Request.tokens` is that effective prefill input.

Two consumption styles:

  * chunked (`absorb_chunk`) — the sequential engines decode
    `decode_chunk` tokens per dispatch in slot lockstep; the scheduler
    walks the [chunk, n_slots] token block, appends per slot until its
    completion condition fires (later tokens in the chunk are speculative
    garbage, exactly the old engines' convention) and reports finished
    slots for refill.

  * mixed (`plan_step` / `commit`) — chunked-prefill continuous batching:
    each step packs every DECODING slot's one pending token (decode slots
    are planned first and the budget floor is the decoding-slot count, so
    decode can never starve behind a long prompt) plus up to
    `token_budget` remaining tokens of PREFILLING slots' prompts in
    priority-then-FIFO order, split into `prefill_chunk`-sized pieces. A
    segment whose chunk consumes the last prompt token emits that
    sequence's first sampled token; decode segments emit always;
    mid-prompt segments emit nothing. `commit` applies the sampled tokens
    and returns finished slots.

Time-to-first-token is tracked per REQUEST ID from enqueue (scheduler
construction — every request is enqueued then) to the first token the
request ever emits; re-admission after preemption never re-arms it, and a
priority-swapped head keeps the waiting time it actually accrued.

Request lifecycle (DESIGN.md §3.7): every request moves through
QUEUED → RUNNING → one terminal status — DONE (EOS / max tokens),
EXPIRED (deadline passed; cancelled exactly like EOS, with whatever it
generated so far as its result), or FAILED (fault-retry budget
exhausted). Faulted requests re-queue through the same recompute-on-
resume path preemption uses (`retry_request` / `fault_slot`), charged
against a per-request retry budget and deferred by `not_before`
exponential backoff; within a priority class retried requests sort after
fresh ones. Nothing is ever silently dropped: `results_list()` has an
entry and `status` a terminal state for every rid once serving ends.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "Request", "Scheduler", "Segment", "StepPlan", "Slot",
    "QUEUED", "RUNNING", "DONE", "FAILED", "EXPIRED", "TERMINAL",
]

# ---- request lifecycle states ----
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
EXPIRED = "expired"
TERMINAL = frozenset({DONE, FAILED, EXPIRED})


@dataclasses.dataclass
class Request:
    """One queued unit of work, including preemption/retry resume state."""

    rid: int
    prompt: np.ndarray  # the ORIGINAL prompt
    out: List[int] = dataclasses.field(default_factory=list)  # pre-preemption output
    priority: int = 0
    deadline: Optional[float] = None  # scheduler-clock time after which it expires
    retries: int = 0  # fault retries consumed so far
    not_before: float = 0.0  # backoff gate: ineligible for admission before this

    @property
    def tokens(self) -> np.ndarray:
        """Effective prefill input: original prompt + tokens generated
        before preemption (recompute-on-resume keeps tokens identical)."""
        if not self.out:
            return np.asarray(self.prompt)
        return np.concatenate(
            [np.asarray(self.prompt), np.asarray(self.out, np.int32)]
        )

    def __iter__(self):  # legacy (rid, prompt) unpacking
        return iter((self.rid, self.tokens))


@dataclasses.dataclass
class Slot:
    """One batch slot's host-side state."""

    rid: int = -1  # request id (−1 = free)
    prompt: Optional[np.ndarray] = None  # EFFECTIVE prefill tokens (incl. resume)
    orig_prompt: Optional[np.ndarray] = None  # the request's original prompt
    out: List[int] = dataclasses.field(default_factory=list)
    resumed: int = 0  # len(out) carried in from a preemption
    priority: int = 0
    admit_seq: int = -1  # admission order (victim selection: youngest first)
    fed: int = 0  # prompt tokens consumed by prefill chunks (mixed path)
    kv: int = 0  # KV positions materialized in the cache
    pending: int = 0  # next decode input token (mixed path)
    deadline: Optional[float] = None  # scheduler-clock expiry (None = none)
    retries: int = 0  # fault retries the request has consumed

    @property
    def live(self) -> bool:
        return self.rid >= 0

    @property
    def prefilling(self) -> bool:
        return self.live and self.prompt is not None and self.fed < len(self.prompt)

    def cache_tokens(self) -> np.ndarray:
        """Token ids whose KV the slot's cache positions [0, kv) hold: the
        effective prompt followed by post-resume generated tokens. This is
        what retirement donates to the radix prefix cache."""
        new = self.out[self.resumed:]
        stream = np.concatenate(
            [np.asarray(self.prompt, np.int32),
             np.asarray(new, np.int32)]
        ) if new else np.asarray(self.prompt, np.int32)
        return stream[: self.kv]


@dataclasses.dataclass(frozen=True)
class Segment:
    """One slot's contribution to a mixed step's packed batch."""

    slot: int
    tokens: np.ndarray  # token ids fed this step
    start: int  # absolute KV position of tokens[0]
    emits: bool  # does this segment's last row get sampled?
    n_draft: int = 0  # trailing speculative rows: tokens[1:] are draft
    # proposals to VERIFY (tokens[0] is the committed pending token);
    # commit() keeps the longest accepted prefix and rolls kv back past
    # the rest (DESIGN.md §3.9)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    segments: Tuple[Segment, ...]
    n_tokens: int  # Σ len(seg.tokens) — the test-pinned budget accounting


class Scheduler:
    def __init__(self, requests: Sequence[Union[np.ndarray, Request]],
                 max_new_tokens: int, n_slots: int, eos_id: int,
                 priorities: Optional[Sequence[int]] = None,
                 deadlines: Optional[Sequence[Optional[float]]] = None,
                 max_retries: int = 3, retry_backoff_s: float = 0.0):
        """`requests` items are prompts (np arrays) or `Request` objects —
        the latter carry resume state (out/priority/deadline/retries) from
        a snapshot restore; either way rids are re-assigned to index order.
        `deadlines` are seconds from enqueue (None = no deadline);
        `max_retries`/`retry_backoff_s` parameterize the fault-retry path
        (`RetryPolicy` semantics, see runtime/resilience.py)."""
        if priorities is not None and len(priorities) != len(requests):
            raise ValueError("priorities must match requests 1:1")
        if deadlines is not None and len(deadlines) != len(requests):
            raise ValueError("deadlines must match requests 1:1")
        self.results: List[Optional[np.ndarray]] = [None] * len(requests)
        self.queue: List[Request] = []
        for i, r in enumerate(requests):
            if isinstance(r, Request):
                pr = int(priorities[i]) if priorities is not None else r.priority
                dl = r.deadline if deadlines is None else deadlines[i]
                self.queue.append(Request(
                    rid=i, prompt=np.asarray(r.prompt), out=list(r.out),
                    priority=pr, deadline=dl, retries=r.retries,
                    # a restored mid-backoff request keeps its gate: the
                    # caller rebased it to this scheduler's clock (seconds
                    # from construction), same convention as deadlines
                    not_before=r.not_before,
                ))
            else:
                self.queue.append(Request(
                    rid=i, prompt=np.asarray(r),
                    priority=int(priorities[i]) if priorities is not None else 0,
                    deadline=deadlines[i] if deadlines is not None else None,
                ))
        self.status: Dict[int, str] = {i: QUEUED for i in range(len(requests))}
        self.slots = [Slot() for _ in range(n_slots)]
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.peak_active = 0
        self.preemptions = 0
        self.retried = 0  # fault retries charged (requeues)
        self.failed = 0  # requests terminal-FAILED (budget exhausted)
        self.expired = 0  # requests terminal-EXPIRED (deadline passed)
        self.rollbacks = 0  # preemptions + fault requeues (re-plan signal)
        # speculative-decoding bookkeeping (DESIGN.md §3.9): aggregate and
        # per-request drafted/accepted counters, filled by verify commits
        self.spec_rounds = 0  # verify segments committed with n_draft > 0
        self.spec_drafted = 0  # draft tokens proposed to the target
        self.spec_accepted = 0  # draft tokens the target confirmed
        self.spec_by_rid: Dict[int, Tuple[int, int]] = {}  # rid → (drafted, accepted)
        self._admit_counter = 0
        # time-to-first-token per request id, seconds from enqueue (every
        # request enqueues at construction) to the first token the request
        # EVER emits — recorded once, never re-armed by a preemption
        # resume; the serving-latency signal BENCH_serve.json /
        # BENCH_prefix.json track
        self.first_token_at: Dict[int, float] = {}
        self._t0 = time.monotonic()

    def now(self) -> float:
        """Scheduler-clock time (seconds since construction/enqueue)."""
        return time.monotonic() - self._t0

    def _mark_first_token(self, rid: int) -> None:
        if rid not in self.first_token_at:
            self.first_token_at[rid] = self.now()

    # ---- queue / admission (priority head-of-line) ----
    def _head_index(self) -> Optional[int]:
        now = self.now()
        ready = [i for i, q in enumerate(self.queue) if q.not_before <= now]
        if not ready:
            return None
        # retried requests sort AFTER fresh ones of the same priority —
        # the "exponential backoff ordering" half of the retry contract
        # (the not_before gate above is the other half)
        return min(ready, key=lambda i: (-self.queue[i].priority,
                                         self.queue[i].retries,
                                         self.queue[i].rid))

    def head(self) -> Optional[Request]:
        i = self._head_index()
        return self.queue[i] if i is not None else None

    def take_head(self) -> Optional[Request]:
        i = self._head_index()
        return self.queue.pop(i) if i is not None else None

    def next_ready_in(self) -> Optional[float]:
        """Seconds until the earliest backing-off queued request becomes
        eligible; None when nothing is waiting on backoff."""
        now = self.now()
        waits = [q.not_before - now for q in self.queue if q.not_before > now]
        return min(waits) if waits else None

    def free_slot(self) -> Optional[int]:
        for s, slot in enumerate(self.slots):
            if not slot.live:
                return s
        return None

    def active_count(self) -> int:
        return sum(slot.live for slot in self.slots)

    def has_active(self) -> bool:
        return any(slot.live for slot in self.slots)

    def note_peak(self) -> int:
        self.peak_active = max(self.peak_active, self.active_count())
        return self.peak_active

    # ---- preemption ----
    def victim_slot(self, *, below: Optional[int] = None,
                    exclude: Tuple[int, ...] = ()) -> Optional[int]:
        """The slot to roll back under pressure: lowest priority first
        (optionally strictly below `below` — admission preemption never
        preempts an equal-priority peer), decoding before prefilling
        (decoding slots hold more reclaimable KV), youngest admission
        first. None when no live slot qualifies."""
        best, best_key = None, None
        for s, sl in enumerate(self.slots):
            if not sl.live or s in exclude:
                continue
            if below is not None and sl.priority >= below:
                continue
            key = (sl.priority, 1 if sl.prefilling else 0, -sl.admit_seq)
            if best_key is None or key < best_key:
                best, best_key = s, key
        return best

    def preempt(self, slot: int) -> Request:
        """Roll `slot` back into the queue with recompute-on-resume: the
        requeued request's prefill input is its original prompt plus every
        token it already generated, so the resumed stream is token-
        identical. The caller releases the slot's memory."""
        sl = self.slots[slot]
        assert sl.live, "preempting a dead slot"
        req = Request(rid=sl.rid, prompt=np.asarray(sl.orig_prompt),
                      out=list(sl.out), priority=sl.priority,
                      deadline=sl.deadline, retries=sl.retries)
        self.queue.append(req)  # head() orders by (priority, retries, rid)
        self.status[sl.rid] = QUEUED
        self.slots[slot] = Slot()
        self.preemptions += 1
        self.rollbacks += 1
        return req

    # ---- fault retries (DESIGN.md §3.7) ----
    def retry_request(self, req: Request, *, backoff_s: Optional[float] = None) -> bool:
        """Charge a faulted request (held by the caller, not slot-resident)
        one retry and re-queue it behind an exponential-backoff gate.
        Returns False — and records the terminal FAILED result (tokens
        generated so far, like EOS does) — when the budget is exhausted."""
        req.retries += 1
        self.rollbacks += 1  # FAILED invalidates a step plan like a requeue
        if req.retries > self.max_retries:
            self.finish(req.rid, list(req.out), status=FAILED)
            return False
        base = self.retry_backoff_s if backoff_s is None else backoff_s
        req.not_before = self.now() + base * (2 ** (req.retries - 1))
        self.status[req.rid] = QUEUED
        self.queue.append(req)
        self.retried += 1
        return True

    def fault_slot(self, slot: int, *, backoff_s: Optional[float] = None) -> bool:
        """Roll a faulted LIVE slot back like `preempt`, but charged as a
        retry: its committed tokens ride along (recompute-on-resume keeps
        the stream token-identical), its budget is debited, and re-
        admission waits out the backoff. Returns False when the request
        went terminal-FAILED instead. Caller releases the slot's memory
        either way."""
        sl = self.slots[slot]
        assert sl.live, "faulting a dead slot"
        req = Request(rid=sl.rid, prompt=np.asarray(sl.orig_prompt),
                      out=list(sl.out), priority=sl.priority,
                      deadline=sl.deadline, retries=sl.retries)
        self.slots[slot] = Slot()
        return self.retry_request(req, backoff_s=backoff_s)

    # ---- deadlines ----
    def expire_overdue(self) -> List[int]:
        """Cancel every queued or live request whose deadline has passed —
        exactly like EOS: whatever it generated so far is its result,
        status EXPIRED. Returns the newly expired LIVE slots (the engine
        releases their memory, then `retire`s them)."""
        now = self.now()
        expired_slots: List[int] = []
        for i in reversed(range(len(self.queue))):
            q = self.queue[i]
            if q.deadline is not None and now > q.deadline:
                self.queue.pop(i)
                self.finish(q.rid, list(q.out), status=EXPIRED)
        for s, sl in enumerate(self.slots):
            if sl.live and sl.deadline is not None and now > sl.deadline:
                self.finish(sl.rid, list(sl.out), status=EXPIRED)
                expired_slots.append(s)
        return expired_slots

    # ---- completion ----
    def _done(self, out: List[int]) -> bool:
        return len(out) >= self.max_new_tokens or (
            self.eos_id >= 0 and out[-1] == self.eos_id
        )

    def finish(self, rid: int, out: List[int], status: str = DONE) -> None:
        assert status in TERMINAL, f"finish with non-terminal status {status!r}"
        self.results[rid] = np.asarray(out, np.int32)
        self.status[rid] = status
        if status == FAILED:
            self.failed += 1
        elif status == EXPIRED:
            self.expired += 1

    def all_terminal(self) -> bool:
        """Lifecycle guarantee: every request reached a terminal status."""
        return all(s in TERMINAL for s in self.status.values())

    def admit_request(self, slot: int, req: Request, first_token: int) -> bool:
        """Sequential-path admission of a (possibly resumed) request: the
        effective prompt is already prefilled and its next token sampled.
        Requests that complete immediately are finalized without taking
        the slot; returns True when the slot was taken."""
        if not req.out:
            self._mark_first_token(req.rid)
        out = list(req.out) + [first_token]
        if self._done(out):
            self.finish(req.rid, out)
            return False
        sl = self.slots[slot]
        sl.rid, sl.out = req.rid, out
        sl.prompt = req.tokens
        sl.orig_prompt = np.asarray(req.prompt)
        sl.resumed = len(req.out)
        sl.priority = req.priority
        sl.deadline = req.deadline
        sl.retries = req.retries
        sl.admit_seq = self._admit_counter
        self._admit_counter += 1
        sl.fed = sl.kv = len(sl.prompt)
        sl.pending = first_token
        self.status[req.rid] = RUNNING
        return True

    def admit_or_finish(self, slot: int, rid: int, prompt: np.ndarray,
                        first_token: int) -> bool:
        """Legacy sequential-path admission (fresh request, priority 0)."""
        return self.admit_request(
            slot, Request(rid=rid, prompt=np.asarray(prompt)), first_token
        )

    def admit_request_prefilling(self, slot: int, req: Request,
                                 *, fed0: int = 0) -> None:
        """Mixed-path admission: the effective prompt will be fed in
        chunks, starting at `fed0` (positions below it are already in the
        cache — the radix prefix hit, DESIGN.md §3.6)."""
        sl = self.slots[slot]
        sl.rid, sl.out = req.rid, list(req.out)
        sl.prompt = req.tokens
        sl.orig_prompt = np.asarray(req.prompt)
        sl.resumed = len(req.out)
        sl.priority = req.priority
        sl.deadline = req.deadline
        sl.retries = req.retries
        sl.admit_seq = self._admit_counter
        self._admit_counter += 1
        sl.fed = sl.kv = fed0
        sl.pending = 0
        self.status[req.rid] = RUNNING

    def admit_prefilling(self, slot: int, rid: int, prompt: np.ndarray) -> None:
        """Legacy mixed-path admission (fresh request, priority 0)."""
        self.admit_request_prefilling(
            slot, Request(rid=rid, prompt=np.asarray(prompt))
        )

    def retire(self, slot: int) -> int:
        """Free a slot (results must already be recorded); returns its rid."""
        rid = self.slots[slot].rid
        self.slots[slot] = Slot()
        return rid

    # ---- chunked consumption (contiguous + paged sequential loops) ----
    def absorb_chunk(self, toks_np: np.ndarray) -> List[int]:
        """Walk a [chunk, n_slots] sampled-token block in slot lockstep;
        tokens after a slot's completion are speculative garbage and are
        discarded. Records finished results and returns finished slots
        (NOT yet retired — the engine frees memory first)."""
        finished: List[int] = []
        for s, sl in enumerate(self.slots):
            if not sl.live:
                continue
            for step in range(toks_np.shape[0]):
                t = int(toks_np[step, s])
                sl.out.append(t)
                sl.kv += 1
                sl.pending = t  # next decode input if a packed step follows
                if self._done(sl.out):
                    self.finish(sl.rid, sl.out)
                    finished.append(s)
                    break
        return finished

    # ---- speculative draft budgeting (DESIGN.md §3.9) ----
    def draft_quota(self, slot: int, k_max: int, *, max_len: int,
                    per_row_s: Optional[float] = None) -> int:
        """How many draft tokens `slot` may verify this step. Clamped so
        the accepted prefix plus the bonus token can never exceed the
        request's `max_new_tokens` or the cache's `max_len`, and — the
        deadline bugfix — so a K-row verify step cannot overshoot a
        deadline by K rows' worth of work: `expire_overdue` only runs
        BETWEEN engine steps, so near the deadline the quota shrinks with
        the remaining slack (`per_row_s` is the engine's measured
        per-verify-row wall time)."""
        sl = self.slots[slot]
        if not sl.live or sl.prefilling:
            return 0
        k = min(int(k_max),
                self.max_new_tokens - len(sl.out) - 1,
                max_len - sl.kv - 1)
        if k <= 0:
            return 0
        if sl.deadline is not None and per_row_s and per_row_s > 0:
            slack = sl.deadline - self.now()
            if slack <= 0:
                return 0
            k = min(k, max(0, int(slack / per_row_s) - 1))
        return max(0, k)

    # ---- mixed-step planning (chunked-prefill continuous batching) ----
    def plan_step(self, token_budget: int, prefill_chunk: int,
                  drafts: Optional[Dict[int, np.ndarray]] = None) -> StepPlan:
        """One mixed step's packed work list.

        Decode slots first — every decoding slot contributes its pending
        token, and the effective budget is floored at that count, so a
        wall of prefill can never starve decode. Remaining budget goes to
        prefilling slots' next prompt chunks in priority-then-request-id
        (FIFO within a class) order.

        `drafts` (speculative decoding, DESIGN.md §3.9) maps decode slots
        to proposed draft tokens. Draft rows are funded LAST, round-robin
        across decode slots, from whatever budget prefill chunks left
        over — draft rows count against `token_budget` but can never
        starve a prefill chunk (acceptance is a throughput bonus, TTFT is
        a latency promise). Values may be placeholders when the real
        draft tokens live on device (the verify dispatch scatters them);
        only the per-slot COUNT is planned here.
        """
        decoding = [
            s for s, sl in enumerate(self.slots)
            if sl.live and not sl.prefilling
        ]
        budget = max(int(token_budget), len(decoding)) - len(decoding)
        pre_segs: List[Segment] = []
        prefilling = sorted(
            (s for s, sl in enumerate(self.slots) if sl.prefilling),
            key=lambda s: (-self.slots[s].priority, self.slots[s].rid),
        )
        for s in prefilling:
            if budget <= 0:
                break
            sl = self.slots[s]
            # ≥ 1: budget > 0 here, prefill_chunk ≥ 1, and a prefilling
            # slot always has unfed prompt left
            n = min(prefill_chunk, len(sl.prompt) - sl.fed, budget)
            pre_segs.append(Segment(
                slot=s,
                tokens=np.asarray(sl.prompt[sl.fed:sl.fed + n], np.int32),
                start=sl.fed,
                emits=sl.fed + n == len(sl.prompt),
            ))
            budget -= n
        extra: Dict[int, int] = {s: 0 for s in decoding}
        if drafts:
            gave = True
            while budget > 0 and gave:
                gave = False
                for s in decoding:
                    if budget <= 0:
                        break
                    if extra[s] < len(drafts.get(s, ())):
                        extra[s] += 1
                        budget -= 1
                        gave = True
        dec_segs: List[Segment] = []
        for s in decoding:
            sl = self.slots[s]
            k = extra[s]
            toks = [sl.pending]
            if k:
                toks.extend(int(t) for t in np.asarray(drafts[s])[:k])
            dec_segs.append(Segment(
                slot=s, tokens=np.asarray(toks, np.int32),
                start=sl.kv, emits=True, n_draft=k,
            ))
        segs = dec_segs + pre_segs
        return StepPlan(
            segments=tuple(segs), n_tokens=sum(len(g.tokens) for g in segs)
        )

    def commit(self, plan: StepPlan, sampled: np.ndarray,
               n_acc: Optional[np.ndarray] = None) -> List[int]:
        """Apply one mixed step's sampled tokens ([n_slots], garbage at
        non-emitting slots). Returns finished slots (engine retires them
        after freeing their memory).

        With `n_acc` (a speculative verify step, DESIGN.md §3.9),
        `sampled` is [n_slots, R]: the target's greedy token at every
        verify row. A decode segment commits the longest accepted prefix —
        row j's token is appended for j = 0..n_acc[slot] (the last one is
        the free "bonus" token from the first rejected row), stopping
        early at EOS/max-tokens — and `kv` advances by exactly the tokens
        committed, so the engine can roll the allocator back to it."""
        finished: List[int] = []
        for seg in plan.segments:
            sl = self.slots[seg.slot]
            if not sl.live:  # preempted after planning (engine re-plans, but stay safe)
                continue
            n = len(seg.tokens)
            if n_acc is not None and not sl.prefilling:
                # verify segment: pending + accepted drafts + bonus token
                k_ok = min(int(n_acc[seg.slot]), seg.n_draft)
                consumed = 0
                for j in range(k_ok + 1):
                    t = int(sampled[seg.slot, j])
                    sl.out.append(t)
                    sl.pending = t
                    consumed += 1
                    if len(sl.out) == sl.resumed + 1 and sl.resumed == 0:
                        self._mark_first_token(sl.rid)
                    if self._done(sl.out):
                        self.finish(sl.rid, sl.out)
                        finished.append(seg.slot)
                        break
                sl.kv = seg.start + consumed  # rejected rows: kv rolls back
                if seg.n_draft:
                    acc = min(consumed, k_ok)
                    self.spec_rounds += 1
                    self.spec_drafted += seg.n_draft
                    self.spec_accepted += acc
                    d, a = self.spec_by_rid.get(sl.rid, (0, 0))
                    self.spec_by_rid[sl.rid] = (d + seg.n_draft, a + acc)
                continue
            sl.kv += n
            if sl.prefilling:
                sl.fed += n
            if not seg.emits:
                continue
            t = int(sampled[seg.slot]) if n_acc is None else int(sampled[seg.slot, 0])
            sl.out.append(t)
            sl.pending = t
            if len(sl.out) == sl.resumed + 1 and sl.resumed == 0:
                self._mark_first_token(sl.rid)
            if self._done(sl.out):
                self.finish(sl.rid, sl.out)
                finished.append(seg.slot)
        return finished

    # ---- results ----
    def results_list(self) -> List[np.ndarray]:
        return [
            r if r is not None else np.zeros((0,), np.int32)
            for r in self.results
        ]
