# Copied from repro/runtime/kvcache.py (pure Python), so the port's page
# allocator is the reference's. One change: `_check_scales` walks the port's
# nested dict of tensors where the reference walked a jax pytree.
"""Paged KV-cache allocator: global page pool, per-sequence block tables,
copy-on-write prefix sharing, and a content-addressed radix prefix cache
(DESIGN.md §3.4, §3.6).

The serving engine's historical memory model reserved one contiguous
`max_len`-wide cache region per batch slot, so `max_batch × max_len` tokens
of KV memory were committed up front even when every live sequence was
short. This module replaces that with the vLLM memory model: KV lives in a
pool of fixed-size *pages* (`page_size` tokens each); a sequence owns an
ordered *block table* of page ids covering `ceil(len / page_size)` pages;
pages are allocated as the sequence grows and returned to the pool when it
finishes. FlashAttention-style kernels are indifferent to where KV tiles
live, and FLASH-D's division-free sigmoid merge blends partials from
non-contiguous pages with the same one-FMA carry as contiguous splits
(`kernels/flashd_decode.flashd_decode_paged_pallas`), so the kernel-side
cost of paging is just the block-table indirection.

This class is pure host-side bookkeeping — it never touches device arrays.
Device effects are communicated back to the caller as:

  * block tables (`table(seq)`) the engine mirrors into the device-side
    `tbl` operand of the paged decode kernel;
  * `CowCopy(src, dst)` records: the caller must copy page `src` → page
    `dst` in every layer's page arrays *before* the next write dispatch.

Radix prefix cache (DESIGN.md §3.6):

  The KV content of page j is a pure function of the token ids at
  positions [0, (j+1)·page) — for a pure global-attention stack, attention
  at position p reads only positions ≤ p. So a *full* page is content-
  addressable by its token chain, and the tree below indexes every full
  page the allocator has ever been given by that chain:

  * `insert(seq, tokens)` — called once a live sequence's pages hold valid
    KV (prefill complete): each full page becomes a tree node (keyed by
    the page's token tuple, chained by depth) holding one extra reference.
  * `donate(seq, tokens)` — retirement: like `free`, but the full pages of
    the sequence's clean token stream (prompt + generated) stay in the
    tree instead of returning to the pool. A page whose node has no table
    references left (``refcount == 1``: the tree's own reference) sits on
    the logical LRU eviction list — retained, but reclaimable.
  * `match_prefix(tokens)` — admission walks the tree with the prompt's
    page chain and returns the longest cached full-page prefix; `admit`
    aliases those pages into the new table (refcount++) so prefill starts
    at the first uncached token. FLASH-D's tile-local (O, Λ) carry is what
    makes resuming from a page boundary free: no running max or deferred
    division needs reconstructing — the next tile's sigmoid blend picks up
    from the cached pages as if they had just been computed.
  * eviction — `_take_page` reclaims least-recently-used refcount-1 leaves
    on demand; `CachePolicy` adds a min-free-pages watermark and a cache
    size cap enforced after every donation. Eviction never touches a page
    any table still references.

Sharing / copy-on-write semantics:

  * `admit(..., share_from=parent, shared_tokens=n)` makes the child's
    first `ceil(n / page_size)` table entries reference the parent's pages
    (refcount++). Full pages of the shared prefix are never written by
    either sequence again (writes only happen at positions ≥ the owner's
    length), so they are shared for their whole lifetime for free. The
    *boundary* page — shared only up to mid-page — is immediately
    copy-on-write'd for the child (one `CowCopy`), because the child's
    tail prefill writes into it. Radix-matched pages (`cached=`) are
    always full pages, so they need no boundary copy at all.
  * Because the boundary page is copied at admit (child side) and full
    shared pages lie strictly below every owner's length, **no live
    sequence ever holds a writable shared page** — writers only touch
    positions ≥ their own length, and those always land on exclusively
    owned (or fresh) pages. `extend()` keeps a defensive CoW for the
    unreachable case anyway, and `check()` asserts the invariant.

Admission control: `reserve_tokens` pages are *reserved* at admit; the
preemption-free engines pass the worst case (prompt + max_new_tokens +
decode-chunk slack) so a mid-flight sequence can never hit pool
exhaustion, while the preemptible engines pass just the prompt
(optimistic per-chunk allocation — growth draws the free pool, and page
pressure is resolved by preempting a victim, DESIGN.md §3.6).
Reservations only turn into materialized pages as the sequence actually
grows (`extend`); once a reservation is spent, growth falls back to the
free pool (evicting cached pages on demand).

Page id 0 is reserved as the *garbage page*: the engine points the table
rows of dead batch slots at it (and the kernel clamps out-of-table writes
to it), so lockstep decode steps of finished slots scribble harmlessly
instead of corrupting live pages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = [
    "CachePolicy",
    "CowCopy",
    "PagedKVAllocator",
    "PageError",
    "PrefixMatch",
    "pages_for",
]

GARBAGE_PAGE = 0


class PageError(RuntimeError):
    """Pool exhausted or API misuse (admitting a live seq, growing a dead one)."""


@dataclasses.dataclass(frozen=True)
class CowCopy:
    """Device-side page copy the caller owes: pages[dst] ← pages[src]."""

    src: int
    dst: int


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    """Retention heuristics for the radix prefix cache (tuning layer).

    min_free_pages   — after a donation, evict cached pages until at least
                       this many pages are physically free (admissions
                       should not always pay eviction latency).
    max_cached_pages — hard cap on tree-retained pages (None: unbounded;
                       0 disables retention entirely — donations free).
    """

    min_free_pages: int = 0
    max_cached_pages: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of a radix lookup: the longest cached full-page prefix.

    `n_tokens` is always a multiple of page_size; `pages` are the cached
    page ids in chain order, valid to alias until the next allocator
    mutation (admit revalidates them)."""

    n_tokens: int
    pages: Tuple[int, ...]


class _RadixNode:
    """One full page of cached KV. Children are keyed by the NEXT page's
    token tuple, so a root path spells out a token-chain prefix."""

    __slots__ = ("key", "pid", "children", "parent", "tick")

    def __init__(self, key, pid, parent):
        self.key = key
        self.pid = pid
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.tick = 0


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages covering n_tokens (0 tokens → 0 pages)."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // page_size)


class PagedKVAllocator:
    def __init__(self, n_pages: int, page_size: int,
                 *, cache_policy: Optional[CachePolicy] = None):
        if n_pages < 2:
            raise ValueError("need ≥ 2 pages (page 0 is the garbage page)")
        if page_size < 1:
            raise ValueError("page_size must be ≥ 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self.policy = cache_policy or CachePolicy()
        # LIFO free list → recently-freed pages are reused first (warm VMEM/HBM)
        self._free: List[int] = list(range(n_pages - 1, GARBAGE_PAGE, -1))
        self._ref: List[int] = [0] * n_pages
        self._tables: Dict[int, List[int]] = {}
        self._lens: Dict[int, int] = {}
        self._reserved: Dict[int, int] = {}  # seq → reserved-but-unmaterialized pages
        # ---- radix prefix cache ----
        self._root = _RadixNode(key=None, pid=-1, parent=None)
        self._tree: Dict[int, _RadixNode] = {}  # pid → its (unique) node
        self._tick = 0
        self.evictions = 0  # cached pages reclaimed (stats)
        self.donated_pages = 0  # tree nodes ever created (stats)

    # ---- accounting ----
    @property
    def free_pages(self) -> int:
        """Pages available to new admissions without evicting anything
        (excludes live reservations)."""
        return len(self._free) - sum(self._reserved.values())

    @property
    def pages_in_use(self) -> int:
        """Distinct pages currently materialized (shared pages count once;
        includes tree-retained pages awaiting eviction)."""
        return sum(1 for r in self._ref if r > 0)

    @property
    def reserved_pages(self) -> int:
        """Pages promised to live sequences but not yet materialized."""
        return sum(self._reserved.values())

    @property
    def cached_pages(self) -> int:
        """Pages indexed by the radix tree (live-shared + LRU-retained)."""
        return len(self._tree)

    @property
    def evictable_pages(self) -> int:
        """Tree pages reclaimable by cascading LRU eviction right now."""
        return self._evictable()

    @property
    def live_seqs(self) -> Tuple[int, ...]:
        return tuple(self._tables)

    def table(self, seq: int) -> List[int]:
        return list(self._tables[seq])

    def seq_len(self, seq: int) -> int:
        return self._lens[seq]

    def refcount(self, pid: int) -> int:
        return self._ref[pid]

    # ---- radix prefix cache ----
    def _page_key(self, tokens, j: int) -> Tuple[int, ...]:
        p = self.page_size
        return tuple(int(t) for t in tokens[j * p:(j + 1) * p])

    def _touch(self, node: _RadixNode) -> None:
        self._tick += 1
        while node is not None and node is not self._root:
            node.tick = self._tick
            node = node.parent

    def match_prefix(self, tokens, *, max_tokens: Optional[int] = None) -> PrefixMatch:
        """Longest cached full-page prefix of `tokens` (pure lookup — no
        refcount or LRU mutation). `max_tokens` caps the match (engines
        pass prompt_len − 1 so at least one token always prefills)."""
        limit = len(tokens) if max_tokens is None else min(len(tokens), max_tokens)
        node, pids, j = self._root, [], 0
        while (j + 1) * self.page_size <= limit:
            child = node.children.get(self._page_key(tokens, j))
            if child is None:
                break
            pids.append(child.pid)
            node = child
            j += 1
        return PrefixMatch(n_tokens=j * self.page_size, pages=tuple(pids))

    def insert(self, seq: int, tokens) -> int:
        """Index a live sequence's full prompt pages in the tree (call once
        its pages hold valid KV — after prefill). Each newly indexed page
        gains the tree's reference, so it outlives the sequence. Pages
        whose chain position is already cached (e.g. radix-matched at
        admission) are just touched. Returns pages newly indexed."""
        if seq not in self._tables:
            raise PageError(f"seq {seq} not admitted")
        table = self._tables[seq]
        clean = min(len(tokens), self._lens[seq])
        node, created, j = self._root, 0, 0
        while (j + 1) * self.page_size <= clean:
            key = self._page_key(tokens, j)
            child = node.children.get(key)
            if child is None:
                pid = table[j]
                if pid in self._tree:  # page already indexed on another chain
                    break  # (unreachable via prefix aliasing; stay safe)
                child = _RadixNode(key=key, pid=pid, parent=node)
                node.children[key] = child
                self._tree[pid] = child
                self._ref[pid] += 1  # the tree's own reference
                created += 1
            node = child
            j += 1
        if j:
            self._touch(node)
        self.donated_pages += created
        self._enforce_policy()
        return created

    def donate(self, seq: int, tokens) -> int:
        """Retire `seq`, donating its clean full pages to the radix tree.

        `tokens` is the sequence's clean token stream — the ids whose KV
        its pages actually hold (effective prompt + generated tokens,
        truncated to the materialized length). Full pages of that stream
        become (or refresh) tree nodes; the boundary partial page and any
        duplicate-content pages are freed normally. Returns pages newly
        indexed."""
        if seq not in self._tables:
            raise PageError(f"seq {seq} not admitted")
        table = self._tables.pop(seq)
        clean = min(len(tokens), self._lens.pop(seq))
        self._reserved.pop(seq, None)
        node, last, created = self._root, None, 0
        for j, pid in enumerate(table):
            if node is not None and (j + 1) * self.page_size <= clean:
                key = self._page_key(tokens, j)
                child = node.children.get(key)
                if child is None and pid not in self._tree:
                    # adopt: the table's reference becomes the tree's
                    child = _RadixNode(key=key, pid=pid, parent=node)
                    node.children[key] = child
                    self._tree[pid] = child
                    created += 1
                else:
                    # chain already cached (or page indexed elsewhere):
                    # this table's reference simply drops
                    self._decref(pid)
                node = child  # None breaks the chain for deeper pages
                last = child if child is not None else last
            else:
                node = None
                self._decref(pid)
        if last is not None:
            self._touch(last)
        self.donated_pages += created
        self._enforce_policy()
        return created

    def _decref(self, pid: int) -> None:
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)

    def _evictable(self, exclude: frozenset = frozenset()) -> int:
        """Pages reclaimable by cascading leaf eviction: a subtree is fully
        reclaimable iff every node in it holds only the tree's reference
        (table references pin whole root chains, so a pinned child implies
        a pinned parent — but grafted chains can pin a child under a free
        parent, hence the subtree walk). `exclude` pids count as pinned
        (an admission about to alias them must not plan to evict them)."""

        def rec(node: _RadixNode) -> Tuple[int, bool]:
            count, full = 0, True
            for child in node.children.values():
                c, f = rec(child)
                count += c
                full = full and f
            if node is self._root:
                return count, full
            if self._ref[node.pid] == 1 and node.pid not in exclude and full:
                return count + 1, True
            return count, False

        return rec(self._root)[0]

    def _evict_one(self) -> bool:
        """Reclaim the least-recently-used evictable leaf. Never touches a
        page any table references (refcount > 1)."""
        best = None
        for pid, node in self._tree.items():
            if not node.children and self._ref[pid] == 1:
                if best is None or node.tick < best.tick:
                    best = node
        if best is None:
            return False
        assert self._ref[best.pid] == 1, "evicting a table-referenced page"
        del best.parent.children[best.key]
        del self._tree[best.pid]
        self._ref[best.pid] = 0
        self._free.append(best.pid)
        self.evictions += 1
        return True

    def _enforce_policy(self) -> None:
        cap = self.policy.max_cached_pages
        while cap is not None and len(self._tree) > cap:
            if not self._evict_one():
                break
        while len(self._free) < self.policy.min_free_pages:
            if not self._evict_one():
                break

    # ---- admission ----
    def can_admit(self, reserve_tokens: int, *, shared_tokens: int = 0,
                  cached: Optional[PrefixMatch] = None) -> bool:
        """Would `admit` succeed? Shared full pages come from the parent
        (or the radix cache); the boundary page (if any) costs a fresh CoW
        page, everything past the shared prefix costs fresh pages, and
        LRU-retained cache pages count as available (eviction on demand)."""
        cost = self._admit_cost(reserve_tokens, shared_tokens, cached)
        if cost <= self.free_pages:  # common case: no tree walk
            return True
        exclude = frozenset(cached.pages) if cached is not None else frozenset()
        return cost <= self.free_pages + self._evictable(exclude)

    def _admit_cost(self, reserve_tokens: int, shared_tokens: int,
                    cached: Optional[PrefixMatch] = None) -> int:
        total = pages_for(reserve_tokens, self.page_size)
        if cached is not None:
            return total - len(cached.pages)
        full_shared = shared_tokens // self.page_size
        return total - full_shared  # boundary partial page needs its own copy

    def admit(
        self,
        seq: int,
        prompt_len: int,
        reserve_tokens: int,
        *,
        share_from: Optional[int] = None,
        shared_tokens: int = 0,
        cached: Optional[PrefixMatch] = None,
    ) -> List[CowCopy]:
        """Register `seq`, materialize pages covering `prompt_len`, reserve up
        to `reserve_tokens`. With `share_from`, the first `shared_tokens`
        positions alias the parent's pages (full pages by reference; the
        partial boundary page as an immediate CoW copy). With `cached` (a
        `match_prefix` result), the matched full pages are aliased out of
        the radix tree instead — no boundary copy, prefill starts at
        `cached.n_tokens`. Returns the device copies owed. Raises
        PageError when the pool cannot cover it."""
        if seq in self._tables:
            raise PageError(f"seq {seq} already admitted")
        if cached is not None and share_from is not None:
            raise PageError("cached= and share_from= are mutually exclusive")
        if shared_tokens and share_from is None:
            raise PageError("shared_tokens needs share_from")
        reserve_tokens = max(reserve_tokens, prompt_len)
        if shared_tokens > prompt_len:
            raise PageError("cannot share more than the prompt")
        if share_from is not None and shared_tokens > self._lens.get(share_from, -1):
            raise PageError("cannot share beyond the parent's length")
        if cached is not None:
            if cached.n_tokens >= max(prompt_len, 1):
                raise PageError("cached prefix must leave ≥ 1 token to prefill")
            for pid in cached.pages:  # revalidate against eviction races
                if pid not in self._tree:
                    raise PageError(f"stale prefix match: page {pid} evicted")
        if not self.can_admit(reserve_tokens, shared_tokens=shared_tokens,
                              cached=cached):
            raise PageError(
                f"pool exhausted: need"
                f" {self._admit_cost(reserve_tokens, shared_tokens, cached)}"
                f" pages, {self.free_pages} free"
                f" (+{self._evictable()} evictable)"
            )

        table: List[int] = []
        cows: List[CowCopy] = []
        if cached is not None:
            for pid in cached.pages:
                self._ref[pid] += 1
                table.append(pid)
            if cached.pages:
                self._touch(self._tree[cached.pages[-1]])
        elif share_from is not None:
            parent_tbl = self._tables[share_from]
            full_shared = shared_tokens // self.page_size
            for j in range(full_shared):
                pid = parent_tbl[j]
                self._ref[pid] += 1
                table.append(pid)
            if shared_tokens % self.page_size:
                # boundary page: child writes its tail into it → private copy
                dst = self._take_page()
                cows.append(CowCopy(src=parent_tbl[full_shared], dst=dst))
                table.append(dst)
        while len(table) < pages_for(prompt_len, self.page_size):
            table.append(self._take_page())
        self._tables[seq] = table
        self._lens[seq] = prompt_len
        self._reserved[seq] = pages_for(reserve_tokens, self.page_size) - len(table)
        return cows

    # ---- growth ----
    def extend(self, seq: int, new_len: int) -> List[CowCopy]:
        """Materialize pages so positions [len, new_len) are writable by
        `seq` alone: pages come from the reservation while it lasts, then
        the free pool (evicting LRU cache pages on demand); plus a private
        CoW copy of the current tail page if another sequence still
        references it. Raises PageError when the pool cannot cover the
        growth — the preemptible engines resolve that by victim selection.
        Returns the device copies owed."""
        if seq not in self._tables:
            raise PageError(f"seq {seq} not admitted")
        cur = self._lens[seq]
        if new_len <= cur:
            return []
        table = self._tables[seq]
        cows: List[CowCopy] = []
        # atomicity precheck: fail BEFORE mutating when the pool cannot
        # cover the whole growth (reservation + free + evictable), so a
        # failed extend leaves the allocator exactly as it was and the
        # preemptible engines can retry after victim selection
        first_page = cur // self.page_size
        need_cow = int(
            first_page < len(table) and self._ref[table[first_page]] > 1
        )
        need = need_cow + (pages_for(new_len, self.page_size) - len(table))
        avail = self._reserved.get(seq, 0) + self.free_pages
        if need > avail:  # count evictable only when actually short: the
            avail += self._evictable()  # tree walk is off the hot path
        if need > avail:
            raise PageError(
                f"page pool exhausted: growing seq {seq} to {new_len} needs"
                f" {need} pages, {avail} coverable"
            )
        # Defensive writer-side CoW. Unreachable through admit() (shared
        # pages always lie strictly below every owner's length — see the
        # module docstring), but a write into a shared page would silently
        # corrupt the sharer, so guard against future callers anyway. The
        # copy is charged to this seq's reservation when it has one, else
        # the free pool.
        if need_cow:
            dst = self._grow_page(seq)
            cows.append(CowCopy(src=table[first_page], dst=dst))
            self._decref(table[first_page])
            table[first_page] = dst
        need = pages_for(new_len, self.page_size)
        while len(table) < need:
            table.append(self._grow_page(seq))
        self._lens[seq] = new_len
        return cows

    def rollback(self, seq: int, new_len: int) -> int:
        """Speculative rollback — the inverse of `extend`. Truncate `seq`'s
        materialized length to `new_len`, dropping the table's references
        to every page wholly past the new boundary. Rejected-draft pages
        are *freed, never donated*: they hold KV for tokens that are not
        part of the committed stream, so indexing them in the radix tree
        would break the bytes-are-a-pure-function-of-the-token-stream
        invariant that prefix caching and the int8 slot-0 scale rule rely
        on (DESIGN.md §3.9).

        Pages this seq owned exclusively return to the pool *via its
        reservation* — rollback + re-extend is the speculative steady
        state, and crediting the reservation keeps the non-preemptive
        worst-case admission guarantee intact (the freed page cannot be
        claimed by a competing admission mid-flight). Returns the number
        of pages actually freed."""
        if seq not in self._tables:
            raise PageError(f"seq {seq} not admitted")
        cur = self._lens[seq]
        if new_len < 0 or new_len > cur:
            raise PageError(
                f"rollback target {new_len} outside [0, {cur}] for seq {seq}"
            )
        table = self._tables[seq]
        keep = pages_for(new_len, self.page_size)
        freed = 0
        for pid in table[keep:]:
            # dropped pages lie past the accepted length, which is ≥ the
            # shared/cached prompt prefix — they are never tree-indexed
            assert pid not in self._tree, "rolling back a cached page"
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                self._free.append(pid)
                self._reserved[seq] = self._reserved.get(seq, 0) + 1
                freed += 1
        del table[keep:]
        self._lens[seq] = new_len
        return freed

    def _grow_page(self, seq: int) -> int:
        """One growth page: reservation first, free pool after (optimistic
        per-chunk allocation past the reserve)."""
        if self._reserved.get(seq, 0) > 0:
            return self._take_page(from_reservation=seq)
        return self._take_page()

    def _take_page(self, from_reservation: Optional[int] = None) -> int:
        if from_reservation is not None:
            if self._reserved.get(from_reservation, 0) < 1:
                raise PageError(
                    f"seq {from_reservation} grew past its reservation"
                )
            self._reserved[from_reservation] -= 1
        elif self.free_pages < 1 and self._evictable() < 1:
            # (short-circuit keeps the tree walk off the common path)
            raise PageError("page pool exhausted")
        while not self._free:
            if not self._evict_one():
                raise PageError("page pool exhausted")
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    # ---- release ----
    def free(self, seq: int) -> None:
        """Release `seq`: decref its pages (exclusive ones return to the
        pool; pages a sharer or the radix tree still holds stay allocated)
        and drop its reservation. `donate` is the cache-aware variant."""
        table = self._tables.pop(seq)
        del self._lens[seq]
        self._reserved.pop(seq, None)
        for pid in table:
            self._decref(pid)

    def reset_live(self) -> int:
        """Crash-recovery sweep: release every live sequence (the engine
        could not retire them individually) while keeping the radix tree —
        and everything it has indexed — intact. Partial-page KV of the
        released sequences is simply dropped; tree-indexed full pages stay
        warm. Returns the number of sequences released."""
        seqs = list(self._tables)
        for seq in seqs:
            self.free(seq)
        return len(seqs)

    def cached_chains(self) -> List[List[int]]:
        """Root-to-leaf token chains indexed by the radix tree, each a flat
        token list (length a multiple of page_size). Leaves only — interior
        prefixes are implied. This is the cache's content in *token* space;
        `Engine.snapshot()/restore()` re-derives the KV pages from it,
        exactly, because FLASH-D's (O, Λ) state is a pure function of the
        token stream (DESIGN.md §3.7)."""
        out: List[List[int]] = []

        def rec(node: _RadixNode, toks: List[int]) -> None:
            if not node.children:
                if node is not self._root:
                    out.append(toks)
                return
            for key, child in node.children.items():
                rec(child, toks + list(key))

        rec(self._root, [])
        return out

    # ---- invariants (tests call this after every schedule step) ----
    def check(self, cache=None) -> None:
        """Assert every allocator invariant. With `cache` (the engine's
        device cache tree) the quantized pool's scale side-band is checked
        too — see `_check_scales`."""
        if cache is not None:
            self._check_scales(cache)
        assert self._ref[GARBAGE_PAGE] == 0, "garbage page must never be allocated"
        assert GARBAGE_PAGE not in self._free
        # Σ refcounts == table references + tree references
        tbl_counts = [0] * self.n_pages
        for table in self._tables.values():
            for pid in table:
                tbl_counts[pid] += 1
        counts = list(tbl_counts)
        for pid in self._tree:
            counts[pid] += 1
        assert counts == self._ref, f"refcount drift: {counts} vs {self._ref}"
        # free list holds exactly the zero-ref pages, each once
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "duplicate page in free list"
        for pid in range(1, self.n_pages):
            assert (self._ref[pid] == 0) == (pid in free_set)
        # radix tree: structure coherent, every node's page is live-or-LRU
        # (table-referenced XOR evictable), never on the free list
        assert GARBAGE_PAGE not in self._tree
        reachable: Dict[int, int] = {}  # pid → depth

        def walk(node: _RadixNode, depth: int) -> None:
            for key, child in node.children.items():
                assert child.parent is node and child.key == key
                assert child.pid not in reachable, "page in tree twice"
                assert len(key) == self.page_size, "non-full page in tree"
                reachable[child.pid] = depth
                walk(child, depth + 1)

        walk(self._root, 0)
        assert set(reachable) == set(self._tree), "tree index drift"
        for pid, node in self._tree.items():
            assert node.pid == pid
            assert self._ref[pid] >= 1, "tree page lost its tree reference"
            assert pid not in free_set
            # live (some table references it) XOR on the LRU side
            # (refcount 1 = the tree's own reference only) — checked
            # against the tables directly, independent of the refcounts
            assert (tbl_counts[pid] > 0) == (self._ref[pid] > 1), (
                f"tree page {pid} neither live nor LRU-consistent"
            )
        # the eviction planner can never reclaim a table-referenced page:
        # its cascade count is bounded by the pages no table holds (checked
        # against the tables directly, not the refcounts it walks)
        assert self._evictable() <= sum(
            1 for pid in self._tree if tbl_counts[pid] == 0
        )
        # every table covers exactly ceil(len / page) pages
        for seq, table in self._tables.items():
            assert len(table) == pages_for(self._lens[seq], self.page_size)
        # shared pages are read-only: every sequence referencing a page with
        # refcount > 1 — or any tree-indexed page — must be fully past it
        # (future writes land at positions ≥ len, so page j is write-free
        # iff (j+1)·page ≤ len) — and prefix sharing/chaining means it sits
        # at the same logical index in every referencing table
        owners: Dict[int, List[Tuple[int, int]]] = {}
        for seq, table in self._tables.items():
            for j, pid in enumerate(table):
                if self._ref[pid] > 1 or pid in self._tree:
                    assert (j + 1) * self.page_size <= self._lens[seq], (
                        f"seq {seq} can still write shared/cached page {pid}"
                    )
                    owners.setdefault(pid, []).append((seq, j))
        for pid, refs in owners.items():
            assert len({j for _, j in refs}) == 1, (
                f"page {pid} aliased at different logical indexes: {refs}"
            )
            if pid in self._tree:
                # chain depth == logical index (root children at depth 0)
                assert refs[0][1] == reachable[pid], (
                    f"page {pid} at table index {refs[0][1]} but tree depth"
                    f" {reachable[pid]}"
                )
        # reservations never exceed what the pool can actually produce
        assert sum(self._reserved.values()) <= len(self._free) + self._evictable()

    def _check_scales(self, cache) -> None:
        """Quantized-pool scale-side-band invariants (DESIGN.md §3.8).

        Scales are indexed by PHYSICAL page id, so a prefix-shared or
        tree-cached page has exactly one scale entry per head regardless
        of how many tables alias it — the aliasing is structural, and this
        check pins it: every scale leaf must span the pool's page axis
        (one row per physical page), and every in-use page's scales must
        be finite and positive (a page whose slot 0 was ever written gets
        a scale ≥ quant._EPS-derived; never-written pages hold the init
        value 1.0). A native (unquantized) cache has no scale leaves and
        passes vacuously."""
        import numpy as np  # lazy: this module is otherwise array-free

        def leaves(tree, name=None):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    yield from leaves(v, k)
            else:
                yield name, tree

        in_use = [pid for pid in range(self.n_pages) if self._ref[pid] > 0]
        for name, leaf in leaves(cache):
            if name not in ("k_scale", "v_scale"):
                continue
            arr = np.asarray(leaf.cpu() if hasattr(leaf, "cpu") else leaf)
            assert arr.shape[-2] == self.n_pages, (
                f"{name} page axis {arr.shape[-2]} != pool n_pages"
                f" {self.n_pages}"
            )
            used = arr[..., in_use, :]
            assert np.all(np.isfinite(used)), f"{name} has non-finite scales"
            assert np.all(used > 0), f"{name} has non-positive scales"
