# Copied from src/repro/serve/scheduler.py; keep the two in step.
"""Continuous-batching scheduler: admit / preempt / retire between steps.

The decode batch is a fixed set of ``max_batch`` *slots*.  Instead of
running a batch until its slowest member finishes (the phase-locked
``generate()`` loop), the scheduler refills slots the moment their
request retires, so the decode step stays full under mixed completion
lengths — the vLLM iteration-level scheduling model.

Decisions happen *between* decode steps, in :meth:`schedule`:

1. **extend** — every running request about to write into a fresh page
   gets one allocated; if the pool is dry, the most recently admitted
   running request is preempted (LIFO victim choice, vLLM-style) until
   the extension fits.
2. **admit** — FIFO over the waiting queue while free slots *and*
   enough pages for the whole prompt (plus the first decode write)
   exist.  Head-of-line blocking is deliberate: skipping ahead starves
   long prompts.

Preemption frees the victim's pages copy-free and re-queues it at the
*front* of the waiting queue.  Already-emitted tokens are never
retracted (they may have been streamed to a client): on re-admission
the engine recomputes KV for prompt + emitted tokens and resumes.

**Sharded pools**: with a :class:`~repro.serve.paged_cache.
ShardedBlockAllocator`, every request is *placed* on one shard at
admission — all of its pages come from that shard's free list and its
attention reads only that shard's pool slice.  Placement balances
**live slots per shard** (fewest running requests wins; ties break to
the shard with the most free pages) so decode work spreads across the
mesh instead of piling onto one device.  Pool-pressure preemption is
shard-local: only a victim on the starved request's own shard frees
pages that help, so the LIFO victim choice walks that shard's
admissions.  An unsharded allocator is the one-shard special case of
the same logic.
"""
from __future__ import annotations

import enum
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.serve.paged_cache import (BlockAllocator, PrefixKey, PrefixMatch,
                                     RECLAIMED)


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


_rid_counter = itertools.count()


@dataclass(eq=False)    # identity equality: lists of Requests use `is`
class Request:
    """One generation request plus its recorded per-token provenance."""

    prompt: np.ndarray               # [P] int32 token ids (no padding)
    max_new_tokens: int
    request_id: int = field(default_factory=lambda: next(_rid_counter))
    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None
    # Home shard of a placed request: all `blocks` are local ids on this
    # shard's pool slice (always 0 with an unsharded allocator).
    shard: Optional[int] = None
    blocks: List[int] = field(default_factory=list)
    # Per emitted token: id, behavior log-prob, producing policy version.
    tokens: List[int] = field(default_factory=list)
    log_beta: List[float] = field(default_factory=list)
    versions: List[int] = field(default_factory=list)
    submit_time: float = field(default_factory=time.monotonic)
    # When the request last entered the waiting queue (submit or
    # preemption re-queue): admission queue-wait is measured from here,
    # NOT from submit_time (which anchors TTFT).
    queued_time: float = field(default_factory=time.monotonic)
    first_token_time: Optional[float] = None   # admission latency probe
    last_emit_time: Optional[float] = None     # inter-token latency probe
    # Most recent admission wall-clock (set by the engine): splits TTFT
    # into queue-wait (submit -> admit) vs prefill-compute (admit ->
    # first token).  Re-admissions overwrite it, so a preempted-before-
    # first-token request books its earlier attempts as queue time.
    admit_time: Optional[float] = None
    finish_time: Optional[float] = None
    finish_reason: Optional[str] = None
    num_preemptions: int = 0
    # Prefix-cache bookkeeping, set at admission: how many leading
    # token rows are already resident (shared pages), and — when the
    # match ends mid-page — the source page whose leading `cow_rows`
    # rows the engine must copy into `blocks[num_shared_full]` before
    # its suffix prefill (copy-on-write; the source ref is held until
    # the copy lands).
    num_matched: int = 0
    num_shared_full: int = 0
    cow_src: Optional[Tuple[int, int]] = None   # (page, rows)
    # Chunked-prefill progress: KV rows computed so far (starts at
    # ``num_matched`` on admission) and whether the prefill has landed
    # in full.  A request with ``prefill_done == False`` holds its pages
    # but is not decode-eligible; the engine advances ``num_prefilled``
    # tile by tile and flips the flag when the last chunk lands (the
    # legacy one-dispatch prefill flips it immediately).
    num_prefilled: int = 0
    prefill_done: bool = True
    # Per-request wall-clock budget (seconds from submit_time); None
    # defers to the scheduler-wide default.  Enforced by expire().
    deadline_s: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def num_cached(self) -> int:
        """KV rows resident once (re)prefilled: prompt + all emitted
        tokens except the pending one (written by the next decode)."""
        return self.prompt_len + max(len(self.tokens) - 1, 0)


class ContinuousBatchingScheduler:
    """Slot/page bookkeeping for the serve engine's decode loop."""

    def __init__(
        self,
        allocator: BlockAllocator,
        *,
        max_batch: int,
        max_blocks_per_request: int,
        prefix_fn: Optional[Callable[[Request], PrefixKey]] = None,
        reclaim_window: Optional[int] = None,
        tracer: Tracer = NULL_TRACER,
        request_deadline_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[object] = None,
    ) -> None:
        self.allocator = allocator
        self.tracer = tracer
        self.max_batch = max_batch
        self.max_blocks_per_request = max_blocks_per_request
        # Content address of a request's committed ids (engine-provided,
        # version-salted).  None disables prefix matching at admission.
        self.prefix_fn = prefix_fn
        # Widest attention window across layers when EVERY layer is
        # windowed: pages entirely behind it are released back to the
        # pool each round.  None keeps all pages resident.
        self.reclaim_window = reclaim_window
        self.waiting: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self._admission_order: List[Request] = []   # oldest first
        self.preemptions = 0
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.prefix_matched_tokens = 0
        self.reclaimed_pages = 0
        # Per-request deadlines: default budget, injectable clock (tests
        # drive expiry deterministically), timeout bookkeeping.
        self.request_deadline_s = request_deadline_s
        self._clock = clock
        self.registry = registry
        self.timeouts = 0
        self.timeouts_by_state: dict = {}

    # -- introspection -------------------------------------------------------

    @property
    def running(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(
            r is not None for r in self.slots)

    # -- lifecycle -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        total = req.prompt_len + req.max_new_tokens
        cap = self.max_blocks_per_request * self.allocator.block_size
        if total > cap:
            raise ValueError(
                f"request {req.request_id} needs {total} token rows > "
                f"table capacity {cap}")
        # A request lives entirely on one shard, so the bound is the
        # per-shard slice (= the whole pool when unsharded).
        if self.allocator.blocks_for(total) > self.allocator.shard_num_blocks:
            raise ValueError(
                f"request {req.request_id} can never fit one pool shard "
                f"({total} rows > {self.allocator.shard_num_blocks} pages "
                f"x {self.allocator.block_size})")
        req.state = RequestState.WAITING
        req.queued_time = time.monotonic()
        self.waiting.append(req)
        tr = self.tracer
        if tr.enabled:
            tr.instant("submit", tid="scheduler", rid=req.request_id,
                       prompt_len=req.prompt_len,
                       max_new=req.max_new_tokens)
            tr.async_begin("waiting", req.request_id)

    def _release_all(self, req: Request) -> None:
        """Drop every page reference `req` holds (RECLAIMED sentinels
        were already released; a pending COW source ref too)."""
        shard = req.shard or 0
        if not req.prefill_done:
            self._abort_prefill(req, shard)
        self.allocator.release(
            [b for b in req.blocks if b != RECLAIMED], shard)
        if req.cow_src is not None:
            self.allocator.release([req.cow_src[0]], shard)
            req.cow_src = None
        req.blocks = []
        req.shard = None
        req.num_matched = 0
        req.num_shared_full = 0
        req.num_prefilled = 0

    def _abort_prefill(self, req: Request, shard: int) -> None:
        """A partially-prefilled request is going away.  Rows past its
        ``num_prefilled`` were never computed, so (a) the registered but
        not-yet-complete pages must leave the prefix index before any
        future admission can match their garbage rows, and (b) a running
        request that already shares one of them (it was gated waiting
        for those rows to land) must recompute from scratch.  Fires
        exactly once per prefill attempt — re-admission starts a new
        one.  Requests that already *started* computing against this
        chain only ever read rows the owner had finished, so they are
        untouched (their shared pages are disjoint from the bad set)."""
        req.prefill_done = True
        if self.prefix_fn is None or \
                not getattr(self.allocator, "prefix_cache", False):
            return
        bs = self.allocator.block_size
        bad = {b for j, b in enumerate(req.blocks)
               if b != RECLAIMED and (j + 1) * bs > req.num_prefilled}
        if not bad:
            return
        self.allocator.unregister(bad, shard)
        if self.tracer.enabled:
            self.tracer.instant(
                "prefill_abort", tid="scheduler", rid=req.request_id,
                prefilled=req.num_prefilled, pages=len(bad))
        for r in list(self.running):
            if r is req or (r.shard or 0) != shard:
                continue
            shared = set(r.blocks[:r.num_shared_full])
            if r.cow_src is not None:
                shared.add(r.cow_src[0])
            if shared & bad:
                self._preempt(r)

    def retire(self, req: Request, reason: str) -> None:
        """Finish a request: release its pages copy-free, free the slot.

        With prefix caching on, "release" only drops this request's
        references — pages other live block tables point at stay put,
        and registered pages park on the evictable LRU for future
        matches instead of returning to the free list outright.

        Idempotent: retiring an already-FINISHED request is a no-op, so
        a deadline expiry racing the engine's own finish path (or a
        preemption list naming a request a timeout just killed) can
        never double-release pages or double-decrement prefix-cache
        refcounts.
        """
        if req.state is RequestState.FINISHED:
            return
        was_running = req.state is RequestState.RUNNING
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.finish_time = time.monotonic()
        tr = self.tracer
        if tr.enabled:
            if was_running:
                tr.async_end("running", req.request_id)
            else:
                tr.async_end("waiting", req.request_id)
            tr.instant("retire", tid="scheduler", rid=req.request_id,
                       reason=reason, tokens=len(req.tokens),
                       state="running" if was_running else "waiting",
                       preemptions=req.num_preemptions)
        self._release_all(req)
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
        if req in self._admission_order:
            self._admission_order.remove(req)
        if req in self.waiting:
            self.waiting.remove(req)

    def expire(self, now: Optional[float] = None) -> List[Request]:
        """Retire every request past its deadline; returns them.

        A request's budget is ``deadline_s`` (or the scheduler default)
        seconds of wall clock from ``submit_time`` — preemptions do not
        reset it (the user has been waiting the whole time).  Expired
        RUNNING requests release their slot + pages/refcounts through
        the one :meth:`retire` path; expired WAITING requests leave the
        queue before they can be admitted.  The engine turns each into
        a (possibly empty) ``finish_reason="timeout"`` trajectory.
        """
        candidates = [
            r for r in list(self.waiting) + self.running
            if (r.deadline_s if r.deadline_s is not None
                else self.request_deadline_s) is not None
        ]
        if not candidates:
            return []
        if now is None:
            now = self._clock()
        expired: List[Request] = []
        for req in candidates:
            budget = (req.deadline_s if req.deadline_s is not None
                      else self.request_deadline_s)
            if now - req.submit_time <= budget:
                continue
            state = req.state.value
            self.retire(req, "timeout")
            self.timeouts += 1
            self.timeouts_by_state[state] = (
                self.timeouts_by_state.get(state, 0) + 1)
            if self.registry is not None:
                self.registry.counter(
                    "request_timeout_total", state=state).inc()
            expired.append(req)
        return expired

    def _preempt(self, victim: Request) -> None:
        if victim.state is RequestState.FINISHED:
            return    # lost the race against a timeout retirement
        self.preemptions += 1
        victim.num_preemptions += 1
        tr = self.tracer
        if tr.enabled:
            tr.async_end("running", victim.request_id)
            tr.instant("preempt", tid="scheduler",
                       rid=victim.request_id, shard=victim.shard or 0,
                       tokens=len(victim.tokens))
            tr.async_begin("waiting", victim.request_id)
        self._release_all(victim)
        if victim.slot is not None:
            self.slots[victim.slot] = None
            victim.slot = None
        self._admission_order.remove(victim)
        victim.state = RequestState.WAITING
        victim.queued_time = time.monotonic()
        self.waiting.appendleft(victim)

    # -- shard placement ------------------------------------------------------

    def _live_slots_by_shard(self) -> List[int]:
        live = [0] * self.allocator.num_shards
        for r in self.running:
            live[r.shard or 0] += 1
        return live

    def _place(self, total: int,
               matches: Optional[List[PrefixMatch]] = None
               ) -> Optional[int]:
        """Home shard for an admission needing `total` pages, or None.

        The shard holding the **longest resident prefix match** wins
        (page ids are shard-local, so a match is only usable on its own
        shard); then fewest live slots (decode work balances across the
        mesh); ties break to the most free pages, then the lowest shard
        id.  Single-shard allocators always place on shard 0, so the
        unsharded scheduler is unchanged.
        """
        live = self._live_slots_by_shard()
        best = None
        for s in range(self.allocator.num_shards):
            m = matches[s] if matches else PrefixMatch()
            # Fresh pages to pop, plus revivals: sharing a zero-ref
            # cached page pulls it off the evictable LRU, shrinking
            # allocatable capacity by one just like a fresh pop.
            need = total - len(m.full_pages)
            for p in m.full_pages:
                if self.allocator.ref(p, s) == 0:
                    need += 1
            if m.cow_page is not None and \
                    self.allocator.ref(m.cow_page, s) == 0:
                need += 1
            if not self.allocator.can_allocate(need, s):
                continue
            key = (-m.matched_tokens, live[s],
                   -self.allocator.shard_free(s), s)
            if best is None or key < best[0]:
                best = (key, s)
        return None if best is None else best[1]

    # -- the per-step decision -----------------------------------------------

    def _rows_needed(self, req: Request, lookahead: int) -> int:
        """KV rows `req` must own to run `lookahead` decode writes.

        Capped at the request's lifetime row count (prompt + budget):
        a request never writes its final emitted token's row.
        """
        writes = min(lookahead, req.max_new_tokens - len(req.tokens) + 1)
        return min(req.num_cached + max(writes, 1),
                   req.prompt_len + req.max_new_tokens)

    def schedule(self, lookahead: int = 1
                 ) -> Tuple[List[Request], List[Request]]:
        """Returns (admitted, preempted) for the next decode round.

        Admitted requests need a (re)prefill before the round;
        preempted ones have left their slots.  Every request still
        running after this call owns pages for its next `lookahead` KV
        writes (the engine's multi-step decode chunk runs that many
        steps without a scheduling point).
        """
        preempted: List[Request] = []

        # 0. Window reclamation: when every layer's attention is
        # windowed, KV rows at positions <= q - W are masked for all
        # future queries q' >= q, so pages entirely behind the widest
        # window can go back to the pool.  The table entry becomes a
        # RECLAIMED sentinel (later pages keep their positional slots;
        # padded_table maps it to page 0, whose garbage the window mask
        # hides).
        if self.reclaim_window is not None:
            bs = self.allocator.block_size
            for req in self.running:
                # A mid-prefill request's oldest *future* query sits at
                # num_prefilled, not num_cached — reclaim only behind it.
                rows = (req.num_cached if req.prefill_done
                        else req.num_prefilled)
                horizon = rows - self.reclaim_window
                for j, b in enumerate(req.blocks):
                    if (j + 1) * bs - 1 > horizon:
                        break
                    if b == RECLAIMED:
                        continue
                    self.allocator.release([b], req.shard or 0)
                    req.blocks[j] = RECLAIMED
                    self.reclaimed_pages += 1

        # 1. Extend running requests that cross a page boundary.  Pool
        # pressure is per-shard: only a victim on the same shard frees
        # pages the starved request can use, so the LIFO choice walks
        # that shard's admissions (the whole pool when unsharded).
        for req in list(self._admission_order):
            if req.slot is None:
                continue
            shard = req.shard or 0
            need = (
                self.allocator.blocks_for(self._rows_needed(req, lookahead))
                - len(req.blocks)
            )
            while need > 0 and not self.allocator.can_allocate(need, shard):
                victim = next(
                    r for r in reversed(self._admission_order)
                    if (r.shard or 0) == shard)
                self._preempt(victim)
                preempted.append(victim)
                if victim is req:
                    need = 0    # preempted itself; nothing to extend
            if need > 0:
                req.blocks.extend(self.allocator.allocate(need, shard))

        # 2. Admit from the waiting queue into free slots (FIFO), placing
        # each admission on its home shard — preferring the shard that
        # holds the longest resident prefix of its committed ids, whose
        # pages it then shares (refcount bump) instead of recomputing.
        admitted: List[Request] = []
        while self.waiting:
            free_slots = [i for i, r in enumerate(self.slots) if r is None]
            if not free_slots:
                break
            req = self.waiting[0]
            total = self.allocator.blocks_for(
                self._rows_needed(req, lookahead))
            key, matches = self._match(req)
            shard = self._place(total, matches)
            if shard is None:
                break
            self.waiting.popleft()
            req.shard = shard
            self._commit_match(req, key,
                               matches[shard] if matches else None,
                               total, shard)
            req.num_prefilled = req.num_matched
            req.slot = free_slots[0]
            req.state = RequestState.RUNNING
            self.slots[req.slot] = req
            self._admission_order.append(req)
            admitted.append(req)
            tr = self.tracer
            if tr.enabled:
                tr.async_end("waiting", req.request_id)
                tr.async_begin("running", req.request_id,
                               slot=req.slot, shard=shard,
                               matched=req.num_matched)
        return admitted, preempted

    # -- prefix matching at admission -----------------------------------------

    def _match(self, req: Request
               ) -> Tuple[Optional[PrefixKey],
                          Optional[List[PrefixMatch]]]:
        """Per-shard resident-prefix matches for `req`, or (None, None)
        when prefix caching is off.  At least one token is always left
        to compute — the admission must produce a logit to sample."""
        if self.prefix_fn is None or \
                not getattr(self.allocator, "prefix_cache", False):
            return None, None
        key = self.prefix_fn(req)
        limit = req.num_cached - 1
        self.prefix_queries += 1
        return key, [self.allocator.lookup(key, limit, s)
                     for s in range(self.allocator.num_shards)]

    def _commit_match(self, req: Request, key: Optional[PrefixKey],
                      match: Optional[PrefixMatch], total: int,
                      shard: int) -> None:
        """Build `req.blocks`: shared matched pages first (pinned before
        any allocation can evict them), then fresh pages; reserve the
        COW source and index the fresh pages for future admissions."""
        if match is None:
            req.blocks = self.allocator.allocate(total, shard)
            return
        for p in match.full_pages:
            self.allocator.share(p, shard)
        if match.cow_page is not None and match.cow_rows > 0:
            self.allocator.share(match.cow_page, shard)
            req.cow_src = (match.cow_page, match.cow_rows)
        fresh = self.allocator.allocate(
            total - len(match.full_pages), shard)
        req.blocks = list(match.full_pages) + fresh
        req.num_shared_full = len(match.full_pages)
        req.num_matched = match.matched_tokens
        if match.matched_tokens > 0:
            self.prefix_hits += 1
            self.prefix_matched_tokens += match.matched_tokens
        if key is not None:
            self.allocator.register(key, req.blocks,
                                    len(match.full_pages), shard)
