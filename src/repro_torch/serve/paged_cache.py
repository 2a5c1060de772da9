# Copied from src/repro/serve/paged_cache.py; keep the two in step.
"""Free-list block allocator + prefix cache for the pooled (paged) KV cache.

The device-side pool (``models.transformer.init_paged_cache``) is a
fixed set of ``num_blocks`` pages of ``block_size`` token rows each;
this module owns *which request holds which pages*.  Allocation pops
page ids off a free list and release pushes them back — freeing a
finished request is O(pages) pointer work with **zero cache copies**
(the rows are simply never referenced again; the next owner overwrites
them).

Page ids are plain ints; per-request block tables (ordered page lists)
live on the :class:`repro.serve.scheduler.Request`.  The table rows the
kernel sees must pad unused slots with an *in-range* id (0): the paged
attention index map fetches skipped pages too.  A negative table entry
(:data:`RECLAIMED`) marks a page released early by window reclamation —
``padded_table`` maps it to page 0 and the attention window mask hides
whatever garbage lives there.

**Prefix caching** (``prefix_cache=True``): pages become refcounted and
content-addressed.  A page's identity is a *chain hash* — blake2b over
its own token ids chained onto the previous page's hash and a salt
(policy version + arch identity), so a hash match certifies the entire
prefix up to and including that page.  :class:`PrefixIndex` maps

* chain hash → page id, for **full** pages (shared outright: a new
  admission's block table points at them, refcount bumped), and
* chain hash of the *preceding* pages → ``(page, token tuple)`` tail
  entries, for **partially matching** pages: the longest common token
  prefix is shared via copy-on-write (the engine copies the matched
  rows into a fresh page before appending its divergent suffix).

Release decrements refcounts; a registered page whose refcount hits
zero parks on an **evictable LRU** (content intact, hash entries live)
instead of the free list, so later admissions can still match it.
Allocation claims free pages first and evicts LRU cached pages only
under pressure — eviction drops the page's index entries.  Counting
``num_free = free + evictable`` keeps scheduler capacity math and the
"all pages returned" test invariants identical to the uncached
allocator.

**Sharded pools**: under a mesh, the pool's NB axis is partitioned over
the ``data`` axis and :class:`ShardedBlockAllocator` keeps one free
list *per shard*.  A request's pages all come from ONE shard (its home
shard — the scheduler picks it at admission), and the page ids handed
out are **shard-local** (``0 .. num_blocks/num_shards - 1``): they
index the shard's local pool slice, which is exactly what the
``shard_map``-dispatched kernels see.  Prefix indices are per-shard for
the same reason — a shared page is only addressable from its own
shard's pool slice, so the scheduler prefers placing an admission on
the shard holding its longest match.  Both allocator classes expose the
same shard-aware API; :class:`BlockAllocator` is the ``num_shards ==
1`` case where local and global ids coincide.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import (Deque, Dict, Iterable, List, Optional, Sequence, Tuple)

import numpy as np

from repro_torch.obs.tracer import NULL_TRACER, Tracer

# Block-table sentinel: a page released early (window reclamation) but
# whose table position must survive so later pages keep their offsets.
RECLAIMED = -1

# At most this many divergent tails are indexed per chain position;
# beyond it new tails simply go unregistered (they still run, unshared).
_MAX_TAILS_PER_CHAIN = 8


class OutOfBlocks(RuntimeError):
    """Allocation request exceeds the free pool (caller should preempt)."""


# -- content addressing -------------------------------------------------------


def _digest(prev: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


@dataclass(frozen=True)
class PrefixKey:
    """Content address of one request's committed token ids.

    ``chain[j]`` hashes pages ``0..j`` (salt-seeded, so a policy-weight
    swap or arch change invalidates every entry without a flush);
    ``pages[j]`` holds page ``j``'s token tuple and ``tail`` whatever
    ids spill past the last full page.  Built once per (version,
    length) by :func:`prefix_key`.
    """

    block_size: int
    root: bytes                         # H(salt): chain seed / empty-chain key
    chain: Tuple[bytes, ...]            # per full page, cumulative
    pages: Tuple[Tuple[int, ...], ...]  # token ids per full page
    tail: Tuple[int, ...]               # ids past the last full page

    def chain_before(self, j: int) -> bytes:
        """Index key for tails extending the first ``j`` full pages."""
        return self.root if j == 0 else self.chain[j - 1]


def prefix_key(ids: np.ndarray, block_size: int, salt: bytes) -> PrefixKey:
    ids = np.asarray(ids, np.int32)
    root = hashlib.blake2b(salt, digest_size=16).digest()
    n_full = len(ids) // block_size
    chain: List[bytes] = []
    pages: List[Tuple[int, ...]] = []
    prev = root
    for j in range(n_full):
        toks = tuple(int(t) for t in ids[j * block_size:(j + 1) * block_size])
        prev = _digest(prev, toks)
        chain.append(prev)
        pages.append(toks)
    tail = tuple(int(t) for t in ids[n_full * block_size:])
    return PrefixKey(block_size, root, tuple(chain), tuple(pages), tail)


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixIndex:
    """Hash → resident page map for one pool shard."""

    def __init__(self) -> None:
        self._full: Dict[bytes, int] = {}
        # chain-before key -> [(page, token tuple)], newest last
        self._tails: Dict[bytes, List[Tuple[int, Tuple[int, ...]]]] = {}
        # reverse map so eviction can drop a page's entries in O(entries)
        self._by_page: Dict[int, List[Tuple[str, bytes]]] = {}

    def __len__(self) -> int:
        return len(self._full) + sum(len(v) for v in self._tails.values())

    def register_full(self, page: int, chain_hash: bytes) -> None:
        if chain_hash in self._full:
            return              # first registration wins; content identical
        self._full[chain_hash] = page
        self._by_page.setdefault(page, []).append(("full", chain_hash))

    def register_tail(self, page: int, chain_before: bytes,
                      tokens: Tuple[int, ...]) -> None:
        if not tokens:
            return
        bucket = self._tails.setdefault(chain_before, [])
        if len(bucket) >= _MAX_TAILS_PER_CHAIN:
            return
        if any(p == page or t == tokens for p, t in bucket):
            return
        bucket.append((page, tokens))
        self._by_page.setdefault(page, []).append(("tail", chain_before))

    def drop_page(self, page: int) -> None:
        for kind, k in self._by_page.pop(page, []):
            if kind == "full":
                if self._full.get(k) == page:
                    del self._full[k]
            else:
                bucket = self._tails.get(k)
                if bucket is not None:
                    bucket[:] = [e for e in bucket if e[0] != page]
                    if not bucket:
                        del self._tails[k]

    def lookup_full(self, chain_hash: bytes) -> Optional[int]:
        return self._full.get(chain_hash)

    def lookup_tail(self, chain_before: bytes, tokens: Sequence[int],
                    budget: int) -> Tuple[Optional[int], int]:
        """Longest token-prefix tail match under ``chain_before``,
        capped at ``budget`` rows.  Returns ``(page, rows)``."""
        best_page, best_m = None, 0
        for page, toks in self._tails.get(chain_before, []):
            m = min(_common_prefix(tokens, toks), budget)
            if m > best_m:
                best_page, best_m = page, m
        return best_page, best_m


@dataclass
class PrefixMatch:
    """Resident-prefix match for one admission, on one shard."""

    matched_tokens: int = 0
    full_pages: List[int] = field(default_factory=list)  # share outright
    cow_page: Optional[int] = None      # partially matched source page
    cow_rows: int = 0                   # leading rows of cow_page to copy


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` KV pages."""

    num_shards = 1

    def __init__(self, num_blocks: int, block_size: int, *,
                 prefix_cache: bool = False,
                 tracer: Tracer = NULL_TRACER,
                 shard_id: int = 0) -> None:
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need positive pool, got {num_blocks}x{block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        self.tracer = tracer
        self.shard_id = shard_id
        # FIFO reuse spreads writes across the pool, which keeps stale
        # rows cold and makes use-after-free bugs loud in tests.
        self._free: Deque[int] = deque(range(num_blocks))
        self._refs: List[int] = [0] * num_blocks
        # zero-ref pages still registered in the index, LRU order
        # (oldest first); allocation evicts from here only after the
        # plain free list runs dry.
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self._index = PrefixIndex() if prefix_cache else None
        self.evictions = 0

    # -- capacity -------------------------------------------------------------

    @property
    def num_free(self) -> int:
        """Allocatable pages: truly free + evictable cached."""
        return len(self._free) + len(self._evictable)

    @property
    def num_cached(self) -> int:
        """Zero-ref pages kept resident for prefix matching."""
        return len(self._evictable)

    @property
    def num_indexed(self) -> int:
        return 0 if self._index is None else len(self._index)

    @property
    def shard_num_blocks(self) -> int:
        """Pages per shard (= the whole pool when unsharded)."""
        return self.num_blocks

    def shard_free(self, shard: int = 0) -> int:
        return self.num_free

    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to hold `n_tokens` rows."""
        return -(-n_tokens // self.block_size)

    def can_allocate(self, n: int, shard: int = 0) -> bool:
        return n <= self.num_free

    # -- allocate / share / release -------------------------------------------

    def allocate(self, n: int, shard: int = 0) -> List[int]:
        """Pop `n` page ids; raises :class:`OutOfBlocks` when short.

        Free pages go first; under pressure, least-recently-parked
        cached pages are evicted (their index entries dropped)."""
        if n > self.num_free:
            raise OutOfBlocks(
                f"asked for {n} pages, {self.num_free} free "
                f"(pool {self.num_blocks})")
        out: List[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.popleft()
            else:
                b, _ = self._evictable.popitem(last=False)
                if self._index is not None:
                    self._index.drop_page(b)
                self.evictions += 1
                if self.tracer.enabled:
                    self.tracer.instant(
                        "cache_evict", tid="pool", page=b,
                        shard=self.shard_id)
            self._refs[b] = 1
            out.append(b)
        return out

    def share(self, page: int, shard: int = 0) -> int:
        """Add one reference to a resident page (reviving it from the
        evictable LRU if parked there).  Returns the page id."""
        self._check_page(page)
        if page in self._evictable:
            del self._evictable[page]
            assert self._refs[page] == 0
            self._refs[page] = 1
        elif self._refs[page] > 0:
            self._refs[page] += 1
        else:
            raise ValueError(f"page {page} is free; cannot share")
        return page

    def ref(self, page: int, shard: int = 0) -> int:
        self._check_page(page)
        return self._refs[page]

    def _check_page(self, b: int) -> None:
        if not (0 <= b < self.num_blocks):
            raise ValueError(
                f"page id {b} out of range [0, {self.num_blocks})")

    def release(self, blocks: Iterable[int], shard: int = 0) -> None:
        """Drop one reference per page (copy-free: no cache data moves).

        Double-frees and out-of-range ids raise — a silently corrupted
        free list would hand the same page to two requests."""
        for b in blocks:
            b = int(b)
            self._check_page(b)
            if self._refs[b] <= 0:
                raise ValueError(
                    f"double free of page {b} (refcount already 0)")
            self._refs[b] -= 1
            if self._refs[b] > 0:
                continue
            if self._index is not None and b in self._index._by_page:
                self._evictable[b] = None   # keep resident for matching
            else:
                self._free.append(b)

    # -- prefix index ---------------------------------------------------------

    def lookup(self, key: PrefixKey, limit: int,
               shard: int = 0) -> PrefixMatch:
        """Longest resident prefix of ``key``, at most ``limit`` tokens.

        Callers pass ``limit = len(ids) - 1`` so at least one token is
        always computed (the admission needs a logit to sample from).
        """
        m = PrefixMatch()
        if self._index is None or limit <= 0:
            return m
        bs = self.block_size
        for j in range(min(len(key.chain), limit // bs)):
            page = self._index.lookup_full(key.chain[j])
            if page is None:
                break
            m.full_pages.append(page)
        j = len(m.full_pages)
        if j < len(key.chain):
            next_tokens: Sequence[int] = key.pages[j]
        else:
            next_tokens = key.tail
        budget = min(limit - j * bs, bs)
        page, rows = self._index.lookup_tail(
            key.chain_before(j), next_tokens, budget)
        if page is not None and rows == bs:
            # The tail covers the whole page: share it outright, no COW.
            m.full_pages.append(page)
            j += 1
        elif page is not None:
            m.cow_page, m.cow_rows = page, rows
        m.matched_tokens = j * bs + m.cow_rows
        return m

    def register(self, key: PrefixKey, blocks: List[int],
                 n_matched_full: int, shard: int = 0) -> None:
        """Index an admission's *fresh* pages (matched ones already are).

        Every fresh full page registers under its chain hash and, so
        future admissions can diverge mid-page, also as a tail of the
        chain before it; a non-empty tail registers the page holding it.
        """
        if self._index is None:
            return
        for j in range(n_matched_full, len(key.chain)):
            self._index.register_full(blocks[j], key.chain[j])
            self._index.register_tail(
                blocks[j], key.chain_before(j), key.pages[j])
        if key.tail and len(key.chain) < len(blocks):
            self._index.register_tail(
                blocks[len(key.chain)], key.chain_before(len(key.chain)),
                key.tail)

    def unregister(self, pages: Iterable[int], shard: int = 0) -> None:
        """Drop the index entries of specific pages (their content stays
        put; references are untouched).  Used when a chunked prefill
        aborts mid-flight: the request's registered-but-never-computed
        pages must stop matching future admissions."""
        if self._index is None:
            return
        for b in pages:
            b = int(b)
            self._check_page(b)
            self._index.drop_page(b)
            # A page already parked on the evictable LRU with no index
            # entries left can never match again — free it outright.
            if b in self._evictable:
                del self._evictable[b]
                self._free.append(b)

    def flush(self, shard: Optional[int] = None) -> None:
        """Drop every index entry; evictable pages return to the free
        list.  (Unused on weight swaps — the version salt already
        invalidates stale entries — but handy for tests/tools.)"""
        if self._index is None:
            return
        for b in list(self._evictable):
            self._free.append(b)
        self._evictable.clear()
        self._index = PrefixIndex()

    # -- tables ---------------------------------------------------------------

    def padded_table(self, blocks: List[int], width: int) -> np.ndarray:
        """[width] int32 table row; unused slots and RECLAIMED entries
        pad with page 0 (the kernel's index map requires in-range ids
        everywhere; reclaimed positions are window-masked anyway)."""
        if len(blocks) > width:
            raise ValueError(
                f"request owns {len(blocks)} pages > table width {width}")
        row = np.zeros((width,), np.int32)
        row[: len(blocks)] = [b if b >= 0 else 0 for b in blocks]
        return row


class ShardedBlockAllocator:
    """Per-shard free lists over an NB-partitioned pool.

    ``num_blocks`` is the *total* pool; each of the ``num_shards``
    shards owns ``num_blocks / num_shards`` pages addressed by
    shard-local ids.  Placement (which shard a request lives on) is the
    scheduler's call; every allocate/release/lookup names the shard.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 num_shards: int, *, prefix_cache: bool = False,
                 tracer: Tracer = NULL_TRACER) -> None:
        if num_shards < 1:
            raise ValueError(f"need >= 1 shard, got {num_shards}")
        if num_blocks % num_shards != 0:
            raise ValueError(
                f"num_blocks {num_blocks} must divide over "
                f"{num_shards} shards")
        self.num_shards = num_shards
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        self.tracer = tracer
        self._shards = [
            BlockAllocator(num_blocks // num_shards, block_size,
                           prefix_cache=prefix_cache, tracer=tracer,
                           shard_id=s)
            for s in range(num_shards)
        ]

    @property
    def num_free(self) -> int:
        return sum(s.num_free for s in self._shards)

    @property
    def num_cached(self) -> int:
        return sum(s.num_cached for s in self._shards)

    @property
    def evictions(self) -> int:
        return sum(s.evictions for s in self._shards)

    @property
    def shard_num_blocks(self) -> int:
        return self.num_blocks // self.num_shards

    def shard_free(self, shard: int = 0) -> int:
        return self._shards[shard].num_free

    def free_by_shard(self) -> List[int]:
        return [s.num_free for s in self._shards]

    def blocks_for(self, n_tokens: int) -> int:
        return self._shards[0].blocks_for(n_tokens)

    def can_allocate(self, n: int, shard: int = 0) -> bool:
        return self._shards[shard].can_allocate(n)

    def allocate(self, n: int, shard: int = 0) -> List[int]:
        """Pop `n` *shard-local* page ids off `shard`'s free list."""
        return self._shards[shard].allocate(n)

    def share(self, page: int, shard: int = 0) -> int:
        return self._shards[shard].share(page)

    def ref(self, page: int, shard: int = 0) -> int:
        return self._shards[shard].ref(page)

    def release(self, blocks: Iterable[int], shard: int = 0) -> None:
        self._shards[shard].release(blocks)

    def lookup(self, key: PrefixKey, limit: int,
               shard: int = 0) -> PrefixMatch:
        return self._shards[shard].lookup(key, limit)

    def register(self, key: PrefixKey, blocks: List[int],
                 n_matched_full: int, shard: int = 0) -> None:
        self._shards[shard].register(key, blocks, n_matched_full)

    def unregister(self, pages: Iterable[int], shard: int = 0) -> None:
        self._shards[shard].unregister(pages)

    def flush(self, shard: Optional[int] = None) -> None:
        for i, s in enumerate(self._shards):
            if shard is None or shard == i:
                s.flush()

    def padded_table(self, blocks: List[int], width: int) -> np.ndarray:
        return self._shards[0].padded_table(blocks, width)


def make_allocator(num_blocks: int, block_size: int,
                   num_shards: int = 1, *, prefix_cache: bool = False,
                   tracer: Tracer = NULL_TRACER):
    """Allocator for an ``num_shards``-way partitioned pool (1 = plain)."""
    if num_shards <= 1:
        return BlockAllocator(num_blocks, block_size,
                              prefix_cache=prefix_cache, tracer=tracer)
    return ShardedBlockAllocator(num_blocks, block_size, num_shards,
                                 prefix_cache=prefix_cache, tracer=tracer)
