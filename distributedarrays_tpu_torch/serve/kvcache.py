"""Paged KV cache: per-sequence attention state as resident DArray pages.

PyTorch counterpart of ``distributedarrays_tpu/serve/kvcache.py`` (its
whole ``__all__``).  The decode service's working set is the KV cache:
per-sequence key/value rows that grow one token at a time.  It is held as
registered DArrays, so every byte is in the memory ledger (created inside
the ``serve.kv`` span) and every page is re-laid onto the survivors by
``resilience.elastic`` on a shrink, like any other array.

- Storage is a pool of **page blocks**: DArrays of shape ``(block_pages,
  2, page_tokens, heads, head_dim)`` (dim 1 = K/V) from ``dzeros``, split
  over the page dim across the live ranks (``procs`` and ``dist`` as JAX's
  ``_grow_locked``), so each page lies whole on one rank.  Blocks are made
  on demand and **reaped** (closed) when fully free, so the ledger's
  live bytes follow real cache use.  ``KVCacheConfig.dtype`` is a torch
  dtype (``torch.float32`` by default).
- A **page** is ``page_tokens`` K and V rows of one sequence; a sequence
  owns an ordered page table of ``(block, slot)`` ids.  :meth:`write` is a
  region write (``d[slot, 0, a:b] = k``) that touches the owner rank's
  tensor only.  :meth:`read` takes each page's rows straight from the
  owning rank's tensor (a view when the page lies in one chunk, kept with
  its block until a shrink re-lays the block; else the region copied out
  of the chunks that hold it) and concatenates them on
  **the device of the rank that owns the sequence's first page**: with
  every rank on one card that is the card; across cards the other pages
  are copied to it, and the decode step computes there.  Nothing builds
  the whole block.
- **Backpressure**: allocation first evicts idle (unpinned,
  least-recently-used) sequences when the pool or the memory budget is
  short; when eviction cannot cover the request the caller gets a typed
  :class:`~.errors.Overloaded` (``reason="kv"``) with a ``retry_after``.
  Eviction frees the pages and keeps the sequence's identity: the engine
  re-prefills it (K/V are a pure function of the token history, so the
  rebuild is bit-identical).
- ``idle_evictable_bytes()`` is the admission controller's reclaimable
  signal.

Telemetry: ``serve.kv.pages_live/pages_free/seqs/bytes`` gauges,
``serve.kv.evictions/blocks_created/blocks_reaped/sheds`` counters.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import torch

from .. import layout as L
from .. import telemetry as _tm
from ..darray import as_tensor, dzeros
from ..resilience import elastic
from .errors import Overloaded, Rejected, ServeError

__all__ = ["KVCacheConfig", "PagedKVCache"]


@dataclasses.dataclass
class KVCacheConfig:
    """Paged-cache knobs.  ``hbm_budget_bytes`` bounds the whole ledger
    (weights, cache and payloads), as the admission gate's signal does;
    ``None`` turns budget-driven eviction off (the pool bound still
    applies)."""

    page_tokens: int = 16             # K/V rows per page
    heads: int = 4
    head_dim: int = 8
    dtype: Any = torch.float32
    max_pages: int = 256              # hard pool bound (all blocks)
    block_pages: int = 8              # pages per DArray block (alloc granule)
    hbm_budget_bytes: int | None = None
    hbm_evict_fraction: float = 0.9   # evict when live >= fraction * budget
    retry_after_s: float = 0.05       # shipped when eviction cannot cover


@dataclasses.dataclass
class _Block:
    """One pool DArray of ``block_pages`` pages; ``free`` holds its unused
    slots, ``views`` each page's view into its owner rank's tensor, taken
    from the rank tensors ``parts`` (dropped when a shrink re-lays the
    block out)."""

    d: Any
    free: set[int]
    views: dict = dataclasses.field(default_factory=dict)
    parts: Any = None


@dataclasses.dataclass
class _Seq:
    """Per-sequence record: the page table and the LRU/pin state the
    eviction policy reads."""

    seq_id: int
    tenant: str
    pages: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    ntok: int = 0                     # K/V rows written so far
    last_use: float = 0.0
    pinned: bool = False              # in-flight dispatch: never evicted


class PagedKVCache:
    """Fixed-size KV pages as resident DArray state.

    Thread-safe; never calls out of module under its lock (eviction
    returns the evicted sequence ids to the caller instead of invoking
    callbacks, so the engine's lock order stays engine -> cache)."""

    def __init__(self, config: KVCacheConfig | None = None):
        self.config = config or KVCacheConfig()
        c = self.config
        if c.page_tokens <= 0 or c.block_pages <= 0 or c.max_pages <= 0:
            raise ValueError("page_tokens, block_pages and max_pages must "
                             "be positive")
        self._blocks: dict[int, _Block] = {}
        self._next_block = 0
        self._free: list[tuple[int, int]] = []   # (block_id, slot)
        self._seqs: dict[int, _Seq] = {}
        self._lock = threading.RLock()
        self._closed = False
        self.evictions = 0

    # -- geometry ----------------------------------------------------------

    @property
    def page_nbytes(self) -> int:
        c = self.config
        item = torch.empty(0, dtype=c.dtype).element_size()
        return 2 * c.page_tokens * c.heads * c.head_dim * item

    def pages_for(self, ntok: int) -> int:
        """Pages needed to hold ``ntok`` K/V rows."""
        return max(1, -(-int(ntok) // self.config.page_tokens))

    def capacity_pages(self) -> int:
        return self.config.max_pages

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            live = sum(len(s.pages) for s in self._seqs.values())
            return {
                "seqs": len(self._seqs),
                "pages_live": live,
                "pages_free": len(self._free),
                "blocks": len(self._blocks),
                "bytes_live": live * self.page_nbytes,
                "evictions": self.evictions,
            }

    def live_bytes(self) -> int:
        """Nominal bytes held by allocated pages (the policy's number; the
        ledger also counts the free pages of live blocks)."""
        with self._lock:
            return sum(len(s.pages) for s in self._seqs.values()) \
                * self.page_nbytes

    def idle_evictable_bytes(self) -> int:
        """Bytes a shed could reclaim right now: pages of idle (unpinned)
        sequences plus fully free blocks awaiting reap (the admission
        controller's ``reclaimable_fn``)."""
        with self._lock:
            pages = sum(len(s.pages) for s in self._seqs.values()
                        if not s.pinned)
            free_block_pages = sum(
                len(b.free) for b in self._blocks.values()
                if len(b.free) == self.config.block_pages)
            return (pages + free_block_pages) * self.page_nbytes

    # -- gauges ------------------------------------------------------------

    def _gauges_locked(self) -> None:
        if not _tm.enabled():
            return
        live = sum(len(s.pages) for s in self._seqs.values())
        _tm.set_gauge("serve.kv.pages_live", live)
        _tm.set_gauge("serve.kv.pages_free", len(self._free))
        _tm.set_gauge("serve.kv.seqs", len(self._seqs))
        _tm.set_gauge("serve.kv.bytes", live * self.page_nbytes)

    # -- pool management ---------------------------------------------------

    def _grow_locked(self) -> bool:
        """Make one more page block if the pool bound and the memory budget
        allow, inside a ``serve.kv`` span so the ledger attributes its
        bytes to the cache."""
        c = self.config
        total = len(self._blocks) * c.block_pages
        if total + c.block_pages > c.max_pages:
            return False
        if c.hbm_budget_bytes is not None:
            block_bytes = c.block_pages * self.page_nbytes
            bound = c.hbm_evict_fraction * c.hbm_budget_bytes
            if _tm.memory.live_bytes() + block_bytes > bound:
                return False
        ranks = elastic.manager().live_ranks()
        n = max(1, min(len(ranks), c.block_pages))
        with _tm.span("serve.kv", op="alloc_block",
                      pages=c.block_pages):
            d = dzeros((c.block_pages, 2, c.page_tokens, c.heads,
                        c.head_dim), dtype=c.dtype,
                       procs=ranks[:n], dist=[n, 1, 1, 1, 1])
        bid = self._next_block
        self._next_block += 1
        self._blocks[bid] = _Block(d=d, free=set(range(c.block_pages)))
        self._free.extend((bid, s) for s in range(c.block_pages))
        _tm.count("serve.kv.blocks_created")
        return True

    def _reap_locked(self) -> None:
        """Close fully free blocks so the ledger drains with use."""
        for bid in [b for b, blk in self._blocks.items()
                    if len(blk.free) == self.config.block_pages]:
            blk = self._blocks.pop(bid)
            self._free = [(b, s) for (b, s) in self._free if b != bid]
            blk.d.close()
            _tm.count("serve.kv.blocks_reaped")

    def _budget_pressure_locked(self) -> bool:
        c = self.config
        if c.hbm_budget_bytes is None:
            return False
        return _tm.memory.live_bytes() >= \
            c.hbm_evict_fraction * c.hbm_budget_bytes

    def _evict_lru_locked(self) -> int | None:
        """Evict the least-recently-used unpinned sequence; returns its id
        (pages freed, record dropped) or None when none is evictable."""
        victims = [s for s in self._seqs.values()
                   if not s.pinned and s.pages]
        if not victims:
            return None
        v = min(victims, key=lambda s: s.last_use)
        for bid, slot in v.pages:
            blk = self._blocks.get(bid)
            if blk is not None:
                blk.free.add(slot)
                self._free.append((bid, slot))
        del self._seqs[v.seq_id]
        self.evictions += 1
        _tm.count("serve.kv.evictions", tenant=v.tenant)
        return v.seq_id

    def maybe_evict(self) -> list[int]:
        """Budget-driven eviction sweep: while the ledger sits over the
        eviction fraction of the budget, evict idle sequences LRU-first
        and reap freed blocks.  Returns the evicted ids (the engine
        re-queues them for re-prefill)."""
        evicted: list[int] = []
        with self._lock:
            while self._budget_pressure_locked():
                sid = self._evict_lru_locked()
                if sid is None:
                    break
                evicted.append(sid)
                self._reap_locked()
            if evicted:
                self._gauges_locked()
        return evicted

    # -- sequence lifecycle ------------------------------------------------

    def ensure(self, seq_id: int, ntok: int, *,
               tenant: str = "default") -> list[int]:
        """Grow ``seq_id``'s page table to cover ``ntok`` rows, allocating
        (and evicting idle sequences, LRU-first) as needed.  Returns the
        ids of sequences evicted to make room.  Raises
        :class:`Overloaded` (``reason="kv"``) when the demand cannot be
        covered even after evicting every idle sequence, and
        :class:`Rejected` when the pool can never hold it."""
        if self.pages_for(ntok) > self.config.max_pages:
            raise Rejected(
                f"sequence needs {self.pages_for(ntok)} pages; the pool "
                f"holds {self.config.max_pages} at its hard bound",
                reason="kv", tenant=tenant)
        with self._lock:
            if self._closed:
                raise ServeError("kv cache is closed")
            seq = self._seqs.get(seq_id)
            if seq is None:
                seq = self._seqs[seq_id] = _Seq(seq_id=seq_id,
                                                tenant=tenant)
            seq.last_use = time.monotonic()
            need = self.pages_for(ntok) - len(seq.pages)
            if need <= 0:
                return []
            evicted: list[int] = []
            was_pinned = seq.pinned
            seq.pinned = True      # never LRU-evict the seq being grown
            try:
                while len(self._free) < need:
                    if self._grow_locked():
                        continue
                    sid = self._evict_lru_locked()
                    if sid is None:
                        _tm.count("serve.kv.sheds", tenant=tenant)
                        self._gauges_locked()
                        raise Overloaded(
                            f"kv cache exhausted: need {need} pages for "
                            f"seq {seq_id}, {len(self._free)} free of "
                            f"{self.config.max_pages} max; retry in "
                            f"{self.config.retry_after_s:.3f}s",
                            retry_after=self.config.retry_after_s,
                            reason="kv", tenant=tenant)
                    evicted.append(sid)
            finally:
                seq.pinned = was_pinned
            for _ in range(need):
                bid, slot = self._free.pop()
                self._blocks[bid].free.discard(slot)
                seq.pages.append((bid, slot))
            self._gauges_locked()
            return evicted

    def write(self, seq_id: int, start: int, k, v) -> None:
        """Write K/V rows for tokens ``[start, start + n)`` of ``seq_id``
        (``k``/``v``: ``(n, heads, head_dim)`` arrays or tensors).  Pages
        must already be ensured; each page's rows are a region write into
        the owning rank's tensor."""
        k, v = as_tensor(k), as_tensor(v)
        n = k.shape[0]
        pt = self.config.page_tokens
        moved: dict = {}

        def on(x, dev):                  # one copy a device, not a page
            key = (id(x), dev)
            if key not in moved:
                moved[key] = x.to(dev)
            return moved[key]

        with self._lock:
            seq = self._seqs.get(seq_id)
            if seq is None:
                raise ServeError(f"unknown kv sequence {seq_id}")
            if self.pages_for(start + n) > len(seq.pages):
                raise ServeError(
                    f"seq {seq_id}: write [{start}, {start + n}) exceeds "
                    f"{len(seq.pages)} ensured pages")
            off = 0
            while off < n:
                tok = start + off
                page, po = divmod(tok, pt)
                take = min(n - off, pt - po)
                bid, slot = seq.pages[page]
                d = self._blocks[bid].d
                dev = L.device_of(int(d.pids[d.locate(slot, 0, 0, 0, 0)]))
                d[slot, 0, po:po + take] = on(k, dev)[off:off + take]
                d[slot, 1, po:po + take] = on(v, dev)[off:off + take]
                off += take
            seq.ntok = max(seq.ntok, start + n)
            seq.last_use = time.monotonic()

    @staticmethod
    def _page(blk: _Block, slot: int) -> torch.Tensor:
        """Page ``slot`` of a block as a (2, page_tokens, heads, head_dim)
        tensor: a view of the owning rank's tensor when the page lies in
        one chunk (kept for the next read), else copied out of the chunks
        that hold it."""
        d = blk.d
        if blk.parts is not d._parts:        # new tensors after a shrink
            blk.views.clear()
            blk.parts = d._parts
        v = blk.views.get(slot)
        if v is not None:
            return v
        ci = d.locate(slot, 0, 0, 0, 0)
        idx = d.indices[ci]
        if all(len(r) == n for r, n in zip(idx[1:], d.dims[1:])):
            v = blk.views[slot] = d.part(ci)[slot - idx[0].start]
            return v
        dev = L.device_of(int(d.pids[ci]))
        return d.region([(slot, slot + 1)] + [(0, n) for n in d.dims[1:]],
                        dev)[0]

    def read(self, seq_id: int):
        """``seq_id``'s resident K/V as ``(ntok, heads, head_dim)`` tensors
        on the device of the rank that owns its first page (the decode
        step's contiguous view), gathered page by page from the owning
        ranks' tensors."""
        with self._lock:
            seq = self._seqs.get(seq_id)
            if seq is None:
                raise ServeError(f"unknown kv sequence {seq_id}")
            pages = [self._page(self._blocks[bid], slot)
                     for bid, slot in seq.pages]
            seq.last_use = time.monotonic()
            ntok = seq.ntok
            dev = pages[0].device
            # concatenated under the lock: a page freed after it could be
            # handed to another sequence and overwritten
            kv = torch.cat([p.to(dev) for p in pages], dim=1)
        return kv[0, :ntok], kv[1, :ntok]

    def ntok(self, seq_id: int) -> int:
        with self._lock:
            seq = self._seqs.get(seq_id)
            return 0 if seq is None else seq.ntok

    def has(self, seq_id: int) -> bool:
        with self._lock:
            return seq_id in self._seqs

    def pin(self, seq_id: int) -> None:
        """Exclude ``seq_id`` from eviction (in-flight dispatch)."""
        with self._lock:
            seq = self._seqs.get(seq_id)
            if seq is not None:
                seq.pinned = True

    def unpin(self, seq_id: int) -> None:
        with self._lock:
            seq = self._seqs.get(seq_id)
            if seq is not None:
                seq.pinned = False
                seq.last_use = time.monotonic()

    def release(self, seq_id: int) -> None:
        """Free ``seq_id``'s pages (completion or cancellation) and reap any
        block the release emptied: a cancellation returns the memory at
        once, not at the next sweep."""
        with self._lock:
            seq = self._seqs.pop(seq_id, None)
            if seq is None:
                return
            for bid, slot in seq.pages:
                blk = self._blocks.get(bid)
                if blk is not None:
                    blk.free.add(slot)
                    self._free.append((bid, slot))
            self._reap_locked()
            self._gauges_locked()

    def close(self) -> None:
        """Release every sequence and close every block DArray (the
        cache's ledger bytes drain to zero)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._seqs.clear()
            self._free.clear()
            for blk in self._blocks.values():
                blk.d.close()
            self._blocks.clear()
            self._gauges_locked()

    def __enter__(self) -> "PagedKVCache":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
