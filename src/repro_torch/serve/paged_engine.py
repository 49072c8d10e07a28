"""Paged serving: block-granular KV storage behind the ladder-locked loop
(the port of the global-pool half of ``repro/serve/paged_engine.py``).

* **Flat page pool** (:class:`PagedKVCache`): KV lives in
  ``(L, num_pages + 1, page_size, Hkv, hd)`` tensors shared by all
  requests; page ``num_pages`` is the *sink* that absorbs the masked
  writes of released rows and holes.  A request holds exactly the pages
  its sequence occupies.
* **Per-slot page table**: a fixed ``(max_slots, max_pages_per_slot)``
  int32 device tensor from logical sequence blocks to physical pages.
  Admission maps ``ceil(padded_prompt / page_size)`` pages and copies
  the prefilled cache in with one in-place ``index_copy_`` per pool;
  decode appends a page only when a row's position crosses a boundary;
  release returns the pages and points the row at the sink.
* **Refcounted prefix sharing (copy-on-write)**, on by default: two
  requests whose token prefixes agree through a page boundary map the
  same physical page; a holder about to write a shared page first gets
  a private copy.  The engine keys sharing on a host-side registry of
  page-aligned token prefixes, purged as pages drain.
* **Reservation-based admission**: a request reserves its worst-case
  page count at admission, so lazy boundary mapping never finds the
  free list empty and the ladder sweep never targets a rung the pool
  cannot back.
* **int8 pools** (``kv_quant="int8"``): ``pk``/``pv`` hold int8 values
  and ``pk_s``/``pv_s`` one bf16 scale per (page, offset, KV head) cell,
  about half the bytes of bf16 pools.  Admission quantizes the prefilled
  chunks as it copies them in, decode quantizes each new K/V as it
  writes it, with the same numerics (:func:`repro_torch.kernels.
  paged_attn.quantize_page_pool`), so admitted and decoded cells
  dequantize identically.  A prefill parked by co-execution backfill
  stays at model precision until its admission copies it in.  The dense
  engines' ``CACHE_QUANT`` flag is refused, as the reference does.

Decode writes the new K/V into the pool in place and attends through K2
(:func:`repro_torch.models.attention.paged_attn_decode_step`).  The
reference's sliding-window page rings, recurrent slabs and cross pages
are later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attn import quantize_page_pool
from repro_torch.models.attention import CACHE_QUANT
from repro_torch.models.transformer import param_dtype
from repro_torch.serve.engine import effective_tokens, Request
from repro_torch.serve.serve_step import make_paged_decode_step
from repro_torch.serve.slot_engine import SlotServeEngine

POOL_QUANTS = (None, "int8")


class PagedKVCache:
    """Flat global page pools + per-slot page table + a refcounting,
    reservation-based page allocator.  Pools are allocated once, at
    construction; the allocator's bookkeeping is host-side."""

    def __init__(self, max_slots: int, num_pages: int, page_size: int,
                 max_pages_per_slot: int, *, n_layers: int, n_kv_heads: int,
                 head_dim: int, dtype: torch.dtype, device: torch.device,
                 quant: Optional[str] = None):
        if num_pages < max_pages_per_slot:
            raise ValueError(
                f"pool of {num_pages} pages cannot hold one full-length "
                f"request ({max_pages_per_slot} pages)")
        self.max_slots = max_slots
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        if quant not in POOL_QUANTS:
            raise ValueError(f"quant={quant!r} not in {POOL_QUANTS}")
        self.device = device
        self.quant = quant
        self.sink = num_pages                      # physical sink page id
        shape = (n_layers, num_pages + 1, page_size, n_kv_heads, head_dim)
        vals = torch.int8 if quant else dtype
        self.pools = {"pk": torch.zeros(shape, dtype=vals, device=device),
                      "pv": torch.zeros(shape, dtype=vals, device=device)}
        if quant:
            plane = shape[:-1] + (1,)
            self.pools.update(
                pk_s=torch.zeros(plane, dtype=torch.bfloat16, device=device),
                pv_s=torch.zeros(plane, dtype=torch.bfloat16, device=device))
        self.table = torch.full((max_slots, max_pages_per_slot), self.sink,
                                dtype=torch.int32, device=device)
        self._reset_allocator()

    def _reset_allocator(self) -> None:
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._free_pages = list(range(self.num_pages - 1, -1, -1))  # pop->lowest
        self._mapped: List[List[int]] = [[] for _ in range(self.max_slots)]
        self._reserved = [0] * self.max_slots
        self._shared = [0] * self.max_slots        # pages mapped by ref
        self._refcount = [0] * self.num_pages
        self._owner: List[Optional[int]] = [None] * self.num_pages
        self._orphaned = 0                         # refcount>0, no owner
        self.reserved_total = 0

    # -- slot free list ---------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def n_free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def orphaned_pages(self) -> int:
        """Occupied pages charged to no live reservation (their owner
        released while sharers still hold them)."""
        return self._orphaned

    def acquire(self) -> int:
        """Claim the lowest free slot (keeps the ladder rung minimal)."""
        return self._free_slots.pop()

    def can_reserve(self, n_pages: int) -> bool:
        """True iff the pool can still back ``n_pages`` worst-case
        exclusive pages on top of every live reservation and every
        orphaned page."""
        return (self.num_pages - self.reserved_total - self._orphaned
                >= n_pages)

    def mapped_pages(self, slot: int) -> List[int]:
        return list(self._mapped[slot])

    def page_refcount(self, page: int) -> int:
        return self._refcount[page]

    def _write_row(self, slot: int, start: int, pages: Sequence[int]) -> None:
        self.table[slot, start:start + len(pages)] = torch.as_tensor(
            pages, dtype=torch.int32).to(self.device)

    # -- page lifecycle -----------------------------------------------------
    def admit(self, prefill_cache: Dict[str, torch.Tensor], slot: int,
              reserve_pages: int, shared_pages: Sequence[int] = ()) -> int:
        """Map a prefilled cache ``{"k","v": (L, 1, S, Hkv, hd)}`` (S a
        page multiple) into ``slot`` and reserve its worst case.  The
        first ``len(shared_pages)`` logical pages are mapped by
        reference (the caller guarantees their content equals the
        prefill's leading chunks); the rest are copied into fresh pages.
        Returns the number of fresh pages mapped."""
        k, v = prefill_cache["k"], prefill_cache["v"]
        n_layers, _, cap = k.shape[:3]
        if cap % self.page_size:
            raise ValueError(f"prefill cache capacity {cap} is not a "
                             f"multiple of page_size {self.page_size}")
        n = cap // self.page_size
        if n > self.max_pages_per_slot:
            raise ValueError(f"prompt needs {n} pages > max_pages_per_slot "
                             f"{self.max_pages_per_slot}")
        shared = list(shared_pages)
        n_fresh = n - len(shared)
        if n_fresh < 0:
            raise ValueError(f"{len(shared)} shared pages exceed the "
                             f"prompt's {n} pages")
        for pg in shared:
            if self._refcount[pg] < 1:
                raise ValueError(f"shared page {pg} is not live")
        if reserve_pages < n_fresh or not self.can_reserve(reserve_pages):
            raise ValueError(
                f"cannot reserve {reserve_pages} pages (fresh now: "
                f"{n_fresh}, unreserved: "
                f"{self.num_pages - self.reserved_total - self._orphaned})")
        fresh = [self._free_pages.pop() for _ in range(n_fresh)]
        for pg in shared:
            self._refcount[pg] += 1
        for pg in fresh:
            self._refcount[pg] = 1
            self._owner[pg] = slot
        if fresh:
            idx = torch.as_tensor(fresh, device=self.device)
            for name, src in (("pk", k), ("pv", v)):
                chunks = src[:, 0].reshape(n_layers, n, self.page_size,
                                           *src.shape[3:])[:, len(shared):]
                if self.quant:
                    # Quantized as decode quantizes its writes (the
                    # reference's _quantize_pool_tree at admission).
                    chunks, scale = quantize_page_pool(chunks)
                    self.pools[name + "_s"].index_copy_(1, idx, scale)
                self.pools[name].index_copy_(1, idx, chunks)
        pages = shared + fresh
        if pages:
            self._write_row(slot, 0, pages)
        self._mapped[slot] = pages
        self._shared[slot] = len(shared)
        self._reserved[slot] = reserve_pages
        self.reserved_total += reserve_pages
        return n_fresh

    def ensure_capacity(self, slot: int, last_pos: int) -> int:
        """Map pages so ``slot`` can write through ``last_pos`` (within
        its reservation by construction).  Returns pages appended."""
        need = last_pos // self.page_size + 1
        have = len(self._mapped[slot])
        if need <= have:
            return 0
        if need > self._reserved[slot] + self._shared[slot]:
            raise AssertionError(
                f"slot {slot} needs {need} pages beyond its reservation "
                f"of {self._reserved[slot]} (+{self._shared[slot]} shared)"
                " — admission under-reserved")
        pages = [self._free_pages.pop() for _ in range(need - have)]
        for pg in pages:
            self._refcount[pg] = 1
            self._owner[pg] = slot
        self._write_row(slot, have, pages)
        self._mapped[slot].extend(pages)
        return len(pages)

    def make_writable(self, slot: int, logical_idx: int) -> bool:
        """Copy-on-write: give ``slot`` a private copy of its logical
        page ``logical_idx`` if it is shared (refcount > 1).  Grows the
        slot's reservation by the private page (and orphans the original
        if this slot owned it).  Returns True iff a copy was made."""
        pg = self._mapped[slot][logical_idx]
        if self._refcount[pg] <= 1:
            return False
        own = self._owner[pg] == slot
        if not self.can_reserve(2 if own else 1):
            raise ValueError(
                f"cannot copy-on-write page {pg}: pool exhausted")
        new = self._free_pages.pop()
        self._refcount[pg] -= 1
        self._refcount[new] = 1
        self._owner[new] = slot
        self._reserved[slot] += 1
        self.reserved_total += 1
        if own:
            self._owner[pg] = None
            self._orphaned += 1
        else:
            self._shared[slot] -= 1
        for pool in self.pools.values():
            pool[:, new] = pool[:, pg]
        self._write_row(slot, logical_idx, [new])
        self._mapped[slot][logical_idx] = new
        return True

    def ensure_writable(self, slot: int, first_pos: int,
                        last_pos: int) -> int:
        """Copy-on-write every shared page overlapping positions
        ``[first_pos, last_pos]`` of ``slot``; returns pages copied."""
        cows = 0
        first = first_pos // self.page_size
        last = min(last_pos // self.page_size, len(self._mapped[slot]) - 1)
        for j in range(first, last + 1):
            cows += bool(self.make_writable(slot, j))
        return cows

    def release(self, slot: int) -> List[int]:
        """Release ``slot``'s pages (a shared page is freed only when its
        last holder releases) and point its table row at the sink.
        Returns the pages actually freed."""
        freed = []
        for pg in self._mapped[slot]:
            self._refcount[pg] -= 1
            own = self._owner[pg]
            if own == slot:
                self._owner[pg] = None
                if self._refcount[pg] > 0:
                    self._orphaned += 1
            if self._refcount[pg] == 0:
                if own != slot:        # orphaned page just drained
                    self._orphaned -= 1
                freed.append(pg)
                self._free_pages.append(pg)
        self._free_pages.sort(reverse=True)
        self._mapped[slot] = []
        self.reserved_total -= self._reserved[slot]
        self._reserved[slot] = 0
        self._shared[slot] = 0
        self.table[slot] = self.sink
        self._free_slots.append(slot)
        self._free_slots.sort(reverse=True)
        return freed

    def tables(self) -> Dict[str, torch.Tensor]:
        return {"global": self.table}

    def seize_pages(self, n: int) -> List[int]:
        """Fault injection: pull up to ``n`` free pages out of
        circulation under a ghost reservation, so ``can_reserve`` and
        the engine's ``_admit_cap`` see real pool pressure and the free
        list cannot underflow (the seizure is bounded by the unreserved
        headroom, never by the free count alone).  Returns the seized
        pages; :meth:`restore_pages` reverses the fault."""
        headroom = self.num_pages - self.reserved_total - self._orphaned
        take = max(0, min(n, headroom, len(self._free_pages)))
        seized = [self._free_pages.pop() for _ in range(take)]
        self.reserved_total += take
        return seized

    def restore_pages(self, pages: Sequence[int]) -> None:
        """Heal a :meth:`seize_pages` fault: drop the ghost reservation
        and return the pages to the free list (lowest popped next)."""
        self._free_pages.extend(pages)
        self._free_pages.sort(reverse=True)
        self.reserved_total -= len(pages)

    def reset(self) -> None:
        """Free every slot and page; the pools (and their stale content,
        never attended) are kept."""
        self._reset_allocator()
        self.table.fill_(self.sink)

    def resident_bytes(self) -> int:
        """Bytes of persistent paged storage: pools (sink included; int8
        pools with their scale planes) and the page table."""
        return (sum(p.numel() * p.element_size() for p in self.pools.values())
                + self.table.numel() * self.table.element_size())


class PagedServeEngine(SlotServeEngine):
    """Ladder-locked serving over block-granular paged KV storage:
    global layers hold their sequence's pages, with page-aligned common
    prompt prefixes shared copy-on-write (``prefix_sharing``, default
    on).  ``num_pages`` sizes the pool; the default matches a dense
    engine's ``max_batch * max_seq`` capacity."""

    def __init__(self, cfg: ModelConfig, params, *, device,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 max_batch: int = 8, max_seq: int = 256,
                 kv_quant: Optional[str] = None,
                 prefix_sharing: bool = True, **kw):
        if CACHE_QUANT["enabled"]:
            raise NotImplementedError(
                "paged storage quantizes at the pool boundary "
                "(kv_quant='int8'), not via the dense CACHE_QUANT flag")
        if kv_quant not in POOL_QUANTS:
            raise ValueError(f"kv_quant={kv_quant!r} not in {POOL_QUANTS}")
        if page_size < 1 or page_size > max_seq:
            raise ValueError(f"page_size {page_size} not in [1, {max_seq}]")
        self.page_size = page_size
        self.kv_quant = kv_quant
        self.prefix_sharing = prefix_sharing
        self.max_pages_per_slot = -(-max_seq // page_size)
        self.num_pages = (num_pages if num_pages is not None
                          else max_batch * self.max_pages_per_slot)
        # token-prefix bytes -> physical page, and its reverse (purged
        # when pages drain back to the free list).
        self._prefix_registry: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        super().__init__(cfg, params, device=device, max_batch=max_batch,
                         max_seq=max_seq, **kw)
        # Page-aligned prefill caches are a storage invariant: an
        # exact-length prefill cache cannot be copied into whole pages.
        if not self._bucket_enabled:
            raise ValueError(
                "PagedServeEngine requires bucketed prefill (page-aligned "
                "cache capacities); buckets='off' cannot be paged")

    # -- storage/decode hooks -------------------------------------------
    def _stats_extras(self) -> dict:
        extras = super()._stats_extras()
        extras.update({"page_admits": 0, "page_grows": 0,
                       "pages_mapped_peak": 0,
                       "pages_shared": 0, "page_cows": 0,
                       "pool_pages": self.num_pages,
                       "kv_pool": self.kv_quant or "f32"})
        return extras

    def _prefill_cache_len(self) -> Optional[int]:
        # The prefilled cache capacity equals the padded prompt length
        # (a page multiple), so admission maps ceil(prompt / page) pages.
        return None

    def _default_decode_fn(self):
        return make_paged_decode_step(self.cfg)

    def _make_cache(self):
        cfg = self.cfg
        return PagedKVCache(self.max_batch, self.num_pages, self.page_size,
                            self.max_pages_per_slot, n_layers=cfg.n_layers,
                            n_kv_heads=cfg.n_kv_heads,
                            head_dim=cfg.resolved_head_dim,
                            dtype=param_dtype(self.params),
                            device=self.device, quant=self.kv_quant)

    def _bucket_len(self, s: int) -> Optional[int]:
        # Page-multiple buckets: admission maps exactly
        # ceil(prompt / page_size) pages, never pages of pad K/V.
        if s > self._bucket_cap:
            return None
        return -(-max(s, 1) // self.page_size) * self.page_size

    def reset(self) -> None:
        super().reset()
        self._prefix_registry.clear()
        self._page_key.clear()

    # -- page accounting ----------------------------------------------------
    def _pages_for(self, req: Request) -> int:
        """Worst-case pages for ``req``: padded (effective) prompt plus
        its remaining decode budget, clamped to the ``max_seq`` stop
        rule.  A preempted request's effective prompt grew by exactly
        what its budget shrank, so resume reserves the same worst case."""
        k = len(req.generated)
        s = len(req.prompt) + max(k - 1, 0)
        blen = self._bucket_len(s) or s
        budget = max(1, req.max_new_tokens - max(k, 1))
        last = min(max(blen - 1, s + budget - 1), self.max_seq - 1)
        return last // self.page_size + 1

    def _probe_shared(self, req: Request) -> List[int]:
        """Physical pages for the longest chain of ``req``'s page-aligned
        token prefixes already resident (causality makes a page's
        content a pure function of the token prefix through it)."""
        if not self.prefix_sharing:
            return []
        toks = effective_tokens(req)
        shared: List[int] = []
        for j in range(len(toks) // self.page_size):
            key = toks[:(j + 1) * self.page_size].tobytes()
            pg = self._prefix_registry.get(key)
            if pg is None:
                break
            if (self.cache.page_refcount(pg) < 1
                    or self._page_key.get(pg) != key):
                # Stale hit: drop the entry rather than alias a free or
                # foreign page into this request.
                self._prefix_registry.pop(key, None)
                if self._page_key.get(pg) == key:
                    self._page_key.pop(pg, None)
                break
            shared.append(pg)
        return shared

    def _admit_cap(self) -> Optional[int]:
        """Live rows plus the prefix of waiting requests (backfilled
        first) whose worst-case reservations still fit the pool."""
        cap = self._n_active()
        rem = (self.cache.num_pages - self.cache.reserved_total
               - self.cache.orphaned_pages)
        waiting = [r for r, _, _ in self._backfilled] + list(self.queue)
        for req in waiting:
            if cap >= self.max_batch:
                break
            need = self._pages_for(req) - len(self._probe_shared(req))
            if need > rem:
                break
            cap += 1
            rem -= need
        return cap

    def _can_admit(self, req: Request) -> bool:
        return self.cache.can_reserve(self._pages_for(req)
                                      - len(self._probe_shared(req)))

    def _store_cache(self, req: Request, cache, slot: int) -> None:
        shared = self._probe_shared(req)
        fresh = self.cache.admit(cache, slot,
                                 self._pages_for(req) - len(shared),
                                 shared_pages=shared)
        ext = self.stats["engine"]
        ext["page_admits"] += fresh
        ext["pages_shared"] += len(shared)
        self._note_pages_peak()
        if self.prefix_sharing:
            # Register this prompt's full pages (keys always form prefix
            # chains, so a shared page's chain is already resident).
            toks = effective_tokens(req)
            pages = self.cache.mapped_pages(slot)
            for j in range(len(toks) // self.page_size):
                key = toks[:(j + 1) * self.page_size].tobytes()
                if key not in self._prefix_registry:
                    self._prefix_registry[key] = pages[j]
                    self._page_key[pages[j]] = key

    def _release_slot(self, slot: int) -> None:
        for pg in self.cache.release(slot):
            key = self._page_key.pop(pg, None)
            if key is not None:
                self._prefix_registry.pop(key, None)

    def _note_pages_peak(self) -> None:
        mapped = self.cache.num_pages - self.cache.n_free_pages
        if mapped > self.stats["engine"]["pages_mapped_peak"]:
            self.stats["engine"]["pages_mapped_peak"] = mapped

    # -- window over the page pool ----------------------------------------
    def _window_call(self, rung: int, toks, pos, budget):
        # Map the pages this window can write (within each admission's
        # reservation by construction) and copy any shared page a row is
        # about to write (never in the serve flow: sharing covers full
        # prompt pages only).
        ext = self.stats["engine"]
        for slot in range(rung):
            if self._req[slot] is None:
                continue
            b = int(self._budget[slot])
            if b <= 0:
                continue
            first = int(self._pos[slot])
            last = min(first + min(self.window, b) - 1, self.max_seq - 1)
            ext["page_grows"] += self.cache.ensure_capacity(slot, last)
            ext["page_cows"] += self.cache.ensure_writable(slot, first, last)
        self._note_pages_peak()
        tables = {k: t[:rung] for k, t in self.cache.tables().items()}
        return self._decode_window(
            lambda t, p: self.decode_fn(self.params, self.cache.pools,
                                        tables, t, p)[0],
            toks, pos, budget, rung=rung)
