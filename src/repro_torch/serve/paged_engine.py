"""Paged serving: block-granular KV storage behind the ladder-locked loop
(the port of ``repro/serve/paged_engine.py``).

* **Flat page pool** (:class:`PagedKVCache`): global layers' KV lives in
  ``(L_attn, num_pages + 1, page_size, Hkv, hd)`` tensors shared by all
  requests; page ``num_pages`` is the *sink* that absorbs the masked
  writes of released rows and holes.  A request holds exactly the pages
  its sequence occupies.
* **Per-slot page table**: a fixed ``(max_slots, max_pages_per_slot)``
  int32 device tensor from logical sequence blocks to physical pages.
  Admission maps ``ceil(padded_prompt / page_size)`` pages and copies
  the prefilled cache in with one in-place ``index_copy_`` per pool;
  decode appends a page only when a row's position crosses a boundary;
  release returns the pages and points the row at the sink.
* **Page rings for sliding-window layers**: a ``LOCAL`` layer never
  reads more than its window, so each slot maps one fixed ring of ``R =
  ceil((w + window_tokens) / page_size) + 1`` pages (``w =
  min(sliding_window, max_seq)``) of a local pool ``(L_local,
  num_local_pages + 1, page_size, Hkv, hd)`` through a ``(max_slots, R)``
  ring table: block ``b`` lives at column ``b % R``.  At every window
  boundary :meth:`PagedKVCache.advance_ring` frees each column whose
  block fell behind the window to the back of a FIFO free list and
  maps it again from the front, so a slot holds ``R`` local pages
  however long it decodes (``stats["engine"]["window_pages_reclaimed"]``
  counts the swaps).
* **Recurrent-state slabs**: RG-LRU (``"h","conv"``) and RWKV6
  (``"state","shift"``) layers keep a state with no sequence axis, so it
  lives in ``(L_kind, max_slots, ...)`` slabs beside the page pools,
  addressed by slot: admission writes the prefilled state into the
  slot's row, the decode window steps a view of the first ``rung`` rows
  in place, and release and reset leave the rows (the next admission
  overwrites a row whole).  No pages, no growth; a slot's bytes are
  fixed.
* **Cross pages for enc-dec decoders** (whisper): a decoder layer's
  cross K/V is a function of the request's encoder features alone, so
  admission writes it once into ``C = ceil(enc_frames / page_size)``
  pages of a cross pool ``(L_dec, num_cross_pages + 1, page_size, Hkv,
  hd)`` (zero cells pad the last page), mapped through a ``(max_slots,
  C)`` cross table and read-only thereafter.  Requests whose features
  are byte-identical map the same block by reference (refcounted; the
  engine keys a host registry on the feature bytes, purged as blocks
  drain), so N decodes of one clip hold one copy.  Token-prefix sharing
  is off for enc-dec: decoder K/V depends on the features too.
* **Refcounted prefix sharing (copy-on-write)**, on by default for
  models with global layers: two requests whose token prefixes agree
  through a page boundary map the same physical global page; a holder
  about to write a shared page first gets a private copy.  The engine
  keys sharing on a host-side registry of page-aligned token prefixes,
  purged as pages drain.
* **Reservation-based admission**: a request reserves its worst-case
  global page count, a free ring where it has local layers and a free
  cross block where its features are not resident, at admission, so
  lazy boundary mapping never finds a free list empty and the ladder
  sweep never targets a rung the pools cannot back.
* **int8 pools** (``kv_quant="int8"``): ``pk``/``pv`` hold int8 values
  and ``pk_s``/``pv_s`` one bf16 scale per (page, offset, KV head) cell,
  about half the bytes of bf16 pools.  Admission quantizes the prefilled
  chunks as it copies them in, decode quantizes each new K/V as it
  writes it, with the same numerics (:func:`repro_torch.kernels.
  paged_attn.quantize_page_pool`), so admitted and decoded cells
  dequantize identically.  Local rings, cross pages and state slabs
  stay at model precision, as in the reference (a model with no global
  layer has no byte to quantize).  A prefill parked by co-execution backfill stays at
  model precision until its admission copies it in.  The dense engines'
  ``CACHE_QUANT`` flag is refused, as the reference does.

Decode writes the new K/V into the pools in place; global layers attend
through K2 (:func:`repro_torch.models.attention.paged_attn_decode_step`),
local layers gather their ring
(:func:`~repro_torch.models.attention.paged_local_attn_decode_step`),
recurrent layers step their slab rows, and enc-dec decoder layers gather
their cross block (:func:`~repro_torch.models.attention.
paged_cross_attn_decode`).  Every model the port accepts (global,
sliding-window and recurrent layers, dense or MoE, enc-dec: gemma3-1b,
recurrentgemma-2b, rwkv6-3b and whisper-base among them) serves here.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ATTN, LOCAL, ModelConfig, RGLRU, WKV
from repro_torch.distributed.mesh import Sharded
from repro_torch.distributed.sharding import cache_specs
from repro_torch.kernels.paged_attn import quantize_page_pool
from repro_torch.models.attention import CACHE_QUANT
from repro_torch.models.transformer import (CROSS_POOLS, CROSS_STACKS,
                                            init_cache, param_dtype,
                                            STATE_STACKS)
from repro_torch.serve.engine import (effective_tokens, encoder_inputs,
                                      Request)
from repro_torch.serve.serve_step import make_paged_decode_step
from repro_torch.serve.slot_engine import SlotServeEngine

POOL_QUANTS = (None, "int8")


class PagedKVCache:
    """Flat page pools + per-slot page tables + a refcounting,
    reservation-based global page allocator and a FIFO ring allocator.

    Global layers (``n_layers`` of them) keep ``"pk","pv"`` (int8 pools
    add ``"pk_s","pv_s"``) indirected by ``table`` ``(max_slots,
    max_pages_per_slot)``; sliding-window layers (``n_local_layers``,
    where ``local_ring`` > 0) keep ``"lk","lv"`` at model precision,
    ``(n_local_layers, num_local_pages + 1, page_size, Hkv, hd)`` with
    sink page ``lsink``, indirected by the ring table ``ltable``
    ``(max_slots, local_ring)``.  An enc-dec decoder's layers
    (``n_cross_layers``, where ``cross_pages`` > 0) keep ``"ck","cv"``
    at model precision, ``(n_cross_layers, num_cross_pages + 1,
    page_size, Hkv, hd)`` with sink page ``csink``, indirected by the
    cross table ``ctable`` ``(max_slots, cross_pages)``; a block of
    ``cross_pages`` pages is refcounted, so requests with the same
    features map one block.  ``slabs`` are the recurrent layers' zero
    state stacks ``(L_kind, max_slots, ...)``, kept in ``pools`` under
    their own names and addressed by slot.  Pools are allocated once, at
    construction; the allocators' bookkeeping is host-side.  With
    ``mesh`` (and the model's ``cfg``) every pool is
    :class:`~repro_torch.distributed.mesh.Sharded` by ``cache_specs``
    and the tables stay whole on ``device``."""

    def __init__(self, max_slots: int, num_pages: int, page_size: int,
                 max_pages_per_slot: int, *, n_layers: int, n_kv_heads: int,
                 head_dim: int, dtype: torch.dtype, device: torch.device,
                 quant: Optional[str] = None, n_local_layers: int = 0,
                 local_ring: int = 0, num_local_pages: int = 0,
                 n_cross_layers: int = 0, cross_pages: int = 0,
                 num_cross_pages: int = 0,
                 slabs: Optional[Dict[str, torch.Tensor]] = None,
                 mesh=None, cfg=None):
        if num_pages < max_pages_per_slot:
            raise ValueError(
                f"pool of {num_pages} pages cannot hold one full-length "
                f"request ({max_pages_per_slot} pages)")
        if local_ring and num_local_pages < local_ring:
            raise ValueError(
                f"local pool of {num_local_pages} pages cannot hold one "
                f"ring ({local_ring} pages)")
        if cross_pages and num_cross_pages < cross_pages:
            raise ValueError(
                f"cross pool of {num_cross_pages} pages cannot hold one "
                f"encoder block ({cross_pages} pages)")
        self.max_slots = max_slots
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        if quant not in POOL_QUANTS:
            raise ValueError(f"quant={quant!r} not in {POOL_QUANTS}")
        self.device = device
        self.quant = quant
        self.local_ring = local_ring
        self.num_local_pages = num_local_pages
        self.cross_pages = cross_pages
        self.num_cross_pages = num_cross_pages
        self.sink = num_pages                      # physical sink page id
        self.lsink = num_local_pages               # the local pool's sink
        self.csink = num_cross_pages               # the cross pool's sink
        self.pools: Dict[str, torch.Tensor] = {}
        # On a mesh the pools are shaped here and laid out per rank below.
        pool_dev = torch.device("meta") if mesh is not None else device
        if n_layers:
            shape = (n_layers, num_pages + 1, page_size, n_kv_heads, head_dim)
            vals = torch.int8 if quant else dtype
            self.pools.update(
                pk=torch.zeros(shape, dtype=vals, device=pool_dev),
                pv=torch.zeros(shape, dtype=vals, device=pool_dev))
            if quant:
                plane = shape[:-1] + (1,)
                self.pools.update(
                    pk_s=torch.zeros(plane, dtype=torch.bfloat16,
                                     device=pool_dev),
                    pv_s=torch.zeros(plane, dtype=torch.bfloat16,
                                     device=pool_dev))
        self.table = torch.full((max_slots, max_pages_per_slot), self.sink,
                                dtype=torch.int32, device=device)
        self.ltable: Optional[torch.Tensor] = None
        if local_ring:
            lshape = (n_local_layers, num_local_pages + 1, page_size,
                      n_kv_heads, head_dim)
            self.pools.update(
                lk=torch.zeros(lshape, dtype=dtype, device=pool_dev),
                lv=torch.zeros(lshape, dtype=dtype, device=pool_dev))
            self.ltable = torch.full((max_slots, local_ring), self.lsink,
                                     dtype=torch.int32, device=device)
        self.ctable: Optional[torch.Tensor] = None
        if cross_pages:
            cshape = (n_cross_layers, num_cross_pages + 1, page_size,
                      n_kv_heads, head_dim)
            self.pools.update(
                ck=torch.zeros(cshape, dtype=dtype, device=pool_dev),
                cv=torch.zeros(cshape, dtype=dtype, device=pool_dev))
            self.ctable = torch.full((max_slots, cross_pages), self.csink,
                                     dtype=torch.int32, device=device)
        self.pools.update(slabs or {})
        if mesh is not None:
            specs = cache_specs(self.pools, cfg, mesh, batch_axes=())
            self.pools = {name: Sharded.zeros(t.shape, t.dtype, specs[name],
                                              mesh)
                          for name, t in self.pools.items()}
        self._reset_allocator()

    def _reset_allocator(self) -> None:
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._free_pages = list(range(self.num_pages - 1, -1, -1))  # pop->lowest
        # Ring pages rotate: freed ones join the back, fresh ones leave
        # the front, so a reclaimed page crosses the whole list first.
        self._free_local = deque(range(self.num_local_pages))
        self._free_cross = list(range(self.num_cross_pages - 1, -1, -1))
        self._lrow: List[List[int]] = [[] for _ in range(self.max_slots)]
        self._lblock = [-1] * self.max_slots      # highest ring block mapped
        self._mapped: List[List[int]] = [[] for _ in range(self.max_slots)]
        self._cmapped: List[List[int]] = [[] for _ in range(self.max_slots)]
        self._cross_ref = [0] * self.num_cross_pages
        self._freed_cross: List[int] = []          # drained, not yet handed
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
    def n_free_local(self) -> int:
        return len(self._free_local)

    @property
    def n_free_cross(self) -> int:
        return len(self._free_cross)

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

    def local_pages_of(self, slot: int) -> List[int]:
        """Physical ring pages of ``slot``, in column order."""
        return list(self._lrow[slot])

    def cross_pages_of(self, slot: int) -> List[int]:
        """Physical cross pages of ``slot``, in logical order."""
        return list(self._cmapped[slot])

    def reserved_pages(self, slot: int) -> int:
        """The worst-case exclusive global pages ``slot`` reserves."""
        return self._reserved[slot]

    def shared_pages_of(self, slot: int) -> int:
        """Global pages ``slot`` maps by reference (admitted shared, not
        yet copied on write)."""
        return self._shared[slot]

    def page_refcount(self, page: int) -> int:
        return self._refcount[page]

    def cross_refcount(self, page: int) -> int:
        """Number of slots mapping cross ``page``."""
        return self._cross_ref[page]

    def _write_row(self, slot: int, start: int, pages: Sequence[int],
                   table: Optional[torch.Tensor] = None) -> None:
        table = self.table if table is None else table
        table[slot, start:start + len(pages)] = torch.as_tensor(
            pages, dtype=torch.int32).to(self.device)

    # -- page lifecycle -----------------------------------------------------
    def admit(self, prefill_cache: Dict[str, torch.Tensor], slot: int,
              reserve_pages: int, shared_pages: Sequence[int] = (), *,
              last_index: Optional[int] = None,
              cross_shared: Optional[Sequence[int]] = None) -> int:
        """Map a prefilled cache (:func:`~repro_torch.models.transformer.
        forward_prefill`'s stacks, each ``(L, 1, capacity, Hkv, hd)``)
        into ``slot`` and reserve its worst case.

        Global stacks ``"k","v"`` (capacity S, a page multiple): the
        first ``len(shared_pages)`` logical pages are mapped by reference
        (the caller guarantees their content equals the prefill's leading
        chunks); the rest are copied into fresh pages.  Local stacks
        ``"wk","wv"`` map one full ring of ``local_ring`` fresh pages
        whatever the prompt's length, regathered into ring-cell order at
        ``last_index``, the position of the prompt's last real token:
        flat ring cell ``t`` takes position ``p = last - ((last - t) mod
        R * page_size)`` from dense cell ``p mod capacity``, zeroed where
        ``p < 0`` (decode writes a cell before it reads it).  Cross
        stacks ``"xk","xv"`` (``(L_dec, 1, enc_len, Hkv, hd)``) map the
        block ``cross_shared`` names by reference, writing nothing, or
        ``cross_pages`` fresh pages (lowest first) into which they are
        copied, padded with zeros to whole pages.  Recurrent stacks
        (``(L, 1, ...)``) overwrite the slot's slab row whole.  Returns
        the number of fresh global pages mapped."""
        has_local = "wk" in prefill_cache
        has_cross = CROSS_STACKS[0] in prefill_cache
        if has_local and not self.local_ring:
            raise ValueError("cache has sliding-window stacks but the pool "
                             "was built with local_ring=0")
        if has_cross and not self.cross_pages:
            raise ValueError("cache has cross-attention stacks but the "
                             "pool was built with cross_pages=0")
        if has_local and len(self._free_local) < self.local_ring:
            raise ValueError(f"no free ring: {len(self._free_local)} local "
                             f"pages free of {self.local_ring}")
        if has_cross:
            if cross_shared is None:
                if len(self._free_cross) < self.cross_pages:
                    raise ValueError(
                        f"no free cross block: {len(self._free_cross)} "
                        f"cross pages free of {self.cross_pages}")
            elif any(self._cross_ref[pg] < 1 for pg in cross_shared):
                raise ValueError(f"cross pages {list(cross_shared)} are "
                                 "not all live")
        n = 0
        if "k" in prefill_cache:
            cap = prefill_cache["k"].shape[2]
            if cap % self.page_size:
                raise ValueError(f"prefill cache capacity {cap} is not a "
                                 f"multiple of page_size {self.page_size}")
            n = cap // self.page_size
            if n > self.max_pages_per_slot:
                raise ValueError(f"prompt needs {n} pages > "
                                 f"max_pages_per_slot "
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
            for name in ("k", "v"):
                src = prefill_cache[name]
                chunks = src[:, 0].reshape(src.shape[0], n, self.page_size,
                                           *src.shape[3:])[:, len(shared):]
                if self.quant:
                    # Quantized as decode quantizes its writes (the
                    # reference's _quantize_pool_tree at admission).
                    chunks, scale = quantize_page_pool(chunks)
                    self._put_pages(f"p{name}_s", idx, scale)
                self._put_pages(f"p{name}", idx, chunks)
        pages = shared + fresh
        if pages:
            self._write_row(slot, 0, pages)
        self._mapped[slot] = pages
        if has_local:
            self._admit_ring(prefill_cache, slot,
                             max(last_index or 0, 0))
        if has_cross:
            self._admit_cross(prefill_cache, slot, cross_shared)
        for name in STATE_STACKS:
            if name in prefill_cache:
                self._put_row(name, slot, prefill_cache[name][:, 0])
        self._shared[slot] = len(shared)
        self._reserved[slot] = reserve_pages
        self.reserved_total += reserve_pages
        return n_fresh

    def _put_pages(self, name: str, idx: torch.Tensor,
                   chunks: torch.Tensor) -> None:
        """Copy whole-width ``chunks`` ``(L, len(idx), page_size, ...)``
        into pages ``idx`` of pool ``name`` (each rank its part on a
        mesh)."""
        pool = self.pools[name]
        if isinstance(pool, Sharded):
            for r, part in enumerate(pool.shards):
                part.index_copy_(1, idx.to(part.device),
                                 pool.part(chunks, r).to(part.device))
        else:
            pool.index_copy_(1, idx, chunks)

    def _put_row(self, name: str, slot: int, rows: torch.Tensor) -> None:
        """Overwrite ``slot``'s row of slab ``name`` with the whole-width
        ``rows`` ``(L, ...)`` (each rank its part on a mesh)."""
        slab = self.pools[name]
        if isinstance(slab, Sharded):
            for r, part in enumerate(slab.shards):
                part[:, slot] = slab[:, slot].part(rows, r).to(part.device)
        else:
            slab[:, slot] = rows

    def _admit_ring(self, prefill_cache: Dict[str, torch.Tensor], slot: int,
                    last: int) -> None:
        """Map ``local_ring`` fresh pages into ``slot``'s ring row and
        copy the local stacks in, in ring-cell order (:meth:`admit`)."""
        psz, ring = self.page_size, self.local_ring
        row = [self._free_local.popleft() for _ in range(ring)]
        cells = ring * psz
        t = torch.arange(cells, device=self.device)
        p = last - torch.remainder(last - t, cells)
        idx = torch.as_tensor(row, device=self.device)
        for name in ("k", "v"):
            src = prefill_cache["w" + name][:, 0]       # (L, cap, Hkv, hd)
            g = src.index_select(
                1, torch.remainder(p.clamp(min=0), src.shape[1]))
            g = g.masked_fill((p < 0)[None, :, None, None], 0)
            self._put_pages("l" + name, idx, g.reshape(
                src.shape[0], ring, psz, *src.shape[2:]))
        self._write_row(slot, 0, row, self.ltable)
        self._lrow[slot] = row
        self._lblock[slot] = last // psz

    def _admit_cross(self, prefill_cache: Dict[str, torch.Tensor],
                     slot: int, shared: Optional[Sequence[int]]) -> None:
        """Map ``slot``'s cross block (:meth:`admit`): by reference, or
        fresh pages with the cross stacks copied in, zero-padded."""
        if shared is not None:
            row = list(shared)
            for pg in row:
                self._cross_ref[pg] += 1
        else:
            row = [self._free_cross.pop() for _ in range(self.cross_pages)]
            for pg in row:
                self._cross_ref[pg] = 1
            idx = torch.as_tensor(row, device=self.device)
            cells = self.cross_pages * self.page_size
            for name, pool in zip(CROSS_STACKS, CROSS_POOLS):
                src = prefill_cache[name][:, 0]        # (L, enc, Hkv, hd)
                src = torch.nn.functional.pad(
                    src, (0, 0, 0, 0, 0, cells - src.shape[1]))
                self._put_pages(pool, idx, src.reshape(
                    src.shape[0], self.cross_pages, self.page_size,
                    *src.shape[2:]))
        self._write_row(slot, 0, row, self.ctable)
        self._cmapped[slot] = row

    def advance_ring(self, slot: int, last_block: int) -> int:
        """Recycle ``slot``'s ring columns before a window writes through
        block ``last_block``: each block in ``(_lblock, last_block]``
        takes column ``block % R``, whose old block is behind every read
        of the window (the ring has one block of slack, ``(R - 1) *
        page_size >= window + window tokens``).  The old page goes to
        the back of the free list before the column takes the front one,
        so an exactly sized, fully held pool hands a column its own page
        back.  Returns the number of swaps."""
        if not self.local_ring or last_block <= self._lblock[slot]:
            return 0
        row = self._lrow[slot]
        swaps = 0
        for nb in range(self._lblock[slot] + 1, last_block + 1):
            col = nb % self.local_ring
            self._free_local.append(row[col])
            row[col] = self._free_local.popleft()
            swaps += 1
        self._lblock[slot] = last_block
        self._write_row(slot, 0, row, self.ltable)
        return swaps

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
        for name, pool in self.pools.items():
            if name[0] == "p":                     # global pools only
                for part in (pool.shards if isinstance(pool, Sharded)
                             else (pool,)):
                    part[:, new] = part[:, pg]
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
        """Release ``slot``'s pages (a shared global page is freed only
        when its last holder releases; the whole ring returns to the back
        of the local free list; a cross page drained to refcount 0
        returns to its free list and is queued for
        :meth:`drain_freed_cross`) and point its table rows at the
        sinks.  Its slab rows keep their stale state until the next
        admission overwrites them.  Returns the global pages actually
        freed."""
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
        if self._lrow[slot]:
            self._free_local.extend(self._lrow[slot])
            self._lrow[slot] = []
            self._lblock[slot] = -1
            self.ltable[slot] = self.lsink
        if self._cmapped[slot]:
            for pg in self._cmapped[slot]:
                self._cross_ref[pg] -= 1
                if self._cross_ref[pg] == 0:
                    self._free_cross.append(pg)
                    self._freed_cross.append(pg)
            self._free_cross.sort(reverse=True)
            self._cmapped[slot] = []
            self.ctable[slot] = self.csink
        self._free_slots.append(slot)
        self._free_slots.sort(reverse=True)
        return freed

    def drain_freed_cross(self) -> List[int]:
        """Cross pages drained since the last call (the engine purges
        its feature registry for them)."""
        out, self._freed_cross = self._freed_cross, []
        return out

    def tables(self) -> Dict[str, torch.Tensor]:
        """The per-class tables a decode step reads its pools through."""
        out = {"global": self.table}
        if self.ltable is not None:
            out["local"] = self.ltable
        if self.ctable is not None:
            out["cross"] = self.ctable
        return out

    def seize_pages(self, n: int) -> List[int]:
        """Fault injection: pull up to ``n`` free global pages out of
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
        """Free every slot and page; the pools and slabs (and their
        stale content, never read before it is overwritten) are kept."""
        self._reset_allocator()
        self.table.fill_(self.sink)
        if self.ltable is not None:
            self.ltable.fill_(self.lsink)
        if self.ctable is not None:
            self.ctable.fill_(self.csink)

    def resident_bytes(self, unique: bool = False) -> int:
        """Bytes of persistent paged storage: pools (sinks included; int8
        pools with their scale planes; cross pools), state slabs and the
        page tables.  On a mesh, every rank's bytes, or with ``unique``
        those of the parts each rank holds first (a replicated stack
        once: the meshless engine's bytes)."""
        return sum(sum(t.nbytes(unique)) if isinstance(t, Sharded)
                   else t.numel() * t.element_size()
                   for t in list(self.pools.values())
                   + list(self.tables().values()))


class PagedServeEngine(SlotServeEngine):
    """Ladder-locked serving over block-granular paged KV storage:
    global layers hold their sequence's pages, with page-aligned common
    prompt prefixes shared copy-on-write (``prefix_sharing``, default
    on where there are global layers, off for enc-dec); sliding-window
    layers hold one ring of ``local_ring`` pages a slot, whose dead
    pages are recycled as decode advances; recurrent layers hold one
    slab row a slot; an enc-dec decoder's cross K/V holds one block of
    ``cross_pages`` pages, shared by requests with the same features.
    ``num_pages`` sizes the global pool; the default matches a dense
    engine's ``max_batch * max_seq`` capacity.  The local pool holds
    ``max_batch`` rings, the cross pool ``max_batch`` blocks."""

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
        kinds = cfg.layer_kinds()
        self._has_global = ATTN in kinds
        self._has_local = LOCAL in kinds
        self._has_cross = bool(cfg.enc_dec)
        if self._has_cross and cfg.enc_frames <= 0:
            raise ValueError(
                f"{cfg.name} is enc-dec but enc_frames={cfg.enc_frames}; "
                "paged cross-attention needs a static encoder length")
        self.page_size = page_size
        self.kv_quant = kv_quant
        # Decoder K/V of an enc-dec model depends on the features too, so
        # it shares cross blocks (keyed on the features) and no prefixes.
        self.prefix_sharing = (prefix_sharing and self._has_global
                               and not self._has_cross)
        self.max_pages_per_slot = -(-max_seq // page_size)
        self.num_pages = (num_pages if num_pages is not None
                          else max_batch * self.max_pages_per_slot)
        # A ring covers the window, one decode window and one page of
        # slack, so a column is recycled only once its old block is
        # behind every read of the coming window (sized before
        # super().__init__ builds the cache).
        self.local_ring = 0
        if self._has_local:
            w = min(cfg.sliding_window, max_seq)
            self.local_ring = -(-(w + int(kw.get("window", 8)))
                                // page_size) + 1
        self.num_local_pages = max_batch * self.local_ring
        self.cross_pages = (-(-cfg.enc_frames // page_size)
                            if self._has_cross else 0)
        self.num_cross_pages = max_batch * self.cross_pages
        # token-prefix bytes -> physical page, and its reverse (purged
        # when pages drain back to the free list).
        self._prefix_registry: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        # encoder-feature bytes -> cross block, and its reverse keyed on
        # the block's first page (purged as cross pages drain).
        self._cross_registry: Dict[bytes, Tuple[int, ...]] = {}
        self._cross_key: Dict[int, bytes] = {}
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
                       "window_pages_reclaimed": 0,
                       "local_ring_pages": self.local_ring,
                       "cross_admits": 0, "cross_shared": 0,
                       "pool_pages": self.num_pages,
                       "kv_pool": self.kv_quant or "f32"})
        return extras

    def _prefill_cache_len(self) -> Optional[int]:
        # The prefilled cache capacity equals the padded prompt length
        # (a page multiple), so admission maps ceil(prompt / page) pages.
        return None

    def _default_decode_fn(self):
        wc = (min(self.cfg.sliding_window, self.max_seq)
              if self._has_local else None)
        return make_paged_decode_step(self.cfg, self.mesh, window_cap=wc)

    def _make_cache(self):
        cfg = self.cfg
        kinds = cfg.layer_kinds()
        dtype = param_dtype(self._host_params)
        return PagedKVCache(self.max_batch, self.num_pages, self.page_size,
                            self.max_pages_per_slot,
                            n_layers=kinds.count(ATTN),
                            n_kv_heads=cfg.n_kv_heads,
                            head_dim=cfg.resolved_head_dim,
                            dtype=dtype, device=self.device,
                            quant=self.kv_quant,
                            n_local_layers=kinds.count(LOCAL),
                            local_ring=self.local_ring,
                            num_local_pages=self.num_local_pages,
                            n_cross_layers=(cfg.n_layers if self._has_cross
                                            else 0),
                            cross_pages=self.cross_pages,
                            num_cross_pages=self.num_cross_pages,
                            # init_cache adds an enc-dec model's dense
                            # cross stacks; here the cross pools hold it.
                            slabs={name: t for name, t in init_cache(
                                cfg, self.max_batch, 1, dtype, self.device,
                                kinds=(RGLRU, WKV)).items()
                                if name in STATE_STACKS},
                            mesh=self.mesh, cfg=cfg)

    def _bucket_len(self, s: int) -> Optional[int]:
        # Page-multiple buckets: admission maps exactly
        # ceil(prompt / page_size) pages, never pages of pad K/V.
        if s > self._bucket_cap:
            return None
        return -(-max(s, 1) // self.page_size) * self.page_size

    def reset(self) -> None:
        super().reset()
        self._clear_registries()

    def _clear_registries(self) -> None:
        self._prefix_registry.clear()
        self._page_key.clear()
        self._cross_registry.clear()
        self._cross_key.clear()

    def remesh(self, new_mesh) -> List[Request]:
        victims = super().remesh(new_mesh)
        # The rebuilt pools start empty: every registry entry points at
        # a page of the lost mesh's pools.
        self._clear_registries()
        return victims

    # -- page accounting ----------------------------------------------------
    def _pages_for(self, req: Request) -> int:
        """Worst-case pages for ``req``: padded (effective) prompt plus
        its remaining decode budget, clamped to the ``max_seq`` stop
        rule.  A preempted request's effective prompt grew by exactly
        what its budget shrank, so resume reserves the same worst case.
        A model with no global layer reserves none."""
        if not self._has_global:
            return 0
        k = len(req.generated)
        s = len(req.prompt) + max(k - 1, 0)
        blen = self._bucket_len(s) or s
        budget = max(1, req.max_new_tokens - max(k, 1))
        last = min(max(blen - 1, s + budget - 1), self.max_seq - 1)
        return last // self.page_size + 1

    def _cross_bytes_key(self, req: Request) -> bytes:
        """The registry key of ``req``'s encoder features: the bytes of
        :func:`~repro_torch.serve.engine.encoder_inputs` (so None and
        explicit zeros share a block), built once a feature block and
        kept on the request (every admission sweep asks again)."""
        held = getattr(req, "_cross_key_of", None)
        if held is None or held[0] is not req.enc_embeds:
            held = (req.enc_embeds,
                    encoder_inputs(req, self.cfg).tobytes())
            req._cross_key_of = held
        return held[1]

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
        first) whose worst-case reservations, rings and cross blocks
        still fit the pools.  A waiting request whose features are not
        resident counts a whole block, as in the reference, even where
        another waiting request has the same features."""
        cap = self._n_active()
        rem = (self.cache.num_pages - self.cache.reserved_total
               - self.cache.orphaned_pages)
        rings = (self.cache.n_free_local // self.local_ring
                 if self._has_local else self.max_batch)
        rem_c = self.cache.n_free_cross
        waiting = [r for r, _, _ in self._backfilled] + list(self.queue)
        for req in waiting:
            if cap >= self.max_batch:
                break
            need = self._pages_for(req) - len(self._probe_shared(req))
            need_c = (self.cross_pages if self._has_cross
                      and self._cross_bytes_key(req)
                      not in self._cross_registry else 0)
            if need > rem or rings < 1 or need_c > rem_c:
                break
            cap += 1
            rem -= need
            rings -= 1
            rem_c -= need_c
        return cap

    def _can_admit(self, req: Request) -> bool:
        if self._has_local and self.cache.n_free_local < self.local_ring:
            return False
        if (self._has_cross
                and self.cache.n_free_cross < self.cross_pages
                and self._cross_bytes_key(req) not in self._cross_registry):
            return False
        return self.cache.can_reserve(self._pages_for(req)
                                      - len(self._probe_shared(req)))

    def _store_cache(self, req: Request, cache, slot: int) -> None:
        shared = self._probe_shared(req)
        ckey = self._cross_bytes_key(req) if self._has_cross else None
        block = self._cross_registry.get(ckey) if self._has_cross else None
        fresh = self.cache.admit(cache, slot,
                                 self._pages_for(req) - len(shared),
                                 shared_pages=shared,
                                 last_index=len(effective_tokens(req)) - 1,
                                 cross_shared=block)
        ext = self.stats["engine"]
        ext["page_admits"] += fresh
        ext["pages_shared"] += len(shared)
        if self._has_cross:
            if block is None:
                block = tuple(self.cache.cross_pages_of(slot))
                self._cross_registry[ckey] = block
                self._cross_key[block[0]] = ckey
                ext["cross_admits"] += 1
            else:
                ext["cross_shared"] += 1
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
        for pg in self.cache.drain_freed_cross():
            key = self._cross_key.pop(pg, None)
            if key is not None:
                self._cross_registry.pop(key, None)

    def _note_pages_peak(self) -> None:
        mapped = self.cache.num_pages - self.cache.n_free_pages
        if mapped > self.stats["engine"]["pages_mapped_peak"]:
            self.stats["engine"]["pages_mapped_peak"] = mapped

    # -- window over the page pool ----------------------------------------
    def _window_call(self, rung: int, toks, pos, budget):
        # Map the pages this window can write (within each admission's
        # reservation by construction), copy any shared page a row is
        # about to write (never in the serve flow: sharing covers full
        # prompt pages only), and recycle the ring columns the window
        # will enter.  The window steps a view of the slabs' first
        # ``rung`` rows in place; the page pools (cross pools among
        # them, which decode only reads) are read whole.
        ext = self.stats["engine"]
        for slot in range(rung):
            if self._req[slot] is None:
                continue
            b = int(self._budget[slot])
            if b <= 0:
                continue
            first = int(self._pos[slot])
            last = min(first + min(self.window, b) - 1, self.max_seq - 1)
            if self._has_global:
                ext["page_grows"] += self.cache.ensure_capacity(slot, last)
                ext["page_cows"] += self.cache.ensure_writable(slot, first,
                                                               last)
            ext["window_pages_reclaimed"] += self.cache.advance_ring(
                slot, last // self.page_size)
        self._note_pages_peak()
        tables = {k: t[:rung] for k, t in self.cache.tables().items()}
        pools = {name: t[:, :rung] if name in STATE_STACKS else t
                 for name, t in self.cache.pools.items()}
        return self._decode_window(
            lambda t, p: self.decode_fn(self.params, pools, tables, t, p)[0],
            toks, pos, budget, rung=rung)
