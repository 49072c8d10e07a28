"""Ladder-locked continuous batching over a persistent slot cache (the
port of ``repro/serve/slot_engine.py``).

* **Persistent slot cache** (:class:`SlotKVCache`): KV caches live in
  fixed ``(layers, max_batch, capacity, ...)`` buffers, one stack a
  layer class (global layers at ``max_seq``, sliding-window layers at
  ``min(max_seq, window)``), and recurrent layers' states (RG-LRU
  ``"h","conv"``, RWKV6 ``"state","shift"``) in ``(layers, max_batch,
  ...)`` buffers of the same kind, a row a slot.  A request is assigned
  a slot at admission (one in-place copy writes its prefilled cache in)
  and releases it when done; admission overwrites the slot's full
  capacity and its whole state row, so slot reuse is safe.
* **Fixed-shape ladder decode**: a decode window always runs at a
  ``SLAB_LADDER`` rung (the smallest rung covering the highest live
  slot), with per-slot budgets masking holes and finished rows.
* **Multi-token window**: ``window`` decode steps with the greedy argmax
  on the device, per-slot positions and done flags, and one host sync
  per window.  The reference scans the window inside one jit over a
  slice of the buffers and writes the slice back; here it is a Python
  loop of eager steps over a view of the buffers, written in place.
  ``stats["decode_compiles"]`` counts the first window run at each
  rung — where the reference traces — and reads 0 after :meth:`warmup`.
* **Bucketed prefill**: prompts pad to a bucket (powers of two here,
  page multiples on the paged engine) with the last real token's logits
  read back (causal masking hides pads); a layer whose ring is shorter
  than the bucket lays it at each row's real last token.  Buckets clamp
  to ``max_seq``; a longer prompt takes an exact-length prefill (a
  fallback), which lays its last ``max_seq`` positions as a ring.
* **Coalesced prefill** (:meth:`SlotServeEngine.prefill_batch`): one
  batched prefill for a group of same-bucket prompts, each row parked
  decode-ready (off for MoE, whose routing capacity couples rows, and
  for ``buckets="off"``).
* **Co-execution backfill** (``coexec_backend="kernel"``): the
  prefills the packer co-schedules with a window run at its boundary
  and park decode-ready, admitted next step without a second prefill.
* **Admission classes and preemption** via
  :class:`~repro_torch.serve.policy.SchedulingPolicy`, with a
  token-identical resume of preempted requests.

Storage lives behind four hooks (``_default_decode_fn``,
``_make_cache``, ``_store_cache``, ``_window_call``), which
:class:`~repro_torch.serve.paged_engine.PagedServeEngine` overrides for
its page pool.  Rows are independent, so a request's tokens do not
depend on what it is batched with.

**On a mesh** (``mesh=``, a ``("data", "model")``
:class:`~repro_torch.distributed.mesh.Mesh`) the parameters are placed
by ``param_specs(..., fsdp=False)`` on every device (the data axis
holds replicas), the slot buffers by ``cache_specs(...,
batch_axes=())`` as :class:`~repro_torch.distributed.mesh.Sharded`
stacks over the model row, and the steps run tensor-parallel there.
One replica computes, the data index 0 row; the other replicas hold the
parameters and stand by, and no storage is kept for them.  A host
master copy of the parameters stays for :meth:`SlotServeEngine.remesh`,
which rebuilds every device structure on a smaller mesh after a lost
device and hands the requests in flight back for re-prefill.
"""
from __future__ import annotations

from collections import deque
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh import Sharded
from repro_torch.distributed.sharding import cache_specs, place_params
from repro_torch.models.transformer import check_supported
from repro_torch.serve.api import completion_of, Completion, FINISH_CANCELLED
from repro_torch.serve.engine import (effective_tokens, init_serve_stats,
                                      note_first_token, prefill_batch_of,
                                      record_step_packing, Request,
                                      SLAB_LADDER)
from repro_torch.serve.policy import KLASS_BATCH, SchedulingPolicy
from repro_torch.serve.serve_step import (make_bucketed_prefill_step,
                                          make_decode_step)

_MIN_BUCKET = 8
Cache = Dict[str, torch.Tensor]


class SlotKVCache:
    """Fixed slot buffers and a free list for the persistent serving
    cache.  Buffers are allocated at the first :meth:`write`, shaped
    from the prefilled cache (float or int8 with scale planes; the
    recurrent states at model precision, ``"h"`` and ``"state"``
    float32) with the batch axis widened to ``max_slots``.  With
    ``mesh`` (and the model's ``cfg``), each buffer is a
    :class:`~repro_torch.distributed.mesh.Sharded` stack laid out by
    ``cache_specs(..., batch_axes=())``."""

    def __init__(self, max_slots: int, mesh=None, cfg=None):
        self.max_slots = max_slots
        self.mesh = mesh
        self.cfg = cfg
        self.buffers: Optional[Cache] = None
        self._free = list(range(max_slots - 1, -1, -1))  # pop() -> lowest

    @property
    def n_free(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        """Claim the lowest free slot (keeps live slots packed at the
        front, so the ladder rung stays minimal)."""
        return self._free.pop()

    def release(self, slot: int) -> None:
        """Return a slot to the free list; its stale content stays and
        is overwritten in full at the next admission."""
        self._free.append(slot)
        self._free.sort(reverse=True)

    def reset(self) -> None:
        """Free every slot; the buffers (and their stale content) are
        kept."""
        self._free = list(range(self.max_slots - 1, -1, -1))

    def resident_bytes(self, unique: bool = False) -> int:
        """Bytes of the slot buffers (0 until the first admission).  On a
        mesh, every rank's bytes, or with ``unique`` those of the parts
        each rank holds first (a replicated stack once)."""
        if self.buffers is None:
            return 0
        return sum(sum(t.nbytes(unique)) if isinstance(t, Sharded)
                   else t.numel() * t.element_size()
                   for t in self.buffers.values())

    def write(self, prefill_cache: Cache, slot: int) -> None:
        """Store a single-request prefilled cache (each stack ``(L, 1,
        ...)``: KV at its capacity, or a recurrent state; whole on a
        mesh) into ``slot``."""
        if self.buffers is None:
            shapes = {name: t.shape[:1] + (self.max_slots,) + t.shape[2:]
                      for name, t in prefill_cache.items()}
            if self.mesh is None:
                self.buffers = {name: prefill_cache[name].new_zeros(shape)
                                for name, shape in shapes.items()}
            else:
                specs = cache_specs(
                    {n: torch.empty(sh, device="meta")
                     for n, sh in shapes.items()},
                    self.cfg, self.mesh, batch_axes=())
                self.buffers = {
                    name: Sharded.zeros(shape, prefill_cache[name].dtype,
                                        specs[name], self.mesh)
                    for name, shape in shapes.items()}
        for name, buf in self.buffers.items():
            if isinstance(buf, Sharded):
                for r, part in enumerate(buf.shards):
                    part[:, slot] = buf.part(prefill_cache[name], r)[:, 0]
            else:
                buf[:, slot] = prefill_cache[name][:, 0]


class SlotServeEngine:
    """Ladder-locked continuous batching over a persistent slot cache;
    subclasses swap the storage through ``_default_decode_fn``,
    ``_make_cache``, ``_store_cache`` and ``_window_call``."""

    def __init__(self, cfg: ModelConfig, params, *, device: torch.device,
                 max_batch: int = 8, max_seq: int = 256, window: int = 8,
                 ladder: Optional[Sequence[int]] = None,
                 multi_tenant: bool = True,
                 coexec_backend: Optional[str] = None,
                 prefill_bucketing: bool = True,
                 policy: Optional[SchedulingPolicy] = None,
                 default_klass: str = KLASS_BATCH, mesh=None):
        check_supported(cfg)
        if mesh is not None:
            device = mesh.model_devices()[0]
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        # The host master copy: remesh() places it on the survivors, so
        # recovery never reads a shard of the lost mesh.
        self._host_params = params
        self.params = (params if mesh is None
                       else place_params(params, cfg, mesh))
        self.policy = policy or SchedulingPolicy()
        self.default_klass = default_klass
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.window = window
        self.multi_tenant = multi_tenant
        self.coexec_backend = coexec_backend
        # MoE experts always run on K4 (or its plain version on the CPU).
        self._expert_backend = "kernel" if cfg.moe is not None else None
        self.stats = init_serve_stats(self._expert_backend, coexec_backend)
        self.stats["engine"].update(self._stats_extras())

        # Ladder rungs available at this engine's max_batch; decode only
        # ever runs at these batch shapes.
        source = SLAB_LADDER if ladder is None else tuple(ladder)
        self.rungs: Tuple[int, ...] = tuple(
            sorted({b for b in source if b <= max_batch} | {max_batch}))

        self._bucket_enabled = prefill_bucketing
        self.prefill_fn = make_bucketed_prefill_step(
            cfg, mesh, cache_len=self._prefill_cache_len())
        self._bucket_cap = max_seq
        self._seen_buckets: set = set()
        # Coalesced prefill is off for MoE: routing capacity couples the
        # rows of a batch, so a group would not be row-identical to
        # single prefills.
        self._batch_prefill = self._bucket_enabled and cfg.moe is None

        self.decode_fn = self._default_decode_fn()
        self._window_rungs: set = set()   # rungs whose first window ran
        self._compile_base = 0

        self.cache = self._make_cache()
        # Per-slot host state (mirrors the device-side window carries).
        self._req: List[Optional[Request]] = [None] * max_batch
        self._tok = np.zeros(max_batch, np.int32)
        self._pos = np.zeros(max_batch, np.int32)
        self._budget = np.zeros(max_batch, np.int32)

        self.queue: Deque[Request] = deque()
        self._backfilled: Deque[Tuple[Request, Any, int]] = deque()
        self._cancelled: List[Request] = []

    # Subclass hooks ------------------------------------------------------
    def _stats_extras(self) -> dict:
        """Engine-specific keys, namespaced under ``stats["engine"]``."""
        return {
            "windows": 0, "rungs": [],
            "prefill_bucket_hits": 0, "prefill_bucket_misses": 0,
            "prefill_bucket_fallbacks": 0,
            "prefill_batches": 0, "prefill_batched_reqs": 0,
            "slot_admits": 0, "slot_releases": 0,
            "preemptions": 0, "cancelled": 0,
            "remeshes": 0,
        }

    def _prefill_cache_len(self) -> Optional[int]:
        return self.max_seq

    def _default_decode_fn(self):
        return make_decode_step(self.cfg, self.mesh)

    def _make_cache(self):
        return SlotKVCache(self.max_batch, self.mesh, self.cfg)

    def _store_cache(self, req: Request, cache, slot: int) -> None:
        """Move a single-request prefilled cache into ``slot``."""
        self.cache.write(cache, slot)

    def _window_call(self, rung: int, toks, pos, budget):
        # The window runs on a view of the first ``rung`` slots, so its
        # in-place writes land in the full buffers (no copy back).
        bufs = {name: t[:, :rung] for name, t in self.cache.buffers.items()}
        return self._decode_window(
            lambda t, p: self.decode_fn(self.params, bufs, t, p)[0],
            toks, pos, budget, rung=rung)

    def _admit_cap(self) -> Optional[int]:
        """Upper bound on resident requests (None = slots only)."""
        return None

    def _can_admit(self, req: Request) -> bool:
        return True

    def _release_slot(self, slot: int) -> None:
        self.cache.release(slot)

    def reset(self) -> None:
        """Clear all serving state for a fresh serve on the same engine
        (device storage is kept)."""
        self.queue.clear()
        self._backfilled.clear()
        self._cancelled.clear()
        self._req = [None] * self.max_batch
        self._tok[:] = 0
        self._pos[:] = 0
        self._budget[:] = 0
        self.cache.reset()
        self.stats = init_serve_stats(self._expert_backend,
                                      self.coexec_backend)
        self.stats["engine"].update(self._stats_extras())

    def remesh(self, new_mesh) -> List[Request]:
        """Rebuild every device structure on ``new_mesh`` and hand the
        requests in flight back for re-prefill (the lost-device recovery
        of :meth:`~repro_torch.serve.frontend.ServeFrontend._recover`).

        Every resident and backfilled request is released — its tokens
        cleared, back at the queue's head in admission order — and the
        parameters (placed anew from the host master copy), the steps
        and the storage are rebuilt; the old mesh's shards and storage
        are dropped, never reused.  Greedy decoding is deterministic, so
        each request regenerates the tokens it had.  Returns the
        released requests."""
        if self.mesh is None:
            raise ValueError("remesh requires a mesh-aware engine "
                             "(construct with mesh=...)")
        victims: List[Request] = []
        for slot in range(self.max_batch):
            if self._req[slot] is not None:
                victims.append(self._req[slot])
                self._req[slot] = None
        victims.extend(req for req, _cache, _pos in self._backfilled)
        self._backfilled.clear()
        for req in victims:
            req.generated = []
            req.done = False
            req.finished_at = None
        for req in reversed(victims):
            self.queue.appendleft(req)
        self._tok[:] = 0
        self._pos[:] = 0
        self._budget[:] = 0

        self.mesh = new_mesh
        self.device = torch.device(new_mesh.model_devices()[0])
        # Drop the old mesh's storage and shards before placing anew.
        self.cache = None
        self.params = None
        self.params = place_params(self._host_params, self.cfg, new_mesh)
        self.prefill_fn = make_bucketed_prefill_step(
            self.cfg, new_mesh, cache_len=self._prefill_cache_len())
        self._seen_buckets.clear()
        self.decode_fn = self._default_decode_fn()
        self._window_rungs.clear()
        self._compile_base = 0
        self.cache = self._make_cache()
        self.stats["engine"]["remeshes"] += 1
        return victims

    # Multi-token decode window -------------------------------------------
    def _decode_window(self, step, toks, pos, budget, *, rung: int):
        """``window`` greedy tokens at batch shape ``rung``, ``step(tokens
        (rung, 1), pos) -> logits`` one decode step over the storage;
        one host sync.  toks/pos/budget: (rung,) int32 device tensors —
        last emitted token, next write position, remaining budget per
        slot.  Rows with budget <= 0 (holes, finished requests) stay
        frozen and emit -1; their writes land in storage that is
        released or overwritten at the next admission (a recurrent
        row's state keeps stepping, as in the reference, and its next
        admission overwrites it)."""
        self._window_rungs.add(rung)
        vocab = self.cfg.vocab_size
        emits = []
        for _ in range(self.window):
            logits = step(toks[:, None], pos)
            nxt = torch.argmax(logits[:, -1, :vocab], dim=-1).to(torch.int32)
            live = budget > 0
            emits.append(torch.where(live, nxt, -1))
            toks = torch.where(live, nxt, toks)
            pos = torch.where(live, pos + 1, pos)
            budget = torch.where(live, budget - 1, budget)
            budget = torch.where(pos >= self.max_seq - 1, 0, budget)
        return toks, pos, budget, torch.stack(emits)

    # Prefill (bucketed) + admission --------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue in admission-class order (interactive ahead of the
        first batch entry; FIFO within each class)."""
        req.arrived = time.time()
        if req.klass is None:
            req.klass = self.default_klass
        self.policy.enqueue(self.queue, req)

    def _bucket_len(self, s: int) -> Optional[int]:
        """Prefill bucket for an ``s``-token prompt, or None past the
        engine capacity (exact-length fallback)."""
        if s > self._bucket_cap:
            return None
        b = _MIN_BUCKET
        while b < s:
            b *= 2
        return min(b, self._bucket_cap)

    def _prefill_one(self, req: Request):
        # A preempted request resumes by re-prefilling every token it
        # wrote (prompt + generated[:-1]), and re-encoding its own
        # features on an enc-dec model; its first token was already
        # sampled and stamped, so resume skips both.
        toks = effective_tokens(req)
        resume = bool(req.generated)
        s = len(toks)
        b = self._bucket_len(s) if self._bucket_enabled else None
        if b is not None:
            if b in self._seen_buckets:
                self.stats["engine"]["prefill_bucket_hits"] += 1
            else:
                self._seen_buckets.add(b)
                self.stats["engine"]["prefill_bucket_misses"] += 1
            padded = np.zeros(b, np.int32)
            padded[:s] = toks
        else:
            if self._bucket_enabled:
                self.stats["engine"]["prefill_bucket_fallbacks"] += 1
            padded = np.asarray(toks, np.int32)
        batch = prefill_batch_of(padded[None], [req], self.cfg, self.device)
        batch["last_index"] = s - 1
        logits, cache = self.prefill_fn(self.params, batch)
        if not resume:
            note_first_token(req, logits, self.cfg.vocab_size, self.stats)
        return cache, s

    def _backfill_one(self, req: Request) -> None:
        """One co-scheduled prefill at a window boundary; the request
        parks decode-ready (its cache at model precision) for the next
        admission."""
        cache, pos = self._prefill_one(req)
        self._backfilled.append((req, cache, pos))
        self.stats["backfilled"] += 1

    def _n_active(self) -> int:
        return sum(r is not None for r in self._req)

    def _admit(self) -> None:
        """Fill free slots up to the SISA ladder target (backfilled
        first, then the queue in policy order).  With ``class_priority``
        an interactive head is admitted past the target, and with
        ``preemption`` a storage-blocked interactive admission evicts a
        batch-class resident instead of stalling."""
        waiting = [r for r, _, _ in self._backfilled] + list(self.queue)
        n_live = self._n_active() + len(waiting)
        if n_live == 0:
            return
        n_inter = sum(1 for r in waiting if self.policy.is_interactive(r))
        target = self.policy.ladder_target(
            n_live, n_inter, self.cfg, self.max_batch,
            admit_cap=self._admit_cap())
        self.stats["batches"].append(min(target, n_live))
        # Every pass admits or preempts, both finite; the guard is a
        # belt against invariant bugs only.
        guard = 2 * (self.max_batch + n_live) + 4
        while (self._backfilled or self.queue) and guard > 0:
            guard -= 1
            src, idx, head = self._next_candidate()
            boost = (self.policy.class_priority
                     and self.policy.is_interactive(head))
            if self._n_active() >= (self.max_batch if boost else target):
                break
            if not self.cache.n_free or not self._can_admit(head):
                if not (boost and self._preempt_for(head)):
                    break
                continue
            if src == "backfilled":
                req, cache, pos = self._backfilled[idx]
                del self._backfilled[idx]
            else:
                req = self.queue[idx]
                del self.queue[idx]
                cache, pos = self._prefill_one(req)
            slot = self.cache.acquire()
            self._store_cache(req, cache, slot)
            self._req[slot] = req
            self._tok[slot] = req.generated[-1]
            self._pos[slot] = pos
            # generated already holds the prefill token.
            self._budget[slot] = max(1, req.max_new_tokens
                                     - len(req.generated))
            self.stats["engine"]["slot_admits"] += 1

    def _next_candidate(self):
        """Admission candidate in policy order: the first interactive
        entry anywhere (backfilled ahead of queued), else the backfilled
        head, else the queue head."""
        if self.policy.class_priority:
            for i, (r, _c, _p) in enumerate(self._backfilled):
                if self.policy.is_interactive(r):
                    return "backfilled", i, r
            for i, r in enumerate(self.queue):
                if self.policy.is_interactive(r):
                    return "queue", i, r
        if self._backfilled:
            return "backfilled", 0, self._backfilled[0][0]
        return "queue", 0, self.queue[0]

    # Preemption + cancellation -------------------------------------------
    def _preempt_for(self, head: Request) -> bool:
        """Evict one batch-class resident to unblock ``head``."""
        if not self.policy.preemption:
            return False
        resident = [(s, r) for s, r in enumerate(self._req) if r is not None]
        victim = self.policy.choose_victim(resident)
        if victim is None:
            return False
        self._preempt_slot(*victim)
        return True

    def _preempt_slot(self, slot: int, req: Request) -> None:
        """Release ``slot``'s storage and requeue its request for a
        deterministic resume."""
        self._req[slot] = None
        self._budget[slot] = 0
        self._release_slot(slot)
        self.stats["engine"]["slot_releases"] += 1
        self.stats["engine"]["preemptions"] += 1
        req.preemptions += 1
        self.policy.requeue(self.queue, req)

    def preempt(self, n: int = 1) -> int:
        """Forcibly evict up to ``n`` residents (policy victims first,
        then any resident by lowest progress); returns how many."""
        count = 0
        for _ in range(n):
            resident = [(s, r) for s, r in enumerate(self._req)
                        if r is not None]
            victim = self.policy.choose_victim(resident)
            if victim is None and resident:
                victim = min(resident,
                             key=lambda sr: (len(sr[1].generated), -sr[0]))
            if victim is None:
                break
            self._preempt_slot(*victim)
            count += 1
        return count

    def cancel(self, rid: int) -> bool:
        """Release a request mid-flight (resident, backfilled or
        queued); marks it done with ``finish_reason="cancelled"``.
        Returns True iff found."""
        for slot, req in enumerate(self._req):
            if req is not None and req.rid == rid:
                self._req[slot] = None
                self._budget[slot] = 0
                self._release_slot(slot)
                self.stats["engine"]["slot_releases"] += 1
                break
        else:
            for item in list(self._backfilled):
                if item[0].rid == rid:
                    self._backfilled.remove(item)
                    req = item[0]
                    break
            else:
                for req in list(self.queue):
                    if req.rid == rid:
                        self.queue.remove(req)
                        break
                else:
                    return False
        req.done = True
        req.finish_reason = FINISH_CANCELLED
        req.finished_at = time.time()
        self._cancelled.append(req)
        self.stats["engine"]["cancelled"] += 1
        return True

    def _current_rung(self) -> int:
        highest = max((i + 1 for i, r in enumerate(self._req)
                       if r is not None), default=0)
        if highest == 0:
            return 0
        return next(r for r in self.rungs if r >= highest)

    # Serve loop ------------------------------------------------------------
    def _run_window(self, rung: int, finished: List[Request]) -> None:
        dev = self.device
        toks = torch.as_tensor(self._tok[:rung], device=dev)
        pos = torch.as_tensor(self._pos[:rung], device=dev)
        budget = torch.as_tensor(self._budget[:rung], device=dev)
        toks, pos, budget, out = self._window_call(rung, toks, pos, budget)
        self.stats["decode_compiles"] = max(
            0, len(self._window_rungs) - self._compile_base)
        self.stats["engine"]["windows"] += 1
        self.stats["engine"]["rungs"].append(rung)
        self.stats["decode_steps"] += self.window
        # The single host sync of the window: emits and carries, all
        # (·, rung) int32, come back in one copy.
        host = torch.cat([out, torch.stack([toks, pos, budget])]).cpu().numpy()
        out_np = host[:-3]                               # (T, rung)
        self._tok[:rung], self._pos[:rung], self._budget[:rung] = host[-3:]
        for slot in range(rung):
            req = self._req[slot]
            if req is None:
                continue
            col = out_np[:, slot]
            req.generated.extend(int(t) for t in col[col >= 0])
            if self._budget[slot] <= 0:
                req.done = True
                req.finished_at = time.time()
                finished.append(req)
                self._req[slot] = None
                self._release_slot(slot)
                self.stats["engine"]["slot_releases"] += 1

    def _plan_step(self) -> int:
        """Multi-tenant co-schedule of this window (stats, and the
        number of prefills co-scheduled with it)."""
        if not self.multi_tenant or not self.queue:
            return 0
        waiting = [len(r.prompt) for r in self.queue]
        return record_step_packing(self.stats, self._n_active(), waiting,
                                   self.cfg, bool(self.coexec_backend))

    @torch.no_grad()
    def step(self, finished: List[Request], max_steps: int = 512) -> int:
        """One scheduler iteration at a window boundary: admit up to the
        ladder target, run one decode window, then (``coexec_backend``)
        run the prefills co-scheduled with it.  Appends newly finished
        requests to ``finished``; returns the decode steps consumed (0
        when idle)."""
        if self._cancelled:
            finished.extend(self._cancelled)
            self._cancelled.clear()
        if not (self.queue or self._backfilled or self._n_active()) \
                or max_steps <= 0:
            return 0
        self._admit()
        n_pre = self._plan_step()
        to_backfill: List[Request] = []
        if self.coexec_backend and self.multi_tenant:
            to_backfill = [self.queue.popleft()
                           for _ in range(min(n_pre, len(self.queue)))]
        rung = self._current_rung()
        if rung:
            self._run_window(rung, finished)
            consumed = self.window
        else:
            consumed = 1
        for req in to_backfill:
            self._backfill_one(req)
        return consumed

    def run(self, max_steps: int = 512) -> List[Completion]:
        """Serve everything in the queue (greedy decoding); one
        :class:`~repro_torch.serve.api.Completion` per finished request.
        ``max_steps`` counts decode iterations, ``window`` at a time."""
        finished: List[Request] = []
        while ((self.queue or self._backfilled or self._n_active())
               and max_steps > 0):
            max_steps -= self.step(finished, max_steps)
        finished.extend(self._cancelled)
        self._cancelled.clear()
        return [completion_of(r) for r in finished]

    # Coalesced prefill + warmup -------------------------------------------
    @torch.no_grad()
    def prefill_batch(self, reqs: List[Request]) -> None:
        """Coalesced multi-prompt prefill: one batched call for each run
        of consecutive same-bucket prompts, each row parked decode-ready
        in the backfill queue (admitted FIFO by the next ``step``, never
        re-prefilled).  The batch pads to the smallest ladder rung
        covering the group with copies of row 0, which are discarded.
        Rows are independent, so each row's first token and cache are
        those of its single prefill (bitwise on the CPU; on the card K1
        may sum in another order at another M).  MoE and exact-length
        engines prefill the group one request at a time."""
        groups: List[Tuple[Optional[int], List[Request]]] = []
        for req in reqs:
            b = self._bucket_len(len(req.prompt))
            if groups and groups[-1][0] == b and b is not None:
                groups[-1][1].append(req)
            else:
                groups.append((b, [req]))
        for b, group in groups:
            if not self._batch_prefill or b is None or len(group) == 1:
                for req in group:
                    self._backfill_one(req)
                continue
            for i in range(0, len(group), self.rungs[-1]):
                self._prefill_group(group[i:i + self.rungs[-1]], b)

    def _prefill_group(self, group: List[Request], b: int) -> None:
        k = len(group)
        rung = next(r for r in self.rungs if r >= k)
        sig = (rung, b)
        if sig in self._seen_buckets:
            self.stats["engine"]["prefill_bucket_hits"] += 1
        else:
            self._seen_buckets.add(sig)
            self.stats["engine"]["prefill_bucket_misses"] += 1
        rows = [group[i] if i < k else group[0] for i in range(rung)]
        toks = np.zeros((rung, b), np.int32)
        last = np.zeros(rung, np.int32)
        for i, src in enumerate(rows):
            toks[i, :len(src.prompt)] = src.prompt
            last[i] = len(src.prompt) - 1
        batch = prefill_batch_of(toks, rows, self.cfg, self.device)
        batch["last_index"] = torch.as_tensor(last, device=self.device)
        logits, cache = self.prefill_fn(self.params, batch)
        for i, req in enumerate(group):
            note_first_token(req, logits[i:i + 1], self.cfg.vocab_size,
                             self.stats)
            row = {name: t[:, i:i + 1] for name, t in cache.items()}
            self._backfilled.append((req, row, len(req.prompt)))
        self.stats["engine"]["prefill_batches"] += 1
        self.stats["engine"]["prefill_batched_reqs"] += k

    def _warm_storage(self) -> None:
        """Admit (and keep) one dummy request so the window warmup runs
        against allocated storage: slot buffers for the dense engine,
        pools and a valid table row for the paged one."""
        self.submit(Request(rid=-1, prompt=np.zeros(1, np.int32),
                            max_new_tokens=1))
        self._admit()

    @torch.no_grad()
    def warmup(self, max_prompt_len: Optional[int] = None,
               rungs: Optional[Sequence[int]] = None) -> None:
        """Run one window at every rung (``rungs``, default all) against
        allocated storage, then reset all serving state, so
        ``stats["decode_compiles"]`` counts from 0.  Eager prefill has
        nothing to compile; the prefill buckets the reference's warmup
        traces for prompts up to ``max_prompt_len`` (default: the bucket
        capacity), single and coalesced, are marked seen, so bucket hits
        and misses count as the reference's do after its warmup."""
        max_len = min(max_prompt_len or self._bucket_cap, self._bucket_cap)
        warm = tuple(r for r in self.rungs
                     if rungs is None or r in set(rungs))
        buckets = sorted({self._bucket_len(s)
                          for s in range(1, max_len + 1)} - {None})
        if self._bucket_enabled:
            self._seen_buckets.update(buckets)
        if self._batch_prefill:
            self._seen_buckets.update((r, b) for r in warm if r >= 2
                                      for b in buckets)
        self._warm_storage()
        for rung in warm:
            # Budget-0 rows are frozen: the window computes and discards
            # their logits; they write only their own slot or the sink.
            zeros = torch.zeros(rung, dtype=torch.int32, device=self.device)
            self._window_call(rung, zeros, zeros, zeros)
        self.reset()
        self._compile_base = len(self._window_rungs)
        self.stats["decode_compiles"] = 0
