"""Online request-lifecycle frontend: async intake over the ladder loop
(the port of ``repro/serve/frontend.py``).

The engines' ``run()`` is an offline host loop — every request must be
queued up front, and results only exist when the whole queue drains.
This module adds the arrival-rate axis: an always-on service wrapping
one engine, with

* **Thread-safe intake**: :meth:`ServeFrontend.submit` can be called
  from any thread at any time; it returns a :class:`RequestHandle`
  immediately (streaming token list, completion event, optional
  per-token callback) and parks the request on an intake queue.

* **Window-boundary scheduling**: a single scheduler thread owns the
  engine.  Each cycle it (1) admits arrivals up to the engine's free
  capacity, *coalescing same-bucket prompts into one batched
  multi-prompt prefill-insert per bucket*
  (:meth:`~repro_torch.serve.slot_engine.SlotServeEngine.prefill_batch`)
  so a burst of k arrivals costs one ``(rung, bucket)`` prefill call
  instead of k, (2) drives one engine ``step()`` — one decode window —
  and (3) flushes every newly generated token onto a backlog queue.

* **Detokenize/emit thread**: a second thread drains the backlog into
  per-request delivery — appending to the handle's token stream and
  invoking its callback in strict per-request order (tokens, then the
  :class:`~repro_torch.serve.api.Completion`).  Decode windows never
  block on user callbacks.

* **Graceful drain/shutdown**: :meth:`drain` blocks until everything
  in flight has completed; :meth:`shutdown` drains (or aborts, when
  ``drain=False`` — inflight handles resolve with
  ``finish_reason="aborted"``) and joins both threads.

* **Warmup**: :meth:`warmup` runs the engine's
  :meth:`~repro_torch.serve.slot_engine.SlotServeEngine.warmup` (one
  window at every rung, the prefill buckets marked seen), so steady
  state serves with ``stats["decode_compiles"] == 0``, online as
  offline.

* **Fault recovery hooks**: pass a
  :class:`~repro_torch.distributed.fault.StragglerWatchdog` and a
  ``device_probe`` callable and the scheduler times every decode window
  into the watchdog; a flagged straggler (and, cheaply, every cycle)
  re-probes the device set.  A shrunk probe asks the engine to rebuild
  its mesh; no engine of the port has a mesh yet, so recovery returns
  at once and ``remeshes`` stays 0, as the reference's does for a
  meshless engine.

**Kernels and threads.** The engine is touched only with the frontend's
mutex held: by the scheduler thread, and by :meth:`warmup` in the
caller's thread.  So no two threads ever launch a kernel at once; the
launch counters, K1's tensor-map caches and K2's cached workspace
(``repro_torch.kernels.paged_attn._workspace``), none of them
thread-safe, are only ever touched by one thread at a time.  Every
launch goes to the device's default stream, which the engines' caches
and K2's workspace are written on, so launches from the two threads
stay in order.  The scheduler thread makes the engine's device its
current CUDA device, which is per thread.  A decode window holds the
mutex for its whole wall time (hundreds of milliseconds when the host
bounds it), and Python's locks are not fair: a submitter waiting on the
mutex would get through about once a window, so arrivals would be
admitted windows apart.  So intake bookkeeping has a lock of its own,
and a submit, a cancel, a drain or a completion never waits for a
window.  An exception in the
scheduler thread ends it (as in the reference), and :meth:`drain` then
times out; callers that must not miss it install a
``threading.excepthook``.

Token identity: the slot/paged engines' rows are batch-invariant and
their batched prefill is the single-prompt prefill per row (bitwise on
the CPU; on the card K1 may sum in another order at another M), so the
frontend's reordered, coalesced admission produces exactly the tokens
of the offline ``run()`` on the same requests (pinned in
``tests/test_torch_frontend.py``).  The sequential engine is served
too, but its mixed-length batches are not batch-invariant — no
identity claim.

TTFT/TPOT here are *user-observed*: stamped at emission by the emit
thread (submission -> first delivered token; mean gap thereafter), not
at the engine's internal prefill, so queueing delay under load is part
of the number.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.serve.api import (Completion, FINISH_ABORTED,
                                   FINISH_CANCELLED, FINISH_DEADLINE,
                                   FINISH_LENGTH, FINISH_MAX_SEQ)
from repro_torch.serve.engine import Request
from repro_torch.serve.policy import KLASSES, RejectedError

_SHUTDOWN = object()


class _Done:
    """Backlog sentinel: all of ``req``'s tokens precede it in the
    backlog, so delivery order per request is tokens-then-completion.
    ``reason`` pins a lifecycle exit (abort/cancel/deadline); ``None``
    means a natural finish, classified by budget accounting."""

    def __init__(self, req: Request, aborted: bool = False,
                 reason: Optional[str] = None):
        self.req = req
        self.reason = reason or (FINISH_ABORTED if aborted else None)


class RequestHandle:
    """Streaming view of one in-flight request.

    ``tokens`` snapshots the delivered stream so far; ``result()``
    blocks for the :class:`~repro_torch.serve.api.Completion`.  The
    ``on_token`` callback (if given) runs on the emit thread, once per
    token, in generation order; a raising callback never disturbs the
    serve (the exception is kept on ``callback_error``).
    """

    def __init__(self, rid: int, max_new_tokens: int,
                 on_token: Optional[Callable[[int], None]] = None):
        self.rid = rid
        self.max_new_tokens = max_new_tokens
        self.submitted_at = time.time()
        self.first_emitted_at: Optional[float] = None
        self.callback_error: Optional[BaseException] = None
        self._on_token = on_token
        self._tokens: List[int] = []
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._completion: Optional[Completion] = None
        # Wired by ServeFrontend.submit; standalone handles can't cancel.
        self._cancel_cb: Optional[Callable[[int], None]] = None

    @property
    def tokens(self) -> List[int]:
        with self._lock:
            return list(self._tokens)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Completion:
        """Block until the request completes; returns its Completion."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still in flight")
        return self._completion

    def cancel(self) -> bool:
        """Request mid-flight cancellation: the scheduler releases the
        engine resources (slot/pages) at its next cycle and the handle
        resolves with ``finish_reason="cancelled"`` (tokens delivered so
        far are kept).  Returns False if already done (or the handle is
        not attached to a frontend); True once the cancel is filed —
        resolution is asynchronous, ``result()`` observes it."""
        if self._done.is_set() or self._cancel_cb is None:
            return False
        self._cancel_cb(self.rid)
        return True

    # Emit-thread side ---------------------------------------------------
    def _deliver(self, toks: Sequence[int]) -> None:
        for t in toks:
            if self.first_emitted_at is None:
                self.first_emitted_at = time.time()
            with self._lock:
                self._tokens.append(t)
            if self._on_token is not None:
                try:
                    self._on_token(t)
                except BaseException as e:  # noqa: B036 - user callback
                    self.callback_error = e
                    self._on_token = None

    def _finish(self, completion: Completion) -> None:
        self._completion = completion
        self._done.set()


class ServeFrontend:
    """Always-on serving service over one engine (see module docs).

    Threads start lazily at the first :meth:`submit` (or explicitly via
    :meth:`start`); the instance is a context manager whose exit drains
    and shuts down.  Only the scheduler thread ever touches the engine
    (and :meth:`warmup`, under the same mutex); :attr:`stats` and
    :meth:`metrics` take that mutex, so they can be read at any time.
    Intake bookkeeping (rids, handles, completions, cancels, the
    deferred backlog) has a lock of its own, taken after the mutex where
    both are held: :meth:`submit`, :meth:`RequestHandle.cancel`,
    :meth:`drain` and the emit thread never wait for a decode window,
    which holds the mutex for its whole wall time.
    """

    def __init__(self, engine, *, idle_wait: float = 0.002,
                 watchdog=None, device_probe=None, min_data: int = 1,
                 max_queued: Optional[int] = None, fault_plan=None):
        self.engine = engine
        self.idle_wait = idle_wait
        # Fault recovery (mesh-aware engines only): `watchdog` is a
        # StragglerWatchdog fed with per-window step times; `device_probe`
        # returns the currently-healthy device list (tests shrink a fake
        # set).
        self.watchdog = watchdog
        self.device_probe = device_probe
        self.min_data = min_data
        self.remeshes = 0
        # Overload robustness: `max_queued` bounds the not-yet-admitted
        # backlog (over-limit submits raise RejectedError — typed load
        # shedding, never a silent drop); `fault_plan` is a
        # repro_torch.serve.faults.FaultPlan injected at scheduler-cycle
        # granularity (chaos testing).
        self.max_queued = max_queued
        self.fault_plan = fault_plan
        self.fault_log: List[Tuple[int, str, int]] = []
        self.rejected = 0
        self._cycle = 0
        self._seized_pages: List[int] = []
        self._cancels: set = set()
        self._slow_next = 0.0          # straggler-fault dt inflation
        self._fault_cursor = -1        # last cycle whose faults fired
        # Admitted-capacity overflow (batch-class only — interactive
        # arrivals bypass the capacity cap so preemption can serve
        # them); written by the scheduler thread, read and written under
        # the intake lock.
        self._deferred: List[Tuple[Request, RequestHandle]] = []
        self._healthy_n: Optional[int] = None
        self._step_idx = 0
        self._intake: "queue.Queue" = queue.Queue()
        self._backlog: "queue.Queue" = queue.Queue()
        self._mutex = threading.Lock()      # engine + tracking state
        self._intake_lock = threading.Lock()  # rids, handles, cancels
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._abort = threading.Event()
        # rid -> (req, handle, n_emitted); scheduler thread only.
        self._tracked: Dict[int, List[Any]] = {}
        self._handles: List[RequestHandle] = []
        self._completions: List[Completion] = []
        self._next_rid = 0
        self._started = False
        self._scheduler_t: Optional[threading.Thread] = None
        self._emitter_t: Optional[threading.Thread] = None
        self.coalesced_prefills = 0          # batched-prefill admissions

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ServeFrontend":
        if self._started:
            return self
        self._started = True
        self._scheduler_t = threading.Thread(target=self._scheduler,
                                             name="serve-scheduler",
                                             daemon=True)
        self._emitter_t = threading.Thread(target=self._emitter,
                                           name="serve-emit", daemon=True)
        self._scheduler_t.start()
        self._emitter_t.start()
        return self

    def __enter__(self) -> "ServeFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    def warmup(self, max_prompt_len: Optional[int] = None,
               rungs: Optional[Sequence[int]] = None) -> None:
        """Warm every serving entry point before taking load (engines
        without a ``warmup`` hook — the sequential engine — no-op; their
        compile count is per batch shape).  Runs in the caller's thread
        with the mutex held (see the module docs)."""
        with self._mutex:
            if hasattr(self.engine, "warmup"):
                self.engine.warmup(max_prompt_len, rungs=rungs)

    def submit(self, prompt, max_new_tokens: int, *,
               rid: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None,
               klass: Optional[str] = None,
               deadline: Optional[float] = None) -> RequestHandle:
        """Enqueue one request; returns its streaming handle at once.

        ``klass`` is the admission class (``"interactive"`` |
        ``"batch"``; ``None`` defers to the engine default) and
        ``deadline`` a per-request timeout in seconds from now — an
        expired request is released wherever it is (queued, deferred, or
        decoding) and resolves with ``finish_reason="deadline"``.  With
        ``max_queued`` set, a full backlog raises
        :class:`~repro_torch.serve.policy.RejectedError` instead of queueing
        unboundedly.
        """
        if self._stop.is_set():
            raise RuntimeError("frontend is shut down")
        if klass is not None and klass not in KLASSES:
            raise ValueError(f"klass={klass!r} not in {KLASSES}")
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline={deadline} must be > 0 seconds")
        with self._intake_lock:
            if self.max_queued is not None:
                backlog = self._intake.qsize() + len(self._deferred)
                if backlog >= self.max_queued:
                    self.rejected += 1
                    raise RejectedError(
                        f"intake full ({backlog} >= max_queued="
                        f"{self.max_queued})",
                        retry_after=max(4 * self.idle_wait,
                                        0.01 * backlog))
            if rid is None:
                rid = self._next_rid
            self._next_rid = max(self._next_rid, rid) + 1
        handle = RequestHandle(rid, max_new_tokens, on_token)
        handle._cancel_cb = self._file_cancel
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens,
                      arrived=handle.submitted_at, klass=klass,
                      deadline=None if deadline is None
                      else handle.submitted_at + deadline)
        with self._intake_lock:
            self._handles.append(handle)
        self.start()
        self._intake.put((req, handle))
        self._wake.set()
        return handle

    def _file_cancel(self, rid: int) -> None:
        """File a cancellation (any thread); the scheduler reaps it at
        its next cycle."""
        with self._intake_lock:
            self._cancels.add(rid)
        self._wake.set()

    def drain(self, timeout: Optional[float] = None) -> List[Completion]:
        """Block until every submitted request has completed; returns
        all completions so far in submission order."""
        deadline = None if timeout is None else time.time() + timeout
        with self._intake_lock:
            pending = list(self._handles)
        for h in pending:
            left = None if deadline is None else deadline - time.time()
            if not h._done.wait(left if left is None else max(left, 0)):
                raise TimeoutError(
                    f"drain timed out with request {h.rid} in flight")
        with self._intake_lock:
            return list(self._completions)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the service.  ``drain=True`` finishes inflight work
        first; ``drain=False`` aborts it (handles resolve with
        ``finish_reason="aborted"``).  Idempotent; joins both threads."""
        if self._started and drain and not self._stop.is_set():
            self.drain(timeout)
        if not drain:
            self._abort.set()
        self._stop.set()
        self._wake.set()
        if not self._started:
            return
        self._scheduler_t.join(timeout=30)
        self._backlog.put(_SHUTDOWN)
        self._emitter_t.join(timeout=30)

    # -- scheduler thread ------------------------------------------------
    def _free_capacity(self) -> int:
        eng = self.engine
        active = eng._n_active() if hasattr(eng, "_n_active") else 0
        inflight = active + len(eng.queue) + len(eng._backfilled)
        return max(eng.max_batch - inflight, 0)

    def _intake_flush(self) -> bool:
        """Admit arrivals up to the engine's free capacity, coalescing
        same-bucket prompts into one batched prefill-insert each.

        Interactive arrivals bypass the capacity cap — under saturation
        they must reach the engine's queue, where the scheduling policy
        admits them (preempting batch work if the pool is full); batch
        arrivals beyond capacity defer to a later cycle.  Entries
        cancelled or deadline-expired before admission resolve here
        without ever touching the engine.
        """
        eng = self.engine
        with self._mutex:
            cap = self._free_capacity()
        with self._intake_lock:
            pending = self._deferred
            self._deferred = []
            cancels = set(self._cancels)
        while True:
            try:
                pending.append(self._intake.get_nowait())
            except queue.Empty:
                break
        if not pending:
            return False
        policy = getattr(eng, "policy", None)
        now = time.time()
        admit: List[Tuple[Request, RequestHandle]] = []
        defer: List[Tuple[Request, RequestHandle]] = []
        resolved: List[Tuple[Request, RequestHandle, str]] = []
        n_batch = 0
        for req, handle in pending:
            if req.klass is None:
                # prefill_batch skips engine.submit(), so the engine
                # default class is stamped here.
                req.klass = getattr(eng, "default_klass", None)
            if req.rid in cancels:
                resolved.append((req, handle, FINISH_CANCELLED))
            elif req.deadline is not None and now >= req.deadline:
                resolved.append((req, handle, FINISH_DEADLINE))
            elif policy is not None and policy.class_priority \
                    and policy.is_interactive(req):
                admit.append((req, handle))
            elif n_batch < cap:
                admit.append((req, handle))
                n_batch += 1
            else:
                defer.append((req, handle))
        with self._mutex:
            with self._intake_lock:
                for req, handle, reason in resolved:
                    req.done = True
                    req.finish_reason = reason
                    self._cancels.discard(req.rid)
                    self._backlog.put((handle, _Done(req, reason=reason)))
                self._deferred = defer + self._deferred
            if admit:
                for req, handle in admit:
                    self._tracked[req.rid] = [req, handle, 0]
                if hasattr(eng, "prefill_batch"):
                    # Same-bucket arrivals prefill as one batched call;
                    # the rows park decode-ready in the engine's
                    # backfill queue and the next window admits them in
                    # policy order.
                    key = (lambda item:
                           eng._bucket_len(len(item[0].prompt))
                           or len(item[0].prompt))
                    ordered = sorted(admit, key=key)
                    eng.prefill_batch([req for req, _ in ordered])
                    self.coalesced_prefills += 1
                else:
                    for req, _ in admit:
                        eng.submit(req)
                # The engines' submit() stamps arrival at queue time;
                # restore the true submission stamps.
                for req, handle in admit:
                    req.arrived = handle.submitted_at
                self._emit_new()
        return bool(admit) or bool(resolved)

    def _emit_new(self) -> None:
        """Push every not-yet-emitted token to the backlog (called with
        the mutex held, scheduler thread only)."""
        for rid in list(self._tracked):
            req, handle, n = self._tracked[rid]
            fresh = req.generated[n:]
            if fresh:
                self._backlog.put((handle, list(fresh)))
                self._tracked[rid][2] = n + len(fresh)
            if req.done:
                self._backlog.put((handle, _Done(req)))
                with self._intake_lock:
                    self._cancels.discard(rid)
                del self._tracked[rid]

    def _reap(self) -> int:
        """Resolve filed cancellations and expired deadlines for admitted
        requests (mutex held): the engine releases the slot/pages, any
        already-generated tokens flush, the handle resolves with the
        lifecycle reason.  Pre-admission entries resolve at intake flush
        instead.  Returns the number of requests reaped."""
        now = time.time()
        with self._intake_lock:
            cancels = set(self._cancels)
            self._cancels -= set(self._tracked)
        victims: List[Tuple[int, str]] = []
        for rid, (req, _handle, _n) in self._tracked.items():
            if rid in cancels:
                victims.append((rid, FINISH_CANCELLED))
            elif req.deadline is not None and now >= req.deadline:
                victims.append((rid, FINISH_DEADLINE))
        for rid, reason in victims:
            req, handle, n = self._tracked.pop(rid)
            if hasattr(self.engine, "cancel"):
                self.engine.cancel(rid)
            req.done = True
            req.finish_reason = reason
            fresh = req.generated[n:]
            if fresh:
                self._backlog.put((handle, list(fresh)))
            self._backlog.put((handle, _Done(req, reason=reason)))
        return len(victims)

    def _apply_faults(self) -> None:
        """Fire this cycle's scheduled fault events (mutex held).  The
        cursor makes each cycle's events one-shot: the fault clock only
        advances on productive cycles, and idle scheduler spins must not
        replay the current cycle's storm."""
        if self.fault_plan is None or self._cycle == self._fault_cursor:
            return
        self._fault_cursor = self._cycle
        for ev in self.fault_plan.events_at(self._cycle):
            self._apply_fault(ev)

    def _apply_fault(self, ev) -> None:
        eng = self.engine
        did = 0
        if ev.kind == "exhaust_pages":
            cache = getattr(eng, "cache", None)
            if hasattr(cache, "seize_pages"):
                seized = cache.seize_pages(ev.arg)
                self._seized_pages.extend(seized)
                did = len(seized)
        elif ev.kind == "heal_pages":
            cache = getattr(eng, "cache", None)
            if self._seized_pages and hasattr(cache, "restore_pages"):
                did = len(self._seized_pages)
                cache.restore_pages(self._seized_pages)
                self._seized_pages = []
        elif ev.kind == "preempt":
            if hasattr(eng, "preempt"):
                did = eng.preempt(ev.arg)
        elif ev.kind == "straggler":
            # Surfaces at the next consumed window as an inflated step
            # time fed to the watchdog (the straggler path).
            self._slow_next += 10.0 * ev.arg
            did = ev.arg
        elif ev.kind in ("cancel", "expire"):
            if self._tracked:
                rid = min(self._tracked)
                if ev.kind == "cancel":
                    with self._intake_lock:
                        self._cancels.add(rid)
                else:
                    self._tracked[rid][0].deadline = time.time()
                did = 1
        elif ev.kind == "raise_callback":
            if self._tracked:
                rid = min(self._tracked)
                handle = self._tracked[rid][1]

                def _boom(_tok, _rid=rid):
                    raise RuntimeError(
                        f"injected callback fault (rid {_rid})")
                handle._on_token = _boom
                did = 1
        self.fault_log.append((self._cycle, ev.kind, did))

    def _scheduler(self) -> None:
        dev = getattr(self.engine, "device", None)
        if dev is not None and dev.type == "cuda" and dev.index is not None:
            # The current CUDA device is per thread: launch on the engine's.
            torch.cuda.set_device(dev)
        finished: List[Request] = []
        while True:
            if self._abort.is_set():
                break
            moved = self._intake_flush()
            with self._mutex:
                self._apply_faults()
                reaped = self._reap()
                self._check_devices()
                t0 = time.perf_counter()
                consumed = self.engine.step(finished)
                dt = time.perf_counter() - t0
                if self.watchdog is not None and consumed:
                    dt += self._slow_next
                    self._slow_next = 0.0
                    if self.watchdog.observe(self._step_idx, dt):
                        # A stalled window is how a lost shard shows up
                        # from inside the host loop — re-probe at once.
                        self._check_devices()
                    self._step_idx += 1
                self._emit_new()
                finished.clear()
                if consumed or moved or reaped:
                    # The fault clock ticks on productive cycles only,
                    # so a plan replays identically regardless of how
                    # long the scheduler idles between work.
                    self._cycle += 1
            if self._stop.is_set() and not consumed and not moved \
                    and not reaped and self._intake.empty() \
                    and not self._deferred:
                break
            if not moved and not consumed and not reaped:
                self._wake.wait(self.idle_wait)
                self._wake.clear()
        with self._mutex:
            self._heal_seized()
        if self._abort.is_set():
            self._abort_inflight()

    def _heal_seized(self) -> None:
        """Return any still-seized pages at scheduler exit (mutex held):
        the injector ghosts pool capacity, it never leaks it — a plan
        whose ``heal_pages`` cycle was never reached must not leave the
        pool short after shutdown."""
        if not self._seized_pages:
            return
        cache = getattr(self.engine, "cache", None)
        if hasattr(cache, "restore_pages"):
            self.fault_log.append(
                (self._cycle, "heal_pages", len(self._seized_pages)))
            cache.restore_pages(self._seized_pages)
            self._seized_pages = []

    # -- fault recovery --------------------------------------------------
    def _check_devices(self) -> None:
        """Probe device health (mutex held, scheduler thread only); a
        shrunk probe triggers elastic recovery."""
        if self.device_probe is None:
            return
        healthy = list(self.device_probe())
        if self._healthy_n is not None and len(healthy) < self._healthy_n:
            self._recover(healthy)
        self._healthy_n = len(healthy)

    def _recover(self, healthy) -> None:
        """Rebuild the engine's mesh on the surviving devices and release
        the victims for re-prefill (mutex held).  The port's engines have
        no mesh, so this returns at once, as the reference's does for a
        meshless engine; elastic re-mesh (``plan_elastic_mesh`` and the
        engines' ``remesh``) belongs to the distributed slice of the port
        (ROADMAP.md, queue A item 3)."""
        eng = self.engine
        if getattr(eng, "mesh", None) is None or not hasattr(eng, "remesh"):
            return
        raise NotImplementedError(
            "elastic re-mesh is not ported yet (ROADMAP.md, queue A item 3)")

    def _abort_inflight(self) -> None:
        with self._mutex, self._intake_lock:
            leftovers = list(self._tracked.values())
            self._tracked.clear()
            leftovers.extend([req, handle, 0]
                             for req, handle in self._deferred)
            self._deferred = []
            while True:
                try:
                    req, handle = self._intake.get_nowait()
                except queue.Empty:
                    break
                leftovers.append([req, handle, 0])
        for req, handle, _n in leftovers:
            self._backlog.put((handle, _Done(req, aborted=True)))

    # -- emit thread -----------------------------------------------------
    def _emitter(self) -> None:
        while True:
            item = self._backlog.get()
            if item is _SHUTDOWN:
                break
            handle, payload = item
            if isinstance(payload, _Done):
                completion = self._completion_for(payload, handle)
                with self._intake_lock:
                    self._completions.append(completion)
                handle._finish(completion)
            else:
                handle._deliver(payload)

    def _completion_for(self, done: _Done, handle: RequestHandle
                        ) -> Completion:
        req = done.req
        n = len(req.generated)
        first = handle.first_emitted_at or handle.submitted_at
        now = time.time()
        reason = done.reason or getattr(req, "finish_reason", None)
        if reason is None:
            reason = (FINISH_LENGTH if n >= req.max_new_tokens
                      else FINISH_MAX_SEQ)
        return Completion(
            rid=req.rid, tokens=tuple(req.generated),
            ttft=max(0.0, first - handle.submitted_at),
            tpot=max(0.0, (now - first) / (n - 1)) if n > 1 else 0.0,
            finish_reason=reason)

    # -- observability ---------------------------------------------------
    @property
    def stats(self) -> Dict[str, Any]:
        """Snapshot of the wrapped engine's stats (shared schema)."""
        import copy
        with self._mutex:
            return copy.deepcopy(self.engine.stats)

    def metrics(self) -> Dict[str, Any]:
        """Frontend-level service metrics (user-observed latency)."""
        with self._mutex, self._intake_lock:
            comps = list(self._completions)
            return {
                "submitted": len(self._handles),
                "completed": len(comps),
                "inflight": len(self._handles) - len(comps),
                "coalesced_prefills": self.coalesced_prefills,
                "remeshes": self.remeshes,
                "rejected": self.rejected,
                "deferred": len(self._deferred),
                "faults": len(self.fault_log),
                "finish_reasons": {
                    r: sum(1 for c in comps if c.finish_reason == r)
                    for r in sorted({c.finish_reason for c in comps})},
                "stragglers": (len(self.watchdog.flagged)
                               if self.watchdog is not None else 0),
                "ttft": [c.ttft for c in comps],
                "tpot": [c.tpot for c in comps if c.n_tokens > 1],
            }
