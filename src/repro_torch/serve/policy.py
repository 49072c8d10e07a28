"""Scheduling policy: admission classes, ladder targeting, preemption.

The three scheduler decision points — the core/multi packer's admission
order, the :func:`~repro_torch.serve.engine.choose_decode_batch` ladder sweep,
and the coexec backfill pull — all used to consult the queue directly,
so a latency class could not influence any of them without forking the
engines.  :class:`SchedulingPolicy` centralizes those decisions:

* **Admission classes**: every :class:`~repro_torch.serve.engine.Request`
  carries a ``klass`` — ``"interactive"`` (latency-sensitive: admitted
  ahead of batch work, may preempt it) or ``"batch"`` (throughput work:
  FIFO among itself, evictable under pool pressure).  ``klass=None``
  resolves to batch, so single-class workloads behave exactly as before
  this layer existed (no victims, no reordering — the differential
  harness runs unchanged).

* **Queue order** (:meth:`enqueue` / :meth:`requeue`): interactive
  arrivals insert ahead of the first batch entry (FIFO within each
  class); a preempted victim re-enters at the *front* of its class
  segment — it was admitted earliest, and head-of-class restart keeps
  re-admission order deterministic.

* **Ladder targeting** (:meth:`ladder_target`): wraps the SISA ladder
  sweep and, with ``class_priority``, raises the target so waiting
  interactive requests are never deferred by batch quantization alone
  (the sweep optimizes cycles/token and will happily park two
  interactive arrivals behind a full rung of batch work).

* **Victim choice** (:meth:`choose_victim`): under pool pressure the
  engines evict the batch-class resident with the fewest generated
  tokens (least re-prefill waste; ties broken toward the highest slot
  to keep the ladder rung minimal).  Interactive residents are never
  victims; with ``preemption=False`` there are no victims at all and
  pool exhaustion degrades to the pre-policy admit stall.

The policy is a frozen dataclass so it can ride on the frozen
:class:`~repro_torch.serve.api.EngineOptions` and serve as a jit-stable
config value.
"""
from __future__ import annotations

import dataclasses
from typing import Deque, List, Optional, Tuple

KLASS_INTERACTIVE = "interactive"
KLASS_BATCH = "batch"
KLASSES = (KLASS_INTERACTIVE, KLASS_BATCH)


class RejectedError(RuntimeError):
    """Typed load-shedding rejection: the frontend's bounded intake is
    full.  Carries ``retry_after`` (seconds, a hint sized to the current
    backlog) so callers can back off instead of spinning."""

    def __init__(self, message: str, retry_after: float = 0.05):
        super().__init__(message)
        self.retry_after = retry_after


@dataclasses.dataclass(frozen=True)
class SchedulingPolicy:
    """Admission-class scheduling knobs (see module docs).

    ``class_priority`` orders interactive work ahead of batch work at
    every decision point; ``preemption`` additionally lets a blocked
    interactive admission evict a batch-class resident.  Both off is
    byte-for-byte the pre-policy FIFO scheduler.
    """
    class_priority: bool = True
    preemption: bool = True

    # -- class resolution ------------------------------------------------
    @staticmethod
    def klass_of(req) -> str:
        """Resolve a request's class (``None`` -> batch, the default
        that keeps single-class workloads policy-invisible)."""
        return req.klass or KLASS_BATCH

    def is_interactive(self, req) -> bool:
        return self.klass_of(req) == KLASS_INTERACTIVE

    # -- queue order -----------------------------------------------------
    def enqueue(self, queue: Deque, req) -> None:
        """Admission-order insert: interactive ahead of the first batch
        entry (FIFO within each class); plain FIFO without
        ``class_priority``."""
        if not self.class_priority or not self.is_interactive(req):
            queue.append(req)
            return
        for i, other in enumerate(queue):
            if not self.is_interactive(other):
                queue.insert(i, req)
                return
        queue.append(req)

    def requeue(self, queue: Deque, req) -> None:
        """Re-insert a preempted victim at the front of its class
        segment: it was admitted earliest, so head-of-class keeps the
        re-admission order (and therefore the resumed token streams)
        deterministic."""
        if not self.class_priority or self.is_interactive(req):
            queue.appendleft(req)
            return
        for i, other in enumerate(queue):
            if not self.is_interactive(other):
                queue.insert(i, req)
                return
        queue.append(req)

    # -- ladder targeting ------------------------------------------------
    def ladder_target(self, n_live: int, n_interactive: int, cfg,
                      max_batch: int, *,
                      admit_cap: Optional[int] = None) -> int:
        """SISA ladder sweep with a class floor: the target batch never
        quantizes below the interactive demand (clamped to capacity), so
        latency-sensitive admissions are not deferred to pad a cheaper
        rung with batch work."""
        from repro_torch.serve.engine import choose_decode_batch
        target = choose_decode_batch(n_live, cfg, max_batch,
                                     admit_cap=admit_cap)
        target = max(1, min(target or 1, max_batch))
        if self.class_priority and n_interactive > 0:
            floor = min(n_interactive, max_batch)
            if admit_cap is not None:
                floor = min(floor, max(admit_cap, 1))
            target = max(target, floor)
        return target

    # -- preemption ------------------------------------------------------
    def choose_victim(self, resident: List[Tuple[int, object]]
                      ) -> Optional[Tuple[int, object]]:
        """Pick the batch-class victim among ``(slot, req)`` residents:
        fewest generated tokens (cheapest re-prefill), ties toward the
        highest slot (keeps the ladder rung minimal).  ``None`` when
        preemption is off or every resident is interactive."""
        if not self.preemption:
            return None
        candidates = [(s, r) for s, r in resident
                      if not self.is_interactive(r)]
        if not candidates:
            return None
        return min(candidates,
                   key=lambda sr: (len(sr[1].generated), -sr[0]))
