"""Deterministic fault injection for the serving stack (the port of
``repro/serve/faults.py``; numpy only, the same draws for a seed).

The overload layer (admission classes, preemption, deadlines,
cancellation, backpressure) only earns trust if every failure mode is
exercised *reproducibly*: a chaos test that cannot replay its fault
sequence cannot pin its invariants.  This module provides that
harness:

* :class:`FaultEvent` — one injected fault, pinned to a scheduler
  *cycle* number (the :class:`~repro_torch.serve.frontend.ServeFrontend`
  scheduler counts cycles; faults fire at cycle start, before the
  engine steps).

* :class:`FaultPlan` — an immutable schedule of events.
  :meth:`FaultPlan.random` draws a plan from a seeded
  ``numpy.random.Generator``, so a seed replays the exact storm;
  hand-built plans pin individual scenarios.

Fault kinds (each degrades to a recorded no-op when the wrapped engine
lacks the faulted surface — e.g. ``exhaust_pages`` on a dense engine):

===================  ====================================================
``exhaust_pages``    Seize ``arg`` free pages from the paged pool under
                     a ghost reservation
                     (``PagedKVCache.seize_pages``)
                     — admissions see genuine pool pressure.
``heal_pages``       Return every seized page to the pool.
``preempt``          Forcibly evict ``arg`` residents
                     (``SlotServeEngine.preempt``)
                     — a preemption storm; evictees resume
                     token-identically.
``straggler``        Inflate the next window's observed step time by
                     ``10 * arg`` seconds into the straggler watchdog —
                     flags the straggler and triggers a device re-probe.
``cancel``           Cancel the lowest-rid in-flight request (resolves
                     ``finish_reason="cancelled"``, frees its storage).
``expire``           Force the lowest-rid in-flight request's deadline
                     to *now* (resolves ``finish_reason="deadline"``).
``raise_callback``   Replace the lowest-rid in-flight handle's
                     ``on_token`` with one that raises — the emit
                     thread must quarantine it and keep serving.
===================  ====================================================

The chaos suite (``tests/test_torch_overload.py``) drives a seeded plan
through a saturated frontend and asserts the system-level postcondition:
every handle resolves, the allocator drains to zero leaked pages/slots,
and every surviving request's tokens are identical to an unfaulted
serve.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("exhaust_pages", "heal_pages", "preempt", "straggler",
               "cancel", "expire", "raise_callback")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault: ``kind`` fires at scheduler cycle ``step``;
    ``arg`` scales it (pages to seize, residents to evict, straggler
    severity — ignored by the request-targeted kinds)."""
    step: int
    kind: str
    arg: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind={self.kind!r} not in {FAULT_KINDS}")
        if self.step < 0 or self.arg < 1:
            raise ValueError(f"step={self.step}/arg={self.arg} must be "
                             ">= 0 / >= 1")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, replayable schedule of :class:`FaultEvent`."""
    events: Tuple[FaultEvent, ...]

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    def events_at(self, step: int) -> List[FaultEvent]:
        """Events scheduled for scheduler cycle ``step`` (plan order)."""
        return [e for e in self.events if e.step == step]

    @property
    def horizon(self) -> int:
        """Last scheduled cycle (-1 for an empty plan)."""
        return max((e.step for e in self.events), default=-1)

    @classmethod
    def random(cls, seed: int, *, n_events: int = 8, horizon: int = 48,
               kinds: Sequence[str] = FAULT_KINDS,
               max_arg: int = 4) -> "FaultPlan":
        """Draw a deterministic plan from ``seed``.  Every
        ``exhaust_pages`` seizure is paired with a later ``heal_pages``
        so a finite workload always drains; the other kinds are sampled
        uniformly over the horizon."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for _ in range(n_events):
            kind = kinds[int(rng.integers(len(kinds)))]
            step = int(rng.integers(horizon))
            arg = int(rng.integers(1, max_arg + 1))
            if kind == "heal_pages":
                # Standalone heals are harmless no-ops; keep them —
                # they fuzz the "heal with nothing seized" edge.
                events.append(FaultEvent(step, kind))
            elif kind == "exhaust_pages":
                heal = int(rng.integers(step + 1, step + horizon // 2 + 2))
                events.append(FaultEvent(step, kind, arg))
                events.append(FaultEvent(heal, "heal_pages"))
            else:
                events.append(FaultEvent(step, kind, arg))
        events.sort(key=lambda e: (e.step, FAULT_KINDS.index(e.kind)))
        return cls(events=tuple(events))
