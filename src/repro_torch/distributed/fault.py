"""Straggler detection for the training loop (the single-device part of
``repro/distributed/fault.py``; elastic re-mesh planning belongs to the
distributed slice of the port)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor: flags steps beyond ``threshold`` x the
    moving average (single host: data-pipeline or device stalls)."""

    threshold: float = 3.0
    alpha: float = 0.1
    _ewma: Optional[float] = None
    flagged: List[Tuple[int, float]] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if self._ewma is not None and dt > self.threshold * self._ewma:
            self.flagged.append((step, dt))
            is_straggler = True
            # do not poison the EWMA with the outlier
        else:
            self._ewma = dt if self._ewma is None else (
                (1 - self.alpha) * self._ewma + self.alpha * dt)
        return is_straggler
