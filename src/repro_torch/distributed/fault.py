"""Fault tolerance: the straggler watchdog and elastic re-mesh planning
(the port of ``repro/distributed/fault.py``).

A lost device cannot be repaired from inside the program: recovery is
detect (the watchdog, a device probe) -> exclude the device -> plan a
smaller mesh (:func:`plan_elastic_mesh`) -> rebuild on it.  The serving
frontend wires the halves together
(:meth:`repro_torch.serve.frontend.ServeFrontend._recover`), and the
tests shrink a device list with :func:`simulate_failure`."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


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


def plan_elastic_mesh(n_healthy: int, *, model_parallel: int = 16,
                      min_data: int = 1) -> Optional[Tuple[int, int]]:
    """The largest ``(data, model)`` mesh that fits ``n_healthy``
    devices: the model axis stays fixed (parameter sharding must stay
    divisible) and the data axis shrinks; None below ``min_data``."""
    data = n_healthy // model_parallel
    if data < min_data:
        return None
    return (data, model_parallel)


def simulate_failure(devices: Sequence, n_failed: int) -> List:
    """Test hook: drop the last ``n_failed`` devices (the failed
    host)."""
    return list(devices[:len(devices) - n_failed])
