r"""Output-stationary systolic-array cycle + energy simulator.

SCALE-Sim-class analytical model (the paper extends SCALE-Sim v3; we
re-derive the OS-dataflow timing directly).  For one output tile of
``tm x tn`` reduced over ``k`` on a logical array of height ``H_g``:

    cycles(tile) = (tm - 1) + (tn - 1) + k + H_g
                    \____ fill skew ____/   |      (drain through the
                                            |       *physical* group height)
                                            +-- one MAC per K element

The drain term is the paper's key second-order effect: a monolithic
128-high array drains every column through all 128 rows even when only 12
carry useful outputs, while a 16-high slab drains in 16 — this is why
measured speedup (8.52x) exceeds the 8x slab parallelism.

Groups run concurrently; tiles within a group run back-to-back (double
buffering hides the *stream* of the next tile but fill/drain skew is
per-tile, matching SCALE-Sim's serial-tile accounting).  Phase latency is
additionally lower-bounded by DRAM bandwidth.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.scheduler import ExecutionPlan, Phase, plan_gemm, Tile
from repro_torch.core.slab import SISA_128, SlabArrayConfig
from repro_torch.hw.specs import AsicSpec, SISA_ASIC


@dataclasses.dataclass
class SimResult:
    """Cycle/energy accounting for one GEMM (or an aggregate)."""

    cycles: float = 0.0
    macs: float = 0.0
    dram_bytes: float = 0.0
    energy_static_nj: float = 0.0
    energy_dynamic_nj: float = 0.0
    active_slab_cycles: float = 0.0     # Σ slabs-on x cycles
    total_slab_cycles: float = 0.0      # Σ n_slabs x cycles
    anygated_cycles: float = 0.0        # cycles with >= 1 slab gated
    n_pes: int = 0

    @property
    def energy_nj(self) -> float:
        return self.energy_static_nj + self.energy_dynamic_nj

    @property
    def edp(self) -> float:
        """Energy-delay product in nJ x cycles (relative comparisons only)."""
        return self.energy_nj * self.cycles

    @property
    def pe_utilization(self) -> float:
        return self.macs / (self.cycles * self.n_pes) if self.cycles else 0.0

    @property
    def gated_fraction(self) -> float:
        """Fraction of slab-cycles spent power-gated."""
        if not self.total_slab_cycles:
            return 0.0
        return 1.0 - self.active_slab_cycles / self.total_slab_cycles

    @property
    def anygated_fraction(self) -> float:
        """Fraction of execution time with >= 1 slab gated (paper: 44 %
        of execution for Qwen2.5-0.5B at m=16)."""
        return self.anygated_cycles / self.cycles if self.cycles else 0.0

    def __iadd__(self, other: "SimResult") -> "SimResult":
        self.cycles += other.cycles
        self.macs += other.macs
        self.dram_bytes += other.dram_bytes
        self.energy_static_nj += other.energy_static_nj
        self.energy_dynamic_nj += other.energy_dynamic_nj
        self.active_slab_cycles += other.active_slab_cycles
        self.total_slab_cycles += other.total_slab_cycles
        self.anygated_cycles += other.anygated_cycles
        self.n_pes = max(self.n_pes, other.n_pes)
        return self

    def scaled(self, times: int) -> "SimResult":
        r = dataclasses.replace(self)
        for f in ("cycles", "macs", "dram_bytes", "energy_static_nj",
                  "energy_dynamic_nj", "active_slab_cycles",
                  "total_slab_cycles", "anygated_cycles"):
            setattr(r, f, getattr(self, f) * times)
        return r


def tile_cycles(t: Tile, group_h: int) -> int:
    """OS-dataflow cycles for one output tile on a ``group_h``-tall group:
    skew-in + skew-out + K reduction + drain through the group height."""
    return (t.tm - 1) + (t.tn - 1) + t.k + group_h


def phase_dram_bytes(phase: Phase, plan: ExecutionPlan, spec: AsicSpec) -> Dict[str, float]:
    """Off-chip traffic for one phase (A resident, B streamed, C out)."""
    e = spec.elem_bytes
    # Distinct M extents in this phase: monolithic main phase has
    # len(tiles)/n_ntiles full-height rows; single-extent phases have one.
    tiles = [t for g in phase.group_tiles for t in g]
    if not tiles:
        return {"a": 0.0, "b": 0.0, "c": 0.0}
    m_extent = sum(t.tm * t.tn for t in tiles) / plan.n  # == Σ tm per N-sweep
    a_bytes = m_extent * plan.k * e                      # each A row loaded once
    b_fits = plan.k * plan.n * e <= spec.global_buf_bytes // 2
    n_m_sweeps = max(1, round(m_extent / min(plan.m, phase.group_h)))
    b_passes = 1 if b_fits else n_m_sweeps
    b_bytes = plan.k * plan.n * e * b_passes
    c_bytes = m_extent * plan.n * e
    return {"a": a_bytes, "b": b_bytes, "c": c_bytes}


def phase_dynamic_energy_nj(phase: Phase, dram: Dict[str, float],
                            spec: AsicSpec) -> float:
    """Dynamic energy of one phase in nJ (MACs + SRAM/DRAM traffic).

    Shared between the single-GEMM simulator and the multi-tenant packer
    (``repro_torch.core.multi``): dynamic energy depends only on the work, not
    on how phases overlap in time.
    """
    e = spec.elem_bytes
    act_stream = sum(t.tm * t.k for g in phase.group_tiles for t in g) * e
    wgt_stream = sum(t.k * t.tn for g in phase.group_tiles for t in g) * e
    out_bytes = sum(t.tm * t.tn for g in phase.group_tiles for t in g) * e
    global_rw = (dram["a"] + dram["b"]) + (act_stream + wgt_stream)  # write once + read per stream
    has_slab_bufs = spec.slab_act_buf_bytes > 0
    # Fused groups bypass all but one weight buffer: weight bytes pay one
    # slab-buffer hop per group; activations pay one hop always.
    slab_rw = 2.0 * (act_stream + wgt_stream) if has_slab_bufs else 0.0
    out_rw = 2.0 * out_bytes                                # write + drain read
    dram_bytes = sum(dram.values())
    return (
        phase.macs * spec.e_mac_pj
        + global_rw * spec.e_global_sram_pj_per_byte
        + slab_rw * spec.e_slab_sram_pj_per_byte
        + out_rw * spec.e_out_sram_pj_per_byte
        + dram_bytes * spec.e_dram_pj_per_byte
    ) / 1e3                                                 # pJ -> nJ


def per_slab_static_nj(cfg: SlabArrayConfig, spec: AsicSpec) -> float:
    """Static (leakage) energy per slab per cycle: array + slab buffers."""
    per_slab_sa = spec.sa_static_nj / cfg.n_slabs
    per_slab_buf = spec.slab_buf_static_nj / cfg.n_slabs if cfg.n_slabs > 1 else 0.0
    return per_slab_sa + per_slab_buf


def shared_static_nj(spec: AsicSpec) -> float:
    """Static energy per cycle of the always-on shared buffers."""
    return spec.global_buf_static_nj + spec.out_buf_static_nj


def simulate_phase(phase: Phase, plan: ExecutionPlan, cfg: SlabArrayConfig,
                   spec: AsicSpec) -> SimResult:
    group_busy = [sum(tile_cycles(t, phase.group_h) for t in g)
                  for g in phase.group_tiles]
    compute_cycles = max(group_busy) if group_busy else 0

    dram = phase_dram_bytes(phase, plan, spec)
    dram_bytes = sum(dram.values())
    bw_cycles = dram_bytes / spec.dram_bytes_per_cycle
    cycles = max(compute_cycles, bw_cycles)

    # --- per-slab activity (for static energy / gating stats) ---
    n_busy = sum(1 for b in group_busy if b)
    slabs_per_busy_group = phase.active_slabs / max(1, n_busy)
    if cfg.power_gating:
        active_slab_cycles = sum(b * slabs_per_busy_group
                                 for b in group_busy if b)
        # Time with at least one slab gated: whole phase if some slab is
        # structurally off (idle group or partial-M gating inside a
        # group), else the tail after the earliest group finishes.
        if phase.active_slabs < cfg.n_slabs:
            anygated = cycles
        else:
            anygated = cycles - min((b for b in group_busy if b),
                                    default=cycles)
    else:
        active_slab_cycles = cycles * cfg.n_slabs
        anygated = 0.0
    total_slab_cycles = cycles * cfg.n_slabs

    # --- static energy ---
    e_static = (active_slab_cycles * per_slab_static_nj(cfg, spec)
                + cycles * shared_static_nj(spec))

    # --- dynamic energy ---
    e_dynamic = phase_dynamic_energy_nj(phase, dram, spec)

    return SimResult(
        cycles=cycles, macs=phase.macs, dram_bytes=dram_bytes,
        energy_static_nj=e_static, energy_dynamic_nj=e_dynamic,
        active_slab_cycles=active_slab_cycles,
        total_slab_cycles=total_slab_cycles, anygated_cycles=anygated,
        n_pes=cfg.n_pes)


def simulate_gemm(m: int, n: int, k: int,
                  cfg: SlabArrayConfig = SISA_128,
                  spec: AsicSpec = SISA_ASIC,
                  plan: Optional[ExecutionPlan] = None) -> SimResult:
    """Cycle/energy/DRAM model of one GEMM under the §3.2 plan (or a
    caller-supplied ``plan``): per-phase tile cycles on the critical
    group, plus dynamic + gated static energy and off-chip traffic."""
    plan = plan or plan_gemm(m, n, k, cfg, spec.global_buf_bytes, spec.elem_bytes)
    total = SimResult(n_pes=cfg.n_pes)
    for phase in plan.phases:
        total += simulate_phase(phase, plan, cfg, spec)
    return total


def simulate_workload(gemms: List[tuple], cfg: SlabArrayConfig = SISA_128,
                      spec: AsicSpec = SISA_ASIC) -> SimResult:
    """Aggregate a list of ``(m, n, k, occurrences)``."""
    total = SimResult(n_pes=cfg.n_pes)
    for (m, n, k, occ) in gemms:
        total += simulate_gemm(m, n, k, cfg, spec).scaled(occ)
    return total
