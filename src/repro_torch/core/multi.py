"""Multi-tenant slab scheduling: concurrent GEMMs on one SISA array.

The paper schedules one GEMM at a time; its §3.2 modes leave slab groups
idle (power-gated) whenever the GEMM's M extent or N-tile count cannot
fill all eight slabs.  In continuous-batching LLM serving and MoE expert
dispatch the accelerator always has *other* pending GEMMs that could run
on those idle slabs — this module packs them.

Model
-----
* Every pending GEMM (:class:`GemmRequest`) decomposes into independent
  output-tile tasks (disjoint C tiles, OS accumulation is tile-local).
  A tile with ``tm`` rows needs ``ceil(tm / slab_h)`` **contiguous**
  slabs (adjacent slabs fuse through the weight-bypass muxes;
  non-adjacent cannot) and drains through that exact height — tenants
  scale in to ``ceil`` rather than the single-tenant power-of-two group.
* The packer is **event-driven at tile granularity**: whenever a tile
  finishes, its slabs return to the free pool and the next tile task —
  from *any* tenant — is placed (arrival-ordered round-robin, with
  backfill past tenants whose tiles do not fit).  Co-resident tenants
  therefore overlap in time and the makespan is set by the critical
  slab, not the serial sum; DRAM is shared, so the makespan is also
  lower-bounded by total traffic / bandwidth.
* Gating/energy per slab group: a tenant pays slab static energy only on
  the slabs it holds, for the time it holds them; the shared global/out
  buffers are paid once over the makespan.  Dynamic energy equals the
  serial sum (same MACs, same traffic).

``pack_requests`` also evaluates the serial single-tenant schedule and
returns whichever is faster — serial execution is always a legal
schedule, so packing never loses to the paper's per-GEMM baseline.
"""
from __future__ import annotations

from collections import deque
import dataclasses
import heapq
import math
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler import ExecutionPlan, Phase, Tile
from repro_torch.core.simulator import (per_slab_static_nj, phase_dram_bytes,
                                  phase_dynamic_energy_nj, shared_static_nj,
                                  SimResult, simulate_gemm, tile_cycles)
from repro_torch.core.slab import ExecMode, SISA_128, SlabArrayConfig, split_n_tiles
from repro_torch.hw.specs import AsicSpec, SISA_ASIC


@dataclasses.dataclass(frozen=True)
class GemmRequest:
    """One pending GEMM: ``C[m,n] = A[m,k] @ B[k,n]``."""

    rid: int
    m: int
    n: int
    k: int
    tag: str = ""

    def __post_init__(self):
        if min(self.m, self.n, self.k) <= 0:
            raise ValueError(f"GEMM dims must be positive: {self}")

    @property
    def macs(self) -> int:
        return self.m * self.n * self.k


@dataclasses.dataclass(frozen=True)
class TileRun:
    """One tile task's residency: which slabs, when, for which request.

    ``tile`` carries the output tile the run executes (``None`` only for
    schedules built before PR 3); the co-exec lowering reads it to map
    the simulated placement onto kernel grid tasks.
    """

    rid: int
    slabs: Tuple[int, ...]          # contiguous physical slab ids
    start: float
    end: float
    tile: Optional[Tile] = None

    @property
    def duration(self) -> float:
        return self.end - self.start

    def overlaps(self, other: "TileRun") -> bool:
        return self.start < other.end and other.start < self.end


@dataclasses.dataclass
class PackedSchedule:
    """Result of packing a request set onto one array."""

    tile_runs: List[TileRun]                # fine-grained timeline
    makespan: float
    result: SimResult                       # aggregate (cycles == makespan)
    per_request: Dict[int, SimResult]       # rid -> isolated accounting
    spans: Dict[int, Tuple[float, float]]   # rid -> (first start, last end)
    chosen: str = "packed"                  # "packed" | "serial"

    @property
    def cycles(self) -> float:
        return self.makespan

    def concurrency(self) -> float:
        """Time-averaged number of co-resident requests."""
        if not self.makespan:
            return 0.0
        busy = sum(e - s for (s, e) in self.spans.values())
        return busy / self.makespan


def _tile_tasks(req: GemmRequest, cfg: SlabArrayConfig) -> List[Tuple[Tile, int]]:
    """Decompose a request into (tile, slabs_needed) tasks.

    ``M > array_h`` becomes full-height passes plus a scale-in residual,
    mirroring ``plan_gemm`` — but the residual (and any ``M <= array_h``
    request) takes exactly ``ceil(m / slab_h)`` slabs instead of the
    single-tenant power-of-two group, leaving the rest to other tenants.
    """
    tasks: List[Tuple[Tile, int]] = []
    n_tiles = split_n_tiles(req.n, cfg.array_w)
    full, residual = divmod(req.m, cfg.array_h)
    for _ in range(full):
        for tn in n_tiles:
            tasks.append((Tile(tm=cfg.array_h, tn=tn, k=req.k), cfg.n_slabs))
    if residual:
        need = math.ceil(residual / cfg.slab_h)
        for tn in n_tiles:
            tasks.append((Tile(tm=residual, tn=tn, k=req.k), need))
    return tasks


def _find_run(free: set, length: int, n_slabs: int) -> Optional[Tuple[int, ...]]:
    """First-fit contiguous run of ``length`` free slabs."""
    run: List[int] = []
    for s in range(n_slabs):
        if s in free:
            run.append(s)
            if len(run) == length:
                return tuple(run)
        else:
            run = []
    return None


def _request_accounting(req: GemmRequest, cfg: SlabArrayConfig,
                        spec: AsicSpec) -> Tuple[float, float, float]:
    """(dram_bytes, dynamic_energy_nj, macs) — schedule-independent work.

    Mirrors the ``_tile_tasks`` decomposition so B-stream pass counts see
    the true tile heights (a full-height pass sweeps ``array_h`` rows, not
    ``slab_h`` — collapsing everything to one slab-height phase would
    overcharge tall GEMMs ~``n_slabs``x in DRAM traffic).
    """
    dram_total = dyn_total = macs_total = 0.0
    n_tiles = split_n_tiles(req.n, cfg.array_w)
    full, residual = divmod(req.m, cfg.array_h)
    parts: List[Tuple[Tuple[Tile, ...], int, int, int]] = []
    if full:
        tiles = tuple(Tile(tm=cfg.array_h, tn=tn, k=req.k)
                      for _ in range(full) for tn in n_tiles)
        parts.append((tiles, cfg.array_h, cfg.n_slabs, full * cfg.array_h))
    if residual:
        need = math.ceil(residual / cfg.slab_h)
        tiles = tuple(Tile(tm=residual, tn=tn, k=req.k) for tn in n_tiles)
        parts.append((tiles, need * cfg.slab_h, need, residual))
    for tiles, group_h, fusion, m_part in parts:
        phase = Phase(mode=ExecMode.INDEPENDENT, fusion=fusion,
                      group_h=group_h, group_tiles=(tiles,), k_chunk=req.k,
                      active_slabs=cfg.n_slabs)
        plan = ExecutionPlan(m=m_part, n=req.n, k=req.k, phases=(phase,))
        dram = phase_dram_bytes(phase, plan, spec)
        dram_total += sum(dram.values())
        dyn_total += phase_dynamic_energy_nj(phase, dram, spec)
        macs_total += float(phase.macs)
    return dram_total, dyn_total, macs_total


def simulate_serial(requests: Sequence[GemmRequest],
                    cfg: SlabArrayConfig = SISA_128,
                    spec: AsicSpec = SISA_ASIC) -> SimResult:
    """The paper's baseline: each GEMM scheduled in isolation, back-to-back."""
    total = SimResult(n_pes=cfg.n_pes)
    for req in requests:
        total += simulate_gemm(req.m, req.n, req.k, cfg, spec)
    return total


def _serial_schedule(requests: Sequence[GemmRequest], cfg: SlabArrayConfig,
                     spec: AsicSpec) -> PackedSchedule:
    runs: List[TileRun] = []
    per_request: Dict[int, SimResult] = {}
    spans: Dict[int, Tuple[float, float]] = {}
    t = 0.0
    total = SimResult(n_pes=cfg.n_pes)
    for req in requests:
        res = simulate_gemm(req.m, req.n, req.k, cfg, spec)
        per_request[req.rid] = res
        runs.append(TileRun(rid=req.rid, slabs=tuple(range(cfg.n_slabs)),
                            start=t, end=t + res.cycles,
                            tile=Tile(tm=req.m, tn=req.n, k=req.k)))
        spans[req.rid] = (t, t + res.cycles)
        t += res.cycles
        total += res
    return PackedSchedule(tile_runs=runs, makespan=t, result=total,
                          per_request=per_request, spans=spans,
                          chosen="serial")


def pack_requests(requests: Sequence[GemmRequest],
                  cfg: SlabArrayConfig = SISA_128,
                  spec: AsicSpec = SISA_ASIC, *,
                  backfill: bool = True,
                  allow_serial_fallback: bool = True,
                  serial_schedule: Optional[PackedSchedule] = None) -> PackedSchedule:
    """Pack pending GEMMs onto disjoint slab groups, event-driven.

    Tile tasks are placed in arrival-ordered round-robin; with
    ``backfill`` a tenant whose next tile does not fit (not enough
    contiguous slabs) is skipped rather than stalling everyone behind it.
    With ``allow_serial_fallback`` the serial single-tenant schedule is
    also evaluated and the faster of the two is returned.
    """
    if not requests:
        return PackedSchedule(tile_runs=[], makespan=0.0,
                              result=SimResult(n_pes=cfg.n_pes),
                              per_request={}, spans={})

    order = [r.rid for r in requests]
    if len(set(order)) != len(order):
        raise ValueError("duplicate request ids in pack_requests")
    byrid = {r.rid: r for r in requests}
    tasks: Dict[int, Deque[Tuple[Tile, int]]] = {
        r.rid: deque(_tile_tasks(r, cfg)) for r in requests}
    slab_h_cycles: Dict[int, float] = {}     # rid -> Σ duration × slabs held
    spans: Dict[int, Tuple[float, float]] = {}

    free: set = set(range(cfg.n_slabs))
    heap: List[Tuple[float, int, int, Tuple[int, ...]]] = []  # (end, seq, rid, slabs)
    seq = 0
    t = 0.0
    runs: List[TileRun] = []
    anygated = 0.0

    def place() -> None:
        nonlocal seq
        progress = True
        while progress and free:
            progress = False
            for rid in order:
                q = tasks[rid]
                if not q:
                    continue
                tile, need = q[0]
                run = _find_run(free, need, cfg.n_slabs)
                if run is None:
                    if backfill:
                        continue
                    return
                q.popleft()
                dur = tile_cycles(tile, need * cfg.slab_h)
                free.difference_update(run)
                runs.append(TileRun(rid=rid, slabs=run, start=t, end=t + dur,
                                    tile=tile))
                s0, s1 = spans.get(rid, (t, t + dur))
                spans[rid] = (min(s0, t), max(s1, t + dur))
                slab_h_cycles[rid] = slab_h_cycles.get(rid, 0.0) + dur * need
                heapq.heappush(heap, (t + dur, seq, rid, run))
                seq += 1
                progress = True
                if not free:
                    break

    place()
    while heap:
        end = heap[0][0]
        occupied = cfg.n_slabs - len(free)
        if occupied < cfg.n_slabs:
            anygated += end - t
        t = end
        while heap and heap[0][0] == end:
            _, _, _, slabs = heapq.heappop(heap)
            free.update(slabs)
        place()
    makespan = t

    per_request: Dict[int, SimResult] = {}
    agg = SimResult(n_pes=cfg.n_pes)
    total_dram = 0.0
    for rid in order:
        req = byrid[rid]
        dram_bytes, e_dyn, macs = _request_accounting(req, cfg, spec)
        active = slab_h_cycles.get(rid, 0.0)
        s0, s1 = spans[rid]
        res = SimResult(
            cycles=s1 - s0, macs=macs, dram_bytes=dram_bytes,
            energy_static_nj=active * per_slab_static_nj(cfg, spec),
            energy_dynamic_nj=e_dyn, active_slab_cycles=active,
            total_slab_cycles=(s1 - s0) * cfg.n_slabs, n_pes=cfg.n_pes)
        per_request[rid] = res
        total_dram += dram_bytes
        agg += res

    # Shared DRAM: the packed window cannot beat total traffic / bandwidth.
    makespan = max(makespan, total_dram / spec.dram_bytes_per_cycle)
    agg.cycles = makespan
    agg.energy_static_nj += makespan * shared_static_nj(spec)
    agg.total_slab_cycles = makespan * cfg.n_slabs
    agg.anygated_cycles = min(anygated, makespan)
    packed = PackedSchedule(tile_runs=runs, makespan=makespan, result=agg,
                            per_request=per_request, spans=spans)

    if allow_serial_fallback:
        serial = serial_schedule or _serial_schedule(requests, cfg, spec)
        if serial.makespan < packed.makespan:
            return serial
    return packed


def packed_speedup(requests: Sequence[GemmRequest],
                   cfg: SlabArrayConfig = SISA_128,
                   spec: AsicSpec = SISA_ASIC) -> Tuple[float, PackedSchedule, SimResult]:
    """(serial_cycles / packed_cycles, packed schedule, serial result).

    The serial schedule is simulated once and shared with the packer's
    fallback comparison.
    """
    serial = _serial_schedule(requests, cfg, spec)
    packed = pack_requests(requests, cfg, spec, serial_schedule=serial)
    sp = serial.makespan / packed.makespan if packed.makespan else 1.0
    return sp, packed, serial.result


def coexec_tile_sequence(schedule: PackedSchedule,
                         rids: Optional[Sequence[int]] = None) -> List[int]:
    """Tenant-index sequence of a schedule's tile runs, in placement order.

    This is the tile table the co-exec kernel consumes: the packer's
    ``ExecutionPlan``-derived ``tile_runs`` are walked by start time (the
    event-driven placement order — co-resident tenants alternate), and
    each run is mapped to the index of its request in ``rids`` (defaults
    to first-appearance order).  Feed the result to
    ``repro_torch.kernels.coexec.coexec_matmul(order=...)``
    / ``build_coexec_plan(order=...)`` so the fused grid axis walks tile
    tasks exactly as the simulator placed them on slab runs, instead of
    tenant-by-tenant.
    """
    runs = sorted(schedule.tile_runs, key=lambda r: (r.start, r.slabs))
    if rids is None:
        seen: List[int] = []
        for r in runs:
            if r.rid not in seen:
                seen.append(r.rid)
        rids = seen
    index = {rid: i for i, rid in enumerate(rids)}
    return [index[r.rid] for r in runs if r.rid in index]


def requests_from_workload(gemms: Iterable[Tuple[int, int, int, int]],
                           tag: str = "", start_rid: int = 0) -> List[GemmRequest]:
    """Expand ``(m, n, k, occurrences)`` tuples into individual requests."""
    reqs: List[GemmRequest] = []
    for (m, n, k, occ) in gemms:
        for _ in range(occ):
            reqs.append(GemmRequest(rid=start_rid + len(reqs),
                                    m=m, n=n, k=k, tag=tag))
    return reqs
