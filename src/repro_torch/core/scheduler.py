"""SISA tiling & scheduling (paper §3.2).

Decomposes a GEMM ``C[M,N] = A[M,K] @ B[K,N]`` into *phases*.  Each phase
fixes one slab configuration (fusion factor) and carries a set of output
tiles statically assigned to the slab groups.  The mode selection follows
§3.2 exactly:

* ``M <= slab_h``           -> INDEPENDENT: 8 groups of 1 slab, tiles along N.
* ``slab_h < M <= H/2``     -> FUSED: groups of 2^k slabs covering M.
* ``H/2 < M <= H``          -> MONOLITHIC (fully fused); slabs above
                               ceil(M/slab_h) power-gated.
* ``M > H``                 -> MONOLITHIC main tiles + recursive residual
                               phase for ``M mod H``.

K never changes the phase structure: the OS dataflow accumulates in-place
across K chunks (the scheduler only records K-chunking for buffer-capacity
accounting, see ``k_chunk``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from repro_torch.core.slab import ExecMode, SlabArrayConfig, split_n_tiles


@dataclasses.dataclass(frozen=True)
class Tile:
    """One output tile: tm x tn, reduced over the full K."""

    tm: int
    tn: int
    k: int


@dataclasses.dataclass(frozen=True)
class Phase:
    """A set of tiles executed under one slab configuration.

    ``group_tiles[g]`` is the ordered tile list of group ``g``; groups run
    concurrently, tiles within a group run back-to-back.
    """

    mode: ExecMode
    fusion: int                      # slabs fused per group
    group_h: int                     # logical array height per group
    group_tiles: Tuple[Tuple[Tile, ...], ...]
    k_chunk: int                     # K split for buffer capacity
    active_slabs: int                # slabs not power-gated in this phase

    @property
    def n_groups(self) -> int:
        return len(self.group_tiles)

    @property
    def n_tiles(self) -> int:
        return sum(len(g) for g in self.group_tiles)

    @property
    def macs(self) -> int:
        return sum(t.tm * t.tn * t.k for g in self.group_tiles for t in g)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A GEMM's full §3.2 schedule: the ordered phases (each one slab
    configuration with its tile assignment) covering ``C[m,n]``."""

    m: int
    n: int
    k: int
    phases: Tuple[Phase, ...]

    @property
    def macs(self) -> int:
        return self.m * self.n * self.k

    def mode_summary(self) -> str:
        return "+".join(f"{p.n_groups}x({p.group_h}x*)" for p in self.phases)


def _k_chunk(m_tile: int, k: int, n_groups: int, cfg: SlabArrayConfig,
             global_buf_bytes: int, elem_bytes: int) -> int:
    """Largest K chunk s.t. resident A tile + streamed B tiles fit on chip.

    A (m_tile x Kc) stays resident (double buffered); each active group
    streams one B tile (Kc x array_w), double buffered.
    """
    per_k = (m_tile + n_groups * cfg.array_w) * elem_bytes * 2  # double buf
    kc = max(1, global_buf_bytes // per_k)
    return min(k, kc)


def _round_robin(tiles: List[Tile], n_groups: int) -> Tuple[Tuple[Tile, ...], ...]:
    groups: List[List[Tile]] = [[] for _ in range(n_groups)]
    for i, t in enumerate(tiles):
        groups[i % n_groups].append(t)
    return tuple(tuple(g) for g in groups)


def _phase_for_m(m: int, n: int, k: int, cfg: SlabArrayConfig,
                 global_buf_bytes: int, elem_bytes: int) -> Phase:
    """Build the single phase covering an M extent <= array_h."""
    assert 0 < m <= cfg.array_h
    if not cfg.power_gating and cfg.n_slabs == 1:
        # Monolithic baseline: a single group at full height, no gating.
        fusion, mode = 1, ExecMode.MONOLITHIC
    else:
        fusion = cfg.fusion_factor(m)
        if fusion == 1:
            mode = ExecMode.INDEPENDENT
        elif fusion < cfg.n_slabs:
            mode = ExecMode.FUSED
        else:
            mode = ExecMode.MONOLITHIC
    n_groups = cfg.n_groups(fusion)
    tiles = [Tile(tm=m, tn=tn, k=k) for tn in split_n_tiles(n, cfg.array_w)]
    group_tiles = _round_robin(tiles, n_groups)
    busy_groups = sum(1 for g in group_tiles if g)

    if cfg.power_gating:
        # Gate (a) whole groups with no tiles and (b) slabs above the used
        # rows inside each busy group (monolithic partial-M case, Fig 3d).
        used_slabs_per_group = math.ceil(m / cfg.slab_h)
        active = busy_groups * min(used_slabs_per_group, fusion)
    else:
        active = cfg.n_slabs
    kc = _k_chunk(m, k, max(busy_groups, 1), cfg, global_buf_bytes, elem_bytes)
    return Phase(mode=mode, fusion=fusion, group_h=cfg.group_height(fusion),
                 group_tiles=group_tiles, k_chunk=kc, active_slabs=active)


def plan_gemm(m: int, n: int, k: int, cfg: SlabArrayConfig,
              global_buf_bytes: int = 8 * 1024**2,
              elem_bytes: int = 2) -> ExecutionPlan:
    """Full §3.2 scheduling for one GEMM."""
    if min(m, n, k) <= 0:
        raise ValueError(f"GEMM dims must be positive: {(m, n, k)}")
    phases: List[Phase] = []
    full_tiles, residual = divmod(m, cfg.array_h)
    if full_tiles:
        # Main monolithic phase: full-height M tiles, tiled along N, run
        # sequentially on the fully fused array.
        tiles = [Tile(tm=cfg.array_h, tn=tn, k=k)
                 for _ in range(full_tiles)
                 for tn in split_n_tiles(n, cfg.array_w)]
        kc = _k_chunk(cfg.array_h, k, 1, cfg, global_buf_bytes, elem_bytes)
        phases.append(Phase(
            mode=ExecMode.MONOLITHIC, fusion=cfg.n_slabs,
            group_h=cfg.array_h, group_tiles=(tuple(tiles),),
            k_chunk=kc, active_slabs=cfg.n_slabs))
    if residual:
        phases.append(_phase_for_m(residual, n, k, cfg,
                                   global_buf_bytes, elem_bytes))
    return ExecutionPlan(m=m, n=n, k=k, phases=tuple(phases))
