"""Slab-array geometry (paper §3.1).

A SISA instance is a logical ``array_h x array_w`` output-stationary
systolic array horizontally partitioned into ``n_slabs`` slabs of
``slab_h = array_h / n_slabs`` rows.  Adjacent slabs can be *fused* (weight
buffers bypassed through muxes) into taller logical arrays; unused slabs
are power-gated.

The monolithic TPU baseline is expressed in the same vocabulary: a single
slab spanning the whole array (``n_slabs=1``) with gating disabled.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import List


class ExecMode(enum.Enum):
    """Execution strategies of Fig. 3."""

    INDEPENDENT = "independent"   # Fig 3a: M <= slab_h, tiles spread along N
    FUSED = "fused"               # Fig 3b: slab_h < M <= array_h/2
    MONOLITHIC = "monolithic"     # Fig 3c: M > array_h/2, fully fused
    GATED = "gated"               # Fig 3d annotation: some slabs off


@dataclasses.dataclass(frozen=True)
class SlabArrayConfig:
    """Geometry of the PE array and its slab partitioning."""

    array_h: int = 128
    array_w: int = 128
    n_slabs: int = 8
    power_gating: bool = True

    def __post_init__(self):
        if self.array_h % self.n_slabs != 0:
            raise ValueError(
                f"array_h={self.array_h} not divisible by n_slabs={self.n_slabs}")

    @property
    def slab_h(self) -> int:
        return self.array_h // self.n_slabs

    @property
    def n_pes(self) -> int:
        return self.array_h * self.array_w

    def fusion_factor(self, m: int) -> int:
        """Number of slabs fused per group so the logical height covers m.

        The paper fuses in power-of-two steps (16 -> 32x128 -> 64x128 ->
        128x128), so we round the required slab count up to a power of two
        (capped at n_slabs).
        """
        if m <= 0:
            raise ValueError(f"m must be positive, got {m}")
        need = math.ceil(m / self.slab_h)
        f = 1 << (need - 1).bit_length()       # next power of two >= need
        return min(f, self.n_slabs)

    def group_height(self, fusion: int) -> int:
        return fusion * self.slab_h

    def n_groups(self, fusion: int) -> int:
        return self.n_slabs // fusion


# Canonical instances.
SISA_128 = SlabArrayConfig(array_h=128, array_w=128, n_slabs=8)
MONOLITHIC_128 = SlabArrayConfig(array_h=128, array_w=128, n_slabs=1,
                                 power_gating=False)


def split_n_tiles(n: int, tile_w: int) -> List[int]:
    """Tile the N dimension; last tile may be ragged."""
    full, rem = divmod(n, tile_w)
    return [tile_w] * full + ([rem] if rem else [])
