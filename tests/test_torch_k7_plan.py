"""K7's launch plan (``k7_plan``) on the CPU.

The plan lays the capacity-padded MoE GEMM of ``csrc/moe_gemm.cu`` out
for its TMA + wgmma body: wgmma width (rows of an expert a CTA),
warpgroups (weight columns a CTA), stages and the raster band of an
expert's row tiles.  Checked here: the picks at phi3.5-moe-42b's decode,
ragged and training capacities (C 2, 37, 320) and at a ragged (E, C, d,
f) = (3, 5, 36, 70); shared memory within a block's limit; the plan
list equal to the C dispatch's; and the kernel's map from CTA to (row
tile, weight columns) a bijection onto each expert's tiles.  K7's plan
has no K split, so its sum is one f32 product over d, the plain
version's (``tests/test_torch_kernels.py`` holds that against the JAX
package's interpret kernel at the plan's capacities).  The kernel runs
only on the card (``chip_smoke.py`` holds it against the plain version
there).
"""
import re
from pathlib import Path

import pytest

from repro_torch.configs import get_config
from repro_torch.kernels import k7_plan
from repro_torch.kernels.grouped_gemm import K4_BAND_BYTES
from repro_torch.kernels.moe_gemm import K7_PLANS, K7Plan

SMEM_LIMIT = 232448     # bytes of shared memory an H100 block can use
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "moe_gemm.cu").read_text()

PHI = get_config("phi3.5-moe-42b")
E, D, FF = PHI.moe.n_experts, PHI.d_model, PHI.d_ff


def _smem(plan):
    """Dynamic shared memory of a launch (``launch_wgmma``): each stage
    holds 64 nwg weight columns and bq rows of x, 64 deep, then a full
    and an empty barrier a stage, and 1024 bytes to align the ring."""
    return plan.stages * (64 * plan.nwg + plan.bq) * 128 \
        + 16 * plan.stages + 1024


def _ctas(plan, c, f):
    """CTAs of one expert (``launch_wgmma``'s grid.x): row tiles by
    tiles of weight columns."""
    return -(-c // plan.bq) * -(-f // (64 * plan.nwg))


def _cta_tile(plan, c, f, cta):
    """(first row, first weight column) of CTA ``cta`` of one expert:
    the raster-band arithmetic of ``moe_gemm_wgmma_kernel``."""
    bp = 64 * plan.nwg
    n_ct, p_tiles = -(-c // plan.bq), -(-f // bp)
    b, off = divmod(cta, plan.band * p_tiles)
    rows_in_band = min(plan.band, n_ct - b * plan.band)
    return ((b * plan.band + off % rows_in_band) * plan.bq,
            off // rows_in_band * bp)


def test_plan_list_mirrors_the_c_dispatch():
    dispatched = tuple(tuple(int(v) for v in m) for m in re.findall(
        r"^\s*K7_PLAN\((\d+), (\d+), (\d+)\)$", SOURCE, re.M))
    assert dispatched == K7_PLANS


# (c, d, f) -> the plan's (bq, nwg, stages, band).
PICKS = [((2, D, FF), (64, 4, 5, 1)), ((2, FF, D), (64, 4, 5, 1)),
         ((37, D, FF), (64, 4, 5, 1)), ((37, FF, D), (64, 4, 5, 1)),
         ((320, D, FF), (128, 4, 4, 3)), ((320, FF, D), (128, 4, 4, 3)),
         ((5, 36, 70), (64, 4, 5, 1))]


@pytest.mark.parametrize("shape,want", PICKS)
def test_plan_picks(shape, want):
    c, d, f = shape
    plan = k7_plan(c, d, f)
    assert plan == K7Plan(*want)
    assert (plan.bq, plan.nwg, plan.stages) in K7_PLANS
    assert _smem(plan) <= SMEM_LIMIT
    # The out tile, staged in the ring, fits it.
    assert 64 * plan.nwg * plan.bq * 2 <= plan.stages * (
        64 * plan.nwg + plan.bq) * 128
    # Up to 64 rows, one row tile an expert: its weights are read once.
    if c <= 64:
        assert -(-c // plan.bq) == 1
    # A band of row tiles holds at most K4_BAND_BYTES of x.
    assert 1 <= plan.band <= max(1, K4_BAND_BYTES // (plan.bq * d * 2))


@pytest.mark.parametrize("c,f,band", [(320, FF, 3), (320, D, 1), (2, FF, 1),
                                      (700, 200, 2), (1, 8, 1)])
def test_ctas_cover_every_tile_of_an_expert_once(c, f, band):
    base = k7_plan(c, 64, f)
    plan = K7Plan(base.bq, base.nwg, base.stages, min(band, -(-c // base.bq)))
    tiles = [_cta_tile(plan, c, f, cta) for cta in range(_ctas(plan, c, f))]
    bp = 64 * plan.nwg
    assert sorted(tiles) == sorted(
        (r, p) for r in range(0, -(-c // plan.bq) * plan.bq, plan.bq)
        for p in range(0, -(-f // bp) * bp, bp))

