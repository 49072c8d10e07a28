"""K4's and K5's launch plans (``k4_plan``, ``k5_plan``) and K5's
plan-following plain version, on the CPU.

The plans lay the flat grouped GEMM (K4: forward and dX) and its
segment-sum weight gradient (K5) out on the H100 for the wgmma bodies of
``csrc/grouped_gemm.cu`` and ``csrc/grouped_dw.cu``.  Their arithmetic is
checked here at phi3.5-moe-42b's decode, prefill and training layouts and
at ``chip_smoke.py``'s capacity-strided and all-to-all layouts: shared
memory within a block's limit, a CTA's rows inside one row tile, half a
wave of CTAs on the main path, and only plans the C dispatch
instantiates (read from the sources).  The kernels run only on the card
(``chip_smoke.py`` holds them against the plain versions there).

``segment_grouped_dw_plan_plain`` walks K5's 64-row stages and zeroes x's
rows that are not live before each stage's product, as the kernel zeroes
them in shared memory.  With NaN in x's dead rows and large finite
values in dy's, it is held against ``jax.vjp`` of the JAX package's
``segment_grouped_gemm`` in interpret mode (which masks X only), and on
clean inputs against ``segment_grouped_dw_plain``, in float32 within
1e-5.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_gemm import a2a_segments
from repro.kernels.grouped_gemm import flat_group_offsets as ref_offsets
from repro.kernels.grouped_gemm import segment_grouped_gemm as ref_segment
from repro_torch.configs import get_config
from repro_torch.kernels import (aligned_block_rows, flat_block_rows,
                                 k4_plan, k5_plan, segment_grouped_dw_plain)
from repro_torch.kernels.grouped_gemm import (HG_BK, K4_PLANS, K5_PLANS,
                                              segment_grouped_dw_plan_plain)
from repro_torch.kernels.sisa_gemm import K1_MIN_CTAS
from repro_torch.models.moe import _capacity

TOL = 1e-5
SMEM_LIMIT = 232448     # bytes of shared memory an H100 block can use
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")

PHI = get_config("phi3.5-moe-42b")
E, D, FF = PHI.moe.n_experts, PHI.d_model, PHI.d_ff
SHAPES = {"up": (D, FF), "down": (FF, D)}      # (k, n) of the forward


def _phi_layout(tokens):
    """(bm, n_mt) of the MoE layer at ``tokens`` tokens: capacity, row
    block and flat size as ``repro_torch.models.moe`` picks them."""
    cap = _capacity(tokens, E, PHI.moe.top_k, PHI.moe.capacity_factor)
    bm = flat_block_rows(min(cap, 64), FF, D, torch.bfloat16)
    return bm, E * -(-cap // bm)


# (name, bm, n_mt, on the main path): phi's decode (rung 8), 208-token
# prefill and 2048-token training step; chip_smoke.py's prefill at bm 32,
# capacity stride 40 (bm 8) and a2a layout (2 ranks, capacity 40, bm 8).
LAYOUTS = [("decode", *_phi_layout(8), True),
           ("prefill", *_phi_layout(208), True),
           ("train", *_phi_layout(2048), True),
           ("prefill_bm32", 32, E, False),
           ("capacity_stride_40",
            aligned_block_rows(40, FF, D, torch.bfloat16, align_to=40),
            E * 40 // 8, False),
           ("a2a_2_ranks", 8, E * 2 * 40 // 8, False)]
K4_CASES = [(name, bm, n_mt, main, mode, shape)
            for name, bm, n_mt, main in LAYOUTS
            for mode in ("fwd", "dx") for shape in SHAPES]


def _k4_nk(mode, shape):
    k, n = SHAPES[shape]
    return (n, k) if mode == "fwd" else (k, n)     # dX: dY (f) @ W^T


def _k4_smem(plan):
    """Dynamic shared memory of a K4 launch (``launch_wgmma``): each stage
    holds 64 nwg weight columns and bq rows of x, 64 deep, then a full
    and an empty barrier a stage, and 1024 bytes to align the ring."""
    return plan.stages * (64 * plan.nwg + plan.bq) * 128 \
        + 16 * plan.stages + 1024


def _k5_smem(plan):
    """As K4's, plus the bf16 dW tile that the TMA store reads while the
    ring already holds the next tile's steps."""
    return plan.stages * (64 * plan.nwg + plan.bq) * 128 \
        + 64 * plan.nwg * plan.bq * 2 + 16 * plan.stages + 1024


def _k4_ctas(plan, n_mt, n):
    """CTAs of a K4 launch: every row tile by every weight-column tile."""
    return n_mt * -(-n // (64 * plan.nwg))


def _k4_cta_tile(plan, n_mt, n, cta):
    """(row tile, first weight column) of CTA ``cta``: the raster-band
    arithmetic of ``grouped_gemm_wgmma_kernel``."""
    bp = 64 * plan.nwg
    per_band = plan.band * -(-n // bp)
    b, off = divmod(cta, per_band)
    rows_in_band = min(plan.band, n_mt - b * plan.band)
    return b * plan.band + off % rows_in_band, off // rows_in_band * bp


def _dispatched(source, macro):
    """The (bq, nwg, stages) plans a C dispatch instantiates."""
    text = (CSRC / source).read_text()
    return tuple(tuple(int(v) for v in m) for m in re.findall(
        rf"^\s*{macro}\((\d+), (\d+), (\d+)\)$", text, re.M))


def test_plan_lists_mirror_the_c_dispatch():
    assert _dispatched("grouped_gemm.cu", "K4_PLAN") == K4_PLANS
    assert _dispatched("grouped_dw.cu", "K5_PLAN") == K5_PLANS


@pytest.mark.parametrize("name,bm,n_mt,main,mode,shape", K4_CASES)
def test_k4_plan_fits_the_card_and_keeps_a_cta_in_one_row_tile(
        name, bm, n_mt, main, mode, shape):
    n, k = _k4_nk(mode, shape)
    plan = k4_plan(bm, n_mt, k)
    assert (plan.bq, plan.nwg, plan.stages) in K4_PLANS
    assert _k4_smem(plan) <= SMEM_LIMIT
    # The out^T staging tile (rows padded by 8 bf16) fits the ring.
    assert plan.bq * (64 * plan.nwg + 8) * 2 <= (
        plan.stages * (64 * plan.nwg + plan.bq) * 128)
    # The least wgmma width that holds the row tile: one CTA covers one
    # row tile's rows, so never two tiles' experts.
    assert plan.bq == min(q for q, _, _ in K4_PLANS if q >= bm)
    assert 1 <= plan.band <= n_mt
    if main:
        assert _k4_ctas(plan, n_mt, n) >= K1_MIN_CTAS


@pytest.mark.parametrize("n_mt,n,band,nwg", [(16, 6400, 16, 1),
                                             (80, 4096, 10, 4),
                                             (80, 6400, 16, 4),
                                             (7, 200, 3, 2)])
def test_k4_raster_bands_cover_every_tile_once(n_mt, n, band, nwg):
    """The kernel's CTA -> (row tile, weight columns) map is a bijection
    onto the grid of tiles, with ``band`` row tiles side by side."""
    plan = dataclasses.replace(k4_plan(64, n_mt, 4096), band=band, nwg=nwg)
    real = _k4_ctas(plan, n_mt, n)
    tiles = [_k4_cta_tile(plan, n_mt, n, c) for c in range(real)]
    assert len(set(tiles)) == real
    assert {i for i, _ in tiles} == set(range(n_mt))
    assert all(0 <= p < n and p % (64 * nwg) == 0 for _, p in tiles)
    # Within a band, the row tiles run fastest.
    first = tiles[:min(band, n_mt)]
    assert [i for i, _ in first] == list(range(min(band, n_mt)))
    assert len({p for _, p in first}) == 1


@pytest.mark.parametrize("d,f", [(D, FF), (FF, D)])
def test_k5_plan_fits_the_card_and_fills_it(d, f):
    """Shared memory within the limit, and at phi's training shapes (up
    and down) more output tiles than SMs, so every persistent CTA walks
    many tiles."""
    plan = k5_plan()
    assert (plan.bq, plan.nwg, plan.stages) in K5_PLANS
    assert _k5_smem(plan) <= SMEM_LIMIT
    tiles = E * -(-d // (64 * plan.nwg)) * -(-f // plan.bq)
    assert tiles >= max(K1_MIN_CTAS, 2 * 132)


F_SMALL, D_SMALL = 48, 40


def _prefix(sizes, bm, tail_tiles):
    starts = np.array(ref_offsets(jnp.asarray(sizes, jnp.int32), bm))
    m = int(starts[-1]) + tail_tiles * bm
    return m, starts[:-1], np.asarray(sizes, np.int32), \
        np.arange(len(sizes), dtype=np.int32)


def _a2a():
    cap = 40
    recv = jnp.asarray([[5, 40, 0], [33, 0, 17]], jnp.int32)
    starts, sizes, gids = (np.array(t) for t in a2a_segments(3, 2, cap,
                                                              recv))
    return 3 * 2 * cap, starts, sizes, gids


# Groups longer than one 64-row stage, stages that reach into the next
# group's rows, empty groups, tail tiles, and shared-gid segments.
DW_LAYOUTS = {
    "prefix_bm16_long": (16, lambda: _prefix([150, 0, 37, 70], 16, 2)),
    "prefix_bm64_train": (64, lambda: _prefix([130, 64, 0, 1], 64, 1)),
    "prefix_bm8": (8, lambda: _prefix([5, 0, 16, 9], 8, 2)),
    "a2a_bm8": (8, _a2a),
}


def _dw_inputs(seed, layout):
    bm, make = DW_LAYOUTS[layout]
    m, starts, sizes, gids = make()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, D_SMALL)).astype(np.float32)
    w = (rng.standard_normal((int(gids.max()) + 1, D_SMALL, F_SMALL))
         / np.sqrt(D_SMALL)).astype(np.float32)
    dy = rng.standard_normal((m, F_SMALL)).astype(np.float32)
    covered = np.zeros(m, bool)
    for s, n in zip(starts, sizes):
        covered[s:s + n] = True
    return bm, starts, sizes, gids, x, w, dy, covered


@pytest.mark.parametrize("layout", sorted(DW_LAYOUTS))
def test_k5_plan_twin_masks_dead_rows_like_the_reference(layout):
    """NaN in x's rows outside every segment and 1e4 in dy's: the twin
    zeroes x's dead rows per stage, so it matches the reference, which
    masks X only (a NaN in dy's dead rows would reach both)."""
    bm, starts, sizes, gids, x, w, dy, covered = _dw_inputs(31, layout)
    x[~covered] = np.nan
    dy[~covered] = 1e4
    tables = [torch.from_numpy(t) for t in (starts, sizes, gids)]
    got = segment_grouped_dw_plan_plain(
        torch.from_numpy(x), torch.from_numpy(dy), *tables, w.shape[0],
        block_rows=bm).numpy()
    _, vjp = jax.vjp(lambda a, b: ref_segment(a, b, starts, sizes, gids,
                                              block_rows=bm, interpret=True),
                     jnp.asarray(x), jnp.asarray(w))
    _, ref_dw = vjp(jnp.asarray(dy))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref_dw), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", sorted(DW_LAYOUTS))
def test_k5_plan_twin_matches_the_plain_version_on_clean_inputs(layout):
    bm, starts, sizes, gids, x, w, dy, _ = _dw_inputs(37, layout)
    tables = [torch.from_numpy(t) for t in (starts, sizes, gids)]
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    got = segment_grouped_dw_plan_plain(tx, tdy, *tables, w.shape[0],
                                        block_rows=bm)
    want = segment_grouped_dw_plain(tx, tdy, *tables, w.shape[0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    rows = np.zeros(w.shape[0], np.int64)
    np.add.at(rows, gids, sizes)
    assert (got.numpy()[rows == 0] == 0).all()


def test_k5_plan_twin_walks_whole_stages():
    """A group of 150 rows at bm 16 takes three 64-row stages; the last
    reaches 42 rows into the next group's tiles, which must not count."""
    assert HG_BK == 64
    bm, starts, sizes, gids, x, _, dy, _ = _dw_inputs(41,
                                                       "prefix_bm16_long")
    tables = [torch.from_numpy(t) for t in (starts, sizes, gids)]
    tx = torch.from_numpy(x)
    tx[150:] = 1e6                      # everything past group 0's rows
    got = segment_grouped_dw_plan_plain(tx, torch.from_numpy(dy), *tables,
                                        4, block_rows=bm)
    want = tx[:150].T @ torch.from_numpy(dy)[:150]
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
