"""K1's launch plan (``repro_torch.kernels.k1_plan``) on the CPU.

The plan lays each SISA mode out on the H100 for the wgmma body of
``csrc/sisa_gemm.cu``: swap-AB for the decode slab, CTA tiles for fused
and monolithic passes, and a thread-block cluster that splits K where
the tiles alone leave SMs idle.  Its grid arithmetic is checked here at
the main path's shapes; the kernel that follows it runs only on the
card (``chip_smoke.py`` holds it against the plain version).  A plain
split-K that follows a plan's K slices and rank-order sum is held
against the JAX package's Pallas kernel in interpret mode and its
``gemm_ref``, in float32 at the tolerance of the other K1 tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sisa_matmul as ref_sisa_matmul
from repro.kernels.ref import gemm_ref
from repro_torch.kernels import choose_block_config, k1_plan, row_passes
from repro_torch.kernels.sisa_gemm import (K1_BK, K1_CLUSTERS, K1_MIN_CTAS,
                                           K1_STAGES, K1_TILES, plan_k_slices,
                                           sisa_gemm_plan_plain)

TOL = 1e-5
QWEN = {"q": (896, 896), "kv": (896, 128), "up": (896, 4864),
        "down": (4864, 896), "lm_head": (896, 153600)}
PHI = {"q": (4096, 4096), "kv": (4096, 1024), "lm_head": (4096, 32768)}
# (M of a pass, model): qwen decode rungs, the 208-row prefill's passes,
# phi at 8, 208 and 2048 rows.
PASSES = ([(m, "qwen") for m in (1, 8, 16)]
          + [(hi - lo, "qwen") for lo, hi in row_passes(208)]
          + [(8, "phi")] + [(hi - lo, "phi") for lo, hi in row_passes(208)]
          + [(2048, "phi")])
CASES = [(m, name, k, n) for m, model in PASSES
         for name, (k, n) in (QWEN if model == "qwen" else PHI).items()]


SMEM_LIMIT = 232448     # bytes of shared memory an H100 block can use


def _tiles(plan, m, n):
    """Tiles of C the plan's grid covers (swap-AB: 64 weight columns
    each, all the tokens in one)."""
    rows = 1 if plan.swap_ab else -(-m // plan.bm)
    return rows * -(-n // plan.bn)


def _smem_bytes(plan):
    """Dynamic shared memory of a launch (``launch_wgmma``): each stage
    holds X's tile (rows x 64 bf16) and Y's, then a full and an empty
    barrier a stage, and 1024 bytes to align the ring."""
    rows_x, cols_y = (64, plan.bm) if plan.swap_ab else (plan.bm, plan.bn)
    return plan.stages * (rows_x + cols_y) * 128 + 16 * plan.stages + 1024


def _most_ctas(plan, m, n, k):
    """CTAs of the plan's tiles with the deepest cluster K allows."""
    ksteps = -(-k // K1_BK)
    s_max = max(s for s in K1_CLUSTERS if s == 1 or ksteps >= 2 * s)
    return _tiles(plan, m, n) * s_max


@pytest.mark.parametrize("m,name,k,n", CASES)
def test_k1_plan_fits_the_card_and_fills_it(m, name, k, n):
    """Shared memory within a block's 227 KB, clusters of at most 8 with
    slices of at least two K steps, and at least half a wave of CTAs
    (``K1_MIN_CTAS``) wherever the tiles and K allow as many."""
    plan = k1_plan(m, n, k)
    ctas = _tiles(plan, m, n) * plan.cluster
    assert _smem_bytes(plan) <= SMEM_LIMIT
    assert plan.cluster in K1_CLUSTERS and plan.cluster <= 8
    slices = plan_k_slices(plan, k)
    assert len(slices) == plan.cluster
    if plan.cluster > 1:
        assert min(hi - lo for lo, hi in slices) >= 2 * K1_BK
    assert slices[0][0] == 0 and slices[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert ctas >= min(K1_MIN_CTAS, _most_ctas(plan, m, n, k))
    if plan.cluster > 1:    # a split only where the tiles leave SMs idle
        assert _tiles(plan, m, n) < K1_MIN_CTAS
    if plan.swap_ab:
        assert plan.bm in (8, 16) and plan.bm >= m and plan.bn == 64
    else:
        assert (plan.bm, plan.bn) in K1_TILES
        assert plan.stages == K1_STAGES[(plan.bm, plan.bn)]


def test_k1_plan_takes_swap_ab_exactly_for_the_slab():
    for m in range(1, 300):
        bm = choose_block_config(m, 896, 896).bm
        plan = k1_plan(m, 896, 896)
        assert plan.swap_ab == (bm == 16), m
        assert plan.bm == (8 if m <= 8 else 16 if m <= 16 else plan.bm)
        if not plan.swap_ab:
            assert plan.bm <= max(64, bm), m


def test_k1_plan_uses_every_cluster_size_on_the_main_path():
    sizes = {k1_plan(m, n, k).cluster for m, _, k, n in CASES}
    assert sizes == set(K1_CLUSTERS)
    # The down projection, 14 column tiles over a K of 4864: a cluster of
    # 8 at decode and, on 128-row tiles that read the weights once, at
    # both passes of the 208-row prefill.
    for m, bm in ((8, 8), (128, 128), (80, 128)):
        down = k1_plan(m, 896, 4864)
        assert (down.bm, down.bn, down.cluster) == (bm, 64, 8)
        assert _tiles(down, m, 896) * down.cluster == 112
    # q: too shallow for a cluster of 8, so 64-row tiles by a cluster of 4.
    q = k1_plan(128, 896, 896)
    assert (q.bm, q.bn, q.cluster) == (64, 64, 4)
    assert _tiles(q, 128, 896) * q.cluster == 112


def test_k1_plan_leaves_the_scheduler_as_it_was():
    """The plan reads choose_block_config and row_passes and changes
    neither: their results are the §3.2 ones the other K1 tests pin."""
    for m in range(1, 300):
        before = choose_block_config(m, 4096, 4096).bm
        passes = row_passes(m)
        k1_plan(m, 4096, 4096)
        assert choose_block_config(m, 4096, 4096).bm == before
        assert row_passes(m) == passes
        assert before == (16 if m <= 16 else 32 if m <= 32
                          else 64 if m <= 64 else 128)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(8, 896, 96), (8, 4864, 64),
                                   (80, 896, 128), (130, 300, 72)])
def test_k1_planned_split_k_matches_pallas_and_ref(m, k, n):
    """A planned launch's K slices, summed in rank order in f32, against
    the reference's Pallas kernel (interpret) and its gemm_ref."""
    plan = k1_plan(m, n, k)
    assert plan.cluster > 1
    a, b = _rand(m, m, k), _rand(k, k, n, scale=k ** -0.5)
    got = sisa_gemm_plan_plain(torch.from_numpy(a), torch.from_numpy(b),
                               plan).numpy()
    pallas = np.asarray(ref_sisa_matmul(jnp.asarray(a), jnp.asarray(b),
                                        "pallas_interpret"))
    ref = np.asarray(gemm_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
