"""K3's launch plan (``repro_torch.kernels.k3_plan``) on the CPU.

On the card, bf16 K3 runs K1's wgmma body once a call, on K1's plan
type and tile pick: a cluster of ``s = min(n_k, 8)`` CTAs deals the
``n_k`` slabs of ``bk`` columns of K as runs of whole slabs and adds
the ranks' f32 tiles in rank order.  The
plan's grid arithmetic is checked here at the main path's shapes (a
qwen2.5-0.5b decode step, rungs 8 and 16, and the slab depths
``chip_smoke.py`` checks); the kernel that follows it runs only on the
card (``chip_smoke.py`` holds it against the plain version).  The plain
split-K that follows a plan's K slices and rank-order sum
(``sisa_gemm_plan_plain``, K1's and K3's) is held
against the JAX package's Pallas kernel in interpret mode and its
``gemm_ref``, in float32 at the tolerance of the other K3 tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import gemm_ref
from repro.kernels.sisa_gemm import BlockConfig as RefBlockConfig
from repro.kernels.sisa_gemm import sisa_gemm_splitk as ref_sisa_gemm_splitk
from repro_torch.kernels import (BlockConfig, choose_block_config, k1_plan,
                                 k3_plan, LAUNCH_COUNTERS, sisa_gemm_splitk,
                                 sisa_gemm_splitk_plain)
from repro_torch.kernels.sisa_gemm import (_splitk_wgmma, K1_BK, K1_STAGES,
                                           K1_SWAP_STAGES, K1_TILES,
                                           K3_MAX_CLUSTER, plan_k_slices,
                                           sisa_gemm_plan_plain)

TOL = 1e-5
QWEN = {"q": (896, 896), "kv": (896, 128), "up": (896, 4864),
        "down": (4864, 896)}
# (m, k, n, bk): qwen's decode GEMVs at rungs 8 and 16 with the slab depths
# chip_smoke.py checks and the timed step's 256, one-stage slabs, and
# taller passes on K1's normal tiles.
CASES = ([(m, k, n, bk) for m in (1, 8, 16) for k, n in QWEN.values()
          for bk in ((128, 256, 448) if k == 896 else (256, 1216))]
         + [(8, 896, 896, 64), (8, 4864, 896, 64), (40, 896, 896, 128),
            (130, 4864, 896, 256), (208, 896, 4864, 448)])
SMEM_LIMIT = 232448     # bytes of shared memory an H100 block can use


@pytest.mark.parametrize("m,k,n,bk", CASES)
def test_k3_plan_covers_k_with_whole_slabs(m, k, n, bk):
    """Every rank sums a non-empty run of whole slabs, the runs tile the
    slabs in rank order, and their columns tile K exactly."""
    plan = k3_plan(m, n, k, bk)
    n_k = -(-k // bk)
    assert plan.slab_steps * K1_BK == bk
    assert plan.cluster == min(n_k, K3_MAX_CLUSTER) <= 8
    slices = plan_k_slices(plan, k)
    runs = [(lo // bk, -(-hi // bk)) for lo, hi in slices]
    assert len(runs) == plan.cluster
    assert runs[0][0] == 0 and runs[-1][1] == n_k
    assert all(lo < hi for lo, hi in runs)
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert max(hi - lo for lo, hi in runs) - min(
        hi - lo for lo, hi in runs) <= 1
    assert slices[0][0] == 0 and slices[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all(lo % bk == 0 and lo < hi for lo, hi in slices)
    # The kernel's K steps: rank r's steps are its slabs' steps.
    steps = bk // K1_BK
    assert [(lo * steps, min(hi * steps, -(-k // K1_BK)))
            for lo, hi in runs] == [(lo // K1_BK, -(-hi // K1_BK))
                                     for lo, hi in slices]


@pytest.mark.parametrize("m,k,n,bk", CASES)
def test_k3_plan_tiles_are_k1s_and_fit_the_card(m, k, n, bk):
    plan = k3_plan(m, n, k, bk)
    if plan.swap_ab:
        assert plan.bm in (8, 16) and plan.bm >= m and plan.bn == 64
        assert plan.stages == K1_SWAP_STAGES
        rows_x, cols_y = 64, plan.bm
    else:
        assert (plan.bm, plan.bn) in K1_TILES
        assert plan.stages == K1_STAGES[(plan.bm, plan.bn)]
        assert plan.bm <= max(64, choose_block_config(m, n, k).bm)
        rows_x, cols_y = plan.bm, plan.bn
    stage = (rows_x + cols_y) * 128
    assert plan.stages * stage + 16 * plan.stages + 1024 <= SMEM_LIMIT
    # The cluster's f32 tile fits the drained ring (sisa_gemm.cu's
    # static_assert): rows x (columns + 8) floats.
    assert rows_x * (cols_y + 8) * 4 <= plan.stages * stage


def test_k3_plan_takes_swap_ab_exactly_for_the_slab():
    for m in range(1, 200):
        plan = k3_plan(m, 896, 4864, 256)
        assert plan.swap_ab == (m <= 16), m
        assert plan.bm == (8 if m <= 8 else 16 if m <= 16 else plan.bm)
        assert plan.cluster == 8


def test_k3_plan_of_the_timed_decode_step():
    """The qwen2.5-0.5b decode step at rung 8, slabs of 256: swap-AB n8,
    clusters of 4 at K 896 (3.5 slabs: the last one half deep) and 8 at
    K 4864 (19 slabs, runs of 2 and 3)."""
    for name, (k, n) in QWEN.items():
        plan = k3_plan(8, n, k, 256)
        assert (plan.swap_ab, plan.bm, plan.bn) == (True, 8, 64)
        assert plan.cluster == (4 if k == 896 else 8), name
    down = plan_k_slices(k3_plan(8, 896, 4864, 256), 4864)
    assert sorted({(hi - lo) // 256 for lo, hi in down}) == [2, 3]
    assert plan_k_slices(k3_plan(8, 896, 896, 256), 896)[-1] == (768, 896)


@pytest.mark.parametrize("m,k,n,bk", CASES)
def test_k3_plan_is_k1s_tile_pick_at_its_cluster(m, k, n, bk):
    """K3 takes K1's tile for the same cluster size: where K1's own plan
    splits K as K3's slabs do, the two plans differ only in the slab."""
    plan, k1 = k3_plan(m, n, k, bk), k1_plan(m, n, k)
    assert k1.slab_steps == 1
    if k1.cluster == plan.cluster:
        assert (plan.bm, plan.bn, plan.stages, plan.swap_ab) == (
            k1.bm, k1.bn, k1.stages, k1.swap_ab)


@pytest.mark.parametrize("bk", [0, 32, 100, 200])
def test_k3_plan_takes_only_whole_stages(bk):
    with pytest.raises(ValueError):
        k3_plan(8, 896, 896, bk)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("m,n,k,bk", [(8, 256, 2048, 128), (16, 128, 896, 128),
                                      (1, 128, 1024, 256),
                                      (16, 256, 4096, 512)])
def test_k3_planned_split_matches_pallas_and_ref(m, n, k, bk):
    """A planned launch's slab runs, each summed in f32 and the ranks in
    rank order, against the reference's split-K Pallas kernel
    (interpret) and its gemm_ref."""
    plan = k3_plan(m, n, k, bk)
    assert plan.cluster > 1
    a, b = _rand(m + k, m, k), _rand(n, k, n, scale=k ** -0.5)
    got = sisa_gemm_plan_plain(torch.from_numpy(a), torch.from_numpy(b),
                               plan)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    mp = ((m + 7) // 8) * 8
    ap = np.pad(a, ((0, mp - m), (0, 0)))
    pallas = np.asarray(ref_sisa_gemm_splitk(
        jnp.asarray(ap), jnp.asarray(b), RefBlockConfig(bm=mp, bn=128, bk=bk),
        interpret=True))[:m]
    ref = np.asarray(gemm_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_k3_cpu_route_is_the_partials_sum():
    """On CPU tensors sisa_gemm_splitk is the plain partials' sum, bit for
    bit, in A's dtype, and launches nothing."""
    before = {k: c.n for k, c in LAUNCH_COUNTERS.items()}
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.from_numpy(_rand(3, 8, 896)).to(dtype)
        b = torch.from_numpy(_rand(4, 896, 128, scale=896 ** -0.5)).to(dtype)
        got = sisa_gemm_splitk(a, b, BlockConfig(16, 0, 256))
        want = sisa_gemm_splitk_plain(a, b, 256).sum(0).to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)
    assert {k: c.n for k, c in LAUNCH_COUNTERS.items()} == before


@pytest.mark.parametrize("dtype,k,n,bk,wgmma", [
    (torch.bfloat16, 896, 896, 256, True),
    (torch.bfloat16, 4864, 896, 1216, True),
    (torch.bfloat16, 896, 128, 64, True),
    (torch.bfloat16, 904, 1000, 200, False),    # slabs not whole stages
    (torch.bfloat16, 900, 1000, 256, False),    # rows TMA cannot stride
    (torch.float32, 896, 896, 256, False),      # f32 stays f32
])
def test_k3_route_is_chosen_by_shape(dtype, k, n, bk, wgmma):
    a, b = torch.zeros(8, k, dtype=dtype), torch.zeros(k, n, dtype=dtype)
    assert _splitk_wgmma(a, b, bk) == wgmma
