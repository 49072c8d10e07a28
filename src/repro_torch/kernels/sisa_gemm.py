"""K1: the SISA-scheduled GEMM as a hand-written Hopper kernel.

Replaces the JAX package's TPU kernel ``repro/kernels/sisa_gemm.py::
_gemm_kernel`` (``sisa_gemm``, ``pallas_call`` at line 166).  The CUDA
source is ``csrc/sisa_gemm.cu`` on the TMA + ``wgmma`` mainloop of
``csrc/hopper_gemm.cuh``; its header says what bounds the kernel in
each mode on an H100 and what the design does about it.

:func:`choose_block_config` keeps the paper's §3.2 scheduler — three
execution modes picked from M — with tile heights re-derived for Hopper
instead of the TPU's (8, 128) tiling and 8 MiB VMEM budget:

* ``M <= 16``  -> slab, ``bm = 16``: every decode rung up to 16.
* ``16 < M <= 64`` -> fused slabs, ``bm = 32`` or ``64``.
* ``M > 64`` -> the monolithic 128-row tile.

:func:`k1_plan` is the one place that lays a mode out on the card for
bf16 operands with 16-byte aligned rows.  It reads ``bm`` and never
changes it, and picks:

* for the slab, **swap-AB**: each CTA computes a Cᵀ tile of 64 weight
  columns (wgmma's 64-row side) by the 8 or 16 tokens (its n8 / n16
  side), so the 64-row instruction never multiplies rows of zeros.  A
  decode GEMV is bound by weight bytes, and the plan's job is to keep
  enough of them in flight;
* for fused and monolithic passes, 128 x 256, 128 x 128, 128 x 64 or
  64 x 64 CTA tiles (one consumer warpgroup per 64 rows), and where the
  tiles alone leave most SMs idle, a **thread-block cluster** of ``s`` =
  2, 4 or 8 CTAs that split K (each slice at least two 64-deep steps)
  and sum their f32 tiles through distributed shared memory in rank
  order: one launch, no workspace.  A prefill pass of 80-208 rows is
  too short to fill the card with wide tiles, so the plan looks for
  half a wave of CTAs (``K1_MIN_CTAS``): the tallest tile first (each
  row tile re-reads the weights), then the least split, then the widest
  tile.

float32, and bf16 rows without that alignment, run the CUDA-core body at
the same tile heights, so float32 stays exact float32.  A ragged
``M > 128`` runs as a full-height main pass plus a scale-in residual
pass (``repro_torch.kernels.ops``); ragged edges are masked inside the
kernel, so operands are never padded.

:func:`sisa_gemm` launches the kernel the plan names for CUDA tensors,
or raises; it takes its plain version, :func:`sisa_gemm_plain`, only
for CPU tensors.  :func:`sisa_gemm_plan_plain` follows a plan's K
slices (:func:`plan_k_slices`) and rank-order sum on the CPU.
``LAUNCHES`` counts its launches and ``CORE_LAUNCHES`` those of them
that took the CUDA-core body.

K3, the split-K variant (``repro/kernels/sisa_gemm.py::_splitk_kernel``,
``pallas_call`` at line 132), is :func:`sisa_gemm_splitk`: C summed over
slabs of ``cfg.bk`` columns of K.  In bf16 with slabs of whole 64-deep
stages it runs K1's wgmma body in one launch, laid out by
:func:`k3_plan`: K1's tile pick with a cluster of ``s = min(n_k, 8)``
CTAs that deals the ``n_k`` slabs as runs of whole slabs
(``K1Plan.slab_steps`` stages a slab; K1's own plans take one-stage
slabs, its even split) and adds the ranks' f32 tiles in rank order in
distributed shared memory, so no ``(n_k, M, N)`` partials and no sum
follow it.  float32, and bf16 shapes TMA cannot read, write the
partials on the CUDA cores (``csrc/tile_gemm.cuh``'s ``fp_tile``,
``TILE_COLS`` wide, ``TILE_K`` deep, shared with K6 and K7) and sum
them with ``torch.sum``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_HEIGHTS = (16, 32, 64, 128)
# Tile width and K step of csrc/tile_gemm.cuh's CUDA-core body (K3, K6, K7);
# the CUDA side refuses any other.
TILE_COLS = 64
TILE_K = 32

# K1's wgmma body (csrc/sisa_gemm.cu): SMs of an H100 SXM, the K step of a
# stage, the normal CTA tiles (bm, bn) in order of preference with their
# pipeline depths, the swap-AB slab's depth, and the cluster sizes.
SMS = 132
K1_BK = 64
K1_TILES = ((128, 256), (128, 128), (128, 64), (64, 64))
K1_STAGES = {(128, 256): 4, (128, 128): 4, (128, 64): 4, (64, 64): 6}
K1_SWAP_STAGES = 8
K1_CLUSTERS = (1, 2, 4, 8)
K1_MIN_CTAS = SMS // 2     # CTAs a plan splits K to reach
K3_MAX_CLUSTER = 8         # CTAs a K3 cluster deals its slabs to

LAUNCHES = _build.LaunchCounter("sisa_gemm")
# K1's launches on the CUDA-core body (float32 and unaligned bf16).
CORE_LAUNCHES = _build.LaunchCounter("sisa_gemm_core")
# K3's two routes: one wgmma launch a call (the slab sum inside), or the
# CUDA-core partials that torch.sum adds.
SPLITK_LAUNCHES = _build.LaunchCounter("sisa_gemm_splitk")
SPLITK_CORE_LAUNCHES = _build.LaunchCounter("sisa_gemm_splitk_core")


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Tile height ``bm`` chosen by the §3.2 scheduler (the slab height).
    ``bn`` and ``bk`` are the reference's column block and K slab; only
    split-K (:func:`sisa_gemm_splitk`) reads them, K1 reads ``bm``."""

    bm: int
    bn: int = 0
    bk: int = 0

    @property
    def mode(self) -> str:
        """SISA execution mode of this tile height."""
        if self.bm <= 16:
            return "slab"
        return "fused" if self.bm <= 64 else "monolithic"


def choose_block_config(m: int, n: int, k: int,
                        dtype: torch.dtype = torch.bfloat16) -> BlockConfig:
    """§3.2 mode selection mapped to Hopper tile heights (module doc).
    The height depends on M only; ``n``, ``k`` and ``dtype`` keep the
    reference's signature."""
    del n, k, dtype
    if m <= 16:
        bm = 16
    elif m <= 32:
        bm = 32
    elif m <= 64:
        bm = 64
    else:
        bm = 128
    return BlockConfig(bm)


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """How one launch of K1's wgmma body is laid out on the card
    (:func:`k1_plan`, :func:`k3_plan`).  ``bm`` x ``bn`` is the tile of C
    one CTA covers (for swap-AB: ``bm`` tokens by ``bn`` = 64 weight
    columns), in ``stages`` pipeline stages of ``K1_BK``; ``cluster``
    CTAs split K's slabs of ``slab_steps`` stages, rank r summing slabs
    ``[r n / s, (r + 1) n / s)`` of the n (K1: one-stage slabs, so the
    steps split evenly)."""

    bm: int
    bn: int
    stages: int
    cluster: int
    swap_ab: bool
    slab_steps: int = 1


def _k_splits(ksteps: int) -> List[int]:
    """Cluster sizes K allows: every slice at least two K steps."""
    return [s for s in K1_CLUSTERS if s == 1 or ksteps >= 2 * s]


def _tile_plan(m: int, n: int, splits: List[int],
               slab_steps: int) -> K1Plan:
    """The tallest tile (every row tile reads all of B again), then the
    least of ``splits``, then the widest tile, that puts ``K1_MIN_CTAS``
    CTAs on the card; where none does, the most CTAs.  The mode is
    ``choose_block_config``'s: swap-AB for M <= 16."""
    bm = choose_block_config(m, n, 0).bm
    if bm == 16:
        tiles = -(-n // 64)
        s = next((s for s in splits if tiles * s >= K1_MIN_CTAS), splits[-1])
        return K1Plan(8 if m <= 8 else 16, 64, K1_SWAP_STAGES, s, True,
                      slab_steps)
    heights = (128, 64) if bm == 128 else (64,)
    cands = [(s, -(-m // tm) * -(-n // tn), tm, tn) for h in heights
             for s in splits for tm, tn in K1_TILES if tm == h]
    s, _, tm, tn = next(
        (c for c in cands if c[0] * c[1] >= K1_MIN_CTAS),
        max(cands, key=lambda c: c[0] * c[1]))
    return K1Plan(tm, tn, K1_STAGES[(tm, tn)], s, False, slab_steps)


@functools.lru_cache(maxsize=4096)
def k1_plan(m: int, n: int, k: int) -> K1Plan:
    """K1's launch plan for a bf16 pass of ``m`` rows (aligned rows; see
    module doc): :func:`_tile_plan` over the cluster sizes that leave
    every rank two K steps.  A split costs a cluster launch, two cluster
    barriers and the reduction, so it pays only where more than half the
    SMs would idle without it (``scripts/k1_sweep.py``, PERF.md)."""
    return _tile_plan(m, n, _k_splits(-(-k // K1_BK)), 1)


@functools.lru_cache(maxsize=4096)
def k3_plan(m: int, n: int, k: int, bk: int) -> K1Plan:
    """K3's launch plan for a bf16 pass of ``m`` rows in slabs of ``bk``
    (a multiple of ``K1_BK``): K1's tile pick with the cluster fixed by
    the slabs, ``s = min(n_k, 8)`` CTAs for the n_k = ceil(k / bk) slabs,
    each rank summing a run of whole slabs."""
    if bk <= 0 or bk % K1_BK:
        raise ValueError(f"k3_plan: bk={bk} is not a whole number of "
                         f"{K1_BK}-deep stages")
    return _tile_plan(m, n, [min(-(-k // bk), K3_MAX_CLUSTER)], bk // K1_BK)


def plan_k_slices(plan: K1Plan, k: int) -> List[Tuple[int, int]]:
    """Columns of K each CTA of a cluster sums, by rank: runs of whole
    slabs, as the kernel deals them."""
    bk = plan.slab_steps * K1_BK
    n_slabs, s = -(-k // bk), plan.cluster
    return [(r * n_slabs // s * bk, min(k, (r + 1) * n_slabs // s * bk))
            for r in range(s)]


def sisa_gemm_plan_plain(a: torch.Tensor, b: torch.Tensor,
                         plan: K1Plan) -> torch.Tensor:
    """Plain version of a planned launch (K1's or K3's): each rank's f32
    product over its K slice, summed in rank order as the cluster sums
    them; f32 result."""
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for lo, hi in plan_k_slices(plan, a.shape[1]):
        out = out + a[:, lo:hi].float() @ b[lo:hi].float()
    return out


def sisa_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: f32 accumulation, result in A's dtype (the
    twin of the reference's ``gemm_ref``)."""
    return (a.float() @ b.float()).to(a.dtype)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C signatures of K1's CUDA-core body, the wgmma body (K1 and K3),
# and K3's CUDA-core route.
_CORE_ARGS = [_P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _LL, _I, _I, _I, _P]
_WGMMA_ARGS = [_P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _I, _I, _I, _I, _I, _I,
               _I, _I, _P]
_SPLITK_ARGS = [_P, _P, _P, _I, _I, _I, _I, _LL, _LL, _I, _I, _P]


def _lib(name: str, argtypes: list):
    fn = getattr(_build.load("sisa_gemm"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor, stride: int, inner: int) -> bool:
    """Rows TMA can read: 16-byte aligned start and row stride."""
    return t.data_ptr() % 16 == 0 and stride % 8 == 0 and stride >= inner


def sisa_gemm(a: torch.Tensor, b: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] in one launch of K1 (any M; ragged edges
    are masked in the kernel).  ``b`` may be row-major or a transposed
    view (``table.T``), and bf16 ``a`` with more than 16 rows may be a
    transposed view (``x.t()``), each read in place.  ``out``, if given,
    receives C and must be a contiguous (M, N) tensor of A's dtype."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"sisa_gemm needs (M,K) @ (K,N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    if a.device.type == "cpu" and b.device.type == "cpu":
        c = sisa_gemm_plain(a, b)
        return c if out is None else out.copy_(c)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"sisa_gemm: operands on {a.device} and {b.device}")
    if a.dtype not in _DTYPES:
        raise ValueError(f"sisa_gemm takes float32 or bfloat16, not {a.dtype}")
    if out is None:
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    elif (out.shape != (m, n) or out.dtype != a.dtype
          or out.device != a.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous (M, N) tensor of A's "
                         "dtype on A's device")
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    if b.stride(1) == 1:
        trans_b, sbk, sbn = 0, b.stride(0), 1
    elif b.stride(0) == 1:
        trans_b, sbk, sbn = 1, 1, b.stride(1)
    else:
        b = b.contiguous()
        trans_b, sbk, sbn = 0, b.stride(0), 1
    ldb = sbn if trans_b else sbk
    stream = torch.cuda.current_stream(a.device).cuda_stream
    bf16 = a.dtype == torch.bfloat16
    # An M-major A (dB = A^T dC's x.t()) is read in place by the normal
    # wgmma body with a row-major B; anything else gets a K-major copy.
    a_mn = (bf16 and a.stride(1) != 1 and a.stride(0) == 1 and m > 16
            and not trans_b and _aligned(a, a.stride(1), m))
    if a.stride(1) != 1 and not a_mn:
        a = a.contiguous()
    lda = a.stride(1) if a_mn else a.stride(0)
    if bf16 and (a_mn or _aligned(a, lda, k)) and _aligned(
            b, ldb, k if trans_b else n):
        plan = k1_plan(m, n, k)
        err = _lib("sisa_gemm_wgmma", _WGMMA_ARGS)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, lda, ldb, n,
            int(a_mn), trans_b, int(plan.swap_ab), plan.bm, plan.bn,
            plan.stages, plan.cluster, plan.slab_steps, stream)
    else:
        if a_mn:
            a, lda = a.contiguous(), k
        err = _lib("sisa_gemm", _CORE_ARGS)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, lda, sbk,
            sbn, n, trans_b, _DTYPES[a.dtype],
            choose_block_config(m, n, k, a.dtype).bm, stream)
        CORE_LAUNCHES.n += 1
    LAUNCHES.n += 1
    _build.check("sisa_gemm", err)
    return out


def sisa_gemm_splitk_plain(a: torch.Tensor, b: torch.Tensor,
                           bk: int) -> torch.Tensor:
    """Plain version of K3's partials: the ``(n_k, M, N)`` f32 partial
    products of ``a @ b`` over slabs of ``bk`` columns of K (the
    reference's kernel output, summed outside it)."""
    return torch.stack([a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
                        for k0 in range(0, a.shape[1], bk)])


def _splitk_wgmma(a: torch.Tensor, b: torch.Tensor, bk: int) -> bool:
    """K3's wgmma route takes bf16 with slabs of whole 64-deep stages, K
    and N multiples of 8 and 16-byte aligned bases (TMA's strides)."""
    return (a.dtype == torch.bfloat16 and bk % K1_BK == 0
            and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


def _splitk_partials(a: torch.Tensor, b: torch.Tensor,
                     cfg: BlockConfig) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    if cfg.bm not in TILE_HEIGHTS:
        raise NotImplementedError(f"K3's CUDA-core route takes tile heights "
                                  f"{TILE_HEIGHTS}, not bm={cfg.bm}")
    part = torch.empty((-(-k // cfg.bk), m, n), dtype=torch.float32,
                       device=a.device)
    err = _lib("sisa_gemm_splitk", _SPLITK_ARGS)(
        a.data_ptr(), b.data_ptr(), part.data_ptr(), m, n, k, cfg.bk, k, n,
        _DTYPES[a.dtype], cfg.bm,
        torch.cuda.current_stream(a.device).cuda_stream)
    SPLITK_CORE_LAUNCHES.n += 1
    _build.check("sisa_gemm", err)
    return part


def sisa_gemm_splitk(a: torch.Tensor, b: torch.Tensor,
                     cfg: BlockConfig) -> torch.Tensor:
    """K3: C[M,N] = A[M,K] @ B[K,N] summed over slabs of ``cfg.bk``
    columns of K, f32 accumulation, C in A's dtype (the reference sums
    its per-slab partials with ``jnp.sum``).

    On the card the route is chosen by shape, never by a failure:
    * bf16 with ``cfg.bk`` a multiple of 64, K and N multiples of 8 and
      16-byte aligned bases: one launch of K1's wgmma body laid out by
      :func:`k3_plan`, the slab runs summed in rank order inside it;
    * otherwise (float32, or a bf16 shape TMA cannot read): the CUDA-core
      body writes the ``(n_k, M, N)`` f32 partials at the tile height
      ``cfg.bm`` (16, 32, 64 or 128), and ``torch.sum`` adds them.
    CPU tensors take the plain version, the partials' sum.

    ``cfg.bk`` is the slab depth (> 0) and ``cfg.bn``, if given, a
    multiple of ``TILE_COLS``.  Unlike the reference, M, N and K need
    not be multiples of the blocks: ragged edges are masked in the
    kernel."""
    if (a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]
            or 0 in a.shape + b.shape):
        raise ValueError(f"sisa_gemm_splitk needs non-empty (M,K) @ (K,N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"sisa_gemm_splitk: {a.dtype} on {a.device} vs "
                         f"{b.dtype} on {b.device}")
    if cfg.bk <= 0 or cfg.bn < 0 or cfg.bn % TILE_COLS:
        raise ValueError(f"sisa_gemm_splitk needs bk > 0 and bn a multiple "
                         f"of {TILE_COLS} (or 0), got {cfg}")
    if a.device.type == "cpu":
        return sisa_gemm_splitk_plain(a, b, cfg.bk).sum(0).to(a.dtype)
    if a.device.type != "cuda":
        raise ValueError(f"sisa_gemm_splitk: no kernel for {a.device}")
    if a.dtype not in _DTYPES:
        raise ValueError(f"sisa_gemm_splitk takes float32 or bfloat16, not "
                         f"{a.dtype}")
    a, b = a.contiguous(), b.contiguous()
    if not _splitk_wgmma(a, b, cfg.bk):
        return torch.sum(_splitk_partials(a, b, cfg), dim=0).to(a.dtype)
    m, k = a.shape
    n = b.shape[1]
    plan = k3_plan(m, n, k, cfg.bk)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    err = _lib("sisa_gemm_wgmma", _WGMMA_ARGS)(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, k, n, n, 0, 0,
        int(plan.swap_ab), plan.bm, plan.bn, plan.stages, plan.cluster,
        plan.slab_steps, torch.cuda.current_stream(a.device).cuda_stream)
    SPLITK_LAUNCHES.n += 1
    _build.check("sisa_gemm", err)
    return out
