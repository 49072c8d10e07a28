"""K4 and K5: the flat ragged grouped GEMM and its weight gradient as
hand-written Hopper kernels (the port of ``repro/kernels/grouped_gemm.py``).

K4 replaces the JAX package's TPU kernel ``repro/kernels/grouped_gemm.py::
_flat_fwd_kernel`` (``_flat_forward``, ``pallas_call`` at line 234), and
K5 replaces ``_flat_dw_kernel`` (``_flat_dw``, ``pallas_call`` at line
272).  The CUDA sources are ``csrc/grouped_gemm.cu`` and
``csrc/grouped_dw.cu``; their headers say what bounds each kernel on an
H100 and what the design does about it.

Layout (as in the reference): activations live in one flat ``(M, d)``
buffer cut into row tiles of ``bm`` rows.  Segment ``s`` covers rows
``[starts[s], starts[s] + sizes[s])`` and contracts against
``w[gids[s]]``; starts are multiples of ``bm``, ascending, with gids
non-decreasing.  A per-tile table ``[gid, hi]`` (:func:`_tile_metadata`,
built on the device with ``searchsorted``) tells each tile its weight
block and where its valid rows end; rows past ``hi`` come out 0, and a
tile that starts at or past ``hi`` reads no weights and does no MACs.

Entry points: :func:`segment_grouped_gemm` (arbitrary segments),
:func:`flat_ragged_gemm` (prefix groups at :func:`flat_group_offsets`)
and the capacity-layout shim :func:`ragged_grouped_gemm`.  They are
differentiable, as the reference's custom VJP makes them
(``grouped_gemm.py:288-313``): dX = dY @ W[gid]ᵀ runs through K4 itself,
reading ``w`` transposed in place, and dW runs through K5, both on the
tile table the forward built and saved.  The integer layout arguments get
no gradient.

The operands' device decides, as for K1 and K2: CUDA tensors launch K4
and K5 (or raise); CPU tensors take :func:`segment_grouped_gemm_plain`
and :func:`segment_grouped_dw_plain`.  The row block comes from the
port's Hopper :func:`~repro_torch.kernels.sisa_gemm.choose_block_config`,
so rows sit elsewhere than in the JAX layout; the values of every
segment's rows are the same.

bf16 operands with 16-byte aligned rows run both kernels on the TMA +
``wgmma`` mainloop of ``csrc/hopper_gemm.cuh``, laid out by
:func:`k4_plan` and :func:`k5_plan` (pure Python, like K1's
``k1_plan``); each C entry refuses a plan it was not instantiated for.
float32, and bf16 rows without that alignment, run the CUDA-core bodies,
so float32 stays exact float32.  :func:`segment_grouped_dw_plan_plain`
follows K5's plan stage by stage on the CPU.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.sisa_gemm import choose_block_config

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BLOCK_ROWS = 128       # the tallest of K1's tile heights
_MAX_ROW_TILES = 65535      # CUDA grid y limit

# The wgmma bodies' instantiations (csrc/grouped_gemm.cu, grouped_dw.cu),
# mirrored from their C dispatch, as (bq, nwg, stages): K4's one for each
# wgmma width bq, in ascending bq; K5's one.  At bq 64, four warpgroups
# beat two and one, and K5's 128 x 256 tiles beat 128 x 128, at the
# prefill and training shapes scripts/k4_sweep.py times (PERF.md).
K4_PLANS = ((8, 1, 8), (16, 1, 8), (32, 1, 8), (64, 4, 5), (128, 2, 4))
K5_PLANS = ((256, 2, 3),)
HG_BK = 64                  # K (K5: rows) per pipeline stage
K4_BAND_BYTES = 8 << 20     # rows of x a raster band keeps in L2

LAUNCHES = _build.LaunchCounter("grouped_gemm")
# K4 launches that read ``w`` transposed: the backward's dX.
DX_LAUNCHES = _build.LaunchCounter("grouped_gemm_dx")
DW_LAUNCHES = _build.LaunchCounter("grouped_dw")
# Launches of the wgmma bodies by route: (counter name, bq, nwg, stages).
ROUTE_LAUNCHES: collections.Counter = collections.Counter()

Tensor = torch.Tensor


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def flat_block_rows(m_hint: int, n: int, k: int,
                    dtype: torch.dtype = torch.float32) -> int:
    """Row block (slab height) K4 uses for this problem; segment starts
    must be aligned to it."""
    return choose_block_config(m_hint, n, k, dtype).bm


def aligned_block_rows(m_hint: int, n: int, k: int,
                       dtype: torch.dtype = torch.float32,
                       align_to: Optional[int] = None) -> int:
    """Row block that also divides ``align_to``, the fixed stride between
    segment starts of a capacity layout."""
    bm = flat_block_rows(m_hint, n, k, dtype)
    if align_to is not None:
        while align_to % bm:
            bm //= 2
    return bm


def flat_group_offsets(group_sizes, block_rows: int) -> Tensor:
    """``(G,) -> (G+1,)`` cumulative block-aligned offsets of a flat prefix
    layout: group ``g`` owns rows ``[offsets[g], offsets[g] + sizes[g])``.
    Computed where ``group_sizes`` lives (no host copy)."""
    sizes = torch.as_tensor(group_sizes, dtype=torch.int32)
    aligned = (sizes + block_rows - 1) // block_rows * block_rows
    return torch.cat([sizes.new_zeros(1),
                      torch.cumsum(aligned, 0).to(torch.int32)])


@dataclasses.dataclass(frozen=True)
class K4Plan:
    """How one bf16 K4 launch is laid out on the card (:func:`k4_plan`).
    Always swap-AB: a CTA covers ``64 * nwg`` weight columns (wgmma's
    64-row side) by the ``bq`` rows of one row tile (its n side), in
    ``stages`` pipeline stages of ``HG_BK``; ``band`` row tiles run side
    by side for each tile of weight columns."""

    bq: int
    nwg: int
    stages: int
    band: int


@dataclasses.dataclass(frozen=True)
class K5Plan:
    """How one bf16 K5 launch is laid out (:func:`k5_plan`): output tiles
    of ``64 * nwg`` rows of d by ``bq`` columns of f (not swapped), over
    a group's rows in ``stages`` pipeline stages of ``HG_BK`` rows; one
    persistent CTA an SM walks the tiles."""

    bq: int
    nwg: int
    stages: int


@functools.lru_cache(maxsize=4096)
def k4_plan(bm: int, n_mt: int, k: int) -> K4Plan:
    """K4's launch plan for ``n_mt`` row tiles of ``bm`` rows against
    weights of depth ``k``: the least wgmma width ``bq`` that holds the
    row tile, so a CTA never covers two tiles (two experts), with that
    width's warpgroups and stages, and a band of row tiles that holds
    ``K4_BAND_BYTES`` of x."""
    bq, nwg, stages = next(p for p in K4_PLANS if p[0] >= bm)
    band = max(1, min(n_mt, K4_BAND_BYTES // (bq * k * 2)))
    return K4Plan(bq, nwg, stages, band)


def k5_plan() -> K5Plan:
    """K5's launch plan: its one instantiation, 128 x 256 tiles of dW,
    two consumer warpgroups, three stages (the persistent CTAs, one an
    SM, walk the tiles, so no shape leaves the card short of CTAs)."""
    return K5Plan(*K5_PLANS[0])


def _tile_metadata(seg_starts: Tensor, seg_sizes: Tensor, seg_gids: Tensor,
                   n_mt: int, bm: int) -> Tensor:
    """``(2, n_mt)`` int32 ownership table of the row tiles, on the
    segments' device: row 0 the owning group, row 1 ``hi``, the absolute
    end of the tile's valid rows (``hi <= i * bm`` marks a tile with none:
    an alignment gap or the buffer's tail)."""
    row0 = torch.arange(n_mt, dtype=torch.int32,
                        device=seg_starts.device) * bm
    s = torch.searchsorted(seg_starts, row0, right=True) - 1
    s = s.clamp(0, seg_starts.shape[0] - 1)
    start = seg_starts[s]
    hi = torch.where(row0 >= start, start + seg_sizes[s],
                     torch.zeros_like(start))
    return torch.stack([seg_gids[s], hi]).to(torch.int32).contiguous()


def _check_layout(starts: Tensor, gids: Tensor, bm: int, n_groups: int):
    """The kernel's layout contract, checked on CPU tensors (on the card
    the tile table built on the device is trusted)."""
    if (starts % bm).any():
        raise ValueError(f"segment starts {starts.tolist()} are not "
                         f"multiples of the row block {bm}")
    if (starts[1:] < starts[:-1]).any() or (gids[1:] < gids[:-1]).any():
        raise ValueError("segment starts must ascend and gids must not "
                         "decrease")
    if ((gids < 0) | (gids >= n_groups)).any():
        raise ValueError(f"segment gids {gids.tolist()} outside "
                         f"[0, {n_groups})")


def segment_grouped_gemm_plain(x: Tensor, w: Tensor, seg_starts: Tensor,
                               seg_sizes: Tensor, seg_gids: Tensor, *,
                               block_rows: int) -> Tensor:
    """Plain version of K4: one f32 product per run of row tiles that
    share an owner, result in x's dtype, rows outside every tile's valid
    extent 0.  Reads the tile table on the host, so it serves CPU tensors
    and the card-side check, never the path on the card."""
    m, f = x.shape[0], w.shape[2]
    bm = block_rows
    n_mt = -(-m // bm)
    gid, hi = _tile_metadata(seg_starts, seg_sizes, seg_gids, n_mt,
                             bm).tolist()
    out = torch.zeros((m, f), dtype=x.dtype, device=x.device)
    i = 0
    while i < n_mt:
        if i * bm >= hi[i]:
            i += 1
            continue
        j = i
        while (j + 1 < n_mt and (gid[j + 1], hi[j + 1]) == (gid[i], hi[i])
               and (j + 1) * bm < hi[i]):
            j += 1
        lo, top = i * bm, min(hi[i], m, (j + 1) * bm)
        out[lo:top] = (x[lo:top].float() @ w[gid[i]].float()).to(x.dtype)
        i = j + 1
    return out


def segment_grouped_dw_plain(x: Tensor, dy: Tensor, seg_starts: Tensor,
                             seg_sizes: Tensor, seg_gids: Tensor,
                             n_groups: int) -> Tensor:
    """Plain version of K5: ``dw[g] = sum over segments s with gid g of
    x[rows of s]ᵀ @ dy[rows of s]``, one f32 product per segment, result
    ``(n_groups, d, f)`` in x's dtype; a group with no rows is 0.  Reads
    the segment table on the host (CPU tensors and the card-side check)."""
    d, f = x.shape[1], dy.shape[1]
    m = x.shape[0]
    dw = torch.zeros((n_groups, d, f), dtype=torch.float32, device=x.device)
    for s, n, g in zip(seg_starts.tolist(), seg_sizes.tolist(),
                       seg_gids.tolist()):
        top = min(s + n, m)
        if top > s:
            dw[g] += x[s:top].float().T @ dy[s:top].float()
    return dw.to(x.dtype)


def segment_grouped_dw_plan_plain(x: Tensor, dy: Tensor, seg_starts: Tensor,
                                  seg_sizes: Tensor, seg_gids: Tensor,
                                  n_groups: int, *,
                                  block_rows: int) -> Tensor:
    """Plain version of K5's wgmma body, stage by stage: for each group,
    its rows ``[r0, r1)`` of the tile table in steps of ``HG_BK`` rows;
    in each step the rows that are not live (past ``r1``, or at or past
    ``hi[r // block_rows]``) of x are set to 0 (NaN included) before the
    step's f32 product, as the kernel zeroes them in shared memory; dy is
    read as it is.  f32 sums in step order, result in x's dtype."""
    m, d = x.shape
    bm = block_rows
    n_mt = -(-m // bm)
    gid, hi = _tile_metadata(seg_starts, seg_sizes, seg_gids, n_mt, bm)
    bounds = torch.searchsorted(gid, torch.arange(n_groups + 1,
                                                  dtype=gid.dtype)).tolist()
    hi_rows = torch.repeat_interleave(hi, bm)[:m]
    dw = torch.zeros((n_groups, d, dy.shape[1]), dtype=torch.float32,
                     device=x.device)
    for g in range(n_groups):
        t0, t1 = bounds[g], bounds[g + 1]
        r0 = t0 * bm
        r1 = max(r0, min(m, int(hi[t1 - 1]))) if t1 > t0 else r0
        for s in range(r0, r1, HG_BK):
            rows = torch.arange(s, min(s + HG_BK, m), device=x.device)
            live = (rows < r1) & (rows < hi_rows[rows])
            xs = torch.where(live[:, None], x[rows].float(),
                             torch.zeros((), device=x.device))
            dw[g] += xs.T @ dy[rows].float()
    return dw.to(x.dtype)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C signatures of K4's and K5's CUDA-core bodies (``grouped_gemm``,
# ``grouped_dw``) and wgmma bodies (``*_wgmma``).
_K4_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _I, _I, _P]
_K4_WGMMA_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _I, _I,
                  _I, _I, _I, _P]
_K5_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _I, _P]
_K5_WGMMA_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _I,
                  _I, _I, _P]


def _lib(lib: str, name: str, argtypes: list):
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _is_transposed(w: Tensor) -> bool:
    """``w`` (G, d, f) is ``stack.transpose(1, 2)`` of a contiguous
    (G, f, d) ``stack``."""
    g, d, f = w.shape
    return (not w.is_contiguous() and w.stride(1) == 1
            and w.stride(2) == d and w.stride(0) == d * f)


def _launch(x: Tensor, w: Tensor, meta: Tensor, bm: int) -> Tensor:
    """One launch of K4: ``x @ w[gid]``.  A transposed ``w`` view
    (:func:`_is_transposed`) is read in place by the TRANS_B bodies."""
    m, d = x.shape
    g, _, f = w.shape
    if x.dtype not in _DTYPES:
        raise ValueError(f"K4 takes float32 or bfloat16, not {x.dtype}")
    n_mt = meta.shape[1]
    if n_mt > _MAX_ROW_TILES:
        raise ValueError(f"{n_mt} row tiles exceed the grid's "
                         f"{_MAX_ROW_TILES}")
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if m == 0 or f == 0:
        return out
    if d == 0:
        return out.zero_()
    if x.stride(1) != 1:
        x = x.contiguous()
    trans_b = _is_transposed(w)
    if not trans_b:
        w = w.contiguous()
    row = d if trans_b else f           # elements per row of w's storage
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counter = DX_LAUNCHES if trans_b else LAUNCHES
    # TMA reads 16-byte aligned rows of x and of w's storage.
    if (x.dtype == torch.bfloat16 and x.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0
            and row % 8 == 0):
        plan = k4_plan(bm, n_mt, d)
        err = _lib("grouped_gemm", "grouped_gemm_wgmma", _K4_WGMMA_ARGS)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), meta.data_ptr(),
            n_mt, g, m, f, d, bm, x.stride(0), f, int(trans_b), plan.bq,
            plan.nwg, plan.stages, plan.band, stream)
        ROUTE_LAUNCHES[(counter.name, plan.bq, plan.nwg, plan.stages)] += 1
    else:
        err = _lib("grouped_gemm", "grouped_gemm", _K4_ARGS)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), meta.data_ptr(),
            n_mt, g, m, f, d, bm, x.stride(0), f, int(trans_b),
            _DTYPES[x.dtype], stream)
    counter.n += 1
    _build.check("grouped_gemm", err)
    return out


def _launch_dw(x: Tensor, dy: Tensor, meta: Tensor, bm: int,
               n_groups: int) -> Tensor:
    """One launch of K5 over the forward's tile table ``meta``."""
    m, d = x.shape
    f = dy.shape[1]
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise ValueError(f"K5 takes float32 or bfloat16 x and dy of one "
                         f"dtype, not {x.dtype} and {dy.dtype}")
    out = torch.empty((n_groups, d, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if m == 0:
        return out.zero_()
    x = x if x.stride(1) == 1 else x.contiguous()
    dy = dy if dy.stride(1) == 1 else dy.contiguous()
    # Group g's row tiles: gids do not decrease over the tiles.
    bounds = torch.searchsorted(
        meta[0].contiguous(),
        torch.arange(n_groups + 1, dtype=torch.int32, device=x.device),
    ).to(torch.int32)
    args = (x.data_ptr(), dy.data_ptr(), out.data_ptr(), meta.data_ptr(),
            bounds.data_ptr(), meta.shape[1], n_groups, m, d, f, bm,
            x.stride(0), dy.stride(0))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # TMA reads 16-byte aligned rows of x and dy and writes dw's.
    if (x.dtype == torch.bfloat16 and x.data_ptr() % 16 == 0
            and dy.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0
            and dy.stride(0) % 8 == 0 and d % 8 == 0 and f % 8 == 0):
        plan = k5_plan()
        err = _lib("grouped_dw", "grouped_dw_wgmma", _K5_WGMMA_ARGS)(
            *args, plan.bq, plan.nwg, plan.stages, stream)
        ROUTE_LAUNCHES[(DW_LAUNCHES.name, plan.bq, plan.nwg,
                        plan.stages)] += 1
    else:
        err = _lib("grouped_dw", "grouped_dw", _K5_ARGS)(
            *args, _DTYPES[x.dtype], stream)
    DW_LAUNCHES.n += 1
    _build.check("grouped_dw", err)
    return out


class _SegmentGemm(torch.autograd.Function):
    """K4 forward; backward dX through K4 with ``w`` transposed and dW
    through K5, over the tile table the forward built (``meta`` is None
    on the CPU, where the plain versions run)."""

    @staticmethod
    def forward(ctx, x, w, starts, sizes, gids, meta, bm):
        ctx.bm = bm
        ctx.save_for_backward(x, w, starts, sizes, gids, meta)
        if meta is None:
            return segment_grouped_gemm_plain(x, w, starts, sizes, gids,
                                              block_rows=bm)
        return _launch(x, w, meta, bm)

    @staticmethod
    def backward(ctx, dy):
        x, w, starts, sizes, gids, meta = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = w.transpose(1, 2)      # read in place, never copied
            dx = (segment_grouped_gemm_plain(dy, wt, starts, sizes, gids,
                                             block_rows=ctx.bm)
                  if meta is None else _launch(dy, wt, meta, ctx.bm))
        if ctx.needs_input_grad[1]:
            dw = (segment_grouped_dw_plain(x, dy, starts, sizes, gids,
                                           w.shape[0])
                  if meta is None else
                  _launch_dw(x, dy, meta, ctx.bm, w.shape[0]))
            dw = dw.to(w.dtype)
        return dx, dw, None, None, None, None, None


def segment_grouped_gemm(x: Tensor, w: Tensor, seg_starts, seg_sizes,
                         seg_gids, *, block_rows: Optional[int] = None,
                         m_hint: Optional[int] = None) -> Tensor:
    """x: (M, d), w: (G, d, f) -> (M, f) in x's dtype over arbitrary row
    segments (module doc).  One launch of K4 on CUDA tensors; ``w`` may
    be contiguous or ``stack.transpose(1, 2)`` of a contiguous (G, f, d)
    stack, read in place either way.  The segment tables may be tensors
    on x's device or sequences.  Differentiable in x and w."""
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"segment_grouped_gemm needs (M,d) and (G,d,f), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise ValueError(f"dtype mismatch: {x.dtype} vs {w.dtype}")
    m, d = x.shape
    g, _, f = w.shape
    mh = m_hint or 128
    bm = block_rows or flat_block_rows(mh, f, d, x.dtype)
    if not 1 <= bm <= _MAX_BLOCK_ROWS:
        raise ValueError(f"block_rows {bm} not in [1, {_MAX_BLOCK_ROWS}]")
    starts, sizes, gids = (torch.as_tensor(t, dtype=torch.int32,
                                           device=x.device)
                           for t in (seg_starts, seg_sizes, seg_gids))
    if x.device.type == "cpu" and w.device.type == "cpu":
        _check_layout(starts, gids, bm, g)
        meta = None
    elif x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"segment_grouped_gemm: operands on {x.device} "
                         f"and {w.device}")
    else:
        meta = _tile_metadata(starts, sizes, gids, -(-m // bm), bm)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _SegmentGemm.apply(x, w, starts, sizes, gids, meta, bm)
    if meta is None:
        return segment_grouped_gemm_plain(x, w, starts, sizes, gids,
                                          block_rows=bm)
    return _launch(x, w, meta, bm)


def flat_ragged_gemm(x: Tensor, w: Tensor, group_sizes,
                     group_offsets=None, *, block_rows: Optional[int] = None,
                     m_hint: Optional[int] = None) -> Tensor:
    """x: (M, d) flat tokens, w: (G, d, f), sizes: (G,) -> (M, f).  Group
    ``g``'s rows live at ``[offsets[g], offsets[g] + sizes[g])``;
    ``group_offsets`` (``(G,)`` starts or ``(G+1,)`` cumulative) defaults
    to :func:`flat_group_offsets`."""
    g, d, f = w.shape
    mh = m_hint or 128
    bm = block_rows or flat_block_rows(mh, f, d, x.dtype)
    sizes = torch.as_tensor(group_sizes, dtype=torch.int32, device=x.device)
    if group_offsets is None:
        starts = flat_group_offsets(sizes, bm)[:g]
    else:
        starts = torch.as_tensor(group_offsets, dtype=torch.int32,
                                 device=x.device)[:g]
    return segment_grouped_gemm(
        x, w, starts, sizes,
        torch.arange(g, dtype=torch.int32, device=x.device),
        block_rows=bm, m_hint=mh)


def ragged_grouped_gemm(x: Tensor, w: Tensor, group_sizes, *,
                        m_hint: Optional[int] = None) -> Tensor:
    """Capacity-layout shim: x: (G, C, d), w: (G, d, f) -> (G, C, f).
    Group ``g`` sits at offset ``g * C'`` (C rounded up to 8) of the flat
    buffer; rows ``>= group_sizes[g]`` come out 0."""
    g, c, d = x.shape
    g2, d2, f = w.shape
    if (g, d) != (g2, d2):
        raise ValueError(f"ragged_grouped_gemm: {tuple(x.shape)} against "
                         f"{tuple(w.shape)}")
    mh = min(m_hint or c, c)
    cp = _round_up(c, 8)
    bm = aligned_block_rows(mh, f, d, x.dtype, align_to=cp)
    if cp != c:
        x = F.pad(x, (0, 0, 0, cp - c))
    ar = torch.arange(g, dtype=torch.int32, device=x.device)
    out = segment_grouped_gemm(x.reshape(g * cp, d), w, ar * cp, group_sizes,
                               ar, block_rows=bm, m_hint=mh)
    return out.reshape(g, cp, f)[:, :c]


def a2a_segments(e_local: int, ms: int, cap: int,
                 recv_sizes) -> tuple:
    """The segment table of an expert-parallel dispatch buffer after the
    all-to-all (the reference's ``a2a_segments``): the exchanged buffer
    is ``(e_local, ms * cap, d)``, in which local expert ``j``'s rows
    from source rank ``r`` are a dense prefix of ``recv_sizes[r, j]``
    rows of slice ``[r * cap, (r + 1) * cap)``.  Flattened row-major,
    segment ``(j, r)`` starts at ``(j * ms + r) * cap``: starts
    ``cap``-aligned, gids expert-major (non-decreasing), as K4 needs.
    Built where ``recv_sizes`` lives."""
    recv = torch.as_tensor(recv_sizes, dtype=torch.int32)
    ar = torch.arange(e_local * ms, dtype=torch.int32, device=recv.device)
    sizes = recv.reshape(ms, e_local).t().reshape(-1)
    gids = torch.arange(e_local, dtype=torch.int32,
                        device=recv.device).repeat_interleave(ms)
    return ar * cap, sizes, gids
