"""K6: fused multi-tenant co-execution, many GEMMs in one launch, as a
hand-written Hopper kernel.

Replaces the JAX package's TPU kernel ``repro/kernels/coexec.py::
_coexec_kernel`` (``_coexec_call``, ``pallas_call`` at line 256); the
plan and packing logic around it is a copy of that module
(``coexec.py:64-385``) under the same names.  The CUDA source is
``csrc/coexec.cu``; its header says what bounds the kernel and how its
tiles keep fused and sequential results bit-identical.

``repro_torch.core`` packs concurrent GEMMs onto disjoint slab groups
and predicts the packed speedup; this module executes that placement.
The tile tasks of every co-resident tenant — heterogeneous ``(mᵢ, nᵢ,
kᵢ)`` problems, each with its own weight — go into one grid, so one
launch runs the whole co-schedule instead of one launch per tenant.

Layout (built host-side by :func:`build_coexec_plan`):

* activations share one flat ``(M_flat, Kp)`` buffer — tenant ``t``'s
  rows live at the block-aligned offset ``row_offsets[t]``, columns
  ``[0, kᵗ)`` are real and the rest up to ``Kp`` is zero;
* weights share one ``(T, Kp, Np)`` stack, zero past ``(kᵗ, nᵗ)``;
* outputs share a flat ``(M_flat, Np)`` buffer; tenant ``t``'s result is
  ``[row_offsets[t] : row_offsets[t] + mᵗ, :nᵗ]``.

The tile table (``(5, n_tasks)`` int32) carries per task ``[tenant,
row_block, col_block, row_hi, k_hi]``.  It stays a host-side numpy array
in the plan; a plan built for a CUDA device also holds one device copy,
made when the plan is built and never per launch.  Task *order* is the
co-schedule: :func:`interleave_order` round-robins tasks across tenants,
or follows the tenant sequence of ``repro_torch.core.
coexec_tile_sequence``.

Block shapes: ``bm`` is the port's §3.2 slab height for the smallest
co-resident M (:func:`~repro_torch.kernels.sisa_gemm.
choose_block_config`); ``bn`` and ``bk`` are the CUDA-core body's fixed
tile width and K step (``TILE_COLS``, ``TILE_K``).  All three may be
pinned (``block_rows`` / ``block_cols`` / ``block_k``); the card runs
``bm`` in (16, 32, 64, 128) with the fixed ``bn``/``bk``, the plain
version any shape.

On the card, float32 runs one CUDA-core block per task of the table.
bf16 runs the **tile groups** of the table :func:`k6_plan` derives when a
bf16 plan for the card is built (``CoexecPlan.groups``, one row a CTA,
with its device copy beside ``meta_device``): a run of one tenant's row blocks, up to
128 rows, by one or two of its column blocks (64-128 weight columns),
ordered by each group's first task.  The group reads its weight tile
once for all its rows, on the TMA + ``wgmma`` mainloop of
``csrc/hopper_gemm.cuh`` (swap-AB at the width 8-128 that holds its live
rows); a group with a long K, or of a narrow tenant, is shared by the
two CTAs of a cluster, each summing half of its K steps.

Numerics contract (``coexec.py:41-45``): each output tile accumulates
in f32 over the same K steps whether its tenant runs fused or alone, so
:func:`coexec_matmul` and :func:`sequential_matmul` built from the same
plan's block shapes agree bit for bit, on the card and on the CPU.  On
the card a group's width, column blocks and cluster split are functions
of its tenant's own (m, n, k) and the plan's blocks only, so a tenant's
groups are the same in a fused plan and in its single-tenant plan.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sisa_gemm import (choose_block_config, TILE_COLS,
                                           TILE_HEIGHTS, TILE_K)

LAUNCHES = _build.LaunchCounter("coexec")

# K6's bf16 body (csrc/coexec.cu): the wgmma widths a group runs at, the
# rows a group covers at most, the consumer warpgroups of a CTA (two CTAs
# share an SM), one a column block of the group, and the weight bytes past
# which a group takes no second column block (a long group left to the
# last wave holds the launch up).  scripts/k6_sweep.py times other values
# of these constants.
K6_WIDTHS = (8, 16, 32, 64, 128)
K6_ROWS = 128
K6_WARPGROUPS = 2
K6_GROUP_BYTES = 256 * 1024
# When a group's K is shared by the two CTAs of a cluster pair (each sums
# a contiguous half; their tiles meet in distributed shared memory and are
# added in rank order): from this many K steps, or for a tenant of at most
# this many column blocks (a narrow tenant's few CTAs are latency-bound).
K6_PAIR_STEPS = 24
K6_PAIR_BLOCKS = 2
K6_STEP = 64                          # K per stage of the wgmma body
# The columns of a group's row in the table k6_plan returns.
K6_FIELDS = ("tenant", "row0", "rows", "live", "col0", "chunks", "k_steps",
             "width", "zero_col", "zero_idx", "zero_n", "ranks", "rank")


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class CoexecTenant:
    """One co-resident GEMM: ``C[m, n] = A[m, k] @ B[k, n]``."""

    rid: int
    m: int
    n: int
    k: int

    def __post_init__(self):
        if min(self.m, self.n, self.k) <= 0:
            raise ValueError(f"tenant dims must be positive: {self}")


@dataclasses.dataclass(frozen=True)
class CoexecPlan:
    """Host-side placement of a tenant set into the fused buffers.

    ``meta`` is the tile table, one column per grid task: ``[tenant,
    row_block, col_block, row_hi, k_hi]``.  ``row_offsets[t]`` is tenant
    ``t``'s first row in the flat A/C buffers (a multiple of ``bm``);
    ``m_flat/kp/np_pad`` are the padded fused buffer extents.
    ``meta_device`` is the table's one device copy (None for a plan
    built for the CPU); a bf16 plan built for the card also holds
    :func:`k6_plan`'s tile-group table ``groups`` and its one device copy
    ``groups_device`` (None otherwise: no other plan reads them).
    """

    tenants: Tuple[CoexecTenant, ...]
    bm: int
    bn: int
    bk: int
    m_flat: int
    kp: int
    np_pad: int
    row_offsets: Tuple[int, ...]
    meta: np.ndarray                      # (5, n_tasks) int32
    meta_device: Optional[torch.Tensor] = dataclasses.field(
        default=None, compare=False, repr=False)
    groups: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)   # k6_plan's table
    groups_device: Optional[torch.Tensor] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def n_tasks(self) -> int:
        return int(self.meta.shape[1])

    @property
    def n_k(self) -> int:
        return self.kp // self.bk

    @property
    def k6_cluster(self) -> int:
        """CTAs a cluster of K6's bf16 launch: 2 where a group is shared
        by a pair (``k6_plan``), else 1.  Only a bf16 plan built for the
        card has groups."""
        return 2 if (self.groups[:, K6_FIELDS.index("ranks")] == 2).any() \
            else 1

    def tenant_tasks(self, idx: int) -> int:
        """Number of grid tasks owned by tenant ``idx``."""
        return int(np.sum(self.meta[0] == idx))


def interleave_order(task_counts: Sequence[int],
                     sequence: Optional[Sequence[int]] = None) -> List[int]:
    """Flatten per-tenant task queues into one interleaved grid order.

    ``task_counts[t]`` is tenant ``t``'s task count.  Without
    ``sequence`` the tenants are drained round-robin; with ``sequence``
    (tenant indices, e.g. from ``coexec_tile_sequence``) the queues are
    drained in that order, cycling until every queue is empty.  Entries
    naming no tenant are ignored; tenants the sequence never names
    drain at the end.
    """
    remaining = [int(c) for c in task_counts]
    order: List[int] = []
    seq = (list(range(len(remaining))) if sequence is None
           else [t for t in sequence if 0 <= t < len(remaining)])
    if not seq:
        seq = list(range(len(remaining)))
    while sum(remaining):
        progressed = False
        for t in seq:
            if remaining[t] > 0:
                order.append(t)
                remaining[t] -= 1
                progressed = True
        if not progressed:          # sequence names no tenant with work left
            for t, left in enumerate(remaining):
                order.extend([t] * left)
                remaining[t] = 0
    return order


def _runs(blocks: np.ndarray, size: int) -> List[np.ndarray]:
    """A sorted block list cut into runs of consecutive blocks, each at
    most ``size`` long."""
    out = []
    for run in np.split(blocks, np.flatnonzero(np.diff(blocks) != 1) + 1):
        out.extend(run[i:i + size] for i in range(0, len(run), size))
    return out


def k6_plan(meta: np.ndarray, bm: int, bn: int) -> np.ndarray:
    """K6's tile groups for the bf16 body, from a plan's task table, laid
    out one row (``K6_FIELDS``, int32) a CTA: the groups in the order of
    each group's first task in ``meta`` (so the packer's placement order
    still decides which tenants share the first wave), a group whose K a
    cluster pair shares (``ranks`` 2) as two rows ``rank`` 0 and 1 that
    start at an even row (the launch then runs clusters of two CTAs; a
    row left before a pair is a hole, ``rank`` 1 of ``ranks`` 1, whose
    CTA exits).

    A group is a run of one tenant's consecutive row blocks, up to
    ``K6_ROWS`` rows (``rows``, from flat row ``row0``; ``live`` of them
    below the tenant's ``row_hi``), by a run of its consecutive column
    blocks (``chunks`` of ``bn`` columns from ``col0``).  Its ``width``
    is the least of ``K6_WIDTHS`` that holds ``live``.  A group takes
    up to ``K6_WARPGROUPS`` column blocks (one a consumer warpgroup)
    while their weights stay within ``K6_GROUP_BYTES`` and the tenant keeps
    two groups a row run (a narrow tenant still spreads over two SMs);
    ``k_steps`` 64-deep steps reach ``k_hi``; two CTAs share them
    (``ranks`` 2, each a contiguous half) from ``K6_PAIR_STEPS`` steps or
    for a tenant of at most ``K6_PAIR_BLOCKS`` column blocks.  Every one of
    these is a function of the tenant's own (m, n, k) and (``bm``,
    ``bn``) alone, so a tenant's groups are the same in a fused plan and
    in its single-tenant plan.  ``zero_col`` is the first column past the
    tenant's column blocks; the 64-wide chunks from there to the buffer's
    width are written as zeros by the row run's ``zero_n`` groups in
    turn, this one taking those ``zero_idx`` (mod ``zero_n``)."""
    rows_max = max(1, K6_ROWS // bm)
    groups = []                     # (first task, fields)
    for t in np.unique(meta[0]):
        own = np.flatnonzero(meta[0] == t)
        rblocks = np.unique(meta[1, own])
        cblocks = np.unique(meta[2, own])
        if len(own) != len(rblocks) * len(cblocks):
            raise ValueError(f"k6_plan: tenant {t}'s tasks are not a grid "
                             "of row and column blocks")
        row_hi, k_hi = int(meta[3, own[0]]), int(meta[4, own[0]])
        k_steps = -(-k_hi // K6_STEP)
        chunks = max(1, min(K6_WARPGROUPS, len(cblocks) // 2,
                            K6_GROUP_BYTES // (bn * k_steps * K6_STEP * 2)))
        ranks = 2 if (k_steps >= K6_PAIR_STEPS
                      or len(cblocks) <= K6_PAIR_BLOCKS) else 1
        first = {(int(meta[1, i]), int(meta[2, i])): int(i) for i in own}
        zero_col = (int(cblocks[-1]) + 1) * bn
        for rrun in _runs(rblocks, rows_max):
            row0 = int(rrun[0]) * bm
            live = max(0, min(len(rrun) * bm, row_hi - row0))
            width = next((w for w in K6_WIDTHS if w >= live), K6_WIDTHS[-1])
            cruns = _runs(cblocks, chunks)
            for idx, crun in enumerate(cruns):
                groups.append((min(first[(int(r), int(c))] for r in rrun
                                   for c in crun),
                               (int(t), row0, len(rrun) * bm, live,
                                int(crun[0]) * bn, len(crun), k_steps, width,
                                zero_col, idx, len(cruns), ranks)))
    groups.sort(key=lambda g: g[0])
    # One row a CTA: a pair's two CTAs at (2c, 2c + 1), the c-th cluster;
    # where a pair would start at an odd row, that row is a hole (rank 1
    # of 1: the CTA exits).  Without pairs the launch has no clusters.
    rows: List[Tuple[int, ...]] = []
    paired = any(f[-1] == 2 for _, f in groups)
    for _, f in groups:
        if f[-1] == 2 and len(rows) % 2:
            rows.append(f[:-1] + (1, 1))
        rows.extend([f + (r,) for r in range(f[-1])])
    if paired and len(rows) % 2:
        rows.append(rows[-1][:-2] + (1, 1))
    return np.asarray(rows, np.int32).reshape(-1, len(K6_FIELDS))


def build_coexec_plan(tenants: Sequence[CoexecTenant],
                      dtype: torch.dtype = torch.float32, *,
                      order: Optional[Sequence[int]] = None,
                      block_rows: Optional[int] = None,
                      block_cols: Optional[int] = None,
                      block_k: Optional[int] = None,
                      m_hint: Optional[int] = None,
                      device=None) -> CoexecPlan:
    """Place a tenant set into fused flat buffers and emit the tile table.

    ``bm`` defaults to the slab height for the smallest co-resident M
    (scale-in: decode tenants take one row block, a co-resident prefill
    many), ``bn``/``bk`` to the kernel's tile width and K step; all
    three can be pinned.  ``order`` is a tenant-index sequence (see
    :func:`interleave_order`).  With a CUDA ``device`` the plan also
    holds the task table's device copy, and a bf16 plan there
    :func:`k6_plan`'s group table and its device copy."""
    tens = tuple(tenants)
    if not tens:
        raise ValueError("build_coexec_plan needs at least one tenant")
    ms = [t.m for t in tens]
    ns = [t.n for t in tens]
    ks = [t.k for t in tens]
    mh = m_hint or min(ms)
    bm = block_rows or choose_block_config(mh, max(ns), max(ks), dtype).bm
    bn, bk = block_cols or TILE_COLS, block_k or TILE_K
    kp = _round_up(max(ks), bk)
    np_pad = _round_up(max(ns), bn)

    row_offsets: List[int] = []
    off = 0
    for t in tens:
        row_offsets.append(off)
        off += _round_up(t.m, bm)
    m_flat = off

    # Per-tenant task queues: row-major over the tenant's C blocks.
    queues: List[List[Tuple[int, int, int, int, int]]] = []
    for idx, t in enumerate(tens):
        rows = _round_up(t.m, bm) // bm
        cols = _round_up(t.n, bn) // bn
        base = row_offsets[idx] // bm
        queues.append([(idx, base + r, c, row_offsets[idx] + t.m, t.k)
                       for r in range(rows) for c in range(cols)])

    cols_meta: List[Tuple[int, int, int, int, int]] = []
    for idx in interleave_order([len(q) for q in queues], order):
        cols_meta.append(queues[idx].pop(0))
    meta = np.asarray(cols_meta, np.int32).T.copy()
    meta_device = groups = groups_device = None
    if device is not None and torch.device(device).type != "cpu":
        meta_device = torch.as_tensor(meta, device=device)
        if dtype == torch.bfloat16:
            groups = k6_plan(meta, bm, bn)
            groups_device = torch.as_tensor(groups, device=device)
    return CoexecPlan(tenants=tens, bm=bm, bn=bn, bk=bk, m_flat=m_flat,
                      kp=kp, np_pad=np_pad, row_offsets=tuple(row_offsets),
                      meta=meta, meta_device=meta_device, groups=groups,
                      groups_device=groups_device)


def pack_operands(plan: CoexecPlan, xs: Sequence[torch.Tensor],
                  ws: Sequence[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assemble the fused ``(M_flat, Kp)`` A and ``(T, Kp, Np)`` B
    buffers.  The zeros past each tenant's ``(m, k, n)`` keep the shared
    K contraction exact and make the padding columns of a tenant's last
    column block read as zeros."""
    dtype, dev = xs[0].dtype, xs[0].device
    a_flat = torch.zeros((plan.m_flat, plan.kp), dtype=dtype, device=dev)
    b_stack = torch.zeros((len(plan.tenants), plan.kp, plan.np_pad),
                          dtype=dtype, device=dev)
    for i, (t, x, w) in enumerate(zip(plan.tenants, xs, ws)):
        if tuple(x.shape) != (t.m, t.k) or tuple(w.shape) != (t.k, t.n):
            raise ValueError(f"tenant {i}: {tuple(x.shape)} @ "
                             f"{tuple(w.shape)} does not fit {t}")
        off = plan.row_offsets[i]
        a_flat[off:off + t.m, :t.k] = x
        b_stack[i, :t.k, :t.n] = w
    return a_flat, b_stack


def _f32_copy(x: torch.Tensor) -> torch.Tensor:
    # A fresh allocation: the CPU GEMM then sees the same shape and
    # alignment for a tenant whether it runs fused or alone.
    return x.to(torch.float32, copy=True)


def run_plan_plain(plan: CoexecPlan, a_flat: torch.Tensor,
                   b_stack: torch.Tensor) -> torch.Tensor:
    """Plain version of K6 from the tile table: each tenant's tiles
    accumulate in f32 over ``bk``-deep K steps up to its ``k_hi``, rows
    at or past ``row_hi`` are zero, and the result is in A's dtype.
    Columns no task covers read 0."""
    meta, bm, bn, bk = plan.meta, plan.bm, plan.bn, plan.bk
    out = torch.zeros((plan.m_flat, plan.np_pad), dtype=a_flat.dtype,
                      device=a_flat.device)
    for t in np.unique(meta[0]):
        own = meta[:, meta[0] == t]
        r0, r1 = int(own[1].min()) * bm, (int(own[1].max()) + 1) * bm
        c0, c1 = int(own[2].min()) * bn, (int(own[2].max()) + 1) * bn
        hi, k_hi = int(own[3, 0]), int(own[4, 0])
        acc = torch.zeros((r1 - r0, c1 - c0), dtype=torch.float32,
                          device=a_flat.device)
        for k0 in range(0, min(k_hi, plan.kp), bk):
            acc += (_f32_copy(a_flat[r0:r1, k0:k0 + bk])
                    @ _f32_copy(b_stack[int(t), k0:k0 + bk, c0:c1]))
        acc[max(hi - r0, 0):] = 0
        out[r0:r1, c0:c1] = acc.to(a_flat.dtype)
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C signatures of the CUDA-core body (float32, one block a task) and
# the wgmma body (bf16, one CTA a tile group).
_FP_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_WGMMA_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def _lib(name: str, argtypes: list):
    fn = getattr(_build.load("coexec"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _run_plan_kernel(plan: CoexecPlan, a_flat: torch.Tensor,
                     b_stack: torch.Tensor) -> torch.Tensor:
    dev = a_flat.device
    n_t = len(plan.tenants)
    if (tuple(a_flat.shape) != (plan.m_flat, plan.kp)
            or tuple(b_stack.shape) != (n_t, plan.kp, plan.np_pad)):
        raise ValueError(f"run_plan: A {tuple(a_flat.shape)} / B "
                         f"{tuple(b_stack.shape)} do not fit the plan")
    if (a_flat.dtype not in (torch.float32, torch.bfloat16)
            or b_stack.dtype != a_flat.dtype):
        raise ValueError(f"run_plan takes float32 or bfloat16 buffers of one "
                         f"dtype, got {a_flat.dtype}/{b_stack.dtype}")
    if b_stack.device != dev:
        raise ValueError("run_plan: buffers on different devices")
    if plan.meta_device is None or plan.meta_device.device != dev:
        raise ValueError("run_plan: the plan holds no tile table on "
                         f"{dev}; build it with device={dev}")
    if (plan.bm not in TILE_HEIGHTS or plan.bn != TILE_COLS
            or plan.bk != TILE_K):
        raise NotImplementedError(
            f"K6 runs bm in {TILE_HEIGHTS} with bn={TILE_COLS}, "
            f"bk={TILE_K}; the plan has ({plan.bm}, {plan.bn}, {plan.bk})")
    a_flat, b_stack = a_flat.contiguous(), b_stack.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if a_flat.dtype == torch.float32:
        out = torch.zeros((plan.m_flat, plan.np_pad), dtype=a_flat.dtype,
                          device=dev)
        err = _lib("coexec", _FP_ARGS)(
            a_flat.data_ptr(), b_stack.data_ptr(), out.data_ptr(),
            plan.meta_device.data_ptr(), plan.n_tasks, n_t, plan.kp,
            plan.np_pad, plan.bm, plan.bn, plan.bk, stream)
    else:
        if a_flat.data_ptr() % 16 or b_stack.data_ptr() % 16:
            raise ValueError("run_plan: bf16 buffers must start 16-byte "
                             "aligned (TMA)")
        if plan.groups_device is None:
            raise ValueError("run_plan: the plan holds no tile groups; "
                             "build it for bfloat16 on the card")
        # Every element lies in some group's rows, and the groups write all
        # of them (zeros past each tenant's m and its column blocks).
        out = torch.empty((plan.m_flat, plan.np_pad), dtype=a_flat.dtype,
                          device=dev)
        err = _lib("coexec_wgmma", _WGMMA_ARGS)(
            a_flat.data_ptr(), b_stack.data_ptr(), out.data_ptr(),
            plan.groups_device.data_ptr(), len(plan.groups), n_t,
            plan.m_flat, plan.kp, plan.np_pad, plan.k6_cluster, stream)
    LAUNCHES.n += 1
    _build.check("coexec", err)
    return out


def run_plan(plan: CoexecPlan, a_flat: torch.Tensor,
             b_stack: torch.Tensor) -> torch.Tensor:
    """Launch the fused grid on pre-packed operands (one launch of K6
    for CUDA buffers, the plain version for CPU ones); returns the flat
    ``(M_flat, Np)`` output for :func:`unpack_outputs`.  Columns past a
    tenant's last column block read 0."""
    if a_flat.device.type == "cpu":
        return run_plan_plain(plan, a_flat, b_stack)
    if a_flat.device.type != "cuda":
        raise ValueError(f"run_plan: no kernel for {a_flat.device}")
    return _run_plan_kernel(plan, a_flat, b_stack)


def unpack_outputs(plan: CoexecPlan,
                   out_flat: torch.Tensor) -> List[torch.Tensor]:
    """Slice the fused ``(M_flat, Np)`` output back into per-tenant
    results."""
    outs = []
    for i, t in enumerate(plan.tenants):
        off = plan.row_offsets[i]
        outs.append(out_flat[off:off + t.m, :t.n])
    return outs


def coexec_matmul(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor], *,
                  order: Optional[Sequence[int]] = None,
                  plan: Optional[CoexecPlan] = None,
                  block_rows: Optional[int] = None,
                  m_hint: Optional[int] = None) -> List[torch.Tensor]:
    """Execute T heterogeneous GEMMs ``xs[i] @ ws[i]`` in one fused grid.

    ``xs[i]: (mᵢ, kᵢ)``, ``ws[i]: (kᵢ, nᵢ)`` → list of ``(mᵢ, nᵢ)``.
    Pass ``order=coexec_tile_sequence(packed)`` to walk tiles in the
    packer's schedule order (the result does not depend on it).  An
    empty tenant set returns ``[]``.  A pre-built ``plan`` (same shapes)
    skips the placement and pins the block shapes."""
    if len(xs) != len(ws):
        raise ValueError(f"{len(xs)} activations vs {len(ws)} weights")
    if not xs:
        return []
    tenants = [CoexecTenant(rid=i, m=x.shape[0], n=w.shape[1], k=x.shape[1])
               for i, (x, w) in enumerate(zip(xs, ws))]
    if plan is None:
        plan = build_coexec_plan(tenants, xs[0].dtype, order=order,
                                 block_rows=block_rows, m_hint=m_hint,
                                 device=xs[0].device)
    elif tuple(t.m for t in plan.tenants) != tuple(t.m for t in tenants):
        raise ValueError("the plan was built for other tenants")
    a_flat, b_stack = pack_operands(plan, xs, ws)
    return unpack_outputs(plan, run_plan(plan, a_flat, b_stack))


def single_tenant_plans(plan: CoexecPlan,
                        dtype: torch.dtype = torch.float32
                        ) -> List[CoexecPlan]:
    """Per-tenant single-GEMM plans pinned to ``plan``'s block shapes
    (and its device), what :func:`sequential_matmul` launches
    back-to-back; build them once, outside any timed region."""
    device = (plan.meta_device.device if plan.meta_device is not None
              else None)
    return [build_coexec_plan([CoexecTenant(rid=0, m=t.m, n=t.n, k=t.k)],
                              dtype, block_rows=plan.bm, block_cols=plan.bn,
                              block_k=plan.bk, device=device)
            for t in plan.tenants]


def sequential_matmul(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                      *, plan: Optional[CoexecPlan] = None,
                      singles: Optional[Sequence[CoexecPlan]] = None
                      ) -> List[torch.Tensor]:
    """The serial baseline: one launch per tenant, back-to-back, through
    the same kernel as single-tenant grids with the same block shapes —
    identical MACs and accumulation order, another launch structure."""
    if not xs:
        return []
    if singles is None:
        if plan is None:
            tenants = [CoexecTenant(rid=i, m=x.shape[0], n=w.shape[1],
                                    k=x.shape[1])
                       for i, (x, w) in enumerate(zip(xs, ws))]
            plan = build_coexec_plan(tenants, xs[0].dtype,
                                     device=xs[0].device)
        singles = single_tenant_plans(plan, xs[0].dtype)
    outs: List[torch.Tensor] = []
    for x, w, single in zip(xs, ws, singles):
        outs.extend(coexec_matmul([x], [w], plan=single))
    return outs
