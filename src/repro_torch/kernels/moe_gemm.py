"""K7: the capacity-padded batched expert GEMM as a hand-written Hopper
kernel, ``(E, C, d) @ (E, d, f) -> (E, C, f)``.

Replaces the JAX package's TPU kernel ``repro/kernels/moe_gemm.py::
_moe_kernel`` (``moe_grouped_gemm``, ``pallas_call`` at line 56).  The
CUDA source is ``csrc/moe_gemm.cu``; its header says what bounds the
kernel on an H100.  bf16 operands with 16-byte aligned rows run the TMA +
``wgmma`` mainloop of ``csrc/hopper_gemm.cuh`` (K4's), laid out by
:func:`k7_plan` (pure Python; the C entry refuses a plan it was not
instantiated for): no K split, so the plain version's single f32 product
is the plan's sum too.  float32, and bf16 rows without that alignment,
run the CUDA-core body at the tile height the §3.2 scheduler picks on the
capacity C (:func:`~repro_torch.kernels.sisa_gemm.choose_block_config`),
as the reference picks its ``bc``.  Ragged C, d and f are masked inside
the kernel instead of padded.

The port's MoE layer does not call it: its experts take the flat
dispatch through K4 (``repro_torch.models.moe``), as the reference's
``_grouped`` path does.  :func:`moe_grouped_gemm` launches K7 for CUDA
tensors and takes :func:`moe_grouped_gemm_plain` only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grouped_gemm import K4_BAND_BYTES
from repro_torch.kernels.sisa_gemm import choose_block_config

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The wgmma body's instantiations (csrc/moe_gemm.cu), mirrored from its C
# dispatch as (bq, nwg, stages), in ascending bq: 256 weight columns by
# 64 or 128 rows of an expert.  At phi3.5-moe-42b's expert shapes they
# beat every other tile of K4's list and (256, 2, 3) at capacities 2, 37
# and 320 (scripts/k7_sweep.py, PERF.md).
K7_PLANS = ((64, 4, 5), (128, 4, 4))

LAUNCHES = _build.LaunchCounter("moe_gemm")


@dataclasses.dataclass(frozen=True)
class K7Plan:
    """How one bf16 K7 launch is laid out on the card (:func:`k7_plan`):
    swap-AB, a CTA covers ``64 * nwg`` weight columns of one expert by
    ``bq`` of its C rows, in ``stages`` pipeline stages of 64 along d;
    ``band`` row tiles of the expert run side by side for each tile of
    weight columns.  The grid is (row tiles x weight-column tiles,
    experts)."""

    bq: int
    nwg: int
    stages: int
    band: int


@functools.lru_cache(maxsize=1024)
def k7_plan(c: int, d: int, f: int) -> K7Plan:
    """K7's launch plan for capacity ``c`` against (d, f) weights: 256
    weight columns a CTA, by one row tile of 64 an expert up to C 64
    (decode: the weights are read once, and rows past C are TMA's zero
    fill, never read), above by row tiles of 128 (each row tile reads the
    expert's weights again, from L2 where a band holds them); a band of
    the expert's row tiles that holds ``K4_BAND_BYTES`` of x."""
    bq, nwg, stages = K7_PLANS[0] if c <= 64 else K7_PLANS[1]
    n_ct = -(-c // bq)
    band = max(1, min(n_ct, K4_BAND_BYTES // (bq * d * 2)))
    return K7Plan(bq, nwg, stages, band)


def moe_grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: f32 accumulation, result in x's dtype (the
    twin of the reference's ``grouped_gemm_ref``)."""
    return (x.float() @ w.float()).to(x.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C signatures of the CUDA-core body (``moe_gemm``) and the wgmma body
# (``moe_gemm_wgmma``).
_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_WGMMA_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]


def _lib(name: str = "moe_gemm", argtypes: list = _ARGS):
    fn = getattr(_build.load("moe_gemm"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def moe_grouped_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, f) -> (E, C, f) in x's dtype, each
    expert's product accumulated in f32.  Any C, d and f."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_grouped_gemm needs (E,C,d) @ (E,d,f), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != w.dtype or x.device != w.device:
        raise ValueError(f"moe_grouped_gemm: {x.dtype} on {x.device} vs "
                         f"{w.dtype} on {w.device}")
    if x.device.type == "cpu":
        return moe_grouped_gemm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_grouped_gemm: no kernel for {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"moe_grouped_gemm takes float32 or bfloat16, not "
                         f"{x.dtype}")
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if d == 0:
        return out.zero_()
    x, w = x.contiguous(), w.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # TMA reads and writes 16-byte aligned rows.
    if (x.dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        plan = k7_plan(c, d, f)
        err = _lib("moe_gemm_wgmma", _WGMMA_ARGS)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f, plan.bq,
            plan.nwg, plan.stages, plan.band, stream)
    else:
        err = _lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                     choose_block_config(c, f, d, x.dtype).bm,
                     _DTYPES[x.dtype], stream)
    LAUNCHES.n += 1
    _build.check("moe_gemm", err)
    return out
