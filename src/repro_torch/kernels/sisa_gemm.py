"""K1: the SISA-scheduled GEMM as a hand-written Hopper kernel.

Replaces the JAX package's TPU kernel ``repro/kernels/sisa_gemm.py::
_gemm_kernel`` (``sisa_gemm``, ``pallas_call`` at line 166).  The CUDA
source is ``csrc/sisa_gemm.cu``; its header says what bounds the kernel
on an H100 and what the design does about it.

:func:`choose_block_config` keeps the paper's §3.2 scheduler — three
execution modes picked from M — with tile heights re-derived for Hopper
instead of the TPU's (8, 128) tiling and 8 MiB VMEM budget:

* ``M <= 16``  -> slab tiles, ``bm = 16``: the height of one ``mma``
  row group, covering every decode rung up to 16 in one tile row; the
  freed width is re-invested as more, narrower column blocks so a
  GEMV-shaped decode still spreads over the SMs, and (bf16) as a deeper
  K tile split over four warps, so each block keeps more weight bytes
  in flight.
* ``16 < M <= 64`` -> fused slabs, ``bm = 32`` or ``64``.
* ``M > 64`` -> the monolithic 128-row tile.

Only the height crosses into the library: the tile width and depth of
each height are set in one place, ``dispatch_tc`` and ``dispatch`` in
``csrc/sisa_gemm.cu``.

bf16 operands with 16-byte aligned rows (every main-path shape) run on
the tensor cores (``mma.sync``, a ``cp.async`` pipeline of 3-4 stages);
float32, and bf16 rows without that alignment, run the same tile heights
on the CUDA cores, so float32 stays exact float32.  A ragged ``M > 128``
runs as a full-height main pass plus a scale-in residual pass
(``repro_torch.kernels.ops``); ragged edges are masked inside the
kernel, so operands are never padded.

:func:`sisa_gemm` launches the kernel for CUDA tensors and takes its
plain version, :func:`sisa_gemm_plain`, only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = _build.LaunchCounter("sisa_gemm")


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Tile height ``bm`` chosen by the §3.2 scheduler (the slab height)."""

    bm: int

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


def sisa_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: f32 accumulation, result in A's dtype (the
    twin of the reference's ``gemm_ref``)."""
    return (a.float() @ b.float()).to(a.dtype)


def _lib():
    lib = _build.load("sisa_gemm")
    fn = lib.sisa_gemm
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, i, i, ll, ll, ll, ll, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def sisa_gemm(a: torch.Tensor, b: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] in one launch of K1 (any M; ragged edges
    are masked in the kernel).  ``b`` may be row-major or a transposed
    view (``table.T``), read in place either way.  ``out``, if given,
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
    if a.stride(1) != 1:
        a = a.contiguous()
    if b.stride(1) == 1:
        trans_b, sbk, sbn = 0, b.stride(0), 1
    elif b.stride(0) == 1:
        trans_b, sbk, sbn = 1, 1, b.stride(1)
    else:
        b = b.contiguous()
        trans_b, sbk, sbn = 0, b.stride(0), 1
    cfg = choose_block_config(m, n, k, a.dtype)
    # The tensor-core body copies 16-byte chunks of A's and B's rows.
    ldb = sbn if trans_b else sbk
    tensor_cores = (a.dtype == torch.bfloat16 and a.data_ptr() % 16 == 0
                    and b.data_ptr() % 16 == 0 and a.stride(0) % 8 == 0
                    and ldb % 8 == 0)
    err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                 a.stride(0), sbk, sbn, n, trans_b,
                 _DTYPES[a.dtype], cfg.bm, int(tensor_cores),
                 torch.cuda.current_stream(a.device).cuda_stream)
    LAUNCHES.n += 1
    _build.check("sisa_gemm", err)
    return out
