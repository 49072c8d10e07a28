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

Only the height crosses into K1's library: the tile width and depth of
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

K3, the split-K variant (``repro/kernels/sisa_gemm.py::_splitk_kernel``,
``pallas_call`` at line 132), is :func:`sisa_gemm_splitk`: each slab of
``cfg.bk`` columns of K writes its own f32 partial C, and the partials
are summed outside the kernel.  Its tiles (and K6's and K7's) are
``csrc/tile_gemm.cuh``'s, ``TILE_COLS`` wide with ``TILE_K``-deep K
steps; K1 does not dispatch to it.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_HEIGHTS = (16, 32, 64, 128)
# Tile width and K step of csrc/tile_gemm.cuh (K3, K6, K7); the CUDA side
# refuses any other.
TILE_COLS = 64
TILE_K = 32

LAUNCHES = _build.LaunchCounter("sisa_gemm")
SPLITK_LAUNCHES = _build.LaunchCounter("sisa_gemm_splitk")


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


def sisa_gemm_splitk_plain(a: torch.Tensor, b: torch.Tensor,
                           bk: int) -> torch.Tensor:
    """Plain version of K3's launch: the ``(n_k, M, N)`` f32 partial
    products of ``a @ b`` over slabs of ``bk`` columns of K."""
    return torch.stack([a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
                        for k0 in range(0, a.shape[1], bk)])


def _splitk_lib():
    fn = _build.load("sisa_gemm").sisa_gemm_splitk
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, i, i, i, ll, ll, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _splitk_partials(a: torch.Tensor, b: torch.Tensor,
                     cfg: BlockConfig) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    if a.dtype not in _DTYPES:
        raise ValueError(f"sisa_gemm_splitk takes float32 or bfloat16, not "
                         f"{a.dtype}")
    if cfg.bm not in TILE_HEIGHTS:
        raise NotImplementedError(f"K3 takes tile heights {TILE_HEIGHTS}, "
                                  f"not bm={cfg.bm}")
    a, b = a.contiguous(), b.contiguous()
    part = torch.empty((-(-k // cfg.bk), m, n), dtype=torch.float32,
                       device=a.device)
    tensor_cores = (a.dtype == torch.bfloat16 and cfg.bk % 8 == 0
                    and k % 8 == 0 and n % 8 == 0
                    and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    err = _splitk_lib()(a.data_ptr(), b.data_ptr(), part.data_ptr(), m, n,
                        k, cfg.bk, k, n, _DTYPES[a.dtype], cfg.bm,
                        int(tensor_cores),
                        torch.cuda.current_stream(a.device).cuda_stream)
    SPLITK_LAUNCHES.n += 1
    _build.check("sisa_gemm", err)
    return part


def sisa_gemm_splitk(a: torch.Tensor, b: torch.Tensor,
                     cfg: BlockConfig) -> torch.Tensor:
    """K3: C[M,N] = A[M,K] @ B[K,N] by K slabs.  One launch writes the
    f32 partial product of every slab of ``cfg.bk`` columns of K into
    ``(n_k, M, N)``; ``torch.sum`` over the slabs, outside the kernel,
    gives C in A's dtype (the reference sums with ``jnp.sum``).

    ``cfg.bm`` is the tile height (16, 32, 64 or 128 on the card),
    ``cfg.bk`` the slab depth (> 0) and ``cfg.bn``, if given, a multiple
    of the kernel's ``TILE_COLS``-wide column tile.  Unlike the
    reference, M, N and K need not be multiples of the blocks: ragged
    edges are masked in the kernel."""
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
        part = sisa_gemm_splitk_plain(a, b, cfg.bk)
    elif a.device.type == "cuda":
        part = _splitk_partials(a, b, cfg)
    else:
        raise ValueError(f"sisa_gemm_splitk: no kernel for {a.device}")
    return torch.sum(part, dim=0).to(a.dtype)
