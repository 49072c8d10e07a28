"""Public, differentiable entry points for K1 (the port of
``repro/kernels/ops.py``).

``sisa_matmul`` is the op every linear layer and the LM head call.  It

* runs a ragged ``M > 128`` as a full-height main pass plus a scale-in
  residual pass (§3.2 "M > array height"), each pass one launch writing
  its own rows of one output — the kernel masks ragged edges itself, so
  nothing is padded or concatenated;
* is a :class:`torch.autograd.Function` whose backward runs the same
  GEMM (dA = dC @ B^T is exactly as skewed as the forward).

The port has one backend, ``"kernel"``: the operands' device decides.
CUDA tensors launch K1 (or raise); CPU tensors take its plain version.
Unlike the reference, whose default is the dense XLA dot, nothing on the
card gives way to a dense library GEMM.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels.sisa_gemm import sisa_gemm


def set_default_backend(backend: str) -> None:
    """The reference's backend switch.  The port has only ``"kernel"``
    (module doc), so this validates and changes nothing."""
    if backend != "kernel":
        raise ValueError(f"backend {backend!r}: the port has only 'kernel'; "
                         "the operands' device picks K1 or its plain version")


def row_passes(m: int) -> List[Tuple[int, int]]:
    """Row ranges ``[start, stop)`` of the launches for an M-row GEMM:
    one pass, or a 128-multiple main pass plus its residual."""
    if m > 128 and m % 128:
        main = (m // 128) * 128
        return [(0, main), (main, m)]
    return [(0, m)]


def _forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    passes = row_passes(a.shape[0])
    if len(passes) == 1:
        return sisa_gemm(a, b)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype,
                      device=a.device)
    for lo, hi in passes:
        sisa_gemm(a[lo:hi], b, out=out[lo:hi])
    return out


class _SisaMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _forward(a, b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc = dc.contiguous()
        # dA[M,K] = dC[M,N] @ B^T[N,K]  — same M-skew as the forward GEMM.
        da = _forward(dc, b.t())
        # dB[K,N] = A^T[K,M] @ dC[M,N]  — M becomes the contraction dim;
        # K1 reads A^T in place as an M-major operand (bf16 on the card).
        db = _forward(a.t(), dc)
        return da.to(a.dtype), db.to(b.dtype)


def sisa_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with SISA shape-adaptive tiling.  a: (M, K), b: (K, N);
    f32 accumulation, result in A's dtype."""
    return _SisaMatmul.apply(a, b)


def sisa_einsum_2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) -> (..., N) through the SISA op."""
    lead = x.shape[:-1]
    out = sisa_matmul(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1])
