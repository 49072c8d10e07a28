"""K7: the capacity-padded batched expert GEMM as a hand-written Hopper
kernel, ``(E, C, d) @ (E, d, f) -> (E, C, f)``.

Replaces the JAX package's TPU kernel ``repro/kernels/moe_gemm.py::
_moe_kernel`` (``moe_grouped_gemm``, ``pallas_call`` at line 56).  The
CUDA source is ``csrc/moe_gemm.cu``; its header says what bounds the
kernel on an H100.  The tile height follows the §3.2 scheduler on the
capacity C (:func:`~repro_torch.kernels.sisa_gemm.choose_block_config`),
as the reference picks its ``bc``; ragged C, d and f are masked inside
the kernel instead of padded.

The port's MoE layer does not call it: its experts take the flat
dispatch through K4 (``repro_torch.models.moe``), as the reference's
``_grouped`` path does.  :func:`moe_grouped_gemm` launches K7 for CUDA
tensors and takes :func:`moe_grouped_gemm_plain` only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sisa_gemm import choose_block_config

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = _build.LaunchCounter("moe_gemm")


def moe_grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: f32 accumulation, result in x's dtype (the
    twin of the reference's ``grouped_gemm_ref``)."""
    return (x.float() @ w.float()).to(x.dtype)


def _lib():
    fn = _build.load("moe_gemm").moe_gemm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
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
    bm = choose_block_config(c, f, d, x.dtype).bm
    tensor_cores = (x.dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
                    and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    err = _lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f, bm,
                 _DTYPES[x.dtype], int(tensor_cores),
                 torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES.n += 1
    _build.check("moe_gemm", err)
    return out
