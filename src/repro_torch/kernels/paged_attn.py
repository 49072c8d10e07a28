"""K2: paged-attention decode over the flat page pool, as a hand-written
Hopper kernel.

Replaces the JAX package's TPU kernel ``repro/kernels/paged_attn.py::
_paged_attn_kernel`` (``_paged_attention_pallas``, ``pallas_call`` at
line 177).  The CUDA source is ``csrc/paged_attn.cu``; its header says
what bounds the kernel on an H100 (the live K/V bytes) and how the
layout and the ``pos``-bounded page loop address it.

The pool stays stationary: the page table is read inside the kernel, so
K/V never exists in dense logical order.  Pools are float (q's dtype),
or int8 with one bf16 scale per (page, offset, KV head) cell in planes
``(pages, page_size, Hkv, 1)`` (:func:`quantize_page_pool`), dequantized
inside the kernel as the reference's ``_dequant_block`` does.  The int8
launches count apart (``LAUNCHES_INT8``), so a serve shows which variant
ran.

The port has one backend, ``"kernel"``: the operands' device decides.
CUDA tensors launch K2 (or raise); CPU tensors take
:func:`paged_attention_plain`, the page-blocked online softmax twin of
the reference's ``_paged_attention_xla``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = torch.finfo(torch.float32).min

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_MAX_PAGE = 32      # one lane per page offset
_MAX_GROUP = 32     # one warp per query head of a GQA group

LAUNCHES = _build.LaunchCounter("paged_attn")
LAUNCHES_INT8 = _build.LaunchCounter("paged_attn_int8")


def set_paged_attn_backend(impl: str) -> None:
    """The reference's backend switch.  The port has only ``"kernel"``
    (module doc), so this validates and changes nothing."""
    if impl != "kernel":
        raise ValueError(f"paged-attn backend {impl!r}: the port has only "
                         "'kernel'; the operands' device picks K2 or its "
                         "plain version")


def quantize_page_pool(x: torch.Tensor):
    """Symmetric int8 quantization over the head dim: ``(int8 values,
    bf16 scales)`` with ``scale = max|x| / 127 + 1e-8`` in f32 per cell,
    values rounded half to even and clipped to +-127, and the scale
    rounded to bf16 only after the values were divided by the f32 scale
    (the reference's ``quantize_page_pool`` and ``_quant_kv``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def paged_attention_plain(q, pk, pv, table, pos, pk_scale=None,
                          pv_scale=None):
    """Plain version of K2: scans logical pages, gathers one physical
    page per row (dequantized with its scale planes for int8 pools), and
    folds it into the same (m, l, acc) recurrence the kernel carries —
    op for op the reference's ``_paged_attention_xla``."""
    b, n_heads, hd = q.shape
    _, psz, n_kv, _ = pk.shape
    n_rep = n_heads // n_kv
    qf = q.float()
    scale = torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    offs = torch.arange(psz, device=q.device)
    table = table.long()
    pos = pos.long()
    m = torch.full((b, n_heads, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, n_heads, 1), device=q.device)
    acc = torch.zeros((b, n_heads, hd), device=q.device)
    for j in range(table.shape[1]):
        phys = table[:, j]
        k = pk[phys].float()                                  # (B,psz,Hkv,hd)
        v = pv[phys].float()
        if pk_scale is not None:
            k = k * pk_scale[phys].float()
            v = v * pv_scale[phys].float()
        if n_rep > 1:
            k = k.repeat_interleave(n_rep, dim=2)             # (B,psz,H,hd)
            v = v.repeat_interleave(n_rep, dim=2)
        logits = torch.einsum("bhd,bkhd->bhk", qf, k) / scale
        idx = j * psz + offs
        logits = torch.where(idx[None, None, :] <= pos[:, None, None],
                             logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        probs = torch.exp(logits - m_new)
        l = alpha * l + probs.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhk,bkhd->bhd", probs, v)
        m = m_new
    return (acc / l).to(q.dtype)


def _lib():
    fn = _build.load("paged_attn").paged_attn
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       p]
        fn.restype = ctypes.c_int
    return fn


def _paged_attention_kernel(q, pk, pv, table, pos, pk_scale, pv_scale):
    b, n_heads, hd = q.shape
    n_pages, psz, n_kv, hd_k = pk.shape
    dev = q.device
    quant = pk_scale is not None
    if pv.shape != pk.shape or hd_k != hd or n_heads % n_kv:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not fit "
                         f"pools {tuple(pk.shape)} / {tuple(pv.shape)}")
    if table.dim() != 2 or table.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"paged_attention: table {tuple(table.shape)} / "
                         f"pos {tuple(pos.shape)} do not fit {b} rows")
    operands = (pk, pv, table, pos) + ((pk_scale, pv_scale) if quant else ())
    if any(t.device != dev for t in operands):
        raise ValueError("paged_attention: operands on different devices")
    if quant:
        plane = (n_pages, psz, n_kv, 1)
        if (pk.dtype != torch.int8 or pv.dtype != torch.int8
                or q.dtype not in _DTYPES
                or any(t.dtype != torch.bfloat16 or t.shape != plane
                       for t in (pk_scale, pv_scale))):
            raise ValueError(
                f"paged_attention takes int8 pools with bf16 scale planes "
                f"{plane} and a float32 or bfloat16 q, got pools "
                f"{pk.dtype}/{pv.dtype}, planes {pk_scale.dtype} "
                f"{tuple(pk_scale.shape)}, q {q.dtype}")
    elif q.dtype not in _DTYPES or pk.dtype != q.dtype or pv.dtype != q.dtype:
        raise ValueError(f"paged_attention takes float32 or bfloat16 q and "
                         f"pools of q's dtype (or int8 pools with scale "
                         f"planes), got {q.dtype}/{pk.dtype}")
    if (hd not in _HEAD_DIMS or psz > _MAX_PAGE
            or n_heads // n_kv > _MAX_GROUP):
        raise NotImplementedError(
            f"K2 takes head_dim in {_HEAD_DIMS}, page_size <= {_MAX_PAGE} "
            f"and at most {_MAX_GROUP} query heads per KV head; got "
            f"hd={hd}, psz={psz}, group={n_heads // n_kv}")
    q = q.contiguous()
    pk, pv = pk.contiguous(), pv.contiguous()
    if quant:
        pk_scale, pv_scale = pk_scale.contiguous(), pv_scale.contiguous()
        scales = (pk_scale.data_ptr(), pv_scale.data_ptr())
    else:
        scales = (None, None)
    table = table.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), pk.data_ptr(), pv.data_ptr(), *scales,
                 table.data_ptr(), pos.data_ptr(), out.data_ptr(), b,
                 n_heads, n_kv, hd, psz, table.shape[1], n_pages,
                 _DTYPES[q.dtype], int(quant),
                 torch.cuda.current_stream(dev).cuda_stream)
    (LAUNCHES_INT8 if quant else LAUNCHES).n += 1
    _build.check("paged_attn", err)
    return out


def paged_attention(q, pk, pv, table, pos, pk_scale=None, pv_scale=None):
    """Fused paged-attention decode: attend rows to their mapped pages.

    Args:
      q: ``(B, n_heads, head_dim)`` post-RoPE queries, one per row.
      pk, pv: flat page pools ``(num_pages + sink, page_size, n_kv, hd)``
        — of q's dtype, or int8 when ``pk_scale``/``pv_scale`` (bf16
        planes ``(num_pages + sink, page_size, n_kv, 1)``) are given.
      table: ``(B, max_pages_per_slot)`` int32 logical -> physical map;
        entries past a row's position may point anywhere in the pool
        (typically the sink page) — they are never attended.
      pos: ``(B,)`` int32 per-row positions; row ``i`` attends logical
        positions ``<= pos[i]`` only.

    Returns ``(B, n_heads, head_dim)`` attention outputs in ``q.dtype``.
    """
    if (pk_scale is None) != (pv_scale is None):
        raise ValueError("paged_attention: give both scale planes or none")
    if q.device.type == "cpu":
        return paged_attention_plain(q, pk, pv, table, pos, pk_scale,
                                     pv_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    return _paged_attention_kernel(q, pk, pv, table, pos, pk_scale, pv_scale)
