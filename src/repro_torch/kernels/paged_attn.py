"""K2: paged-attention decode over the flat page pool, as a hand-written
Hopper kernel.

Replaces the JAX package's TPU kernel ``repro/kernels/paged_attn.py::
_paged_attn_kernel`` (``_paged_attention_pallas``, ``pallas_call`` at
line 177).  The CUDA source is ``csrc/paged_attn.cu``; its header says
what bounds the kernel on an H100 (latency: the live K/V bytes take a
fraction of a microsecond) and how the split-KV design shortens it.

The pool stays stationary: the page table is read inside the kernel, so
K/V never exists in dense logical order.  Pools are float (q's dtype),
or int8 with one bf16 scale per (page, offset, KV head) cell in planes
``(pages, page_size, Hkv, 1)`` (:func:`quantize_page_pool`), dequantized
inside the kernel as the reference's ``_dequant_block`` does.  The int8
launches count apart (``LAUNCHES_INT8``), so a serve shows which variant
ran.

:func:`k2_plan` lays a launch out from static shapes only (the rows'
positions live on the card): pages a split and splits, one KV head a
CTA.
:func:`paged_attention_split_plain` computes what the kernel computes
under a plan, split by split, then the combine.

The port has one backend, ``"kernel"``: the operands' device decides.
CUDA tensors launch K2 (or raise); CPU tensors take
:func:`paged_attention_plain`, the page-blocked online softmax twin of
the reference's ``_paged_attention_xla``.  On a mesh,
:func:`paged_attention_sharded` launches K2 once a shard, on the shard's
heads.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.distributed.mesh import P, Sharded
from repro_torch.kernels import _build

NEG_INF = torch.finfo(torch.float32).min

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_MAX_PAGE = 32      # one lane per page offset
_MAX_GROUP = 32     # one warp per query head of a GQA group
K2_MAX_PPS = 8      # pages a split keeps in flight (kMaxPps in the source)
K2_PPS = 2          # pages a split by default (scripts/k2_sweep.py)
K2_MAX_SMEM = 227 * 1024 - 1024     # dynamic bytes a CTA may ask (kMaxSmem)

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


@dataclasses.dataclass(frozen=True)
class K2Plan:
    """How one K2 launch is laid out on the card (:func:`k2_plan`): a
    row's ``pmax`` pages are cut into ``n_splits`` splits of
    ``pages_per_split`` pages; one CTA per (split, KV head, row), one
    warp per (page of the split, query head of the KV head's group).
    Every page of a split is in flight, and computed, at once, so
    ``pages_per_split`` is also the pipeline depth."""

    pages_per_split: int
    n_splits: int


def k2_smem_bytes(heads: int, psz: int, pages: int, hd: int,
                  pool_itemsize: int, quant: bool) -> int:
    """A CTA's dynamic shared memory (``smem_bytes`` in the source): q in
    f32, ``pages`` pages of K and V cell rows in the pool's dtype, each
    row padded by 16 bytes, each (page, head) warp's f32 state (m, l,
    acc), and for int8 pools the pages' scales in f32."""
    return (heads * hd * 4 + pages * 2 * psz * (hd * pool_itemsize + 16)
            + pages * heads * (hd + 2) * 4
            + (pages * 2 * psz * 4 if quant else 0))


@functools.lru_cache(maxsize=1024)
def k2_plan(b: int, n_heads: int, n_kv: int, hd: int, psz: int, pmax: int,
            pool_itemsize: int = 2, quant: bool = False, *,
            pages_per_split: int = 0) -> K2Plan:
    """K2's launch plan from static shapes (no CTA knows the rows'
    positions before it runs): ``K2_PPS`` pages a split, computed side by
    side by one warp a (page, query head), unless asked otherwise; fewer
    pages where ``pmax``, the CTA's 32 warps or its shared memory hold
    fewer.  At both serve layouts, on bf16 and int8 pools, at the end of
    a serve and on a full pool, that was the fastest plan
    (``scripts/k2_sweep.py``, PERF.md)."""
    heads = n_heads // n_kv

    def fits(pages):
        return (pages * heads * 32 <= 1024
                and k2_smem_bytes(heads, psz, pages, hd, pool_itemsize,
                                  quant) <= K2_MAX_SMEM)

    pps = pages_per_split
    if not pps:
        pps = min(K2_PPS, pmax)
        while pps > 1 and not fits(pps):
            pps -= 1
    if not 1 <= pps <= K2_MAX_PPS or not fits(pps):
        raise ValueError(f"k2_plan: {pps} pages a split of {heads} query "
                         f"heads do not fit a CTA")
    return K2Plan(pps, -(-pmax // pps))


def _page_step(qf, k, v, j, psz, pos, offs, scale, m, l, acc):
    """Fold logical page ``j`` (K/V ``(B, psz, H, hd)`` in f32) into the
    online softmax ``(m, l, acc)``: the reference's page step."""
    logits = torch.einsum("bhd,bkhd->bhk", qf, k) / scale
    idx = j * psz + offs
    logits = torch.where(idx[None, None, :] <= pos[:, None, None],
                         logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    probs = torch.exp(logits - m_new)
    l = alpha * l + probs.sum(dim=-1, keepdim=True)
    acc = alpha * acc + torch.einsum("bhk,bkhd->bhd", probs, v)
    return m_new, l, acc


def _page_kv(pk, pv, pk_scale, pv_scale, phys, n_rep):
    """One physical page a row as f32 ``(B, psz, H, hd)`` K and V,
    dequantized with the scale planes for int8 pools."""
    k = pk[phys].float()                                  # (B,psz,Hkv,hd)
    v = pv[phys].float()
    if pk_scale is not None:
        k = k * pk_scale[phys].float()
        v = v * pv_scale[phys].float()
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)             # (B,psz,H,hd)
        v = v.repeat_interleave(n_rep, dim=2)
    return k, v


def _softmax_state(b, n_heads, hd, device):
    return (torch.full((b, n_heads, 1), NEG_INF, device=device),
            torch.zeros((b, n_heads, 1), device=device),
            torch.zeros((b, n_heads, hd), device=device))


def paged_attention_plain(q, pk, pv, table, pos, pk_scale=None,
                          pv_scale=None):
    """Plain version of K2: scans logical pages, gathers one physical
    page per row (dequantized with its scale planes for int8 pools), and
    folds it into the same (m, l, acc) recurrence the kernel carries —
    op for op the reference's ``_paged_attention_xla``."""
    b, n_heads, hd = q.shape
    _, psz, n_kv, _ = pk.shape
    qf = q.float()
    scale = torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    offs = torch.arange(psz, device=q.device)
    table = table.long()
    pos = pos.long()
    m, l, acc = _softmax_state(b, n_heads, hd, q.device)
    for j in range(table.shape[1]):
        k, v = _page_kv(pk, pv, pk_scale, pv_scale, table[:, j],
                        n_heads // n_kv)
        m, l, acc = _page_step(qf, k, v, j, psz, pos, offs, scale, m, l, acc)
    return (acc / l).to(q.dtype)


def _merge(states, live=None):
    """The combine of online-softmax states ``(m, l, acc)`` in list order
    (``live``: a ``(B, 1, 1)`` mask a state; a dead one is ``(finfo.min,
    0, 0)``): ``w_i = exp(m_i - max m)``, ``l = sum w_i l_i``, ``acc =
    sum w_i acc_i``, as the kernel merges a split's pages and then the
    splits."""
    if live is not None:
        states = [(torch.where(lv, m, NEG_INF), torch.where(lv, l, 0.0),
                   torch.where(lv, acc, 0.0))
                  for (m, l, acc), lv in zip(states, live)]
    m_max = states[0][0]
    for m, _, _ in states[1:]:
        m_max = torch.maximum(m_max, m)
    l_sum = torch.zeros_like(states[0][1])
    acc_sum = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.exp(m - m_max)
        l_sum = l_sum + w * l
        acc_sum = acc_sum + w * acc
    return m_max, l_sum, acc_sum


def paged_attention_split_plain(q, pk, pv, table, pos, pk_scale=None,
                                pv_scale=None, *, plan: K2Plan):
    """Plain version of K2 under ``plan``: each live page's own
    online-softmax state (the page step of :func:`paged_attention_plain`
    from an empty state), merged in page order into its split's, then the
    kernel's combine over the splits that hold a live page (``split *
    pages_per_split <= pos // psz``).  A page or split with nothing live
    contributes nothing (``m`` = finfo.min, ``l`` = 0), as the kernel's
    warps and CTAs with nothing to attend."""
    b, n_heads, hd = q.shape
    _, psz, n_kv, _ = pk.shape
    pmax = table.shape[1]
    pps = plan.pages_per_split
    if plan.n_splits != -(-pmax // pps):
        raise ValueError(f"plan of {plan.n_splits} splits of {pps} pages "
                         f"does not cover {pmax} pages")
    qf = q.float()
    scale = torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    offs = torch.arange(psz, device=q.device)
    table = table.long()
    pos = pos.long()
    n_live = torch.clamp(pos // psz + 1, max=pmax)
    splits, split_live = [], []
    for s in range(plan.n_splits):
        pages, page_live = [], []
        for j in range(s * pps, min((s + 1) * pps, pmax)):
            k, v = _page_kv(pk, pv, pk_scale, pv_scale, table[:, j],
                            n_heads // n_kv)
            pages.append(_page_step(qf, k, v, j, psz, pos, offs, scale,
                                    *_softmax_state(b, n_heads, hd,
                                                    q.device)))
            page_live.append((j < n_live)[:, None, None])
        splits.append(_merge(pages, page_live))
        split_live.append((s * pps < n_live)[:, None, None])
    _, l, acc = _merge(splits, split_live)
    return (acc / l).to(q.dtype)


def _lib():
    fn = _build.load("paged_attn").paged_attn
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 11 + [p]
        fn.restype = ctypes.c_int
    return fn


# One workspace a device, reused by every launch of more than one split:
# the f32 partials and the int32 arrival counters, which each launch
# leaves at 0 (the combining CTA resets its own).  The port issues K2 on
# one stream, so no two launches use it at once; a second stream would
# need its own.
_WORKSPACE: dict = {}


def _workspace(dev, n_floats: int, n_counters: int):
    ws = _WORKSPACE.get(dev)
    if ws is None or ws[0].numel() < n_floats or ws[1].numel() < n_counters:
        old = ws or (torch.empty(0), torch.empty(0))
        ws = (torch.empty(max(n_floats, old[0].numel()),
                          dtype=torch.float32, device=dev),
              torch.zeros(max(n_counters, old[1].numel()),
                          dtype=torch.int32, device=dev))
        _WORKSPACE[dev] = ws
    return ws


def _paged_attention_kernel(q, pk, pv, table, pos, pk_scale, pv_scale,
                            plan=None):
    """One launch of K2, under ``plan`` (default: :func:`k2_plan`'s)."""
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
    if q.data_ptr() % 16:
        q = q.clone()
    if pk.data_ptr() % 16 or pv.data_ptr() % 16:
        raise ValueError("paged_attention: K2 reads the pools in 16-byte "
                         "pieces; their base addresses are not 16-byte "
                         "aligned")
    if quant:
        pk_scale, pv_scale = pk_scale.contiguous(), pv_scale.contiguous()
        scales = (pk_scale.data_ptr(), pv_scale.data_ptr())
    else:
        scales = (None, None)
    table = table.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    pmax = table.shape[1]
    if plan is None:
        plan = k2_plan(b, n_heads, n_kv, hd, psz, pmax, pk.element_size(),
                       quant)
    scratch = (None, None)
    if plan.n_splits > 1:
        part, counters = _workspace(
            dev, b * n_heads * plan.n_splits * (hd + 2), b * n_kv)
        scratch = (part.data_ptr(), counters.data_ptr())
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), pk.data_ptr(), pv.data_ptr(), *scales,
                 table.data_ptr(), pos.data_ptr(), out.data_ptr(), *scratch,
                 b, n_heads, n_kv, hd, psz, pmax, n_pages,
                 plan.pages_per_split, plan.n_splits,
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


def paged_attention_sharded(q, pk, pv, table, pos, *, mesh,
                            model_axis: str = "model",
                            pk_scale=None, pv_scale=None):
    """Tensor-parallel :func:`paged_attention` over ``mesh``'s model row
    (the reference's ``paged_attention_sharded``).

    ``q`` and the pools (and scale planes) are
    :class:`~repro_torch.distributed.mesh.Sharded`: ``q`` ``(B, H, hd)``
    split on its heads, the pools ``(pages + sink, page_size, Hkv, hd)``
    on their KV heads with the page axis whole, as ``cache_specs`` lays
    them out; ``table`` and ``pos`` are replicated (one tensor, moved to
    each shard's device).  Heads are independent in the online softmax,
    so each shard launches K2 on its own query heads and KV-head slice,
    the GQA ratio intact, and the result is ``q``'s layout.

    Where the model axis does not divide both head counts,
    ``cache_specs`` lays the pools out on the page interior instead and
    ``q`` is replicated: the pools are gathered and one unsharded call
    runs on rank 0's device, its output replicated, as in the
    reference.  Which of the two runs follows the pools' spec."""
    scaled = pk_scale is not None
    entries = tuple(pk.spec) + (None,) * 4
    if entries[2] is None:
        scales = (pk_scale.gather(), pv_scale.gather()) if scaled else ()
        out = paged_attention(q.gather(), pk.gather(), pv.gather(), table,
                              pos, *scales)
        return Sharded([out.to(d) for d in mesh.model_devices(model_axis)],
                       P(), tuple(out.shape), mesh)
    outs = []
    for r, qr in enumerate(q.shards):
        dev = qr.device
        scales = ((pk_scale.shards[r], pv_scale.shards[r]) if scaled
                  else ())
        outs.append(paged_attention(qr, pk.shards[r], pv.shards[r],
                                    table.to(dev), pos.to(dev), *scales))
    return Sharded(outs, P(None, model_axis), tuple(q.shape), mesh)
