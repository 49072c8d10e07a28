"""GQA attention: causal global (``ATTN``) and sliding-window
(``LOCAL``), an encoder's bidirectional (``BIDIR``) and a decoder's
cross-attention, with dense and paged KV decode (the port of
``repro/models/attention.py``).

Prefill attention is plain PyTorch (the reference's is plain XLA, not
Pallas): einsum logits with f32 accumulation, softmax in f32, the
probabilities cast to ``q.dtype`` before the PV product.  A ``LOCAL``
layer masks keys more than ``cfg.sliding_window`` positions back;
bidirectional and cross attention mask nothing, and cross attention
takes no RoPE.
The reference's opt-in banded local and chunked global prefill forms
(``set_attention_impl``) are not ported: nothing in the port selects
them yet.

Decode reads a dense per-row cache ``{"k","v": (B, cap, Hkv, hd)}`` in
plain PyTorch (:func:`attn_decode_step`; the reference's is plain XLA
too), or shared page pools: a global layer's pool through K2
(:func:`paged_attn_decode_step`), a local layer's ring of pages by a
plain gather (:func:`paged_local_attn_decode_step`, plain XLA in the
reference as well), a decoder's cross pool by a plain gather of its
block (:func:`paged_cross_attn_decode`).  A dense cache is a ring: a
global layer's capacity is the engine's ``max_seq``, a local layer's
``min(max_seq, window)`` (:func:`cache_capacity`), and that capacity is
all that limits a local layer's window at decode; a paged local layer
reads the same ring through its ring table.  :func:`prefill_into_cache`
lays a prompt longer than the capacity as that ring.  Dense caches are int8 with bf16
scale planes ``"k_s","v_s"`` while :func:`set_kv_cache_quant` is on.
A decoder's cross K/V (:func:`encode_cross_kv`) is projected once at
prefill, kept at model precision whatever that flag says, and only read
at decode (:func:`cross_attn_decode`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.collectives import all_gather
from repro_torch.distributed.mesh import P, Sharded
from repro_torch.kernels.paged_attn import (paged_attention,
                                            paged_attention_sharded,
                                            quantize_page_pool)
from repro_torch.models.common import (apply_rope, linear_apply, linear_in,
                                       linear_init, linear_out, reduce_rows)

Tensor = torch.Tensor
NEG_INF = torch.finfo(torch.float32).min


def attn_init(gen, cfg, dtype):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "q": linear_init(gen, d, cfg.n_heads * hd, dtype, cfg.use_bias),
        "k": linear_init(gen, d, cfg.n_kv_heads * hd, dtype, cfg.use_bias),
        "v": linear_init(gen, d, cfg.n_kv_heads * hd, dtype, cfg.use_bias),
        "o": linear_init(gen, cfg.n_heads * hd, d, dtype, cfg.use_bias),
    }


def _split_heads(x: Tensor, n_heads: int) -> Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1)


def _repeat_kv(kv: Tensor, n_rep: int) -> Tensor:
    if n_rep == 1:
        return kv
    return kv.repeat_interleave(n_rep, dim=2)


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor]) -> Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Skv,H,hd), mask: (1|B, 1, Sq, Skv) bool."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    # sqrt in f64 rounded to f32 is the f32 sqrt (correct rounding), so
    # this equals the reference's jnp.sqrt(float32(hd)) with no tensor
    # made on the device.
    logits = logits / math.sqrt(hd)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _causal_mask(sq: int, skv: int, window: Optional[int],
                 device) -> Tensor:
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    mask = kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    return mask[None, None]                         # (1, 1, Sq, Skv)


def _check_kind(kind: str, kv_x: Optional[Tensor]) -> None:
    if kind not in ("attn", "local", "bidir", "cross"):
        raise ValueError(f"attention kind {kind!r}")
    if (kind == "cross") != (kv_x is not None):
        raise ValueError("kv_x is the encoder output of cross attention "
                         "and of no other kind")


def attn_apply(p, x: Tensor, cfg, *, kind: str = "attn",
               positions: Optional[Tensor] = None,
               kv_x: Optional[Tensor] = None
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Full-sequence attention (training and prefill), the reference's
    default form, ``kind``:

    * ``"attn"`` (global) or ``"local"`` (sliding window): causal, RoPE
      on q and k;
    * ``"bidir"`` (an encoder layer): RoPE on q and k, no mask;
    * ``"cross"`` (a decoder layer's cross-attention): queries from
      ``x``, keys and values projected from ``kv_x`` (the encoder's
      output), no RoPE and no mask.

    Returns the output and the layer's K/V (post-RoPE for self
    attention), which :func:`prefill_into_cache` lays into a cache, or
    which are a decoder's cross K/V as is: the reference projects them a
    second time for that (``encode_cross_kv``), to the same values."""
    _check_kind(kind, kv_x)
    b, s, _ = x.shape
    src = x if kv_x is None else kv_x
    q = _split_heads(linear_apply(p["q"], x), cfg.n_heads)
    k = _split_heads(linear_apply(p["k"], src), cfg.n_kv_heads)
    v = _split_heads(linear_apply(p["v"], src), cfg.n_kv_heads)
    if kind != "cross":
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    mask = None
    if kind in ("attn", "local"):
        mask = _causal_mask(s, s, cfg.sliding_window if kind == "local"
                            else None, x.device)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = _sdpa(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), mask)
    out = out.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim)
    return linear_apply(p["o"], out), k, v


def encode_cross_kv(p, enc_out: Tensor, cfg) -> Dict[str, Tensor]:
    """A decoder layer's cross K/V ``{"k","v": (B, S_enc, Hkv, hd)}``,
    projected once from the encoder output, at model precision whatever
    :data:`CACHE_QUANT` says (the reference's ``encode_cross_kv``)."""
    k = _split_heads(linear_apply(p["k"], enc_out), cfg.n_kv_heads)
    v = _split_heads(linear_apply(p["v"], enc_out), cfg.n_kv_heads)
    return {"k": k, "v": v}


def cross_attn_decode(p, x: Tensor, cross_kv: Dict[str, Tensor], cfg
                      ) -> Tensor:
    """A decoder token's cross-attention against the static encoder K/V
    ``cross_kv`` (:func:`encode_cross_kv`'s): every frame visible, no
    RoPE; nothing is written."""
    q = _split_heads(linear_apply(p["q"], x), cfg.n_heads)
    return linear_apply(p["o"], _attend_all(q, cross_kv["k"],
                                            cross_kv["v"], cfg))


def _attend_all(q: Tensor, k: Tensor, v: Tensor, cfg) -> Tensor:
    """``q`` ``(B, S, H, hd)`` over every position of ``k``/``v`` ``(B,
    S_kv, Hkv, hd)``, nothing masked.  Returns ``(B, S, H * hd)``."""
    b, s = q.shape[:2]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = _sdpa(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), None)
    return out.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim)


def _cross_block(ck: Tensor, cv: Tensor, page_table: Tensor, cfg,
                 enc_len: int) -> Tuple[Tensor, Tensor]:
    """Each row's cross block gathered through its ``(B, C)`` table from
    the pools ``ck``, ``cv`` ``(pages + sink, page_size, Hkv, hd)``, its
    pages laid end to end and cut back to ``enc_len`` frames: ``(B,
    enc_len, Hkv, hd)`` each."""
    b = page_table.shape[0]
    hd = cfg.resolved_head_dim
    table = page_table.long()
    kd = ck[table].reshape(b, -1, cfg.n_kv_heads, hd)[:, :enc_len]
    vd = cv[table].reshape(b, -1, cfg.n_kv_heads, hd)[:, :enc_len]
    return kd, vd


def paged_cross_attn_decode(p, x: Tensor, cache: Dict[str, Tensor],
                            page_table: Tensor, cfg, *, enc_len: int
                            ) -> Tensor:
    """A decoder token's cross-attention against the encoder K/V in the
    cross page pool (the reference's ``paged_cross_attn_decode``).

    ``cache`` is this layer's slice of the cross pool ``{"ck": (n_cpages
    + sink, page_size, Hkv, hd), "cv": ...}`` (model precision, written
    once at admission, never by decode) and ``page_table`` the per-row
    ``(B, C)`` cross table.  Each row gathers its ``C`` pages, laid end
    to end, and the gathered K/V are cut back to ``enc_len`` frames
    before the softmax: cross attention masks nothing, so the zero cells
    that pad the last page must not reach it.  On the same cells this is
    :func:`cross_attn_decode` on the dense stacks."""
    q = _split_heads(linear_apply(p["q"], x), cfg.n_heads)
    kd, vd = _cross_block(cache["ck"], cache["cv"], page_table, cfg, enc_len)
    return linear_apply(p["o"], _attend_all(q, kd, vd, cfg))


# int8 dense KV caches (per-position, per-head symmetric scales), the
# reference's CACHE_QUANT flag.  Paged engines quantize at the pool
# boundary instead (kv_quant="int8") and refuse the flag.
CACHE_QUANT = {"enabled": False}


def set_kv_cache_quant(enabled: bool) -> None:
    CACHE_QUANT["enabled"] = enabled


# The reference's _quant_kv: the numerics of quantize_page_pool.
_quant_kv = quantize_page_pool


def _dequant_kv(q: Tensor, scale: Tensor, dtype) -> Tensor:
    return (q.float() * scale.float()).to(dtype)


def cache_capacity(kind: str, seq_len: int, window: int) -> int:
    return min(seq_len, window) if kind == "local" else seq_len


def init_cache(batch: int, cap: int, n_kv_heads: int, head_dim: int,
               dtype, device) -> Dict[str, Tensor]:
    """A zero dense cache ``{"k","v": (batch, cap, Hkv, hd)}``; int8
    values and bf16 ``"k_s","v_s": (batch, cap, Hkv, 1)`` scale planes
    while :data:`CACHE_QUANT` is on."""
    shape = (batch, cap, n_kv_heads, head_dim)
    if CACHE_QUANT["enabled"]:
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(sshape, dtype=torch.bfloat16,
                                   device=device),
                "v_s": torch.zeros(sshape, dtype=torch.bfloat16,
                                   device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_into_cache(k: Tensor, v: Tensor, cap: int,
                       last_index=None) -> Dict[str, Tensor]:
    """Lay a prompt's post-RoPE K/V ``(B, S, Hkv, hd)`` into a ring
    cache of capacity ``cap``, quantized after the layout while
    :data:`CACHE_QUANT` is on, as the reference's ``prefill_into_cache``
    lays it:

    * ``S <= cap``: positions 0..S-1 in cells 0..S-1, a zero tail;
    * ``S > cap`` with ``last_index`` (an int, a 0-dim tensor or a
      ``(B,)`` vector: each row's real last token under right-padded
      prefill): per row, cell ``j`` takes position ``last - ((last - j)
      mod cap)``, the one position in ``(last - cap, last]`` that is
      ``j`` mod ``cap``, zeroed where it is negative (a row shorter
      than ``cap``, whose decode mask never reads those cells);
    * ``S > cap`` without it: the last ``cap`` positions, rolled so
      position ``t`` sits in cell ``t mod cap``.
    """
    b, s = k.shape[:2]
    if s <= cap:
        pad = cap - s
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    elif last_index is not None:
        last = torch.as_tensor(last_index, device=k.device).long()
        last = last.reshape(-1, 1).expand(b, 1)                 # (B, 1)
        j = torch.arange(cap, device=k.device)[None, :]
        src = last - torch.remainder(last - j, cap)             # (B, cap)
        valid = (src >= 0)[:, :, None, None]
        idx = src.clamp(0, s - 1)[:, :, None, None].expand(
            -1, -1, *k.shape[2:])
        k = torch.gather(k, 1, idx).masked_fill(~valid, 0)
        v = torch.gather(v, 1, idx).masked_fill(~valid, 0)
    else:
        k = torch.roll(k[:, -cap:], s % cap, dims=1)
        v = torch.roll(v[:, -cap:], s % cap, dims=1)
    if CACHE_QUANT["enabled"]:
        (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
        return {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
    return {"k": k, "v": v}


def attn_decode_step(p, x: Tensor, cache: Dict[str, Tensor], pos, cfg
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token step against a dense cache ``{"k","v": (B, cap, Hkv,
    hd)}`` (int8 caches add their ``"k_s","v_s"`` scale planes).  ``pos``
    is a scalar (the whole batch at one position: the sequential engine)
    or a ``(B,)`` vector (per-row positions: the slot engine).

    Each row writes its new K/V (quantized, with its scales, into int8
    caches) at ring cell ``pos % cap`` and attends the cells whose ring
    position ``pos - ((pos - j) mod cap)`` is >= 0, as the reference
    does: under a scalar ``pos`` a short row also attends the zero cells
    between its own length and ``pos``.  The cache is written in place
    (the reference's update is functional), so a caller's view of a
    larger buffer receives the writes.
    """
    b = x.shape[0]
    cap = cache["k"].shape[1]
    pos = torch.as_tensor(pos, device=x.device).long()
    per_row = pos.dim() == 1
    positions = pos[:, None] if per_row else pos.reshape(1, 1)
    q = _split_heads(linear_apply(p["q"], x), cfg.n_heads)
    k = _split_heads(linear_apply(p["k"], x), cfg.n_kv_heads)
    v = _split_heads(linear_apply(p["v"], x), cfg.n_kv_heads)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    slot = pos % cap
    if per_row:
        rows = torch.arange(b, device=x.device)

        def upd(name, new):
            cache[name][rows, slot] = new[:, 0]
    else:
        def upd(name, new):
            cache[name].index_copy_(1, slot.reshape(1), new)

    if "k_s" in cache:
        (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
        for name, new in (("k", kq), ("v", vq), ("k_s", ks), ("v_s", vs)):
            upd(name, new)
    else:
        upd("k", k)
        upd("v", v)
    return linear_apply(p["o"], _attend_cache(q, cache, pos, cfg,
                                              x.dtype)), cache


def _attend_cache(q: Tensor, cache: Dict[str, Tensor], pos: Tensor, cfg,
                  dtype) -> Tensor:
    """``q`` ``(B, 1, H, hd)`` over a dense cache that already holds the
    step's K/V: int8 caches dequantized to ``dtype``, and the cells whose
    ring position ``pos - ((pos - j) mod cap)`` is negative masked,
    ``pos`` a scalar or ``(B,)``.  Returns ``(B, 1, H * hd)``."""
    cap = cache["k"].shape[1]
    if "k_s" in cache:
        kd = _dequant_kv(cache["k"], cache["k_s"], dtype)
        vd = _dequant_kv(cache["v"], cache["v_s"], dtype)
    else:
        kd, vd = cache["k"], cache["v"]
    j = torch.arange(cap, device=q.device)
    if pos.dim() == 1:
        logical = pos[:, None] - torch.remainder(pos[:, None] - j[None, :],
                                                 cap)
        mask = (logical >= 0)[:, None, None, :]     # (B,1,1,cap)
    else:
        logical = pos - torch.remainder(pos - j, cap)
        mask = (logical >= 0)[None, None, None, :]  # (1,1,1,cap)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = _sdpa(q, _repeat_kv(kd, n_rep), _repeat_kv(vd, n_rep), mask)
    return out.reshape(q.shape[0], 1, cfg.n_heads * cfg.resolved_head_dim)


def _paged_cell(page_table: Tensor, pos: Tensor, psz: int):
    """Each row's write cell: its physical page and the offset in it.  A
    row frozen past its last page (admitted at max_seq - 1, then
    stepped) writes where the reference's clamped gather puts it: its
    last mapped column.  Its output is discarded."""
    pos_l = pos.long()
    col = torch.clamp(pos_l // psz, max=page_table.shape[1] - 1)
    rows = torch.arange(page_table.shape[0], device=page_table.device)
    return page_table[rows, col].long(), pos_l % psz


def _paged_write(p, x: Tensor, cache: Dict[str, Tensor], page_table: Tensor,
                 pos: Tensor, cfg) -> Tensor:
    """Project and RoPE one token's q/k/v, write its K/V (quantized, with
    its scales, into int8 pools) at its cell in place, and return q
    ``(B, 1, H, hd)``."""
    q = _split_heads(linear_apply(p["q"], x), cfg.n_heads)
    k = _split_heads(linear_apply(p["k"], x), cfg.n_kv_heads)
    v = _split_heads(linear_apply(p["v"], x), cfg.n_kv_heads)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    phys, off = _paged_cell(page_table, pos, cache["pk"].shape[1])
    # The pool is written in place (the reference's .at[].set is
    # functional): the new K/V lands before K2 launches on the same
    # stream, so the kernel sees it, as the reference's does.
    if "pk_s" in cache:
        (k, ks), (v, vs) = _quant_kv(k), _quant_kv(v)
        cache["pk_s"][phys, off] = ks[:, 0]
        cache["pv_s"][phys, off] = vs[:, 0]
    cache["pk"][phys, off] = k[:, 0]
    cache["pv"][phys, off] = v[:, 0]
    return q


def paged_attn_decode_step(p, x: Tensor, cache: Dict[str, Tensor],
                           page_table: Tensor, pos: Tensor, cfg
                           ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token step against this layer's slice of the page pool.

    ``cache`` is ``{"pk": (n_pages + sink, page_size, Hkv, hd), "pv":
    ...}``, plus the bf16 scale planes ``"pk_s"``/``"pv_s"`` ``(n_pages
    + sink, page_size, Hkv, 1)`` when the pools are int8;
    ``page_table`` is the per-row ``(B, max_pages)`` int32 indirection
    and ``pos`` the per-row ``(B,)`` write position.  Row ``i`` writes
    its new K/V (quantized, with its scales, into int8 pools) at
    physical cell ``(table[i, pos_i // P], pos_i % P)`` and then attends
    its pages through K2.
    """
    b = x.shape[0]
    q = _paged_write(p, x, cache, page_table, pos, cfg)
    scales = (cache["pk_s"], cache["pv_s"]) if "pk_s" in cache else ()
    out = paged_attention(q[:, 0], cache["pk"], cache["pv"], page_table, pos,
                          *scales)
    out = out.reshape(b, 1, cfg.n_heads * cfg.resolved_head_dim)
    return linear_apply(p["o"], out), cache


def paged_local_attn_decode_step(p, x: Tensor, cache: Dict[str, Tensor],
                                 page_table: Tensor, pos: Tensor, cfg, *,
                                 window_cap: int
                                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token sliding-window step against a ring of pages.

    ``cache`` is this layer's slice of the local pool ``{"lk": (n_lpages
    + sink, page_size, Hkv, hd), "lv": ...}`` (model precision, never
    int8), ``page_table`` the per-row ring table ``(B, R)`` int32 (the
    page of sequence block ``b`` is ``page_table[i, b % R]``) and ``pos``
    the per-row ``(B,)`` write position.  ``window_cap`` is the dense
    ring's capacity ``min(sliding_window, max_seq)``.

    Row ``i`` writes its new K/V in place at cell ``(table[i, (pos_i //
    P) % R], pos_i % P)``, then gathers the logical ring of
    ``window_cap`` cells through the table: cell ``j`` holds position
    ``pos_i - ((pos_i - j) mod window_cap)``, masked where that is
    negative, the cell order and mask of :func:`attn_decode_step`, so
    :func:`_sdpa` sees the dense ring's operands.  The engine sizes ``R``
    so that a page it recycles is behind every read.
    """
    q = _split_heads(linear_apply(p["q"], x), cfg.n_heads)
    k = _split_heads(linear_apply(p["k"], x), cfg.n_kv_heads)
    v = _split_heads(linear_apply(p["v"], x), cfg.n_kv_heads)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    phys, off = _ring_cell(page_table, pos, cache["lk"].shape[1])
    cache["lk"][phys, off] = k[:, 0]
    cache["lv"][phys, off] = v[:, 0]
    out = _ring_attend(q, cache["lk"], cache["lv"], page_table, pos, cfg,
                       window_cap)
    return linear_apply(p["o"], out), cache


def _ring_cell(page_table: Tensor, pos: Tensor, psz: int):
    """Each row's write cell in its ring of pages: the page of column
    ``(pos // P) % R`` and the offset ``pos % P``."""
    pos_l = pos.long()
    rows = torch.arange(page_table.shape[0], device=page_table.device)
    col = (pos_l // psz) % page_table.shape[1]
    return page_table.long()[rows, col], pos_l % psz


def _ring_attend(q: Tensor, lk: Tensor, lv: Tensor, page_table: Tensor,
                 pos: Tensor, cfg, window_cap: int) -> Tensor:
    """``q`` ``(B, 1, H, hd)`` over the logical ring of ``window_cap``
    cells gathered through the ring table from the local pools ``lk``,
    ``lv`` (which already hold the step's K/V): cell ``j`` holds position
    ``pos - ((pos - j) mod window_cap)``, masked where that is negative.
    Returns ``(B, 1, H * hd)``."""
    b = q.shape[0]
    psz = lk.shape[1]
    ring = page_table.shape[1]
    pos_l = pos.long()
    rows = torch.arange(b, device=q.device)
    table = page_table.long()
    j = torch.arange(window_cap, device=q.device)
    logical = pos_l[:, None] - torch.remainder(pos_l[:, None] - j[None, :],
                                               window_cap)     # (B, w)
    pc = logical.clamp(min=0)
    pages = table[rows[:, None], (pc // psz) % ring]
    kd = lk[pages, pc % psz]                                   # (B, w, Hkv, hd)
    vd = lv[pages, pc % psz]
    mask = (logical >= 0)[:, None, None, :]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = _sdpa(q, _repeat_kv(kd, n_rep), _repeat_kv(vd, n_rep), mask)
    return out.reshape(b, 1, cfg.n_heads * cfg.resolved_head_dim)


# --------------------------------------------------------------------------
# On a mesh (repro_torch.models.common.TensorParallel)
# --------------------------------------------------------------------------
def _qkv_whole(ps, x: Tensor, cfg, positions: Optional[Tensor],
               kv_x: Optional[Tensor] = None):
    """Whole-head q/k/v on rank 0's device: each projection
    column-parallel and gathered where the specs split it (q/o split on
    ``n_heads``, k/v on ``n_kv_heads``, separately), else one call on
    the whole weight.  k/v are projected from ``kv_x`` where it is given
    (cross attention); RoPE is applied at ``positions`` unless they are
    None."""
    src = x if kv_x is None else kv_x
    q = _q_whole(ps, x, cfg)
    k, v = (_split_heads(linear_out([p[n] for p in ps], src,
                                    cfg.n_kv_heads * cfg.resolved_head_dim),
                         cfg.n_kv_heads) for n in "kv")
    if positions is None:
        return q, k, v
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _q_whole(ps, x: Tensor, cfg) -> Tensor:
    """Whole-head q, before RoPE (:func:`_qkv_whole`'s projection)."""
    return _split_heads(linear_out([p["q"] for p in ps], x,
                                   cfg.n_heads * cfg.resolved_head_dim),
                        cfg.n_heads)


def _o_whole(ps, out: Tensor, cfg) -> Tensor:
    return linear_in([p["o"] for p in ps], out,
                     cfg.n_heads * cfg.resolved_head_dim)


def _write_parts(parts, rows: Tensor, cell: Tensor, new: Tensor,
                 full: int) -> None:
    """Write ``new[i]`` at ``[rows[i], cell[i]]`` of a tensor whose dim 1
    (``full`` wide) the ranks' ``parts`` hold in rank order, each whole
    where it is replicated.  A rank writes the rows whose cell it holds
    and writes back what it read elsewhere, so nothing waits on the host
    for a mask."""
    for r, buf in enumerate(parts):
        n = buf.shape[1]
        local = cell.to(buf.device) - (r * n if n != full else 0)
        inside = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)
        rr = rows.to(buf.device)
        cur = buf[rr, idx]
        mask = inside.reshape((-1,) + (1,) * (cur.dim() - 1))
        buf[rr, idx] = torch.where(mask, new.to(buf.device, buf.dtype), cur)


def attn_apply_tp(ps, x: Tensor, cfg, tp, need_kv: bool = True, *,
                  kind: str = "attn", kv_x: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """:func:`attn_apply` on a mesh, every ``kind`` (causal global or
    sliding-window, an encoder's bidirectional, a decoder's cross
    attention on ``kv_x``): the output and the whole K/V on rank 0's
    device (the storage lays them out by its own specs; cross K/V are
    the cache's ``"xk","xv"``).  With ``tp.head_ok`` each rank runs
    :func:`attn_apply` on its heads and the ``o`` partials are reduced;
    otherwise attention runs once, on the whole heads.  Training passes
    ``need_kv=False``: the heads' K/V are not gathered and None comes
    back for them."""
    _check_kind(kind, kv_x)
    if tp.head_ok:
        outs = [attn_apply(p, x.to(d), tp.cfg_local, kind=kind,
                           kv_x=None if kv_x is None else kv_x.to(d))
                for p, d in zip(ps, tp.devices)]
        mix = reduce_rows([o[0] for o in outs], ps[0]["o"])
        if not need_kv:
            return mix, None, None
        return (mix, all_gather([o[1] for o in outs], 2)[0],
                all_gather([o[2] for o in outs], 2)[0])
    b, s, _ = x.shape
    positions = (None if kind == "cross"
                 else torch.arange(s, device=x.device)[None])
    q, k, v = _qkv_whole(ps, x, cfg, positions, kv_x)
    mask = None
    if kind in ("attn", "local"):
        mask = _causal_mask(s, s, cfg.sliding_window if kind == "local"
                            else None, x.device)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = _sdpa(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), mask)
    return _o_whole(ps, out.reshape(b, s, -1), cfg), k, v


def cross_attn_decode_tp(ps, x: Tensor, cross_kv: Dict[str, Sharded], cfg,
                         tp) -> Tensor:
    """:func:`cross_attn_decode` on a mesh, against a layer's dense cross
    K/V ``{"k","v"}`` laid out by ``cache_specs`` (its ``"xk","xv"``
    rows): with ``tp.head_ok`` each rank attends its heads' K/V and the
    ``o`` partials are reduced; otherwise the K/V, split on the sequence
    (or whole), are gathered once and attention runs once on the whole
    heads.  Nothing is written."""
    if tp.head_ok:
        return reduce_rows([cross_attn_decode(
            p, x.to(d), {n: c.shards[r] for n, c in cross_kv.items()},
            tp.cfg_local) for r, (p, d) in enumerate(zip(ps, tp.devices))],
            ps[0]["o"])
    out = _attend_all(_q_whole(ps, x, cfg), cross_kv["k"].gather(),
                      cross_kv["v"].gather(), cfg)
    return _o_whole(ps, out, cfg)


def paged_cross_attn_decode_tp(ps, x: Tensor, cache: Dict[str, Sharded],
                               page_table: Tensor, cfg, tp, *,
                               enc_len: int) -> Tensor:
    """:func:`paged_cross_attn_decode` on a mesh, against a layer's cross
    pools ``"ck","cv"`` laid out by ``cache_specs`` (the cross table
    whole): with ``tp.head_ok`` each rank reads its heads' pools through
    the table and the ``o`` partials are reduced; otherwise the pools,
    split on the page interior (or whole), are gathered once and
    attention reads the blocks through them once.  Nothing is written;
    the blocks are cut to ``enc_len`` frames either way."""
    if tp.head_ok:
        return reduce_rows([paged_cross_attn_decode(
            p, x.to(d), {n: c.shards[r] for n, c in cache.items()},
            page_table.to(d), tp.cfg_local, enc_len=enc_len)
            for r, (p, d) in enumerate(zip(ps, tp.devices))], ps[0]["o"])
    kd, vd = _cross_block(cache["ck"].gather(), cache["cv"].gather(),
                          page_table, cfg, enc_len)
    return _o_whole(ps, _attend_all(_q_whole(ps, x, cfg), kd, vd, cfg), cfg)


def attn_decode_step_tp(ps, x: Tensor, cache: Dict[str, Sharded], pos,
                        cfg, tp) -> Tensor:
    """:func:`attn_decode_step` on a mesh, against a dense cache (a
    global layer's, or a local layer's ring) laid out by
    ``cache_specs``: with ``tp.head_ok`` each rank steps its heads'
    cache and the ``o`` partials are reduced; otherwise the cache is
    split on its sequence axis, each rank writes the cells it holds (the
    ring cell ``pos % cap`` may be any rank's) and attention reads the
    gathered cache once."""
    if tp.head_ok:
        parts = []
        for r, (p, d) in enumerate(zip(ps, tp.devices)):
            local = {n: c.shards[r] for n, c in cache.items()}
            parts.append(attn_decode_step(p, x.to(d), local, pos.to(d),
                                          tp.cfg_local)[0])
        return reduce_rows(parts, ps[0]["o"])
    b = x.shape[0]
    cap = cache["k"].shape[1]
    pos = torch.as_tensor(pos, device=x.device).long().expand(b)
    q, k, v = _qkv_whole(ps, x, cfg, pos[:, None])
    new = {"k": k, "v": v}
    if "k_s" in cache:
        (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
        new = {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
    rows = torch.arange(b, device=x.device)
    for name, t in new.items():
        _write_parts(cache[name].shards, rows, pos % cap, t[:, 0], cap)
    whole = {n: c.gather() for n, c in cache.items()}
    return _o_whole(ps, _attend_cache(q, whole, pos, cfg, x.dtype), cfg)


def paged_attn_decode_step_tp(ps, x: Tensor, cache: Dict[str, Sharded],
                              page_table: Tensor, pos: Tensor, cfg, tp
                              ) -> Tensor:
    """:func:`paged_attn_decode_step` on a mesh, against pools laid out
    by ``cache_specs``, through :func:`~repro_torch.kernels.paged_attn.
    paged_attention_sharded`: with ``tp.head_ok`` each rank writes its
    heads' K/V and K2 runs once a rank on them; otherwise the pools are
    split on the page interior, each rank writes the offsets it holds,
    and one K2 call reads the gathered pools."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    if tp.head_ok:
        qs = []
        for r, (p, d) in enumerate(zip(ps, tp.devices)):
            local = {n: c.shards[r] for n, c in cache.items()}
            qs.append(_paged_write(p, x.to(d), local, page_table.to(d),
                                   pos.to(d), tp.cfg_local)[:, 0])
        q = Sharded(qs, P(None, "model"), (b, cfg.n_heads, hd), tp.mesh)
    else:
        q, k, v = _qkv_whole(ps, x, cfg, pos[:, None])
        new = {"pk": k, "pv": v}
        if "pk_s" in cache:
            (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
            new = {"pk": kq, "pv": vq, "pk_s": ks, "pv_s": vs}
        psz = cache["pk"].shape[1]
        phys, off = _paged_cell(page_table, pos, psz)
        for name, t in new.items():
            _write_parts(cache[name].shards, phys, off, t[:, 0], psz)
        q = Sharded([q[:, 0].to(d) for d in tp.devices], P(),
                    (b, cfg.n_heads, hd), tp.mesh)
    out = paged_attention_sharded(q, cache["pk"], cache["pv"], page_table,
                                  pos, mesh=tp.mesh,
                                  pk_scale=cache.get("pk_s"),
                                  pv_scale=cache.get("pv_s"))
    if tp.head_ok:
        return reduce_rows([linear_apply(p["o"], o.reshape(b, 1, -1))
                            for p, o in zip(ps, out.shards)], ps[0]["o"])
    return _o_whole(ps, out.shards[0].reshape(b, 1, -1), cfg)


def paged_local_attn_decode_step_tp(ps, x: Tensor,
                                    cache: Dict[str, Sharded],
                                    page_table: Tensor, pos: Tensor, cfg,
                                    tp, *, window_cap: int) -> Tensor:
    """:func:`paged_local_attn_decode_step` on a mesh, against the ring
    pools ``"lk","lv"`` laid out by ``cache_specs`` (the page axis never
    split; the ring table whole): with ``tp.head_ok`` each rank steps
    its heads' pools and the ``o`` partials are reduced; otherwise the
    pools are split on the page interior, each rank writes the offsets
    it holds, and attention reads the window through the gathered
    pools once."""
    if tp.head_ok:
        parts = []
        for r, (p, d) in enumerate(zip(ps, tp.devices)):
            local = {n: c.shards[r] for n, c in cache.items()}
            parts.append(paged_local_attn_decode_step(
                p, x.to(d), local, page_table.to(d), pos.to(d),
                tp.cfg_local, window_cap=window_cap)[0])
        return reduce_rows(parts, ps[0]["o"])
    q, k, v = _qkv_whole(ps, x, cfg, pos[:, None])
    psz = cache["lk"].shape[1]
    phys, off = _ring_cell(page_table, pos, psz)
    for name, t in (("lk", k), ("lv", v)):
        _write_parts(cache[name].shards, phys, off, t[:, 0], psz)
    out = _ring_attend(q, cache["lk"].gather(), cache["lv"].gather(),
                       page_table, pos, cfg, window_cap)
    return _o_whole(ps, out, cfg)
