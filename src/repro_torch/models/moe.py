"""Mixture-of-Experts FFN on one device (the single-device part of
``repro/models/moe.py``).

Token-choice top-k routing with a per-expert capacity (Switch-style
position-in-expert cumsum), as in the reference's ``_moe_local`` with
all experts local.  The expert FFNs always take the reference's *flat*
dispatch (``moe.py:114-134``): routed pairs are scattered into one
``(M_flat, d)`` buffer at block-aligned cumulative expert offsets and
each projection is one launch of K4
(:func:`~repro_torch.kernels.grouped_gemm.segment_grouped_gemm`).  The
reference's default, the dense capacity einsum, equals it in float32
and differs only at bf16 rounding points (ROADMAP.md, section C).

``M_flat = E * ceil(cap / bm) * bm`` depends only on the static token
count, and the offsets and tile table stay on the device, so the layer
makes no device-to-host copy.

Rounding points sit where the reference's do: router logits and softmax
in f32, K4's output in x's dtype then f32, ``act(g) * h`` in f32 cast to
x's dtype before ``down``, the top-k weights cast to x's dtype before
they multiply, and the top-k sum in x's dtype.  Expert parallelism over
a mesh is the distributed slice (``mesh`` raises).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.grouped_gemm import (flat_block_rows,
                                              flat_group_offsets,
                                              segment_grouped_gemm)
from repro_torch.models.common import _normal, activation

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, cfg, dtype):
    """Router (d, E) in float32 whatever ``dtype`` is, and stacked expert
    weights ``up``/``gate`` (E, d, d_ff) and ``down`` (E, d_ff, d), drawn
    one expert at a time from ``gen``."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts

    def stack(rows, cols):
        out = torch.empty((e, rows, cols), dtype=dtype, device=gen.device)
        for i in range(e):
            out[i] = _normal(gen, (rows, cols), 1.0 / math.sqrt(rows), dtype)
        return out

    p = {"router": _normal(gen, (d, e), 1.0 / math.sqrt(d), torch.float32),
         "up": stack(d, ff), "down": stack(ff, d)}
    if cfg.gated_mlp:
        p["gate"] = stack(d, ff)
    return p


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              factor: float) -> int:
    cap = math.ceil(top_k * n_tokens / n_experts * factor)
    return max(8, ((cap + 7) // 8) * 8)


def _dynamic_capacity(n_real: Tensor, n_static: int, cfg) -> Tensor:
    """Capacity for a real-token count that lives on the device: the
    exact :func:`_capacity` table over every possible count, gathered."""
    m = cfg.moe
    table = torch.tensor([_capacity(i, m.n_experts, m.top_k,
                                    m.capacity_factor)
                          for i in range(n_static + 1)],
                         dtype=torch.int32, device=n_real.device)
    return table[n_real.clamp(0, n_static)]


def _grouped(x: Tensor, w: Tensor, segments) -> Tensor:
    """One expert projection through K4, read back in float32."""
    starts, sizes, gids, bm, m_hint = segments
    return segment_grouped_gemm(x, w.to(x.dtype), starts, sizes, gids,
                                block_rows=bm, m_hint=m_hint).float()


def _expert_ffn(buf: Tensor, p, act: str, segments) -> Tensor:
    """Flat ``(M, d) -> (M, d)`` expert FFN over ``segments``."""
    h = _grouped(buf, p["up"], segments)
    if "gate" in p:
        h = activation(act)(_grouped(buf, p["gate"], segments)) * h
    else:
        h = activation(act)(h)
    return _grouped(h.to(buf.dtype), p["down"], segments).to(buf.dtype)


def _moe_local(x: Tensor, p, cfg, act: str,
               valid: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (y, aux).  ``valid`` (B, S) bool marks real tokens
    of a bucketed prefill: pads claim no capacity and shift no position,
    and the keep threshold is the capacity of the real count alone."""
    b, s, d = x.shape
    n = b * s
    moe_cfg = cfg.moe
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    cap = _capacity(n, e, k, moe_cfg.capacity_factor)
    xt = x.reshape(n, d)
    dev = x.device

    gates = xt.float() @ p["router"]
    probs = torch.softmax(gates, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / topw.sum(dim=-1, keepdim=True)

    flat_e = topi.reshape(-1)
    flat_w = topw.reshape(-1)
    tok_of = torch.arange(n * k, device=dev) // k
    onehot = F.one_hot(flat_e, e).to(torch.int32)
    if valid is not None:
        pair_valid = valid.reshape(-1)[tok_of]
        onehot = onehot * pair_valid[:, None].to(torch.int32)
        limit = _dynamic_capacity(valid.to(torch.int32).sum(), n, cfg)
    else:
        limit = cap
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = pos < limit
    if valid is not None:
        keep = keep & pair_valid
    lp = pos.clamp(0, cap - 1)
    counts = onehot.sum(dim=0)
    sizes = (counts.clamp(max=cap) if valid is None
             else torch.minimum(counts, limit)).to(torch.int32)
    vals = torch.where(keep[:, None], xt[tok_of], 0).to(x.dtype)

    ff = p["up"].shape[-1]
    m_hint = min(cap, 64)
    bm = flat_block_rows(m_hint, ff, d, x.dtype)
    offs = flat_group_offsets(sizes, bm)                     # (E + 1,)
    m_flat = e * (-(-cap // bm)) * bm                        # static
    dst = offs[flat_e] + lp
    flat = torch.zeros((m_flat, d), dtype=x.dtype, device=dev)
    # Each kept pair owns its row; dropped and pad pairs add exact zeros,
    # so the atomics of index_add_ on the card leave one order-free sum.
    flat.index_add_(0, dst, vals)
    segments = (offs[:-1], sizes, torch.arange(e, dtype=torch.int32,
                                               device=dev), bm, m_hint)
    out_flat = _expert_ffn(flat, p, act, segments)
    pair_out = out_flat[dst] * (keep * flat_w)[:, None].to(x.dtype)
    y = pair_out.reshape(n, k, d).sum(dim=1)
    # Aux: load-balancing loss ingredients (mean prob x mean assignment).
    density = F.one_hot(topi, e).float().mean(dim=(0, 1))
    aux = (probs.mean(dim=0) * density).sum() * e
    return y.reshape(b, s, d), aux


def moe_apply(p, x: Tensor, cfg, *, mesh=None,
              valid: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (y, aux_loss) with every expert on this device.
    ``valid`` (B, S) bool marks real tokens under bucketed prefill."""
    if mesh is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh is the distributed slice of "
            "the port (ROADMAP.md)")
    return _moe_local(x, p, cfg, cfg.act, valid=valid)


def set_expert_backend(impl: str) -> None:
    """The reference's expert-backend switch.  The port's experts always
    take K4 on the card and its plain version on the CPU, so this
    validates ``"kernel"`` and changes nothing."""
    if impl != "kernel":
        raise ValueError(f"expert backend {impl!r}: the port has only "
                         "'kernel'; the operands' device picks K4 or its "
                         "plain version")
