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
they multiply, and the top-k sum in x's dtype.

On a mesh the experts split over the ``model`` axis (expert
parallelism, the reference's ``moe_apply`` with a mesh,
``moe.py:295-365``), in one of two ways (:func:`set_ep_impl`):
``"psum"`` gives every rank all tokens, each rank runs its own experts
and the ranks' outputs are summed; ``"all_to_all"`` splits the tokens on
the sequence, each rank routes its own with its own capacity, and two
all-to-alls carry the dispatch buffer to the experts' ranks and back
(:func:`_moe_a2a`, K4 on :func:`~repro_torch.kernels.grouped_gemm.
a2a_segments`).  A sequence the model axis does not divide takes
``"psum"``, and an expert count it does not divide the replicated path.
Either way ``aux`` is the mean of the ranks' (the reference's ``pmean``).

In training (:func:`moe_apply_replicas`) every data replica routes its
own rows with its own capacity where the experts split, as each data
shard of the reference's ``shard_map`` does; where they do not (a model
axis of 1, or one that does not divide the experts) the reference runs
``_moe_local`` on the whole global batch, and so does the port: the
replicas' rows are gathered over the data axis first.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (all_gather, all_reduce_sum,
                                                 all_to_all)
from repro_torch.kernels.grouped_gemm import (a2a_segments,
                                              aligned_block_rows,
                                              flat_block_rows,
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


def _route(x: Tensor, p, cfg, valid: Optional[Tensor]):
    """Top-k routing of ``x`` (B, S, d)'s tokens with capacity: the flat
    tokens, the router probabilities and top-k experts, per pair its
    expert, weight, position in its expert and keep flag, the per-expert
    routed counts, and the capacity and keep threshold (that of the
    real tokens where ``valid`` marks them)."""
    b, s, d = x.shape
    n = b * s
    moe_cfg = cfg.moe
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    cap = _capacity(n, e, k, moe_cfg.capacity_factor)
    xt = x.reshape(n, d)
    gates = xt.float() @ p["router"]
    probs = torch.softmax(gates, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    flat_e = topi.reshape(-1)
    tok_of = torch.arange(n * k, device=x.device) // k
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
    return dict(xt=xt, probs=probs, topi=topi, flat_e=flat_e,
                flat_w=topw.reshape(-1), tok_of=tok_of, pos=pos, keep=keep,
                counts=onehot.sum(dim=0), cap=cap, limit=limit)


def _aux(rt, e: int) -> Tensor:
    """Load-balancing loss ingredients (mean prob x mean assignment)."""
    density = F.one_hot(rt["topi"], e).float().mean(dim=(0, 1))
    return (rt["probs"].mean(dim=0) * density).sum() * e


def _moe_local(x: Tensor, p, cfg, act: str,
               valid: Optional[Tensor] = None, e_offset: int = 0,
               e_local: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (y, aux) over experts ``[e_offset, e_offset +
    e_local)`` (default all), whose weights ``p`` holds; pairs routed
    elsewhere add zeros.  ``valid`` (B, S) bool marks real tokens of a
    bucketed prefill: pads claim no capacity and shift no position, and
    the keep threshold is the capacity of the real count alone."""
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    e_local = e if e_local is None else e_local
    rt = _route(x, p, cfg, valid)
    cap, flat_e, keep = rt["cap"], rt["flat_e"], rt["keep"]
    dev = x.device
    is_local = keep & (flat_e >= e_offset) & (flat_e < e_offset + e_local)
    le = (flat_e - e_offset).clamp(0, e_local - 1)
    lp = rt["pos"].clamp(0, cap - 1)
    counts = rt["counts"][e_offset:e_offset + e_local]
    sizes = (counts.clamp(max=cap) if valid is None
             else torch.minimum(counts, rt["limit"])).to(torch.int32)
    vals = torch.where(is_local[:, None], rt["xt"][rt["tok_of"]],
                       0).to(x.dtype)

    ff = p["up"].shape[-1]
    m_hint = min(cap, 64)
    bm = flat_block_rows(m_hint, ff, d, x.dtype)
    offs = flat_group_offsets(sizes, bm)                     # (E_loc + 1,)
    m_flat = e_local * (-(-cap // bm)) * bm                  # static
    dst = offs[le] + lp
    flat = torch.zeros((m_flat, d), dtype=x.dtype, device=dev)
    # Each kept pair owns its row; dropped, pad and other ranks' pairs
    # add exact zeros, so the atomics of index_add_ on the card leave
    # one order-free sum.
    flat.index_add_(0, dst, vals)
    segments = (offs[:-1], sizes, torch.arange(e_local, dtype=torch.int32,
                                               device=dev), bm, m_hint)
    out_flat = _expert_ffn(flat, p, act, segments)
    pair_out = out_flat[dst] * (is_local * rt["flat_w"])[:, None].to(x.dtype)
    y = pair_out.reshape(b * s, k, d).sum(dim=1)
    return y.reshape(b, s, d), _aux(rt, e)


def _moe_a2a(xs: List[Tensor], ps, cfg, act: str,
             valid: Optional[List[Tensor]] = None
             ) -> Tuple[List[Tensor], Tensor]:
    """All-to-all EP over sequence-split tokens (the reference's
    ``_moe_a2a``): rank ``r`` routes its ``xs[r]`` (B, S / ms, d) with
    its own capacity into an ``(E, cap, d)`` buffer, the buffers are
    exchanged so each rank holds its experts' rows from every rank
    ``(E / ms, ms * cap, d)``, K4 runs them as the segments of
    :func:`a2a_segments`, and the outputs go back the same way.
    Returns each rank's output rows and the mean aux."""
    ms = len(xs)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    e_local = e // ms
    routes, bufs, sizes = [], [], []
    for r, (x, p) in enumerate(zip(xs, ps)):
        b, s, d = x.shape
        rt = _route(x, p, cfg, None if valid is None else valid[r])
        cap = rt["cap"]
        lp = rt["pos"].clamp(0, cap - 1)
        vals = torch.where(rt["keep"][:, None], rt["xt"][rt["tok_of"]],
                           0).to(x.dtype)
        buf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
        buf.index_add_(0, rt["flat_e"] * cap + lp, vals)
        routes.append((rt, lp))
        bufs.append(buf.reshape(e, cap, d))
        sizes.append(torch.minimum(rt["counts"], torch.as_tensor(
            rt["limit"], device=x.device)).to(torch.int32).reshape(ms,
                                                                   e_local))
    recv = all_to_all(bufs, 0, 1)            # (E / ms, ms * cap, d) a rank
    recv_sizes = all_to_all(sizes, 0, 0)     # (ms, E / ms): by source rank
    outs = []
    for buf, rs, p in zip(recv, recv_sizes, ps):
        cap = buf.shape[1] // ms
        d = buf.shape[2]
        m_hint = min(cap, 64)
        # Segment starts are cap-strided: the row block must divide cap.
        bm = aligned_block_rows(m_hint, p["up"].shape[-1], d, buf.dtype,
                                align_to=cap)
        starts, seg_sizes, gids = a2a_segments(e_local, ms, cap, rs)
        outs.append(_expert_ffn(buf.reshape(-1, d), p, act,
                                (starts, seg_sizes, gids, bm, m_hint)
                                ).reshape(buf.shape))
    back = all_to_all(outs, 1, 0)            # (E, cap, d) a rank
    ys, auxs = [], []
    for x, out, (rt, lp) in zip(xs, back, routes):
        b, s, d = x.shape
        pair_out = out[rt["flat_e"], lp] * (
            rt["keep"] * rt["flat_w"])[:, None].to(x.dtype)
        ys.append(pair_out.reshape(b * s, k, d).sum(dim=1).reshape(b, s, d))
        auxs.append(_aux(rt, e).to(xs[0].device))
    return ys, torch.stack(auxs).mean()


# "psum": tokens on every rank, each rank computes its experts for all of
#         them, outputs summed (the reference's default).
# "all_to_all": tokens split on the sequence, dispatch buffers exchanged
#         with two all-to-alls.
EP_IMPL = {"impl": "psum"}


def set_ep_impl(impl: str) -> None:
    if impl not in ("psum", "all_to_all"):
        raise ValueError(f"EP impl {impl!r} not in ('psum', 'all_to_all')")
    EP_IMPL["impl"] = impl


def moe_apply(p, x: Tensor, cfg, *, mesh=None,
              valid: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Without a mesh every expert is on
    this device.  With one, ``p`` is the list of the model row's
    per-rank MoE trees (experts split over ``model`` where it divides
    their count) and the experts run expert-parallel (module doc); ``x``
    and ``y`` are whole, on rank 0's device.  ``valid`` (B, S) bool
    marks real tokens under bucketed prefill."""
    if mesh is None:
        return _moe_local(x, p, cfg, cfg.act, valid=valid)
    ps = p
    e = cfg.moe.n_experts
    ms = len(ps)
    if ms == 1 or ps[0]["up"].shape[0] == e:
        return _moe_local(x, ps[0], cfg, cfg.act, valid=valid)
    e_local = e // ms
    s = x.shape[1]
    devs = [q["up"].device for q in ps]
    if EP_IMPL["impl"] == "all_to_all" and s % ms == 0 and s >= ms:
        xs = [c.to(dv) for c, dv in zip(torch.chunk(x, ms, dim=1), devs)]
        vs = (None if valid is None else
              [c.to(dv) for c, dv in zip(torch.chunk(valid, ms, dim=1),
                                         devs)])
        ys, aux = _moe_a2a(xs, ps, cfg, cfg.act, valid=vs)
        return all_gather(ys, 1)[0], aux
    outs = [_moe_local(x.to(dv), q, cfg, cfg.act,
                       valid=None if valid is None else valid.to(dv),
                       e_offset=r * e_local, e_local=e_local)
            for r, (q, dv) in enumerate(zip(ps, devs))]
    aux = all_reduce_sum([o[1] for o in outs])[0] / ms
    return all_reduce_sum([o[0] for o in outs])[0], aux


def moe_apply_replicas(rows: List[list], xs: List[Tensor], cfg, mesh
                       ) -> Tuple[List[Tensor], List[Tensor]]:
    """The MoE of every data replica of a training step: ``rows[r]`` is
    replica ``r``'s list of per-rank MoE trees, ``xs[r]`` its rows (on
    its rank 0's device).  Returns each replica's output and ``aux``.
    Where the experts split over ``model``, each replica runs
    :func:`moe_apply` on its own rows (its own capacity); otherwise each
    runs :func:`_moe_local` on the global batch, gathered over the data
    axis, and keeps its own rows (module doc)."""
    if len(rows[0]) > 1 and rows[0][0]["up"].shape[0] != cfg.moe.n_experts:
        outs = [moe_apply(ps, x, cfg, mesh=mesh) for ps, x in zip(rows, xs)]
        return [o[0] for o in outs], [o[1] for o in outs]
    b = xs[0].shape[0]
    ys, auxs = [], []
    for r, (whole, ps) in enumerate(zip(all_gather(xs, 0), rows)):
        y, aux = _moe_local(whole, ps[0], cfg, cfg.act)
        ys.append(y[r * b:(r + 1) * b])
        auxs.append(aux)
    return ys, auxs


def set_expert_backend(impl: str) -> None:
    """The reference's expert-backend switch.  The port's experts always
    take K4 on the card and its plain version on the CPU, so this
    validates ``"kernel"`` and changes nothing."""
    if impl != "kernel":
        raise ValueError(f"expert backend {impl!r}: the port has only "
                         "'kernel'; the operands' device picks K4 or its "
                         "plain version")
