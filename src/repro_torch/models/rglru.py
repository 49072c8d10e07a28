"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
the port of ``repro/models/rglru.py``.

One recurrent block::

    x ─ linear ─ GeLU ───────────────┐
    x ─ linear ─ conv1d(4) ─ RG-LRU ─┴─ (*) ─ linear ─ out

RG-LRU per channel: ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t *
x_t)`` with ``a_t = exp(-c * softplus(Lambda) * r_t)`` and sigmoid
gates ``r``, ``i`` (diagonal, as in the reference).  The recurrence is
element-wise (no GEMM, and no Pallas kernel in the reference); the
three projections go through K1.  The gates, ``Lambda`` and the state
``h`` are float32 whatever the model dtype.

The reference scans with ``lax.associative_scan``; here the scan over
the sequence is a log-depth doubling (Hillis–Steele) scan in float32,
``ceil(log2 S)`` steps of a few element-wise ops each.  A cumulative
product of ``a`` would underflow, so each step composes the transitions
of two neighbouring segments instead.

Decode writes ``"h"`` and ``"conv"`` back into the caller's cache
tensors in place (the engines decode views of their slot buffers and
slabs and keep no returned cache).

On a mesh (``*_tp``) the block is channel-parallel over the model row
where ``d_model`` divides it (``sharding.rglru_split``): ``in_gate`` and
``in_rec`` are column parts, ``out`` is row-parallel and reduced, and
the per-channel weights and the recurrence are cut to a rank's
channels.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import all_gather
from repro_torch.distributed.mesh import Sharded
from repro_torch.models.common import (activation, last_rows, linear_apply,
                                       linear_init, reduce_rows, whole_linear)

Tensor = torch.Tensor

_C = 8.0      # Griffin's recurrence sharpness constant
_CONV_W = 4   # temporal conv width


def rglru_init(gen, cfg, dtype):
    """Random weights in the reference's tree; ``gate_r``, ``gate_i``
    and ``lam`` are float32."""
    d, dev = cfg.d_model, gen.device
    lam = torch.rand((d,), generator=gen, device=dev) * 0.5 + 0.3
    return {
        "in_gate": linear_init(gen, d, d, dtype, cfg.use_bias),
        "in_rec": linear_init(gen, d, d, dtype, cfg.use_bias),
        "conv_w": (torch.randn((_CONV_W, d), generator=gen, device=dev)
                   * 0.1).to(dtype),
        "gate_r": torch.zeros((d,), dtype=torch.float32, device=dev),
        "gate_i": torch.zeros((d,), dtype=torch.float32, device=dev),
        "lam": lam,
        "out": linear_init(gen, d, d, dtype, cfg.use_bias),
    }


def _gates(p, x32: Tensor) -> Tuple[Tensor, Tensor]:
    """``a_t`` and the input branch ``b_t = sqrt(1 - a^2) * i * x``."""
    r = torch.sigmoid(x32 * p["gate_r"])
    i = torch.sigmoid(x32 * p["gate_i"])
    a = torch.exp(-_C * F.softplus(p["lam"]) * r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x32)
    return a, b


def _conv1d(p, x: Tensor) -> Tensor:
    """Depthwise causal temporal conv, width 4: tap ``w`` multiplies
    ``x_{t-w}``, summed in ``x``'s dtype in the reference's order.
    x: (B, S, d)."""
    s = x.shape[1]
    out = x * p["conv_w"][0]
    for w in range(1, _CONV_W):
        shifted = F.pad(x[:, :max(s - w, 0)], (0, 0, min(w, s), 0))
        out = out + shifted * p["conv_w"][w]
    return out


def _scan(a: Tensor, b: Tensor) -> Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` along axis 1, by
    doubling: after the step of distance ``d`` each position holds the
    composed transition of the ``2d`` positions ending at it.  Position
    ``t`` reads only positions ``<= t``."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _block(p, x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The block over ``x`` (B, S, d): its output, ``in_rec``'s rows
    before the conv and the scan's float32 ``h``."""
    gate = activation("gelu")(linear_apply(p["in_gate"], x))
    u_raw = linear_apply(p["in_rec"], x)
    a, b = _gates(p, _conv1d(p, u_raw).float())
    h = _scan(a, b)
    return linear_apply(p["out"], gate * h.to(x.dtype)), u_raw, h


def rglru_prefill(p, x: Tensor, cfg, last_index=None
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The block's output over the prompt ``x`` (B, S, d) and its cache
    at each row's real last token (``last_index``; default the last
    position), from one projection, one conv and one scan.

    The reference projects ``in_rec`` twice, once for the output and
    once for the cache, and scans the cache a second time with the pad
    positions forced to the identity transition; this reads ``h`` at
    ``last_index`` from the output's scan, whose positions up to it see
    only real tokens.  The conv tail is ``in_rec``'s rows ``last-2 ..
    last``, zero where they fall before the prompt."""
    bsz, s, _ = x.shape
    out, u_raw, h = _block(p, x)
    if last_index is None:
        h_last = h[:, -1]
        conv = F.pad(u_raw, (0, 0, _CONV_W - 1, 0))[:, -(_CONV_W - 1):]
    else:
        last = last_rows(last_index, bsz, x.device)
        rows = torch.arange(bsz, device=x.device)
        h_last = h[rows, last.clamp(0, s - 1)]
        src = last[:, None] - (_CONV_W - 2) + torch.arange(
            _CONV_W - 1, device=x.device)[None, :]
        conv = u_raw[rows[:, None], src.clamp(0, s - 1)]
        conv = conv.masked_fill((src < 0)[:, :, None], 0)
    return out, {"h": h_last, "conv": conv}


def rglru_apply(p, x: Tensor, cfg) -> Tensor:
    """Full-sequence forward, the output alone (training: no cache).
    x: (B, S, d).  Autograd runs back through the doubling scan's
    ``cat`` and ``addcmul`` steps; nothing is written in place."""
    return _block(p, x)[0]


def rglru_init_cache(batch: int, d: int, dtype, device=None
                     ) -> Dict[str, Tensor]:
    return {"h": torch.zeros((batch, d), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, d), dtype=dtype,
                                device=device)}


def rglru_prefill_cache(p, x: Tensor, cfg, last_index=None
                        ) -> Dict[str, Tensor]:
    """The state after the prompt (the reference's function of that
    name): ``{"h": (B, d) f32, "conv": (B, 3, d)}`` at each row's real
    last token under right-padded prefill (:func:`rglru_prefill`)."""
    return rglru_prefill(p, x, cfg, last_index)[1]


def _step(p, x: Tensor, h: Tensor, conv: Tensor
          ) -> Tuple[Tensor, Tensor, Tensor]:
    """One token through the block from state ``h`` (B, d) and conv tail
    ``conv`` (B, 3, d), both only read: the output (B, 1, d), the new
    ``h`` and ``in_rec``'s new row (B, d), which enters the tail."""
    gate = activation("gelu")(linear_apply(p["in_gate"], x))
    u_t = linear_apply(p["in_rec"], x)[:, 0]                 # (B, d)
    hist = torch.cat([conv, u_t[:, None]], dim=1)            # a new tensor
    u_conv = hist[:, -1] * p["conv_w"][0]
    for w in range(1, _CONV_W):
        u_conv = u_conv + hist[:, -(w + 1)] * p["conv_w"][w]
    a, b = _gates(p, u_conv.float())
    h = a * h + b
    out = linear_apply(p["out"], gate[:, 0] * h.to(x.dtype))
    return out[:, None], h, u_t


def _shift_in(conv: Tensor, u_t: Tensor) -> None:
    """The conv tail ``conv`` (B, 3, d) advanced by the row ``u_t``, in
    place."""
    conv.copy_(torch.cat([conv[:, 1:], u_t[:, None]], dim=1))


def rglru_decode_step(p, x: Tensor, cache: Dict[str, Tensor], cfg
                      ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, 1, d) -> (out (B, 1, d), cache).  ``cache["h"]`` and
    ``cache["conv"]`` are updated in place."""
    out, h, u_t = _step(p, x, cache["h"], cache["conv"])
    cache["h"].copy_(h)
    _shift_in(cache["conv"], u_t)
    return out, cache


# --------------------------------------------------------------------------
# On a mesh (repro_torch.models.common.TensorParallel)
# --------------------------------------------------------------------------
_LINEARS = ("in_gate", "in_rec", "out")


def _rank_tree(p, cols: slice):
    """A rank's block where RG-LRU splits on its channels: ``in_gate``,
    ``in_rec`` (column parts) and ``out`` (row part) as placed, the
    per-channel ``conv_w``, ``gate_r``, ``gate_i`` and ``lam`` (whole on
    every rank) cut to its channels ``cols``."""
    return {**p, "conv_w": p["conv_w"][:, cols], "gate_r": p["gate_r"][cols],
            "gate_i": p["gate_i"][cols], "lam": p["lam"][cols]}


def _whole_tree(ps, cfg):
    d = cfg.d_model
    return {**ps[0], **{n: whole_linear([p[n] for p in ps], d, d)
                        for n in _LINEARS}}


def rglru_apply_tp(ps, x: Tensor, cfg, tp) -> Tensor:
    """:func:`rglru_apply` on a mesh: each rank the block on its channels
    (``tp.rglru_cols``) and ``out``'s partial sums reduced; where the
    channels do not split, the block runs whole, once."""
    if tp.rglru_cols is None:
        return rglru_apply(_whole_tree(ps, cfg), x, cfg)
    return reduce_rows([_block(_rank_tree(p, c), x.to(d))[0] for p, c, d in
                        zip(ps, tp.rglru_cols, tp.devices)], ps[0]["out"])


def rglru_prefill_tp(ps, x: Tensor, cfg, tp, last_index=None
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """:func:`rglru_prefill` on a mesh: the output and the whole cache on
    rank 0's device (each rank's channels of ``h`` and ``conv``
    gathered; the storage lays them out by its own specs)."""
    if tp.rglru_cols is None:
        return rglru_prefill(_whole_tree(ps, cfg), x, cfg, last_index)
    outs = [rglru_prefill(_rank_tree(p, c), x.to(d), cfg, last_index)
            for p, c, d in zip(ps, tp.rglru_cols, tp.devices)]
    return (reduce_rows([o[0] for o in outs], ps[0]["out"]),
            {n: all_gather([o[1][n] for o in outs], -1)[0]
             for n in ("h", "conv")})


def rglru_decode_step_tp(ps, x: Tensor, cache: Dict[str, Sharded], cfg,
                         tp) -> Tensor:
    """:func:`rglru_decode_step` on a mesh, on a cache laid out by
    ``cache_specs``: ``h`` split on its channels, ``conv`` (4-D)
    replicated whole on every rank.  Each rank steps its channels, reads
    its columns of its ``conv`` copy and writes its ``h`` part; the
    ranks' new ``in_rec`` columns are gathered, and every rank shifts
    the whole row into its copy, so the copies stay whole and equal.
    Where the channels do not split, the block runs whole, once, and
    every rank's copy takes its state."""
    if tp.rglru_cols is None:
        whole = {n: c.gather() for n, c in cache.items()}
        out = rglru_decode_step(_whole_tree(ps, cfg), x, whole, cfg)[0]
        for n, c in cache.items():
            c.copy_(whole[n])
        return out
    outs, rows = [], []
    for r, (p, cols, d) in enumerate(zip(ps, tp.rglru_cols, tp.devices)):
        h = cache["h"].shards[r]
        out, h_new, u_t = _step(_rank_tree(p, cols), x.to(d), h,
                                cache["conv"].shards[r][..., cols])
        h.copy_(h_new)
        outs.append(out)
        rows.append(u_t)
    for conv, u_t in zip(cache["conv"].shards, all_gather(rows, -1)):
        _shift_in(conv, u_t)
    return reduce_rows(outs, ps[0]["out"])
