"""RWKV6 "Finch" time-mix (arXiv:2404.05892), data-dependent decay WKV:
the port of ``repro/models/rwkv6.py``.

Per head (key dim dk, value dim dv), with per-channel decay ``w_t``::

    S_t   = diag(w_t) S_{t-1} + k_t^T v_t
    out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

Prefill uses the reference's chunkwise-parallel form: the intra-chunk
part is an attention-like ``(T_c x T_c)`` masked product, here one
batched einsum over every chunk at once; only the recursion over the
chunk states is a loop, one short step a chunk.  Decode is the O(1)
recurrence.  Every factor of the scan is float32, as in the reference:
``exp(-cumsum)`` reaches ``e^44.8``, past bfloat16's range.  The
recurrence has no GEMM for K1 and no Pallas kernel in the reference;
the r/k/v/w/o projections go through K1.

The token-shift mix ``x * mu + sx * (1 - mu)`` is float32 (``mu`` is)
and is rounded to the weights' dtype before its projection, because K1
takes one dtype; the reference projects the float32 mix against the
promoted weights.  The two agree exactly in float32.

On a mesh (``*_tp``) the time-mix is head-parallel over the model row
where its ``d_model / head_dim`` heads divide it (``sharding.
wkv_split``): each rank runs a function above on its heads (they read
their head count from ``u``), and ``o``'s partial sums are reduced.

Training calls :func:`rwkv_apply` with no ``last_index`` and no
state: autograd runs back through the chunk scan, its float32
``exp(-cs)`` and ``exp(cs - wc)`` factors included, and only a sequence
off CHUNK is masked (its pad).  Decode writes ``"state"`` and
``"shift"`` back into the caller's cache tensors in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import all_gather
from repro_torch.distributed.mesh import Sharded
from repro_torch.models.common import (last_rows, linear_apply, linear_init,
                                       reduce_rows, whole_linear)

Tensor = torch.Tensor

CHUNK = 32
_MAX_DECAY = 1.4      # |log w| bound: CHUNK x 1.4 = 44.8 < log(f32 max)


def _decay_log(decay_logit: Tensor) -> Tensor:
    """Bounded log-decay: wlog in [-(1e-4 + 1.4), -1e-4)."""
    return -(1e-4 + _MAX_DECAY * torch.sigmoid(decay_logit))


def rwkv_head_dims(cfg) -> Tuple[int, int]:
    hd = cfg.resolved_head_dim if cfg.n_heads else 64
    return cfg.d_model // hd, hd


def rwkv_init(gen, cfg, dtype):
    """Random weights in the reference's tree; ``mu`` (4, d) and ``u``
    (H, hd) are float32."""
    d, dev = cfg.d_model, gen.device
    h, hd = rwkv_head_dims(cfg)
    p = {"mu": torch.full((4, d), 0.5, dtype=torch.float32, device=dev)}
    for name in ("r", "k", "v", "w"):
        p[name] = linear_init(gen, d, h * hd, dtype, False)
    p["u"] = torch.randn((h, hd), generator=gen, device=dev) * 0.1
    p["o"] = linear_init(gen, h * hd, d, dtype, False)
    return p


def _shifted(x: Tensor, x_prev: Tensor) -> Tensor:
    """The x_{t-1} sequence (the first position takes x_prev)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _projections(p, x: Tensor, x_prev: Tensor, h: int, hd: int):
    b, s, _ = x.shape
    sx = _shifted(x, x_prev)
    mu = p["mu"]

    def proj(name: str, i: int) -> Tensor:
        w = p[name]["w"]
        mix = x.float() * mu[i] + sx.float() * (1.0 - mu[i])
        return linear_apply(p[name], mix.to(w.dtype)).reshape(b, s, h, hd)

    wlog = _decay_log(proj("w", 3).float())                 # log w_t < 0
    return proj("r", 0), proj("k", 1), proj("v", 2), wlog


def _chunk_scan(r, k, v, wlog, u, s0):
    """Chunkwise-parallel WKV.  r/k/v: (B, S, H, hd) with S % CHUNK ==
    0, wlog: f32 log-decay, s0: (B, H, hd, hd) f32 initial state.
    Returns the f32 output (B, S, H, hd) and the final state."""
    b, s, h, hd = r.shape
    nc = s // CHUNK
    rc, kc, vc = (t.float().reshape(b, nc, CHUNK, h, hd) for t in (r, k, v))
    wc = wlog.reshape(b, nc, CHUNK, h, hd)
    cs = torch.cumsum(wc, dim=2)                   # cs_i = sum_{l<=i}
    ri = rc * torch.exp(cs - wc)                   # r_i * exp(cs_{i-1})
    kj = kc * torch.exp(-cs)
    att = torch.einsum("bnihd,bnjhd->bnhij", ri, kj)          # j < i part
    ii = torch.arange(CHUNK, device=r.device)
    att = att.masked_fill(~(ii[:, None] > ii[None, :]), 0.0)
    diag = torch.einsum("bnihd,bnihd->bnhi", rc * u, kc)
    out = torch.einsum("bnhij,bnjhd->bnihd", att, vc)
    out = out + diag.transpose(2, 3)[..., None] * vc
    # The state entering each chunk: S_end = diag(e_T) S + sum_j
    # diag(e_T / e_j) k_j v_j^T, the sums of every chunk at once.
    e_total = torch.exp(cs[:, :, -1])                         # (B, nc, H, hd)
    kdec = kc * torch.exp(cs[:, :, -1:] - cs)
    inc = torch.einsum("bnjhk,bnjhd->bnhkd", kdec, vc)
    states = []
    state = s0
    for n in range(nc):
        states.append(state)
        state = state * e_total[:, n, ..., None] + inc[:, n]
    out = out + torch.einsum("bnihk,bnhkd->bnihd", ri,
                             torch.stack(states, dim=1))
    return out.reshape(b, s, h, hd), state


def rwkv_apply(p, x: Tensor, cfg, x_prev: Tensor = None,
               state0: Tensor = None, return_state: bool = False,
               last_index=None):
    """Full-sequence time-mix. x: (B, S, d).

    ``last_index`` (an int, a 0-dim tensor or a ``(B,)`` vector) marks
    each row's real last token under right-padded prefill: positions
    past it get ``k = 0`` and ``wlog = 0`` (no outer product, decay 1),
    as the CHUNK pad does, so the returned state is the state at the
    real last token and ``shift`` is read there."""
    b, s, d = x.shape
    h, hd = p["u"].shape
    if x_prev is None:
        x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    if state0 is None:
        state0 = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                             device=x.device)
    pad = (-s) % CHUNK
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    r, k, v, wlog = _projections(p, xp, x_prev, h, hd)
    t = torch.arange(s + pad, device=x.device)[None, :]
    valid = None
    if last_index is not None:
        last = last_rows(last_index, b, x.device)
        valid = (t <= last[:, None])[:, :, None, None]
    elif pad:
        valid = (t < s)[:, :, None, None]
    if valid is not None:
        k = k.masked_fill(~valid, 0)
        wlog = wlog.masked_fill(~valid, 0.0)
    out, s_final = _chunk_scan(r, k, v, wlog, p["u"], state0)
    out = out[:, :s].to(x.dtype)
    y = linear_apply(p["o"], out.reshape(b, s, h * hd))
    if not return_state:
        return y
    if last_index is not None:
        shift = x[torch.arange(b, device=x.device), last.clamp(0, s - 1)]
    else:
        shift = x[:, -1]
    return y, {"state": s_final, "shift": shift}


def rwkv_init_cache(batch: int, cfg, dtype, device=None
                    ) -> Dict[str, Tensor]:
    h, hd = rwkv_head_dims(cfg)
    return {"state": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                                 device=device),
            "shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device)}


def _step(p, x: Tensor, x_prev: Tensor, state: Tensor
          ) -> Tuple[Tensor, Tensor]:
    """One token from ``x_prev`` (B, d) and ``state`` (B, H, hd, hd),
    both only read: the output (B, 1, d) and the new state."""
    b = x.shape[0]
    h, hd = p["u"].shape
    r, k, v, wlog = _projections(p, x, x_prev, h, hd)
    r1, k1, v1 = (t[:, 0].float() for t in (r, k, v))
    w1 = torch.exp(wlog[:, 0])                                # (B, H, hd)
    kv = k1[..., :, None] * v1[..., None, :]
    out = torch.einsum("bhk,bhkd->bhd", r1, state + p["u"][..., None] * kv)
    y = linear_apply(p["o"], out.to(x.dtype).reshape(b, 1, h * hd))
    return y, state * w1[..., None] + kv


def rwkv_decode_step(p, x: Tensor, cache: Dict[str, Tensor], cfg
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, 1, d) -> (out (B, 1, d), cache).  ``cache["state"]`` and
    ``cache["shift"]`` are updated in place."""
    y, state = _step(p, x, cache["shift"], cache["state"])
    cache["state"].copy_(state)
    cache["shift"].copy_(x[:, 0])
    return y, cache


# --------------------------------------------------------------------------
# On a mesh (repro_torch.models.common.TensorParallel)
# --------------------------------------------------------------------------
_COLS = ("r", "k", "v", "w")


def _rank_tree(p, heads: slice, hd: int):
    """A rank's time-mix where the heads split: its heads ``heads`` of
    the r/k/v/w columns, of ``u`` and of ``o``'s rows.  A projection the
    specs left whole (``k``/``v``/``o`` follow the attention rule, on
    the configured head counts) is cut to them here; ``mu`` stays whole,
    since the token-shift mix precedes the projections.  The time-mix
    has no biases."""
    cols = slice(heads.start * hd, heads.stop * hd)
    n = (heads.stop - heads.start) * hd
    out = {**p, "u": p["u"][heads]}
    for name in _COLS:
        if p[name]["w"].shape[1] != n:
            out[name] = {"w": p[name]["w"][:, cols]}
    if p["o"]["w"].shape[0] != n:
        out["o"] = {"w": p["o"]["w"][cols]}
    return out


def _whole_tree(ps, cfg):
    d = cfg.d_model
    return {**ps[0], **{n: whole_linear([p[n] for p in ps], d, d)
                        for n in _COLS + ("o",)}}


def rwkv_apply_tp(ps, x: Tensor, cfg, tp, return_state: bool = False,
                  last_index=None):
    """:func:`rwkv_apply` (no ``x_prev``/``state0``) on a mesh: each rank
    the chunk scan on its heads (``tp.wkv_heads``) and ``o``'s partial
    sums reduced; the state comes back whole on rank 0's device (the
    ranks' heads gathered), ``shift`` from rank 0 (every rank reads the
    whole input).  Where the heads do not split, the time-mix runs
    whole, once."""
    if tp.wkv_heads is None:
        return rwkv_apply(_whole_tree(ps, cfg), x, cfg,
                          return_state=return_state, last_index=last_index)
    hd = rwkv_head_dims(cfg)[1]
    outs = [rwkv_apply(_rank_tree(p, heads, hd), x.to(d), cfg,
                       return_state=return_state, last_index=last_index)
            for p, heads, d in zip(ps, tp.wkv_heads, tp.devices)]
    if not return_state:
        return reduce_rows(outs, ps[0]["o"])
    return (reduce_rows([o[0] for o in outs], ps[0]["o"]),
            {"state": all_gather([o[1]["state"] for o in outs], 1)[0],
             "shift": outs[0][1]["shift"]})


def rwkv_decode_step_tp(ps, x: Tensor, cache: Dict[str, Sharded], cfg,
                        tp) -> Tensor:
    """:func:`rwkv_decode_step` on a mesh, on a cache laid out by
    ``cache_specs``: ``state`` split on its heads, ``shift`` on its
    features.  The token-shift mix needs the whole ``x_prev`` before the
    column-parallel projections, so ``shift`` is gathered (a whole copy
    a rank); each rank steps its heads and writes its ``state`` part,
    and every rank keeps its features of the new ``shift``.  Where the
    heads do not split, the time-mix runs whole, once, and every rank's
    parts take its state."""
    if tp.wkv_heads is None:
        whole = {n: c.gather() for n, c in cache.items()}
        out = rwkv_decode_step(_whole_tree(ps, cfg), x, whole, cfg)[0]
        for n, c in cache.items():
            c.copy_(whole[n])
        return out
    hd = rwkv_head_dims(cfg)[1]
    shift = cache["shift"]
    prev = (all_gather(shift.shards, -1) if shift.spec else shift.shards)
    outs = []
    for r, (p, heads, d) in enumerate(zip(ps, tp.wkv_heads, tp.devices)):
        state = cache["state"].shards[r]
        y, new = _step(_rank_tree(p, heads, hd), x.to(d), prev[r], state)
        state.copy_(new)
        outs.append(y)
    shift.copy_(x[:, 0])
    return reduce_rows(outs, ps[0]["o"])
