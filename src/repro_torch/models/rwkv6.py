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

from repro_torch.models.common import last_rows, linear_apply, linear_init

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
    h, hd = rwkv_head_dims(cfg)
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


def rwkv_decode_step(p, x: Tensor, cache: Dict[str, Tensor], cfg
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, 1, d) -> (out (B, 1, d), cache).  ``cache["state"]`` and
    ``cache["shift"]`` are updated in place."""
    b = x.shape[0]
    h, hd = rwkv_head_dims(cfg)
    r, k, v, wlog = _projections(p, x, cache["shift"], h, hd)
    r1, k1, v1 = (t[:, 0].float() for t in (r, k, v))
    w1 = torch.exp(wlog[:, 0])                                # (B, H, hd)
    kv = k1[..., :, None] * v1[..., None, :]
    out = torch.einsum("bhk,bhkd->bhd", r1,
                       cache["state"] + p["u"][..., None] * kv)
    new_state = cache["state"] * w1[..., None] + kv
    y = linear_apply(p["o"], out.to(x.dtype).reshape(b, 1, h * hd))
    cache["state"].copy_(new_state)
    cache["shift"].copy_(x[:, 0])
    return y, cache
