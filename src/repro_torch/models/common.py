"""Shared model substrate: linears (SISA-backed), norms, RoPE, embeddings
(the port of ``repro/models/common.py``).

Parameters are plain nested dicts of tensors with the reference's
layouts: a linear's weight is ``(in, out)``, i.e. the GEMM's ``B[K, N]``.
Norms and RoPE compute in f32 and cast back, and every projection goes
through ``sisa_einsum_2d`` (K1 on the card).

On a mesh (:class:`TensorParallel`) a layer takes the list of the model
row's per-rank trees (``Placed.local``): a column-parallel linear
computes each rank's output columns with the rank's slice of its bias
(:func:`linear_out`), a row-parallel one each rank's partial sum, reduced
in float32 in rank order before its bias is added once
(:func:`reduce_rows`); the embedding table and the LM head are split on
the vocabulary (:func:`embedding_lookup_tp`, :func:`lm_head_logits_tp`).
A weight that the divisibility-guarded specs left whole is used once, on
rank 0.  Every helper is made of differentiable torch ops and the
collectives, so training runs them under autograd: the backward of a
gather slices the gradient, that of a reduction hands it to every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import all_gather, all_reduce_sum
from repro_torch.kernels.ops import sisa_einsum_2d

Tensor = torch.Tensor


# --------------------------------------------------------------------------
# Initializers (seeded torch.Generator; the reference's jax.random draws
# differ, so tests hand both packages the same numpy weights instead)
# --------------------------------------------------------------------------
def _normal(gen: torch.Generator, shape, scale: float, dtype) -> Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def linear_init(gen, in_dim: int, out_dim: int, dtype, use_bias: bool):
    p = {"w": _normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype)}
    if use_bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=gen.device)
    return p


def linear_apply(p, x: Tensor) -> Tensor:
    y = sisa_einsum_2d(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rmsnorm_init(dim: int, dtype, device):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE (split halves, not interleaved pairs)
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                        # (head_dim/2,)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs           # (..., S, hd/2)
    angles = angles[..., None, :]                           # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Embedding with padded vocab
# --------------------------------------------------------------------------
VOCAB_PAD_MULTIPLE = 2048    # kept from the reference: equal padded shapes


def padded_vocab(vocab: int) -> int:
    return ((vocab + VOCAB_PAD_MULTIPLE - 1) // VOCAB_PAD_MULTIPLE
            ) * VOCAB_PAD_MULTIPLE


def embedding_init(gen, vocab: int, dim: int, dtype):
    return {"table": _normal(gen, (padded_vocab(vocab), dim),
                             1.0 / math.sqrt(dim), dtype)}


def embedding_lookup(p, tokens: Tensor) -> Tensor:
    return p["table"][tokens.long()]


def embed_scale(d_model: int, dtype) -> float:
    """sqrt(d_model) rounded to the parameter dtype *before* it
    multiplies, as the reference does (29.875 for 896 in bf16)."""
    return torch.sqrt(torch.tensor(float(d_model))).to(dtype).item()


def lm_head_logits(table: Tensor, x: Tensor, vocab: int) -> Tensor:
    """x: (..., d) -> f32 logits (..., vocab_padded), padding masked to
    finfo(f32).min.  ``table.T`` is read in place by K1, never copied."""
    logits = sisa_einsum_2d(x, table.T).float()
    pad = torch.arange(table.shape[0], device=x.device) >= vocab
    return logits.masked_fill(pad, torch.finfo(torch.float32).min)


def last_rows(last_index, batch: int, device) -> Tensor:
    """A prefill's ``last_index`` (an int, a 0-dim tensor or a ``(B,)``
    vector: each row's real last token) as a ``(batch,)`` long
    vector."""
    last = torch.as_tensor(last_index, device=device).long().reshape(-1)
    return last.expand(batch)


def activation(name: str) -> Callable[[Tensor], Tensor]:
    return {"silu": F.silu,
            # jax.nn.gelu defaults to the tanh approximation.
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu2": lambda x: torch.square(F.relu(x))}[name]


# --------------------------------------------------------------------------
# Dense MLP (SwiGLU or plain)
# --------------------------------------------------------------------------
def mlp_init(gen, d: int, ff: int, dtype, gated: bool, use_bias: bool):
    p = {"up": linear_init(gen, d, ff, dtype, use_bias),
         "down": linear_init(gen, ff, d, dtype, use_bias)}
    if gated:
        p["gate"] = linear_init(gen, d, ff, dtype, use_bias)
    return p


def mlp_apply(p, x: Tensor, act: str) -> Tensor:
    up = linear_apply(p["up"], x)
    if "gate" in p:
        up = activation(act)(linear_apply(p["gate"], x)) * up
    else:
        up = activation(act)(up)
    return linear_apply(p["down"], up)


# --------------------------------------------------------------------------
# Tensor parallelism over a mesh's model row
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One forward's split over ``mesh``'s model row: its ``devices``
    (rank order), whether attention heads split (``head_ok``: both head
    counts divide, the reference's ``MeshSharder`` rule) and, where they
    do, ``cfg_local``, the config a rank's attention runs with (its
    share of the heads).  The recurrent mixers: ``rglru_cols``, each
    rank's channels of an RG-LRU layer where they split
    (``sharding.rglru_split``), and ``wkv_heads``, each rank's heads of
    a WKV layer where they split (``sharding.wkv_split``); None where
    the mixer runs whole."""
    mesh: object
    devices: tuple
    head_ok: bool
    cfg_local: object
    rglru_cols: Optional[Tuple[slice, ...]] = None
    wkv_heads: Optional[Tuple[slice, ...]] = None

    @property
    def ms(self) -> int:
        return len(self.devices)


def _rank_slices(n: int, ms: int) -> Tuple[slice, ...]:
    k = n // ms
    return tuple(slice(r * k, (r + 1) * k) for r in range(ms))


def tensor_parallel(cfg, mesh, at=None) -> TensorParallel:
    """The split over the model row through coordinate ``at`` (default:
    data index 0)."""
    from repro_torch.distributed.sharding import (MeshSharder, rglru_split,
                                                  wkv_split)
    from repro_torch.models.rwkv6 import rwkv_head_dims
    devices = tuple(mesh.model_devices(at=at))
    ms = len(devices)
    head_ok = MeshSharder(mesh, cfg, batch_axes=()).head_ok
    local = (dataclasses.replace(cfg, n_heads=cfg.n_heads // ms,
                                 n_kv_heads=cfg.n_kv_heads // ms,
                                 head_dim=cfg.resolved_head_dim)
             if head_ok else None)
    return TensorParallel(
        mesh, devices, head_ok, local,
        rglru_cols=(_rank_slices(cfg.d_model, ms)
                    if rglru_split(cfg, mesh) else None),
        wkv_heads=(_rank_slices(rwkv_head_dims(cfg)[0], ms)
                   if wkv_split(cfg, mesh) else None))


def is_split(p, dim: int, full: int) -> bool:
    """True where a rank holds a part of linear ``p``'s weight on
    ``dim`` (``full`` wide whole)."""
    return p["w"].shape[dim] != full


def reduce_rows(parts: List[Tensor], p0) -> Tensor:
    """A row-parallel linear's output from the ranks' partial sums: the
    f32 sum in rank order, rounded once, then the bias rank 0 keeps
    aside (``"b_reduced"``), added once."""
    y = all_reduce_sum(parts)[0]
    if "b_reduced" in p0:
        y = y + p0["b_reduced"]
    return y


def linear_out(ps, x: Tensor, full: int) -> Tensor:
    """A linear's whole output (``full`` columns) on rank 0's device:
    column-parallel ranks' outputs gathered, or one call where the
    weight is whole."""
    if not is_split(ps[0], 1, full):
        return linear_apply(ps[0], x)
    return all_gather([linear_apply(p, x.to(p["w"].device)) for p in ps],
                      -1)[0]


def linear_in(ps, x: Tensor, full: int) -> Tensor:
    """A linear applied to a whole input ``x`` (``full`` features):
    row-parallel, each rank on its slice of the features, or one call
    where the weight is whole."""
    if not is_split(ps[0], 0, full):
        return linear_apply(ps[0], x)
    k = ps[0]["w"].shape[0]
    return reduce_rows([linear_apply(p, x[..., r * k:(r + 1) * k].to(
        p["w"].device)) for r, p in enumerate(ps)], ps[0])


def mlp_apply_tp(ps, x: Tensor, act: str, d_ff: int) -> Tensor:
    """The MLP on a mesh: ``up``/``gate`` column-parallel and ``down``
    row-parallel, each rank on its ``d_ff`` slice; whole weights (a
    width the model axis does not divide) run once."""
    if not is_split(ps[0]["up"], 1, d_ff):
        return mlp_apply(ps[0], x, act)
    return reduce_rows([mlp_apply(p, x.to(p["up"]["w"].device), act)
                        for p in ps], ps[0]["down"])


def whole_linear(ps, full_in: int, full_out: int):
    """Linear ``ps``'s whole weight (and bias) on rank 0's device, its
    parts gathered where the specs split it on its columns or its rows:
    what a mixer that runs whole, once, computes with."""
    p0 = ps[0]
    if is_split(p0, 1, full_out):
        out = {"w": all_gather([p["w"] for p in ps], 1)[0]}
        if "b" in p0:
            out["b"] = all_gather([p["b"] for p in ps], 0)[0]
        return out
    if is_split(p0, 0, full_in):
        out = {"w": all_gather([p["w"] for p in ps], 0)[0]}
        if "b_reduced" in p0:
            out["b"] = p0["b_reduced"]
        return out
    return p0


def embedding_lookup_tp(tables: List[Tensor], tokens: Tensor,
                        vocab: int) -> Tensor:
    """Vocabulary-parallel lookup: each rank gathers the tokens its rows
    hold and zeros for the rest, and the ranks' rows are summed (one
    nonzero term a token, so the sum is exact).  A whole table (a
    vocabulary the model axis does not divide) is read once."""
    if tables[0].shape[0] == padded_vocab(vocab):
        return embedding_lookup({"table": tables[0]}, tokens)
    n = tables[0].shape[0]
    parts = []
    for r, t in enumerate(tables):
        local = tokens.to(t.device).long() - r * n
        hit = ((local >= 0) & (local < n))[..., None]
        parts.append(torch.where(hit, t[local.clamp(0, n - 1)], 0))
    return all_reduce_sum(parts)[0]


def lm_head_logits_tp(tables: List[Tensor], x: Tensor, vocab: int
                      ) -> Tensor:
    """Vocabulary-parallel LM head: each rank's logits for its rows of
    the table (K1 a rank), gathered in rank order, padding masked as in
    :func:`lm_head_logits`.  A greedy argmax over the gathered row takes
    the lowest index among equal maxima, as the unsharded one does."""
    if tables[0].shape[0] == padded_vocab(vocab):
        return lm_head_logits(tables[0], x, vocab)
    parts = [sisa_einsum_2d(x.to(t.device), t.T).float() for t in tables]
    logits = all_gather(parts, -1)[0]
    pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab
    return logits.masked_fill(pad, torch.finfo(torch.float32).min)
