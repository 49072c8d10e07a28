"""Shared model substrate: linears (SISA-backed), norms, RoPE, embeddings
(the port of ``repro/models/common.py``).

Parameters are plain nested dicts of tensors with the reference's
layouts: a linear's weight is ``(in, out)``, i.e. the GEMM's ``B[K, N]``.
Norms and RoPE compute in f32 and cast back, and every projection goes
through ``sisa_einsum_2d`` (K1 on the card).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

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
