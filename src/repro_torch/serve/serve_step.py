"""Serving steps: exact-length and bucketed prefill (prompt -> cache),
and dense and paged decode (one token), the port of
``repro/serve/serve_step.py``.  PyTorch runs eagerly, so a step is a
plain closure over the config; nothing is compiled per shape.

Given a ``("data", "model")`` mesh, a step runs the model tensor-parallel
over the mesh's model row (``repro_torch.models.transformer``'s module
doc): its params are the ``Placed`` tree, decode's caches are
``Sharded`` stacks laid out by
:func:`repro_torch.distributed.sharding.cache_specs`, and prefill returns
the whole cache for the storage to lay out."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward_decode, forward_prefill


def make_prefill_step(cfg: ModelConfig, mesh=None, *,
                      cache_len: Optional[int] = None):
    """Exact-length prefill: ``batch = {"tokens": (B, S)}`` -> the last
    position's logits and the cache filled to ``cache_len`` (default
    S)."""

    def prefill_step(params, batch: Dict[str, torch.Tensor]):
        return forward_prefill(params, cfg, batch, cache_len=cache_len,
                               mesh=mesh)

    return prefill_step


def make_bucketed_prefill_step(cfg: ModelConfig, mesh=None, *,
                               cache_len: Optional[int] = None):
    """Prefill over pad-to-bucket prompts.  The step takes ``batch =
    {"tokens": (B, S_bucket), "last_index": int or (B,)}`` — the prompt
    padded with any token id, and the position of its last real token —
    and returns that position's logits plus the filled cache."""

    def prefill_step(params, batch: Dict[str, torch.Tensor]):
        return forward_prefill(params, cfg, batch, cache_len=cache_len,
                               logits_index=batch["last_index"], mesh=mesh)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """Decode step over dense caches: ``(params, caches, tokens (B, 1),
    pos)`` -> ``(logits, caches)``, ``pos`` a scalar or ``(B,)``, the
    caches updated in place."""

    def decode_step(params, caches, tokens: torch.Tensor, pos):
        return forward_decode(params, cfg, tokens, caches, pos, mesh=mesh)

    return decode_step


def make_paged_decode_step(cfg: ModelConfig, mesh=None, *,
                           window_cap: Optional[int] = None):
    """Decode step over paged KV storage: ``(params, pools, page_table,
    tokens (B, 1), pos (B,))`` -> ``(logits, pools)``, the pools updated
    in place.  ``page_table`` is the global table or a dict of the
    per-class tables (``"global"``, ``"local"``); ``window_cap`` pins the
    local layers' logical ring capacity to the engine's
    ``min(sliding_window, max_seq)``.  On a mesh the tables are whole
    (replicated) and the pools ``Sharded``."""

    def decode_step(params, pools, page_table, tokens: torch.Tensor,
                    pos: torch.Tensor):
        return forward_decode(params, cfg, tokens, pools, pos,
                              page_table=page_table, window_cap=window_cap,
                              mesh=mesh)

    return decode_step
