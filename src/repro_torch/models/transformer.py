"""Model assembly for causal-attention decoders, dense or MoE, with
global (``ATTN``) and sliding-window (``LOCAL``) layers (the port of the
main path of ``repro/models/transformer.py``).

The parameter tree keeps the reference's names with the scanned layer
groups unstacked into one dict per layer::

    {"embed": {"table"}, "final_norm": {"scale"},
     "layers": [{"norm1", "norm2", "mixer": {"q","k","v","o"},
                 "mlp": {"up","down"[,"gate"]}
                 | "moe": {"router","up","down"[,"gate"]}}, ...],
     ["lm_head": {"table"}]}

Layers run in a Python loop (the reference scans them), each with its
kind from ``cfg.layer_kinds()``.  Prefill emits the filled dense KV
cache as one stack a layer class, since the classes differ in
capacity: global layers ``{"k","v": (L_attn, B, max_seq, Hkv, hd)}``,
local layers ``{"wk","wv": (L_local, B, min(max_seq, window), Hkv,
hd)}`` (int8 with ``"k_s","v_s"`` / ``"wk_s","wv_s"`` scale planes
while ``attention.CACHE_QUANT`` is on); a model with one class has one
stack (:func:`cache_layout` maps a layer to its stack and index).
Decode reads and writes either such dense caches or page pools, one
stack a layer class: global layers ``{"pk","pv": (L_attn, pages + sink,
page_size, Hkv, hd)}`` (int8 with ``"pk_s","pv_s"`` scale planes) through
a ``(B, max_pages)`` page table, local layers ``{"lk","lv": (L_local,
local pages + sink, page_size, Hkv, hd)}`` (model precision) through a
``(B, R)`` ring table.  MoE layers (``cfg.moe``) replace the MLP with
:func:`repro_torch.models.moe.moe_apply`.  :func:`forward_train`
returns the next-token loss and its metrics for training
(``repro/models/transformer.py:188-246``).
Recurrent, enc-dec and frontend models raise ``NotImplementedError``
(later slices, ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, LOCAL, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (embed_scale, embedding_init,
                                       embedding_lookup, lm_head_logits,
                                       mlp_apply, mlp_init, rmsnorm_apply,
                                       rmsnorm_init)

Tensor = torch.Tensor
Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any architecture outside this slice of the port."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= {ATTN, LOCAL} or cfg.enc_dec \
            or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port serves causal-attention decoders (global "
            f"and sliding-window layers, dense or MoE) only so far (layer "
            f"kinds {sorted(kinds)}, enc_dec={cfg.enc_dec}, "
            f"frontend={cfg.frontend}); recurrent layers, enc-dec and "
            f"frontends are later slices, see ROADMAP.md")


# A local layer's cache tensors carry this prefix ("wk", "wv", ...),
# so the two classes' stacks live side by side in one dict.
_LOCAL_PREFIX = "w"


def _class(kind: str) -> str:
    return _LOCAL_PREFIX if kind == LOCAL else ""


def cache_layout(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Per layer, its cache stack's name prefix (``""`` global, ``"w"``
    local) and its index in that stack."""
    seen = {"": 0, _LOCAL_PREFIX: 0}
    out = []
    for kind in cfg.layer_kinds():
        pre = _class(kind)
        out.append((pre, seen[pre]))
        seen[pre] += 1
    return out


def _layer_cache(caches: Dict[str, Tensor], pre: str, index: int
                 ) -> Dict[str, Tensor]:
    """Layer ``index`` of the ``pre`` stack, under the plain names
    ``"k","v"[,"k_s","v_s"]`` (views: writes land in the stack)."""
    return {name[len(pre):]: t[index] for name, t in caches.items()
            if name.startswith(_LOCAL_PREFIX) == bool(pre)}


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def init_params(cfg: ModelConfig, seed: int = 0,
                dtype_override: Optional[str] = None,
                device=None) -> Params:
    """Random weights at ``cfg``'s widths from a seeded
    :class:`torch.Generator` (same tree as :func:`repro_torch.convert.
    params_from_jax`; not the reference's random draws)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = _dtype(dtype_override or cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "layers": [{
            "norm1": rmsnorm_init(cfg.d_model, dtype, dev),
            "norm2": rmsnorm_init(cfg.d_model, dtype, dev),
            "mixer": attn.attn_init(gen, cfg, dtype),
            **_ffn_init(gen, cfg, dtype),
        } for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                           dtype)
    return params


def _ffn_init(gen, cfg: ModelConfig, dtype) -> Params:
    if cfg.moe is not None:
        return {"moe": moe_mod.moe_init(gen, cfg, dtype)}
    return {"mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                            cfg.gated_mlp, cfg.use_bias)}


def _ffn(p: Params, cfg: ModelConfig, h: Tensor,
         valid: Optional[Tensor] = None) -> Tensor:
    """The layer's MLP, or its MoE with ``valid`` marking real tokens."""
    if cfg.moe is not None:
        return moe_mod.moe_apply(p["moe"], h, cfg, valid=valid)[0]
    return mlp_apply(p["mlp"], h, cfg.act)


def param_dtype(params: Params) -> torch.dtype:
    return params["embed"]["table"].dtype


def param_device(params: Params) -> torch.device:
    return params["embed"]["table"].device


def _embed(params: Params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    x = embedding_lookup(params["embed"], tokens)
    return x * embed_scale(cfg.d_model, x.dtype)


def _logits(params: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["lm_head"]["table"])
    return lm_head_logits(table, x, cfg.vocab_size)


def _block_train(p: Params, x: Tensor, cfg: ModelConfig, kind: str
                 ) -> Tuple[Tensor, Tensor]:
    """One full-sequence block for training: ``(x, moe_aux)``."""
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    mix, _, _ = attn.attn_apply(p["mixer"], h, cfg, kind=kind)
    x = x + mix
    h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    if cfg.moe is not None:
        ffn, aux = moe_mod.moe_apply(p["moe"], h, cfg)
    else:
        ffn = mlp_apply(p["mlp"], h, cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ffn, aux


REMAT_MODES = ("none", "full", "dots")


def forward_train(params: Params, cfg: ModelConfig,
                  batch: Dict[str, Tensor], *, mesh=None,
                  remat: str = "full") -> Tuple[Tensor, Dict[str, Tensor]]:
    """Returns ``(loss, {"loss", "accuracy", "moe_aux"})`` for ``batch``
    ``{"tokens": (B, S)[, "labels"]}``: the mean next-token cross entropy,
    plus ``0.01 * aux / n_layers`` for MoE, as the reference's
    ``forward_train``.

    ``remat="full"`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    activations.  ``"dots"`` (the reference keeps matmul outputs and
    recomputes the rest) maps to ``"full"`` here: the values are the
    same and only memory and time differ.  A mesh is the distributed
    slice and raises."""
    check_supported(cfg)
    if mesh is not None:
        raise NotImplementedError(
            "sharded training is the distributed slice of the port "
            "(ROADMAP.md)")
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r} not in {REMAT_MODES}")
    x = _embed(params, cfg, batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in zip(params["layers"], cfg.layer_kinds()):
        if remat == "none":
            x, a = _block_train(p, x, cfg, kind)
        else:
            x, a = checkpoint(_block_train, p, x, cfg, kind,
                              use_reentrant=False)
        aux = aux + a
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, cfg, x)
    labels = batch["labels"] if "labels" in batch else batch["tokens"]
    loss, acc = _next_token_loss(logits, labels)
    if cfg.moe is not None:
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss, {"loss": loss, "accuracy": acc, "moe_aux": aux}


def set_loss_dtype(mode: str) -> None:
    """Accepts the reference's loss modes and nothing else.  There,
    ``"bf16"`` keeps bf16 logits and upcasts only inside the loss's
    reductions; here the LM head always returns float32 logits
    (``lm_head_logits``), so both modes are the one float32 loss below
    and nothing is stored."""
    if mode not in ("f32", "bf16"):
        raise ValueError(f"loss dtype {mode!r} not in ('f32', 'bf16')")


def _next_token_loss(logits: Tensor, labels: Tensor
                     ) -> Tuple[Tensor, Tensor]:
    """Mean cross entropy of ``logits[:, t]`` against ``labels[:, t+1]``,
    in float32, and the argmax accuracy."""
    tg = labels[:, 1:].long()
    lg = logits[:, :-1].float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tg[..., None])[..., 0]
    loss = (lse - picked).mean()
    acc = (lg.argmax(dim=-1) == tg).float().mean()
    return loss, acc


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
               device=None) -> Dict[str, Tensor]:
    """Zero dense KV cache: ``{"k","v": (L_attn, batch, seq_len, Hkv,
    hd)}`` for the global layers and ``{"wk","wv": (L_local, batch,
    min(seq_len, window), Hkv, hd)}`` for the local ones (a class with
    no layer has no stack), int8 with bf16 scale planes while
    ``attention.CACHE_QUANT`` is on."""
    check_supported(cfg)
    dev = resolve_device(device)
    kinds = cfg.layer_kinds()
    out: Dict[str, Tensor] = {}
    for kind in (ATTN, LOCAL):
        n = kinds.count(kind)
        if not n:
            continue
        cap = attn.cache_capacity(kind, seq_len, cfg.sliding_window)
        one = attn.init_cache(batch, cap, cfg.n_kv_heads,
                              cfg.resolved_head_dim, dtype, dev)
        out.update({_class(kind) + name: t.new_zeros((n,) + t.shape)
                    for name, t in one.items()})
    return out


def forward_prefill(params: Params, cfg: ModelConfig,
                    batch: Dict[str, Tensor], *,
                    cache_len: Optional[int] = None,
                    logits_index=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Process prompts ``batch["tokens"]`` (B, S); return the f32 logits
    ``(B, 1, vocab_padded)`` of one position and the filled cache
    (module doc), each layer's capacity ``cache_capacity(kind,
    cache_len or S, window)``.

    ``logits_index`` (an int or 0-dim tensor, or a ``(B,)`` vector)
    selects the position whose logits are returned instead of the last
    — the bucketed prefill pads prompts and reads each row's last real
    token (causal masking hides the pads from it).  Every attention
    layer also takes it as ``last_index``: a layer whose capacity is
    shorter than S lays its ring at each row's real length, as the
    reference does (``repro/models/transformer.py:370-377``).  MoE
    layers take the tokens up to it as the real ones (``valid``).
    """
    check_supported(cfg)
    x = _embed(params, cfg, batch["tokens"])
    cap_seq = cache_len or x.shape[1]
    valid = None
    if logits_index is not None and cfg.moe is not None:
        last = torch.as_tensor(logits_index, device=x.device).reshape(-1)
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 <= last.expand(x.shape[0])[:, None])
    caches: Dict[str, List[Dict[str, Tensor]]] = {}
    for p, kind in zip(params["layers"], cfg.layer_kinds()):
        h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        mix, k, v = attn.attn_apply(p["mixer"], h, cfg, kind=kind)
        cap = attn.cache_capacity(kind, cap_seq, cfg.sliding_window)
        caches.setdefault(_class(kind), []).append(
            attn.prefill_into_cache(k, v, cap, logits_index))
        x = x + mix
        h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        x = x + _ffn(p, cfg, h, valid)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if logits_index is None:
        x_last = x[:, -1:]
    else:
        idx = torch.as_tensor(logits_index, device=x.device)
        if idx.dim() >= 1:
            gather = idx.long()[:, None, None].expand(-1, 1, x.shape[-1])
            x_last = torch.gather(x, 1, gather)
        else:
            i = int(idx)
            x_last = x[:, i:i + 1]
    return _logits(params, cfg, x_last), {
        pre + name: torch.stack([c[name] for c in layers])
        for pre, layers in caches.items() for name in layers[0]}


# The initial of a layer class's page-pool tensors ("pk", "pk_s" global;
# "lk" local), keyed by its dense-cache prefix.
_POOL_CLASS = {"": "p", _LOCAL_PREFIX: "l"}


def forward_decode(params: Params, cfg: ModelConfig, tokens: Tensor,
                   caches: Dict[str, Tensor], pos, *, page_table=None,
                   window_cap: Optional[int] = None
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decode step.  tokens: (B, 1).

    With ``page_table`` None, ``caches`` are the dense stacks of
    :func:`init_cache` / :func:`forward_prefill` (module doc), each
    layer reading its own stack (:func:`cache_layout`), and ``pos`` is a
    scalar (every row at one position: the sequential engine) or a
    ``(B,)`` vector of per-row positions (the slot engine); a local
    layer's ring capacity is its window.  Otherwise ``caches`` are the
    page pools of the module doc, ``pos`` is ``(B,)``, and
    ``page_table`` is ``{"global": (B, max_pages)[, "local": (B, R)]}``
    (a bare tensor means ``{"global": tensor}``): a global layer reads
    its ``"pk","pv"`` through K2, a local layer its ``"lk","lv"`` ring
    through the ring table with the logical ring capacity ``window_cap``
    (the engine's ``min(sliding_window, max_seq)``; default the
    window).  Either way the caches are updated in place, so a view of
    a larger buffer receives the writes.  Returns the f32 logits ``(B,
    1, vocab_padded)`` and the caches."""
    check_supported(cfg)
    if page_table is not None and not isinstance(page_table, dict):
        page_table = {"global": page_table}
    x = _embed(params, cfg, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    if page_table is None:
        pos = pos.long()
    for p, (pre, index) in zip(params["layers"], cache_layout(cfg)):
        h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        if page_table is None:
            mix, _ = attn.attn_decode_step(
                p["mixer"], h, _layer_cache(caches, pre, index), pos, cfg)
        else:
            cache = {name: t[index] for name, t in caches.items()
                     if name[0] == _POOL_CLASS[pre]}
            if pre:
                mix, _ = attn.paged_local_attn_decode_step(
                    p["mixer"], h, cache, page_table["local"], pos, cfg,
                    window_cap=window_cap or cfg.sliding_window)
            else:
                mix, _ = attn.paged_attn_decode_step(
                    p["mixer"], h, cache, page_table["global"], pos, cfg)
        x = x + mix
        h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        x = x + _ffn(p, cfg, h)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), caches
