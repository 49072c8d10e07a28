"""Model assembly for decoders of global (``ATTN``) and sliding-window
(``LOCAL``) attention layers and RG-LRU (``RGLRU``) and RWKV6 time-mix
(``WKV``) recurrent layers, dense or MoE (the port of the main path of
``repro/models/transformer.py``).

The parameter tree keeps the reference's names with the scanned layer
groups unstacked into one dict per layer::

    {"embed": {"table"}, "final_norm": {"scale"},
     "layers": [{"norm1", "norm2",
                 "mixer": {"q","k","v","o"}                 (attention)
                        | {"in_gate","in_rec","conv_w","gate_r","gate_i",
                           "lam","out"}                     (RG-LRU)
                        | {"mu","r","k","v","w","u","o"},   (WKV)
                 "mlp": {"up","down"[,"gate"]}
                 | "moe": {"router","up","down"[,"gate"]}}, ...],
     ["lm_head": {"table"}], ["frontend_proj": {"w","b"}]}

and an enc-dec model (whisper) adds to each decoder layer ``"norm_cross"``
and ``"cross": {"q","k","v","o"}``, and ``"encoder": {"layers": [...],
"final_norm"}`` of bidirectional (``BIDIR``) attention layers.

Layers run in a Python loop (the reference scans them), each with its
kind from ``cfg.layer_kinds()``.  Caches hold one stack a layer class,
since the classes differ in shape (:func:`cache_layout` maps a layer to
its class's tag and its index in the stacks).  Prefill emits the filled
dense cache: global layers ``{"k","v": (L_attn, B, max_seq, Hkv, hd)}``,
local layers ``{"wk","wv": (L_local, B, min(max_seq, window), Hkv,
hd)}`` (int8 with ``"k_s","v_s"`` / ``"wk_s","wv_s"`` scale planes
while ``attention.CACHE_QUANT`` is on), RG-LRU layers ``{"h": (L_rglru,
B, d) f32, "conv": (L_rglru, B, 3, d)}`` and WKV layers ``{"state":
(L_wkv, B, H, hd, hd) f32, "shift": (L_wkv, B, d)}``, the recurrent
states at model precision whatever the flag; a class with no layer has
no stack.  Decode reads and writes either such dense caches or the
paged engine's pools: global layers ``{"pk","pv": (L_attn, pages +
sink, page_size, Hkv, hd)}`` (int8 with ``"pk_s","pv_s"`` scale planes)
through a ``(B, max_pages)`` page table, local layers ``{"lk","lv":
(L_local, local pages + sink, page_size, Hkv, hd)}`` (model precision)
through a ``(B, R)`` ring table, and the recurrent states as slabs of
the dense stacks' shapes, ``(L_kind, B, ...)``, a row a slot.  Decode
updates every cache in place.  MoE layers (``cfg.moe``) replace the MLP
with :func:`repro_torch.models.moe.moe_apply`.  :func:`forward_train`
returns the next-token loss and its metrics for training
(``repro/models/transformer.py:188-246``) on every layer kind above.

A decoder with a stub frontend (internvl2's vision tower) has the leaf
``"frontend_proj": {"w": (frontend_dim, d_model), "b"}``: training
and prefill project ``batch["frontend_embeds"]`` through it in place of
the token embedding (unscaled), cast to the weights' dtype first since
K1 takes one dtype; decode and the engines embed tokens, as the
reference's do.

An enc-dec model (whisper-base) runs ``batch["frontend_embeds"]``
through ``frontend_proj`` and the encoder (:func:`_encode`) in training
and prefill; its decoder embeds the tokens unscaled there and scaled by
√d in decode, as the reference does, and each decoder layer attends the
encoder's output after its self-attention.  Prefill projects each
layer's cross K/V once into the dense stacks ``{"xk","xv": (L_dec, B,
S_enc, Hkv, hd)}`` (model precision even under ``CACHE_QUANT``), which
decode only reads; the paged engine copies them into its cross pools
``{"ck","cv": (L_dec, cross pages + sink, page_size, Hkv, hd)}`` (model
precision on int8 pools too), which decode reads through a ``(B, C)``
cross table.  All three engines serve it.

On a ``("data", "model")`` mesh (:class:`~repro_torch.distributed.mesh.
Mesh`), :func:`forward_prefill` and :func:`forward_decode` run one
replica over the model row from the placed parameters
(:func:`~repro_torch.distributed.sharding.place_params`): the embedding
and the LM head vocabulary-parallel, ``frontend_proj`` column-parallel
(gathered), attention, global or sliding-window, head-parallel where
both head counts divide (else once, on caches and ring pools split on
the sequence), RG-LRU channel-parallel and the RWKV6 time-mix
head-parallel where they divide (else once), the MLP column- then
row-parallel, MoE expert-parallel.  An enc-dec model's encoder runs
there too (:func:`_encode_tp`: ``frontend_proj`` column-parallel, the
bidirectional layers head-parallel where the heads divide), and each
decoder layer's cross attention reads the ``"xk","xv"`` stacks, or the
``"ck","cv"`` pools through the cross table, head-parallel (else
gathered once).  Decode reads and writes caches of
:class:`~repro_torch.distributed.mesh.Sharded` stacks laid out by
``cache_specs``; prefill returns the whole cache, which the engines'
storage lays out.  :func:`forward_train` on a mesh takes the training
placement (FSDP over data x TP over model) and runs that TP forward
once a data replica on its rows of the batch, the parameters gathered
over the data axis layer by layer, an enc-dec model's encoder layers
too.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN, BIDIR, LOCAL, ModelConfig, RGLRU,
                                      WKV)
from repro_torch.distributed.collectives import all_reduce_sum
from repro_torch.distributed.mesh import shard_slices
from repro_torch.distributed.sharding import batch_specs, gather_fsdp
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import (embed_scale, embedding_init,
                                       embedding_lookup, embedding_lookup_tp,
                                       last_rows, linear_apply, linear_init,
                                       linear_out, lm_head_logits,
                                       lm_head_logits_tp,
                                       mlp_apply, mlp_apply_tp, mlp_init,
                                       rmsnorm_apply, rmsnorm_init,
                                       tensor_parallel)

Tensor = torch.Tensor
Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any architecture outside the port so far: layer kinds
    other than global and sliding-window attention, RG-LRU and WKV.
    Enc-dec models pass, and every engine serves them."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= {ATTN, LOCAL, RGLRU, WKV}:
        raise NotImplementedError(
            f"{cfg.name}: the port serves and trains decoders of global "
            f"and sliding-window attention and RG-LRU and RWKV6 recurrent "
            f"layers, dense or MoE, with or without a stub frontend or an "
            f"encoder, only (layer kinds {sorted(kinds)}); see ROADMAP.md")


# Each layer class keeps its cache tensors in stacks of its own.  A
# class's tag (cache_layout), and for each name of a layer's cache the
# name of its class's stack in a dense cache.
_TAG = {ATTN: "", LOCAL: "w", RGLRU: RGLRU, WKV: WKV}
_KV = ("k", "v", "k_s", "v_s")
_DENSE = {"": {n: n for n in _KV}, "w": {n: "w" + n for n in _KV},
          RGLRU: {"h": "h", "conv": "conv"},
          WKV: {"state": "state", "shift": "shift"}}
# The names of each class's tensors in the paged engine's pools; a paged
# layer's cache keeps them.
_POOLS = {"": ("pk", "pv", "pk_s", "pv_s"), "w": ("lk", "lv"),
          RGLRU: ("h", "conv"), WKV: ("state", "shift")}
# The recurrent layers' stacks: no sequence axis, the same shape dense
# (slot buffers) and paged (slabs).
STATE_STACKS = _POOLS[RGLRU] + _POOLS[WKV]
# An enc-dec decoder's dense cross K/V, (L_dec, B, enc_len, Hkv, hd), a
# row a layer, and the paged engine's cross pools, (L_dec, cross pages +
# sink, page_size, Hkv, hd), read through the "cross" table.
CROSS_STACKS = ("xk", "xv")
CROSS_POOLS = ("ck", "cv")


def stack_name(tag: str, name: str) -> str:
    """The dense stack that holds ``name`` of a layer of class ``tag``."""
    return _DENSE[tag][name]


def cache_layout(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Per layer, its class's tag (``""`` global, ``"w"`` local,
    ``"rglru"``, ``"wkv"``) and its index in that class's stacks."""
    seen = {tag: 0 for tag in _DENSE}
    out = []
    for kind in cfg.layer_kinds():
        tag = _TAG[kind]
        out.append((tag, seen[tag]))
        seen[tag] += 1
    return out


def _layer_cache(caches: Dict[str, Tensor], tag: str, index: int
                 ) -> Dict[str, Tensor]:
    """Layer ``index`` of class ``tag``'s dense stacks, under the names
    its mixer reads (views: writes land in the stacks)."""
    return {name: caches[stack][index] for name, stack in _DENSE[tag].items()
            if stack in caches}


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
        "layers": [_block_init(gen, cfg, kind, dtype, dev, cfg.enc_dec)
                   for kind in cfg.layer_kinds()],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                           dtype)
    if cfg.frontend is not None:
        # A bias, though the model's other linears have none, as in the
        # reference (repro/models/transformer.py:88-90).
        params["frontend_proj"] = linear_init(gen, cfg.frontend_dim,
                                              cfg.d_model, dtype,
                                              use_bias=True)
    if cfg.enc_dec:
        params["encoder"] = {
            "layers": [_block_init(gen, cfg, BIDIR, dtype, dev, False)
                       for _ in range(cfg.n_enc_layers)],
            "final_norm": rmsnorm_init(cfg.d_model, dtype, dev)}
    return params


def _block_init(gen, cfg: ModelConfig, kind: str, dtype, dev,
                with_cross: bool) -> Params:
    """One layer's weights; an enc-dec decoder layer adds its
    cross-attention (``"norm_cross"``, ``"cross"``)."""
    p = {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
         "norm2": rmsnorm_init(cfg.d_model, dtype, dev),
         "mixer": _mixer_init(gen, cfg, kind, dtype)}
    if with_cross:
        p["norm_cross"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["cross"] = attn.attn_init(gen, cfg, dtype)
    p.update(_ffn_init(gen, cfg, dtype))
    return p


def _mixer_init(gen, cfg: ModelConfig, kind: str, dtype) -> Params:
    if kind == RGLRU:
        return rglru_mod.rglru_init(gen, cfg, dtype)
    if kind == WKV:
        return rwkv_mod.rwkv_init(gen, cfg, dtype)
    return attn.attn_init(gen, cfg, dtype)


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


def _project_frontend(params: Params, embeds: Tensor) -> Tensor:
    """``embeds`` (B, S, frontend_dim) through ``frontend_proj``, cast to
    the weights' dtype first (K1 takes one dtype); the reference
    projects float32 embeds against promoted weights, so in bf16 its
    stream is float32."""
    proj = params["frontend_proj"]
    return linear_apply(proj, embeds.to(proj["w"].dtype))


def _embed_inputs(params: Params, cfg: ModelConfig,
                  batch: Dict[str, Tensor]) -> Tensor:
    """The decoder's input: on an enc-dec model the token embedding,
    unscaled (the reference's training and prefill; its decode scales,
    :func:`_embed`); else ``batch["frontend_embeds"]`` through
    ``frontend_proj``, unscaled, where the model has a frontend and the
    batch carries them; else the scaled token embedding."""
    if cfg.enc_dec:
        return embedding_lookup(params["embed"], batch["tokens"])
    if cfg.frontend is not None and "frontend_embeds" in batch:
        return _project_frontend(params, batch["frontend_embeds"])
    return _embed(params, cfg, batch["tokens"])


def _encode(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor], *,
            remat: str = "none") -> Tensor:
    """An enc-dec model's encoder: ``batch["frontend_embeds"]`` (B,
    S_enc, frontend_dim) through ``frontend_proj``, the bidirectional
    layers (each recomputed in the backward unless ``remat`` is
    ``"none"``; the MoE aux of the encoder is dropped, as in the
    reference) and the encoder's final norm: ``(B, S_enc, d)``."""
    x = _project_frontend(params, batch["frontend_embeds"])
    for p in params["encoder"]["layers"]:
        x = _run_block(p, x, cfg, BIDIR, None, remat)[0]
    return rmsnorm_apply(params["encoder"]["final_norm"], x, cfg.norm_eps)


def _logits(params: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["lm_head"]["table"])
    return lm_head_logits(table, x, cfg.vocab_size)


def _mixer_train(p: Params, h: Tensor, cfg: ModelConfig, kind: str
                 ) -> Tensor:
    """A layer's mixer over the whole sequence, its output only."""
    if kind == RGLRU:
        return rglru_mod.rglru_apply(p, h, cfg)
    if kind == WKV:
        return rwkv_mod.rwkv_apply(p, h, cfg)
    return attn.attn_apply(p, h, cfg, kind=kind)[0]


def _block_train(p: Params, x: Tensor, cfg: ModelConfig, kind: str,
                 enc_out: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """One full-sequence block for training: ``(x, moe_aux)``; a decoder
    layer of an enc-dec model attends ``enc_out`` after its mixer."""
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    x = x + _mixer_train(p["mixer"], h, cfg, kind)
    if "cross" in p:
        h = rmsnorm_apply(p["norm_cross"], x, cfg.norm_eps)
        x = x + attn.attn_apply(p["cross"], h, cfg, kind="cross",
                                kv_x=enc_out)[0]
    h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    if cfg.moe is not None:
        ffn, aux = moe_mod.moe_apply(p["moe"], h, cfg)
    else:
        ffn = mlp_apply(p["mlp"], h, cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ffn, aux


REMAT_MODES = ("none", "full", "dots")


def _remat(fn, remat: str, *args):
    """``fn(*args)``, recomputed in the backward unless ``remat`` is
    ``"none"``."""
    if remat == "none":
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def _run_block(p: Params, x: Tensor, cfg: ModelConfig, kind: str,
               enc_out: Optional[Tensor], remat: str
               ) -> Tuple[Tensor, Tensor]:
    """:func:`_block_train`, recomputed in the backward unless ``remat``
    is ``"none"``."""
    return _remat(_block_train, remat, p, x, cfg, kind, enc_out)


def forward_train(params: Params, cfg: ModelConfig,
                  batch: Dict[str, Tensor], *, mesh=None,
                  remat: str = "full") -> Tuple[Tensor, Dict[str, Tensor]]:
    """Returns ``(loss, {"loss", "accuracy", "moe_aux"})`` for ``batch``
    ``{"tokens": (B, S)[, "labels"][, "frontend_embeds": (B, S,
    frontend_dim)]}``: the mean next-token cross entropy, plus ``0.01 *
    aux / n_layers`` for MoE, as the reference's ``forward_train``.
    Each layer runs its kind's mixer (attention, RG-LRU or WKV), as the
    reference's ``_block_apply`` does; the embeds, where the model has a
    frontend, replace the token embedding (:func:`_embed_inputs`).  On
    an enc-dec model the embeds (B, S_enc, frontend_dim) go through the
    encoder instead (:func:`_encode`), every decoder layer attends its
    output, and the labels are the tokens.

    ``remat="full"`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    activations.  ``"dots"`` (the reference keeps matmul outputs and
    recomputes the rest) maps to ``"full"`` here: the values are the
    same and only memory and time differ.

    With ``mesh``, ``params`` is the training placement
    (:func:`~repro_torch.distributed.sharding.place_train`) and
    :func:`_forward_train_tp` runs one TP forward per data replica."""
    check_supported(cfg)
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r} not in {REMAT_MODES}")
    if mesh is not None:
        return _forward_train_tp(params, cfg, batch, mesh, remat)
    enc_out = _encode(params, cfg, batch, remat=remat) if cfg.enc_dec \
        else None
    x = _embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in zip(params["layers"], cfg.layer_kinds()):
        x, a = _run_block(p, x, cfg, kind, enc_out, remat)
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


def _layer_cache_init(cfg: ModelConfig, kind: str, batch: int,
                      seq_len: int, dtype, dev) -> Dict[str, Tensor]:
    if kind == RGLRU:
        return rglru_mod.rglru_init_cache(batch, cfg.d_model, dtype, dev)
    if kind == WKV:
        return rwkv_mod.rwkv_init_cache(batch, cfg, dtype, dev)
    cap = attn.cache_capacity(kind, seq_len, cfg.sliding_window)
    return attn.init_cache(batch, cap, cfg.n_kv_heads, cfg.resolved_head_dim,
                           dtype, dev)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
               device=None, *, kinds=(ATTN, LOCAL, RGLRU, WKV),
               enc_len: Optional[int] = None) -> Dict[str, Tensor]:
    """Zero dense cache of the module doc for the layers of ``kinds``:
    ``{"k","v": (L_attn, batch, seq_len, Hkv, hd)}`` for the global
    layers, ``{"wk","wv": (L_local, batch, min(seq_len, window), Hkv,
    hd)}`` for the local ones (int8 with bf16 scale planes while
    ``attention.CACHE_QUANT`` is on), ``{"h","conv"}`` for the RG-LRU
    layers and ``{"state","shift"}`` for the WKV ones (a class with no
    layer has no stack).  An enc-dec model adds its cross stacks
    ``{"xk","xv": (L_dec, batch, enc_len or seq_len, Hkv, hd)}`` in
    ``dtype`` whatever the flag (what prefill fills them with is never
    quantized; the reference's ``init_cache`` quantizes its zero cross
    caches under the flag, which its prefill then replaces)."""
    check_supported(cfg)
    dev = resolve_device(device)
    layer_kinds = cfg.layer_kinds()
    out: Dict[str, Tensor] = {}
    for kind in kinds:
        n = layer_kinds.count(kind)
        if not n:
            continue
        one = _layer_cache_init(cfg, kind, batch, seq_len, dtype, dev)
        out.update({stack_name(_TAG[kind], name):
                    t.new_zeros((n,) + t.shape) for name, t in one.items()})
    if cfg.enc_dec:
        shape = (cfg.n_layers, batch, enc_len or seq_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        out.update({name: torch.zeros(shape, dtype=dtype, device=dev)
                    for name in CROSS_STACKS})
    return out


def _mixer_prefill(p: Params, h: Tensor, cfg: ModelConfig, kind: str,
                   cap_seq: int, last_index) -> Tuple[Tensor,
                                                      Dict[str, Tensor]]:
    """A layer's mixer over the prompt: its output and its cache."""
    if kind == RGLRU:
        return rglru_mod.rglru_prefill(p, h, cfg, last_index)
    if kind == WKV:
        return rwkv_mod.rwkv_apply(p, h, cfg, return_state=True,
                                   last_index=last_index)
    mix, k, v = attn.attn_apply(p, h, cfg, kind=kind)
    cap = attn.cache_capacity(kind, cap_seq, cfg.sliding_window)
    return mix, attn.prefill_into_cache(k, v, cap, last_index)


def forward_prefill(params: Params, cfg: ModelConfig,
                    batch: Dict[str, Tensor], *,
                    cache_len: Optional[int] = None,
                    logits_index=None, mesh=None
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Process prompts ``batch["tokens"]`` (B, S), or on a model with a
    frontend ``batch["frontend_embeds"]`` (B, S, frontend_dim) where
    the batch has them (:func:`_embed_inputs`); return the f32 logits
    ``(B, 1, vocab_padded)`` of one position and the filled cache
    (module doc), each layer's capacity ``cache_capacity(kind,
    cache_len or S, window)``.  On an enc-dec model the embeds (B,
    S_enc, frontend_dim) go through the encoder (:func:`_encode`), the
    tokens through the decoder, and the cache adds each decoder layer's
    cross K/V, ``{"xk","xv": (L_dec, B, S_enc, Hkv, hd)}``, projected
    once (``attn_apply(kind="cross")`` returns them).

    ``logits_index`` (an int or 0-dim tensor, or a ``(B,)`` vector)
    selects the position whose logits are returned instead of the last
    — the bucketed prefill pads prompts and reads each row's last real
    token (causal masking hides the pads from it).  Every attention
    and recurrent layer also takes it as ``last_index``, as the
    reference's do (``repro/models/transformer.py:290-316``, ``:370-377``):
    an attention layer whose capacity is shorter than S lays its ring at
    each row's real length, and a recurrent layer keeps its state at
    each row's real last token.  MoE layers take the tokens up to it as
    the real ones (``valid``).

    With ``mesh``, ``params`` is the ``Placed`` tree and the model runs
    tensor-parallel (module doc); the logits and the cache come back
    whole, on the model row's first device.
    """
    check_supported(cfg)
    if mesh is not None:
        return _forward_prefill_tp(params, cfg, batch, cache_len,
                                   logits_index, mesh)
    enc_out = _encode(params, cfg, batch) if cfg.enc_dec else None
    x = _embed_inputs(params, cfg, batch)
    cap_seq = cache_len or x.shape[1]
    valid = None
    if logits_index is not None and cfg.moe is not None:
        last = last_rows(logits_index, x.shape[0], x.device)
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 <= last[:, None])
    caches: Dict[str, List[Dict[str, Tensor]]] = {}
    cross: List[Dict[str, Tensor]] = []
    for p, kind in zip(params["layers"], cfg.layer_kinds()):
        h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        mix, cache = _mixer_prefill(p["mixer"], h, cfg, kind, cap_seq,
                                    logits_index)
        caches.setdefault(_TAG[kind], []).append(cache)
        x = x + mix
        if "cross" in p:
            h = rmsnorm_apply(p["norm_cross"], x, cfg.norm_eps)
            mix, xk, xv = attn.attn_apply(p["cross"], h, cfg, kind="cross",
                                          kv_x=enc_out)
            cross.append({"xk": xk, "xv": xv})
            x = x + mix
        h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        x = x + _ffn(p, cfg, h, valid)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    out = {stack_name(tag, name): torch.stack([c[name] for c in layers])
           for tag, layers in caches.items() for name in layers[0]}
    out.update({name: torch.stack([c[name] for c in cross])
                for name in CROSS_STACKS if cross})
    return _logits(params, cfg, _logits_rows(x, logits_index)), out


def _logits_rows(x: Tensor, logits_index) -> Tensor:
    """The one position a prefill returns logits for: the last, or
    ``logits_index`` (an int or 0-dim tensor, or a ``(B,)`` vector)."""
    if logits_index is None:
        return x[:, -1:]
    idx = torch.as_tensor(logits_index, device=x.device)
    if idx.dim() >= 1:
        gather = idx.long()[:, None, None].expand(-1, 1, x.shape[-1])
        return torch.gather(x, 1, gather)
    i = int(idx)
    return x[:, i:i + 1]


def _lookup_tp(loc, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    return embedding_lookup_tp([t["embed"]["table"] for t in loc], tokens,
                               cfg.vocab_size)


def _embed_tp(loc, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    x = _lookup_tp(loc, tokens, cfg)
    return x * embed_scale(cfg.d_model, x.dtype)


def _project_frontend_tp(loc, embeds: Tensor, cfg: ModelConfig) -> Tensor:
    """:func:`_project_frontend` on a mesh: ``frontend_proj``
    column-parallel, its output gathered."""
    proj = [t["frontend_proj"] for t in loc]
    return linear_out(proj, embeds.to(proj[0]["w"].dtype), cfg.d_model)


def _embed_inputs_tp(loc, cfg: ModelConfig, batch: Dict[str, Tensor]
                     ) -> Tensor:
    """:func:`_embed_inputs` on a mesh: on an enc-dec model the
    vocabulary-parallel token embedding, unscaled (the features go to
    the encoder); else ``frontend_proj`` column-parallel where the model
    has a frontend and the batch carries its embeds; else the scaled
    vocabulary-parallel token embedding."""
    if cfg.enc_dec:
        return _lookup_tp(loc, batch["tokens"], cfg)
    if cfg.frontend is not None and "frontend_embeds" in batch:
        return _project_frontend_tp(loc, batch["frontend_embeds"], cfg)
    return _embed_tp(loc, cfg, batch["tokens"])


def _encode_tp(loc, cfg: ModelConfig, embeds: Tensor, tp) -> Tensor:
    """:func:`_encode` over a model row (``loc``: its rank trees):
    ``frontend_proj`` column-parallel, each bidirectional layer
    head-parallel where the heads divide (else once) with its MLP column-
    then row-parallel, and the encoder's final norm: ``(B, S_enc, d)``
    on rank 0's device."""
    x = _project_frontend_tp(loc, embeds, cfg)
    for i in range(cfg.n_enc_layers):
        x = _enc_block_tp([t["encoder"]["layers"][i] for t in loc], x, cfg,
                          tp)
    return rmsnorm_apply(loc[0]["encoder"]["final_norm"], x, cfg.norm_eps)


def _enc_block_tp(ps, x: Tensor, cfg: ModelConfig, tp) -> Tensor:
    """One encoder layer on a mesh (``ps``: the ranks' layer trees)."""
    return _mlp_train_tp(ps, _mixer_half_tp(ps, x, cfg, BIDIR, tp), cfg)


def _cross_half_tp(ps, x: Tensor, enc_out: Tensor, cfg: ModelConfig, tp,
                   need_kv: bool = True) -> Tuple[Tensor, Optional[Tensor],
                                                  Optional[Tensor]]:
    """A decoder layer's cross-attention half on a mesh (``ps``: the
    ranks' layer trees): the residual stream after it and the layer's
    whole cross K/V (training passes ``need_kv=False``)."""
    h = rmsnorm_apply(ps[0]["norm_cross"], x, cfg.norm_eps)
    mix, xk, xv = attn.attn_apply_tp([p["cross"] for p in ps], h, cfg, tp,
                                     need_kv, kind="cross", kv_x=enc_out)
    return x + mix, xk, xv


def _logits_tp(loc, cfg: ModelConfig, x: Tensor) -> Tensor:
    name = "embed" if cfg.tie_embeddings else "lm_head"
    return lm_head_logits_tp([t[name]["table"] for t in loc], x,
                             cfg.vocab_size)


def _ffn_tp(loc, i: int, cfg: ModelConfig, h: Tensor, mesh,
            valid: Optional[Tensor] = None) -> Tensor:
    if cfg.moe is not None:
        return moe_mod.moe_apply([t["layers"][i]["moe"] for t in loc], h,
                                 cfg, mesh=mesh, valid=valid)[0]
    return mlp_apply_tp([t["layers"][i]["mlp"] for t in loc], h, cfg.act,
                        cfg.d_ff)


def _mixer_prefill_tp(ps, h: Tensor, cfg: ModelConfig, kind: str, tp,
                      cap_seq: int, last_index
                      ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """:func:`_mixer_prefill` on a mesh: the output and the layer's
    whole cache on rank 0's device."""
    if kind == RGLRU:
        return rglru_mod.rglru_prefill_tp(ps, h, cfg, tp, last_index)
    if kind == WKV:
        return rwkv_mod.rwkv_apply_tp(ps, h, cfg, tp, return_state=True,
                                      last_index=last_index)
    mix, k, v = attn.attn_apply_tp(ps, h, cfg, tp, kind=kind)
    cap = attn.cache_capacity(kind, cap_seq, cfg.sliding_window)
    return mix, attn.prefill_into_cache(k, v, cap, last_index)


def _mixer_half_tp(ps, x: Tensor, cfg: ModelConfig, kind: str, tp
                   ) -> Tensor:
    """One replica's mixer half of a layer in training: :func:`
    _mixer_train` on a mesh (``ps``: the ranks' layer trees)."""
    h = rmsnorm_apply(ps[0]["norm1"], x, cfg.norm_eps)
    mixers = [p["mixer"] for p in ps]
    if kind == RGLRU:
        return x + rglru_mod.rglru_apply_tp(mixers, h, cfg, tp)
    if kind == WKV:
        return x + rwkv_mod.rwkv_apply_tp(mixers, h, cfg, tp)
    return x + attn.attn_apply_tp(mixers, h, cfg, tp, need_kv=False,
                                  kind=kind)[0]


def _mlp_train_tp(ps, x: Tensor, cfg: ModelConfig) -> Tensor:
    h = rmsnorm_apply(ps[0]["norm2"], x, cfg.norm_eps)
    return x + mlp_apply_tp([p["mlp"] for p in ps], h, cfg.act, cfg.d_ff)


def _moe_train_tp(rows, xs: List[Tensor], cfg: ModelConfig, mesh
                  ) -> Tuple[List[Tensor], List[Tensor]]:
    """The MoE half of a layer for every replica (``rows[r]``: replica
    ``r``'s per-rank layer trees), and each replica's ``aux``."""
    hs = [rmsnorm_apply(ps[0]["norm2"], x, cfg.norm_eps)
          for ps, x in zip(rows, xs)]
    ys, auxs = moe_mod.moe_apply_replicas([[p["moe"] for p in ps]
                                           for ps in rows], hs, cfg, mesh)
    return [x + y for x, y in zip(xs, ys)], auxs


_BATCH_INPUTS = ("tokens", "labels", "frontend_embeds")


def _top_of(tree):
    """What a training forward gathers once, outside the layers: every
    subtree but the decoder and encoder layers (the encoder's final norm
    kept)."""
    out = {k: v for k, v in tree.items() if k not in ("layers", "encoder")}
    if "encoder" in tree:
        out["encoder"] = {"final_norm": tree["encoder"]["final_norm"]}
    return out


def _forward_train_tp(placed, cfg: ModelConfig, batch: Dict[str, Tensor],
                      mesh, remat: str) -> Tuple[Tensor, Dict[str, Tensor]]:
    """:func:`forward_train` on a mesh.  Each data replica (a model row,
    :meth:`~repro_torch.distributed.mesh.Mesh.replicas`) takes its rows
    of the batch (tokens, labels and frontend embeds) by
    ``batch_specs`` and runs the TP forward of
    :func:`_forward_prefill_tp` without caches, each layer its kind's
    mixer, on TP shards gathered over the data axes layer by layer
    (``gather_fsdp``); an enc-dec model first runs the encoder on the
    replica's embeds, its layers gathered the same way, and each decoder
    layer attends that replica's encoder output.  Its loss is the mean
    next-token cross entropy of its rows plus ``0.01 * aux /
    n_layers``; the step's is the mean of the replicas' (equal row
    counts: the reference's mean over the global batch).  ``remat``
    wraps a layer, over all the replicas (a MoE half may route the
    global batch: :func:`~repro_torch.models.moe.moe_apply_replicas`),
    in ``checkpoint`` together with its gather, so that the backward
    gathers the layer's shards again and no layer's gathered weights
    outlive it; under ``remat="none"`` the matmuls keep every layer's
    gathered weights until the backward."""
    reps = mesh.replicas()
    specs = batch_specs("train", mesh, cfg)
    labels_key = "labels" if "labels" in batch else "tokens"
    inputs = [{k: batch[k][shard_slices(batch[k].shape, specs[k], mesh,
                                        base)].to(mesh.devices[base])
               for k in _BATCH_INPUTS if k in batch} for base in reps]
    tps = [tensor_parallel(cfg, mesh, at=base) for base in reps]
    kinds = cfg.layer_kinds()

    def tp_rows(select):
        trees = gather_fsdp(placed, select)
        return [[trees[c] for c in mesh.model_row(at=base)] for base in reps]

    top = tp_rows(_top_of)
    enc_outs = None
    if cfg.enc_dec:
        def enc_layer(i: int, xs: List[Tensor]) -> List[Tensor]:
            rows = tp_rows(lambda t: t["encoder"]["layers"][i])
            return [_enc_block_tp(ps, x, cfg, tp)
                    for ps, x, tp in zip(rows, xs, tps)]

        enc = [_project_frontend_tp(loc, inp["frontend_embeds"], cfg)
               for loc, inp in zip(top, inputs)]
        for i in range(cfg.n_enc_layers):
            enc = _remat(enc_layer, remat, i, enc)
        enc_outs = [rmsnorm_apply(loc[0]["encoder"]["final_norm"], x,
                                  cfg.norm_eps) for loc, x in zip(top, enc)]
    xs = [_embed_inputs_tp(loc, cfg, inp) for loc, inp in zip(top, inputs)]
    auxs = [torch.zeros((), dtype=torch.float32, device=x.device)
            for x in xs]

    def layer(i: int, xs: List[Tensor], enc_outs):
        rows = tp_rows(lambda t: t["layers"][i])
        xs = [_mixer_half_tp(ps, x, cfg, kinds[i], tp)
              for ps, x, tp in zip(rows, xs, tps)]
        if enc_outs is not None:
            xs = [_cross_half_tp(ps, x, e, cfg, tp, need_kv=False)[0]
                  for ps, x, e, tp in zip(rows, xs, enc_outs, tps)]
        if cfg.moe is None:
            return [_mlp_train_tp(ps, x, cfg) for ps, x in zip(rows, xs)], []
        return _moe_train_tp(rows, xs, cfg, mesh)

    for i in range(cfg.n_layers):
        xs, layer_aux = _remat(layer, remat, i, xs, enc_outs)
        if layer_aux:
            auxs = [a + b for a, b in zip(auxs, layer_aux)]
    losses, accs = [], []
    for loc, x, inp, aux in zip(top, xs, inputs, auxs):
        x = rmsnorm_apply(loc[0]["final_norm"], x, cfg.norm_eps)
        loss, acc = _next_token_loss(_logits_tp(loc, cfg, x), inp[labels_key])
        if cfg.moe is not None:
            loss = loss + 0.01 * aux / cfg.n_layers
        losses.append(loss)
        accs.append(acc)
    n = len(reps)
    loss = all_reduce_sum(losses)[0] / n
    acc = all_reduce_sum(accs)[0] / n
    aux = all_reduce_sum(auxs)[0] / n
    return loss, {"loss": loss, "accuracy": acc, "moe_aux": aux}


def _forward_prefill_tp(placed, cfg: ModelConfig, batch, cache_len,
                        logits_index, mesh) -> Tuple[Tensor,
                                                     Dict[str, Tensor]]:
    """:func:`forward_prefill` over ``mesh``'s model row (module doc)."""
    tp = tensor_parallel(cfg, mesh)
    loc = placed.local
    enc_out = (_encode_tp(loc, cfg, batch["frontend_embeds"], tp)
               if cfg.enc_dec else None)
    x = _embed_inputs_tp(loc, cfg, batch)
    cap_seq = cache_len or x.shape[1]
    valid = None
    if logits_index is not None and cfg.moe is not None:
        last = last_rows(logits_index, x.shape[0], x.device)
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 <= last[:, None])
    caches: Dict[str, List[Dict[str, Tensor]]] = {}
    cross: List[Dict[str, Tensor]] = []
    for i, (p, kind) in enumerate(zip(loc[0]["layers"], cfg.layer_kinds())):
        h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        mix, cache = _mixer_prefill_tp([t["layers"][i]["mixer"] for t in loc],
                                       h, cfg, kind, tp, cap_seq,
                                       logits_index)
        caches.setdefault(_TAG[kind], []).append(cache)
        x = x + mix
        if enc_out is not None:
            x, xk, xv = _cross_half_tp([t["layers"][i] for t in loc], x,
                                       enc_out, cfg, tp)
            cross.append({"xk": xk, "xv": xv})
        h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        x = x + _ffn_tp(loc, i, cfg, h, mesh, valid)
    x = rmsnorm_apply(loc[0]["final_norm"], x, cfg.norm_eps)
    out = {stack_name(tag, name): torch.stack([c[name] for c in layers])
           for tag, layers in caches.items() for name in layers[0]}
    out.update({name: torch.stack([c[name] for c in cross])
                for name in CROSS_STACKS if cross})
    return _logits_tp(loc, cfg, _logits_rows(x, logits_index)), out


def forward_decode(params: Params, cfg: ModelConfig, tokens: Tensor,
                   caches: Dict[str, Tensor], pos, *, page_table=None,
                   window_cap: Optional[int] = None, mesh=None
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decode step.  tokens: (B, 1).

    With ``page_table`` None, ``caches`` are the dense stacks of
    :func:`init_cache` / :func:`forward_prefill` (module doc), each
    layer reading its own stack (:func:`cache_layout`), and ``pos`` is a
    scalar (every row at one position: the sequential engine) or a
    ``(B,)`` vector of per-row positions (the slot engine); a local
    layer's ring capacity is its window.  Otherwise ``caches`` are the
    page pools of the module doc, ``pos`` is ``(B,)``, and
    ``page_table`` is ``{"global": (B, max_pages)[, "local": (B, R)][,
    "cross": (B, C)]}`` (a bare tensor means ``{"global": tensor}``): a
    global layer reads its ``"pk","pv"`` through K2, a local layer its
    ``"lk","lv"`` ring through the ring table with the logical ring
    capacity ``window_cap`` (the engine's ``min(sliding_window,
    max_seq)``; default the window).  Recurrent layers read and write their ``"h","conv"`` or
    ``"state","shift"`` stacks either way (slot rows of the dense
    buffers, or of the paged engine's slabs); they take no position.
    An enc-dec decoder layer then attends its cross K/V, read and never
    written: the dense ``"xk","xv"`` stacks, or with a ``"cross"`` table
    its ``"ck","cv"`` pools through it, cut to ``cfg.enc_frames``
    frames (:func:`~repro_torch.models.attention.
    paged_cross_attn_decode`).  Every cache is
    updated in place, so a view of a larger buffer receives the writes.
    The token embedding is scaled by √d here, as in the reference's
    decode, also on an enc-dec model, whose training and prefill leave
    it unscaled (:func:`_embed_inputs`).  Returns the f32 logits ``(B,
    1, vocab_padded)`` and the caches.

    With ``mesh``, ``params`` is the ``Placed`` tree, ``caches`` are
    :class:`~repro_torch.distributed.mesh.Sharded` stacks laid out by
    ``cache_specs``, the tables are whole, and the model runs
    tensor-parallel (module doc)."""
    check_supported(cfg)
    if page_table is not None and not isinstance(page_table, dict):
        page_table = {"global": page_table}
    if mesh is not None:
        return _forward_decode_tp(params, cfg, tokens, caches, pos,
                                  page_table, window_cap, mesh)
    x = _embed(params, cfg, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    if page_table is None:
        pos = pos.long()
    for i, (p, kind, (tag, index)) in enumerate(zip(
            params["layers"], cfg.layer_kinds(), cache_layout(cfg))):
        h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        if page_table is None:
            cache = _layer_cache(caches, tag, index)
        else:
            cache = {name: caches[name][index] for name in _POOLS[tag]
                     if name in caches}
        if kind == RGLRU:
            mix, _ = rglru_mod.rglru_decode_step(p["mixer"], h, cache, cfg)
        elif kind == WKV:
            mix, _ = rwkv_mod.rwkv_decode_step(p["mixer"], h, cache, cfg)
        elif page_table is None:
            mix, _ = attn.attn_decode_step(p["mixer"], h, cache, pos, cfg)
        elif kind == LOCAL:
            mix, _ = attn.paged_local_attn_decode_step(
                p["mixer"], h, cache, page_table["local"], pos, cfg,
                window_cap=window_cap or cfg.sliding_window)
        else:
            mix, _ = attn.paged_attn_decode_step(
                p["mixer"], h, cache, page_table["global"], pos, cfg)
        x = x + mix
        if "cross" in p:
            h = rmsnorm_apply(p["norm_cross"], x, cfg.norm_eps)
            if page_table is not None and "cross" in page_table:
                x = x + attn.paged_cross_attn_decode(
                    p["cross"], h, {n: caches[n][i] for n in CROSS_POOLS},
                    page_table["cross"], cfg, enc_len=cfg.enc_frames)
            else:
                x = x + attn.cross_attn_decode(
                    p["cross"], h,
                    {"k": caches["xk"][i], "v": caches["xv"][i]}, cfg)
        h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        x = x + _ffn(p, cfg, h)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), caches


def _forward_decode_tp(placed, cfg: ModelConfig, tokens: Tensor, caches,
                       pos, page_table, window_cap, mesh
                       ) -> Tuple[Tensor, Dict]:
    """:func:`forward_decode` over ``mesh``'s model row (module doc)."""
    tp = tensor_parallel(cfg, mesh)
    loc = placed.local
    x = _embed_tp(loc, cfg, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    for i, (p, kind, (tag, index)) in enumerate(zip(
            loc[0]["layers"], cfg.layer_kinds(), cache_layout(cfg))):
        h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        ps = [t["layers"][i]["mixer"] for t in loc]
        if page_table is None:
            cache = _layer_cache(caches, tag, index)
        else:
            cache = {name: caches[name][index] for name in _POOLS[tag]
                     if name in caches}
        if kind == RGLRU:
            mix = rglru_mod.rglru_decode_step_tp(ps, h, cache, cfg, tp)
        elif kind == WKV:
            mix = rwkv_mod.rwkv_decode_step_tp(ps, h, cache, cfg, tp)
        elif page_table is None:
            mix = attn.attn_decode_step_tp(ps, h, cache, pos.long(), cfg, tp)
        elif kind == LOCAL:
            mix = attn.paged_local_attn_decode_step_tp(
                ps, h, cache, page_table["local"], pos, cfg, tp,
                window_cap=window_cap or cfg.sliding_window)
        else:
            mix = attn.paged_attn_decode_step_tp(
                ps, h, cache, page_table["global"], pos, cfg, tp)
        x = x + mix
        if "cross" in p:
            cs = [t["layers"][i]["cross"] for t in loc]
            h = rmsnorm_apply(p["norm_cross"], x, cfg.norm_eps)
            if page_table is not None and "cross" in page_table:
                x = x + attn.paged_cross_attn_decode_tp(
                    cs, h, {n: caches[n][i] for n in CROSS_POOLS},
                    page_table["cross"], cfg, tp, enc_len=cfg.enc_frames)
            else:
                x = x + attn.cross_attn_decode_tp(
                    cs, h, {"k": caches["xk"][i], "v": caches["xv"][i]},
                    cfg, tp)
        h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        x = x + _ffn_tp(loc, i, cfg, h, mesh)
    x = rmsnorm_apply(loc[0]["final_norm"], x, cfg.norm_eps)
    return _logits_tp(loc, cfg, x), caches
