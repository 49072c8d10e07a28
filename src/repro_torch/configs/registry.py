"""Architecture registry: the 10 assigned archs + the paper's 4 LLMs.

``get_config(name)`` returns the full published configuration;
``smoke_config(name)`` returns a structurally identical reduced instance
(same family, same layer pattern, tiny dims) for CPU smoke tests.  Full
configs are only ever lowered via ShapeDtypeStruct in the dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ATTN, LOCAL, ModelConfig, MoEConfig, RGLRU, WKV

_REGISTRY: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# --------------------------------------------------------------------------
# Assigned architectures (shape set: train_4k / prefill_32k / decode_32k /
# long_500k — applicability per DESIGN.md §4).
# --------------------------------------------------------------------------
GEMMA3_1B = _register(ModelConfig(
    name="gemma3-1b", family="dense", n_layers=26, d_model=1152,
    n_heads=4, n_kv_heads=1, head_dim=256, d_ff=6912, vocab_size=262144,
    layer_pattern=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, ATTN),   # 5:1
    sliding_window=512, rope_theta=1_000_000.0, tie_embeddings=True,
    subquadratic=True,     # 5/6 layers are 512-window local attention
    source="hf:google/gemma-3-1b-pt"))

GRANITE_20B = _register(ModelConfig(
    name="granite-20b", family="dense", n_layers=52, d_model=6144,
    n_heads=48, n_kv_heads=1, head_dim=128, d_ff=24576, vocab_size=49152,
    layer_pattern=(ATTN,), gated_mlp=False, act="gelu", use_bias=True,
    tie_embeddings=True, source="arXiv:2405.04324 (gpt-bigcode MQA)"))

YI_6B = _register(ModelConfig(
    name="yi-6b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=11008, vocab_size=64000,
    layer_pattern=(ATTN,), tie_embeddings=False, rope_theta=5_000_000.0,
    source="arXiv:2403.04652"))

COMMAND_R_PLUS = _register(ModelConfig(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, head_dim=128, d_ff=33792, vocab_size=256000,
    layer_pattern=(ATTN,), use_bias=False, tie_embeddings=True,
    rope_theta=75_000_000.0, source="hf:CohereForAI/c4ai-command-r-v01"))

INTERNVL2_76B = _register(ModelConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=28672, vocab_size=128256,
    layer_pattern=(ATTN,), tie_embeddings=False,
    frontend="vision", frontend_dim=3200,   # InternViT-6B hidden (stub)
    source="arXiv:2404.16821"))

DBRX_132B = _register(ModelConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=10752, vocab_size=100352,
    layer_pattern=(ATTN,), moe=MoEConfig(n_experts=16, top_k=4),
    tie_embeddings=False, source="hf:databricks/dbrx-base"))

PHI35_MOE = _register(ModelConfig(
    name="phi3.5-moe-42b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=6400, vocab_size=32064,
    layer_pattern=(ATTN,), moe=MoEConfig(n_experts=16, top_k=2),
    tie_embeddings=False, source="hf:microsoft/Phi-3.5-MoE-instruct"))

WHISPER_BASE = _register(ModelConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048, vocab_size=51865,
    layer_pattern=(ATTN,), enc_dec=True, n_enc_layers=6, dec_max_len=448,
    enc_frames=1500,                        # 30s x 50 frames/s post-conv
    gated_mlp=False, act="gelu", use_bias=True, tie_embeddings=True,
    frontend="audio", frontend_dim=80,      # mel bins (conv stack stubbed)
    source="arXiv:2212.04356"))

RECURRENTGEMMA_2B = _register(ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, head_dim=256, d_ff=7680, vocab_size=256000,
    layer_pattern=(RGLRU, RGLRU, LOCAL),    # 1:2 attn:recurrent
    sliding_window=2048, tie_embeddings=True, subquadratic=True,
    source="arXiv:2402.19427"))

RWKV6_3B = _register(ModelConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
    n_heads=40, n_kv_heads=40, head_dim=64, d_ff=8960, vocab_size=65536,
    layer_pattern=(WKV,), gated_mlp=False, act="relu2",
    tie_embeddings=False, subquadratic=True, source="arXiv:2404.05892"))

# --------------------------------------------------------------------------
# The paper's own evaluation models (Table 2) — used by the simulator
# benchmarks and available as full configs for end-to-end runs.
# --------------------------------------------------------------------------
QWEN25_05B = _register(ModelConfig(
    name="qwen2.5-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, head_dim=64, d_ff=4864, vocab_size=151936,
    layer_pattern=(ATTN,), use_bias=True, tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-0.5B (paper Table 2)"))

QWEN25_15B = _register(ModelConfig(
    name="qwen2.5-1.5b", family="dense", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, head_dim=128, d_ff=8960, vocab_size=151936,
    layer_pattern=(ATTN,), use_bias=True, tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-1.5B (paper Table 2)"))

LLAMA32_3B = _register(ModelConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=128256,
    layer_pattern=(ATTN,), tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-3B (paper Table 2)"))

QWEN25_7B = _register(ModelConfig(
    name="qwen2.5-7b", family="dense", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, head_dim=128, d_ff=18944, vocab_size=152064,
    layer_pattern=(ATTN,), use_bias=True, tie_embeddings=False,
    source="hf:Qwen/Qwen2.5-7B (paper Table 2)"))

ASSIGNED_ARCHS = ("gemma3-1b", "granite-20b", "yi-6b",
                  "command-r-plus-104b", "internvl2-76b", "dbrx-132b",
                  "phi3.5-moe-42b", "whisper-base", "recurrentgemma-2b",
                  "rwkv6-3b")


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    return dict(_REGISTRY)


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family instance for CPU smoke tests."""
    cfg = get_config(name)
    n_layers = min(cfg.n_layers, 2 * len(cfg.layer_pattern))
    moe = (MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2))
           if cfg.moe else None)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4 if cfg.name != "rwkv6-3b" else 8,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.name != "rwkv6-3b" else 8,
        head_dim=8,
        d_ff=128,
        vocab_size=512,
        sliding_window=16,
        moe=moe,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        dec_max_len=min(cfg.dec_max_len, 32),
        # deliberately not page-aligned so paged cross-KV pad paths run
        enc_frames=min(cfg.enc_frames, 12),
        frontend_dim=16 if cfg.frontend else 0,
        param_dtype="float32",
    )
