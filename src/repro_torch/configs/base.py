"""Model + shape-cell configuration schema."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# Layer kinds used in ``layer_pattern``.
ATTN = "attn"            # full causal self-attention
LOCAL = "local"          # sliding-window self-attention
BIDIR = "bidir"          # bidirectional self-attention (encoder)
RGLRU = "rglru"          # RecurrentGemma RG-LRU recurrent block
WKV = "wkv"              # RWKV6 time-mix block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|vlm|audio|hybrid|ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    layer_pattern: Tuple[str, ...] = (ATTN,)
    moe: Optional[MoEConfig] = None
    sliding_window: int = 1024
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    use_bias: bool = False
    tie_embeddings: bool = True
    act: str = "silu"                # silu | gelu
    gated_mlp: bool = True           # SwiGLU-style
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    dec_max_len: int = 448           # decoder structural max (whisper)
    enc_frames: int = 0              # fixed encoder source length (frames)
    # modality frontend stubs
    frontend: Optional[str] = None   # None | "vision" | "audio"
    frontend_dim: int = 0            # embedding dim the stub provides
    # numerics
    param_dtype: str = "bfloat16"
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False
    source: str = ""                 # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attn_free(self) -> bool:
        return all(k in (RGLRU, WKV) for k in self.layer_pattern)

    def layer_kinds(self) -> Tuple[str, ...]:
        """The full per-layer kind sequence (pattern tiled to n_layers)."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def layer_groups(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """(pattern, n_repeats) chunks for scan-over-layers.

        The cyclic pattern is scanned ``n_layers // period`` times; any
        ragged tail becomes a second group with one repeat.
        """
        period = len(self.layer_pattern)
        reps, rem = divmod(self.n_layers, period)
        groups = []
        if reps:
            groups.append((self.layer_pattern, reps))
        if rem:
            groups.append((self.layer_pattern[:rem], 1))
        return tuple(groups)

    def params_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            if kind in (ATTN, LOCAL, BIDIR):
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * hd * d
            elif kind == RGLRU:
                total += 2 * d * d + 2 * d      # in/out proj + gates (diag)
            elif kind == WKV:
                total += 4 * d * d              # r,k,v,o projections
            mlp = (3 if self.gated_mlp else 2) * d * ff
            total += mlp * (self.moe.n_experts if self.moe else 1)
            if self.moe:
                total += d * self.moe.n_experts  # router
        if self.enc_dec:
            per_enc = 4 * d * hd * self.n_heads // self.n_heads  # rough
            total += self.n_enc_layers * (4 * d * d + 3 * d * ff)
        return total

    def active_params_count(self) -> int:
        """Active (per-token) params — MoE counts top_k experts only."""
        if not self.moe:
            return self.params_count()
        dense_like = dataclasses.replace(self, moe=None)
        base = dense_like.params_count()
        mlp_per_layer = (3 if self.gated_mlp else 2) * self.d_model * self.d_ff
        return base + self.n_layers * mlp_per_layer * (self.moe.top_k - 1)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (shape) column: seq_len x global_batch, step kind."""

    name: str
    seq_len: int
    global_batch: int
    step: str                        # "train" | "prefill" | "decode"


SHAPE_CELLS: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Task-spec skips: long_500k only for sub-quadratic archs."""
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: long_500k requires "
                       "sub-quadratic attention (DESIGN.md §4)")
    if cell.name == "long_500k" and cfg.enc_dec:
        return False, "enc-dec audio model: 500k source length is meaningless"
    return True, ""
