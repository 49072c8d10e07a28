"""Paper Table 2: unique GEMM operations of the evaluated LLMs.

Each entry is ``(N, K)`` with ``M = m`` (sequence length in prefill /
batch size in decode).  ``occurrence`` counts how many times the GEMM
appears per forward pass, derived from the HuggingFace configs the paper
extracted (q/o projections share ID0, k/v share ID1, gate/up share ID2,
down is ID3, lm_head is ID4).

Note: the paper prints Qwen2.5-1.5B ID1 as ``(m, 356, 1536)``; the actual
k/v projection of that model is ``2 kv-heads x 128 = 256``.  We keep the
paper's printed value for figure reproduction (the difference is <0.5 %
of aggregate cycles) — flagged here for transparency.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class GemmLayer:
    layer_id: int
    n: int
    k: int
    occurrence: int
    name: str

    def with_m(self, m: int) -> Tuple[int, int, int, int]:
        return (m, self.n, self.k, self.occurrence)


@dataclasses.dataclass(frozen=True)
class LLMWorkload:
    """A model's Table-2-style GEMM layer set; ``gemms(m)`` instantiates
    it at effective batch/sequence extent ``m``."""

    name: str
    n_layers: int
    layers: Tuple[GemmLayer, ...]

    def gemms(self, m: int) -> List[Tuple[int, int, int, int]]:
        return [ly.with_m(m) for ly in self.layers]


def _llm(name: str, n_layers: int, d: int, kv: int, ff: int, vocab: int,
         id1_override: int | None = None) -> LLMWorkload:
    id1 = id1_override if id1_override is not None else kv
    return LLMWorkload(name=name, n_layers=n_layers, layers=(
        GemmLayer(0, d, d, 2 * n_layers, "q/o_proj"),
        GemmLayer(1, id1, d, 2 * n_layers, "k/v_proj"),
        GemmLayer(2, ff, d, 2 * n_layers, "gate/up_proj"),
        GemmLayer(3, d, ff, n_layers, "down_proj"),
        GemmLayer(4, vocab, d, 1, "lm_head"),
    ))


QWEN25_05B = _llm("Qwen2.5-0.5B", 24, 896, 128, 4864, 151936)
QWEN25_15B = _llm("Qwen2.5-1.5B", 28, 1536, 256, 8960, 151936,
                  id1_override=356)   # paper Table 2 prints 356
LLAMA32_3B = _llm("Llama3.2-3B", 28, 3072, 1024, 8192, 128256)
QWEN25_7B = _llm("Qwen2.5-7B", 28, 3584, 512, 18944, 152064)

TABLE2: Dict[str, LLMWorkload] = {
    w.name: w for w in (QWEN25_05B, QWEN25_15B, LLAMA32_3B, QWEN25_7B)
}
