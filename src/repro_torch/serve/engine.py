"""Serving host helpers: requests, SISA-aware batch quantization and
multi-tenant packing stats (the host-side part of the JAX package's
``repro/serve/engine.py``; its sequential ``ServeEngine`` is a later
slice).

The paper's utilization analysis (§4.3) shows distinct efficiency
regimes at effective-M = 16/32/64/128 (slab / fused / monolithic), so
admission *quantizes* the decode batch to the slab ladder: the
simulator (``repro_torch.core``) picks the rung with the fewest
predicted cycles per served request.  With ``multi_tenant`` on, every
step also plans how the decode batch's GEMMs and the waiting prompts'
prefill GEMMs would pack onto the slab array, and records the predicted
speedup in the stats.

Co-execution (``coexec_backend="kernel"``) executes that placement at
the serving level, as the reference's engines do: the co-scheduled
prefills run at the window boundary and park decode-ready in the
backfill queue, and each step's placement is lowered to the fused
kernel's grid-task order (:func:`~repro_torch.core.coexec_tile_sequence`),
whose size and tenant switches are recorded in ``stats["coexec_tiles"]``
/ ``stats["coexec_interleave"]``.  As in the reference, the flag does
not route the engine's own GEMMs through K6
(:mod:`repro_torch.kernels.coexec`); that kernel runs the packer's
placements with real operands (``coexec_matmul``).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (coexec_tile_sequence, GemmRequest,
                              packed_speedup, requests_from_workload,
                              simulate_workload, SISA_128)
from repro_torch.core.workloads import GemmLayer, LLMWorkload

SLAB_LADDER = (1, 2, 4, 8, 16, 32, 64, 128)
COEXEC_BACKENDS = (None, "kernel")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    arrived: float = 0.0
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # SLO scheduling (repro_torch.serve.policy): admission class (None ->
    # batch), absolute deadline stamp, times evicted under pool pressure,
    # and an explicit finish reason for lifecycle exits (cancel).
    klass: Optional[str] = None
    deadline: Optional[float] = None
    preemptions: int = 0
    finish_reason: Optional[str] = None


def effective_tokens(req: Request) -> np.ndarray:
    """Token sequence a (re-)prefill of ``req`` must run over.

    Fresh requests prefill their prompt.  A preempted request resumes by
    re-prefilling ``prompt + generated[:-1]`` — every token written to
    its released cache — and re-entering decode with
    ``tok = generated[-1]``, which regenerates the identical stream.
    """
    if not req.generated:
        return np.asarray(req.prompt, np.int32)
    return np.concatenate([np.asarray(req.prompt, np.int32),
                           np.asarray(req.generated[:-1], np.int32)])


def _llm_workload_of(cfg: ModelConfig) -> LLMWorkload:
    """Project a ModelConfig onto Table-2-style GEMM layers."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return LLMWorkload(name=cfg.name, n_layers=cfg.n_layers, layers=(
        GemmLayer(0, cfg.n_heads * hd, d, 2 * cfg.n_layers, "q/o"),
        GemmLayer(1, cfg.n_kv_heads * hd, d, 2 * cfg.n_layers, "k/v"),
        GemmLayer(2, cfg.d_ff, d, 2 * cfg.n_layers, "gate/up"),
        GemmLayer(3, d, cfg.d_ff, cfg.n_layers, "down"),
        GemmLayer(4, cfg.vocab_size, d, 1, "lm_head"),
    ))


@functools.lru_cache(maxsize=4096)
def _rung_cycles(cfg: ModelConfig, rung: int) -> float:
    """Simulated cycles for one full decode pass at batch = ``rung``
    (memoized per frozen config and rung: admission calls the ladder
    sweep every step)."""
    wl = _llm_workload_of(cfg)
    return simulate_workload(wl.gemms(rung), SISA_128).cycles


def choose_decode_batch(n_live: int, cfg: ModelConfig,
                        max_batch: int = 128, *,
                        admit_cap: Optional[int] = None) -> int:
    """SISA-aware batch quantization: the ladder rung minimizing
    predicted cycles per served request.  ``admit_cap`` bounds the
    requests that can actually be resident (the paged engine's page
    budget), so rungs beyond it only buy masked holes."""
    if n_live <= 0:
        return 0
    cap = n_live if admit_cap is None else min(n_live, max(admit_cap, 1))
    best_b, best_cpt = None, float("inf")
    for b in SLAB_LADDER:
        if b > max_batch:
            break
        served = min(cap, b)
        cpt = _rung_cycles(cfg, b) / served
        if cpt < best_cpt - 1e-9:
            best_b, best_cpt = b, cpt
        if b >= cap:
            break
    return best_b


def plan_step_packing(decode_bsz: int, prompt_lens: List[int],
                      cfg: ModelConfig, max_coresident: int = 4):
    """Multi-tenant co-schedule of one engine step on the slab array:
    the decode batch's GEMMs packed with the next waiting prompts'
    prefill GEMMs.  Returns ``(packed, serial, n_prefills_packed)``."""
    wl = _llm_workload_of(cfg)
    reqs: List[GemmRequest] = []
    if decode_bsz > 0:
        reqs = requests_from_workload(wl.gemms(decode_bsz), tag="decode")
    prompts = prompt_lens[:max_coresident]
    for s in prompts:
        reqs += requests_from_workload(wl.gemms(max(1, s)), tag="prefill",
                                       start_rid=len(reqs))
    _, packed, serial = packed_speedup(reqs, SISA_128)
    return packed, serial, len(prompts)


def note_first_token(req: Request, logits: torch.Tensor, vocab: int,
                     stats: Dict[str, Any]) -> None:
    """Record a prefill's greedy first token and TTFT on ``req``."""
    req.generated.append(int(torch.argmax(logits[0, -1, :vocab])))
    req.first_token_at = time.time()
    stats["ttft"].append(req.first_token_at - req.arrived)


def init_serve_stats(expert_backend: Optional[str] = None,
                     coexec_backend: Optional[str] = None
                     ) -> Dict[str, Any]:
    """The stats dict every engine starts from: exactly the shared
    schema of ``repro_torch.serve.api.STATS_KEYS`` (engine extras go
    under ``"engine"``).  ``expert_backend`` is the MoE expert lowering
    in effect (``"kernel"`` for MoE models, None otherwise);
    ``coexec_backend`` is None or ``"kernel"`` (the port's only
    co-execution backend, like its other ``*_backend`` switches) and
    raises ``ValueError`` otherwise."""
    if coexec_backend not in COEXEC_BACKENDS:
        raise ValueError(f"coexec_backend={coexec_backend!r}: the port has "
                         f"only {COEXEC_BACKENDS}")
    return {"batches": [], "ttft": [], "decode_steps": 0,
            "decode_compiles": None,
            "packed_speedup": [], "packed_prefills": 0,
            "backfilled": 0, "coexec_tiles": [], "coexec_interleave": [],
            "coexec_backend": coexec_backend,
            "expert_backend": expert_backend,
            "engine": {}}


def record_step_packing(stats: Dict[str, Any], decode_bsz: int,
                        waiting: List[int], cfg: ModelConfig,
                        coexec: bool) -> int:
    """Plan one step's multi-tenant placement and record its predicted
    speedup and, with ``coexec``, the size and tenant switches of its
    fused grid-task order; returns the number of co-scheduled
    prefills."""
    packed, serial, n_pre = plan_step_packing(decode_bsz, waiting, cfg)
    if packed.makespan > 0:
        stats["packed_speedup"].append(serial.cycles / packed.makespan)
    stats["packed_prefills"] += n_pre
    if coexec:
        seq = coexec_tile_sequence(packed)
        stats["coexec_tiles"].append(len(seq))
        stats["coexec_interleave"].append(
            sum(a != b for a, b in zip(seq, seq[1:])))
    return n_pre
