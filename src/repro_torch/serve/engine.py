"""Serving engine: continuous batching with SISA-aware batch
quantization, and the host helpers every engine shares (the port of
``repro/serve/engine.py``).

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

:class:`ServeEngine` is the sequential engine: each step admits a
ladder batch, prefills its fresh admits at exact length, concatenates
their caches and decodes the batch to completion at one shared
position, ``pos = max(positions)``, so a short row also attends the
zero cells past its own prompt.  Only the slot and paged engines
(``repro_torch.serve.slot_engine``) are batch-invariant.
"""
from __future__ import annotations

from collections import deque
import dataclasses
import functools
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (coexec_tile_sequence, GemmRequest,
                              packed_speedup, requests_from_workload,
                              simulate_workload, SISA_128)
from repro_torch.core.workloads import GemmLayer, LLMWorkload
from repro_torch.models.transformer import check_supported
from repro_torch.serve.api import completion_of, Completion, FINISH_CANCELLED
from repro_torch.serve.policy import KLASS_BATCH, SchedulingPolicy
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

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
    # batch), absolute deadline stamp enforced by the frontend, times
    # evicted under pool pressure, and an explicit finish reason for
    # lifecycle exits (cancel/deadline) that budget accounting alone
    # cannot express.
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


class ServeEngine:
    """The sequential engine: admit a ladder batch and serve it to
    completion, one decode step (and one host sync) a token.

    Prefills run at exact length into ``max_seq``-capacity caches, which
    are concatenated along the batch axis and decoded at ``pos =
    max(positions)``; finished rows are dropped from the batch by index.
    ``stats["decode_compiles"]`` is the number of distinct decode batch
    sizes run since construction (what the reference's jit cache
    counts), kept across :meth:`reset`."""

    def __init__(self, cfg: ModelConfig, params, *, device: torch.device,
                 max_batch: int = 8, max_seq: int = 256,
                 multi_tenant: bool = True,
                 coexec_backend: Optional[str] = None,
                 policy: Optional[SchedulingPolicy] = None,
                 default_klass: str = KLASS_BATCH):
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = params
        self.prefill_fn = make_prefill_step(cfg, cache_len=max_seq)
        self.decode_fn = make_decode_step(cfg)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.multi_tenant = multi_tenant
        self.policy = policy or SchedulingPolicy()
        self.default_klass = default_klass
        self.coexec_backend = coexec_backend
        self._expert_backend = "kernel" if cfg.moe is not None else None
        self._decode_sizes: set = set()
        self.stats: Dict[str, Any] = {}
        self.queue: Deque[Request] = deque()
        # (request, prefilled cache, position): prefills completed via
        # backfill, awaiting decode admission.
        self._backfilled: Deque[Tuple[Request, Any, int]] = deque()
        self._cancelled: List[Request] = []
        self.reset()

    def submit(self, req: Request) -> None:
        req.arrived = time.time()
        if req.klass is None:
            req.klass = self.default_klass
        self.policy.enqueue(self.queue, req)

    def cancel(self, rid: int) -> bool:
        """Drop a queued or backfilled request (nothing is resident
        between ``step()`` calls); marks it done with
        ``finish_reason="cancelled"``.  Returns True iff found."""
        for req in list(self.queue):
            if req.rid == rid:
                self.queue.remove(req)
                break
        else:
            for item in list(self._backfilled):
                if item[0].rid == rid:
                    self._backfilled.remove(item)
                    req = item[0]
                    break
            else:
                return False
        req.done = True
        req.finish_reason = FINISH_CANCELLED
        req.finished_at = time.time()
        self._cancelled.append(req)
        self.stats["engine"]["cancelled"] += 1
        return True

    def reset(self) -> None:
        """Clear queues and stats for a fresh serve on the same engine."""
        self.queue.clear()
        self._backfilled.clear()
        self._cancelled.clear()
        self.stats = init_serve_stats(self._expert_backend,
                                      self.coexec_backend)
        self.stats["engine"].update({"cancelled": 0})

    def _prefill_one(self, req: Request):
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int32)[None],
                                 device=self.device)
        logits, cache = self.prefill_fn(self.params, {"tokens": tokens})
        note_first_token(req, logits, self.cfg.vocab_size, self.stats)
        return cache, len(req.prompt)

    def _backfill_one(self, req: Request) -> None:
        """One co-scheduled prefill inside the decode loop; the request
        parks decode-ready for the next admission."""
        cache, pos = self._prefill_one(req)
        self._backfilled.append((req, cache, pos))
        self.stats["backfilled"] += 1

    @torch.no_grad()
    def step(self, finished: List[Request], max_steps: int = 512) -> int:
        """One scheduler iteration: admit a ladder batch (backfilled
        requests first) and decode it to completion.  Appends finished
        requests to ``finished``; returns the decode steps consumed (0
        when there is no work)."""
        if self._cancelled:
            finished.extend(self._cancelled)
            self._cancelled.clear()
        if not (self.queue or self._backfilled) or max_steps <= 0:
            return 0
        budget = max_steps
        # A backfilled request is live (its prefill already ran), not a
        # pending prefill.
        n_live = len(self.queue) + len(self._backfilled)
        bsz = choose_decode_batch(n_live, self.cfg, self.max_batch)
        bsz = max(1, min(bsz, n_live, self.max_batch))
        self.stats["batches"].append(bsz)
        active: List[Request] = []
        caches, positions = [], []
        while self._backfilled and len(active) < bsz:
            r, cache, pos_r = self._backfilled.popleft()
            active.append(r)
            caches.append(cache)
            positions.append(pos_r)
        fresh = [self.queue.popleft() for _ in range(bsz - len(active))]
        active += fresh
        n_pre = 0
        if self.multi_tenant:
            waiting = [len(r.prompt) for r in self.queue]
            n_pre = record_step_packing(self.stats, bsz, waiting, self.cfg,
                                        bool(self.coexec_backend))
        for r in fresh:
            cache, pos_r = self._prefill_one(r)
            caches.append(cache)
            positions.append(pos_r)
        to_backfill: List[Request] = []
        if self.coexec_backend and self.multi_tenant:
            to_backfill = [self.queue.popleft()
                           for _ in range(min(n_pre, len(self.queue)))]
        batched = {name: torch.cat([c[name] for c in caches], dim=1)
                   for name in caches[0]}
        pos = max(positions)
        live = list(active)
        while live and budget > 0:
            toks = torch.as_tensor([[r.generated[-1]] for r in live],
                                   dtype=torch.int32, device=self.device)
            logits, batched = self.decode_fn(self.params, batched, toks, pos)
            self._decode_sizes.add(len(live))
            self.stats["decode_steps"] += 1
            pos += 1
            budget -= 1
            if to_backfill:
                # One co-resident prefill per decode iteration.
                self._backfill_one(to_backfill.pop(0))
            nxt = torch.argmax(logits[:, -1, :self.cfg.vocab_size],
                               -1).cpu().numpy()
            still = []
            for i, r in enumerate(live):
                r.generated.append(int(nxt[i]))
                if len(r.generated) >= r.max_new_tokens \
                        or pos >= self.max_seq - 1:
                    r.done = True
                    r.finished_at = time.time()
                    finished.append(r)
                else:
                    still.append(r)
            if len(still) != len(live):
                keep = [i for i, r in enumerate(live) if not r.done]
                if keep:
                    idx = torch.as_tensor(keep, device=self.device)
                    batched = {name: t[:, idx] for name, t in batched.items()}
                live = still
        # Decode drained before every co-scheduled prefill ran.
        for r in to_backfill:
            self._backfill_one(r)
        self.stats["decode_compiles"] = len(self._decode_sizes)
        return max_steps - budget

    def run(self, max_steps: int = 512) -> List[Completion]:
        """Serve everything in the queue (greedy decoding); one
        :class:`~repro_torch.serve.api.Completion` per finished
        request."""
        finished: List[Request] = []
        while (self.queue or self._backfilled) and max_steps > 0:
            max_steps -= self.step(finished, max_steps)
        finished.extend(self._cancelled)   # cancelled with no step after
        self._cancelled.clear()
        return [completion_of(r) for r in finished]
