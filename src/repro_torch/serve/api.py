"""Serving API: one factory, one options record, one result contract,
one stats schema (the port of ``repro/serve/api.py``).

* :func:`make_engine` — the construction path.  ``kind`` selects the
  engine: ``"slot"`` (the default, dense slot cache), ``"paged"`` (page
  pools) or ``"sequential"`` (the baseline that decodes each admitted
  batch to completion).
* :class:`EngineOptions` — a frozen dataclass of engine knobs, the same
  fields as the reference's.
* :class:`Completion` — the result of serving one request.
* ``STATS_KEYS`` / :func:`validate_stats` — the stats schema every
  engine emits; engine-specific extras live under ``stats["engine"]``.

Stats schema (all engines)::

    batches           list[int]  ladder-quantized target per admission
    ttft              list[float]  seconds from submit to first token
    decode_steps      int        decode iterations executed
    decode_compiles   int|None   first windows run per rung since warmup
                                 (0 in steady state after ``warmup()``)
    packed_speedup    list[float]  predicted step speedup (multi-tenant)
    packed_prefills   int        prefills co-scheduled by the packer
    backfilled        int        prefills executed inside decode windows
    coexec_tiles      list[int]  fused grid-task counts per step
    coexec_interleave list[int]  tenant switches in each task order
    coexec_backend    str|None   requested co-execution backend
    expert_backend    str|None   MoE expert GEMM lowering in effect
                                 ("kernel": K4; None for dense models)
    engine            dict       engine-specific extras
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch import resolve_device

ENGINE_KINDS = ("sequential", "slot", "paged")

#: The shared stats schema — every engine's ``stats`` dict has exactly
#: these keys (engine-specific extras live under ``stats["engine"]``).
STATS_KEYS = frozenset({
    "batches", "ttft", "decode_steps", "decode_compiles",
    "packed_speedup", "packed_prefills", "backfilled",
    "coexec_tiles", "coexec_interleave", "coexec_backend",
    "expert_backend", "engine",
})

FINISH_LENGTH = "length"        # max_new_tokens budget exhausted
FINISH_MAX_SEQ = "max_seq"      # hit the engine's sequence capacity
FINISH_ABORTED = "aborted"      # shutdown(drain=False) tore it down
FINISH_CANCELLED = "cancelled"  # RequestHandle.cancel()/engine.cancel()
FINISH_DEADLINE = "deadline"    # per-request deadline expired


@dataclasses.dataclass(frozen=True)
class Completion:
    """Result of serving one request.

    ``tokens`` is the full greedy stream (prefill's first token
    included); ``ttft`` is seconds from submission to the first token;
    ``tpot`` is mean seconds per subsequent token (window-granular: the
    host observes tokens once per window); ``finish_reason`` is one of
    ``"length"`` (budget exhausted), ``"max_seq"`` (sequence capacity),
    ``"aborted"`` (abortive shutdown), ``"cancelled"`` or ``"deadline"``
    (the frontend's lifecycle exits).
    """
    rid: int
    tokens: Tuple[int, ...]
    ttft: float
    tpot: float
    finish_reason: str

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


def completion_of(req) -> Completion:
    """Build a :class:`Completion` from a finished engine ``Request``."""
    n = len(req.generated)
    first = req.first_token_at if req.first_token_at is not None else 0.0
    done_at = req.finished_at if req.finished_at is not None else first
    ttft = max(0.0, first - req.arrived) if req.first_token_at else 0.0
    tpot = (done_at - first) / (n - 1) if n > 1 else 0.0
    reason = req.finish_reason or (
        FINISH_LENGTH if n >= req.max_new_tokens else FINISH_MAX_SEQ)
    return Completion(rid=req.rid, tokens=tuple(req.generated),
                      ttft=ttft, tpot=max(0.0, tpot), finish_reason=reason)


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Every serving-engine knob, in one frozen record (the reference's
    fields).  ``expert_backend`` is None or ``"kernel"`` (MoE experts
    always run on K4); ``coexec_backend`` is None or ``"kernel"`` (the
    packer's co-scheduled prefills run as backfill at window
    boundaries); ``kv_quant`` is None or ``"int8"``."""
    max_slots: int = 8
    max_seq: int = 256
    window: int = 8
    ladder: Optional[Tuple[int, ...]] = None
    buckets: str = "auto"
    page_size: int = 16
    num_pages: Optional[int] = None
    kv_quant: Optional[str] = None
    prefix_sharing: bool = True
    multi_tenant: bool = True
    coexec_backend: Optional[str] = None
    expert_backend: Optional[str] = None
    policy: Optional[Any] = None
    default_klass: str = "batch"

    def __post_init__(self):
        if self.buckets not in ("auto", "off"):
            raise ValueError(f"buckets={self.buckets!r} not in "
                             "('auto', 'off')")
        if self.expert_backend not in (None, "kernel"):
            raise ValueError(f"expert_backend={self.expert_backend!r}: the "
                             "port has only 'kernel' (K4 on the card, its "
                             "plain version on the CPU)")
        from repro_torch.serve.policy import KLASSES, SchedulingPolicy
        if self.default_klass not in KLASSES:
            raise ValueError(f"default_klass={self.default_klass!r} "
                             f"not in {KLASSES}")
        if self.policy is not None \
                and not isinstance(self.policy, SchedulingPolicy):
            raise ValueError(f"policy={self.policy!r} is not a "
                             "SchedulingPolicy")
        if self.ladder is not None:
            rungs = tuple(self.ladder)
            if not rungs or list(rungs) != sorted(set(rungs)) \
                    or rungs[0] < 1:
                raise ValueError(f"ladder {rungs} must be a strictly "
                                 "increasing tuple of positive rungs")
            object.__setattr__(self, "ladder", rungs)


def make_engine(cfg, params, kind: str = "slot",
                options: Optional[EngineOptions] = None, *,
                device=None, **overrides):
    """Build a serving engine on ``device`` (None: the CUDA card; raises
    when there is none).  ``options`` plus keyword ``overrides`` of its
    fields carry the knobs; ``params`` must already live on ``device``.
    Paged-only knobs (``page_size``, ``num_pages``, ``kv_quant``,
    ``prefix_sharing``) are ignored by the dense kinds, and ``window``,
    ``ladder`` and ``buckets`` by the sequential one.

        eng = make_engine(cfg, params, kind="paged",
                          options=EngineOptions(max_slots=8))
    """
    from repro_torch.models.transformer import param_device
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.paged_engine import PagedServeEngine
    from repro_torch.serve.slot_engine import SlotServeEngine

    if kind not in ENGINE_KINDS:
        raise ValueError(f"kind={kind!r} not in {ENGINE_KINDS}")
    opts = dataclasses.replace(options or EngineOptions(), **overrides)
    dev = resolve_device(device)
    if param_device(params) != dev and not (
            dev.type == "cuda" and param_device(params).type == "cuda"
            and dev.index is None):
        raise ValueError(f"params live on {param_device(params)}, "
                         f"engine device is {dev}")
    common = dict(device=param_device(params), max_batch=opts.max_slots,
                  max_seq=opts.max_seq, multi_tenant=opts.multi_tenant,
                  coexec_backend=opts.coexec_backend, policy=opts.policy,
                  default_klass=opts.default_klass)
    if kind == "sequential":
        return ServeEngine(cfg, params, **common)  # api-ok
    common.update(window=opts.window, ladder=opts.ladder,
                  prefill_bucketing=opts.buckets != "off")
    if kind == "slot":
        return SlotServeEngine(cfg, params, **common)  # api-ok
    return PagedServeEngine(  # api-ok
        cfg, params, page_size=opts.page_size, num_pages=opts.num_pages,
        kv_quant=opts.kv_quant, prefix_sharing=opts.prefix_sharing,
        **common)


def validate_stats(stats: Dict[str, Any]) -> None:
    """Assert ``stats`` matches the shared schema: exactly
    ``STATS_KEYS`` at the top level, extras (a dict) under
    ``stats["engine"]``."""
    keys = set(stats)
    missing, extra = STATS_KEYS - keys, keys - STATS_KEYS
    assert not missing, f"stats missing shared keys: {sorted(missing)}"
    assert not extra, (f"stats carries non-schema top-level keys "
                       f"{sorted(extra)} — namespace them under "
                       f"stats['engine']")
    assert isinstance(stats["engine"], dict), "stats['engine'] not a dict"
