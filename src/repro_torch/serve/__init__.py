"""Serving for the port: the slot, paged and sequential engines behind
``make_engine``."""
from repro_torch.serve.api import (Completion, completion_of, EngineOptions,
                                   make_engine, STATS_KEYS, validate_stats)
from repro_torch.serve.engine import (choose_decode_batch, effective_tokens,
                                      Request, ServeEngine)
from repro_torch.serve.paged_engine import PagedKVCache, PagedServeEngine
from repro_torch.serve.policy import (KLASS_BATCH, KLASS_INTERACTIVE, KLASSES,
                                      RejectedError, SchedulingPolicy)
from repro_torch.serve.serve_step import (make_bucketed_prefill_step,
                                          make_decode_step,
                                          make_paged_decode_step,
                                          make_prefill_step)
from repro_torch.serve.slot_engine import SlotKVCache, SlotServeEngine

__all__ = ["Completion", "completion_of", "effective_tokens",
           "EngineOptions", "KLASS_BATCH", "KLASS_INTERACTIVE", "KLASSES",
           "make_bucketed_prefill_step", "make_decode_step", "make_engine",
           "make_paged_decode_step", "make_prefill_step", "PagedKVCache",
           "PagedServeEngine", "RejectedError", "Request",
           "SchedulingPolicy", "ServeEngine", "SlotKVCache",
           "SlotServeEngine", "STATS_KEYS", "choose_decode_batch",
           "validate_stats"]
