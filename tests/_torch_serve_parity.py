"""Shared pieces of the port's engine-parity tests (not collected).

Smoke configs in float32 go through ``repro.serve.make_engine`` and
``repro_torch.serve.make_engine(device="cpu")`` of the same kind on the
same weights (``params_from_jax``).  Engines are built once per
(config, kind, options) and ``reset()`` between workloads; the JAX and
the port engine of a key are built together and always run the same
workloads in the same order, so even their compile counters agree.
"""
import jax
import numpy as np

from repro.configs import smoke_config
from repro.models import init_params as jax_init
from repro.serve import completion_of as jax_completion_of
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro.serve import validate_stats as jax_validate_stats
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.serve import completion_of, make_engine, Request
from repro_torch.serve import validate_stats

NAMES = ("qwen2.5-0.5b", "phi3.5-moe-42b")
OPTS = dict(max_slots=4, max_seq=64, window=4)
PAGE_SIZE = 8
# (prompt length, max_new_tokens), the workload of test_torch_serve.py;
# rid 1 extends rid 0's first 16 tokens.
WORKLOAD = [(17, 6), (20, 5), (7, 3), (9, 6), (1, 4), (15, 7)]
# test_serve_differential.py's prompt lengths: page boundaries (8) +-1.
LENS = (1, 2, 3, 5, 6, 7, 8, 9, 10, 12, 14, 15, 16, 17, 20, 23)
# The port's co-execution backend beside the reference's.
COEXEC = {None: None, "kernel": "xla"}
SHARED_TOP = ("batches", "decode_steps", "packed_prefills", "backfilled")
SHARED_ENGINE = ("windows", "rungs", "slot_admits", "slot_releases",
                 "prefill_bucket_hits", "prefill_bucket_misses",
                 "prefill_bucket_fallbacks", "prefill_batches",
                 "prefill_batched_reqs", "preemptions", "cancelled",
                 "remeshes")

_SETUPS = {}
_ENGINES = {}


def setup(name):
    """(JAX cfg, port cfg, JAX params, port params) of a smoke config."""
    if name not in _SETUPS:
        cfg = smoke_config(name)
        jparams = jax_init(cfg, jax.random.PRNGKey(0))
        tcfg = torch_smoke_config(name)
        _SETUPS[name] = (cfg, tcfg, jparams, params_from_jax(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    return _SETUPS[name]


def engines(name, kind, coexec=None, **kw):
    """The (JAX, port) engine pair of a key, built once."""
    key = (name, kind, coexec, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        cfg, tcfg, jparams, tparams = setup(name)
        opts = dict(OPTS, **kw)
        if kind == "paged":
            opts.setdefault("page_size", PAGE_SIZE)
        _ENGINES[key] = (
            jax_make_engine(cfg, jparams, kind=kind,
                            coexec_backend=COEXEC[coexec], **opts),
            make_engine(tcfg, tparams, kind=kind, device="cpu",
                        coexec_backend=coexec, **opts))
    return _ENGINES[key]


def prompts_of(work, vocab, seed=0, share=False):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n, dtype=np.int32) for n, _ in work]
    if share:
        prompts[1][:16] = prompts[0][:16]
    return prompts


def workload(seed, vocab):
    """A fixed-seed mixed-length workload drawn as the differential
    harness draws them: 1-6 requests, lengths from LENS, budgets 1-7."""
    rng = np.random.default_rng(seed)
    work = [(int(rng.choice(LENS)), int(rng.integers(1, 8)))
            for _ in range(int(rng.integers(1, 7)))]
    return work, prompts_of(work, vocab, seed)


def submit(eng, request_cls, work, prompts, klass=None, enc=None):
    """Submit the workload; ``enc``, if given, holds each request's
    encoder features (an enc-dec model's ``enc_embeds``, or None)."""
    for rid, (prompt, (_, budget)) in enumerate(zip(prompts, work)):
        eng.submit(request_cls(rid=rid, prompt=prompt.copy(),
                               max_new_tokens=budget,
                               klass=klass[rid] if klass else None,
                               enc_embeds=None if enc is None else enc[rid]))


def completion(req):
    """A finished request's ``Completion``, built by its own package."""
    return (completion_of(req) if isinstance(req, Request)
            else jax_completion_of(req))


def serve(eng, request_cls, work, prompts, **kw):
    """Reset ``eng``, serve the workload, completions sorted by rid."""
    eng.reset()
    submit(eng, request_cls, work, prompts, **kw)
    return sorted(eng.run(max_steps=4096), key=lambda c: c.rid)


def serve_both(jeng, teng, work, prompts, **kw):
    return (serve(jeng, JaxRequest, work, prompts, **kw),
            serve(teng, Request, work, prompts, **kw))


def check_parity(jeng, jout, teng, tout):
    """Identical completions (tokens and finish reasons), the shared
    stats schema on both sides, and every shared stat equal."""
    assert [(c.rid, c.tokens, c.finish_reason) for c in tout] == \
        [(c.rid, c.tokens, c.finish_reason) for c in jout]
    jax_validate_stats(jeng.stats)
    validate_stats(teng.stats)
    for key in SHARED_TOP:
        assert teng.stats[key] == jeng.stats[key], key
    jext, text = jeng.stats["engine"], teng.stats["engine"]
    for key in SHARED_ENGINE:
        if key in jext:
            assert text[key] == jext[key], key
