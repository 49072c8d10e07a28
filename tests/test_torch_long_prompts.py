"""Prompts longer than a cache's capacity, on the slot and sequential
engines, against the JAX engines on the CPU, in float32.

A dense cache is a ring (``prefill_into_cache``): a prompt longer than
``max_seq`` keeps its last ``max_seq`` positions in every global layer,
laid by the per-row gather at its last token (the slot engine's
exact-length fallback) or rolled (the sequential engine's exact-length
prefill), and a sliding-window layer keeps its last ``min(max_seq,
window)`` whatever the prompt.

* **Long prompts on global-attention models** (yi-6b and phi3.5-moe-42b
  smoke configs, ``max_seq=64``): prompts of 63, 64, 70 and 200 tokens
  alone and together through ``make_engine(kind="slot")`` and
  ``kind="sequential"``, offline and through ``ServeFrontend``, give the
  JAX engine's completions (tokens and finish reasons) and shared stats;
  every frontend handle resolves, also in the case where a prompt past
  ``max_seq`` once ended the scheduler thread.
* **gemma3-1b** (smoke: 12 layers, 5 LOCAL : 1 ATTN, window 16): the
  slot and sequential engines pass ``check_parity`` against the JAX
  engines at prompt lengths around the window (1-33) and around
  ``max_seq`` (63-200), with ``prefill_batch`` (every coalesced row also
  against its own single prefill within ``TOL``), with the int8 dense
  cache, and through ``ServeFrontend`` over slot.
* **What stays as it was**: global-only models keep their cache names
  and shapes.  (The other architectures serve on every engine: whisper
  in ``tests/test_torch_enc_dec_serve.py`` and
  ``tests/test_torch_enc_dec_paged.py``, the recurrent models in
  ``tests/test_torch_recurrent_serve.py``, internvl2-76b on tokens in
  ``tests/test_torch_vision_frontend.py``, gemma3 on the paged engine
  in ``tests/test_torch_local_rings.py``.)
"""
import numpy as np
import pytest
import torch

from _torch_serve_parity import (check_parity, engines, OPTS, prompts_of,
                                 serve, serve_both, setup)
from _torch_frontend import hold, WAIT
from repro.models import attention as jattn
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro_torch.models import attention as tattn
from repro_torch.models import forward_prefill, init_cache
from repro_torch.models.transformer import cache_layout
from repro_torch.serve import make_engine, Request, ServeFrontend

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5
GEMMA = "gemma3-1b"
C1_NAMES = ("yi-6b", "phi3.5-moe-42b")
LONG = (63, 64, 70, 200)
# (prompt length, max_new_tokens): around gemma3's window of 16 (decode
# carries the shorter rows across it), and around max_seq = 64.
WINDOW_WORK = [(1, 6), (7, 12), (15, 6), (16, 5), (17, 8), (23, 4),
               (31, 7), (33, 5)]
MAX_SEQ_WORK = [(63, 3), (64, 2), (70, 3), (200, 2), (5, 6)]
WORKS = {"window": WINDOW_WORK, "max_seq": MAX_SEQ_WORK}
# Both edges in one workload, for the int8 engines (built afresh).
EDGE_WORK = [(7, 12), (15, 6), (17, 8), (33, 5), (63, 3), (70, 3), (200, 2)]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture
def frontends():
    """Every ``ServeFrontend`` a test makes, shut down after it, pass or
    fail."""
    made = []
    yield lambda eng: made.append(ServeFrontend(eng)) or made[-1]
    while made:
        made.pop().shutdown(drain=False)


def _drained(teng, n, kind):
    if kind == "slot":
        ext = teng.stats["engine"]
        assert ext["slot_admits"] == ext["slot_releases"] == n
        assert teng.cache.n_free == teng.max_batch


# --------------------------------------------------------------------------
# Long prompts on global-attention models
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", LONG)
@pytest.mark.parametrize("kind", ["slot", "sequential"])
@pytest.mark.parametrize("name", C1_NAMES)
def test_a_long_prompt_alone_matches_jax(name, kind, n):
    jeng, teng = engines(name, kind)
    work = [(n, 4)]
    prompts = prompts_of(work, setup(name)[1].vocab_size, seed=n)
    jout, tout = serve_both(jeng, teng, work, prompts)
    check_parity(jeng, jout, teng, tout)
    # The first token, then one decode step at most: position 62 is the
    # last max_seq leaves to write.
    assert tout[0].n_tokens == 2
    assert tout[0].finish_reason == "max_seq"
    _drained(teng, 1, kind)


@pytest.mark.parametrize("kind", ["slot", "sequential"])
@pytest.mark.parametrize("name", C1_NAMES)
def test_long_prompts_mixed_with_short_ones_match_jax(name, kind):
    jeng, teng = engines(name, kind)
    work = [(63, 3), (5, 7), (64, 2), (70, 3), (200, 5), (12, 4)]
    prompts = prompts_of(work, setup(name)[1].vocab_size, seed=21)
    jout, tout = serve_both(jeng, teng, work, prompts)
    check_parity(jeng, jout, teng, tout)
    if kind == "slot":
        assert teng.stats["engine"]["prefill_bucket_fallbacks"] == 2
    _drained(teng, len(work), kind)


def _online(fe, prompts, budgets, parked=True):
    """Submit every request while the scheduler is parked (so the
    engine sees them all at its first cycle, as the offline serve
    does), then drain; rid -> completion."""
    reached, release = hold(fe) if parked else (None, None)
    handles = [fe.submit(p, b, rid=i)
               for i, (p, b) in enumerate(zip(prompts, budgets))]
    if parked:
        assert reached.wait(WAIT)
        release.set()
    done = {c.rid: c for c in fe.drain(timeout=WAIT)}
    for h in handles:
        assert h.done
        assert tuple(h.tokens) == done[h.rid].tokens
    return done


@pytest.mark.parametrize("kind", ["slot", "sequential"])
@pytest.mark.parametrize("name", C1_NAMES)
def test_long_prompts_through_the_frontend_match_jax(name, kind, frontends):
    work = [(n, 3) for n in LONG]
    _, tcfg, _, tparams = setup(name)
    prompts = prompts_of(work, tcfg.vocab_size, seed=5)
    jeng, _ = engines(name, kind)
    want = serve(jeng, JaxRequest, work, prompts)
    fe = frontends(make_engine(tcfg, tparams, kind=kind, device="cpu",
                               **OPTS))
    got = _online(fe, prompts, [b for _, b in work])
    assert [(c.rid, c.tokens, c.finish_reason) for c in want] == \
        [(r, got[r].tokens, got[r].finish_reason) for r in sorted(got)]
    assert fe._scheduler_t.is_alive()


def test_the_scheduler_survives_a_prompt_past_max_seq(frontends):
    """yi-6b through ``ServeFrontend`` over slot, prompts of 10, 70 and
    12 tokens arriving while the scheduler runs: the 70-token prefill
    once raised in the scheduler thread, which ended it and left every
    handle to time out.  Now every handle resolves, with the JAX
    engine's tokens."""
    name = "yi-6b"
    _, tcfg, _, tparams = setup(name)
    work = [(10, 3), (70, 3), (12, 3)]
    prompts = prompts_of(work, tcfg.vocab_size, seed=1)
    jeng, _ = engines(name, "slot")
    want = {c.rid: c.tokens for c in serve(jeng, JaxRequest, work, prompts)}
    fe = frontends(make_engine(tcfg, tparams, kind="slot", device="cpu",
                               **OPTS))
    got = _online(fe, prompts, [b for _, b in work], parked=False)
    assert {r: c.tokens for r, c in got.items()} == want
    assert [got[r].finish_reason for r in range(3)] == \
        ["length", "max_seq", "length"]
    assert fe._scheduler_t.is_alive()


# --------------------------------------------------------------------------
# gemma3-1b: sliding-window layers through the slot and sequential engines
# --------------------------------------------------------------------------
@pytest.mark.parametrize("work", sorted(WORKS))
@pytest.mark.parametrize("kind", ["slot", "sequential"])
def test_gemma3_engines_match_jax(kind, work):
    jeng, teng = engines(GEMMA, kind)
    work = WORKS[work]
    prompts = prompts_of(work, setup(GEMMA)[1].vocab_size, seed=2)
    jout, tout = serve_both(jeng, teng, work, prompts)
    check_parity(jeng, jout, teng, tout)
    _drained(teng, len(work), kind)
    if kind == "slot":
        # Ten local layers at 16 cells, two global ones at 64.
        bufs = teng.cache.buffers
        assert bufs["wk"].shape[:3] == (10, OPTS["max_slots"], 16)
        assert bufs["k"].shape[:3] == (2, OPTS["max_slots"], 64)
        assert teng.cache.resident_bytes() == sum(
            np.asarray(x).nbytes for group in jeng.cache.buffers
            for block in group.values() for x in block.values())


@pytest.mark.parametrize("work", sorted(WORKS))
def test_gemma3_prefill_batch_matches_jax_and_single_prefills(work):
    """Coalesced prefills (``last_index`` a vector: each row's local
    rings laid by the per-row gather) park the rows and count buckets
    as the JAX engine does; every parked cache equals the port's own
    single prefill of its request within ``TOL``."""
    jeng, teng = engines(GEMMA, "slot")
    _, tcfg, _, tparams = setup(GEMMA)
    work = WORKS[work]
    prompts = prompts_of(work, tcfg.vocab_size, seed=3)
    reqs = {}
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        eng.reset()
        reqs[req_cls] = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=b)
                         for i, (p, (_, b)) in enumerate(zip(prompts, work))]
        eng.prefill_batch(reqs[req_cls])
    ext, jext = teng.stats["engine"], jeng.stats["engine"]
    for key in ("prefill_batches", "prefill_batched_reqs",
                "prefill_bucket_hits", "prefill_bucket_misses",
                "prefill_bucket_fallbacks"):
        assert ext[key] == jext[key], key
    assert ext["prefill_batches"] >= 1
    assert [r.generated for r in reqs[Request]] == \
        [r.generated for r in reqs[JaxRequest]]
    lone = make_engine(tcfg, tparams, kind="slot", device="cpu", **OPTS)
    parked = {r.rid: cache for r, cache, _ in teng._backfilled}
    for req in reqs[Request]:
        single = Request(rid=req.rid, prompt=req.prompt.copy(),
                         max_new_tokens=req.max_new_tokens)
        cache, _ = lone._prefill_one(single)
        assert single.generated == req.generated[:1]
        assert set(parked[req.rid]) == set(cache) == {"k", "v", "wk", "wv"}
        for key, t in cache.items():
            torch.testing.assert_close(parked[req.rid][key], t, rtol=TOL,
                                       atol=TOL)
    outs = [sorted(eng.run(max_steps=4096), key=lambda c: c.rid)
            for eng in (jeng, teng)]
    check_parity(jeng, outs[0], teng, outs[1])
    _drained(teng, len(work), "slot")


@pytest.mark.parametrize("kind", ["slot", "sequential"])
def test_gemma3_int8_cache_matches_jax(kind):
    """Under ``set_kv_cache_quant(True)`` in both packages (engines
    built with the flag on): int8 rings with bf16 scale planes for both
    layer classes, and the JAX engine's completions on prompts across
    the window and across ``max_seq``."""
    cfg, tcfg, jparams, tparams = setup(GEMMA)
    jattn.set_kv_cache_quant(True)
    tattn.set_kv_cache_quant(True)
    try:
        jeng = jax_make_engine(cfg, jparams, kind=kind, **OPTS)
        teng = make_engine(tcfg, tparams, kind=kind, device="cpu", **OPTS)
        prompts = prompts_of(EDGE_WORK, tcfg.vocab_size, seed=4)
        jout, tout = serve_both(jeng, teng, EDGE_WORK, prompts)
        check_parity(jeng, jout, teng, tout)
        _drained(teng, len(EDGE_WORK), kind)
    finally:
        jattn.set_kv_cache_quant(False)
        tattn.set_kv_cache_quant(False)
    if kind == "slot":
        assert {k: v.dtype for k, v in teng.cache.buffers.items()} == {
            "k": torch.int8, "v": torch.int8, "k_s": torch.bfloat16,
            "v_s": torch.bfloat16, "wk": torch.int8, "wv": torch.int8,
            "wk_s": torch.bfloat16, "wv_s": torch.bfloat16}


def test_gemma3_frontend_over_slot_matches_jax(frontends):
    """Both workloads at once through ``ServeFrontend`` over slot,
    submitted while the scheduler runs: every stream equals the JAX
    engine's offline serve (slot rows are independent, so arrival
    timing cannot change a token)."""
    _, tcfg, _, tparams = setup(GEMMA)
    work = WINDOW_WORK + MAX_SEQ_WORK
    prompts = prompts_of(work, tcfg.vocab_size, seed=6)
    jeng, _ = engines(GEMMA, "slot")
    want = serve(jeng, JaxRequest, work, prompts)
    eng = make_engine(tcfg, tparams, kind="slot", device="cpu", **OPTS)
    fe = frontends(eng)
    fe.warmup()
    got = _online(fe, prompts, [b for _, b in work], parked=False)
    assert [(c.rid, c.tokens, c.finish_reason) for c in want] == \
        [(r, got[r].tokens, got[r].finish_reason) for r in sorted(got)]
    assert fe.stats["decode_compiles"] == 0
    assert eng.cache.n_free == eng.max_batch


# --------------------------------------------------------------------------
# What stays as it was
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen2.5-0.5b", "yi-6b", "phi3.5-moe-42b"])
def test_global_only_models_keep_their_cache_names_and_shapes(name):
    _, tcfg, _, tparams = setup(name)
    assert cache_layout(tcfg) == [("", i) for i in range(tcfg.n_layers)]
    shape = (tcfg.n_layers, 2, 24, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    cache = init_cache(tcfg, 2, 24, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {"k": shape, "v": shape}
    toks = torch.zeros((2, 30), dtype=torch.int32)
    _, cache = forward_prefill(tparams, tcfg, {"tokens": toks}, cache_len=24)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {"k": shape, "v": shape}
