"""The port's slot engine (dense slot cache) against the JAX slot engine
on the CPU, in float32.

``make_engine(kind="slot")`` of both packages on the same smoke weights
(``qwen2.5-0.5b``, and ``phi3.5-moe-42b`` whose MoE routing couples the
rows of a window): identical ``Completion`` tokens and finish reasons,
and equal shared stats (``_torch_serve_parity.SHARED_*``), on the
paged tests' workload and on fixed-seed workloads drawn from the
differential harness's prompt lengths; with and without
``coexec_backend``; under a preemption storm, an interactive admission
that preempts, and a cancel.  The coalesced prefill (``prefill_batch``)
is held to the reference's counters and completions and to the port's
own single prefills (first tokens identical, parked caches within
1e-5), on the slot and the paged engine; ``warmup()`` leaves
``decode_compiles`` at 0; the port's slot and paged engines agree.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_serve_parity import (check_parity, completion, engines, NAMES,
                                 OPTS, PAGE_SIZE, prompts_of, serve,
                                 serve_both, setup, submit, workload,
                                 WORKLOAD)
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro_torch.models import attention as tattn
from repro_torch.serve import make_engine, Request

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5


def _slots_drained(teng, work, preemptions=0):
    ext = teng.stats["engine"]
    assert ext["slot_admits"] == ext["slot_releases"] \
        == len(work) + preemptions
    assert teng.cache.n_free == teng.max_batch


@pytest.mark.parametrize("coexec", [None, "kernel"])
@pytest.mark.parametrize("name", NAMES)
def test_slot_engine_matches_jax(name, coexec):
    jeng, teng = engines(name, "slot", coexec)
    prompts = prompts_of(WORKLOAD, setup(name)[1].vocab_size, share=True)
    jout, tout = serve_both(jeng, teng, WORKLOAD, prompts)
    check_parity(jeng, jout, teng, tout)
    assert all(c.n_tokens == b for c, (_, b) in zip(tout, WORKLOAD))
    _slots_drained(teng, WORKLOAD)
    assert teng.cache.resident_bytes() == sum(
        x.nbytes for x in jax.tree.leaves(jeng.cache.buffers))
    if coexec:
        assert teng.stats["backfilled"] > 0


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_slot_engine_matches_jax_on_differential_workloads(seed):
    name = "qwen2.5-0.5b"
    work, prompts = workload(seed, setup(name)[1].vocab_size)
    jeng, teng = engines(name, "slot")
    jout, tout = serve_both(jeng, teng, work, prompts)
    check_parity(jeng, jout, teng, tout)
    _slots_drained(teng, work)


# Prompts near max_seq (64): the window stops a row at pos >= max_seq - 1
# (finish_reason "max_seq"), as the reference's window does.
NEAR_MAX_SEQ = [(60, 10), (5, 4), (58, 9), (63, 3), (64, 2)]


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_max_seq_stop_matches_jax(kind):
    name = "qwen2.5-0.5b"
    jeng, teng = engines(name, kind)
    prompts = prompts_of(NEAR_MAX_SEQ, setup(name)[1].vocab_size, seed=9)
    jout, tout = serve_both(jeng, teng, NEAR_MAX_SEQ, prompts)
    check_parity(jeng, jout, teng, tout)
    assert [c.finish_reason for c in tout].count("max_seq") == 3
    _slots_drained(teng, NEAR_MAX_SEQ)


def _storm(eng, request_cls, work, prompts):
    """Serve with a storm of two forced preemptions after the first
    window; completions sorted by rid."""
    eng.reset()
    submit(eng, request_cls, work, prompts)
    finished = []
    eng.step(finished)
    assert eng.preempt(2) == 2
    return sorted(eng.run(max_steps=4096)
                  + [completion(r) for r in finished], key=lambda c: c.rid)


@pytest.mark.parametrize("name", NAMES)
def test_preemption_and_cancel_match_jax(name):
    """A forced storm resumes token-identically (re-prefill of prompt +
    generated[:-1]); an interactive arrival overtakes queued batch
    requests; a cancel releases its slot at once.  Each as the JAX
    engine does, stats included."""
    jeng, teng = engines(name, "slot")
    vocab = setup(name)[1].vocab_size
    prompts = prompts_of(WORKLOAD, vocab, share=True)
    jout = _storm(jeng, JaxRequest, WORKLOAD, prompts)
    tout = _storm(teng, Request, WORKLOAD, prompts)
    check_parity(jeng, jout, teng, tout)
    assert teng.stats["engine"]["preemptions"] == 2
    _slots_drained(teng, WORKLOAD, preemptions=2)

    # Every slot taken and two batch requests queued: an interactive
    # arrival is admitted ahead of them at the next free slot.
    work = [(12, 9), (10, 13), (9, 17), (14, 21), (11, 6), (13, 6), (5, 6)]
    prompts = prompts_of(work, vocab, seed=7)
    outs = []
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        eng.reset()
        submit(eng, req_cls, work[:6], prompts[:6])
        finished = []
        eng.step(finished)
        submit_one(eng, req_cls, 6, prompts[6], work[6][1], "interactive")
        out = eng.run(max_steps=4096)
        outs.append(sorted(out + [completion(r) for r in finished],
                           key=lambda c: c.rid))
    check_parity(jeng, outs[0], teng, outs[1])
    assert outs[1][6].ttft < min(c.ttft for c in outs[1][4:6])
    _slots_drained(teng, work)

    outs = []
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        eng.reset()
        submit(eng, req_cls, [(10, 30), (14, 30), (6, 30)],
               prompts_of([(10, 0), (14, 0), (6, 0)], vocab, seed=8))
        eng.step([])
        assert eng.cancel(0) and eng.cancel(2) and not eng.cancel(99)
        outs.append(sorted(eng.run(max_steps=4096), key=lambda c: c.rid))
    check_parity(jeng, outs[0], teng, outs[1])
    assert [c.finish_reason for c in outs[1]] == \
        ["cancelled", "length", "cancelled"]
    assert teng.cache.n_free == teng.max_batch


def submit_one(eng, request_cls, rid, prompt, budget, klass):
    eng.submit(request_cls(rid=rid, prompt=prompt.copy(),
                           max_new_tokens=budget, klass=klass))


# Buckets of 8 (slot: powers of two from 8; paged: page multiples):
# consecutive runs of one bucket coalesce, padded to a ladder rung.
BATCH_LENS = [9, 12, 16, 3, 7, 20, 30, 25, 13]


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_prefill_batch_matches_jax_and_single_prefills(kind):
    name = "qwen2.5-0.5b"
    jeng, teng = engines(name, kind)
    vocab = setup(name)[1].vocab_size
    work = [(n, 5) for n in BATCH_LENS]
    prompts = prompts_of(work, vocab, seed=11)
    reqs = {}
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        eng.reset()
        reqs[req_cls] = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=b)
                         for i, (p, (_, b)) in enumerate(zip(prompts, work))]
        for r in reqs[req_cls]:
            r.arrived = 0.0
        eng.prefill_batch(reqs[req_cls])
    ext, jext = teng.stats["engine"], jeng.stats["engine"]
    for key in ("prefill_batches", "prefill_batched_reqs",
                "prefill_bucket_hits", "prefill_bucket_misses"):
        assert ext[key] == jext[key], key
    assert ext["prefill_batches"] >= 3 and ext["prefill_batched_reqs"] >= 7
    assert teng.stats["backfilled"] == jeng.stats["backfilled"]
    assert [r.generated for r in reqs[Request]] == \
        [r.generated for r in reqs[JaxRequest]]

    # Each parked row against the port's own single prefill, on an
    # engine of its own (the pair's bucket counters stay in step).
    kw = {"page_size": PAGE_SIZE} if kind == "paged" else {}
    lone = make_engine(setup(name)[1], setup(name)[3], kind=kind,
                       device="cpu", **OPTS, **kw)
    parked = {r.rid: (cache, pos) for r, cache, pos in teng._backfilled}
    for req in reqs[Request]:
        single = Request(rid=req.rid, prompt=req.prompt.copy(),
                         max_new_tokens=req.max_new_tokens)
        cache, pos = lone._prefill_one(single)
        assert single.generated == req.generated[:1]
        assert parked[req.rid][1] == pos
        for key, t in cache.items():
            assert parked[req.rid][0][key].shape == t.shape
            torch.testing.assert_close(parked[req.rid][0][key], t,
                                       rtol=TOL, atol=TOL)

    outs = [sorted(eng.run(max_steps=4096), key=lambda c: c.rid)
            for eng in (jeng, teng)]
    check_parity(jeng, outs[0], teng, outs[1])
    _slots_drained(teng, work)
    if kind == "paged":
        assert teng.cache.n_free_pages == teng.cache.num_pages


def test_prefill_batch_is_serial_for_moe():
    """MoE routing capacity couples a batch's rows, so coalescing is off
    and every request prefills alone, as in the reference."""
    name = "phi3.5-moe-42b"
    jeng, teng = engines(name, "slot")
    work = [(n, 4) for n in BATCH_LENS[:5]]
    prompts = prompts_of(work, setup(name)[1].vocab_size, seed=12)
    outs = []
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        eng.reset()
        eng.prefill_batch([req_cls(rid=i, prompt=p.copy(), max_new_tokens=b)
                           for i, (p, (_, b)) in enumerate(zip(prompts,
                                                               work))])
        outs.append(sorted(eng.run(max_steps=4096), key=lambda c: c.rid))
    check_parity(jeng, outs[0], teng, outs[1])
    assert teng.stats["engine"]["prefill_batches"] == 0
    assert teng.stats["backfilled"] == len(work)


def test_warmup_leaves_no_decode_compiles():
    """After ``warmup(max_prompt_len=16)`` the first serve runs no new
    rung (``decode_compiles`` 0) and counts prefill bucket hits and
    misses as the warmed-up JAX engine does."""
    name = "qwen2.5-0.5b"
    cfg, tcfg, jparams, tparams = setup(name)
    jeng = jax_make_engine(cfg, jparams, kind="slot", **OPTS)
    teng = make_engine(tcfg, tparams, kind="slot", device="cpu", **OPTS)
    for eng in (jeng, teng):
        eng.warmup(max_prompt_len=16)
        assert eng.stats["decode_compiles"] == 0
    assert teng.cache.n_free == teng.max_batch
    prompts = prompts_of(WORKLOAD, tcfg.vocab_size, share=True)
    jout, tout = (serve(jeng, JaxRequest, WORKLOAD, prompts),
                  serve(teng, Request, WORKLOAD, prompts))
    check_parity(jeng, jout, teng, tout)
    assert teng.stats["decode_compiles"] == 0 == jeng.stats["decode_compiles"]


@pytest.mark.parametrize("seed", [None, 6, 7])
def test_port_slot_engine_equals_port_paged_engine(seed):
    """Rows are independent in both storages, so dense slots and page
    pools give the same tokens on every workload."""
    name = "qwen2.5-0.5b"
    vocab = setup(name)[1].vocab_size
    if seed is None:
        work, prompts = WORKLOAD, prompts_of(WORKLOAD, vocab, share=True)
    else:
        work, prompts = workload(seed, vocab)
    outs = [[c.tokens for c in serve(engines(name, kind)[1], Request, work,
                                     prompts)]
            for kind in ("slot", "paged")]
    assert outs[0] == outs[1]
    assert len(outs[0]) == len(work)


def test_dense_int8_flag_serves_on_slots():
    """Under ``set_kv_cache_quant(True)`` the slot buffers hold int8
    values and bf16 scale planes; every request completes with in-
    vocabulary tokens and the slots drain."""
    _, tcfg, _, tparams = setup("qwen2.5-0.5b")
    tattn.set_kv_cache_quant(True)
    try:
        eng = make_engine(tcfg, tparams, kind="slot", device="cpu", **OPTS)
        prompts = prompts_of(WORKLOAD, tcfg.vocab_size, share=True)
        out = serve(eng, Request, WORKLOAD, prompts)
    finally:
        tattn.set_kv_cache_quant(False)
    assert {k: v.dtype for k, v in eng.cache.buffers.items()} == {
        "k": torch.int8, "v": torch.int8, "k_s": torch.bfloat16,
        "v_s": torch.bfloat16}
    assert [c.n_tokens for c in out] == [b for _, b in WORKLOAD]
    assert all(0 <= t < tcfg.vocab_size for c in out for t in c.tokens)
    _slots_drained(eng, WORKLOAD)
    assert np.isfinite(eng.cache.buffers["k_s"].float().numpy()).all()
