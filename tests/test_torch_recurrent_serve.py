"""Recurrent models through the port's three engines, against the JAX
engine of the same kind on the CPU, in float32 with TF32 off:
``smoke_config("recurrentgemma-2b")`` (RG-LRU and sliding-window
layers, window 16) and ``smoke_config("rwkv6-3b")`` (WKV layers), 4
slots, ``max_seq`` 64, windows of 4 tokens, pages of 8.

* Every kind passes ``check_parity`` (tokens, finish reasons, shared
  stats) on prompts around the window (8 requests on 4 slots, so slots
  are reused after release) and across ``max_seq`` (past it too, where
  the exact-length prefill lays the state); the slot buffers' and the
  paged storage's bytes and the paged extras equal the JAX engine's.
* Decode carries the state: after each window the slot's state rows
  equal the JAX engine's, so a window continues from the last one's
  state and not from the prefill's.
* ``prefill_batch``, a preemption storm with resume, int8 pools (no byte
  to quantize: the same bytes as float pools), the dense
  ``CACHE_QUANT`` flag (the states stay at model precision), and one
  ``ServeFrontend`` run a model against the JAX offline ``run()``.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_frontend import drained, hold, WAIT
from _torch_serve_parity import (check_parity, completion, engines, OPTS,
                                 prompts_of, serve, serve_both, setup,
                                 submit)
from repro.models import attention as jattn
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro_torch.convert import cache_from_jax, pools_from_jax
from repro_torch.models import attention as tattn
from repro_torch.serve import make_engine, Request, ServeFrontend

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5
WKV_TOL = 1e-4          # tests/test_torch_recurrent.py
RG, RWKV = "recurrentgemma-2b", "rwkv6-3b"
NAMES = (RG, RWKV)
KINDS = ("slot", "sequential", "paged")
# (prompt length, max_new_tokens): around recurrentgemma's window of 16
# (8 requests on 4 slots), and across max_seq = 64 (70 takes the
# exact-length prefill; every kind serves it on models with no global
# layer, whose storage has no page table).
WINDOW_WORK = [(1, 6), (7, 12), (15, 6), (16, 5), (17, 8), (23, 4),
               (31, 7), (33, 5)]
MAX_SEQ_WORK = [(63, 3), (64, 2), (70, 3), (5, 6), (40, 30)]
WORKS = {"window": WINDOW_WORK, "max_seq": MAX_SEQ_WORK}
PAGED_EXTRAS = ("page_admits", "page_grows", "pages_mapped_peak",
                "pages_shared", "window_pages_reclaimed", "local_ring_pages")
STATES = {RG: ("h", "conv"), RWKV: ("state", "shift")}


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _jax_bytes(jeng):
    if hasattr(jeng.cache, "resident_bytes"):
        return jeng.cache.resident_bytes()
    return sum(x.nbytes for x in jax.tree.leaves(jeng.cache.buffers))


def _check_storage(jeng, teng, kind, n_admits):
    """Slot and paged: every slot back, the bytes of the JAX engine's
    storage; paged: its extras, no page reserved or held, every ring
    back."""
    if kind == "sequential":
        return
    ext = teng.stats["engine"]
    assert ext["slot_admits"] == ext["slot_releases"] == n_admits
    assert teng.cache.n_free == teng.max_batch
    assert teng.cache.resident_bytes() == _jax_bytes(jeng)
    if kind == "paged":
        for key in PAGED_EXTRAS:
            assert ext[key] == jeng.stats["engine"][key], key
        c = teng.cache
        assert drained(teng) and c.n_free_local == c.num_local_pages
        assert ext["page_admits"] == ext["page_grows"] == 0


@pytest.mark.parametrize("work", sorted(WORKS))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
def test_engines_match_jax(name, kind, work):
    jeng, teng = engines(name, kind)
    work = WORKS[work]
    prompts = prompts_of(work, setup(name)[1].vocab_size, seed=2)
    jout, tout = serve_both(jeng, teng, work, prompts)
    check_parity(jeng, jout, teng, tout)
    _check_storage(jeng, teng, kind, len(work))
    if kind == "slot":
        bufs, n = teng.cache.buffers, OPTS["max_slots"]
        if name == RG:
            assert bufs["h"].shape == (4, n, 64)
            assert bufs["conv"].shape == (4, n, 3, 64)
            assert bufs["wk"].shape[:3] == (2, n, 16)
        else:
            assert bufs["state"].shape == (2, n, 8, 8, 8)
            assert bufs["shift"].shape == (2, n, 64)
            assert set(bufs) == {"state", "shift"}


def _state_rows(eng, name, slot):
    """The recurrent states of ``slot`` (every layer) in the port's
    names, from either package's engine."""
    if type(eng.cache).__module__.startswith("repro_torch"):
        store = (eng.cache.pools if hasattr(eng.cache, "pools")
                 else eng.cache.buffers)
    elif hasattr(eng.cache, "pools"):
        store = pools_from_jax(jax.tree.map(np.asarray, eng.cache.pools),
                               setup(name)[1], device="cpu")
    else:
        store = cache_from_jax(jax.tree.map(np.asarray, eng.cache.buffers),
                               setup(name)[1], device="cpu")
    return {k: store[k][:, slot].clone() for k in STATES[name]}


@pytest.mark.parametrize("kind", ["slot", "paged"])
@pytest.mark.parametrize("name", NAMES)
def test_each_window_continues_from_the_last_windows_state(name, kind):
    """One request of 5 prompt tokens decoding 14, window by window:
    after every window the slot's state rows equal the JAX engine's and
    differ from the last window's, and the tokens are the JAX ones."""
    jeng, teng = engines(name, kind)
    prompt = np.arange(5, dtype=np.int32) + 3
    rows, toks = {}, {}
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        eng.reset()
        eng.submit(req_cls(rid=0, prompt=prompt.copy(), max_new_tokens=14))
        fin, trace = [], []
        while True:
            eng.step(fin)
            if fin:
                break
            trace.append(_state_rows(eng, name, 0))
        rows[req_cls], toks[req_cls] = trace, fin[0].generated
    assert toks[Request] == toks[JaxRequest] and len(toks[Request]) == 14
    assert len(rows[Request]) == len(rows[JaxRequest]) == 3
    tol = WKV_TOL if name == RWKV else TOL
    for i, (got, want) in enumerate(zip(rows[Request], rows[JaxRequest])):
        for k in got:
            torch.testing.assert_close(got[k], want[k], rtol=tol, atol=tol,
                                       msg=f"window {i} {k}")
    for a, b in zip(rows[Request], rows[Request][1:]):
        assert not torch.equal(a[STATES[name][0]], b[STATES[name][0]])


@pytest.mark.parametrize("kind", ["slot", "paged"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_batch_matches_jax(name, kind):
    """Coalesced prefills park the rows (their states taken at each
    row's real last token) and serve as the JAX engine's do."""
    jeng, teng = engines(name, kind)
    prompts = prompts_of(WINDOW_WORK, setup(name)[1].vocab_size, seed=3)
    reqs = {}
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        eng.reset()
        reqs[req_cls] = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=b)
                         for i, (p, (_, b)) in enumerate(
                             zip(prompts, WINDOW_WORK))]
        eng.prefill_batch(reqs[req_cls])
    ext, jext = teng.stats["engine"], jeng.stats["engine"]
    for key in ("prefill_batches", "prefill_batched_reqs",
                "prefill_bucket_hits", "prefill_bucket_misses"):
        assert ext[key] == jext[key], key
    assert ext["prefill_batches"] >= 1
    assert [r.generated for r in reqs[Request]] == \
        [r.generated for r in reqs[JaxRequest]]
    outs = [sorted(eng.run(max_steps=4096), key=lambda c: c.rid)
            for eng in (jeng, teng)]
    check_parity(jeng, outs[0], teng, outs[1])
    _check_storage(jeng, teng, kind, len(WINDOW_WORK))


def _storm(eng, request_cls, work, prompts):
    """Serve with two forced preemptions after the first window."""
    eng.reset()
    submit(eng, request_cls, work, prompts)
    finished = []
    eng.step(finished)
    assert eng.preempt(2) == 2
    return sorted(eng.run(max_steps=4096)
                  + [completion(r) for r in finished], key=lambda c: c.rid)


@pytest.mark.parametrize("kind", ["slot", "paged"])
@pytest.mark.parametrize("name", NAMES)
def test_preemption_resumes_as_in_jax(name, kind):
    """Two residents preempted after the first window re-prefill their
    prompt and generated tokens into a fresh state and resume
    token-identically; their released slots are reused at once."""
    jeng, teng = engines(name, kind)
    prompts = prompts_of(WINDOW_WORK, setup(name)[1].vocab_size, seed=4)
    jout = _storm(jeng, JaxRequest, WINDOW_WORK, prompts)
    tout = _storm(teng, Request, WINDOW_WORK, prompts)
    check_parity(jeng, jout, teng, tout)
    assert teng.stats["engine"]["preemptions"] == 2
    _check_storage(jeng, teng, kind, len(WINDOW_WORK) + 2)


@pytest.mark.parametrize("name", NAMES)
def test_int8_pools_hold_no_byte_to_quantize(name):
    """``kv_quant="int8"`` on a model with no global layer: slabs and
    rings stay at model precision, the storage's bytes are the float
    pools', and the tokens are the JAX int8 engine's."""
    jeng, teng = engines(name, "paged", kv_quant="int8")
    _, flt = engines(name, "paged")
    prompts = prompts_of(WINDOW_WORK, setup(name)[1].vocab_size, seed=5)
    jout, tout = serve_both(jeng, teng, WINDOW_WORK, prompts)
    check_parity(jeng, jout, teng, tout)
    _check_storage(jeng, teng, "paged", len(WINDOW_WORK))
    assert teng.stats["engine"]["kv_pool"] == "int8"
    assert teng.cache.resident_bytes() == flt.cache.resident_bytes()
    assert {k: v.dtype for k, v in teng.cache.pools.items()} == \
        {k: v.dtype for k, v in flt.cache.pools.items()}
    assert all(v.dtype != torch.int8 for v in teng.cache.pools.values())


@pytest.mark.parametrize("kind", ["slot", "sequential"])
@pytest.mark.parametrize("name", NAMES)
def test_cache_quant_flag_leaves_the_states_at_model_precision(name, kind):
    """The dense int8 flag on in both packages (engines built with it):
    recurrentgemma's local rings go int8 with scale planes, every state
    stays float32, and the tokens are the JAX engine's."""
    cfg, tcfg, jparams, tparams = setup(name)
    jattn.set_kv_cache_quant(True)
    tattn.set_kv_cache_quant(True)
    try:
        jeng = jax_make_engine(cfg, jparams, kind=kind, **OPTS)
        teng = make_engine(tcfg, tparams, kind=kind, device="cpu", **OPTS)
        work = [(7, 12), (17, 8), (33, 5), (63, 3), (70, 3)]
        prompts = prompts_of(work, tcfg.vocab_size, seed=6)
        jout, tout = serve_both(jeng, teng, work, prompts)
        check_parity(jeng, jout, teng, tout)
    finally:
        jattn.set_kv_cache_quant(False)
        tattn.set_kv_cache_quant(False)
    if kind == "slot":
        dtypes = {k: v.dtype for k, v in teng.cache.buffers.items()}
        want = {k: torch.float32 for k in STATES[name]}
        if name == RG:
            want.update(wk=torch.int8, wv=torch.int8, wk_s=torch.bfloat16,
                        wv_s=torch.bfloat16)
        assert dtypes == want


@pytest.mark.parametrize("name", NAMES)
def test_frontend_matches_jax_offline(name):
    """Both workloads through ``ServeFrontend`` over the paged engine,
    submitted while the scheduler is parked, then drained: every stream
    is the JAX engine's offline one, and the storage drains."""
    jeng, _ = engines(name, "paged")
    _, tcfg, _, tparams = setup(name)
    work = WINDOW_WORK + MAX_SEQ_WORK
    prompts = prompts_of(work, tcfg.vocab_size, seed=8)
    want = serve(jeng, JaxRequest, work, prompts)
    eng = make_engine(tcfg, tparams, kind="paged", device="cpu",
                      page_size=8, **OPTS)
    fe = ServeFrontend(eng)
    try:
        reached, release = hold(fe)
        handles = [fe.submit(p, b, rid=i)
                   for i, (p, (_, b)) in enumerate(zip(prompts, work))]
        assert reached.wait(WAIT)
        release.set()
        got = {c.rid: c for c in fe.drain(timeout=WAIT)}
    finally:
        fe.shutdown(drain=False)
    assert all(h.done for h in handles)
    assert [(c.rid, c.tokens, c.finish_reason) for c in want] == \
        [(r, got[r].tokens, got[r].finish_reason) for r in sorted(got)]
    assert drained(eng)


@pytest.mark.parametrize("name", NAMES)
def test_paged_slabs_are_rows_of_their_own(name):
    """The slabs hold the dense stacks' shapes with the slot axis at 4;
    no global page exists to reserve; a released slot's row keeps its
    stale state until an admission overwrites the whole row."""
    jeng, teng = engines(name, "paged")
    tcfg = setup(name)[1]
    pools = teng.cache.pools
    if name == RG:
        assert pools["h"].shape == (4, 4, 64)
        assert pools["conv"].shape == (4, 4, 3, 64)
        assert set(pools) == {"h", "conv", "lk", "lv"}
        assert teng.cache.tables().keys() == {"global", "local"}
    else:
        assert pools["state"].shape == (2, 4, 8, 8, 8)
        assert set(pools) == {"state", "shift"}
        assert teng.cache.tables().keys() == {"global"}
    assert not teng.prefix_sharing
    assert teng.cache.resident_bytes() == jeng.cache.resident_bytes()
    prompts = prompts_of([(9, 3), (12, 3)], tcfg.vocab_size, seed=9)
    teng.reset()
    teng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=3))
    teng.run()
    stale = _state_rows(teng, name, 0)
    assert any(t.abs().sum() > 0 for t in stale.values())
    teng.reset()
    assert all(torch.equal(stale[k], v)
               for k, v in _state_rows(teng, name, 0).items())
    teng.submit(Request(rid=1, prompt=prompts[1], max_new_tokens=1))
    teng._admit()
    fresh = teng.prefill_fn(teng.params, {
        "tokens": torch.as_tensor(np.pad(prompts[1], (0, 4))[None]),
        "last_index": 11})[1]
    for k, v in _state_rows(teng, name, 0).items():
        torch.testing.assert_close(v, fresh[k][:, 0], rtol=0, atol=0)
    teng.reset()
