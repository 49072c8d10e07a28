"""The port's online frontend (``repro_torch.serve.frontend``) against the
JAX engine's offline ``run()``, mirroring ``tests/test_frontend.py``.

The claim is serving-path transparency: asynchronous intake from any
thread, coalesced batched prefills and window-boundary scheduling emit
exactly the tokens of the JAX engine's offline serve of the same
requests (slot and paged engines, yi-6b smoke config, float32, tokens
identical), and after ``warmup()`` serve them with zero decode
compiles.  The supporting contracts: per-request streaming order,
a raising callback quarantined, drain blocking on inflight work, and an
abortive shutdown resolving every handle.
"""
import sys
import threading

import numpy as np
import pytest

from _torch_frontend import hold, Setup, WAIT
from repro_torch.serve import validate_stats


@pytest.fixture(scope="module")
def setup():
    s = Setup()
    yield s
    s.close()


@pytest.fixture
def fx(setup):
    """The module's setup; every frontend the test made is shut down
    after it, pass or fail."""
    yield setup
    setup.close()


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_out_of_order_arrivals_from_threads_match_offline(fx, kind):
    """Mixed bucket lengths submitted from two threads, each in its own
    reverse order: whatever interleaving the threads produce, intake
    coalescing sorts and batches them, and every stream equals the JAX
    offline serve of the same requests."""
    lens = [5, 17, 9, 3, 23, 8]
    budgets = [4, 2, 6, 3, 5, 4]
    prompts = fx.prompts(lens, seed=1)
    want = fx.offline(prompts, budgets, kind=kind)

    fe = fx.frontend(fx.engine(kind))
    handles = {}
    start = threading.Barrier(2, timeout=WAIT)

    def submitter(rids):
        start.wait()
        for rid in rids:
            handles[rid] = fe.submit(prompts[rid], budgets[rid], rid=rid)

    threads = [threading.Thread(target=submitter, args=(rids,))
               for rids in ((5, 3, 1), (4, 2, 0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive()
    done = fe.drain(timeout=WAIT)
    fe.shutdown()
    assert {c.rid: c.tokens for c in done} == want
    for c in done:
        h = handles[c.rid]
        assert tuple(h.tokens) == c.tokens
        assert h.done and h.result(timeout=1) == c
        assert c.finish_reason == "length"
    validate_stats(fe.stats)
    assert fe.metrics()["coalesced_prefills"] >= 1


def test_callback_ordering_per_request(fx):
    """on_token callbacks fire once per token in generation order, all
    before the completion resolves; a raising callback is quarantined
    on its handle without disturbing the serve."""
    prompts = fx.prompts([6, 6, 11], seed=5)
    streams = {i: [] for i in range(3)}
    order_ok = {}
    handles = []

    def cb(rid):
        def _cb(tok):
            if rid == 2:
                raise RuntimeError("user callback exploded")
            streams[rid].append(tok)
            order_ok[rid] = order_ok.get(rid, True) \
                and not handles[rid].done
        return _cb

    fe = fx.frontend(fx.engine())
    _, go = hold(fe)                    # `handles` is complete first
    handles.extend(fe.submit(p, 5, on_token=cb(i))
                   for i, p in enumerate(prompts))
    go.set()
    done = {c.rid: c for c in fe.drain(timeout=WAIT)}
    want = fx.offline(prompts, [5] * 3)
    for rid in (0, 1):
        assert tuple(streams[rid]) == done[rid].tokens == want[rid]
        assert order_ok[rid]            # tokens preceded the completion
        assert handles[rid].callback_error is None
    # rid 2: its first delivery raised; its stream still completes.
    assert isinstance(handles[2].callback_error, RuntimeError)
    assert done[2].tokens == want[2] and len(done[2].tokens) == 5
    assert tuple(handles[2].tokens) == want[2]


def test_drain_blocks_on_inflight_and_metrics_count(fx):
    prompts = fx.prompts([8] * 6, seed=7)
    fe = fx.frontend(fx.engine())
    for p in prompts:
        fe.submit(p, 12)
    done = fe.drain(timeout=WAIT)        # called with work inflight
    assert len(done) == len(prompts)
    assert all(c.n_tokens == 12 and c.finish_reason == "length"
               for c in done)
    m = fe.metrics()
    assert m["completed"] == m["submitted"] == len(prompts)
    assert m["inflight"] == 0 and m["deferred"] == 0
    assert m["finish_reasons"] == {"length": len(prompts)}
    assert len(m["ttft"]) == len(m["tpot"]) == len(prompts)
    assert all(t >= 0 for t in m["ttft"] + m["tpot"])
    assert m["rejected"] == m["faults"] == m["remeshes"] == 0
    fe.shutdown()


def test_abortive_shutdown_resolves_handles(fx):
    """``shutdown(drain=False)`` mid-serve: every handle resolves, with
    ``aborted`` for every request whose budget the serve had not
    reached, and the frontend refuses later submits."""
    prompts = fx.prompts([8] * 6, seed=9)
    fe = fx.frontend(fx.engine())
    # The second flush waits for the abort: at most one window, 5
    # tokens, runs before it, far short of the 40-token budgets.
    hold(fe, flush=2, until=fe._abort)
    handles = [fe.submit(p, 40) for p in prompts]
    fe.shutdown(drain=False)
    for h in handles:
        c = h.result(timeout=WAIT)
        assert c.finish_reason in ("aborted", "length")
    assert all(h.result(timeout=0).finish_reason == "aborted"
               for h in handles)
    assert all(len(h.tokens) < 40 for h in handles)
    assert not fe._scheduler_t.is_alive()
    assert not fe._emitter_t.is_alive()
    with pytest.raises(RuntimeError):
        fe.submit(prompts[0], 1)


def test_warmup_then_serve_zero_compiles(fx):
    """After warmup the whole online path, coalesced batched prefills
    included, runs without a decode compile, with the offline tokens."""
    lens = [5, 17, 9, 3, 23, 8, 16, 12]
    prompts = fx.prompts(lens, seed=11)
    fe = fx.frontend(fx.engine())
    fe.warmup(max_prompt_len=24)
    _, go = hold(fe)                    # one burst: all queued at once
    for p in prompts:
        fe.submit(p, 6)
    go.set()
    done = fe.drain(timeout=WAIT)
    stats = fe.stats
    fe.shutdown()
    assert {c.rid: c.tokens for c in done} == \
        fx.offline(prompts, [6] * len(lens))
    assert stats["decode_compiles"] == 0
    # The burst really coalesced: one flush batched several same-bucket
    # prompts into one prefill call.
    assert stats["engine"]["prefill_batched_reqs"] > 0
    assert fe.coalesced_prefills > 0


def test_poisson_smoke_token_identical(fx):
    """Seeded Poisson arrivals: whatever interleaving the arrival
    process produces, the streams equal the offline serve."""
    rng = np.random.default_rng(13)
    lens = [int(x) for x in rng.integers(3, 24, size=8)]
    budgets = [int(b) for b in rng.integers(2, 7, size=8)]
    gaps = rng.exponential(scale=0.004, size=8)
    prompts = fx.prompts(lens, seed=13)
    want = fx.offline(prompts, budgets)

    fe = fx.frontend(fx.engine())
    fe.warmup(max_prompt_len=24)
    pause = threading.Event()
    for p, b, g in zip(prompts, budgets, gaps):
        pause.wait(g)                   # Poisson inter-arrival gap
        fe.submit(p, b)
    done = fe.drain(timeout=WAIT)
    stats = fe.stats
    fe.shutdown()
    assert {c.rid: c.tokens for c in done} == want
    assert stats["decode_compiles"] == 0


def test_sequential_engine_served(fx):
    """The sequential engine has no coalesced prefill and no warmup:
    the frontend submits each arrival and every handle completes its
    budget (its mixed-length batches are not batch-invariant, so no
    identity claim, as in the reference)."""
    lens = [5, 17, 9, 3, 23, 8]
    budgets = [4, 2, 6, 3, 5, 4]
    fe = fx.frontend(fx.engine("sequential"))
    fe.warmup()                         # a no-op without the hook
    handles = [fe.submit(p, b)
               for p, b in zip(fx.prompts(lens, seed=1), budgets)]
    done = {c.rid: c for c in fe.drain(timeout=WAIT)}
    fe.shutdown()
    for h, b in zip(handles, budgets):
        c = done[h.rid]
        assert c.finish_reason == "length" and c.n_tokens == b
        assert tuple(h.tokens) == c.tokens
    assert fe.coalesced_prefills == 0
    validate_stats(fe.stats)


def test_concurrent_submitters_stress(fx):
    """16 threads submit 32 requests at once under a 1 µs switch
    interval: every auto-assigned rid is distinct (the rid counter's
    read-modify-write is under the mutex), every handle resolves, and
    each stream equals the offline serve of its own prompt."""
    prompts = fx.prompts([5, 9, 17, 3], seed=17)
    want = fx.offline(prompts, [3] * len(prompts))
    fe = fx.frontend(fx.engine("paged"))
    got = []                            # (handle, prompt index)
    start = threading.Barrier(16, timeout=WAIT)

    def submitter(k):
        start.wait()
        for j in (2 * k, 2 * k + 1):
            got.append((fe.submit(prompts[j % 4], 3), j % 4))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        done = fe.drain(timeout=WAIT)
    finally:
        sys.setswitchinterval(old)
    fe.shutdown()
    assert sorted(h.rid for h, _ in got) == list(range(32))
    assert len(done) == 32 and fe.metrics()["completed"] == 32
    for h, i in got:
        assert h.result(timeout=0).tokens == tuple(h.tokens) == want[i]


def test_submit_and_cancel_never_wait_for_a_window(fx):
    """A decode window holds the frontend's mutex for its whole wall
    time; submit, cancel and drain take only the intake lock, so they
    return while a window is still running."""
    prompts = fx.prompts([9, 12], seed=19)
    eng = fx.engine("paged")
    fe = fx.frontend(eng)
    in_window, release = threading.Event(), threading.Event()
    real = eng.step

    def held_step(finished, *args):
        in_window.set()
        release.wait(WAIT)
        return real(finished, *args)

    eng.step = held_step
    h0 = fe.submit(prompts[0], 4)
    assert in_window.wait(WAIT)          # the scheduler holds the mutex
    late = []

    def submit_and_cancel():
        late.append(fe.submit(prompts[1], 4))
        late.append(late[0].cancel())

    t = threading.Thread(target=submit_and_cancel)
    t.start()
    t.join(10)
    window_still_running = not release.is_set()
    release.set()
    assert not t.is_alive() and window_still_running
    assert late[1] is True
    done = {c.rid: c for c in fe.drain(timeout=WAIT)}
    fe.shutdown()
    assert done[1].finish_reason == "cancelled" and done[1].tokens == ()
    assert done[0].finish_reason == "length"
    assert done[0].tokens == fx.offline(prompts[:1], [4], kind="paged")[0]
