"""Overload robustness of the port's frontend: cancellation, deadlines,
backpressure and the seeded fault-injection harness, mirroring the
frontend-level tests of ``tests/test_overload.py``.

The contract is graceful degradation with zero corruption: every
lifecycle exit resolves its handle with a typed reason and releases all
engine storage (slots, pages, reservations, prefix registry), and a
seeded :class:`~repro_torch.serve.FaultPlan` can batter the frontend
with allocator exhaustion, preemption storms, stragglers, cancels,
expiries and raising callbacks — and afterwards every handle is
resolved, the paged engine's storage is drained to zero leaks, and every
surviving stream equals the JAX engine's offline serve of the same
requests (yi-6b smoke config, float32, tokens identical).

Mid-flight expiry goes through the ``expire`` fault, which fires at a
fixed scheduler cycle, and not through a wall-clock deadline that a
fast serve could outrun; wall-clock deadlines appear only where they
have lapsed before the scheduler looks (:func:`hold`).
"""
import time

import pytest

from _torch_frontend import drained, hold, Setup, WAIT
from repro_torch.distributed.fault import StragglerWatchdog
from repro_torch.serve import (FaultEvent, FaultPlan, RejectedError,
                               validate_stats)

SMALL_POOL = 10   # pages of 8: two or three residents fill it


@pytest.fixture(scope="module")
def setup():
    s = Setup()
    yield s
    s.close()


@pytest.fixture
def fx(setup):
    yield setup
    setup.close()


def _check_survivors(done, want):
    """``length`` completions equal the unfaulted serve; lifecycle exits
    truncate it and nothing else may."""
    for c in done:
        if c.finish_reason == "length":
            assert c.tokens == want[c.rid], c.rid
        else:
            assert c.tokens == want[c.rid][:len(c.tokens)], c.rid


class TestCancellation:
    def test_handle_cancel_resolves_and_keeps_tokens(self, fx):
        prompts = fx.prompts([9, 17, 15], seed=5)
        eng = fx.engine("paged")
        fe = fx.frontend(eng)
        _, go = hold(fe)
        reached, cancelled = hold(fe, flush=2)
        hs = [fe.submit(p, 40) for p in prompts]
        go.set()
        # The scheduler has admitted all three and run one window.
        assert reached.wait(WAIT)
        assert hs[1].cancel()
        cancelled.set()
        done = {c.rid: c for c in fe.drain(timeout=WAIT)}
        fe.shutdown()
        assert done[1].finish_reason == "cancelled"
        assert tuple(hs[1].tokens) == done[1].tokens  # delivered kept
        assert 1 <= len(done[1].tokens) < 40
        want = fx.offline(prompts, [40] * 3, kind="paged")
        _check_survivors(done.values(), want)
        for rid in (0, 2):
            assert done[rid].finish_reason == "length"
        assert hs[1].cancel() is False        # already resolved
        assert fe.stats["engine"]["cancelled"] == 1
        assert drained(eng)

    def test_cancel_before_admission_never_touches_engine(self, fx):
        prompts = fx.prompts([9, 12], seed=6)
        eng = fx.engine("paged")
        fe = fx.frontend(eng)
        _, go = hold(fe)
        hs = [fe.submit(p, 5) for p in prompts]
        assert hs[0].cancel()
        go.set()
        done = {c.rid: c for c in fe.drain(timeout=WAIT)}
        fe.shutdown()
        assert done[0].finish_reason == "cancelled" and done[0].tokens == ()
        assert done[1].finish_reason == "length"
        assert eng.stats["engine"]["cancelled"] == 0
        assert eng.stats["engine"]["slot_admits"] == 1


class TestDeadlines:
    def test_midflight_expiry_resolves_with_partial_stream(self, fx):
        """The ``expire`` fault forces the in-flight request's deadline
        to now at cycle 2 (after two windows): it resolves ``deadline``
        with the tokens generated so far, which prefix the offline
        stream, and frees its storage."""
        prompt = fx.prompts([9], seed=6)
        eng = fx.engine("paged")
        fe = fx.frontend(eng, fault_plan=FaultPlan(
            events=(FaultEvent(2, "expire"),)))
        h = fe.submit(prompt[0], 40, deadline=3600.0)
        c = h.result(timeout=WAIT)
        fe.shutdown()
        assert c.finish_reason == "deadline"
        assert 1 <= len(c.tokens) < 40
        assert c.tokens == fx.offline(prompt, [40],
                                      kind="paged")[0][:len(c.tokens)]
        assert fe.fault_log == [(2, "expire", 1)]
        assert drained(eng)

    def test_queued_deadline_expires_without_touching_engine(self, fx):
        """A deadline that lapses while the request is still queued
        resolves at intake; the engine never sees it."""
        prompts = fx.prompts([9] * 5, seed=7)
        eng = fx.engine("paged")
        fe = fx.frontend(eng)
        _, go = hold(fe)
        for p in prompts[:4]:           # they fill the 4 slots
            fe.submit(p, 30)
        h = fe.submit(prompts[4], 5, deadline=1e-4)
        time.sleep(0.01)                # the deadline lapses in intake
        go.set()
        c = h.result(timeout=WAIT)
        done = fe.drain(timeout=WAIT)
        fe.shutdown()
        assert c.finish_reason == "deadline" and c.tokens == ()
        assert len(done) == 5
        assert eng.stats["engine"]["cancelled"] == 0
        assert eng.stats["engine"]["slot_admits"] == 4

    def test_submit_validation(self, fx):
        fe = fx.frontend(fx.engine("paged"))
        with pytest.raises(ValueError):
            fe.submit([1, 2], 4, deadline=0.0)
        with pytest.raises(ValueError):
            fe.submit([1, 2], 4, deadline=-1.0)
        with pytest.raises(ValueError):
            fe.submit([1, 2], 4, klass="realtime")
        fe.shutdown(drain=False)
        with pytest.raises(RuntimeError):
            fe.submit([1, 2], 4)


class TestBackpressure:
    def test_rejection_then_clean_drain(self, fx):
        """Over-limit submits shed load with a typed, retryable error;
        everything accepted still serves to completion, and a drained
        intake accepts again."""
        prompts = fx.prompts([9] * 12, seed=8)
        fe = fx.frontend(fx.engine("paged"), max_queued=2)
        _, go = hold(fe)                # nothing leaves intake yet
        accepted, nrej = [], 0
        for p in prompts:
            try:
                accepted.append(fe.submit(p, 6))
            except RejectedError as e:
                nrej += 1
                assert e.retry_after > 0
        go.set()
        assert (len(accepted), nrej) == (2, 10)
        done = fe.drain(timeout=WAIT)
        m = fe.metrics()
        assert len(done) == len(accepted)
        assert all(c.finish_reason == "length" for c in done)
        assert m["rejected"] == nrej
        assert m["submitted"] == len(accepted)
        c = fe.submit(prompts[0], 3).result(timeout=WAIT)
        fe.shutdown()
        assert len(c.tokens) == 3


class TestChaos:
    LENS = [9, 17, 15, 7, 8, 12]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_storm_resolves_everything_zero_leaks(self, fx, seed):
        budgets = [12] * len(self.LENS)
        prompts = fx.prompts(self.LENS, seed=9)
        want = fx.offline(prompts, budgets, kind="paged")

        plan = FaultPlan.random(seed, n_events=10, horizon=24)
        eng = fx.engine("paged", num_pages=SMALL_POOL)
        fe = fx.frontend(eng, fault_plan=plan)
        _, go = hold(fe)
        hs = [fe.submit(p, b) for p, b in zip(prompts, budgets)]
        go.set()
        done = fe.drain(timeout=WAIT)
        fe.shutdown()

        # 1. Every handle resolved, with a schema finish reason.
        assert len(done) == len(hs) and all(h.done for h in hs)
        for c in done:
            assert c.finish_reason in ("length", "cancelled", "deadline")
        # 2. Zero leaked storage of any kind.
        assert drained(eng)
        # 3. Survivors token-identical to the JAX offline serve.
        _check_survivors(done, want)
        # 4. The storm happened and was recorded.
        assert fe.fault_log
        assert fe.metrics()["faults"] == len(fe.fault_log)
        validate_stats(eng.stats)

    def test_handcrafted_storm_hits_every_fault_kind(self, fx):
        """A pinned plan firing all seven kinds in one serve, the
        straggler through the watchdog."""
        lens = [9, 17, 15, 7, 8]
        budgets = [14] * len(lens)
        prompts = fx.prompts(lens, seed=10)
        want = fx.offline(prompts, budgets, kind="paged")
        plan = FaultPlan(events=(
            FaultEvent(1, "exhaust_pages", 3),
            FaultEvent(2, "preempt", 2),
            FaultEvent(2, "raise_callback"),
            FaultEvent(3, "cancel"),
            FaultEvent(3, "straggler", 2),
            FaultEvent(4, "expire"),
            FaultEvent(5, "heal_pages"),
        ))
        eng = fx.engine("paged", num_pages=12)
        wd = StragglerWatchdog(threshold=3.0)
        fe = fx.frontend(eng, fault_plan=plan, watchdog=wd)
        _, go = hold(fe)
        hs = [fe.submit(p, b, on_token=(lambda t: None) if i else None)
              for i, (p, b) in enumerate(zip(prompts, budgets))]
        go.set()
        done = {c.rid: c for c in fe.drain(timeout=WAIT)}
        fe.shutdown()
        fired = {k for _, k, n in fe.fault_log if n > 0}
        assert fired == {"exhaust_pages", "preempt", "cancel", "expire",
                         "straggler", "heal_pages", "raise_callback"}
        # The raising callback was quarantined on exactly one handle.
        assert sum(isinstance(h.callback_error, RuntimeError)
                   for h in hs) == 1
        # The inflated window tripped the watchdog.
        assert len(wd.flagged) >= 1
        assert fe.metrics()["stragglers"] == len(wd.flagged)
        reasons = {c.finish_reason for c in done.values()}
        assert {"cancelled", "deadline"} <= reasons
        _check_survivors(done.values(), want)
        assert eng.stats["engine"]["preemptions"] >= 2
        assert drained(eng)

    def test_shrinking_device_probe_on_meshless_engine(self, fx):
        """A device probe that loses a device every cycle drives the
        recovery path: the port's engines have no mesh, so nothing is
        re-meshed and the serve finishes as if unprobed."""
        lens = [9, 17, 15]
        budgets = [8] * len(lens)
        prompts = fx.prompts(lens, seed=11)
        calls = [0]

        def probe():
            calls[0] += 1
            return list(range(max(8 - calls[0], 1)))

        eng = fx.engine("paged")
        fe = fx.frontend(eng, device_probe=probe,
                         watchdog=StragglerWatchdog())
        hs = [fe.submit(p, b) for p, b in zip(prompts, budgets)]
        done = {c.rid: c for c in fe.drain(timeout=WAIT)}
        fe.shutdown()
        assert calls[0] >= 2
        assert fe.remeshes == 0 and fe.metrics()["remeshes"] == 0
        assert {rid: c.tokens for rid, c in done.items()} == \
            fx.offline(prompts, budgets, kind="paged")
        assert all(h.result(timeout=0).finish_reason == "length"
                   for h in hs)
        assert drained(eng)
