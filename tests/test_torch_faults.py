"""The port's seeded fault injection (``repro_torch.serve.faults``) and the
paged pool's fault surface (``PagedKVCache.seize_pages`` /
``restore_pages``) against the reference's.

* ``FaultPlan.random`` draws the reference's exact events for a seed,
  for several ``n_events``/``horizon``/``kinds``/``max_arg`` settings,
  and pairs every seizure with a later heal;
* ``FaultEvent`` validates as the reference's does;
* after the same admissions on the JAX and the port paged engine (qwen
  smoke config, float32), a seizure takes the same page ids under the
  same ghost reservation, both allocators answer ``can_reserve`` and
  ``_admit_cap`` alike, and after the heal both pop the same pages next
  and serve the same tokens.
"""
import dataclasses

import pytest

from _torch_serve_parity import engines, prompts_of
from repro.serve import FaultEvent as JaxFaultEvent
from repro.serve import FaultPlan as JaxFaultPlan
from repro.serve import Request as JaxRequest
from repro_torch.serve import FaultEvent, FaultPlan, Request
from repro_torch.serve.faults import FAULT_KINDS

SETTINGS = [
    dict(),
    dict(n_events=10, horizon=24),
    dict(n_events=16, horizon=64),
    dict(n_events=12, horizon=8, kinds=("exhaust_pages", "heal_pages",
                                        "preempt"), max_arg=1),
    dict(n_events=0),
]


def _events(plan):
    return [dataclasses.astuple(e) for e in plan.events]


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("kw", SETTINGS, ids=lambda kw: "-".join(
    f"{k}={v if k != 'kinds' else len(v)}" for k, v in kw.items())
    or "defaults")
def test_random_plan_equals_reference(seed, kw):
    plan = FaultPlan.random(seed, **kw)
    assert _events(plan) == _events(JaxFaultPlan.random(seed, **kw))
    assert plan == FaultPlan.random(seed, **kw)
    assert plan.horizon == max((e.step for e in plan.events), default=-1)
    for step in range(plan.horizon + 1):
        assert plan.events_at(step) == [e for e in plan.events
                                        if e.step == step]


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_every_seizure_has_a_later_heal(seed):
    plan = FaultPlan.random(seed, n_events=32, horizon=64)
    assert plan != FaultPlan.random(seed + 1, n_events=32, horizon=64)
    seizures = [e for e in plan.events if e.kind == "exhaust_pages"]
    assert seizures
    for ev in seizures:
        assert any(h.kind == "heal_pages" and h.step > ev.step
                   for h in plan.events)
    # Sorted by (step, kind order), as the reference sorts.
    keys = [(e.step, FAULT_KINDS.index(e.kind)) for e in plan.events]
    assert keys == sorted(keys)
    assert plan.events_at(plan.horizon)
    assert FaultPlan(events=()).horizon == -1


@pytest.mark.parametrize("args", [(0, "meteor_strike"), (-1, "cancel"),
                                  (0, "preempt", 0)])
def test_fault_event_validation(args):
    with pytest.raises(ValueError):
        JaxFaultEvent(*args)
    with pytest.raises(ValueError):
        FaultEvent(*args)


def test_fault_plan_is_immutable_and_tuple_backed():
    plan = FaultPlan(events=[FaultEvent(3, "cancel"), FaultEvent(1, "expire")])
    assert isinstance(plan.events, tuple)
    assert plan.events_at(1) == [FaultEvent(1, "expire")]
    assert plan.horizon == 3
    with pytest.raises(dataclasses.FrozenInstanceError):
        plan.events = ()


def _allocator(cache):
    return (list(cache._free_pages), cache.reserved_total,
            cache.n_free_pages, cache.orphaned_pages,
            [cache.can_reserve(k) for k in range(cache.num_pages + 2)])


@pytest.mark.parametrize("n", [1, 3, 64])
def test_seize_restore_matches_reference(n):
    """Two residents (one sharing the other's prefix), then a seizure
    of ``n`` pages (64: more than the unreserved headroom), a third
    request that must wait on the pressure, the heal, and the rest of
    the serve, step for step on both packages."""
    jeng, teng = engines("qwen2.5-0.5b", "paged", num_pages=12)
    work = [(17, 6), (20, 5), (9, 6)]
    prompts = prompts_of(work, teng.cfg.vocab_size, share=True)
    pair = ((jeng, JaxRequest), (teng, Request))

    def add(rids):
        for eng, cls in pair:
            for rid in rids:
                eng.submit(cls(rid=rid, prompt=prompts[rid].copy(),
                               max_new_tokens=work[rid][1]))

    def step():
        return [eng.step(fin) for (eng, _), fin in zip(pair, finished)]

    for eng, _ in pair:
        eng.reset()
    finished = ([], [])
    add([0, 1])
    step()
    jc, tc = jeng.cache, teng.cache
    assert _allocator(tc) == _allocator(jc)
    headroom = tc.num_pages - tc.reserved_total - tc.orphaned_pages
    before = tc.reserved_total

    seized = tc.seize_pages(n)
    assert seized == jc.seize_pages(n)
    assert len(seized) == min(n, headroom)
    assert tc.reserved_total == before + len(seized)
    assert _allocator(tc) == _allocator(jc)
    add([2])
    assert teng._admit_cap() == jeng._admit_cap()
    assert teng._can_admit(teng.queue[0]) == jeng._can_admit(jeng.queue[0])
    if len(seized) == headroom:         # the pool has nothing left
        assert not teng._can_admit(teng.queue[0])

    tc.restore_pages(seized)
    jc.restore_pages(list(seized))
    assert tc.reserved_total == before
    assert _allocator(tc) == _allocator(jc)
    while any(step()):
        for slot in range(teng.max_batch):
            assert tc.mapped_pages(slot) == jc.mapped_pages(slot)
        assert _allocator(tc) == _allocator(jc)
    got = [sorted((r.rid, tuple(r.generated)) for r in fin)
           for fin in finished]
    assert got[1] == got[0] and len(got[0]) == 3
    assert tc.n_free_pages == tc.num_pages and tc.reserved_total == 0
