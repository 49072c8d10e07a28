"""The port's sequential engine against the JAX sequential engine on the
CPU, in float32.

``make_engine(kind="sequential")`` of both packages on the same smoke
weights: each step admits a ladder batch, prefills its fresh admits at
exact length, and decodes the concatenated caches at ``pos =
max(positions)``, so on mixed-length workloads a short row attends the
zero cells past its prompt, in both.  Identical completions and equal
shared stats (``decode_compiles``, the count of distinct decode batch
sizes, included), with and without ``coexec_backend`` (one backfill a
decode iteration).  On uniform-length workloads the port's sequential,
slot and paged engines give the same tokens as the JAX sequential one.
"""
import pytest

from _torch_serve_parity import (check_parity, completion, engines, NAMES,
                                 prompts_of, serve, serve_both, setup,
                                 workload, WORKLOAD)
from repro.serve import Request as JaxRequest
from repro_torch.serve import Request

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _check(jeng, jout, teng, tout):
    check_parity(jeng, jout, teng, tout)
    assert teng.stats["decode_compiles"] == jeng.stats["decode_compiles"]


@pytest.mark.parametrize("coexec", [None, "kernel"])
@pytest.mark.parametrize("name", NAMES)
def test_sequential_engine_matches_jax(name, coexec):
    jeng, teng = engines(name, "sequential", coexec)
    prompts = prompts_of(WORKLOAD, setup(name)[1].vocab_size, share=True)
    jout, tout = serve_both(jeng, teng, WORKLOAD, prompts)
    _check(jeng, jout, teng, tout)
    if coexec:
        assert teng.stats["backfilled"] > 0


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_sequential_engine_matches_jax_on_differential_workloads(seed):
    name = "qwen2.5-0.5b"
    work, prompts = workload(seed, setup(name)[1].vocab_size)
    jeng, teng = engines(name, "sequential")
    jout, tout = serve_both(jeng, teng, work, prompts)
    _check(jeng, jout, teng, tout)


def test_max_seq_stop_matches_jax():
    """The batch stops at pos >= max_seq - 1 (64 here), its shared
    position set by the longest prompt."""
    name = "qwen2.5-0.5b"
    work = [(60, 10), (5, 4), (58, 9), (64, 2)]
    prompts = prompts_of(work, setup(name)[1].vocab_size, seed=9)
    jeng, teng = engines(name, "sequential")
    jout, tout = serve_both(jeng, teng, work, prompts)
    _check(jeng, jout, teng, tout)
    assert "max_seq" in [c.finish_reason for c in tout]


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_uniform_lengths_all_engines_agree(seed):
    """One prompt length for every request: the shared position is each
    row's own, so the port's three engines and the JAX sequential engine
    give the same tokens."""
    name = "qwen2.5-0.5b"
    vocab = setup(name)[1].vocab_size
    work, _ = workload(seed, vocab)
    work = [(work[0][0], b) for _, b in work] + [(work[0][0], 7)]
    prompts = prompts_of(work, vocab, seed)
    jeng, teng = engines(name, "sequential")
    jout, tout = serve_both(jeng, teng, work, prompts)
    _check(jeng, jout, teng, tout)
    want = [c.tokens for c in tout]
    for kind in ("slot", "paged"):
        got = [c.tokens for c in serve(engines(name, kind)[1], Request,
                                       work, prompts)]
        assert got == want, kind
    assert sum(len(t) for t in want) == sum(max(b, 2) for _, b in work)


def test_cancel_drops_queued_and_backfilled_requests():
    """Nothing is resident between steps: a cancel finds a request in the
    queue or parked by backfill, as in the reference."""
    name = "qwen2.5-0.5b"
    jeng, teng = engines(name, "sequential", "kernel")
    work = [(9, 4), (5, 3), (12, 5), (7, 6), (3, 2), (10, 4)]
    prompts = prompts_of(work, setup(name)[1].vocab_size, seed=5)
    outs = []
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        eng.reset()
        for rid, (p, (_, b)) in enumerate(zip(prompts, work)):
            eng.submit(req_cls(rid=rid, prompt=p.copy(), max_new_tokens=b))
        assert eng.cancel(5) and not eng.cancel(99)
        finished = []
        eng.step(finished)
        parked = [r.rid for r, _, _ in eng._backfilled]
        assert parked and eng.cancel(parked[0])
        outs.append(sorted([c for c in eng.run(max_steps=4096)]
                           + [completion(r) for r in finished],
                           key=lambda c: c.rid))
    _check(jeng, outs[0], teng, outs[1])
    assert [c.finish_reason for c in outs[1]].count("cancelled") == 2
    assert teng.stats["engine"]["cancelled"] == 2


def test_decode_compiles_counts_batch_sizes_across_reset():
    """``decode_compiles`` is the number of distinct decode batch sizes
    run since construction (the reference's jit-cache count): None after
    a reset until the next step, and never reset itself."""
    name = "phi3.5-moe-42b"
    jeng, teng = engines(name, "sequential")
    prompts = prompts_of(WORKLOAD, setup(name)[1].vocab_size, share=True)
    jout, tout = serve_both(jeng, teng, WORKLOAD, prompts)
    _check(jeng, jout, teng, tout)
    n = teng.stats["decode_compiles"]
    assert n == len(teng._decode_sizes) >= 2
    for eng in (jeng, teng):
        eng.reset()
        assert eng.stats["decode_compiles"] is None
    jout, tout = serve_both(jeng, teng, WORKLOAD[:2], prompts[:2])
    _check(jeng, jout, teng, tout)
    assert teng.stats["decode_compiles"] >= n
