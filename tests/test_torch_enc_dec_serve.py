"""whisper-base's encoder-decoder through the port's slot and sequential
engines, against the JAX engine of the same kind on the CPU, on
``smoke_config("whisper-base")`` in float32 with TF32 off: 4 slots,
``max_seq`` 64, windows of 4 tokens.

* Every request carries its own seeded ``(enc_frames, frontend_dim)``
  features but one, which carries None (zero features, as in the
  reference): ``check_parity`` (tokens, finish reasons, shared stats)
  on prompts around the window (8 requests on 4 slots, so slots are
  reused after release) and across ``max_seq``; the slot buffers hold
  the self stacks at ``max_seq`` and the cross stacks ``xk``, ``xv`` at
  ``enc_frames``, their bytes the JAX engine's.
* A request's tokens depend on its own features: the same prompt with
  other features decodes another stream, as in the reference, on the
  paged engine too (its cross page pool: ``test_torch_enc_dec_paged.py``).
* ``prefill_batch`` (each row with its own features, pad rows with row
  0's), a preemption storm whose victims re-encode their own features
  on resume, the dense ``CACHE_QUANT`` flag (self stacks int8, cross
  stacks at model precision), ``ServeFrontend`` over the slot engine
  against the JAX offline ``run()``, the wrong-shape ``ValueError`` in
  all three engines in both packages, and ``launch.serve`` on slot and
  sequential.
"""
import numpy as np
import pytest
import torch

from _torch_frontend import hold, WAIT
from _torch_serve_parity import (check_parity, completion, engines, OPTS,
                                 serve, serve_both, setup, submit)
from repro.models import attention as jattn
from repro.serve.engine import encoder_inputs as jax_encoder_inputs
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as tattn
from repro_torch.serve import make_engine, Request, ServeFrontend
from repro_torch.serve.engine import encoder_inputs

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NAME = "whisper-base"
KINDS = ("slot", "sequential")
# (prompt length, max_new_tokens): 8 requests on 4 slots around the
# window of 4, and across max_seq = 64 (70 takes the exact-length
# prefill into the ring).
WINDOW_WORK = [(1, 6), (7, 12), (15, 6), (16, 5), (17, 8), (23, 4),
               (31, 7), (33, 5)]
MAX_SEQ_WORK = [(63, 3), (64, 2), (70, 3), (5, 6), (40, 30)]
WORKS = {"window": WINDOW_WORK, "max_seq": MAX_SEQ_WORK}


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _cfg():
    return setup(NAME)[1]


def _prompts(work, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, _cfg().vocab_size, n, dtype=np.int32)
            for n, _ in work]


def _features(n, seed, none_at=1):
    """A seeded feature block a request, None at ``none_at``."""
    cfg = _cfg()
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((cfg.enc_frames, cfg.frontend_dim)
                               ).astype(np.float32) for _ in range(n)]
    if none_at is not None:
        out[none_at] = None
    return out


@pytest.mark.parametrize("work", list(WORKS))
@pytest.mark.parametrize("kind", KINDS)
def test_engines_match_jax_with_per_request_features(kind, work):
    jeng, teng = engines(NAME, kind)
    w = WORKS[work]
    prompts, enc = _prompts(w, seed=1), _features(len(w), seed=2)
    jout, tout = serve_both(jeng, teng, w, prompts, enc=enc)
    check_parity(jeng, jout, teng, tout)
    assert len(tout) == len(w)
    if kind == "slot":
        cfg = _cfg()
        bufs = teng.cache.buffers
        hd, h = cfg.resolved_head_dim, cfg.n_kv_heads
        assert {k: tuple(t.shape) for k, t in bufs.items()} == {
            "k": (cfg.n_layers, 4, 64, h, hd),
            "v": (cfg.n_layers, 4, 64, h, hd),
            "xk": (cfg.n_layers, 4, cfg.enc_frames, h, hd),
            "xv": (cfg.n_layers, 4, cfg.enc_frames, h, hd)}
        assert teng.cache.resident_bytes() == jeng.cache.resident_bytes()
        assert teng.cache.n_free == teng.max_batch


@pytest.mark.parametrize("kind", KINDS + ("paged",))
def test_tokens_follow_each_requests_own_features(kind):
    """One prompt, three feature blocks: the reference's streams, and
    at least two of them differ."""
    jeng, teng = engines(NAME, kind)
    w = [(9, 8)] * 3
    prompt = _prompts(w[:1], seed=3)[0]
    enc = _features(3, seed=4, none_at=None)
    jout, tout = serve_both(jeng, teng, w, [prompt] * 3, enc=enc)
    check_parity(jeng, jout, teng, tout)
    assert len({tuple(c.tokens) for c in tout}) >= 2


def test_prefill_batch_matches_jax():
    """One coalesced prefill of a group of same-bucket prompts, each
    row with its own features (the ladder rung pads with row 0's),
    then the parked requests are served."""
    jeng, teng = engines(NAME, "slot")
    w = [(9, 5), (12, 4), (14, 6), (10, 3), (3, 4)]
    prompts, enc = _prompts(w, seed=5), _features(len(w), seed=6)
    reqs = {}
    for eng, cls in ((jeng, JaxRequest), (teng, Request)):
        eng.reset()
        reqs[cls] = [cls(rid=i, prompt=p.copy(), max_new_tokens=b,
                         enc_embeds=e)
                     for i, (p, (_, b), e) in enumerate(zip(prompts, w, enc))]
        eng.prefill_batch(reqs[cls])
    ext, jext = teng.stats["engine"], jeng.stats["engine"]
    for key in ("prefill_batches", "prefill_batched_reqs",
                "prefill_bucket_hits", "prefill_bucket_misses"):
        assert ext[key] == jext[key], key
    assert ext["prefill_batches"] >= 1 and ext["prefill_batched_reqs"] >= 3
    assert [r.generated for r in reqs[Request]] == \
        [r.generated for r in reqs[JaxRequest]]
    outs = [sorted(eng.run(max_steps=4096), key=lambda c: c.rid)
            for eng in (jeng, teng)]
    check_parity(jeng, outs[0], teng, outs[1])


def _storm(eng, request_cls, work, prompts, enc):
    """Serve with two forced preemptions after the first window."""
    eng.reset()
    submit(eng, request_cls, work, prompts, enc=enc)
    finished = []
    eng.step(finished)
    assert eng.preempt(2) == 2
    return sorted(eng.run(max_steps=4096)
                  + [completion(r) for r in finished], key=lambda c: c.rid)


def test_preemption_re_encodes_each_requests_features():
    """Two residents preempted after the first window re-prefill their
    prompt and generated tokens against their own features and resume
    token-identically."""
    jeng, teng = engines(NAME, "slot")
    prompts, enc = _prompts(WINDOW_WORK, seed=7), _features(8, seed=8)
    jout = _storm(jeng, JaxRequest, WINDOW_WORK, prompts, enc)
    tout = _storm(teng, Request, WINDOW_WORK, prompts, enc)
    check_parity(jeng, jout, teng, tout)
    assert teng.stats["engine"]["preemptions"] == 2


@pytest.mark.parametrize("kind", KINDS)
def test_dense_int8_flag_keeps_the_cross_stacks_at_model_precision(kind):
    cfg, tcfg, jparams, tparams = setup(NAME)
    jattn.set_kv_cache_quant(True)
    tattn.set_kv_cache_quant(True)
    try:
        jeng = jax_make_engine(cfg, jparams, kind=kind, **OPTS)
        teng = make_engine(tcfg, tparams, kind=kind, device="cpu", **OPTS)
        prompts, enc = _prompts(WINDOW_WORK, seed=9), _features(8, seed=10)
        jout, tout = serve_both(jeng, teng, WINDOW_WORK, prompts, enc=enc)
        check_parity(jeng, jout, teng, tout)
        if kind == "slot":
            dtypes = {k: t.dtype for k, t in teng.cache.buffers.items()}
            assert dtypes == {"k": torch.int8, "v": torch.int8,
                              "k_s": torch.bfloat16, "v_s": torch.bfloat16,
                              "xk": torch.float32, "xv": torch.float32}
            assert teng.cache.resident_bytes() == \
                jeng.cache.resident_bytes()
    finally:
        jattn.set_kv_cache_quant(False)
        tattn.set_kv_cache_quant(False)


def test_frontend_over_slot_matches_jax_offline():
    """The window workload through ``ServeFrontend`` over the slot
    engine (its submit takes no features, in either package: every
    request encodes zeros), submitted while the scheduler is parked:
    every stream is the JAX engine's offline one."""
    jeng, _ = engines(NAME, "slot")
    _, tcfg, _, tparams = setup(NAME)
    prompts = _prompts(WINDOW_WORK, seed=11)
    want = serve(jeng, JaxRequest, WINDOW_WORK, prompts)
    eng = make_engine(tcfg, tparams, kind="slot", device="cpu", **OPTS)
    fe = ServeFrontend(eng)
    try:
        reached, release = hold(fe)
        handles = [fe.submit(p, b, rid=i)
                   for i, (p, (_, b)) in enumerate(zip(prompts,
                                                       WINDOW_WORK))]
        assert reached.wait(WAIT)
        release.set()
        got = {c.rid: c for c in fe.drain(timeout=WAIT)}
    finally:
        fe.shutdown(drain=False)
    assert all(h.done for h in handles)
    assert [(c.rid, c.tokens, c.finish_reason) for c in want] == \
        [(r, got[r].tokens, got[r].finish_reason) for r in sorted(got)]
    assert eng.cache.n_free == eng.max_batch


@pytest.mark.parametrize("kind", KINDS + ("paged",))
def test_wrong_feature_shape_raises_value_error(kind):
    cfg = _cfg()
    good = np.ones((cfg.enc_frames, cfg.frontend_dim), np.float32)
    for req_cls, fn in ((JaxRequest, jax_encoder_inputs),
                        (Request, encoder_inputs)):
        np.testing.assert_array_equal(
            fn(req_cls(rid=0, prompt=np.ones(3, np.int32), max_new_tokens=1),
               cfg), np.zeros_like(good))
        np.testing.assert_array_equal(
            fn(req_cls(rid=0, prompt=np.ones(3, np.int32), max_new_tokens=1,
                       enc_embeds=good.astype(np.float64)), cfg), good)
    bad = np.zeros((cfg.enc_frames + 1, cfg.frontend_dim), np.float32)
    jeng, teng = engines(NAME, kind)
    for eng, cls in ((jeng, JaxRequest), (teng, Request)):
        eng.reset()
        eng.submit(cls(rid=0, prompt=np.ones(5, np.int32), max_new_tokens=3,
                       enc_embeds=bad))
        with pytest.raises(ValueError, match="enc_embeds must be"):
            eng.run()
        eng.reset()


@pytest.mark.parametrize("engine", KINDS)
def test_launch_serve_runs_on_the_cpu(engine, capsys):
    assert launch_serve.main(["--arch", NAME, "--smoke", "--requests", "3",
                              "--max-seq", "64", "--engine", engine,
                              "--device", "cpu"]) == 0
    assert "3/3 done" in capsys.readouterr().out

