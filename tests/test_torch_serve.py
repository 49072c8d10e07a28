"""The port's paged engine against the JAX paged engine on the CPU.

One mixed-length workload (prompt lengths on page boundaries +-1, two
requests sharing a page-aligned prefix, heterogeneous budgets, more
requests than slots) goes through ``repro.serve.make_engine(kind=
"paged")`` and ``repro_torch.serve.make_engine(kind="paged",
device="cpu")`` on the same float32 smoke weights.  The completions
must be identical token for token, both stats dicts must hold the
shared schema, and the port's page pool must drain back to full.  The
same holds for the MoE smoke config (the reference's default dense
experts against the port's flat dispatch, in float32).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import init_params as jax_init
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro.serve import validate_stats as jax_validate_stats
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.configs.base import ATTN, LOCAL
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import init_params
from repro_torch.models import moe as torch_moe
from repro_torch.serve import (completion_of, make_engine, Request,
                               validate_stats)

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

OPTS = dict(max_slots=4, max_seq=64, page_size=8, window=4)
# (prompt length, max_new_tokens); rid 1 extends rid 0's first 16 tokens.
WORKLOAD = [(17, 6), (20, 5), (7, 3), (9, 6), (1, 4), (15, 7)]


def _setup(name):
    cfg = smoke_config(name)
    jparams = jax_init(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              torch_smoke_config(name), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n, _ in WORKLOAD]
    prompts[1][:16] = prompts[0][:16]
    return cfg, jparams, tparams, prompts


@pytest.fixture(scope="module")
def setup():
    return _setup("qwen2.5-0.5b")


def _serve(make, request_cls, cfg, params, prompts, **kw):
    eng = make(cfg, params, kind="paged", **OPTS, **kw)
    for rid, (prompt, (_, budget)) in enumerate(zip(prompts, WORKLOAD)):
        eng.submit(request_cls(rid=rid, prompt=prompt.copy(),
                               max_new_tokens=budget))
    return eng, sorted(eng.run(), key=lambda c: c.rid)


def test_paged_engine_matches_jax(setup):
    _check_matches_jax("qwen2.5-0.5b", *setup)


def test_moe_paged_engine_matches_jax():
    """phi3.5-moe smoke: the decode window routes all rung rows together
    (frozen and released rows included) and bucketed prefills mask their
    pads, exactly as the JAX window does, so the tokens match."""
    teng = _check_matches_jax("phi3.5-moe-42b", *_setup("phi3.5-moe-42b"))
    assert teng.stats["expert_backend"] == "kernel"


def test_moe_engine_matches_jax_when_experts_overflow_in_decode(
        monkeypatch):
    """Capacity is shared by every row of a decode window: at rung 16 with
    capacity factor 0.25 experts overflow, and which pairs drop depends
    on every row fed, frozen and released rows included.  The port feeds
    the rows the JAX window feeds, so the tokens still match."""
    name = "phi3.5-moe-42b"

    def tight(c):
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=0.25))

    cfg, tcfg = tight(smoke_config(name)), tight(torch_smoke_config(name))
    jparams = jax_init(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(3)
    work = [(int(rng.integers(1, 30)), int(rng.integers(3, 9)))
            for _ in range(12)]
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n, _ in work]
    overflows = []
    local = torch_moe._moe_local

    def spy(x, p, c, act, valid=None):
        if x.shape[1] == 1:                                  # decode
            xt = x.reshape(-1, x.shape[-1]).float()
            topi = torch.topk(torch.softmax(xt @ p["router"], -1),
                              c.moe.top_k, -1).indices
            cap = torch_moe._capacity(xt.shape[0], c.moe.n_experts,
                                      c.moe.top_k, c.moe.capacity_factor)
            overflows.append(int(torch.bincount(topi.reshape(-1)).max())
                             > cap)
        return local(x, p, c, act, valid)

    monkeypatch.setattr(torch_moe, "_moe_local", spy)
    opts = dict(OPTS, max_slots=16)
    outs = []
    for make, req_cls, c, params, kw in (
            (jax_make_engine, JaxRequest, cfg, jparams, {}),
            (make_engine, Request, tcfg, tparams, {"device": "cpu"})):
        eng = make(c, params, kind="paged", **opts, **kw)
        for rid, (prompt, (_, budget)) in enumerate(zip(prompts, work)):
            eng.submit(req_cls(rid=rid, prompt=prompt.copy(),
                               max_new_tokens=budget))
        outs.append([c_.tokens for c_ in sorted(eng.run(),
                                                key=lambda c_: c_.rid)])
        assert 16 in eng.stats["engine"]["rungs"]
    assert any(overflows)
    assert outs[0] == outs[1]
    assert eng.cache.n_free_pages == eng.cache.num_pages


def _check_matches_jax(name, cfg, jparams, tparams, prompts):
    jeng, jout = _serve(jax_make_engine, JaxRequest, cfg, jparams, prompts)
    teng, tout = _serve(make_engine, Request, torch_smoke_config(name),
                        tparams, prompts, device="cpu")
    assert [c.rid for c in tout] == list(range(len(WORKLOAD)))
    assert [(c.tokens, c.finish_reason) for c in tout] == \
        [(c.tokens, c.finish_reason) for c in jout]
    assert all(c.n_tokens == budget for c, (_, budget) in zip(tout, WORKLOAD))
    jax_validate_stats(jeng.stats)
    validate_stats(teng.stats)
    ext = teng.stats["engine"]
    assert ext["pages_shared"] == jeng.stats["engine"]["pages_shared"] >= 1
    assert ext["slot_admits"] == ext["slot_releases"] == len(WORKLOAD)
    assert teng.stats["batches"] == jeng.stats["batches"]
    assert teng.cache.n_free_pages == teng.cache.num_pages
    assert teng.cache.reserved_total == 0
    assert (teng.cache.table == teng.cache.sink).all()
    assert teng.cache.resident_bytes() == jeng.cache.resident_bytes()
    return teng


def test_preempted_and_cancelled_requests(setup):
    """A preemption storm resumes token-identically (re-prefill of
    prompt + generated[:-1]); a cancel releases its pages at once."""
    _, _, tparams, prompts = setup
    tcfg = torch_smoke_config("qwen2.5-0.5b")
    _, ref = _serve(make_engine, Request, tcfg, tparams, prompts,
                    device="cpu")
    eng = make_engine(tcfg, tparams, kind="paged", device="cpu", **OPTS)
    for rid, (prompt, (_, budget)) in enumerate(zip(prompts, WORKLOAD)):
        eng.submit(Request(rid=rid, prompt=prompt.copy(),
                           max_new_tokens=budget))
    finished = []
    eng.step(finished)
    assert eng.preempt(2) == 2
    out = sorted(eng.run() + [c for c in map(completion_of, finished)],
                 key=lambda c: c.rid)
    assert [c.tokens for c in out] == [c.tokens for c in ref]
    assert eng.stats["engine"]["preemptions"] == 2
    assert eng.cache.n_free_pages == eng.cache.num_pages

    eng.reset()
    for rid, prompt in enumerate(prompts[:2]):
        eng.submit(Request(rid=rid, prompt=prompt.copy(), max_new_tokens=30))
    eng.step([])
    assert eng.cancel(0) and not eng.cancel(99)
    out = {c.rid: c for c in eng.run()}
    assert out[0].finish_reason == "cancelled"
    assert out[1].finish_reason == "length" and out[1].n_tokens == 30
    assert eng.cache.n_free_pages == eng.cache.num_pages


def test_warmup_leaves_no_decode_compiles(setup):
    cfg, _, tparams, prompts = setup
    eng = make_engine(torch_smoke_config("qwen2.5-0.5b"), tparams,
                      kind="paged", device="cpu", **OPTS)
    eng.warmup()
    assert eng.stats["decode_compiles"] == 0
    assert eng.cache.n_free_pages == eng.cache.num_pages
    eng.submit(Request(rid=0, prompt=prompts[0].copy(), max_new_tokens=6))
    (out,) = eng.run()
    assert out.n_tokens == 6 and eng.stats["decode_compiles"] == 0


@pytest.mark.parametrize("kind,kw,exc", [
    ("dense", {}, ValueError),
    ("paged", {"kv_quant": "fp8"}, ValueError),
    ("paged", {"coexec_backend": "xla"}, ValueError),
    ("paged", {"expert_backend": "xla"}, ValueError),
    ("paged", {"expert_backend": "pallas"}, ValueError),
])
def test_unported_engine_options_raise(setup, kind, kw, exc):
    _, _, tparams, _ = setup
    with pytest.raises(exc):
        make_engine(torch_smoke_config("qwen2.5-0.5b"), tparams, kind=kind,
                    device="cpu", **kw)


def test_paged_engine_refuses_the_dense_quant_flag(setup):
    """Paged storage quantizes at the pool boundary (``kv_quant="int8"``);
    under the dense engines' ``set_kv_cache_quant(True)`` its
    constructor raises, as the reference's does."""
    _, _, tparams, _ = setup
    tattn.set_kv_cache_quant(True)
    try:
        with pytest.raises(NotImplementedError, match="CACHE_QUANT"):
            make_engine(torch_smoke_config("qwen2.5-0.5b"), tparams,
                        kind="paged", device="cpu", **OPTS)
    finally:
        tattn.set_kv_cache_quant(False)
    make_engine(torch_smoke_config("qwen2.5-0.5b"), tparams, kind="paged",
                device="cpu", **OPTS)


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_every_assigned_architecture_builds_a_paged_engine(name):
    """No architecture is refused: each of the ten builds the paged
    engine (its own smoke weights), with the storage its layers need."""
    cfg = torch_smoke_config(name)
    eng = make_engine(cfg, init_params(cfg, seed=0, device="cpu"),
                      kind="paged", device="cpu", **OPTS)
    kinds = set(cfg.layer_kinds())
    want = ({"global"} if ATTN in kinds else set()) \
        | ({"local"} if LOCAL in kinds else set()) \
        | ({"cross"} if cfg.enc_dec else set())
    assert set(eng.cache.tables()) == want | {"global"}
    assert eng.cache.resident_bytes() > 0


def test_expert_backend_is_kernel_for_moe_and_none_for_dense(setup):
    _, _, tparams, _ = setup
    eng = make_engine(torch_smoke_config("qwen2.5-0.5b"), tparams,
                      kind="paged", device="cpu", expert_backend="kernel",
                      **OPTS)
    assert eng.stats["expert_backend"] is None
    eng.reset()
    assert eng.stats["expert_backend"] is None


def test_default_device_raises_without_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, _, tparams, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(torch_smoke_config("qwen2.5-0.5b"), tparams, kind="paged")
