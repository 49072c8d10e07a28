"""The port's engines on a ``("data", "model")`` mesh against the JAX
package's engines of the same kind without one, on virtual CPU meshes.

The reference's sharded engines are token-identical to its meshless
ones (``tests/test_serve_sharded.py``, on an 8-device mesh), so the
port's sharded engines are held to the meshless JAX engine with
``check_parity`` (tokens, finish reasons, the shared stats with
``remeshes``) and to the port's meshless engine:

* yi-6b smoke (4/2 heads: heads split at ``model`` 2, the fallback of
  sequence-split caches at 4) and phi3.5-moe smoke (4 experts) through
  slot and paged on (1, 2), (2, 2) and (1, 4);
* the paged engine on a 12-page pool (preemption), on int8 pools and
  with shared prefixes;
* MoE under both EP impls: ``"all_to_all"`` gives each shard its own
  capacity, so it is held to the JAX engine whose MoE layers run the
  reference's ``_moe_a2a`` under ``jax.vmap`` over a named axis (its
  sharded function on one device);
* the storage laid out by ``cache_specs``, its bytes those of the
  meshless engine; ``remesh`` drops the old storage;
* what a mesh does not take (the sequential engine; ``remesh`` of an
  engine built without one) raises;
* ``ServeFrontend`` over a (2, 2) mesh that loses two devices re-meshes
  to (1, 2) and finishes with an uninterrupted serve's completions, and
  an unserveable shrink keeps serving with ``remeshes`` 0 (the port of
  the reference's ``TestFaultRecovery``).
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_parity as H
from repro.models import moe as jmoe
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro_torch.distributed import (simulate_failure, StragglerWatchdog,
                                     virtual_mesh)
from repro_torch.distributed.mesh import Sharded
from repro_torch.models import moe as tmoe
from repro_torch.serve import make_engine, Request, ServeFrontend

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NAMES = ("yi-6b", "phi3.5-moe-42b")
SHAPES = ((1, 2), (2, 2), (1, 4))
# (prompt length, max_new_tokens): the reference's FIXED workload.
FIXED = [(5, 6), (17, 8), (9, 5), (33, 7), (12, 9), (7, 6)]


@pytest.fixture(autouse=True)
def _psum_default():
    yield
    tmoe.set_ep_impl("psum")


def _mesh_engine(name, kind, shape, **kw):
    _, tcfg, _, tparams = H.setup(name)
    opts = dict(H.OPTS, **kw)
    if kind == "paged":
        opts.setdefault("page_size", H.PAGE_SIZE)
    return make_engine(tcfg, tparams, kind=kind,
                       mesh=virtual_mesh(shape, "cpu"), **opts)


def _tokens(out):
    return [(c.rid, c.tokens, c.finish_reason) for c in out]


def _jax_engine(name, kind, **kw):
    """A fresh JAX engine: its bucket and compile counters start where
    the port engines built beside it start."""
    cfg, _, jparams, _ = H.setup(name)
    opts = dict(H.OPTS, **kw)
    if kind == "paged":
        opts.setdefault("page_size", H.PAGE_SIZE)
    return jax_make_engine(cfg, jparams, kind=kind, **opts)


@pytest.mark.parametrize("kind", ["slot", "paged"])
@pytest.mark.parametrize("name", NAMES)
def test_mesh_engine_matches_jax_engine(name, kind):
    """Every mesh shape serves the workloads of the JAX engine, in the
    same order, with its tokens and shared stats, and the port's
    meshless engine's tokens."""
    tcfg = H.setup(name)[1]
    jeng = _jax_engine(name, kind)
    teng = H.engines(name, kind)[1]
    mengs = {shape: _mesh_engine(name, kind, shape) for shape in SHAPES}
    for work, prompts in ((FIXED, H.prompts_of(FIXED, tcfg.vocab_size, 3)),
                          H.workload(11, tcfg.vocab_size)):
        jout = H.serve(jeng, JaxRequest, work, prompts)
        tout = H.serve(teng, Request, work, prompts)
        for shape, meng in mengs.items():
            mout = H.serve(meng, Request, work, prompts)
            H.check_parity(jeng, jout, meng, mout)
            assert _tokens(mout) == _tokens(tout), shape
            assert meng.stats["engine"]["remeshes"] == 0
            assert meng.stats["decode_compiles"] == \
                jeng.stats["decode_compiles"]


def _storm(eng, request_cls, work, prompts):
    """Serve with two forced preemptions after the first window;
    completions sorted by rid."""
    eng.reset()
    H.submit(eng, request_cls, work, prompts)
    finished = []
    eng.step(finished)
    assert eng.preempt(2) == 2
    return sorted(eng.run(max_steps=4096)
                  + [H.completion(r) for r in finished], key=lambda c: c.rid)


@pytest.mark.parametrize("extra", [dict(num_pages=12), dict(kv_quant="int8"),
                                   dict()],
                         ids=["small-pool", "int8", "shared-prefix"])
def test_paged_mesh_pressure_int8_and_shared_prefixes(extra):
    name = "yi-6b"
    tcfg = H.setup(name)[1]
    jeng = _jax_engine(name, "paged", **extra)
    teng = H.engines(name, "paged", **extra)[1]
    work = H.WORKLOAD
    prompts = H.prompts_of(work, tcfg.vocab_size, seed=5, share=True)
    # On the small pool, a storm of two preemptions after the first
    # window (each resumes by re-prefill, under pool pressure).
    serve = _storm if "num_pages" in extra else H.serve
    jout = serve(jeng, JaxRequest, work, prompts)
    tout = serve(teng, Request, work, prompts)
    for shape in ((1, 2), (1, 4)):
        meng = _mesh_engine(name, "paged", shape, **extra)
        mout = serve(meng, Request, work, prompts)
        H.check_parity(jeng, jout, meng, mout)
        assert _tokens(mout) == _tokens(tout)
        for key in ("pages_shared", "page_admits", "page_grows", "page_cows",
                    "pages_mapped_peak", "pool_pages", "kv_pool"):
            assert meng.stats["engine"][key] == jeng.stats["engine"][key], \
                (shape, key)
        assert meng.stats["engine"]["pages_shared"] > 0
        if "num_pages" in extra:
            assert meng.stats["engine"]["preemptions"] == 2
            assert meng.stats["engine"]["pages_mapped_peak"] <= 12
        assert meng.cache.resident_bytes() == teng.cache.resident_bytes()
        assert meng.cache.n_free_pages == meng.cache.num_pages


def _ep_reference(ms, impl):
    """The reference's ``moe_apply`` as its sharded engine computes it on
    ``ms`` model shards: its own shard functions (``_moe_a2a`` where the
    sequence splits, else ``_moe_local`` with the psum) under
    ``jax.vmap`` over the named axis."""
    def moe_apply(p, x, cfg, *, mesh=None, batch_axes=(),
                  model_axis="model", valid=None):
        e = cfg.moe.n_experts
        el = e // ms
        b, s, d = x.shape
        ps = {k: (v.reshape(ms, el, *v.shape[1:]) if k != "router"
                  else jnp.stack([v] * ms)) for k, v in p.items()}
        if valid is None:
            valid = jnp.ones((b, s), bool)
        if impl == "all_to_all" and s % ms == 0 and s >= ms:
            xs = x.reshape(b, ms, s // ms, d).transpose(1, 0, 2, 3)
            vs = valid.reshape(b, ms, s // ms).transpose(1, 0, 2)
            y, aux = jax.vmap(lambda x_, v_, pp: jmoe._moe_a2a(
                x_, pp, cfg, cfg.act, "model", ms, valid=v_),
                axis_name="model")(xs, vs, ps)
            return y.transpose(1, 0, 2, 3).reshape(b, s, d), aux.mean()
        y, aux = jax.vmap(lambda pp: jmoe._moe_local(
            x, pp, cfg, cfg.act, jax.lax.axis_index("model") * el, el,
            "model", valid=valid), axis_name="model")(ps)
        return y[0], aux[0]

    return moe_apply


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_moe_all_to_all_ep(kind, monkeypatch):
    """``"all_to_all"`` EP against the JAX engine running the reference's
    own shard functions (``"psum"`` is held to the meshless JAX engine
    by ``test_mesh_engine_matches_jax_engine``)."""
    impl = "all_to_all"
    name = "phi3.5-moe-42b"
    cfg, tcfg, jparams, _ = H.setup(name)
    ms = 2
    monkeypatch.setattr(jmoe, "moe_apply", _ep_reference(ms, impl))
    opts = dict(H.OPTS)
    if kind == "paged":
        opts["page_size"] = H.PAGE_SIZE
    jeng = jax_make_engine(cfg, jparams, kind=kind, **opts)
    tmoe.set_ep_impl(impl)
    meng = _mesh_engine(name, kind, (1, ms))
    for work, prompts in ((FIXED, H.prompts_of(FIXED, tcfg.vocab_size, 3)),
                          H.workload(4, tcfg.vocab_size)):
        jout = H.serve(jeng, JaxRequest, work, prompts)
        mout = H.serve(meng, Request, work, prompts)
        H.check_parity(jeng, jout, meng, mout)
    assert meng.params.local[0]["layers"][0]["moe"]["up"].shape[0] == 2


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_storage_layout_and_remesh_drops_it(kind):
    name = "yi-6b"
    tcfg = H.setup(name)[1]
    eng = _mesh_engine(name, kind, (1, 2))
    plain = H.engines(name, kind)[1]
    work = FIXED[:3]
    prompts = H.prompts_of(work, tcfg.vocab_size, 1)
    H.serve(plain, Request, work, prompts)
    H.serve(eng, Request, work, prompts)
    store = eng.cache.pools if kind == "paged" else eng.cache.buffers
    k = store["pk" if kind == "paged" else "k"]
    assert isinstance(k, Sharded) and len(k.shards) == 2
    assert k.shards[0].shape[3] == tcfg.n_kv_heads // 2      # heads split
    assert eng.cache.resident_bytes() == plain.cache.resident_bytes()
    eng4 = _mesh_engine(name, kind, (1, 4))
    H.serve(eng4, Request, work, prompts)
    store4 = eng4.cache.pools if kind == "paged" else eng4.cache.buffers
    k4 = store4["pk" if kind == "paged" else "k"]
    assert k4.shards[0].shape[2] == k4.shape[2] // 4         # sequence
    # remesh: the requests in flight come back, the storage is new
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p.copy(), max_new_tokens=20))
    eng.step([])
    old = weakref.ref(eng.cache)
    old_params = weakref.ref(eng.params)
    victims = eng.remesh(virtual_mesh((1, 4), "cpu"))
    gc.collect()
    assert old() is None and old_params() is None
    assert sorted(v.rid for v in victims) == [0, 1, 2]
    assert all(not v.generated for v in victims)
    assert eng.stats["engine"]["remeshes"] == 1
    assert eng.mesh.shape == {"data": 1, "model": 4}
    done = sorted(eng.run(max_steps=4096), key=lambda c: c.rid)
    want = sorted(plain.run(max_steps=0), key=lambda c: c.rid)
    assert len(done) == 3 and not want
    plain.reset()
    for rid, p in enumerate(prompts):
        plain.submit(Request(rid=rid, prompt=p.copy(), max_new_tokens=20))
    want = sorted(plain.run(max_steps=4096), key=lambda c: c.rid)
    assert _tokens(done) == _tokens(want)


def test_what_the_slice_does_not_cover_raises():
    name = "yi-6b"
    _, tcfg, _, tparams = H.setup(name)
    mesh = virtual_mesh((1, 2), "cpu")
    with pytest.raises(ValueError, match="slot' or 'paged"):
        make_engine(tcfg, tparams, kind="sequential", mesh=mesh)
    with pytest.raises(ValueError, match="slot' or 'paged"):
        make_engine(tcfg, tparams, kind="sequential", mesh=mesh,
                    coexec_backend="kernel")
    with pytest.raises(ValueError, match="mesh-aware"):
        H.engines(name, "slot")[1].remesh(mesh)


# --------------------------------------------------------------------------
# Fault injection: a lost shard -> elastic re-mesh, not a crashed serve
# --------------------------------------------------------------------------
PROMPTS = [(5, 10), (13, 8), (9, 12), (21, 6), (7, 9)]


def _frontend_serve(engine, probe=None, **kw):
    fe = ServeFrontend(engine, device_probe=probe, **kw)
    try:
        fe.warmup(max_prompt_len=H.OPTS["max_seq"])
        rng = np.random.default_rng(11)
        handles = [fe.submit(rng.integers(0, 500, size=s).astype(np.int32),
                             b) for s, b in PROMPTS]
        comps = {h.rid: tuple(h.result(120).tokens) for h in handles}
        return comps, fe.metrics()
    finally:
        fe.shutdown(drain=False)


def _shrinking_probe(devices, n_failed):
    calls = {"n": 0}

    def probe():
        calls["n"] += 1
        return (simulate_failure(devices, n_failed) if calls["n"] > 2
                else devices)
    return probe


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_lost_shard_remeshes_and_resumes(kind):
    """Mid-serve the probe drops the last two of four devices: the
    frontend plans a (1, 2) mesh, the engine hands its requests back and
    re-prefills them there, and every stream resumes: completions equal
    an uninterrupted serve without a mesh."""
    name = "yi-6b"
    _, tcfg, _, tparams = H.setup(name)
    opts = dict(H.OPTS)
    if kind == "paged":
        opts["page_size"] = H.PAGE_SIZE
    want, _ = _frontend_serve(make_engine(tcfg, tparams, kind=kind,
                                          device="cpu", **opts))
    mesh = virtual_mesh((2, 2), "cpu")
    eng = make_engine(tcfg, tparams, kind=kind, mesh=mesh, **opts)
    devs = list(mesh.devices.flat)
    got, metrics = _frontend_serve(eng, _shrinking_probe(devs, 2),
                                   watchdog=StragglerWatchdog())
    assert got == want
    assert metrics["remeshes"] >= 1
    assert eng.stats["engine"]["remeshes"] >= 1
    assert eng.mesh.shape == {"data": 1, "model": 2}   # TP survived


def test_unserveable_shrink_keeps_limping():
    name = "yi-6b"
    _, tcfg, _, tparams = H.setup(name)
    want, _ = _frontend_serve(make_engine(tcfg, tparams, device="cpu",
                                          **H.OPTS))
    mesh = virtual_mesh((1, 2), "cpu")
    eng = make_engine(tcfg, tparams, mesh=mesh, **H.OPTS)
    got, metrics = _frontend_serve(
        eng, _shrinking_probe(list(mesh.devices.flat), 2), min_data=1)
    assert metrics["remeshes"] == 0
    assert eng.stats["engine"]["remeshes"] == 0
    assert got == want
