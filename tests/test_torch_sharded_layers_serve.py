"""The port's slot and paged engines on a ``("data", "model")`` mesh for
the decoders of sliding-window, RG-LRU and RWKV6 layers and the vision
stub (``smoke_config`` of gemma3-1b, recurrentgemma-2b, rwkv6-3b and
internvl2-76b), on virtual CPU meshes, against a fresh JAX engine of the
same kind without a mesh (``check_parity``: tokens, finish reasons and
the shared stats), as ``tests/test_torch_sharded_serve.py`` holds the
global-attention decoders:

* every model through slot and paged on (1, 2), (2, 2) and (1, 4), on
  prompts across the window (16) and, on slot, past ``max_seq``; the
  storage's bytes, each replicated stack counted once, equal to the
  meshless port engine's, and ``conv`` whole on every rank;
* gemma3's global layers on int8 pools;
* ``ServeFrontend`` over a (2, 2) mesh that loses two devices re-meshes
  to (1, 2) and finishes recurrentgemma's streams as an uninterrupted
  serve without a mesh does.
"""
import numpy as np
import pytest
import torch

import _torch_serve_parity as H
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro_torch.distributed import (simulate_failure, StragglerWatchdog,
                                     virtual_mesh)
from repro_torch.distributed.mesh import Sharded
from repro_torch.serve import make_engine, Request, ServeFrontend

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NAMES = ("gemma3-1b", "recurrentgemma-2b", "rwkv6-3b", "internvl2-76b")
SHAPES = ((1, 2), (2, 2), (1, 4))
# (prompt length, max_new_tokens): inside and across the smoke window
# (16); slot adds a prompt past max_seq (64), which paged refuses.
WORK = [(5, 6), (17, 8), (33, 5), (9, 7)]
SLOT_WORK = WORK + [(70, 4)]


def _opts(kind, **kw):
    opts = dict(H.OPTS, **kw)
    if kind == "paged":
        opts.setdefault("page_size", H.PAGE_SIZE)
    return opts


def _store(eng):
    return eng.cache.pools if hasattr(eng.cache, "pools") \
        else eng.cache.buffers


@pytest.mark.parametrize("kind", ["slot", "paged"])
@pytest.mark.parametrize("name", NAMES)
def test_mesh_engines_match_jax_engine(name, kind):
    cfg, tcfg, jparams, tparams = H.setup(name)
    work = SLOT_WORK if kind == "slot" else WORK
    prompts = H.prompts_of(work, tcfg.vocab_size, 9)
    jeng = jax_make_engine(cfg, jparams, kind=kind, **_opts(kind))
    jout = H.serve(jeng, JaxRequest, work, prompts)
    plain = make_engine(tcfg, tparams, kind=kind, device="cpu",
                        **_opts(kind))
    H.serve(plain, Request, work, prompts)
    for shape in SHAPES:
        meng = make_engine(tcfg, tparams, kind=kind,
                           mesh=virtual_mesh(shape, "cpu"), **_opts(kind))
        mout = H.serve(meng, Request, work, prompts)
        H.check_parity(jeng, jout, meng, mout)
        assert meng.cache.resident_bytes(unique=True) == \
            plain.cache.resident_bytes(), shape
        store = _store(meng)
        assert all(isinstance(t, Sharded) and len(t.shards) == shape[1]
                   for t in store.values())
        if "conv" in store:
            first = store["conv"].shards[0]
            assert first.shape == store["conv"].shape
            assert all(c.equal(first) for c in store["conv"].shards)


def test_gemma3_int8_pools_on_a_mesh_match_jax():
    name = "gemma3-1b"
    cfg, tcfg, jparams, tparams = H.setup(name)
    prompts = H.prompts_of(WORK, tcfg.vocab_size, 10)
    opts = _opts("paged", kv_quant="int8")
    jeng = jax_make_engine(cfg, jparams, kind="paged", **opts)
    jout = H.serve(jeng, JaxRequest, WORK, prompts)
    meng = make_engine(tcfg, tparams, kind="paged",
                       mesh=virtual_mesh((1, 2), "cpu"), **opts)
    H.check_parity(jeng, jout, meng, H.serve(meng, Request, WORK, prompts))
    assert meng.cache.pools["pk"].shards[0].dtype == torch.int8


PROMPTS = [(5, 10), (13, 8), (21, 12), (9, 6)]


def _frontend_serve(engine, probe=None, **kw):
    fe = ServeFrontend(engine, device_probe=probe, **kw)
    try:
        fe.warmup(max_prompt_len=H.OPTS["max_seq"])
        rng = np.random.default_rng(12)
        handles = [fe.submit(rng.integers(0, 500, size=s).astype(np.int32),
                             b) for s, b in PROMPTS]
        comps = {h.rid: tuple(h.result(120).tokens) for h in handles}
        return comps, fe.metrics()
    finally:
        fe.shutdown(drain=False)


def test_lost_shard_remeshes_recurrentgemma():
    """Mid-serve the probe drops the last two of four devices: the
    paged engine re-meshes to (1, 2), re-prefills the requests in flight
    (their rings and state slabs rebuilt there), and every stream equals
    an uninterrupted serve without a mesh."""
    _, tcfg, _, tparams = H.setup("recurrentgemma-2b")
    opts = _opts("paged")
    want, _ = _frontend_serve(make_engine(tcfg, tparams, kind="paged",
                                          device="cpu", **opts))
    mesh = virtual_mesh((2, 2), "cpu")
    eng = make_engine(tcfg, tparams, kind="paged", mesh=mesh, **opts)
    devs = list(mesh.devices.flat)
    calls = {"n": 0}

    def probe():
        calls["n"] += 1
        return simulate_failure(devs, 2) if calls["n"] > 2 else devs

    got, metrics = _frontend_serve(eng, probe, watchdog=StragglerWatchdog())
    assert got == want
    assert metrics["remeshes"] >= 1
    assert eng.mesh.shape == {"data": 1, "model": 2}
