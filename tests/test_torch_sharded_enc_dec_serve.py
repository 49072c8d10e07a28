"""whisper-base through the port's slot and paged engines on a ``("data",
"model")`` mesh (``smoke_config("whisper-base")``, float32, 4 slots,
``max_seq`` 64, windows of 4, pages of 8, 12 encoder frames), on virtual
CPU meshes (1, 2) (heads split), (2, 2) (the data row 0 computes) and
(1, 3) (nothing divides but the 12 frames of the dense cross stacks),
against a fresh JAX engine of the same kind without a mesh
(``check_parity``: tokens, finish reasons, the shared stats with
``remeshes``), as ``tests/test_torch_sharded_serve.py`` holds the
decoders:

* per-request seeded features, rid 3 carrying rid 0's (one shared cross
  block on paged) and rid 1 none (zeros); float and int8 global pools on
  paged (the cross pools at model precision); ``cross_admits``,
  ``cross_shared`` and the page extras the JAX engine's; the first
  holders' bytes (``resident_bytes(unique=True)``) the meshless port
  engine's, every slot, page and cross page back;
* co-execution (``coexec_backend="kernel"``) on (1, 2) and (2, 2)
  against the JAX engine with ``"xla"``: backfills, ``coexec_tiles``,
  ``coexec_interleave`` and ``packed_prefills`` equal;
* an elastic ``remesh`` (2, 2) -> (1, 2) of a paged engine after its
  first window: the requests in flight re-prefill (their features
  re-encoded, their cross blocks admitted anew) and finish with an
  uninterrupted (1, 2) serve's completions.
"""
import numpy as np
import pytest

import _torch_serve_parity as H
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro_torch.distributed import virtual_mesh
from repro_torch.distributed.mesh import Sharded
from repro_torch.serve import make_engine, Request

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NAME = "whisper-base"
SHAPES = ((1, 2), (2, 2), (1, 3))
# (prompt length, max_new_tokens): 8 requests on 4 slots around the
# window of 4, all within max_seq = 64.
WORK = [(1, 6), (7, 12), (15, 6), (16, 5), (17, 8), (23, 4), (31, 7),
        (33, 5)]
EXTRAS = ("cross_admits", "cross_shared", "page_admits", "page_grows",
          "pages_mapped_peak", "pages_shared")
_JAX = {}


def _opts(kind, **kw):
    opts = dict(H.OPTS, **kw)
    if kind == "paged":
        opts.setdefault("page_size", H.PAGE_SIZE)
    return opts


def _inputs(seed=1):
    """Prompts and features: rid 3 carries rid 0's features (one cross
    block), rid 1 none."""
    tcfg = H.setup(NAME)[1]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, tcfg.vocab_size, n, dtype=np.int32)
               for n, _ in WORK]
    enc = [rng.standard_normal((tcfg.enc_frames, tcfg.frontend_dim)
                               ).astype(np.float32) for _ in WORK]
    enc[1] = None
    enc[3] = enc[0]
    return prompts, enc


def _jax(kind, coexec=None, **kw):
    """The meshless JAX engine's serve of the workload, built once a
    key: (engine, completions)."""
    key = (kind, coexec, tuple(sorted(kw.items())))
    if key not in _JAX:
        cfg, _, jparams, _ = H.setup(NAME)
        jeng = jax_make_engine(cfg, jparams, kind=kind, coexec_backend=coexec,
                               **_opts(kind, **kw))
        prompts, enc = _inputs()
        _JAX[key] = (jeng, H.serve(jeng, JaxRequest, WORK, prompts, enc=enc))
    return _JAX[key]


def _drained(eng, kind):
    c = eng.cache
    if kind == "slot":
        return c.n_free == eng.max_batch
    return (c.n_free_pages == c.num_pages
            and c.n_free_cross == c.num_cross_pages
            and not any(c.cross_refcount(p)
                        for p in range(c.num_cross_pages)))


@pytest.mark.parametrize("kind,quant", [("slot", None), ("paged", None),
                                        ("paged", "int8")],
                         ids=["slot", "paged", "paged-int8"])
def test_mesh_engines_match_jax_engine(kind, quant):
    kw = {"kv_quant": quant} if quant else {}
    _, tcfg, _, tparams = H.setup(NAME)
    jeng, jout = _jax(kind, **kw)
    prompts, enc = _inputs()
    plain = make_engine(tcfg, tparams, kind=kind, device="cpu",
                        **_opts(kind, **kw))
    H.serve(plain, Request, WORK, prompts, enc=enc)
    for shape in SHAPES:
        meng = make_engine(tcfg, tparams, kind=kind,
                           mesh=virtual_mesh(shape, "cpu"),
                           **_opts(kind, **kw))
        mout = H.serve(meng, Request, WORK, prompts, enc=enc)
        H.check_parity(jeng, jout, meng, mout)
        assert meng.cache.resident_bytes(unique=True) == \
            plain.cache.resident_bytes(), shape
        store = meng.cache.pools if kind == "paged" else meng.cache.buffers
        assert all(isinstance(t, Sharded) and len(t.shards) == shape[1]
                   for t in store.values())
        assert {"ck", "cv"} <= set(store) if kind == "paged" \
            else {"xk", "xv"} <= set(store)
        assert _drained(meng, kind), shape
        if kind == "paged":
            jext, mext = jeng.stats["engine"], meng.stats["engine"]
            for key in EXTRAS:
                assert mext[key] == jext[key], (shape, key)
            assert mext["cross_shared"] >= 1


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_coexec_on_a_mesh_matches_jax(kind):
    _, tcfg, _, tparams = H.setup(NAME)
    jeng, jout = _jax(kind, coexec="xla")
    prompts, enc = _inputs()
    for shape in ((1, 2), (2, 2)):
        meng = make_engine(tcfg, tparams, kind=kind,
                           mesh=virtual_mesh(shape, "cpu"),
                           coexec_backend="kernel", **_opts(kind))
        mout = H.serve(meng, Request, WORK, prompts, enc=enc)
        H.check_parity(jeng, jout, meng, mout)
        for key in ("backfilled", "packed_prefills", "coexec_tiles",
                    "coexec_interleave"):
            assert meng.stats[key] == jeng.stats[key], (shape, key)
        assert meng.stats["backfilled"] > 0 and meng.stats["coexec_tiles"]
        assert meng.stats["coexec_backend"] == "kernel"
        assert _drained(meng, kind)


def test_paged_remesh_finishes_as_an_uninterrupted_serve():
    _, tcfg, _, tparams = H.setup(NAME)
    prompts, enc = _inputs(seed=2)
    want = H.serve(make_engine(tcfg, tparams, kind="paged",
                               mesh=virtual_mesh((1, 2), "cpu"),
                               **_opts("paged")),
                   Request, WORK, prompts, enc=enc)
    eng = make_engine(tcfg, tparams, kind="paged",
                      mesh=virtual_mesh((2, 2), "cpu"), **_opts("paged"))
    eng.reset()
    H.submit(eng, Request, WORK, prompts, enc=enc)
    finished = []
    eng.step(finished)
    assert eng.cache.n_free_cross < eng.cache.num_cross_pages
    victims = eng.remesh(virtual_mesh((1, 2), "cpu"))
    assert victims and all(not v.generated for v in victims)
    assert eng.stats["engine"]["remeshes"] == 1
    assert eng.mesh.shape == {"data": 1, "model": 2}
    assert eng.cache.n_free_cross == eng.cache.num_cross_pages
    got = sorted(eng.run(max_steps=4096) + [H.completion(r)
                                            for r in finished],
                 key=lambda c: c.rid)
    assert [(c.rid, c.tokens, c.finish_reason) for c in got] == \
        [(c.rid, c.tokens, c.finish_reason) for c in want]
    assert _drained(eng, "paged")
