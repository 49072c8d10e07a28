"""Co-execution (``coexec_backend="kernel"``) in the port's slot and paged
engines on a ``("data", "model")`` mesh, against the JAX engine of the
same kind without a mesh and with ``coexec_backend="xla"``, on the smoke
configs of qwen2.5-0.5b (global attention, heads split at model 2),
phi3.5-moe-42b (MoE, expert-parallel), gemma3-1b (sliding-window layers,
attention whole) and recurrentgemma-2b (RG-LRU layers), on virtual CPU
meshes (1, 2) and (2, 2); whisper-base's are in
``tests/test_torch_sharded_enc_dec_serve.py``.

The flag moves the prefills the multi-tenant packer co-schedules with a
decode window to the window's boundary, where they park decode-ready
(as in the reference, it routes none of the engine's GEMMs through K6),
so the tokens are the engine's without it.  Held: tokens, finish
reasons and the shared stats (``check_parity``), ``backfilled``,
``packed_prefills``, ``coexec_tiles`` and ``coexec_interleave`` equal to
the JAX engine's, a backfill at least, every slot and page back.
"""
import pytest

import _torch_serve_parity as H
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro_torch.distributed import virtual_mesh
from repro_torch.serve import make_engine, Request

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NAMES = ("qwen2.5-0.5b", "phi3.5-moe-42b", "gemma3-1b", "recurrentgemma-2b")
COEXEC_KEYS = ("backfilled", "packed_prefills", "coexec_tiles",
               "coexec_interleave")


@pytest.mark.parametrize("kind", ["slot", "paged"])
@pytest.mark.parametrize("name", NAMES)
def test_coexec_on_a_mesh_matches_jax(name, kind):
    cfg, tcfg, jparams, tparams = H.setup(name)
    opts = dict(H.OPTS)
    if kind == "paged":
        opts["page_size"] = H.PAGE_SIZE
    prompts = H.prompts_of(H.WORKLOAD, tcfg.vocab_size, 3)
    jeng = jax_make_engine(cfg, jparams, kind=kind, coexec_backend="xla",
                           **opts)
    jout = H.serve(jeng, JaxRequest, H.WORKLOAD, prompts)
    for shape in ((1, 2), (2, 2)):
        meng = make_engine(tcfg, tparams, kind=kind,
                           mesh=virtual_mesh(shape, "cpu"),
                           coexec_backend="kernel", **opts)
        mout = H.serve(meng, Request, H.WORKLOAD, prompts)
        H.check_parity(jeng, jout, meng, mout)
        for key in COEXEC_KEYS:
            assert meng.stats[key] == jeng.stats[key], (shape, key)
        assert meng.stats["backfilled"] > 0 and meng.stats["coexec_tiles"]
        assert meng.stats["coexec_backend"] == "kernel"
        cache = meng.cache
        if kind == "slot":
            assert cache.n_free == meng.max_batch
        else:
            assert cache.n_free_pages == cache.num_pages
