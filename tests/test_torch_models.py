"""The port's model (repro_torch.models) against the JAX model on the CPU.

Both packages get the same weights (the reference's seeded init, handed
over as numpy through ``repro_torch.convert.params_from_jax``) and the
same seeded numpy tokens.  Everything runs in float32 on the smoke
configs; logits agree within 1e-4 (f32 sums in another order) and the
greedy tokens are identical.  The MoE configs route with the reference's
default dense experts and the port's flat dispatch (K4's plain version).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import init_params as jax_init
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import forward_decode, forward_prefill, init_cache

ARCHS = ["qwen2.5-0.5b", "granite-20b", "yi-6b", "phi3.5-moe-42b",
         "dbrx-132b"]
TOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = smoke_config(request.param)
    jparams = jax_init(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              torch_smoke_config(request.param),
                              device="cpu")
    return cfg, torch_smoke_config(request.param), jparams, tparams


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def test_config_copy_matches_reference(model):
    cfg, tcfg, _, _ = model
    # asdict: a nested MoEConfig is a different class in each package.
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("index", ["last", "scalar", "vector"])
def test_prefill_logits_and_cache(model, index):
    cfg, tcfg, jparams, tparams = model
    toks = _tokens(1, 2, 12, cfg.vocab_size)
    if index == "last":
        jidx = tidx = None
    elif index == "scalar":
        jidx, tidx = jnp.int32(7), 7
    else:
        jidx, tidx = jnp.asarray([4, 11], jnp.int32), torch.tensor([4, 11])
    jl, jc = jax_prefill(jparams, cfg, {"tokens": jnp.asarray(toks)},
                         cache_len=16, logits_index=jidx)
    tl, tc = forward_prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                             cache_len=16, logits_index=tidx)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert tc["k"].shape == init_cache(tcfg, 2, 16, torch.float32,
                                       device="cpu")["k"].shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    assert (tl.argmax(-1).numpy() == np.asarray(jnp.argmax(jl, -1))).all()
    # One scanned group (pattern (ATTN,)) stacks exactly like the port.
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc[0]["b0"]["k"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc[0]["b0"]["v"]),
                               rtol=TOL, atol=TOL)


def test_paged_decode_logits(model):
    """Three paged decode steps from a prefilled pool: rows at different
    positions, pages scattered, unmapped entries on the sink page."""
    cfg, tcfg, jparams, tparams = model
    psz, n_pages, pmax = 4, 10, 5
    lens = [5, 9]
    toks = _tokens(2, 2, 12, cfg.vocab_size)
    _, tc = forward_prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    k = tc["k"].numpy()
    v = tc["v"].numpy()
    n_layers, _, _, hkv, hd = k.shape
    pk = np.zeros((n_layers, n_pages + 1, psz, hkv, hd), np.float32)
    pv = np.zeros_like(pk)
    table = np.full((2, pmax), n_pages, np.int32)
    table[0, :3] = [7, 2, 5]
    table[1, :4] = [0, 9, 3, 6]
    for row, n in enumerate(lens):
        for t in range(n):
            pg, off = table[row, t // psz], t % psz
            pk[:, pg, off] = k[:, row, t]
            pv[:, pg, off] = v[:, row, t]
    pos = np.asarray(lens, np.int32)
    cur = toks[np.arange(2), pos - 1][:, None]
    jpools = [{"b0": {"pk": jnp.asarray(pk), "pv": jnp.asarray(pv)}}]
    tpools = {"pk": torch.from_numpy(pk.copy()),
              "pv": torch.from_numpy(pv.copy())}
    for _ in range(3):
        jl, jpools = jax_decode(jparams, cfg, jnp.asarray(cur), jpools,
                                jnp.asarray(pos), page_table=jnp.asarray(table))
        tl, tpools = forward_decode(tparams, tcfg, torch.from_numpy(cur),
                                    tpools, torch.from_numpy(pos),
                                    page_table=torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        nxt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1))
        assert (tl[:, -1, :cfg.vocab_size].argmax(-1).numpy() == nxt).all()
        cur = nxt.astype(np.int32)[:, None]
        pos = pos + 1
    np.testing.assert_allclose(tpools["pk"].numpy(),
                               np.asarray(jpools[0]["b0"]["pk"]),
                               rtol=TOL, atol=TOL)
