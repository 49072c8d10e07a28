"""The port's sliding-window, RG-LRU and RWKV6 mixers on a ``("data",
"model")`` mesh against the JAX package's functions (and the port's own
meshless paged ring step), on virtual CPU meshes ``(1, 2)`` and
``(1, 4)``, in float32.

* Windowed attention on ``smoke_config("gemma3-1b")``'s first layer (4/1
  heads: attention runs whole, its caches split on the sequence) and on
  the same structure with 2 KV heads (heads split at model 2): the
  prompt's output and ring cache at a ``(B,)`` ``last_index`` past the
  window, dense decode steps across the ring's wrap (``pos % cap`` lands
  on another rank's cells where the ring is split), and the paged ring
  step over ``"lk","lv"`` pools laid out by ``cache_specs``.
* RG-LRU (``smoke_config("recurrentgemma-2b")``, channel-parallel):
  prefill's output and cache at no, a scalar and a ``(B,)``
  ``last_index``, decode steps whose ``conv`` stays whole and equal on
  every rank; on 3 ranks, which 64 channels do not divide, whole.
* RWKV6 (``smoke_config("rwkv6-3b")``, 8 heads split): S on and off
  ``CHUNK``, prefill state, decode; and a width of 6 heads that do not
  divide 4 ranks, where the time-mix runs whole.

``TOL = 1e-5``; WKV outputs and states ``WKV_TOL = 1e-4``, as in
``tests/test_torch_recurrent.py`` (the chunked form scales its factors
by up to ``e^44.8``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import attention as jattn
from repro.models import init_params as jax_init
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import (cache_specs, P, place_params,
                                     virtual_mesh)
from repro_torch.distributed.mesh import Sharded
from repro_torch.models import attention as tattn
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.common import tensor_parallel

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5
WKV_TOL = 1e-4
SHAPES = ((1, 2), (1, 4))
_SETUPS = {}


def _setup(name, **overrides):
    """(JAX cfg, port cfg, JAX first-layer mixer, port params) of a smoke
    config (with ``overrides``); the first layer's zero gates (RG-LRU)
    and constant mixes (WKV) redrawn at random in both packages."""
    key = (name, tuple(sorted(overrides.items())))
    if key not in _SETUPS:
        cfg = dataclasses.replace(smoke_config(name), **overrides)
        tcfg = dataclasses.replace(torch_smoke_config(name), **overrides)
        tree = jax.tree.map(np.array, jax_init(cfg, jax.random.PRNGKey(0)))
        mix = tree["groups"][0]["b0"]["mixer"]
        rng = np.random.default_rng(5)
        for k in ("gate_r", "gate_i", "mu"):
            if k in mix:
                mix[k][0] = rng.uniform(-1, 1, mix[k][0].shape)
        jmix = jax.tree.map(lambda x: jnp.asarray(x[0]), mix)
        _SETUPS[key] = (cfg, tcfg, jmix,
                        params_from_jax(tree, tcfg, device="cpu"))
    return _SETUPS[key]


def _ranks(tparams, tcfg, shape):
    """The model row's first-layer mixers, the split and the mesh."""
    mesh = virtual_mesh(shape, "cpu")
    placed = place_params(tparams, tcfg, mesh)
    return ([t["layers"][0]["mixer"] for t in placed.local],
            tensor_parallel(tcfg, mesh), mesh)


def _sharded(name, t, tcfg, mesh):
    """One layer's ``t`` laid out as ``cache_specs`` lays its stack."""
    spec = cache_specs({name: torch.empty((1,) + tuple(t.shape),
                                          device="meta")}, tcfg, mesh,
                       batch_axes=())[name]
    return Sharded.of(t, P(*tuple(spec)[1:]), mesh)


def _x(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# --------------------------------------------------------------------------
# Sliding-window attention
# --------------------------------------------------------------------------
ATTN_CASES = {"1x2-seq": ((1, 2), {}), "1x4-seq": ((1, 4), {}),
              "1x2-heads": ((1, 2), {"n_kv_heads": 2})}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_windowed_attention_across_the_ring(case):
    shape, over = ATTN_CASES[case]
    cfg, tcfg, jp, tparams = _setup("gemma3-1b", **over)
    ps, tp, mesh = _ranks(tparams, tcfg, shape)
    assert tp.head_ok == ("n_kv_heads" in over)
    cap = cfg.sliding_window
    last = np.array([19, 12, 5], np.int32)            # past, in, short
    x = _x(cfg, 3, 20, seed=1)
    want = jattn.attn_apply(jp, jnp.asarray(x), cfg, kind="local")
    mix, k, v = tattn.attn_apply_tp(ps, torch.from_numpy(x), tcfg, tp,
                                    kind="local")
    _close(mix.numpy(), want, what="prefill")
    jc = jattn.prefill_into_cache(jp, jnp.asarray(x), cfg, kind="local",
                                  cap=cap, last_index=jnp.asarray(last))
    tc = tattn.prefill_into_cache(k, v, cap, torch.from_numpy(last))
    for n in ("k", "v"):
        _close(tc[n].numpy(), jc[n], what=f"cache {n}")
    sc = {n: _sharded("w" + n, tc[n], tcfg, mesh) for n in ("k", "v")}
    split = 2 if tp.head_ok else 1
    assert sc["k"].shards[0].shape[split] == sc["k"].shape[split] // shape[1]
    rng = np.random.default_rng(2)
    pos = last + 1
    for t in range(7):                  # rows 0 and 1 cross cells 15 -> 0
        xt = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jout, jc = jattn.attn_decode_step(jp, jnp.asarray(xt), jc,
                                          jnp.asarray(pos), cfg, kind="local")
        tout = tattn.attn_decode_step_tp(ps, torch.from_numpy(xt), sc,
                                         torch.from_numpy(pos).long(), tcfg,
                                         tp)
        _close(tout.numpy(), jout, what=f"decode {t}")
        pos = pos + 1
    for n in ("k", "v"):
        _close(sc[n].gather().numpy(), jc[n], what=f"ring {n}")


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_paged_ring_step_matches_the_meshless_step(case):
    """Ring pools of 12 pages of 8 (``R`` 3 a row) split by
    ``cache_specs`` (KV heads, or the page interior), four steps across
    a ring block's edge: the outputs and the pools equal the port's
    meshless paged ring step's."""
    shape, over = ATTN_CASES[case]
    _, tcfg, _, tparams = _setup("gemma3-1b", **over)
    ps, tp, mesh = _ranks(tparams, tcfg, shape)
    g = torch.Generator().manual_seed(3)
    shape_pool = (13, 8, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    pools = {n: torch.randn(shape_pool, generator=g) for n in ("lk", "lv")}
    sp = {n: _sharded(n, t, tcfg, mesh) for n, t in pools.items()}
    table = torch.tensor([[4, 9, 1], [7, 0, 11], [2, 5, 8]],
                         dtype=torch.int32)
    pos = torch.tensor([22, 14, 9], dtype=torch.int32)
    for t in range(4):
        xt = torch.randn((3, 1, tcfg.d_model), generator=g)
        want, _ = tattn.paged_local_attn_decode_step(
            tparams["layers"][0]["mixer"], xt, pools, table, pos, tcfg,
            window_cap=16)
        got = tattn.paged_local_attn_decode_step_tp(
            ps, xt, sp, table, pos, tcfg, tp, window_cap=16)
        _close(got.numpy(), want.numpy(), what=f"step {t}")
        pos = pos + 1
    for n in pools:
        _close(sp[n].gather().numpy(), pools[n].numpy(), what=n)


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------
RG_LAST = {"none": None, "scalar": np.int32(11),
           "vector": np.array([0, 1, 19], np.int32)}


@pytest.mark.parametrize("layout", sorted(RG_LAST))
@pytest.mark.parametrize("shape", SHAPES + ((1, 3),),
                         ids=lambda s: "%dx%d" % s)
def test_rglru_prefill_and_decode_on_a_mesh(shape, layout):
    """At (1, 3) the 64 channels do not divide: the block runs whole and
    every rank keeps a whole copy of the state."""
    cfg, tcfg, jp, tparams = _setup("recurrentgemma-2b")
    ps, tp, mesh = _ranks(tparams, tcfg, shape)
    assert (tp.rglru_cols is None) == (shape == (1, 3))
    last = RG_LAST[layout]
    x = _x(cfg, 3, 20, seed=4)
    want = jrglru.rglru_apply(jp, jnp.asarray(x), cfg)
    _close(trglru.rglru_apply_tp(ps, torch.from_numpy(x), tcfg, tp).numpy(),
           want, what="apply")
    out, tc = trglru.rglru_prefill_tp(
        ps, torch.from_numpy(x), tcfg, tp,
        None if last is None else torch.from_numpy(np.asarray(last)))
    _close(out.numpy(), want, what="prefill")
    jc = jrglru.rglru_prefill_cache(
        jp, jnp.asarray(x), cfg,
        last_index=None if last is None else jnp.asarray(last))
    for n in ("h", "conv"):
        _close(tc[n].numpy(), jc[n], what=f"cache {n}")
    sc = {n: _sharded(n, tc[n], tcfg, mesh) for n in ("h", "conv")}
    split = P(None, "model") if tp.rglru_cols else P()
    assert sc["h"].spec == split and sc["conv"].spec == P()
    rng = np.random.default_rng(6)
    for t in range(5):
        xt = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jout, jc = jrglru.rglru_decode_step(jp, jnp.asarray(xt), jc, cfg)
        tout = trglru.rglru_decode_step_tp(ps, torch.from_numpy(xt), sc,
                                           tcfg, tp)
        _close(tout.numpy(), jout, what=f"decode {t}")
        for n in ("conv",) if tp.rglru_cols else ("h", "conv"):
            first = sc[n].shards[0]
            assert all(torch.equal(c, first) for c in sc[n].shards[1:])
    for n in ("h", "conv"):
        _close(sc[n].gather().numpy(), jc[n], what=f"state {n}")


# --------------------------------------------------------------------------
# RWKV6
# --------------------------------------------------------------------------
WKV_CASES = {"1x2": ((1, 2), {}), "1x4": ((1, 4), {}),
             "1x4-whole": ((1, 4), {"d_model": 48})}


@pytest.mark.parametrize("s", [32, 40])
@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_rwkv_prefill_and_decode_on_a_mesh(case, s):
    shape, over = WKV_CASES[case]
    cfg, tcfg, jp, tparams = _setup("rwkv6-3b", **over)
    ps, tp, mesh = _ranks(tparams, tcfg, shape)
    assert (tp.wkv_heads is None) == ("d_model" in over)
    last = np.array([s - 1, 7, 30], np.int32)
    x = _x(cfg, 3, s, seed=s)
    jy = jrwkv.rwkv_apply(jp, jnp.asarray(x), cfg)
    _close(trwkv.rwkv_apply_tp(ps, torch.from_numpy(x), tcfg, tp).numpy(),
           jy, tol=WKV_TOL, what="apply")
    jy, jc = jrwkv.rwkv_apply(jp, jnp.asarray(x), cfg, return_state=True,
                              last_index=jnp.asarray(last))
    ty, tc = trwkv.rwkv_apply_tp(ps, torch.from_numpy(x), tcfg, tp,
                                 return_state=True,
                                 last_index=torch.from_numpy(last))
    _close(ty.numpy(), jy, tol=WKV_TOL, what="prefill")
    for n in ("state", "shift"):
        _close(tc[n].numpy(), jc[n], tol=WKV_TOL, what=f"cache {n}")
    sc = {n: _sharded(n, tc[n], tcfg, mesh) for n in ("state", "shift")}
    rng = np.random.default_rng(8)
    for t in range(4):
        xt = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jout, jc = jrwkv.rwkv_decode_step(jp, jnp.asarray(xt), jc, cfg)
        tout = trwkv.rwkv_decode_step_tp(ps, torch.from_numpy(xt), sc, tcfg,
                                         tp)
        _close(tout.numpy(), jout, tol=WKV_TOL, what=f"decode {t}")
    for n in ("state", "shift"):
        _close(sc[n].gather().numpy(), jc[n], tol=WKV_TOL, what=f"state {n}")
