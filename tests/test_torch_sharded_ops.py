"""The port's sharded operations against the JAX package's, on virtual
CPU meshes, in float32 at 1e-5:

* ``paged_attention_sharded`` at 2 and 4 shards (heads split) and its
  fallback (heads that do not divide: the pools split on the page
  interior, gathered for one call), float and int8 pools, against
  ``paged_attention(impl="xla")``;
* expert-parallel ``moe_apply``: ``"psum"`` against the reference's
  ``moe_apply`` without a mesh; ``"all_to_all"`` against the
  reference's ``_moe_a2a`` run under ``jax.vmap`` over a named axis (its
  own shard function, whose capacity is per shard), and against
  ``moe_apply`` without a mesh where no capacity binds; the fallbacks
  (experts or sequence the model axis does not divide);
* ``a2a_segments`` equal to the reference's;
* the sharded model: ``forward_prefill`` and dense ``forward_decode``
  on a mesh against the reference's without one, and paged decode
  against the port's own without one; sliding-window, recurrent and
  frontend models the same way (WKV's tolerance, 1e-4, for all five),
  and the enc-dec model (whisper-base: encoder, cross K/V, the decode
  embedding's √d).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.kernels import paged_attention as ref_paged_attention
from repro.kernels.grouped_gemm import a2a_segments as ref_a2a_segments
from repro.kernels.paged_attn import quantize_page_pool as ref_quantize
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import init_params as jax_init
from repro.models import moe as jmoe
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.distributed import (cache_specs, P, place_params,
                                     virtual_mesh)
from repro_torch.distributed.mesh import Sharded
from repro_torch.kernels import a2a_segments, paged_attention_sharded
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as T

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5


def _to_torch(x):
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.fixture(autouse=True)
def _psum_default():
    yield
    tmoe.set_ep_impl("psum")


# --------------------------------------------------------------------------
# paged_attention_sharded
# --------------------------------------------------------------------------
def _pool_spec(pool_shape, cfg, mesh, name):
    """A layer's pool spec: ``cache_specs`` of the stacked pool, without
    the layer dimension."""
    spec = cache_specs({name: torch.empty((1,) + tuple(pool_shape),
                                          device="meta")}, cfg, mesh,
                       batch_axes=())[name]
    return P(*tuple(spec)[1:])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", [(2, 8, 4), (4, 8, 4), (4, 6, 2),
                                  (2, 3, 1)],
                         ids=["2x8/4", "4x8/4", "4x6/2-fallback",
                              "2x3/1-fallback"])
def test_paged_attention_sharded_matches_xla(case, int8):
    ms, n_heads, n_kv = case
    b, hd, psz, n_pages, pmax = 5, 8, 8, 13, 5
    rng = np.random.default_rng(ms * 10 + n_heads)
    q = rng.standard_normal((b, n_heads, hd)).astype(np.float32)
    kv = [rng.standard_normal((n_pages + 1, psz, n_kv, hd)).astype(
        np.float32) for _ in range(2)]
    pos = np.asarray([0, 7, 8, 21, 39], np.int32)    # page edges, full
    table = np.full((b, pmax), n_pages, np.int32)
    pages = rng.permutation(n_pages).astype(np.int32)
    for row, p in enumerate(pos):
        n = p // psz + 1
        table[row, :n] = pages[:n]
        pages = pages[n:]
    if int8:
        (pk, pks), (pv, pvs) = (ref_quantize(jnp.asarray(x)) for x in kv)
        scales = dict(pk_scale=pks, pv_scale=pvs)
    else:
        pk, pv = map(jnp.asarray, kv)
        scales = {}
    want = np.asarray(ref_paged_attention(
        jnp.asarray(q), pk, pv, jnp.asarray(table), jnp.asarray(pos),
        impl="xla", **scales))

    cfg = dataclasses.replace(torch_smoke_config("yi-6b"), n_heads=n_heads,
                              n_kv_heads=n_kv, head_dim=hd)
    mesh = virtual_mesh((1, ms), "cpu")
    head_ok = n_heads % ms == 0 and n_kv % ms == 0
    qs = Sharded.of(torch.from_numpy(q), P(None, "model") if head_ok
                    else P(), mesh)

    def pool(name, x):
        t = _to_torch(x)
        return Sharded.of(t, _pool_spec(t.shape, cfg, mesh, name), mesh)

    sp = {k: pool(n, v) for k, n, v in
          (("pk", "pk", pk), ("pv", "pv", pv))}
    if int8:
        sp.update(pk_scale=pool("pk_s", pks), pv_scale=pool("pv_s", pvs))
    if head_ok:
        assert sp["pk"].shards[0].shape[2] == n_kv // ms
    else:
        assert sp["pk"].shards[0].shape[1] == psz // ms
    out = paged_attention_sharded(qs, sp["pk"], sp["pv"],
                                  torch.from_numpy(table),
                                  torch.from_numpy(pos), mesh=mesh,
                                  pk_scale=sp.get("pk_scale"),
                                  pv_scale=sp.get("pv_scale"))
    assert len(out.shards) == ms
    np.testing.assert_allclose(out.gather().numpy(), want, rtol=TOL,
                               atol=TOL)


# --------------------------------------------------------------------------
# Expert-parallel MoE
# --------------------------------------------------------------------------
def _moe_case(capacity_factor=None):
    cfg = smoke_config("phi3.5-moe-42b")
    tcfg = torch_smoke_config("phi3.5-moe-42b")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    p = jmoe.moe_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return cfg, tcfg, p, tp


def _ref_moe(p, cfg, x, valid=None):
    """The reference's meshless ``moe_apply``, jitted."""
    fn = jax.jit(lambda p_, x_, v_: jmoe.moe_apply(p_, x_, cfg, valid=v_)[0])
    return np.asarray(fn(p, jnp.asarray(x),
                         None if valid is None else jnp.asarray(valid)))


def _ranks(tp, tcfg, mesh):
    """The model row's local MoE trees, placed by ``param_specs``."""
    loc = place_params({"layers": [{"moe": tp}]}, tcfg, mesh).local
    return [t["layers"][0]["moe"] for t in loc]


def _ref_a2a(p, cfg, x, valid, ms):
    """The reference's ``_moe_a2a`` shard function on ``ms`` shards of
    the sequence, run under ``jax.vmap`` over the named model axis."""
    b, s, d = x.shape
    el = cfg.moe.n_experts // ms
    xs = jnp.asarray(x).reshape(b, ms, s // ms, d).transpose(1, 0, 2, 3)
    vs = jnp.asarray(valid).reshape(b, ms, s // ms).transpose(1, 0, 2)
    ps = {k: (v.reshape(ms, el, *v.shape[1:]) if k != "router"
              else jnp.stack([v] * ms)) for k, v in p.items()}
    y, _ = jax.jit(jax.vmap(lambda x_, v_, pp: jmoe._moe_a2a(
        x_, pp, cfg, cfg.act, "model", ms, valid=v_),
        axis_name="model"))(xs, vs, ps)
    return np.asarray(y.transpose(1, 0, 2, 3).reshape(b, s, d))


@pytest.mark.parametrize("ms", [2, 4])
@pytest.mark.parametrize("s,n_real", [(16, 16), (32, 17), (8, 3), (1, 1)])
def test_ep_moe_matches_reference(ms, s, n_real):
    cfg, tcfg, p, tp = _moe_case()
    rng = np.random.default_rng(ms * 100 + s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    valid = np.broadcast_to(np.arange(s) < n_real, (2, s)).copy()
    mesh = virtual_mesh((1, ms), "cpu")
    ranks = _ranks(tp, tcfg, mesh)
    assert ranks[0]["up"].shape[0] == cfg.moe.n_experts // ms
    want = _ref_moe(p, cfg, x, valid)
    tmoe.set_ep_impl("psum")
    got = tmoe.moe_apply(ranks, torch.from_numpy(x), tcfg, mesh=mesh,
                         valid=torch.from_numpy(valid))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    tmoe.set_ep_impl("all_to_all")
    got = tmoe.moe_apply(ranks, torch.from_numpy(x), tcfg, mesh=mesh,
                         valid=torch.from_numpy(valid))[0].numpy()
    if s % ms == 0:
        np.testing.assert_allclose(got, _ref_a2a(p, cfg, x, valid, ms),
                                   rtol=TOL, atol=TOL)
    else:    # a sequence the model axis does not split takes "psum"
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ms", [2, 4])
def test_ep_all_to_all_equals_unsharded_without_drops(ms):
    """With capacity to spare (no pair dropped on any shard or whole)
    the per-shard capacities cannot differ in effect: the all-to-all EP
    output is the reference's meshless one."""
    cfg, tcfg, p, tp = _moe_case(capacity_factor=4.0)
    rng = np.random.default_rng(ms)
    x = rng.normal(size=(1, 32, cfg.d_model)).astype(np.float32)
    mesh = virtual_mesh((1, ms), "cpu")
    tmoe.set_ep_impl("all_to_all")
    got = tmoe.moe_apply(_ranks(tp, tcfg, mesh), torch.from_numpy(x), tcfg,
                         mesh=mesh)[0]
    np.testing.assert_allclose(got.numpy(), _ref_moe(p, cfg, x), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape", [(1, 3), (1, 8)])
def test_ep_experts_not_dividing_replicate(shape):
    cfg, tcfg, p, tp = _moe_case()
    x = np.random.default_rng(1).normal(
        size=(1, 24, cfg.d_model)).astype(np.float32)
    mesh = virtual_mesh(shape, "cpu")
    ranks = _ranks(tp, tcfg, mesh)
    assert ranks[0]["up"].shape[0] == cfg.moe.n_experts
    want = _ref_moe(p, cfg, x)
    for impl in ("psum", "all_to_all"):
        tmoe.set_ep_impl(impl)
        got = tmoe.moe_apply(ranks, torch.from_numpy(x), tcfg, mesh=mesh)[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        tmoe.set_ep_impl("ring")


@pytest.mark.parametrize("e_local,ms,cap", [(1, 2, 8), (2, 2, 16),
                                            (4, 4, 8), (8, 2, 24)])
def test_a2a_segments_equal_reference(e_local, ms, cap):
    recv = np.random.default_rng(cap).integers(0, cap + 1, (ms, e_local))
    want = ref_a2a_segments(e_local, ms, cap, jnp.asarray(recv))
    got = a2a_segments(e_local, ms, cap, torch.from_numpy(recv))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# The sharded model
# --------------------------------------------------------------------------
_SETUPS = {}


def _setup(name):
    if name not in _SETUPS:
        cfg = smoke_config(name)
        jparams = jax_init(cfg, jax.random.PRNGKey(0))
        tcfg = torch_smoke_config(name)
        _SETUPS[name] = (cfg, tcfg, jparams, params_from_jax(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    return _SETUPS[name]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)],
                         ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("name", ["yi-6b", "phi3.5-moe-42b"])
def test_sharded_forward_matches_reference(name, shape):
    cfg, tcfg, jparams, tparams = _setup(name)
    mesh = virtual_mesh(shape, "cpu")
    placed = place_params(tparams, tcfg, mesh)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    last = np.asarray([9, 15], np.int32)
    jl, jc = jax.jit(lambda p_, b_, i_: jax_prefill(
        p_, cfg, b_, cache_len=32, logits_index=i_))(
        jparams, {"tokens": jnp.asarray(toks)}, jnp.asarray(last))
    tl, tc = T.forward_prefill(placed, tcfg,
                               {"tokens": torch.from_numpy(toks)},
                               cache_len=32, mesh=mesh,
                               logits_index=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    want_c = cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                            device="cpu")
    for k in want_c:
        np.testing.assert_allclose(tc[k].numpy(), want_c[k].numpy(),
                                   rtol=TOL, atol=TOL)
    # dense decode on caches laid out by cache_specs
    specs = cache_specs(tc, tcfg, mesh, batch_axes=())
    sc = {k: Sharded.of(t, specs[k], mesh) for k, t in tc.items()}
    pos = last + 1
    tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jd, _ = jax.jit(lambda p_, t_, c_, q_: jax_decode(p_, cfg, t_, c_, q_))(
        jparams, jnp.asarray(tok), jc, jnp.asarray(pos))
    td, _ = T.forward_decode(placed, tcfg, torch.from_numpy(tok), sc,
                             torch.from_numpy(pos), mesh=mesh)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL,
                               atol=TOL)
    # paged decode against the port's own meshless step
    psz, n_pages = 8, 9
    pools = {n: torch.zeros((tcfg.n_layers, n_pages + 1, psz,
                             tcfg.n_kv_heads, tcfg.resolved_head_dim))
             for n in ("pk", "pv")}
    table = torch.full((2, 4), n_pages, dtype=torch.int32)
    table[0, :2] = torch.tensor([3, 0])
    table[1, :3] = torch.tensor([5, 1, 7])
    for row in range(2):
        for j in range(int(pos[row]) // psz + 1):
            for n, src in (("pk", "k"), ("pv", "v")):
                pools[n][:, table[row, j]] = tc[src][:, row,
                                                     j * psz:(j + 1) * psz]
    pspecs = cache_specs(pools, tcfg, mesh, batch_axes=())
    sp = {k: Sharded.of(t, pspecs[k], mesh) for k, t in pools.items()}
    want, _ = T.forward_decode(tparams, tcfg, torch.from_numpy(tok),
                               pools, torch.from_numpy(pos),
                               page_table=table)
    got, _ = T.forward_decode(placed, tcfg, torch.from_numpy(tok), sp,
                              torch.from_numpy(pos), page_table=table,
                              mesh=mesh)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    for k in pools:
        np.testing.assert_allclose(sp[k].gather().numpy(), pools[k].numpy(),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["gemma3-1b", "recurrentgemma-2b",
                                  "rwkv6-3b", "whisper-base",
                                  "internvl2-76b"])
def test_kinds_outside_the_slice_raise_on_a_mesh(name):
    """Every kind once refused here runs there: sliding-window, RG-LRU
    and RWKV6 layers, the vision stub's ``frontend_proj`` and the
    enc-dec model (whisper-base: its encoder on the features, the cross
    K/V returned in ``"xk","xv"`` and read by decode): a prefill (on
    ``frontend_embeds`` where the model has a frontend, of
    ``enc_frames`` frames on the enc-dec model) and two dense decode
    steps on (1, 2) against the reference's."""
    cfg, tcfg, jparams, tparams = _setup(name)
    mesh = virtual_mesh((1, 2), "cpu")
    placed = place_params(tparams, tcfg, mesh)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    if cfg.frontend is not None:
        frames = cfg.enc_frames if cfg.enc_dec else 20
        emb = rng.standard_normal((2, frames, cfg.frontend_dim)).astype(
            np.float32)
        jb["frontend_embeds"] = jnp.asarray(emb)
        tb["frontend_embeds"] = torch.from_numpy(emb)
    jl, jc = jax_prefill(jparams, cfg, jb, cache_len=32)
    tl, tc = T.forward_prefill(placed, tcfg, tb, cache_len=32, mesh=mesh)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    specs = cache_specs(tc, tcfg, mesh, batch_axes=())
    sc = {k: Sharded.of(t, specs[k], mesh) for k, t in tc.items()}
    for pos in (20, 21):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jd, jc = jax_decode(jparams, cfg, jnp.asarray(tok), jc,
                            jnp.asarray(pos))
        td, _ = T.forward_decode(placed, tcfg, torch.from_numpy(tok), sc,
                                 pos, mesh=mesh)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                                   atol=1e-4)
