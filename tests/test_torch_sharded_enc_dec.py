"""whisper-base's encoder-decoder on a ``("data", "model")`` mesh against
the JAX package's functions without one, on ``smoke_config("whisper-
base")`` in float32 (4/2 heads of 8, 12 encoder frames), on virtual CPU
meshes (1, 2) (heads split), (1, 4) (2 KV heads do not divide: attention
whole, the dense cross stacks split on their 12 frames, the cross pools
on the page interior) and (1, 3) (nothing divides but the 12 frames of
the dense cross stacks; the pools whole).

* ``attn_apply_tp`` of the two non-causal kinds: ``"bidir"`` (RoPE, no
  mask) and ``"cross"`` on ``kv_x`` (no RoPE, no mask), their outputs
  and cross K/V (``encode_cross_kv``'s), and ``attn_apply``'s argument
  check on both branches;
* ``cross_attn_decode_tp`` on ``"xk","xv"`` laid out by
  ``cache_specs``, and ``paged_cross_attn_decode_tp`` on ``"ck","cv"``
  pools through a cross table with the pad cells past ``enc_frames``
  poisoned: against the JAX functions, nothing written;
* ``_encode_tp`` against the reference's ``_encode``;
* the model: ``forward_prefill`` on features and tokens (logits, the
  dense K/V and the cross stacks) and three dense decode steps against
  the reference's; paged decode steps with a ``"cross"`` table on float
  and int8 global pools against the reference's paged step; the
  decoder's embedding on a mesh unscaled in prefill (the features never
  reach the decoder) and scaled by √d in decode.

``TOL = 1e-5`` (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_parity as H
from repro.kernels.paged_attn import quantize_page_pool as jax_quantize
from repro.models import attention as jattn
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models.common import IDENTITY_SHARDER
from repro.models.transformer import _encode as jax_encode
from repro_torch.convert import cache_from_jax, pools_from_jax
from repro_torch.distributed import (cache_specs, P, place_params,
                                     virtual_mesh)
from repro_torch.distributed.mesh import Sharded
from repro_torch.models import attention as tattn
from repro_torch.models import forward_decode, forward_prefill
from repro_torch.models import transformer as T
from repro_torch.models.common import embed_scale, tensor_parallel

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NAME = "whisper-base"
TOL = 1e-5
SHAPES = ((1, 2), (1, 4), (1, 3))
B, S, CAP, PSZ = 3, 10, 24, 8


def shape_id(shape):
    return "%dx%d" % shape


def _setup():
    return H.setup(NAME)


def _mesh(shape):
    _, tcfg, _, tparams = _setup()
    mesh = virtual_mesh(shape, "cpu")
    return mesh, place_params(tparams, tcfg, mesh), tensor_parallel(tcfg,
                                                                    mesh)


def _sharded(name, t, tcfg, mesh):
    """One layer's ``t`` laid out as ``cache_specs`` lays its stack."""
    spec = cache_specs({name: torch.empty((1,) + tuple(t.shape),
                                          device="meta")}, tcfg, mesh,
                       batch_axes=())[name]
    return Sharded.of(t, P(*tuple(spec)[1:]), mesh)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _jlayer(jparams, where, r=0):
    return jax.tree.map(lambda a: a[r], jparams["groups"][0]["b0"])[where]


def _batch(cfg, s=S, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s),
                                   dtype=np.int32),
            "frontend_embeds": rng.standard_normal(
                (B, cfg.enc_frames, cfg.frontend_dim)).astype(np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# Mixers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["bidir", "cross"])
@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_attn_apply_tp_matches_jax(shape, kind):
    cfg, tcfg, jparams, _ = _setup()
    mesh, placed, tp = _mesh(shape)
    assert tp.head_ok == (shape == (1, 2))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)
                              ).astype(np.float32)
    where = "cross" if kind == "cross" else "mixer"
    kv = enc if kind == "cross" else None
    jp = _jlayer(jparams, where)
    ps = [t["layers"][0][where] for t in placed.local]
    want = jattn.attn_apply(jp, jnp.asarray(x), cfg, kind=kind,
                            kv_x=None if kv is None else jnp.asarray(kv))
    got, k, v = tattn.attn_apply_tp(
        ps, torch.from_numpy(x), tcfg, tp, kind=kind,
        kv_x=None if kv is None else torch.from_numpy(kv))
    _close(got.numpy(), want, what=kind)
    if kind == "cross":
        ref = jattn.encode_cross_kv(jp, jnp.asarray(enc), cfg)
        assert tuple(k.shape) == (B, cfg.enc_frames, cfg.n_kv_heads,
                                  cfg.resolved_head_dim)
        _close(k.numpy(), ref["k"], what="cross k")
        _close(v.numpy(), ref["v"], what="cross v")
    mix, none_k, none_v = tattn.attn_apply_tp(
        ps, torch.from_numpy(x), tcfg, tp, need_kv=False, kind=kind,
        kv_x=None if kv is None else torch.from_numpy(kv))
    _close(mix.numpy(), want, what=f"{kind} without K/V")
    assert (none_k is None) == tp.head_ok
    with pytest.raises(ValueError):
        tattn.attn_apply_tp(ps, torch.from_numpy(x), tcfg, tp, kind=kind,
                            kv_x=None if kind == "cross"
                            else torch.from_numpy(enc))


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_cross_attn_decode_tp_matches_jax(shape):
    """The dense cross stacks split on heads at (1, 2) and on their 12
    frames at (1, 4) and (1, 3), read in place; nothing is written."""
    cfg, tcfg, jparams, _ = _setup()
    mesh, placed, tp = _mesh(shape)
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)
                              ).astype(np.float32)
    for r in range(cfg.n_layers):
        jp = _jlayer(jparams, "cross", r)
        ps = [t["layers"][r]["cross"] for t in placed.local]
        jkv = jattn.encode_cross_kv(jp, jnp.asarray(enc), cfg)
        sc = {n: _sharded("x" + n, torch.from_numpy(np.array(jkv[n])),
                          tcfg, mesh) for n in ("k", "v")}
        split = 2 if tp.head_ok else 1
        assert sc["k"].spec[split] == "model", sc["k"].spec
        held = {n: [s.clone() for s in c.shards] for n, c in sc.items()}
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want = jattn.cross_attn_decode(jp, jnp.asarray(x), jkv, cfg)
        got = tattn.cross_attn_decode_tp(ps, torch.from_numpy(x), sc, tcfg,
                                         tp)
        _close(got.numpy(), want, what=f"layer {r}")
        for n, c in sc.items():
            assert all(torch.equal(a, b) for a, b in zip(c.shards, held[n]))


def _cross_pools(cfg, rng, n_cross):
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {n: rng.standard_normal((n_cross + 1, PSZ, hkv, hd)).astype(
        np.float32) for n in ("ck", "cv")}


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_paged_cross_attn_decode_tp_matches_jax(shape):
    """Cross pools of 12 pages of 8 split on KV heads at (1, 2), on the
    page interior at (1, 4), whole at (1, 3) (8 cells do not divide);
    the cells past ``enc_frames`` in each block's last page poisoned, so
    a read that is not cut to 12 frames fails."""
    cfg, tcfg, jparams, _ = _setup()
    mesh, placed, tp = _mesh(shape)
    rng = np.random.default_rng(5)
    n_cross = 12
    c = -(-cfg.enc_frames // PSZ)
    table = rng.permutation(n_cross)[:B * c].reshape(B, c).astype(np.int32)
    pools = _cross_pools(cfg, rng, n_cross)
    for name in pools:
        pools[name][table[:, -1], cfg.enc_frames - (c - 1) * PSZ:] = 1e4
    sp = {n: _sharded(n, torch.from_numpy(t), tcfg, mesh)
          for n, t in pools.items()}
    want_spec = {(1, 2): P(None, None, "model"), (1, 4): P(None, "model"),
                 (1, 3): P()}[shape]
    assert sp["ck"].spec == want_spec
    jp = _jlayer(jparams, "cross")
    ps = [t["layers"][0]["cross"] for t in placed.local]
    for t in range(2):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want = jattn.paged_cross_attn_decode(
            jp, jnp.asarray(x), {n: jnp.asarray(v) for n, v in pools.items()},
            jnp.asarray(table), cfg, enc_len=cfg.enc_frames)
        got = tattn.paged_cross_attn_decode_tp(
            ps, torch.from_numpy(x), sp, torch.from_numpy(table), tcfg, tp,
            enc_len=tcfg.enc_frames)
        assert np.abs(np.asarray(want)).max() < 1e3
        _close(got.numpy(), want, what=f"step {t}")
    for n, t in pools.items():
        assert np.array_equal(sp[n].gather().numpy(), t), n


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_encode_tp_matches_jax(shape):
    cfg, tcfg, jparams, _ = _setup()
    mesh, placed, tp = _mesh(shape)
    batch = _batch(cfg)
    want = jax_encode(jparams, cfg, _jb(batch), sharder=IDENTITY_SHARDER,
                      remat="none")
    got = T._encode_tp(placed.local, tcfg,
                       torch.from_numpy(batch["frontend_embeds"]), tp)
    assert tuple(got.shape) == (B, cfg.enc_frames, cfg.d_model)
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_forward_prefill_and_dense_decode_on_a_mesh(shape):
    """A right-padded prefill (a ``(B,)`` ``logits_index``) on features
    and tokens: logits, ``k,v`` and the cross stacks ``xk,xv`` whole on
    rank 0's device; three greedy dense decode steps on caches laid out
    by ``cache_specs``, the cross stacks never written."""
    cfg, tcfg, jparams, _ = _setup()
    mesh, placed, _ = _mesh(shape)
    lens = np.array([10, 4, 7], np.int32)
    batch = _batch(cfg, seed=2)
    last = lens - 1
    jl, jc = jax_prefill(jparams, cfg, _jb(batch), cache_len=CAP,
                         logits_index=jnp.asarray(last))
    tl, tc = forward_prefill(placed, tcfg, _tb(batch), cache_len=CAP,
                             logits_index=torch.from_numpy(last), mesh=mesh)
    v = cfg.vocab_size
    _close(tl.numpy()[..., :v], np.asarray(jl)[..., :v], what="prefill")
    want = cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    assert set(tc) == set(want) == {"k", "v", "xk", "xv"}
    for k in want:
        _close(tc[k].numpy(), want[k].numpy(), what=k)
    specs = cache_specs(tc, tcfg, mesh, batch_axes=())
    sc = {k: Sharded.of(t, specs[k], mesh) for k, t in tc.items()}
    held = {k: sc[k].gather().clone() for k in ("xk", "xv")}
    tok = np.array(jnp.argmax(jl[:, -1, :v], -1), np.int32)[:, None]
    pos = lens.copy()
    for t in range(3):
        jl, jc = jax_decode(jparams, cfg, jnp.asarray(tok), jc,
                            jnp.asarray(pos))
        tl, _ = forward_decode(placed, tcfg, torch.from_numpy(tok), sc,
                               torch.from_numpy(pos), mesh=mesh)
        _close(tl.numpy(), np.asarray(jl), what=f"step {t}")
        tok = np.array(jnp.argmax(jl[:, -1, :v], -1), np.int32)[:, None]
        pos = pos + 1
    for k, t in held.items():
        assert torch.equal(sc[k].gather(), t), k
    ref = cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    for k in ("k", "v"):
        _close(sc[k].gather().numpy(), ref[k].numpy(), what=k)


def _jax_pools(cfg, rng, n_global, n_cross, quant):
    """The reference's pools with seeded values (the layout of
    ``tests/test_torch_enc_dec_paged.py``)."""
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    (_, reps), = cfg.layer_groups()

    def vals(n):
        return jnp.asarray(rng.standard_normal(
            (reps, n + 1, PSZ, hkv, hd)).astype(np.float32))

    own = {}
    for name in "kv":
        x = vals(n_global)
        if quant:
            x, own[f"p{name}_s"] = jax_quantize(x)
        own["p" + name] = x
    return [{"b0": {"self": own,
                    "cross": {"ck": vals(n_cross), "cv": vals(n_cross)}}}]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_paged_decode_with_a_cross_table_on_a_mesh(shape, quant):
    """Three paged decode steps (self attention through K2's plain
    version on the sharded pools, cross attention through the cross
    table) against the reference's paged step: logits and the global
    pools within ``TOL``, greedy tokens equal, the cross pools
    unchanged."""
    cfg, tcfg, jparams, _ = _setup()
    mesh, placed, _ = _mesh(shape)
    rng = np.random.default_rng(6)
    n_global, n_cross, pmax = 24, 12, 4
    c = -(-cfg.enc_frames // PSZ)
    jpools = _jax_pools(cfg, rng, n_global, n_cross, quant)
    tpools = pools_from_jax(jax.tree.map(np.asarray, jpools), tcfg,
                            device="cpu")
    specs = cache_specs(tpools, tcfg, mesh, batch_axes=())
    sp = {n: Sharded.of(t, specs[n], mesh) for n, t in tpools.items()}
    held = {n: tpools[n].clone() for n in ("ck", "cv")}
    tables = {"global": rng.permutation(n_global)[:B * pmax].reshape(
        B, pmax).astype(np.int32),
        "cross": np.stack([rng.permutation(n_cross)[:c]
                           for _ in range(B)]).astype(np.int32)}
    pos = np.asarray([2, 9, 20], np.int32)
    cur = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    v = cfg.vocab_size
    for t in range(3):
        jl, jpools = jax_decode(
            jparams, cfg, jnp.asarray(cur), jpools, jnp.asarray(pos),
            page_table={k: jnp.asarray(x) for k, x in tables.items()})
        tl, _ = forward_decode(
            placed, tcfg, torch.from_numpy(cur), sp, torch.from_numpy(pos),
            page_table={k: torch.from_numpy(x) for k, x in tables.items()},
            mesh=mesh)
        _close(tl.numpy(), np.asarray(jl), what=f"step {t}")
        nxt = np.asarray(jnp.argmax(jl[:, -1, :v], -1))
        assert (tl[:, -1, :v].argmax(-1).numpy() == nxt).all()
        cur, pos = nxt.astype(np.int32)[:, None], pos + 1
    ref = pools_from_jax(jax.tree.map(np.asarray, jpools), tcfg,
                         device="cpu")
    for name, t in sp.items():
        _close(t.gather().float().numpy(), ref[name].float().numpy(),
               what=name)
    for name, t in held.items():
        assert torch.equal(sp[name].gather(), t), name


def test_decoder_embedding_on_a_mesh_is_unscaled_in_prefill_only():
    """On (1, 2) the 2,048-row table splits on the vocabulary: the
    decoder's input of an enc-dec prefill is the unscaled
    vocabulary-parallel lookup (the features go to the encoder, never to
    the decoder), decode's the lookup times √d (8.0 at d 64)."""
    cfg, tcfg, _, tparams = _setup()
    mesh, placed, _ = _mesh((1, 2))
    assert placed.local[0]["embed"]["table"].shape[0] == 1024
    batch = _tb(_batch(cfg, seed=7))
    want = tparams["embed"]["table"][batch["tokens"].long()]
    got = T._embed_inputs_tp(placed.local, tcfg, batch)
    assert torch.equal(got, want)
    assert embed_scale(tcfg.d_model, torch.float32) == 8.0
    assert torch.equal(T._embed_tp(placed.local, tcfg, batch["tokens"]),
                       want * 8.0)
