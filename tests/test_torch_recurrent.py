"""The port's recurrent layers against the JAX package on the CPU, on
``smoke_config("recurrentgemma-2b")`` (6 layers in the RGLRU, RGLRU,
LOCAL pattern, d 64, window 16) and ``smoke_config("rwkv6-3b")`` (2 WKV
layers, 8 heads of 8).

Modules, on seeded inputs with the float32 gates (``gate_r``,
``gate_i``) and token-shift mixes (``mu``) drawn at random so that they
matter: ``rglru_apply``, ``rglru_prefill_cache`` (no ``last_index``, a
scalar, a ``(B,)`` vector, prompts shorter than the conv) and
``rglru_decode_step``; ``rwkv_apply`` with S a multiple of CHUNK and
not, with a scalar and a ``(B,)`` ``last_index``, with ``x_prev`` and
``state0`` given, its ``return_state``, and ``rwkv_decode_step``.  The
log-depth scan against a sequential loop in float64 where the decays
underflow a cumulative product.  In bfloat16, the token-shift mix
rounded to the weights' dtype before K1 (the reference projects the
float32 mix) stays within ``BF16_SHIFT_REL`` of the reference.

The model: ``params_from_jax`` at full depth (26 and 32 layers, smoke
widths; recurrentgemma's second scan group is the ragged ``(RGLRU,
RGLRU)`` tail), ``init_params``' tree, ``init_cache`` and
``cache_layout``, ``forward_prefill`` logits and per-class caches
against the JAX caches carried over by ``cache_from_jax``, and decode
steps (dense caches, and slabs through ``pools_from_jax``), updated in
place.  (Training on these layers: ``tests/test_torch_recurrent_train.py``;
enc-dec models pass ``check_supported``, and every engine kind takes
them.)
Float32, TF32 off, ``TOL = 1e-5``; WKV outputs and the logits of
models of WKV layers ``WKV_TOL = 1e-4`` (the chunked form scales its
factors by up to ``e^44.8`` and back, and JAX's scan and the port's
batched einsums sum them in other orders).
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
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax, pools_from_jax
from repro_torch.models import (forward_decode, forward_prefill,
                                init_cache, init_params)
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.transformer import cache_layout, check_supported
from repro_torch.serve import make_engine

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5
WKV_TOL = 1e-4
RG, RWKV = "recurrentgemma-2b", "rwkv6-3b"
NAMES = (RG, RWKV)
# bf16: the port rounds the float32 token-shift mix to bf16 before each
# projection and gets bf16 r/k/v; the reference projects the float32 mix
# and keeps them float32.  Both then round the output to bf16.  The
# outputs must agree within this share of their largest magnitude.
BF16_SHIFT_REL = 2.0 ** -5
_SETUPS = {}


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def setup(name):
    """(JAX cfg, port cfg, JAX params, port params) of a smoke config."""
    if name not in _SETUPS:
        cfg = smoke_config(name)
        jparams = jax_init(cfg, jax.random.PRNGKey(0))
        tcfg = torch_smoke_config(name)
        _SETUPS[name] = (cfg, tcfg, jparams, params_from_jax(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    return _SETUPS[name]


def _mixer(name, seed=0):
    """The first layer's mixer as a (JAX, port) pair of the same numpy
    weights, with its zero-initialised gates (RG-LRU) or constant mixes
    (WKV) redrawn at random."""
    _, _, jparams, _ = setup(name)
    mix = jax.tree.map(lambda x: np.array(x[0]),
                       jparams["groups"][0]["b0"]["mixer"])
    rng = np.random.default_rng(seed)
    if name == RG:
        for key in ("gate_r", "gate_i"):
            mix[key] = rng.standard_normal(mix[key].shape).astype(np.float32)
    else:
        mix["mu"] = rng.uniform(0, 1, mix["mu"].shape).astype(np.float32)
    return (jax.tree.map(jnp.asarray, mix),
            jax.tree.map(lambda x: torch.from_numpy(x.copy()), mix))


def _x(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _close_tree(got, want, tol=TOL, what=""):
    assert set(got) == set(want), what
    for k in got:
        assert got[k].shape == tuple(want[k].shape), (what, k)
        _close(got[k].float().numpy(), np.asarray(want[k], np.float32), tol,
               f"{what} {k}")


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 2, 5, 16, 33])
def test_rglru_apply_matches_jax(s):
    cfg, tcfg, _, _ = setup(RG)
    jp, tp = _mixer(RG)
    x = _x(cfg, 2, s, seed=s)
    want = jrglru.rglru_apply(jp, jnp.asarray(x), cfg)
    got = trglru.rglru_apply(tp, torch.from_numpy(x), tcfg)
    _close(got.numpy(), want, what=f"S {s}")


# (S, last_index): no index (the conv tail front-padded for S < 3), a
# scalar, a (B,) vector with rows before, at and past the conv width.
RG_LAYOUTS = {
    "none": (20, None),
    "none_s1": (1, None),
    "none_s2": (2, None),
    "scalar": (20, np.int32(11)),
    "vector": (20, np.array([0, 1, 19], np.int32)),
    "vector_s2": (2, np.array([0, 1, 1], np.int32)),
}


@pytest.mark.parametrize("layout", sorted(RG_LAYOUTS))
def test_rglru_prefill_cache_matches_jax(layout):
    cfg, tcfg, _, _ = setup(RG)
    jp, tp = _mixer(RG)
    s, last = RG_LAYOUTS[layout]
    x = _x(cfg, 3, s, seed=s + 1)
    want = jrglru.rglru_prefill_cache(
        jp, jnp.asarray(x), cfg,
        last_index=None if last is None else jnp.asarray(last))
    got = trglru.rglru_prefill_cache(
        tp, torch.from_numpy(x), tcfg,
        last_index=None if last is None else torch.from_numpy(
            np.asarray(last)))
    assert got["h"].dtype == torch.float32
    _close_tree(got, want, what=layout)
    if layout == "scalar":                  # an int is a scalar index too
        again = trglru.rglru_prefill_cache(tp, torch.from_numpy(x), tcfg,
                                           last_index=int(last))
        assert all(torch.equal(again[k], got[k]) for k in got)


def test_rglru_decode_step_matches_jax_and_writes_in_place():
    """Eight steps from a prefill of rows of 3, 7 and 12 tokens: the
    outputs track the JAX steps, and every step writes ``h`` and
    ``conv`` into the same tensors (a caller's view of its buffers)."""
    cfg, tcfg, _, _ = setup(RG)
    jp, tp = _mixer(RG)
    lens = np.array([3, 7, 12], np.int32)
    x = _x(cfg, 3, 12, seed=2)
    jc = jrglru.rglru_prefill_cache(jp, jnp.asarray(x), cfg,
                                    last_index=jnp.asarray(lens - 1))
    tc = trglru.rglru_prefill_cache(tp, torch.from_numpy(x), tcfg,
                                    last_index=torch.from_numpy(lens - 1))
    h, conv = tc["h"], tc["conv"]
    rng = np.random.default_rng(3)
    for t in range(8):
        xt = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jout, jc = jrglru.rglru_decode_step(jp, jnp.asarray(xt), jc, cfg)
        before = h.clone()
        tout, tc = trglru.rglru_decode_step(tp, torch.from_numpy(xt), tc,
                                            tcfg)
        _close(tout.numpy(), jout, what=f"step {t}")
        assert tc["h"] is h and tc["conv"] is conv
        assert not torch.equal(h, before)
    _close_tree(tc, jc, what="cache after decode")


def test_the_scan_holds_where_a_cumulative_product_underflows():
    """400 steps of decays down to exp(-8) each (a product of them is
    0 in float32 after a few dozen): the doubling scan against a
    sequential loop in float64."""
    rng = np.random.default_rng(4)
    a = np.exp(-8 * rng.uniform(0, 1, (2, 400, 5)))
    b = rng.standard_normal((2, 400, 5))
    want, h = np.zeros_like(b), np.zeros((2, 5))
    for t in range(400):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    assert np.prod(a.astype(np.float32), axis=1).min() == 0
    got = trglru._scan(torch.from_numpy(a).float(),
                       torch.from_numpy(b).float())
    _close(got.numpy(), want, tol=1e-5)


# --------------------------------------------------------------------------
# RWKV6 time-mix
# --------------------------------------------------------------------------
# (S, last_index): S a multiple of CHUNK (32) and not, then the per-row
# valid mask at a scalar and at a (B,) vector.
WKV_LAYOUTS = {
    "s32": (32, None),
    "s64": (64, None),
    "s5": (5, None),
    "s40": (40, None),
    "scalar": (40, np.int32(22)),
    "vector": (70, np.array([0, 32, 69], np.int32)),
}


@pytest.mark.parametrize("layout", sorted(WKV_LAYOUTS))
def test_rwkv_apply_matches_jax(layout):
    cfg, tcfg, _, _ = setup(RWKV)
    jp, tp = _mixer(RWKV)
    s, last = WKV_LAYOUTS[layout]
    x = _x(cfg, 3, s, seed=s)
    jidx = None if last is None else jnp.asarray(last)
    tidx = None if last is None else torch.from_numpy(np.asarray(last))
    jy, jstate = jrwkv.rwkv_apply(jp, jnp.asarray(x), cfg, return_state=True,
                                  last_index=jidx)
    ty, tstate = trwkv.rwkv_apply(tp, torch.from_numpy(x), tcfg,
                                  return_state=True, last_index=tidx)
    _close(ty.numpy(), jy, tol=WKV_TOL, what=f"{layout} out")
    assert tstate["state"].dtype == torch.float32
    _close_tree(tstate, jstate, tol=WKV_TOL, what=layout)
    plain = trwkv.rwkv_apply(tp, torch.from_numpy(x), tcfg, last_index=tidx)
    assert torch.equal(plain, ty)


def test_rwkv_apply_continues_from_x_prev_and_state0():
    """A 50-token sequence in one call equals its first 20 tokens, then
    the other 30 from the first call's ``shift`` and ``state``, in both
    packages."""
    cfg, tcfg, _, _ = setup(RWKV)
    jp, tp = _mixer(RWKV)
    x = _x(cfg, 2, 50, seed=7)
    rng = np.random.default_rng(8)
    prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    s0 = rng.standard_normal((2, 8, 8, 8)).astype(np.float32) * 0.1
    jy, jst = jrwkv.rwkv_apply(jp, jnp.asarray(x), cfg,
                               x_prev=jnp.asarray(prev),
                               state0=jnp.asarray(s0), return_state=True)
    ty, tst = trwkv.rwkv_apply(tp, torch.from_numpy(x), tcfg,
                               x_prev=torch.from_numpy(prev),
                               state0=torch.from_numpy(s0), return_state=True)
    _close(ty.numpy(), jy, tol=WKV_TOL, what="out")
    _close_tree(tst, jst, tol=WKV_TOL, what="state")
    y1, st1 = trwkv.rwkv_apply(tp, torch.from_numpy(x[:, :20]), tcfg,
                               x_prev=torch.from_numpy(prev),
                               state0=torch.from_numpy(s0), return_state=True)
    y2, st2 = trwkv.rwkv_apply(tp, torch.from_numpy(x[:, 20:]), tcfg,
                               x_prev=st1["shift"], state0=st1["state"],
                               return_state=True)
    _close(torch.cat([y1, y2], 1).numpy(), ty.numpy(), what="split")
    _close_tree(st2, {k: t.numpy() for k, t in tst.items()}, what="split")


def test_rwkv_decode_step_matches_jax_and_writes_in_place():
    cfg, tcfg, _, _ = setup(RWKV)
    jp, tp = _mixer(RWKV)
    lens = np.array([1, 9, 33], np.int32)
    x = _x(cfg, 3, 33, seed=9)
    _, jc = jrwkv.rwkv_apply(jp, jnp.asarray(x), cfg, return_state=True,
                             last_index=jnp.asarray(lens - 1))
    _, tc = trwkv.rwkv_apply(tp, torch.from_numpy(x), tcfg,
                             return_state=True,
                             last_index=torch.from_numpy(lens - 1))
    state, shift = tc["state"], tc["shift"]
    rng = np.random.default_rng(10)
    for t in range(8):
        xt = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jout, jc = jrwkv.rwkv_decode_step(jp, jnp.asarray(xt), jc, cfg)
        tout, tc = trwkv.rwkv_decode_step(tp, torch.from_numpy(xt), tc,
                                          tcfg)
        _close(tout.numpy(), jout, tol=WKV_TOL, what=f"step {t}")
        assert tc["state"] is state and tc["shift"] is shift
        assert torch.equal(shift, torch.from_numpy(xt[:, 0]))
    _close_tree(tc, jc, tol=WKV_TOL, what="cache after decode")


def test_rwkv_head_dims():
    assert trwkv.rwkv_head_dims(torch_smoke_config(RWKV)) == (8, 8)
    from repro_torch.configs import get_config
    assert trwkv.rwkv_head_dims(get_config(RWKV)) == (40, 64)


def test_bf16_token_shift_rounding_stays_near_the_reference():
    """bfloat16 weights (``mu``, ``u`` float32): the port rounds the
    float32 mix to bf16 before each projection (K1 takes one dtype), the
    reference projects it in float32.  Prefill outputs and states, and
    four decode steps, within ``BF16_SHIFT_REL`` of each one's largest
    magnitude."""
    name = RWKV
    cfg = dataclasses.replace(smoke_config(name), param_dtype="bfloat16")
    tcfg = dataclasses.replace(torch_smoke_config(name),
                               param_dtype="bfloat16")
    jparams = jax_init(cfg, jax.random.PRNGKey(2))
    jp = jax.tree.map(lambda x: x[0], jparams["groups"][0]["b0"]["mixer"])
    rng = np.random.default_rng(11)
    jp["mu"] = jnp.asarray(rng.uniform(0, 1, jp["mu"].shape), jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                         device="cpu")["layers"][0]["mixer"]
    tp["mu"] = torch.from_numpy(np.asarray(jp["mu"]).copy())
    assert tp["r"]["w"].dtype == torch.bfloat16
    assert tp["mu"].dtype == tp["u"].dtype == torch.float32
    x = _x(cfg, 2, 40, seed=12)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()

    def near(got, want, what):
        got = got.float().numpy()
        want = np.asarray(jnp.asarray(want, jnp.float32))
        err = np.abs(got - want).max()
        assert err <= BF16_SHIFT_REL * np.abs(want).max(), (what, err)

    jy, jc = jrwkv.rwkv_apply(jp, jx, cfg, return_state=True)
    ty, tc = trwkv.rwkv_apply(tp, tx, tcfg, return_state=True)
    assert ty.dtype == torch.bfloat16
    near(ty, jy, "prefill out")
    near(tc["state"], jc["state"], "state")
    for t in range(4):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jc = jrwkv.rwkv_decode_step(jp, jnp.asarray(xt).astype(
            jnp.bfloat16), jc, cfg)
        tout, tc = trwkv.rwkv_decode_step(
            tp, torch.from_numpy(xt).bfloat16(), tc, tcfg)
        near(tout, jout, f"step {t}")
    near(tc["state"], jc["state"], "state after decode")


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------
def _from_jax(tcfg, jc):
    return cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks


def _tol(name):
    return WKV_TOL if name == RWKV else TOL


def _spec(tree):
    if isinstance(tree, dict):
        return {k: _spec(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("name", NAMES)
def test_init_params_has_the_converted_tree(name):
    """Seeded random weights in the tree ``params_from_jax`` gives:
    names, shapes and dtypes (the float32 leaves float32 in a bf16
    model too)."""
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(smoke_config(name), param_dtype=dtype)
        tcfg = dataclasses.replace(torch_smoke_config(name),
                                   param_dtype=dtype)
        want = params_from_jax(jax.tree.map(
            np.asarray, jax_init(cfg, jax.random.PRNGKey(0))), tcfg,
            device="cpu")
        got = init_params(tcfg, seed=3, device="cpu")
        assert _spec(got) == _spec(want), dtype


@pytest.mark.parametrize("name,layers", [(RG, 26), (RWKV, 32)])
def test_params_from_jax_at_full_depth(name, layers):
    """Full depth at smoke widths: recurrentgemma's 26 layers scan as
    ``(pattern, 8)`` and the ragged ``(RGLRU, RGLRU)`` tail, rwkv6's 32
    as one group.  The converted weights give the JAX logits and caches
    (the JAX caches through ``cache_from_jax``)."""
    cfg = dataclasses.replace(smoke_config(name), n_layers=layers)
    tcfg = dataclasses.replace(torch_smoke_config(name), n_layers=layers)
    if name == RG:
        assert [(len(p), n) for p, n in tcfg.layer_groups()] == \
            [(3, 8), (2, 1)]
    jparams = jax_init(cfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    assert len(tparams["layers"]) == layers
    toks = _prompts(cfg, [21, 21], seed=2)
    jl, jc = jax_prefill(jparams, cfg, {"tokens": jnp.asarray(toks)},
                         cache_len=32)
    tl, tc = forward_prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                             cache_len=32)
    tol = _tol(name)
    _close(tl.numpy(), jl, tol=tol, what="logits")
    ref = _from_jax(tcfg, jc)
    if name == RG:
        assert ref["h"].shape == (18, 2, cfg.d_model)
        assert ref["conv"].shape == (18, 2, 3, cfg.d_model)
        assert ref["wk"].shape[:3] == (8, 2, 16)
    else:
        assert ref["state"].shape == (32, 2, 8, 8, 8)
    _close_tree(tc, {k: t.numpy() for k, t in ref.items()}, tol=tol,
                what="cache")


@pytest.mark.parametrize("name", NAMES)
def test_cache_layout_and_init_cache_match_jax(name):
    cfg, tcfg, _, _ = setup(name)
    layout = cache_layout(tcfg)
    if name == RG:
        assert layout == [("rglru", 0), ("rglru", 1), ("w", 0),
                          ("rglru", 2), ("rglru", 3), ("w", 1)]
    else:
        assert layout == [("wkv", 0), ("wkv", 1)]
    for dtype in ("float32", "bfloat16"):
        jc = _from_jax(tcfg, jax_init_cache(cfg, 2, 40,
                                            dtype_override=dtype))
        tc = init_cache(tcfg, 2, 40, getattr(torch, dtype), device="cpu")
        assert {k: (v.shape, v.dtype) for k, v in tc.items()} == \
            {k: (v.shape, v.dtype) for k, v in jc.items()}
        assert all((t == 0).all() for t in tc.values())
    want = {"h", "conv", "wk", "wv"} if name == RG else {"state", "shift"}
    assert set(tc) == want
    assert tc["h" if name == RG else "state"].dtype == torch.float32


@pytest.mark.parametrize("index", ["vector", "scalar", "none"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_prefill_and_decode_match_jax(name, index):
    """A right-padded prefill at cache capacity 48 (recurrentgemma's
    local rings of 16), prompts of 9, 20 and 37 tokens with the
    per-row index, 37 each at one index, or exact length with none;
    then 10 greedy decode steps on the JAX caches carried over by
    ``cache_from_jax``, written in place, against the JAX steps."""
    cfg, tcfg, jparams, tparams = setup(name)
    lens = np.array([9, 20, 37], np.int32) if index == "vector" else \
        np.array([37, 37, 37], np.int32)
    toks = _prompts(cfg, lens)
    if index == "vector":
        jidx, tidx = jnp.asarray(lens - 1), torch.from_numpy(lens - 1)
    elif index == "scalar":
        jidx, tidx = jnp.int32(36), 36
    else:
        jidx = tidx = None
    jl, jc = jax_prefill(jparams, cfg, {"tokens": jnp.asarray(toks)},
                         cache_len=48, logits_index=jidx)
    tl, tc_own = forward_prefill(tparams, tcfg,
                                 {"tokens": torch.from_numpy(toks)},
                                 cache_len=48, logits_index=tidx)
    tol = _tol(name)
    _close(tl.numpy(), jl, tol=tol, what="prefill logits")
    tc = _from_jax(tcfg, jc)
    _close_tree(tc_own, {k: t.numpy() for k, t in tc.items()}, tol=tol,
                what="prefill cache")
    held = dict(tc)
    jdecode = jax.jit(lambda p, t, c, pos: jax_decode(p, cfg, t, c, pos))
    tok = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1),
                   np.int32)[:, None]
    per_row = index == "vector"
    for t in range(10):
        pos = lens + t if per_row else np.int32(lens.max() + t)
        jl, jc = jdecode(jparams, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = forward_decode(tparams, tcfg, torch.from_numpy(tok), tc,
                                torch.as_tensor(pos))
        _close(tl.numpy(), jl, tol=tol, what=f"step {t}")
        tok = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1),
                       np.int32)[:, None]
        assert (tl[:, -1, :cfg.vocab_size].argmax(-1).numpy()
                == tok[:, 0]).all()
    assert all(tc[k] is held[k] for k in held)
    ref = _from_jax(tcfg, jc)
    _close_tree(tc, {k: t.numpy() for k, t in ref.items()}, tol=tol,
                what="cache after decode")


@pytest.mark.parametrize("name", NAMES)
def test_paged_forward_decode_steps_the_slabs(name):
    """Paged decode on pools built by ``pools_from_jax`` from the JAX
    engine's layout (recurrent slabs of 4 slots; recurrentgemma's local
    layers on rings of 3 pages of 8): logits and every pool against
    the JAX steps, the slabs stepped in place."""
    cfg, tcfg, jparams, tparams = setup(name)
    rng = np.random.default_rng(5)
    slots, psz, ring, n_local = 4, 8, 3, 14
    jc = jax_init_cache(cfg, slots, 24)
    jpools = []
    for group in jc:
        jpools.append({})
        for b, block in group.items():
            if "k" in block:                 # a local layer: ring pages
                shape = (block["k"].shape[0], n_local + 1, psz) + \
                    block["k"].shape[3:]
                jpools[-1][b] = {n: jnp.asarray(rng.standard_normal(
                    shape).astype(np.float32)) for n in ("lk", "lv")}
            else:
                jpools[-1][b] = {n: jnp.asarray(rng.standard_normal(
                    x.shape).astype(np.float32) * 0.5)
                    for n, x in block.items()}
    tpools = pools_from_jax(jax.tree.map(np.asarray, jpools), tcfg,
                            device="cpu")
    want = {"h", "conv", "lk", "lv"} if name == RG else {"state", "shift"}
    assert set(tpools) == want
    held = dict(tpools)
    pos = np.asarray([3, 17, 30, 9], np.int32)
    table = {"global": np.zeros((slots, 3), np.int32)}
    if name == RG:
        table["local"] = np.stack([rng.permutation(n_local)[:ring]
                                   for _ in range(slots)]).astype(np.int32)
    cur = rng.integers(0, cfg.vocab_size, (slots, 1)).astype(np.int32)
    for _ in range(4):
        jl, jpools = jax_decode(
            jparams, cfg, jnp.asarray(cur), jpools, jnp.asarray(pos),
            page_table={k: jnp.asarray(t) for k, t in table.items()},
            window_cap=16)
        tl, got = forward_decode(
            tparams, tcfg, torch.from_numpy(cur), tpools,
            torch.from_numpy(pos),
            page_table={k: torch.from_numpy(t) for k, t in table.items()},
            window_cap=16)
        _close(tl.numpy(), jl, tol=_tol(name), what="logits")
        cur = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1)
                         ).astype(np.int32)[:, None]
        pos = pos + 1
    assert all(tpools[k] is held[k] for k in held)
    ref = pools_from_jax(jax.tree.map(np.asarray, jpools), tcfg,
                         device="cpu")
    _close_tree(tpools, {k: t.numpy() for k, t in ref.items()},
                tol=_tol(name), what="pools")


@pytest.mark.parametrize("name", ["whisper-base"])
def test_every_engine_kind_takes_enc_dec(name):
    """An enc-dec model passes ``check_supported`` beside the recurrent
    ones, and all three engine kinds take it (the paged one with its
    cross page pool: one block of ``ceil(enc_frames / page_size)`` pages
    a slot)."""
    tcfg = torch_smoke_config(name)
    check_supported(tcfg)
    for ok in NAMES:
        check_supported(torch_smoke_config(ok))
    params = init_params(tcfg, seed=0, device="cpu")
    for kind in ("slot", "sequential", "paged"):
        eng = make_engine(tcfg, params, kind=kind, device="cpu",
                          max_slots=4, max_seq=64)
        assert eng.cfg is tcfg
    assert eng.cross_pages == -(-tcfg.enc_frames // eng.page_size)
    assert eng.cache.n_free_cross == 4 * eng.cross_pages
