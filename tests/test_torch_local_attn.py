"""The port's sliding-window (``LOCAL``) attention and ring caches
against the JAX package on the CPU, on ``smoke_config("gemma3-1b")``
(12 layers in the 5 LOCAL : 1 ATTN pattern, window 16, GQA 4/1,
head_dim 8).

Modules: the windowed ``attn_apply`` (the masked softmax, the
reference's default form), ``prefill_into_cache`` in all three layouts (pad, roll, per-row gather
at a scalar and a ``(B,)`` ``last_index``) on float and int8 caches,
and ``attn_decode_step`` on a local ring across its wrap.  The model:
``forward_prefill`` logits and per-class caches against the JAX caches
carried over by ``cache_from_jax``, decode steps across the ring's wrap,
``forward_train``'s loss and every gradient against ``jax.grad``, and
``params_from_jax`` at gemma3's full depth of 26 layers (two scan
groups).  Float32, TF32 off, ``TOL = 1e-5``.  On int8 caches, as in
``tests/test_torch_dense_decode.py`` (each package quantizes its own
float32 projections): cells within one level, scales within one bf16
ulp, logits within ``INT8_TOL`` = 1e-4, and a row whose cache holds a
cell one level from the JAX cell within ``ONE_LEVEL_TOL`` = 5e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import attention as jattn
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import forward_train as jax_train
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import (forward_decode, forward_prefill,
                                forward_train, init_cache)
from repro_torch.models.transformer import cache_layout

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5
INT8_TOL = 1e-4
ONE_LEVEL_TOL = 5e-3
NAME = "gemma3-1b"
LOCAL_BLOCK, GLOBAL_BLOCK = "b0", "b5"      # the pattern's first of each
_SETUPS = {}


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, port cfg, JAX params, port params) of the smoke config."""
    if NAME not in _SETUPS:
        cfg = smoke_config(NAME)
        jparams = jax_init(cfg, jax.random.PRNGKey(0))
        tcfg = torch_smoke_config(NAME)
        _SETUPS[NAME] = (cfg, tcfg, jparams, params_from_jax(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    return _SETUPS[NAME]


@pytest.fixture(params=[False, True], ids=["float", "int8"])
def quant(request):
    """Both packages' dense int8 flag, restored in ``finally`` (the
    flags are process-wide and xdist runs many files in one worker)."""
    jattn.set_kv_cache_quant(request.param)
    tattn.set_kv_cache_quant(request.param)
    try:
        yield request.param
    finally:
        jattn.set_kv_cache_quant(False)
        tattn.set_kv_cache_quant(False)


def _mixer(setup, block):
    _, _, jparams, tparams = setup
    jp = jax.tree.map(lambda x: x[0], jparams["groups"][0][block]["mixer"])
    return jp, tparams["layers"][int(block[1:])]["mixer"]


def _x(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _torch(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":          # exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _check_cache(tc, ref, quant, what):
    """Port cache tensors against reference ones (same names, dtypes
    and shapes): float within TOL; int8 cells within one level, their
    bf16 scales within one bf16 ulp."""
    assert {k: (v.dtype, v.shape) for k, v in tc.items()} == \
        {k: (v.dtype, v.shape) for k, v in ref.items()}, what
    for name in tc:
        got, want = tc[name].float().numpy(), ref[name].float().numpy()
        if not quant:
            _close(got, want, what=f"{what} {name}")
        elif not name.endswith("_s"):
            assert np.abs(got - want).max() <= 1, (what, name)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0,
                                       err_msg=f"{what} {name}")


def _from_jax(tcfg, jc):
    return cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s", [5, 16, 17, 32, 40, 48])
@pytest.mark.parametrize("kind", ["local", "attn"])
def test_attn_apply_matches_jax(setup, kind, s):
    """The masked softmax: a local layer sees at most the last 16
    positions (S 17 to 48 cross the window, S 32 and 48 are whole
    windows), a global one all."""
    cfg, tcfg, _, _ = setup
    jp, tp = _mixer(setup, LOCAL_BLOCK if kind == "local" else GLOBAL_BLOCK)
    x = _x(cfg, 2, s)
    want = jattn.attn_apply(jp, jnp.asarray(x), cfg, kind=kind)
    got, k, v = tattn.attn_apply(tp, torch.from_numpy(x), tcfg, kind=kind)
    _close(got.numpy(), want, what=f"{kind} S {s}")
    assert k.shape == v.shape == (2, s, tcfg.n_kv_heads,
                                  tcfg.resolved_head_dim)


def test_windowed_mask_is_the_reference_mask():
    for window in (None, 1, 3, 16):
        want = np.asarray(jattn._causal_mask(7, 7, window))
        got = tattn._causal_mask(7, 7, window, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


# (S, cap, last_index): the pad layout, the rolled ring, and the per-row
# gather at a scalar and at a (B,) vector whose rows are shorter than
# cap, exactly cap, and longer.
LAYOUTS = {
    "pad": (12, 16, None),
    "pad_with_index": (12, 16, np.array([3, 11, 7], np.int32)),
    "roll": (40, 16, None),
    "roll_exact_multiple": (32, 16, None),
    "gather_scalar": (40, 16, np.int32(29)),
    "gather_vector": (40, 16, np.array([5, 15, 37], np.int32)),
    "gather_vector_full": (24, 16, np.array([23, 16, 0], np.int32)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prefill_into_cache_matches_jax(setup, quant, layout):
    cfg, tcfg, _, _ = setup
    s, cap, last = LAYOUTS[layout]
    jp, tp = _mixer(setup, LOCAL_BLOCK)
    x = _x(cfg, 3, s, seed=s)
    want = jattn.prefill_into_cache(
        jp, jnp.asarray(x), cfg, kind="local", cap=cap,
        last_index=None if last is None else jnp.asarray(last))
    _, k, v = tattn.attn_apply(tp, torch.from_numpy(x), tcfg, kind="local")
    got = tattn.prefill_into_cache(
        k, v, cap, None if last is None else torch.from_numpy(
            np.asarray(last)))
    _check_cache(got, {n: _torch(t) for n, t in want.items()}, quant,
                 layout)
    if layout == "gather_scalar":           # an int is a scalar index too
        again = tattn.prefill_into_cache(k, v, cap, int(last))
        for name in got:
            assert torch.equal(again[name], got[name])


@pytest.mark.parametrize("per_row", [False, True],
                         ids=["scalar_pos", "vector_pos"])
def test_attn_decode_step_on_a_local_ring_across_the_wrap(setup, quant,
                                                          per_row):
    """A ring of the window's 16 cells, laid from 13- and 20-token
    prompts (pad and roll), decoded 12 steps: positions wrap past 16 and
    32, and each step attends the last 16 positions only."""
    cfg, tcfg, _, _ = setup
    jp, tp = _mixer(setup, LOCAL_BLOCK)
    cap = cfg.sliding_window
    x = _x(cfg, 2, 20, seed=4)
    lens = np.array([13, 20], np.int32)
    last = jnp.asarray(lens - 1)
    jcache = jattn.prefill_into_cache(jp, jnp.asarray(x), cfg, kind="local",
                                      cap=cap, last_index=last)
    _, k, v = tattn.attn_apply(tp, torch.from_numpy(x), tcfg, kind="local")
    tcache = tattn.prefill_into_cache(k, v, cap, torch.from_numpy(lens - 1))
    rng = np.random.default_rng(5)
    for t in range(12):
        pos = lens + t if per_row else np.int32(lens.max() + t)
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jattn.attn_decode_step(jp, jnp.asarray(xt), jcache,
                                              jnp.asarray(pos), cfg,
                                              kind="local")
        tout, tcache = tattn.attn_decode_step(tp, torch.from_numpy(xt),
                                              tcache, torch.as_tensor(pos),
                                              tcfg)
        _close(tout.numpy(), jout, tol=INT8_TOL if quant else TOL,
               what=f"step {t}")
    _check_cache(tcache, {n: _torch(a) for n, a in jcache.items()}, quant,
                 "ring after decode")


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------
def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks


def test_cache_layout_and_init_cache_match_jax(setup, quant):
    """Local layers keep their own stack at capacity min(seq, window):
    ten of gemma3's twelve smoke layers at 16 cells, two global ones at
    the full 40."""
    cfg, tcfg, _, _ = setup
    layout = cache_layout(tcfg)
    assert [pre for pre, _ in layout] == ["w"] * 5 + [""] + ["w"] * 5 + [""]
    assert [i for _, i in layout] == [0, 1, 2, 3, 4, 0, 5, 6, 7, 8, 9, 1]
    jc = _from_jax(tcfg, jax_init_cache(cfg, 2, 40))
    tc = init_cache(tcfg, 2, 40, torch.float32, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in tc.items()} == \
        {k: (v.shape, v.dtype) for k, v in jc.items()}
    base = {"k", "v", "k_s", "v_s"} if quant else {"k", "v"}
    assert set(tc) == base | {"w" + n for n in base}
    assert tc["k"].shape[:3] == (2, 2, 40)
    assert tc["wk"].shape[:3] == (10, 2, 16)
    assert all((t == 0).all() for t in tc.values())


@pytest.mark.parametrize("index", ["vector", "scalar", "none"])
def test_forward_prefill_and_decode_match_jax(setup, quant, index):
    """A right-padded prefill at cache capacity 40 (local rings of 16):
    prompts of 9, 20 and 27 tokens, so the local layers take the
    per-row gather (``last_index`` a vector), the gather at one index,
    or the roll (no index, the sequential engine's exact-length
    prefill); then 10 greedy decode steps, which wrap every local ring,
    on caches carried over from the JAX prefill."""
    cfg, tcfg, jparams, tparams = setup
    lens = np.array([9, 20, 27], np.int32) if index == "vector" else \
        np.array([27, 27, 27], np.int32)
    toks = _prompts(cfg, lens)
    if index == "vector":
        jidx, tidx = jnp.asarray(lens - 1), torch.from_numpy(lens - 1)
    elif index == "scalar":
        jidx, tidx = jnp.int32(26), 26
    else:
        jidx = tidx = None
    # Jitted here, so each test traces under its own int8 flag.
    jdecode = jax.jit(lambda p, t, c, pos: jax_decode(p, cfg, t, c, pos))
    jl, jc = jax_prefill(jparams, cfg, {"tokens": jnp.asarray(toks)},
                         cache_len=40, logits_index=jidx)
    tl, tc_own = forward_prefill(tparams, tcfg,
                                 {"tokens": torch.from_numpy(toks)},
                                 cache_len=40, logits_index=tidx)
    tol = INT8_TOL if quant else TOL
    _close(tl.numpy(), jl, tol=tol, what="prefill logits")
    tc = _from_jax(tcfg, jc)
    _check_cache(tc_own, tc, quant, "prefill cache")
    tok = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1),
                   np.int32)[:, None]
    per_row = index == "vector"
    for t in range(10):
        pos = lens + t if per_row else np.int32(lens.max() + t)
        jl, jc = jdecode(jparams, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = forward_decode(tparams, tcfg, torch.from_numpy(tok), tc,
                                torch.as_tensor(pos))
        row_tol = np.full(len(lens), tol)
        if quant:
            # A row whose cache holds a cell one int8 level away from
            # the JAX cell (each package quantizes its own float32
            # projections) is held to ONE_LEVEL_TOL, as in
            # tests/test_torch_dense_decode.py.
            ref = _from_jax(tcfg, jc)
            off = sum((tc[n] != ref[n]).transpose(0, 1)
                      .reshape(len(lens), -1).any(1)
                      for n in ("k", "v", "wk", "wv")).numpy() > 0
            row_tol[off] = ONE_LEVEL_TOL
        for i, rt in enumerate(row_tol):
            _close(tl[i].numpy(), jl[i], tol=rt, what=f"step {t} row {i}")
        tok = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1),
                       np.int32)[:, None]
        assert (tl[:, -1, :cfg.vocab_size].argmax(-1).numpy()
                == tok[:, 0]).all()
    _check_cache(tc, _from_jax(tcfg, jc), quant, "cache after decode")


def test_forward_train_loss_and_grads_match_jax(setup):
    """The next-token loss of an 8 x 40 batch (every local layer masks
    past its window) and every gradient, against ``jax.grad``."""
    cfg, tcfg, jparams, _ = setup
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (4, 40)).astype(np.int32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_train(p, cfg, {"tokens": jnp.asarray(toks)},
                            remat="none"), has_aux=True))(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    leaves = [t.requires_grad_() for t in _leaves(tparams)]
    loss, _ = forward_train(tparams, tcfg,
                            {"tokens": torch.from_numpy(toks)}, remat="full")
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.item(), jloss, what="loss")
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                           device="cpu")
    assert len(grads) == len(_leaves(want))
    for i, (g, w) in enumerate(zip(grads, _leaves(want))):
        _close(g.numpy(), w.numpy(), what=f"grad leaf {i}")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_params_from_jax_at_full_depth(quant):
    """gemma3's 26 layers scan as ``(pattern, 4)`` and ``(pattern[:2],
    1)``: at smoke widths and full depth the converted weights and caches
    (22 local layers, 4 global) give the JAX logits."""
    name = "gemma3-1b"
    cfg = dataclasses.replace(smoke_config(name), n_layers=26)
    tcfg = dataclasses.replace(torch_smoke_config(name), n_layers=26)
    assert [len(p) * n for p, n in tcfg.layer_groups()] == [24, 2]
    jparams = jax_init(cfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    assert len(tparams["layers"]) == 26
    toks = _prompts(cfg, [21, 21], seed=2)
    jl, jc = jax_prefill(jparams, cfg, {"tokens": jnp.asarray(toks)},
                         cache_len=32)
    tl, tc = forward_prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                             cache_len=32)
    _close(tl.numpy(), jl, tol=INT8_TOL if quant else TOL, what="logits")
    ref = _from_jax(tcfg, jc)
    assert ref["wk"].shape[:3] == (22, 2, 16) and ref["k"].shape[:3] == \
        (4, 2, 32)
    _check_cache(tc, ref, quant, "full-depth cache")
