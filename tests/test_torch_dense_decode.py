"""The port's dense KV decode against the JAX package on the CPU.

``attn_decode_step`` with a scalar ``pos`` (every row at one position,
the sequential engine) and a ``(B,)`` vector (per-row positions, the
slot engine), on float caches and on int8 caches under
``set_kv_cache_quant(True)``; ``forward_decode`` for a few greedy steps
on dense caches laid by the JAX prefill and carried into the port by
``cache_from_jax``; ``init_cache`` following the flag.  Float32, TF32
off.  Tolerances: 1e-5 on float caches; on int8 caches the logits
within 1e-4 of the JAX int8 logits, except on a row whose cache holds a
cell one int8 level away from the JAX cell.  Both quantizers round half
to even, but their inputs are each package's own K/V projections, whose
float32 values differ in the last bits (other summation orders); a value
that close to a half level lands one level apart.  phi3.5-moe's smoke
config (head_dim 8: a level is 1/127 of the largest of only 8 values)
has one such cell in these steps, and it moves its row's logits by
1.4e-3: such a row is held to ``ONE_LEVEL_TOL`` = 5e-3, and every int8
cell to within one level.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import attention as jattn
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import forward_decode, forward_prefill, init_cache

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5
INT8_TOL = 1e-4
ONE_LEVEL_TOL = 5e-3
NAMES = ("qwen2.5-0.5b", "phi3.5-moe-42b")
_SETUPS = {}


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _setup(name):
    if name not in _SETUPS:
        cfg = smoke_config(name)
        jparams = jax_init(cfg, jax.random.PRNGKey(0))
        tcfg = torch_smoke_config(name)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu")
        _SETUPS[name] = (cfg, tcfg, jparams, tparams)
    return _SETUPS[name]


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


def _torch(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":          # exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _check_cache(tc, ref, quant, what):
    """A port cache against a reference one (torch tensors, same
    layout): float cells within TOL; int8 cells within one level, their
    bf16 scales within one bf16 ulp."""
    assert {k: v.dtype for k, v in tc.items()} == \
        {k: v.dtype for k, v in ref.items()}, what
    for name in tc:
        got, want = tc[name].float().numpy(), ref[name].float().numpy()
        if not quant:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=f"{what} {name}")
        elif name in ("k", "v"):
            assert np.abs(got - want).max() <= 1, (what, name)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0,
                                       err_msg=f"{what} {name}")


def _from_jax(cfg, jc):
    return cache_from_jax(jax.tree.map(np.asarray, jc), cfg, device="cpu")


@pytest.mark.parametrize("per_row", [False, True],
                         ids=["scalar_pos", "vector_pos"])
def test_attn_decode_step_matches_jax(quant, per_row):
    cfg, tcfg, jparams, tparams = _setup("qwen2.5-0.5b")
    jp = jax.tree.map(lambda x: x[0], jparams["groups"][0]["b0"]["mixer"])
    tp = tparams["layers"][0]["mixer"]
    rng = np.random.default_rng(0)
    b, cap, hd = 3, 16, cfg.resolved_head_dim
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, b, cap, cfg.n_kv_heads, hd)
                             ).astype(np.float32)
    # Positions past cap exercise the ring's write cell and mask.
    pos = np.array([5, 0, 21], np.int32) if per_row else np.int32(19)
    jcache = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])}
    if quant:
        (kq, ks), (vq, vs) = jattn._quant_kv(kv[0]), jattn._quant_kv(kv[1])
        jcache = {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
    tcache = {name: _torch(t) for name, t in jcache.items()}
    jout, jnew = jattn.attn_decode_step(jp, jnp.asarray(x), jcache,
                                        jnp.asarray(pos), cfg, kind="attn")
    tout, tnew = tattn.attn_decode_step(tp, torch.from_numpy(x), tcache,
                                        torch.as_tensor(pos), tcfg)
    tol = INT8_TOL if quant else TOL
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=tol,
                               atol=tol)
    assert tnew is tcache                        # written in place
    _check_cache(tnew, {k: _torch(v) for k, v in jnew.items()}, quant,
                 "decode-step cache")


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("per_row", [False, True],
                         ids=["scalar_pos", "vector_pos"])
def test_forward_decode_on_dense_caches_matches_jax(name, quant, per_row):
    """Three greedy decode steps from a right-padded prefill at cache
    capacity 24: per-row positions attend each row's own prefix; the
    scalar position ``max(lens)`` attends every row's pad cells too, in
    both packages."""
    cfg, tcfg, jparams, tparams = _setup(name)
    lens = np.array([5, 9, 3], np.int32)
    toks = _prompts(cfg, lens)
    last = lens - 1
    jl, jc = jax_prefill(jparams, cfg, {"tokens": jnp.asarray(toks)},
                         cache_len=24, logits_index=jnp.asarray(last))
    tl, tc_own = forward_prefill(tparams, tcfg,
                                 {"tokens": torch.from_numpy(toks)},
                                 cache_len=24,
                                 logits_index=torch.from_numpy(last))
    tc = _from_jax(tcfg, jc)
    _check_cache(tc_own, tc, quant, "prefill cache")
    tol = INT8_TOL if quant else TOL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    tok = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1),
                   np.int32)[:, None]
    for t in range(3):
        pos = lens + t if per_row else np.int32(lens.max() + t)
        jl, jc = jax_decode(jparams, cfg, jnp.asarray(tok), jc,
                            jnp.asarray(pos))
        tl, tc = forward_decode(tparams, tcfg, torch.from_numpy(tok), tc,
                                torch.as_tensor(pos))
        row_tol = np.full(len(lens), tol)
        if quant:
            ref = _from_jax(tcfg, jc)
            off = sum((tc[n] != ref[n]).transpose(0, 1).reshape(len(lens), -1)
                      .any(1) for n in ("k", "v")).numpy() > 0
            row_tol[off] = ONE_LEVEL_TOL
        for i, rt in enumerate(row_tol):
            np.testing.assert_allclose(tl[i].numpy(), np.asarray(jl[i]),
                                       rtol=rt, atol=rt,
                                       err_msg=f"step {t} row {i}")
        tok = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1),
                       np.int32)[:, None]
        assert (tl[:, -1, :cfg.vocab_size].argmax(-1).numpy()
                == tok[:, 0]).all()
    _check_cache(tc, _from_jax(tcfg, jc), quant, "cache after decode")


def test_init_cache_follows_the_quant_flag(quant):
    cfg, tcfg, _, _ = _setup("qwen2.5-0.5b")
    jc = _from_jax(tcfg, jax_init_cache(cfg, 2, 24))
    tc = init_cache(tcfg, 2, 24, torch.float32, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in tc.items()} == \
        {k: (v.shape, v.dtype) for k, v in jc.items()}
    assert set(tc) == ({"k", "v", "k_s", "v_s"} if quant else {"k", "v"})
    assert all((t == 0).all() for t in tc.values())
