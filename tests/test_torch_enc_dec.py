"""whisper-base's encoder-decoder against the JAX package on the CPU, on
``smoke_config("whisper-base")`` (2 bidirectional encoder layers, 2
decoder layers each with cross-attention, d 64, GQA 4/2 at head_dim 8,
biases on every linear, a GELU MLP without a gate, ``frontend_dim`` 16,
``enc_frames`` 12, tied head), weights from ``repro.models.init_params``
through ``params_from_jax``, float32 with TF32 off.

* ``init_params``' tree (the encoder's layers and final norm, each
  decoder layer's ``norm_cross`` and ``cross``) against the reference's
  through ``params_from_jax``, and the converted encoder and cross
  leaves equal to the reference's.
* ``attn_apply(kind="bidir")`` (RoPE, no mask) and ``kind="cross"`` (no
  RoPE, no mask; the K/V it returns are ``encode_cross_kv``'s), and
  ``encode_cross_kv`` and ``cross_attn_decode``, each within ``TOL`` =
  1e-5 of the JAX function; ``_encode`` likewise.
* ``forward_train`` loss and accuracy within ``TOL`` and every gradient
  within ``GRAD_TOL`` = 1e-4 of each leaf's largest magnitude of
  ``jax.value_and_grad``, at remat none and full, except the
  cross-attention key biases: their exact gradient is 0 (with no RoPE,
  a bias on the keys adds one constant to a query's logits, which the
  softmax removes), so both sides hold only rounding noise there, each
  within ``NOISE`` = 1e-6 of the tree's largest gradient.
* ``forward_prefill`` logits and caches (``k``, ``v`` and the cross
  stacks ``xk``, ``xv`` through ``cache_from_jax``) with no, a scalar
  and a ``(B,)`` ``logits_index``; three ``forward_decode`` steps at a
  scalar and a vector ``pos`` from those caches, the cross stacks
  bitwise unchanged and the tokens the reference's; ``init_cache``'s
  stacks the reference's.
* The reference's decoder-embedding quirk, pinned: unscaled in
  training and prefill, scaled by √d in decode, so the last token's
  logits differ between a prefill and a decode of it, in both packages
  alike.
* ``CACHE_QUANT`` on: the self stacks int8 (cells within one level of
  the reference's), the cross stacks at model precision and within
  ``TOL``, decode logits within ``INT8_TOL`` = 1e-4.
* Parameters after 3 ``make_train_step`` steps against the reference's
  jitted step (1e-4), but the cross-attention key biases: AdamW turns
  their noise gradients into steps of about lr either way, so on each
  side they move by at most 3 lr; ``launch.train`` on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import attention as jattn
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import forward_train as jax_forward_train
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models.common import IDENTITY_SHARDER
from repro.models.transformer import _encode as jax_encode
from repro.optim import adamw as jax_adamw
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as tattn
from repro_torch.models import (forward_decode, forward_prefill,
                                init_cache, init_params)
from repro_torch.models.common import embed_scale
from repro_torch.models.transformer import _embed_inputs, _encode
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import loss_and_grads, make_train_step

NAME = "whisper-base"
TOL = 1e-5
GRAD_TOL = 1e-4
NOISE = 1e-6
INT8_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
B, S, CAP = 2, 10, 24
_SETUP = {}


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture
def quant():
    """Both packages' dense int8 flag on, restored in ``finally`` (the
    flags are process-wide and xdist runs many files in one worker)."""
    jattn.set_kv_cache_quant(True)
    tattn.set_kv_cache_quant(True)
    try:
        yield
    finally:
        jattn.set_kv_cache_quant(False)
        tattn.set_kv_cache_quant(False)


def _setup(dtype="float32"):
    """(JAX cfg, port cfg, JAX params, port params), built once."""
    if dtype not in _SETUP:
        cfg = dataclasses.replace(smoke_config(NAME), param_dtype=dtype)
        tcfg = dataclasses.replace(torch_smoke_config(NAME),
                                   param_dtype=dtype)
        jparams = jax_init(cfg, jax.random.PRNGKey(0))
        _SETUP[dtype] = (cfg, tcfg, jparams, _to_torch(jparams, tcfg))
    return _SETUP[dtype]


def _to_torch(jtree, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                           device="cpu")


def _spec(tree):
    if isinstance(tree, dict):
        return {k: _spec(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _features(cfg, b=B, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_frames, cfg.frontend_dim)).astype(np.float32)


def _batch(cfg, s=S, seed=1):
    """A serving-shaped batch: tokens (B, s) and one feature block of
    ``enc_frames`` a row."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s),
                                                dtype=np.int32)
    return {"tokens": toks, "frontend_embeds": _features(cfg, seed=seed)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _from_jax(tcfg, jc):
    return cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")


def _paths(tree, path=()):
    """(path, leaf) in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _zero_grad(path) -> bool:
    """A cross-attention key bias (module doc)."""
    return path[-3:] == ("cross", "k", "b")


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_the_references_tree(dtype):
    cfg, tcfg, jparams, _ = _setup(dtype)
    got = init_params(tcfg, seed=1, device="cpu")
    assert _spec(got) == _spec(_to_torch(jparams, tcfg))
    assert len(got["encoder"]["layers"]) == cfg.n_enc_layers
    assert set(got["encoder"]) == {"layers", "final_norm"}
    for layer in got["layers"]:
        assert {"norm_cross", "cross"} <= set(layer)
        assert set(layer["cross"]) == {"q", "k", "v", "o"}
        assert "b" in layer["cross"]["q"]                 # use_bias
    assert all("cross" not in layer for layer in got["encoder"]["layers"])


def test_params_from_jax_carries_the_encoder_and_cross_leaves():
    cfg, tcfg, jparams, tparams = _setup()
    enc = jparams["encoder"]["groups"][0]["b0"]
    for r, layer in enumerate(tparams["encoder"]["layers"]):
        for name in ("q", "o"):
            np.testing.assert_array_equal(
                layer["mixer"][name]["w"].numpy(),
                np.asarray(enc["mixer"][name]["w"][r]))
        np.testing.assert_array_equal(layer["mlp"]["up"]["b"].numpy(),
                                      np.asarray(enc["mlp"]["up"]["b"][r]))
    np.testing.assert_array_equal(
        tparams["encoder"]["final_norm"]["scale"].numpy(),
        np.asarray(jparams["encoder"]["final_norm"]["scale"]))
    dec = jparams["groups"][0]["b0"]
    for r, layer in enumerate(tparams["layers"]):
        for name in ("q", "k", "v", "o"):
            np.testing.assert_array_equal(
                layer["cross"][name]["b"].numpy(),
                np.asarray(dec["cross"][name]["b"][r]))
        np.testing.assert_array_equal(
            layer["norm_cross"]["scale"].numpy(),
            np.asarray(dec["norm_cross"]["scale"][r]))


# --------------------------------------------------------------------------
# Modules: bidirectional and cross attention, the encoder
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["bidir", "cross"])
def test_attn_apply_matches_jax(kind):
    cfg, tcfg, jparams, tparams = _setup()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)
                              ).astype(np.float32)
    where = "cross" if kind == "cross" else "mixer"
    kv = enc if kind == "cross" else None
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][0]["b0"][where])
    tp = tparams["layers"][0][where]
    want = jattn.attn_apply(jp, jnp.asarray(x), cfg, kind=kind,
                            kv_x=None if kv is None else jnp.asarray(kv))
    got, k, v = tattn.attn_apply(
        tp, torch.from_numpy(x), tcfg, kind=kind,
        kv_x=None if kv is None else torch.from_numpy(kv))
    _close(got.numpy(), want, what=kind)
    if kind == "cross":
        ref = jattn.encode_cross_kv(jp, jnp.asarray(enc), cfg)
        assert tuple(k.shape) == (B, cfg.enc_frames, cfg.n_kv_heads,
                                  cfg.resolved_head_dim)
        _close(k.numpy(), ref["k"], what="cross k")
        _close(v.numpy(), ref["v"], what="cross v")
    # bidirectional: the first position sees the last (no causal mask)
    x2 = x.copy()
    x2[:, -1] += 1.0
    again = tattn.attn_apply(tp, torch.from_numpy(x2), tcfg, kind=kind,
                             kv_x=None if kv is None
                             else torch.from_numpy(kv))[0]
    assert (kind == "bidir") == bool((again[:, 0] != got[:, 0]).any())
    with pytest.raises(ValueError):
        tattn.attn_apply(tp, torch.from_numpy(x), tcfg, kind=kind,
                         kv_x=None if kind == "cross"
                         else torch.from_numpy(enc))


def test_encode_cross_kv_and_cross_attn_decode_match_jax():
    cfg, tcfg, jparams, tparams = _setup()
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)
                              ).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    for r in range(cfg.n_layers):
        jp = jax.tree.map(lambda a, r=r: a[r],
                          jparams["groups"][0]["b0"]["cross"])
        tp = tparams["layers"][r]["cross"]
        jkv = jattn.encode_cross_kv(jp, jnp.asarray(enc), cfg)
        tkv = tattn.encode_cross_kv(tp, torch.from_numpy(enc), tcfg)
        for name in ("k", "v"):
            _close(tkv[name].numpy(), jkv[name], what=name)
        want = jattn.cross_attn_decode(jp, jnp.asarray(x), jkv, cfg)
        got = tattn.cross_attn_decode(tp, torch.from_numpy(x), tkv, tcfg)
        _close(got.numpy(), want, what=f"layer {r}")


def test_encode_matches_jax():
    cfg, tcfg, jparams, tparams = _setup()
    batch = _batch(cfg)
    want = jax_encode(jparams, cfg, _jb(batch), sharder=IDENTITY_SHARDER,
                      remat="none")
    got = _encode(tparams, tcfg, _tb(batch))
    assert tuple(got.shape) == (B, cfg.enc_frames, cfg.d_model)
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------
@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_train_loss_and_grads_match_jax_grad(remat):
    cfg, tcfg, jparams, tparams = _setup()
    batch = JaxSyntheticLM(cfg, B, 24, JaxDataConfig(seed=3)).batch(0)
    assert set(batch) == {"tokens", "frontend_embeds"}

    def loss_fn(p):
        return jax_forward_train(p, cfg, _jb(batch), remat="none")

    (jloss, jmet), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jparams)
    loss, metrics, grads = loss_and_grads(tparams, tcfg, _tb(batch),
                                          remat=remat)
    assert abs(float(loss) - float(jloss)) <= TOL
    for k in ("loss", "accuracy", "moe_aux"):
        assert abs(float(metrics[k]) - float(jmet[k])) <= TOL, k
    ref = _to_torch(jgrads, tcfg)
    assert _spec(grads) == _spec(ref)
    leaves = list(_paths(ref))
    assert all(a is b for (_, a), b in zip(leaves, tree_leaves(ref),
                                           strict=True))
    top = max(r.abs().max().item() for _, r in leaves)
    assert sum(_zero_grad(p) for p, _ in leaves) == cfg.n_layers
    for g, (path, r) in zip(tree_leaves(grads), leaves, strict=True):
        if _zero_grad(path):
            assert max(g.abs().max().item(), r.abs().max().item()) \
                <= NOISE * top, path
            continue
        np.testing.assert_allclose(
            g.numpy(), r.numpy(), rtol=0,
            atol=GRAD_TOL * max(r.abs().max().item(), 1e-30),
            err_msg=str(path))
    for layer in grads["encoder"]["layers"] + grads["layers"]:
        assert layer["mixer"]["q"]["w"].abs().max() > 0
    assert grads["frontend_proj"]["w"].abs().max() > 0


def test_train_step_params_after_3_steps_match_reference():
    cfg, tcfg, jparams, _ = _setup()
    data = JaxSyntheticLM(cfg, 4, 20, JaxDataConfig(seed=9))
    batches = [data.batch(i) for i in range(3)]
    jstep = jax.jit(jax_make_train_step(
        cfg, opt_cfg=jax_adamw.AdamWConfig(**OPT), remat="none"))
    jp, jstate = jparams, jax_adamw.init_state(jparams)
    for batch in batches:
        jp, jstate, jmet = jstep(jp, jstate, _jb(batch))
    step = make_train_step(tcfg, opt_cfg=adamw.AdamWConfig(**OPT),
                           remat="full")
    tp = _to_torch(jparams, tcfg)
    state = adamw.init_state(tp)
    for batch in batches:
        tp, state, met = step(tp, state, _tb(batch))
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-4
    start = tree_leaves(_to_torch(jparams, tcfg))
    for g, r, (path, p0) in zip(tree_leaves(tp),
                                tree_leaves(_to_torch(jp, tcfg)),
                                zip([p for p, _ in _paths(tp)], start),
                                strict=True):
        if _zero_grad(path):
            for side in (g, r):
                assert (side - p0).abs().max() <= 3 * OPT["lr"], path
            continue
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


def test_launch_train_runs_on_the_cpu(capsys):
    assert launch_train.main(["--arch", NAME, "--smoke", "--steps", "3",
                              "--batch", "2", "--seq", "20",
                              "--device", "cpu"]) == 0
    assert "done: loss" in capsys.readouterr().out


# --------------------------------------------------------------------------
# Prefill and decode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("index", ["none", "scalar", "vector"])
def test_forward_prefill_matches_jax(index):
    cfg, tcfg, jparams, tparams = _setup()
    batch = _batch(cfg)
    last = {"none": None, "scalar": np.int32(S - 3),
            "vector": np.array([S - 1, 4], np.int32)}[index]
    jlog, jcache = jax_prefill(
        jparams, cfg, _jb(batch), cache_len=CAP,
        logits_index=None if last is None else jnp.asarray(last))
    tlog, tcache = forward_prefill(
        tparams, tcfg, _tb(batch), cache_len=CAP,
        logits_index=None if last is None
        else torch.from_numpy(np.asarray(last)))
    v = cfg.vocab_size
    _close(tlog.numpy()[..., :v], np.asarray(jlog)[..., :v])
    want = _from_jax(tcfg, jcache)
    assert set(tcache) == set(want) == {"k", "v", "xk", "xv"}
    kv = (cfg.n_layers, B, CAP, cfg.n_kv_heads, cfg.resolved_head_dim)
    x = (cfg.n_layers, B, cfg.enc_frames, cfg.n_kv_heads,
         cfg.resolved_head_dim)
    assert {k: tuple(t.shape) for k, t in tcache.items()} == \
        {"k": kv, "v": kv, "xk": x, "xv": x}
    for k in want:
        _close(tcache[k].numpy(), want[k].numpy(), what=k)


@pytest.mark.parametrize("per_row", [False, True],
                         ids=["scalar_pos", "vector_pos"])
def test_forward_decode_steps_match_jax(per_row):
    """Three greedy steps on the caches of a right-padded prefill: the
    logits within TOL, the tokens the reference's, the cross stacks
    never written."""
    cfg, tcfg, jparams, tparams = _setup()
    lens = np.array([7, 4], np.int32)
    batch = _batch(cfg, s=int(lens.max()), seed=2)
    last = lens - 1
    jl, jc = jax_prefill(jparams, cfg, _jb(batch), cache_len=CAP,
                         logits_index=jnp.asarray(last))
    tl, tc = forward_prefill(tparams, tcfg, _tb(batch), cache_len=CAP,
                             logits_index=torch.from_numpy(last))
    held = {k: tc[k].clone() for k in ("xk", "xv")}
    tok = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1),
                   np.int32)[:, None]
    for t in range(3):
        pos = lens + t if per_row else np.int32(lens.max() + t)
        jl, jc = jax_decode(jparams, cfg, jnp.asarray(tok), jc,
                            jnp.asarray(pos))
        tl, tc = forward_decode(tparams, tcfg, torch.from_numpy(tok), tc,
                                torch.as_tensor(pos))
        _close(tl.numpy(), np.asarray(jl), what=f"step {t}")
        tok = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1),
                       np.int32)[:, None]
        assert (tl[:, -1, :cfg.vocab_size].argmax(-1).numpy()
                == tok[:, 0]).all()
    for k, t in held.items():
        assert torch.equal(tc[k], t), k
    ref = _from_jax(tcfg, jc)
    for k in ref:
        _close(tc[k].numpy(), ref[k].numpy(), what=k)


def test_init_cache_matches_jax():
    cfg, tcfg, _, _ = _setup()
    want = _from_jax(tcfg, jax_init_cache(cfg, B, CAP, enc_len=7))
    got = init_cache(tcfg, B, CAP, torch.float32, device="cpu", enc_len=7)
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}
    assert got["xk"].shape[2] == 7
    assert all((t == 0).all() for t in got.values())
    # without enc_len the cross stacks take the sequence length, as the
    # reference's do
    assert init_cache(tcfg, B, CAP, torch.float32,
                      device="cpu")["xv"].shape[2] == CAP


def test_decoder_embedding_quirk_is_pinned():
    """The decoder's token embedding is unscaled in training and prefill
    and scaled by √d in decode, in the reference and in the port: the
    last token's logits from a prefill of the whole prompt differ from
    a decode of that token after a prefill of the rest, by the same
    logits in both packages."""
    cfg, tcfg, jparams, tparams = _setup()
    batch = _batch(cfg, s=6, seed=5)
    toks = torch.from_numpy(batch["tokens"])
    table = tparams["embed"]["table"]
    assert torch.equal(_embed_inputs(tparams, tcfg, {"tokens": toks}),
                       table[toks.long()])
    assert embed_scale(cfg.d_model, torch.float32) == 8.0
    full_j, _ = jax_prefill(jparams, cfg, _jb(batch), cache_len=CAP)
    full_t, _ = forward_prefill(tparams, tcfg, _tb(batch), cache_len=CAP)
    head = dict(batch, tokens=batch["tokens"][:, :-1].copy())
    _, jc = jax_prefill(jparams, cfg, _jb(head), cache_len=CAP)
    _, tc = forward_prefill(tparams, tcfg, _tb(head), cache_len=CAP)
    tail = batch["tokens"][:, -1:]
    step_j, _ = jax_decode(jparams, cfg, jnp.asarray(tail), jc, jnp.int32(5))
    step_t, _ = forward_decode(tparams, tcfg, torch.from_numpy(tail), tc, 5)
    v = cfg.vocab_size
    _close(full_t.numpy()[..., :v], np.asarray(full_j)[..., :v])
    _close(step_t.numpy()[..., :v], np.asarray(step_j)[..., :v])
    gap = np.abs(np.asarray(full_j)[..., :v] - np.asarray(step_j)[..., :v])
    assert gap.max() > 1e-2, gap.max()


def test_int8_flag_keeps_the_cross_stacks_at_model_precision(quant):
    cfg, tcfg, jparams, tparams = _setup()
    lens = np.array([7, 4], np.int32)
    batch = _batch(cfg, s=int(lens.max()), seed=6)
    last = lens - 1
    jl, jc = jax_prefill(jparams, cfg, _jb(batch), cache_len=CAP,
                         logits_index=jnp.asarray(last))
    tl, tc = forward_prefill(tparams, tcfg, _tb(batch), cache_len=CAP,
                             logits_index=torch.from_numpy(last))
    assert {k: t.dtype for k, t in tc.items()} == {
        "k": torch.int8, "v": torch.int8, "k_s": torch.bfloat16,
        "v_s": torch.bfloat16, "xk": torch.float32, "xv": torch.float32}
    fresh = init_cache(tcfg, B, CAP, torch.float32, device="cpu",
                       enc_len=cfg.enc_frames)
    assert {k: t.dtype for k, t in fresh.items()} == \
        {k: t.dtype for k, t in tc.items()}
    ref = _from_jax(tcfg, jc)
    assert set(ref) == set(tc)
    for name in tc:
        got, want = tc[name].float().numpy(), ref[name].float().numpy()
        if name in ("k", "v"):
            assert np.abs(got - want).max() <= 1, name
        elif name in ("k_s", "v_s"):
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
        else:
            _close(got, want, what=name)
    _close(tl.numpy(), np.asarray(jl), tol=INT8_TOL)
    held = {k: tc[k].clone() for k in ("xk", "xv")}
    tok = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1),
                   np.int32)[:, None]
    for t in range(3):
        pos = lens + t
        jl, jc = jax_decode(jparams, cfg, jnp.asarray(tok), jc,
                            jnp.asarray(pos))
        tl, tc = forward_decode(tparams, tcfg, torch.from_numpy(tok), tc,
                                torch.as_tensor(pos))
        _close(tl.numpy(), np.asarray(jl), tol=INT8_TOL, what=f"step {t}")
        tok = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1),
                       np.int32)[:, None]
    for k, t in held.items():
        assert torch.equal(tc[k], t), k
