"""Training on recurrent layers against the JAX package on the CPU:
``smoke_config("recurrentgemma-2b")`` (6 layers, RGLRU, RGLRU, LOCAL,
d 64, window 16) and ``smoke_config("rwkv6-3b")`` (2 WKV layers, 8
heads of 8), weights from ``repro.models.init_params`` through
``params_from_jax``, float32 with TF32 off unless a test says bf16.

* ``forward_train`` loss and accuracy (``LOSS_TOL`` = 1e-5) and every
  gradient (``GRAD_TOL`` = 1e-4 of each leaf's largest magnitude)
  against ``jax.value_and_grad`` of the reference's ``forward_train``,
  at S a multiple of CHUNK (32), off it (40: the pad mask) and below the
  conv width (3).  At S = 3 the WKV decay projection's exact gradient
  is 0 (the decay of position 1 reaches only position 2, whose output
  predicts no token), so both sides hold only rounding noise there: a
  leaf's bound is floored at ``GRAD_TOL`` x ``NOISE_FLOOR`` of the
  tree's largest gradient.
* The two spots where the reference's gradient could part from
  autograd's: the clamp of ``1 - a^2`` at 1e-12 (gates that drive
  ``a`` to 1, where ``torch.clamp`` and ``jnp.maximum`` both pass no
  gradient), and the chunk scan's ``exp(-cs)`` / ``exp(cs - wc)``
  factors at the largest decay (up to e^44.8), each module's gradient
  against ``jax.grad`` within ``GRAD_TOL``.
* ``remat`` none / full / dots give the same loss and gradients (1e-6).
* Parameters after 3 ``make_train_step`` steps against the reference's
  jitted train step (1e-4, absolute and relative).
* A ``Trainer`` run whose loss falls; in bf16, the float32 leaves
  (``gate_r``, ``gate_i``, ``lam``; ``mu``, ``u``) get float32
  gradients, float32 moments and stay float32 through a checkpoint
  round trip; and the bf16 gradients lie within ``BF16_GRAD_REL`` of
  each leaf's largest magnitude of the float32 reference's on the same
  (bf16-rounded) weights, the loss within ``BF16_LOSS_REL``.
* ``python -m repro_torch.launch.train --smoke --device cpu`` trains
  both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro.optim import adamw as jax_adamw
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import ckpt
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as launch_train
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv6 as trwkv
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train import (loss_and_grads, make_train_step, Trainer,
                               TrainerConfig)

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RG, RWKV = "recurrentgemma-2b", "rwkv6-3b"
NAMES = (RG, RWKV)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
NOISE_FLOOR = 1e-4
# bf16 training: the weights, activations and each K1 output round to
# 8 significant bits, through six layers and the scans.
BF16_GRAD_REL = 2.0 ** -3
BF16_LOSS_REL = 2.0 ** -7
F32_LEAVES = {RG: ("gate_r", "gate_i", "lam"), RWKV: ("mu", "u")}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _model(name, dtype="float32"):
    cfg = dataclasses.replace(smoke_config(name), param_dtype=dtype)
    tcfg = dataclasses.replace(torch_smoke_config(name), param_dtype=dtype)
    return cfg, tcfg, jax_init(cfg, jax.random.PRNGKey(0))


def _to_torch(jtree, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                           device="cpu")


def _tokens(vocab, s, b=2, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _assert_grads_close(got_tree, ref_tree, rel=GRAD_TOL):
    """Every leaf within ``rel`` of the larger of its largest magnitude
    and ``NOISE_FLOOR`` of the tree's (module doc)."""
    got, ref = tree_leaves(got_tree), tree_leaves(ref_tree)
    assert len(got) == len(ref)
    top = max(r.abs().max().item() for r in ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.detach().float().numpy(), r.float().numpy()
        assert g.shape == r.shape
        scale = max(np.abs(r).max(), NOISE_FLOOR * top)
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * scale,
                                   err_msg=f"leaf {i}")


def _jax_value_and_grad(jparams, cfg, toks, **kw):
    def loss_fn(p):
        return jax_forward_train(p, cfg, {"tokens": jnp.asarray(toks)},
                                 remat="none")
    return jax.value_and_grad(loss_fn, has_aux=True)(jparams)


# --------------------------------------------------------------------------
# forward_train: loss, accuracy and every gradient
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s", [32, 40, 3])
@pytest.mark.parametrize("name", NAMES)
def test_forward_train_loss_and_grads_match_jax_grad(name, s):
    cfg, tcfg, jparams = _model(name)
    toks = _tokens(cfg.vocab_size, s)
    (jloss, jmet), jgrads = _jax_value_and_grad(jparams, cfg, toks)
    loss, metrics, grads = loss_and_grads(
        _to_torch(jparams, tcfg), tcfg, {"tokens": torch.from_numpy(toks)},
        remat="none")
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    for k in ("loss", "accuracy", "moe_aux"):
        assert abs(float(metrics[k]) - float(jmet[k])) <= LOSS_TOL, k
    _assert_grads_close(grads, _to_torch(jgrads, tcfg))


def _rg_mixer_at_the_clamp():
    """recurrentgemma's first mixer with ``gate_r`` of +-1000 on
    alternate channels and ``lam`` large: where the conv's output times
    ``gate_r`` is well below 0, r is 0 in float32, a is 1, ``1 - a^2``
    is 0 and the clamp at 1e-12 holds; elsewhere r is 1 and a about
    e^-24."""
    cfg, tcfg, jparams = _model(RG)
    mix = jax.tree.map(lambda x: np.array(x[0]),
                       jparams["groups"][0]["b0"]["mixer"])
    d = cfg.d_model
    mix["gate_r"] = np.where(np.arange(d) % 2, 1e3, -1e3).astype(
        np.float32)
    mix["gate_i"] = np.random.default_rng(5).standard_normal(d).astype(
        np.float32)
    mix["lam"] = np.full(d, 3.0, np.float32)
    return cfg, tcfg, mix


def test_rglru_grads_through_the_clamp_match_jax():
    cfg, tcfg, mix = _rg_mixer_at_the_clamp()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    # Where x * gate_r < 0 by a margin, a is 1 and the clamp holds.
    jp = jax.tree.map(jnp.asarray, mix)
    a, _ = jrglru._gates(jp, jrglru._conv1d(jp, jrglru.linear_apply(
        jp["in_rec"], jnp.asarray(x))).astype(jnp.float32))
    assert float(jnp.mean(a == 1.0)) > 0.2

    def jloss(p, xx):
        return jnp.sum(jrglru.rglru_apply(p, xx, cfg) * jnp.asarray(r))

    jgp, jgx = jax.jit(jax.grad(jloss, (0, 1)))(jp, jnp.asarray(x))
    tp = tree_map(lambda v: torch.from_numpy(v.copy()).requires_grad_(), mix)
    tx = torch.from_numpy(x).requires_grad_()
    (trglru.rglru_apply(tp, tx, tcfg) * torch.from_numpy(r)).sum().backward()
    assert torch.isfinite(tx.grad).all()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=GRAD_TOL * np.abs(jgx).max())
    _assert_grads_close(tree_map(lambda t: t.grad, tp),
                        jax.tree.map(lambda v: torch.from_numpy(np.array(v)),
                                     jgp))


def test_rwkv_grads_through_the_largest_decay_factors_match_jax():
    """The decay projection's weights scaled so every ``wlog`` sits at
    about -1.4: a chunk's cumulative sum reaches -44.8, ``exp(-cs)``
    e^44.8 and ``exp(cs - wc)`` e^-43.4, in the forward and in autograd's
    backward."""
    cfg, tcfg, jparams = _model(RWKV)
    mix = jax.tree.map(lambda x: np.array(x[0]),
                       jparams["groups"][0]["b0"]["mixer"])
    rng = np.random.default_rng(7)
    mix["mu"] = rng.uniform(0, 1, mix["mu"].shape).astype(np.float32)
    mix["w"]["w"] = (np.abs(mix["w"]["w"]) * 200).astype(np.float32)
    x = np.abs(rng.standard_normal((2, 64, cfg.d_model))).astype(np.float32)
    r = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, mix)
    wlog = jrwkv._projections(jp, jnp.asarray(x), jnp.zeros((2, cfg.d_model)),
                              *jrwkv.rwkv_head_dims(cfg))[3]
    assert float(jnp.max(wlog)) < -1.39

    def jloss(p, xx):
        return jnp.sum(jrwkv.rwkv_apply(p, xx, cfg) * jnp.asarray(r))

    jgp, jgx = jax.jit(jax.grad(jloss, (0, 1)))(jp, jnp.asarray(x))
    tp = tree_map(lambda v: torch.from_numpy(v.copy()).requires_grad_(), mix)
    tx = torch.from_numpy(x).requires_grad_()
    (trwkv.rwkv_apply(tp, tx, tcfg) * torch.from_numpy(r)).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in tree_leaves(tp))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=GRAD_TOL * np.abs(jgx).max())
    _assert_grads_close(tree_map(lambda t: t.grad, tp),
                        jax.tree.map(lambda v: torch.from_numpy(np.array(v)),
                                     jgp))


@pytest.mark.parametrize("name", NAMES)
def test_remat_modes_give_the_same_values(name):
    cfg, tcfg, jparams = _model(name)
    params = _to_torch(jparams, tcfg)
    batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, 40,
                                                seed=3))}
    base = loss_and_grads(params, tcfg, batch, remat="none")
    for remat in ("full", "dots"):
        got = loss_and_grads(params, tcfg, batch, remat=remat)
        assert abs(float(got[0]) - float(base[0])) <= 1e-6
        _assert_grads_close(got[2], base[2], 1e-6)


# --------------------------------------------------------------------------
# Train step, Trainer, checkpoints, bf16
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_train_step_params_after_3_steps_match_reference(name):
    cfg, tcfg, jparams = _model(name)
    rng = np.random.default_rng(9)
    batches = [rng.integers(0, cfg.vocab_size, (4, 40), dtype=np.int32)
               for _ in range(3)]
    jstep = jax.jit(jax_make_train_step(
        cfg, opt_cfg=jax_adamw.AdamWConfig(**OPT), remat="none"))
    jp, jstate = jparams, jax_adamw.init_state(jparams)
    for toks in batches:
        jp, jstate, jmet = jstep(jp, jstate, {"tokens": jnp.asarray(toks)})
    step = make_train_step(tcfg, opt_cfg=adamw.AdamWConfig(**OPT),
                           remat="full")
    tp = _to_torch(jparams, tcfg)
    state = adamw.init_state(tp)
    for toks in batches:
        tp, state, met = step(tp, state, {"tokens": torch.from_numpy(toks)})
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-4
    for g, r in zip(tree_leaves(tp), tree_leaves(_to_torch(jp, tcfg)),
                    strict=True):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_trainer_loss_falls(name):
    tcfg = torch_smoke_config(name)
    out = Trainer(tcfg, TrainerConfig(steps=12, global_batch=4, seq_len=40,
                                      log_every=100, remat="full"),
                  opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup_steps=2,
                                            total_steps=12),
                  device="cpu").run()
    losses = [h["loss"] for h in out["history"]]
    assert all(np.isfinite(losses))
    assert out["final_loss"] < out["first_loss"], losses


def _f32_leaves(name, params):
    return [layer["mixer"][k] for layer in params["layers"]
            for k in F32_LEAVES[name] if k in layer["mixer"]]


@pytest.mark.parametrize("name", NAMES)
def test_bf16_training_keeps_the_f32_leaves_f32(name, tmp_path):
    """A bf16 ``Trainer`` run with a checkpoint: the float32 leaves'
    gradients and moments are float32 and the leaves move; after the
    restore every leaf has the dtype and bits it was saved with."""
    _, tcfg, _ = _model(name, "bfloat16")
    tr = Trainer(tcfg, TrainerConfig(steps=2, global_batch=2, seq_len=40,
                                     ckpt_every=2, ckpt_dir=str(tmp_path),
                                     log_every=100), device="cpu")
    _, params, _ = tr.init_or_restore()
    assert params["embed"]["table"].dtype == torch.bfloat16
    before = [t.clone() for t in _f32_leaves(name, params)]
    assert before and all(t.dtype == torch.float32 for t in before)
    batch = {"tokens": torch.from_numpy(tr.data.batch(0)["tokens"])}
    _, _, grads = loss_and_grads(params, tcfg, batch)
    assert all(g.dtype == torch.float32 for g in _f32_leaves(name, grads))
    out = tr.run()
    moved = _f32_leaves(name, out["params"])
    assert all(t.dtype == torch.float32 for t in moved)
    assert any(not torch.equal(a, b) for a, b in zip(moved, before))
    assert all(m.dtype == torch.float32
               for m in tree_leaves(out["opt_state"].mu))
    like = tree_map(torch.zeros_like, (out["params"], out["opt_state"]))
    step, (back, _) = ckpt.restore(ckpt.latest_step_dir(str(tmp_path)),
                                   like)
    assert step == 2
    for a, b in zip(tree_leaves(back), tree_leaves(out["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_gradients_stay_near_the_f32_reference(name):
    """The port in bf16 against the reference in float32 on the same
    bf16-rounded weights: loss within ``BF16_LOSS_REL``, every gradient
    leaf within ``BF16_GRAD_REL`` of its largest magnitude."""
    cfg, tcfg, jparams = _model(name, "bfloat16")
    cfg32 = smoke_config(name)
    toks = _tokens(cfg.vocab_size, 40, seed=4)
    (jloss, _), jgrads = _jax_value_and_grad(
        jax.tree.map(lambda x: x.astype(jnp.float32), jparams), cfg32, toks)
    loss, _, grads = loss_and_grads(_to_torch(jparams, tcfg), tcfg,
                                    {"tokens": torch.from_numpy(toks)},
                                    remat="none")
    assert abs(float(loss) - float(jloss)) <= BF16_LOSS_REL * abs(
        float(jloss))
    ref = _to_torch(jgrads, torch_smoke_config(name))
    for g, r in zip(tree_leaves(grads), tree_leaves(ref), strict=True):
        err = (g.float() - r).abs().max().item()
        assert err <= BF16_GRAD_REL * r.abs().max().item(), (g.shape, err)


@pytest.mark.parametrize("name", NAMES)
def test_launch_train_runs_on_the_cpu(name, capsys):
    assert launch_train.main(["--arch", name, "--smoke", "--steps", "3",
                              "--batch", "2", "--seq", "33",
                              "--device", "cpu"]) == 0
    assert "done: loss" in capsys.readouterr().out

