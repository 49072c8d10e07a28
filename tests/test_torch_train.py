"""The port's training path (repro_torch.{models,optim,train,data,
checkpoint}) against the JAX package's on the CPU.

Both packages get the reference's seeded weights (handed over as numpy
through ``repro_torch.convert.params_from_jax``) and the same seeded numpy
inputs, in float32 on the smoke configs; the port's kernels take their
plain versions here.  Tolerances:

* MoE layer gradients (x, router, up, gate, down) against ``jax.grad``
  under the reference's ``"xla"`` and ``"pallas_interpret"`` experts,
  also with a capacity factor of 0.25 that drops pairs: 1e-5;
* ``forward_train`` loss and accuracy: 1e-5; every gradient leaf within
  1e-4 of that leaf's largest magnitude (f32 sums in another order);
* ``apply_updates`` and ``cosine_lr`` on random trees with bfloat16
  leaves: 1e-6 (bfloat16 leaves: one bf16 ulp, a rounding of values that
  agree within 1e-6);
* parameters after 3 train steps (``accum_steps`` 1 and 2), and
  ``remat="full"`` against ``"none"``: 1e-4, absolute and relative;
* ``SyntheticLM`` batches: bit-identical; checkpoints: exact.

The reference's expert switch is process-wide, so a test that sets it
restores ``"xla"`` in ``finally``.
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
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init
from repro.models import moe as jax_moe
from repro.optim import adamw as jax_adamw
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import ckpt
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed import (init_opt_state, place_train,
                                     unshard_tree, virtual_mesh)
from repro_torch.models import forward_train, moe, set_loss_dtype
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train import (loss_and_grads, make_train_step, Trainer,
                               TrainerConfig)

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ["qwen2.5-0.5b", "phi3.5-moe-42b", "dbrx-132b"]
B, S = 2, 12


def _model(name):
    cfg, tcfg = smoke_config(name), torch_smoke_config(name)
    jparams = jax_init(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, jparams


def _to_torch(jtree, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                           device="cpu")


def _tokens(seed, vocab, b=B, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _assert_leaves_close(got_tree, ref_tree, rel):
    """Every leaf within ``rel`` of that leaf's largest magnitude."""
    got, ref = tree_leaves(got_tree), tree_leaves(ref_tree)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = g.detach().float().numpy(), r.float().numpy()
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=rel * max(np.abs(r).max(), 1e-30))


def _assert_params_close(got_tree, ref_tree, tol=1e-4):
    """Parameters after AdamW steps within ``tol`` (absolute and
    relative): Adam's update is about lr * sign(g) wherever |g| >> eps,
    so an element whose gradient is near 0 in both packages may move by
    lr in either; a bound relative to a leaf's scale would not hold."""
    for g, r in zip(tree_leaves(got_tree), tree_leaves(ref_tree),
                    strict=True):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   r.float().numpy(), rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# MoE layer gradients
# --------------------------------------------------------------------------
def _with_factor(cfg, factor):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


@pytest.mark.parametrize("factor", [None, 0.25], ids=["cap", "drop"])
@pytest.mark.parametrize("name", ["phi3.5-moe-42b", "dbrx-132b"])
def test_moe_apply_grads_match_both_jax_expert_paths(name, factor):
    cfg, tcfg = smoke_config(name), torch_smoke_config(name)
    if factor is not None:
        cfg, tcfg = _with_factor(cfg, factor), _with_factor(tcfg, factor)
    jp = jax_moe.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(tp, tx, tcfg)
    ((y * torch.from_numpy(r)).sum() + 0.3 * aux).backward()

    def loss(p, xx):
        yy, a = jax_moe.moe_apply(p, xx, cfg)
        return jnp.sum(yy * jnp.asarray(r)) + 0.3 * a

    for impl in ("xla", "pallas_interpret"):
        try:
            jax_moe.set_expert_backend(impl)
            gp, gx = jax.grad(loss, (0, 1))(jp, jnp.asarray(x))
        finally:
            jax_moe.set_expert_backend("xla")
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                                   rtol=1e-5, atol=1e-5)
        assert set(gp) == set(tp) >= {"router", "up", "down"}
        for k in gp:
            np.testing.assert_allclose(tp[k].grad.numpy(),
                                       np.asarray(gp[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{impl} {k}")


# --------------------------------------------------------------------------
# forward_train: loss, accuracy and every gradient
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_forward_train_loss_and_grads_match_jax_grad(name):
    cfg, tcfg, jparams = _model(name)
    toks = _tokens(2, cfg.vocab_size)

    def loss_fn(p):
        return jax_forward_train(p, cfg, {"tokens": jnp.asarray(toks)},
                                 remat="none")

    (jloss, jmet), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jparams)
    loss, metrics, grads = loss_and_grads(
        _to_torch(jparams, tcfg), tcfg, {"tokens": torch.from_numpy(toks)},
        remat="none")
    assert abs(float(loss) - float(jloss)) <= 1e-5
    for k in ("loss", "accuracy", "moe_aux"):
        assert abs(float(metrics[k]) - float(jmet[k])) <= 1e-5, k
    _assert_leaves_close(grads, _to_torch(jgrads, tcfg), 1e-4)


def test_forward_train_remat_and_loss_dtype_keep_the_values():
    """``remat="full"`` (per-layer checkpoint) and ``"dots"`` give the
    loss and gradients of ``"none"``; the bf16 loss mode gives the f32
    loss (the logits are already float32); unknown modes raise."""
    cfg, tcfg, jparams = _model("phi3.5-moe-42b")
    batch = {"tokens": torch.from_numpy(_tokens(3, cfg.vocab_size))}
    params = _to_torch(jparams, tcfg)
    base = loss_and_grads(params, tcfg, batch, remat="none")
    for remat in ("full", "dots"):
        got = loss_and_grads(params, tcfg, batch, remat=remat)
        assert abs(float(got[0]) - float(base[0])) <= 1e-6
        _assert_leaves_close(got[2], base[2], 1e-6)
    try:
        set_loss_dtype("bf16")
        loss, _ = forward_train(params, tcfg, batch, remat="none")
    finally:
        set_loss_dtype("f32")
    assert abs(float(loss) - float(base[0])) <= 1e-5
    with pytest.raises(ValueError):
        forward_train(params, tcfg, batch, remat="some")
    with pytest.raises(ValueError):
        set_loss_dtype("f16")
    # An enc-dec model on a mesh: the (1, 2) loss under remat="full" is
    # the meshless one under "none".
    wtcfg = torch_smoke_config("whisper-base")
    wparams = _to_torch(_model("whisper-base")[2], wtcfg)
    wbatch = {k: torch.from_numpy(v)
              for k, v in SyntheticLM(wtcfg, 2, S).batch(0).items()}
    mesh = virtual_mesh((1, 2), "cpu")
    want, _ = forward_train(wparams, wtcfg, wbatch, remat="none")
    got, _ = forward_train(place_train(wparams, wtcfg, mesh), wtcfg, wbatch,
                           mesh=mesh, remat="full")
    assert abs(float(got) - float(want)) <= 1e-5


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": [rng.standard_normal((3,)).astype(np.float32),
                  rng.standard_normal((4, 2)).astype(np.float32)],
            "c": rng.standard_normal((6, 8)).astype(np.float32)}


def _bf16_leaf(tree):
    """Leaf ``c`` in bfloat16 for both packages (rounded once in numpy's
    ml_dtypes, whose bits torch reads back)."""
    out = dict(tree)
    out["c"] = np.asarray(jnp.asarray(tree["c"], jnp.bfloat16))
    return out


def _torch_tree(tree):
    def conv(x):
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return tree_map(conv, tree)


def test_cosine_lr_matches_reference():
    cfg = adamw.AdamWConfig(warmup_steps=10, total_steps=50)
    jcfg = jax_adamw.AdamWConfig(warmup_steps=10, total_steps=50)
    for step in (0, 1, 5, 10, 11, 30, 50, 80):
        got = float(adamw.cosine_lr(cfg, torch.tensor(step,
                                                      dtype=torch.int32)))
        want = float(jax_adamw.cosine_lr(jcfg, jnp.int32(step)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), step


@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_apply_updates_matches_reference(clip):
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            grad_clip_norm=clip)
    jcfg = jax_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                                 grad_clip_norm=clip)
    params = _bf16_leaf(_random_tree(0))
    tparams = _torch_tree(params)
    jparams = jax.tree.map(jnp.asarray, params)
    state, jstate = adamw.init_state(tparams), jax_adamw.init_state(jparams)
    for step in range(3):
        grads = _bf16_leaf(_random_tree(10 + step))
        tgrads = _torch_tree(grads)
        norm = float(adamw.global_norm(tgrads))
        jnorm = float(jax_adamw.global_norm(jax.tree.map(jnp.asarray,
                                                         grads)))
        assert abs(norm - jnorm) <= 1e-6 * jnorm
        tparams, state, met = adamw.apply_updates(tparams, tgrads, state,
                                                  cfg)
        jparams, jstate, jmet = jax_adamw.apply_updates(
            jparams, jax.tree.map(jnp.asarray, grads), jstate, jcfg)
        assert int(state.step) == int(jstate.step) == step + 1
        assert abs(float(met["lr"]) - float(jmet["lr"])) <= 1e-9
        for got, want in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
            bf16 = got.dtype == torch.bfloat16
            got = got.float().numpy()
            want = np.asarray(want.astype(jnp.float32))
            if bf16:        # one f32 value rounded once: within one ulp
                ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
                assert (np.abs(got - want) <= ulp).all()
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        for t, j in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
            for got, want in zip(tree_leaves(t), jax.tree.leaves(j)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-6)
    clipped, n = adamw.clip_by_global_norm(tgrads, clip)
    assert all(c.dtype == torch.float32 for c in tree_leaves(clipped))
    assert float(adamw.global_norm(clipped)) <= min(clip, float(n)) * (
        1 + 1e-6)


# --------------------------------------------------------------------------
# Train step
# --------------------------------------------------------------------------
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _batches(cfg, n, b=4, s=16):
    data = JaxSyntheticLM(cfg, b, s, JaxDataConfig(seed=7))
    return [data.batch(i) for i in range(n)]


@pytest.mark.parametrize("name,accum", [("qwen2.5-0.5b", 1),
                                        ("qwen2.5-0.5b", 2),
                                        ("phi3.5-moe-42b", 1),
                                        ("phi3.5-moe-42b", 2)])
def test_train_step_params_after_3_steps_match_reference(name, accum):
    cfg, tcfg, jparams = _model(name)
    batches = _batches(cfg, 3)
    jstep = jax.jit(jax_make_train_step(
        cfg, opt_cfg=jax_adamw.AdamWConfig(**OPT), accum_steps=accum,
        remat="none"))
    jstate = jax_adamw.init_state(jparams)
    jp = jparams
    for bt in batches:
        jp, jstate, jmet = jstep(jp, jstate, {"tokens": jnp.asarray(
            bt["tokens"])})

    runs = {}
    for remat in ("none", "full"):
        step = make_train_step(tcfg, opt_cfg=adamw.AdamWConfig(**OPT),
                               accum_steps=accum, remat=remat)
        tp = _to_torch(jparams, tcfg)
        state = adamw.init_state(tp)
        for bt in batches:
            tp, state, met = step(tp, state,
                                  {"tokens": torch.from_numpy(bt["tokens"])})
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-4
        runs[remat] = tp
    _assert_params_close(runs["none"], _to_torch(jp, tcfg))
    _assert_params_close(runs["full"], runs["none"])


def test_train_step_options():
    """bf16 gradient compression matches the reference's, and on a mesh
    (whisper-base on (1, 2)) the meshless step's; ``shard_grads``
    without a mesh changes nothing, as in the reference; other expert
    backends and compressions raise."""
    cfg, tcfg, jparams = _model("qwen2.5-0.5b")
    bt = _batches(cfg, 1)[0]
    jstep = jax.jit(jax_make_train_step(
        cfg, opt_cfg=jax_adamw.AdamWConfig(**OPT), remat="none",
        grad_compression="bf16"))
    jp, _, _ = jstep(jparams, jax_adamw.init_state(jparams),
                     {"tokens": jnp.asarray(bt["tokens"])})
    step = make_train_step(tcfg, opt_cfg=adamw.AdamWConfig(**OPT),
                           remat="none", grad_compression="bf16")
    tp = _to_torch(jparams, tcfg)
    tp, _, _ = step(tp, adamw.init_state(tp),
                    {"tokens": torch.from_numpy(bt["tokens"])})
    _assert_params_close(tp, _to_torch(jp, tcfg))
    sp = _to_torch(jparams, tcfg)
    sp, _, _ = make_train_step(
        tcfg, opt_cfg=adamw.AdamWConfig(**OPT), remat="none",
        grad_compression="bf16", shard_grads=True)(
        sp, adamw.init_state(sp), {"tokens": torch.from_numpy(bt["tokens"])})
    for a, b in zip(tree_leaves(sp), tree_leaves(tp), strict=True):
        assert torch.equal(a, b)
    wtcfg = torch_smoke_config("whisper-base")
    wjp = _model("whisper-base")[2]
    wbatch = {k: torch.from_numpy(v)
              for k, v in SyntheticLM(wtcfg, 4, S).batch(0).items()}
    wopts = dict(opt_cfg=adamw.AdamWConfig(**OPT), remat="none",
                 grad_compression="bf16")
    wp = _to_torch(wjp, wtcfg)
    wp, _, _ = make_train_step(wtcfg, **wopts)(wp, adamw.init_state(wp),
                                                wbatch)
    mesh = virtual_mesh((1, 2), "cpu")
    placed = place_train(_to_torch(wjp, wtcfg), wtcfg, mesh)
    placed, _, _ = make_train_step(wtcfg, mesh, **wopts)(
        placed, init_opt_state(placed), wbatch)
    _assert_params_close(unshard_tree(placed.shards, placed.specs, mesh), wp)
    with pytest.raises(ValueError):
        make_train_step(tcfg, expert_backend="xla")
    with pytest.raises(ValueError):
        make_train_step(tcfg, grad_compression="int8")


# --------------------------------------------------------------------------
# Data, checkpoints, the Trainer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen2.5-0.5b", "whisper-base",
                                  "internvl2-76b"])
def test_synthetic_lm_batches_are_the_references(name):
    cfg, tcfg = smoke_config(name), torch_smoke_config(name)
    for host_index, host_count in ((0, 1), (1, 2)):
        ref = JaxSyntheticLM(cfg, 4, 40, JaxDataConfig(seed=3),
                             host_index=host_index, host_count=host_count)
        got = SyntheticLM(tcfg, 4, 40, DataConfig(seed=3),
                          host_index=host_index, host_count=host_count)
        for step in (0, 1, 17):
            a, b = got.batch(step), ref.batch(step)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_round_trip_bf16_and_gc(tmp_path):
    rng = np.random.default_rng(0)
    tree = ({"w": torch.from_numpy(rng.standard_normal((5, 3)).astype(
                np.float32)).bfloat16(),
             "layers": [{"b": torch.arange(4, dtype=torch.float32)}]},
            adamw.init_state({"x": torch.ones(2)}))
    for step in (1, 2, 3, 4):
        path = ckpt.save_step(str(tmp_path), step, tree, extra={"k": 1})
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_2", "step_3", "step_4"]
    assert ckpt.latest_step_dir(str(tmp_path)) == path
    assert not any(p.name.startswith(".tmp")
                   for p in (tmp_path / "step_4").iterdir())
    like = tree_map(torch.zeros_like, tree)
    step, back = ckpt.restore(path, like)
    assert step == 4
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(back[1], adamw.AdamWState)
    with pytest.raises(ValueError):
        ckpt.restore(path, ({"w": torch.zeros(5, 4, dtype=torch.bfloat16),
                             "layers": [{"b": torch.zeros(4)}]}, back[1]))
    assert ckpt.latest_step_dir(str(tmp_path / "missing")) is None


def _trainer(tmp_path, steps, arch="yi-6b", **kw):
    tcfg = TrainerConfig(steps=steps, global_batch=4, seq_len=32,
                         ckpt_every=5, ckpt_dir=str(tmp_path), log_every=100,
                         **kw)
    return Trainer(torch_smoke_config(arch), tcfg, device="cpu")


def test_trainer_loss_decreases(tmp_path):
    out = _trainer(tmp_path, 30).run()
    assert out["final_loss"] < out["first_loss"], out["history"]


def test_trainer_restart_resumes_from_checkpoint(tmp_path):
    first = _trainer(tmp_path, 10).run()          # writes step_10
    second = _trainer(tmp_path, 12)
    start, params, state = second.init_or_restore()
    assert start == 10 and int(state.step) == 10
    for a, b in zip(tree_leaves(params), tree_leaves(first["params"])):
        assert torch.equal(a, b)
    out = second.run()                           # resumes at 10, 2 steps
    assert [h["step"] for h in out["history"]] == [10, 11]


def test_moe_trainer_trains_with_given_params(tmp_path):
    tcfg = torch_smoke_config("phi3.5-moe-42b")
    from repro_torch.models import init_params
    params = init_params(tcfg, seed=5, device="cpu")
    first = tree_leaves(params)[0].clone()
    out = Trainer(tcfg, TrainerConfig(steps=8, global_batch=4, seq_len=32,
                                      log_every=100),
                  params=params, device="cpu").run()
    assert np.isfinite(out["final_loss"])
    assert out["params"] is params
    assert not torch.equal(tree_leaves(params)[0], first)


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(torch_smoke_config("yi-6b"), TrainerConfig(steps=1))
