"""Elastic restart of sharded training and gradient compression, against
the JAX package's (``tests/test_distributed.py``'s
``test_elastic_restart_subprocess`` and ``test_error_feedback_reduces_
bias``), on CPU meshes (``virtual_mesh(shape, "cpu")``).

* Train yi-6b smoke 3 steps on (4, 2), checkpoint, lose 4 devices,
  restore resharded onto the planned (2, 2) mesh and take a step: the
  checkpoint holds whole leaves, the restore places them by the new
  mesh's specs, and the step equals the same step run without a mesh
  from the checkpoint (loss, ``grad_norm`` and every parameter within
  1e-5; dense: the meshless step with accumulation 2).
* The same through ``Trainer(mesh=)``: a run on (4, 2) that checkpoints
  and one on (2, 2) that restores and goes on give the losses of an
  uninterrupted meshless run within 1e-5.
* ``compress_grads`` equals the reference's, bf16 and int8 with error
  feedback, within 1e-7; error feedback reduces the int8 bias.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro_torch.checkpoint import ckpt
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.distributed import (compress_grads, init_error_state,
                                     init_opt_state, Mesh,
                                     opt_state_specs, param_specs,
                                     place_train, plan_elastic_mesh,
                                     simulate_failure, unshard_tree,
                                     virtual_mesh)
from repro_torch.models import init_params
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train import make_train_step, Trainer, TrainerConfig

from _torch_sharded_train import (assert_replicas_equal,
                                  one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
TOL = 1e-5


def _batch(data, step):
    return {k: torch.from_numpy(v) for k, v in data.batch(step).items()}


def test_elastic_restart_reshards_and_continues(tmp_path):
    cfg = smoke_config("yi-6b")
    mesh = virtual_mesh((4, 2), "cpu")
    params = place_train(init_params(cfg, 0, device="cpu"), cfg, mesh)
    opt = init_opt_state(params)
    data = SyntheticLM(cfg, 8, 32)
    step_fn = make_train_step(cfg, mesh, remat="none")
    for s in range(3):
        params, opt, m = step_fn(params, opt, _batch(data, s))
    assert np.isfinite(float(m["loss"]))
    path = str(tmp_path / "step_3")
    ckpt.save(path, 3, (params, opt))

    healthy = simulate_failure(list(mesh.devices.flat), 4)
    plan = plan_elastic_mesh(len(healthy), model_parallel=2)
    assert plan == (2, 2), plan
    mesh2 = Mesh(np.asarray(healthy[:4], dtype=object).reshape(plan))
    like = (params, opt)
    pspecs = param_specs(init_params(cfg, 0, device="cpu"), cfg, mesh2)
    step0, (params2, opt2) = ckpt.restore(
        path, like, mesh=mesh2, specs=(pspecs, opt_state_specs(pspecs)))
    assert step0 == 3 and int(opt2.step) == 3
    assert params2.mesh is mesh2 and params2.shards.shape == (2, 2)
    assert_replicas_equal(params2)
    params2, opt2, m2 = make_train_step(cfg, mesh2, remat="none")(
        params2, opt2, _batch(data, 3))
    assert np.isfinite(float(m2["loss"]))
    assert_replicas_equal(params2)

    # the same step without a mesh, from the gathered checkpoint
    _, (whole, wopt) = ckpt.restore(path, like)
    whole, wopt, wm = make_train_step(cfg, accum_steps=2, remat="none")(
        whole, wopt, _batch(data, 3))
    for k in ("loss", "grad_norm"):
        assert abs(float(m2[k]) - float(wm[k])) <= TOL, k
    got = unshard_tree(params2.shards, params2.specs, mesh2)
    for a, b in zip(tree_leaves(got), tree_leaves(whole), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_trainer_restarts_on_a_smaller_mesh(tmp_path):
    cfg = smoke_config("yi-6b")

    def tcfg(steps, ckpt_dir=None):
        return TrainerConfig(steps=steps, global_batch=8, seq_len=32,
                             ckpt_every=3, ckpt_dir=ckpt_dir, log_every=100)

    ref = Trainer(cfg, tcfg(5), device="cpu").run()
    first = Trainer(cfg, tcfg(3, str(tmp_path)),
                    mesh=virtual_mesh((4, 2), "cpu")).run()
    assert ckpt.latest_step_dir(str(tmp_path)).endswith("step_3")
    second = Trainer(cfg, tcfg(5, str(tmp_path)),
                     mesh=virtual_mesh((2, 2), "cpu"))
    start, params, opt = second.init_or_restore()
    assert start == 3 and params.shards.shape == (2, 2)
    out = second.run()
    assert [h["step"] for h in out["history"]] == [3, 4]
    losses = [h["loss"] for h in first["history"] + out["history"]]
    np.testing.assert_allclose(losses, [h["loss"] for h in ref["history"]],
                               rtol=TOL, atol=TOL)
    got = unshard_tree(out["params"].shards, out["params"].specs,
                       out["params"].mesh)
    for a, b in zip(tree_leaves(got), tree_leaves(ref["params"]),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(64, 8)) * 1e-3).astype(np.float32),
            "b": [(rng.normal(size=(16,)) * 3.0).astype(np.float32)]}


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_compress_grads_equals_reference(kind):
    """Three rounds of error feedback: compressed gradients and the
    residual equal the reference's."""
    err, jerr = None, None
    for seed in range(3):
        g = _grad_tree(seed)
        comp, err = compress_grads(tree_map(torch.from_numpy, g), err, kind)
        jcomp_g, jerr = jcomp.compress_grads(jax.tree.map(jnp.asarray, g),
                                             jerr, kind)
        for got, want in ((comp, jcomp_g), (err, jerr)):
            for a, b in ((got["w"], want["w"]), (got["b"][0], want["b"][0])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-7, atol=1e-7)
    zeros = init_error_state({"w": torch.ones(3, 2)})
    assert zeros["w"].dtype == torch.float32 and not zeros["w"].any()
    with pytest.raises(ValueError):
        compress_grads({"w": torch.ones(2)}, None, "fp8")


def test_error_feedback_reduces_bias():
    g = {"w": torch.from_numpy(
        (np.random.default_rng(0).normal(size=(256,)) * 1e-3).astype(
            np.float32))}
    err, total = None, torch.zeros_like(g["w"])
    for _ in range(64):
        c, err = compress_grads(g, err, "int8")
        total = total + c["w"]
    bias = (total / 64 - g["w"]).abs().mean()
    c1, _ = compress_grads(g, None, "int8")
    assert float(bias) < float((c1["w"] - g["w"]).abs().mean()) * 0.5
