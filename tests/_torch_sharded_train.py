"""Shared pieces of the sharded-training tests: the reference's meshless
jitted step (cached per accumulation and compression) and the port's
sharded step on ``virtual_mesh(shape, "cpu")``, both from the
reference's seeded weights over ``SyntheticLM(cfg, 8, 32)``'s first
batches, and the comparisons (1e-5 in f32; replicas bitwise)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import init_params as jax_init
from repro.optim import adamw as jax_adamw
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import (init_opt_state, place_train,
                                     unshard_tree, virtual_mesh)
from repro_torch.distributed.sharding import _leaves, replica_groups
from repro_torch.models import moe
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import make_train_step

from _torch_threads import one_thread  # noqa: F401  (re-exported)

TOL = 1e-5
STEPS = 2
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
# (accum_steps, shard_grads, grad_compression, remat); ``shard_grads`` is
# passed both ways though it selects nothing (the reference's keyword).
VARIANTS = {"a1": (1, True, None, "none"),
            "a2-tp-full": (2, False, None, "full"),
            "bf16": (1, False, "bf16", "none")}
# Every mesh under the first two variants; bf16 compression (the same
# cast on every layout) on the meshes without a data axis, which keeps
# the reference's jitted oracles to four an architecture.
CASES = [(shape, v) for shape in MESHES for v in ("a1", "a2-tp-full")] + [
    (shape, "bf16") for shape in MESHES if shape[0] == 1]


def case_id(case):
    return "%dx%d-%s" % (*case[0], case[1])


def _batches(cfg):
    data = JaxSyntheticLM(cfg, 8, 32)
    return [data.batch(s) for s in range(STEPS)]


@functools.lru_cache(maxsize=None)
def jax_run(name, accum, compression):
    """The reference's meshless jitted step: (losses, grad norms, numpy
    params after STEPS steps)."""
    cfg = smoke_config(name)
    params = jax_init(cfg, jax.random.PRNGKey(0))
    opt = jax_adamw.init_state(params)
    step = jax.jit(jax_make_train_step(cfg, accum_steps=accum, remat="none",
                                       grad_compression=compression))
    losses, norms = [], []
    for b in _batches(cfg):
        params, opt, m = step(params, opt, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, params)


def init_torch(name):
    cfg = smoke_config(name)
    return params_from_jax(jax.tree.map(np.asarray, jax_init(
        cfg, jax.random.PRNGKey(0))), torch_smoke_config(name),
        device="cpu")


def assert_replicas_equal(placed):
    """Every device's copy of a part equal, bit for bit, to the first
    holder's."""
    for li, spec in enumerate(_leaves(placed.specs)):
        for group in replica_groups(spec, placed.mesh):
            first = tree_leaves(placed.shards[group[0]])[li]
            for c in group[1:]:
                assert torch.equal(tree_leaves(placed.shards[c])[li],
                                   first), (li, spec, c)


def port_run(name, shape, accum, shard_grads, compression, remat,
             impl="psum"):
    """The port's sharded step on ``virtual_mesh(shape, "cpu")``: (losses,
    grad norms, whole params after STEPS steps)."""
    tcfg = torch_smoke_config(name)
    mesh = virtual_mesh(shape, "cpu")
    params = place_train(init_torch(name), tcfg, mesh)
    opt = init_opt_state(params)
    step = make_train_step(tcfg, mesh, accum_steps=accum, remat=remat,
                           shard_grads=shard_grads,
                           grad_compression=compression)
    losses, norms = [], []
    try:
        moe.set_ep_impl(impl)
        for b in _batches(smoke_config(name)):
            params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                                for k, v in b.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            assert_replicas_equal(params)
            assert_replicas_equal(opt.mu)
            assert_replicas_equal(opt.nu)
    finally:
        moe.set_ep_impl("psum")
    assert int(opt.step) == STEPS
    return losses, norms, unshard_tree(params.shards, params.specs, mesh)


def assert_matches(got, want, tcfg):
    losses, norms, params = got
    wl, wn, wp = want
    np.testing.assert_allclose(losses, wl, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(norms, wn, rtol=TOL, atol=TOL)
    ref = params_from_jax(wp, tcfg, device="cpu")
    for g, r in zip(tree_leaves(params), tree_leaves(ref), strict=True):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=TOL, atol=TOL)
