"""The port's MoE layer (repro_torch.models.moe) against the JAX MoE on the
CPU.

Both get the reference's seeded expert weights (``repro.models.moe.
moe_init``, handed over as numpy) and the same seeded numpy activations,
in float32 on the MoE smoke configs.  The port always takes the flat
dispatch through K4's plain version; the reference runs once with its
default dense ``"xla"`` experts and once with the flat Pallas kernel in
interpret mode.  The reference's expert switch is process-wide, so the
test restores ``"xla"`` in ``finally``.  Outputs agree within 1e-5 with
and without a ``valid`` mask, and with a capacity factor small enough
that pairs are dropped.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import moe as jax_moe
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.models import moe

TOL = 1e-5
ARCHS = ["phi3.5-moe-42b", "dbrx-132b"]
B, S = 2, 12
LAST = [7, 11]                  # each row's last real token (bucketed prefill)


def _with_factor(cfg, factor):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def _setup(name, factor=None):
    cfg, tcfg = smoke_config(name), torch_smoke_config(name)
    if factor is not None:
        cfg, tcfg = _with_factor(cfg, factor), _with_factor(tcfg, factor)
    jp = jax_moe.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    valid = np.arange(S)[None, :] <= np.asarray(LAST)[:, None]
    return cfg, tcfg, jp, tp, x, valid


def _jax_moe(jp, x, cfg, valid, impl):
    try:
        jax_moe.set_expert_backend(impl)
        y, aux = jax_moe.moe_apply(
            jp, jnp.asarray(x), cfg,
            valid=None if valid is None else jnp.asarray(valid))
        return np.asarray(y), float(aux)
    finally:
        jax_moe.set_expert_backend("xla")


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_matches_both_jax_expert_paths(name, masked):
    cfg, tcfg, jp, tp, x, valid = _setup(name)
    v = valid if masked else None
    y, aux = moe.moe_apply(tp, torch.from_numpy(x), tcfg,
                           valid=None if v is None else torch.from_numpy(v))
    assert y.shape == x.shape and y.dtype == torch.float32
    for impl in ("xla", "pallas_interpret"):
        jy, jaux = _jax_moe(jp, x, cfg, v, impl)
        np.testing.assert_allclose(y.numpy(), jy, rtol=TOL, atol=TOL)
        assert abs(float(aux) - jaux) <= TOL
    if masked:
        # Pads hold their own hidden states; real tokens route exactly as
        # an exact-length call would.
        exact, _ = moe.moe_apply(tp, torch.from_numpy(x[:1, :LAST[0] + 1]),
                                 tcfg)
        np.testing.assert_allclose(y[:1, :LAST[0] + 1].numpy(),
                                   exact.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
def test_moe_apply_drops_pairs_past_capacity_like_the_reference(masked):
    """capacity_factor 0.5: some expert is routed more pairs than its
    capacity, so pairs are dropped, and the port drops the same ones."""
    cfg, tcfg, jp, tp, x, valid = _setup(ARCHS[0], factor=0.5)
    v = valid if masked else None
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ tp["router"], dim=-1)
    topi = torch.topk(probs, cfg.moe.top_k, dim=-1).indices
    if masked:
        topi = topi[torch.from_numpy(valid).reshape(-1)]
    counts = torch.bincount(topi.reshape(-1), minlength=cfg.moe.n_experts)
    cap = moe._capacity(topi.shape[0], cfg.moe.n_experts, cfg.moe.top_k, 0.5)
    assert counts.max() > cap, (counts, cap)          # pairs are dropped
    y, _ = moe.moe_apply(tp, torch.from_numpy(x), tcfg,
                         valid=None if v is None else torch.from_numpy(v))
    full, _ = moe.moe_apply(tp, torch.from_numpy(x),
                            _with_factor(tcfg, 4.0),
                            valid=None if v is None else torch.from_numpy(v))
    assert not torch.allclose(y, full)                # dropping changed y
    for impl in ("xla", "pallas_interpret"):
        jy, _ = _jax_moe(jp, x, cfg, v, impl)
        np.testing.assert_allclose(y.numpy(), jy, rtol=TOL, atol=TOL)


def test_moe_init_keeps_a_float32_router():
    tcfg = torch_smoke_config(ARCHS[0])
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, tcfg, torch.bfloat16)
    e, d, ff = tcfg.moe.n_experts, tcfg.d_model, tcfg.d_ff
    assert p["router"].dtype == torch.float32 and p["router"].shape == (d, e)
    assert p["up"].shape == p["gate"].shape == (e, d, ff)
    assert p["down"].shape == (e, ff, d)
    assert all(p[k].dtype == torch.bfloat16 for k in ("up", "gate", "down"))
    assert not torch.equal(p["up"][0], p["up"][1])     # one draw per expert


def test_moe_mesh_and_unknown_expert_backends_raise():
    """A mesh now runs expert parallelism (tests/test_torch_sharded_ops.py
    holds it to the reference): on a (1, 2) CPU mesh it gives the
    meshless output, and an EP impl the reference does not have raises,
    as does every expert backend but ``"kernel"``."""
    from repro_torch.distributed import place_params, virtual_mesh
    cfg, tcfg, _, tp, x, _ = _setup(ARCHS[0])
    mesh = virtual_mesh((1, 2), "cpu")
    ranks = [t["layers"][0]["moe"] for t in place_params(
        {"layers": [{"moe": tp}]}, tcfg, mesh).local]
    got, _ = moe.moe_apply(ranks, torch.from_numpy(x), tcfg, mesh=mesh)
    want, _ = moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        moe.set_ep_impl("ring")
    moe.set_expert_backend("kernel")
    for impl in ("xla", "pallas", "pallas_interpret", "plain"):
        with pytest.raises(ValueError):
            moe.set_expert_backend(impl)


def test_params_from_jax_carries_experts_and_the_float32_router():
    """bf16 params: the stacked (E, d, f) expert leaves cross unstacked
    per layer, and the router stays float32 as the reference keeps it."""
    from repro.models import init_params as jax_init
    from repro_torch.convert import params_from_jax

    name = ARCHS[0]
    cfg = dataclasses.replace(smoke_config(name), param_dtype="bfloat16")
    tcfg = dataclasses.replace(torch_smoke_config(name),
                               param_dtype="bfloat16")
    jparams = jax_init(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    assert len(tparams["layers"]) == cfg.n_layers
    jmoe = jparams["groups"][0]["b0"]["moe"]
    for r, layer in enumerate(tparams["layers"]):
        assert "mlp" not in layer
        p = layer["moe"]
        assert p["router"].dtype == torch.float32
        for key in ("router", "up", "gate", "down"):
            want = np.asarray(jmoe[key][r].astype(jnp.float32))
            assert p[key].shape == want.shape
            np.testing.assert_array_equal(p[key].float().numpy(), want)
        assert p["up"].dtype == torch.bfloat16
