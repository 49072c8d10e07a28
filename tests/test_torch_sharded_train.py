"""Sharded training of the port (``make_train_step(cfg, mesh)``) on CPU
meshes (``virtual_mesh(shape, "cpu")``) against the JAX package's
meshless train step, on ``smoke_config("yi-6b")``, whose 4/2 heads
split at model 2 and not at 4.

Both packages start from the reference's seeded weights (through
``params_from_jax``) and take two steps on ``SyntheticLM(cfg, 8,
32)``'s batches 0 and 1.  A (D, M) step with ``accum_steps=A`` computes
what the meshless step with ``A * D`` computes (the reference's sharded
step does too: loss 6.655305, ``grad_norm`` 1.713068 on (2, 2), (4, 2)
and (2, 1)).  Compared after each step: the loss and ``grad_norm``
within 1e-5; after two steps every parameter within 1e-5, absolute and
relative (f32 sums in another order); every copy of a part that several
devices hold bitwise equal to the others.  Also here: the training
specs (``param_specs(fsdp=True)``, ``opt_state_specs``, ``batch_specs``)
against the reference's, placement bytes, and an enc-dec model
(whisper-base) taken by ``make_train_step`` and a ``Trainer`` on a
mesh.
"""
import math

import jax
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.distributed import sharding as jsh
from repro.models import init_params as jax_init
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.configs.base import BIDIR
from repro_torch.convert import _unstack_layers
from repro_torch.distributed import (batch_specs, init_opt_state,
                                     opt_state_specs,
                                     param_specs, place_train, unshard_tree,
                                     virtual_mesh)
from repro_torch.models import init_params
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import make_train_step, Trainer, TrainerConfig

from _torch_sharded_train import (assert_matches, CASES, case_id, init_torch,
                                  jax_run, one_thread, port_run,  # noqa: F401
                                  VARIANTS)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_dense_sharded_step_matches_meshless_reference(case):
    """yi-6b smoke: a (D, M) step with ``accum_steps=A`` equals the
    reference's meshless step with ``A * D`` (every variant's options
    leave the values as they are, compression aside)."""
    shape, variant = case
    accum, shard_grads, compression, remat = VARIANTS[variant]
    got = port_run("yi-6b", shape, accum, shard_grads, compression, remat)
    want = jax_run("yi-6b", accum * shape[0], compression)
    assert_matches(got, want, torch_smoke_config("yi-6b"))


def test_dense_step_oracle_values():
    """The reference's first step, as measured with its own sharded step
    (loss 6.655305, grad_norm 1.713068), and the port's on (2, 2)."""
    losses, norms, _ = jax_run("yi-6b", 2, None)
    assert abs(losses[0] - 6.655305) < 1e-5
    assert abs(norms[0] - 1.713068) < 1e-5
    got = port_run("yi-6b", (2, 2), 1, True, None, "none")
    assert abs(got[0][0] - 6.655305) < 1e-5


# --------------------------------------------------------------------------
# Specs and placement
# --------------------------------------------------------------------------
SPEC_MESHES = ((1, 2), (2, 1), (2, 2), (1, 4), (4, 2))


class _FakeMesh:
    """Duck-typed mesh: the rules read only ``.shape`` and
    ``.axis_names``."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))
        self.axis_names = ("data", "model")


def _spec_pairs(jtree, ttree, cfg):
    """(reference spec minus its stacked dimension where stacked, port
    spec) for every parameter leaf, the port's layers matched to the
    reference's scanned groups."""
    out = []

    def flat(j, t, stacked):
        if isinstance(j, dict):
            assert set(j) == set(t)
            for k in j:
                flat(j[k], t[k], stacked)
        else:
            out.append((tuple(j)[1:] if stacked else tuple(j), tuple(t)))

    for key, jv in jtree.items():
        if key == "groups":
            layers = _unstack_layers(jv, cfg)
            assert len(layers) == len(ttree["layers"])
            for (group, b, _r), tl in zip(layers, ttree["layers"]):
                flat(group[b], tl, True)
        elif key == "encoder":
            layers = _unstack_layers(jv["groups"], cfg,
                                     [((BIDIR,), cfg.n_enc_layers)])
            for (group, b, _r), tl in zip(layers, ttree["encoder"]["layers"]):
                flat(group[b], tl, True)
            flat(jv["final_norm"], ttree["encoder"]["final_norm"], False)
        else:
            flat(jv, ttree[key], False)
    return out


@pytest.mark.parametrize("name", tuple(all_configs()))
def test_training_specs_equal_reference(name):
    """``param_specs(fsdp=True)`` leaf for leaf, ``opt_state_specs`` and
    ``batch_specs`` equal the reference's at every mesh of the slice."""
    cfg, tcfg = smoke_config(name), torch_smoke_config(name)
    shapes = jax.eval_shape(lambda: jax_init(cfg, jax.random.PRNGKey(0)))
    tparams = init_params(tcfg, 0, device="cpu")
    for shape in SPEC_MESHES:
        mesh = _FakeMesh(shape)
        jspecs = jsh.param_specs(shapes, cfg, mesh, fsdp=True)
        tspecs = param_specs(tparams, tcfg, mesh, fsdp=True)
        pairs = _spec_pairs(jspecs, tspecs, tcfg)
        assert pairs
        for want, got in pairs:
            assert got == want, (shape, want, got)
        jopt = jsh.opt_state_specs(jspecs, None)
        topt = opt_state_specs(tspecs)
        assert tuple(topt.step) == tuple(jopt.step) == ()
        for jt, tt in ((jopt.mu, topt.mu), (jopt.nu, topt.nu)):
            assert [w for w, _ in _spec_pairs(jt, tt, tcfg)] == \
                [w for w, _ in pairs]
            assert tt is tspecs
        jb, tb = jsh.batch_specs("train", mesh, cfg), batch_specs(
            "train", mesh, tcfg)
        assert set(jb) == set(tb)
        for k in jb:
            assert tuple(tb[k]) == tuple(jb[k]), (k, shape)


@pytest.mark.parametrize("shape", SPEC_MESHES, ids=lambda s: "%dx%d" % s)
def test_place_train_bytes_and_join(shape):
    """Each device holds its (data, model) parts; over the first holder
    of each part the bytes sum to the whole tree's, and the shards join
    back bit for bit."""
    tcfg = torch_smoke_config("phi3.5-moe-42b")
    params = init_torch("phi3.5-moe-42b")
    mesh = virtual_mesh(shape, "cpu")
    placed = place_train(params, tcfg, mesh)
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    assert sum(placed.nbytes(unique=True).values()) == whole
    per = placed.nbytes()
    assert max(per.values()) < whole or shape == (1, 1)
    for a, b in zip(tree_leaves(unshard_tree(placed.shards, placed.specs,
                                             mesh)),
                    tree_leaves(params), strict=True):
        assert torch.equal(a, b)
    opt = init_opt_state(placed)
    assert sum(opt.mu.nbytes(unique=True).values()) == sum(
        t.numel() * 4 for t in tree_leaves(params))


def test_item_2c_still_raises_on_a_mesh():
    """Enc-dec models, once refused on a mesh, train there: a
    ``Trainer`` on (1, 2) takes whisper-base's batches (its features
    through the encoder) for two steps of finite loss (the steps
    against the reference's:
    ``tests/test_torch_sharded_enc_dec_train.py``)."""
    mesh = virtual_mesh((1, 2), "cpu")
    tcfg = torch_smoke_config("whisper-base")
    assert callable(make_train_step(tcfg, mesh))
    out = Trainer(tcfg, TrainerConfig(steps=2, global_batch=4, seq_len=16,
                                      log_every=100), mesh=mesh).run()
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


def test_remat_gathers_each_layer_again_in_the_backward(monkeypatch):
    """Under ``remat="full"`` a layer's FSDP gather runs inside its
    checkpoint, so the backward gathers the layer's shards again (and no
    layer's gathered weights are kept from the forward); under
    ``"none"`` each gather runs once.  Counted at ``all_gather``, yi-6b
    smoke on (2, 2)."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import gather_fsdp
    from repro_torch.train import loss_and_grads

    tcfg = torch_smoke_config("yi-6b")
    mesh = virtual_mesh((2, 2), "cpu")
    placed = place_train(init_torch("yi-6b"), tcfg, mesh)
    batch = {"tokens": torch.randint(0, tcfg.vocab_size, (4, 16))}
    calls = []
    gather = sharding.all_gather

    def spy(parts, dim):
        calls.append(dim)
        return gather(parts, dim)

    monkeypatch.setattr(sharding, "all_gather", spy)
    gather_fsdp(placed, lambda t: t["layers"])
    per_layers = len(calls)
    counts = {}
    for remat in ("none", "full"):
        calls.clear()
        loss_and_grads(placed, tcfg, batch, remat=remat, mesh=mesh)
        counts[remat] = len(calls)
    assert per_layers > 0
    assert counts["full"] == counts["none"] + per_layers
