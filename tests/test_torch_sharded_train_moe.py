"""Sharded training of a MoE model (``smoke_config("phi3.5-moe-42b")``,
4 experts, top-2) on CPU meshes against the JAX package's meshless
train step, under ``"psum"`` expert parallelism.

Routing depends on the split, as in the reference: where the model axis
splits the experts ((1, 2), (2, 2), (1, 4)) each data replica routes its
own rows with its own capacity, so a (D, M) step with ``accum_steps=A``
equals the meshless step with ``A * D`` (the reference's sharded step:
6.642024 on (2, 2)); where the model axis is 1 ((2, 1)) the layer runs
on the whole global batch and equals the meshless step with ``A``
(6.646872).  Same comparisons and tolerance as
``test_torch_sharded_train.py`` (1e-5 on loss, ``grad_norm`` and every
parameter after two steps; replicas bitwise equal).  The
``"all_to_all"`` impl equals no meshless step; the reference's own
sharded step is its oracle (``test_torch_sharded_train_reference.py``).
"""
import pytest

from repro_torch.configs import smoke_config as torch_smoke_config

from _torch_sharded_train import (assert_matches, CASES, case_id, jax_run,
                                  one_thread, port_run,  # noqa: F401
                                  VARIANTS)

pytestmark = pytest.mark.usefixtures("one_thread")
NAME = "phi3.5-moe-42b"


def _oracle_accum(shape, accum):
    """The meshless ``accum_steps`` a (D, M) step with ``accum`` equals."""
    return accum * (shape[0] if shape[1] > 1 else 1)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_moe_sharded_step_matches_meshless_reference(case):
    shape, variant = case
    accum, shard_grads, compression, remat = VARIANTS[variant]
    got = port_run(NAME, shape, accum, shard_grads, compression, remat)
    want = jax_run(NAME, _oracle_accum(shape, accum), compression)
    assert_matches(got, want, torch_smoke_config(NAME))


@pytest.mark.parametrize("shape, loss", [((2, 2), 6.642024),
                                         ((2, 1), 6.646872)],
                         ids=["2x2", "2x1"])
def test_moe_step_oracle_values(shape, loss):
    """The first step's loss of the reference's own sharded step."""
    got = port_run(NAME, shape, 1, True, None, "none")
    assert abs(got[0][0] - loss) < 1e-5
