"""The port's GPipe pipeline (``repro_torch.distributed.pipeline``)
against the reference's ``tests/test_pipeline.py`` cases, on CPU meshes.

* ``schedule_bubble_fraction`` gives the reference's values;
* on a 1-stage axis the pipeline equals plain application, and the
  reference's ``pipeline_apply`` on its 1-device host mesh (1e-6);
* 4 stages on a ``("pp",)`` mesh of 4 CPU devices equal the sequential
  reference (1e-5), every stage holding the last stage's outputs, bit
  for bit the same; a 2-stage ``("data", "model")`` pipeline over
  ``model`` likewise;
* ``ppermute`` against ``jax.lax.ppermute`` under ``jax.vmap``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import pipeline as jpipe
from repro.launch.mesh import make_host_mesh
from repro_torch.distributed import Mesh, ppermute, virtual_mesh
from repro_torch.distributed.pipeline import (pipeline_apply,
                                              schedule_bubble_fraction)


def _stage(p, x):
    return torch.tanh(x @ p)


def test_bubble_fraction():
    assert schedule_bubble_fraction(1, 8) == 0.0
    assert schedule_bubble_fraction(2, 2) == pytest.approx(1 / 3)
    assert schedule_bubble_fraction(4, 16) == pytest.approx(3 / 19)
    assert (schedule_bubble_fraction(4, 64)
            < schedule_bubble_fraction(4, 8))
    for s, m in ((1, 8), (2, 2), (4, 16), (3, 5)):
        assert schedule_bubble_fraction(s, m) == \
            jpipe.schedule_bubble_fraction(s, m)


def test_single_stage_pipeline_is_identity_schedule():
    w = np.random.default_rng(0).normal(size=(1, 4, 4)).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(3, 2, 4)).astype(np.float32)
    mesh = virtual_mesh((1, 1), "cpu")
    (y,) = pipeline_apply(_stage, torch.from_numpy(w), torch.from_numpy(x),
                          mesh, axis="data")
    ref = torch.stack([_stage(torch.from_numpy(w[0]), torch.from_numpy(xi))
                       for xi in x])
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-6)
    jmesh = make_host_mesh()
    with jmesh:
        jy = jpipe.pipeline_apply(lambda p, v: jnp.tanh(v @ p),
                                  jnp.asarray(w), jnp.asarray(x), jmesh,
                                  axis="data")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)


@pytest.mark.parametrize("n_micro", [6, 1])
def test_multi_stage_pipeline_equals_sequential(n_micro):
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.normal(size=(4, 8, 8)) * 0.3).astype(
        np.float32))
    x = torch.from_numpy(rng.normal(size=(n_micro, 2, 8)).astype(np.float32))
    mesh = Mesh(np.asarray([torch.device("cpu")] * 4, dtype=object), ("pp",))
    ys = pipeline_apply(_stage, w, x, mesh, axis="pp")
    ref = x
    for s in range(4):
        ref = torch.stack([_stage(w[s], ref[i]) for i in range(n_micro)])
    assert len(ys) == 4
    np.testing.assert_allclose(ys[0].numpy(), ref.numpy(), atol=1e-5)
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


def test_two_stage_pipeline_over_model_axis_with_tree_params():
    rng = np.random.default_rng(2)
    params = {"w": torch.from_numpy(rng.normal(size=(2, 4, 4)).astype(
        np.float32)), "b": [torch.from_numpy(rng.normal(size=(2, 4)).astype(
            np.float32))]}
    x = torch.from_numpy(rng.normal(size=(3, 5, 4)).astype(np.float32))

    def stage(p, v):
        return torch.tanh(v @ p["w"] + p["b"][0])

    ys = pipeline_apply(stage, params, x, virtual_mesh((2, 2), "cpu"),
                        axis="model")
    ref = x
    for s in range(2):
        ref = torch.stack([stage({"w": params["w"][s],
                                  "b": [params["b"][0][s]]}, v) for v in ref])
    np.testing.assert_allclose(ys[1].numpy(), ref.numpy(), atol=1e-5)


def test_ppermute_equals_reference():
    """A full permutation against ``jax.lax.ppermute`` under ``jax.vmap``
    (whose batching takes full ones only); the pipeline's shift, where
    rank 0 receives nothing, against its definition: zeros."""
    x = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    perm = [(0, 3), (3, 1), (1, 2), (2, 0)]
    got = ppermute([torch.from_numpy(r) for r in x], perm)
    want = jax.vmap(lambda v: jax.lax.ppermute(v, "i", perm),
                    axis_name="i")(jnp.asarray(x))
    np.testing.assert_array_equal(torch.stack(got).numpy(), np.asarray(want))
    got = ppermute([torch.from_numpy(r) for r in x], [(0, 1), (1, 2), (2, 3)])
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  np.concatenate([np.zeros((1, 3)), x[:3]]))
