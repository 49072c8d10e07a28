"""Sharded training of the port (``make_train_step(cfg, mesh)``) on CPU
meshes for the decoders of sliding-window, RG-LRU and RWKV6 layers and
the vision stub (``smoke_config`` of gemma3-1b, recurrentgemma-2b,
rwkv6-3b and internvl2-76b, whose ``SyntheticLM`` batches carry
``frontend_embeds``), against the JAX package's meshless jitted step, as
``tests/test_torch_sharded_train.py`` holds yi-6b: a (D, M) step with
``accum_steps=A`` computes what the meshless step with ``A * D``
computes.  Two steps on ``SyntheticLM(cfg, 8, 32)``'s batches 0 and 1;
the loss and ``grad_norm`` of each step and every parameter after both
within 1e-5; every copy of a part that several devices hold bitwise
equal to the others.  The (2, 2) cases run under ``remat="full"`` (the
FSDP gather inside each layer's checkpoint); a ``Trainer`` on a mesh
takes each model.
"""
import math

import pytest

from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.distributed import virtual_mesh
from repro_torch.train import Trainer, TrainerConfig

from _torch_sharded_train import (assert_matches, jax_run,  # noqa: F401
                                  one_thread, port_run)

pytestmark = pytest.mark.usefixtures("one_thread")

NAMES = ("gemma3-1b", "recurrentgemma-2b", "rwkv6-3b", "internvl2-76b")
SHAPES = ((1, 2), (2, 2), (1, 4))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_meshless_reference(name, shape):
    remat = "full" if shape == (2, 2) else "none"
    got = port_run(name, shape, 1, True, None, remat)
    want = jax_run(name, shape[0], None)
    assert_matches(got, want, torch_smoke_config(name))


@pytest.mark.parametrize("name", NAMES)
def test_trainer_on_a_mesh_takes_every_model(name):
    tcfg = torch_smoke_config(name)
    out = Trainer(tcfg, TrainerConfig(steps=2, global_batch=4, seq_len=16,
                                      log_every=100),
                  mesh=virtual_mesh((2, 2), "cpu")).run()
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
