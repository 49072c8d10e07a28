"""Sharded training of whisper-base (``make_train_step(cfg, mesh)`` on
``smoke_config("whisper-base")``, float32) on virtual CPU meshes against
the JAX package's meshless jitted step, as
``tests/test_torch_sharded_train.py`` holds yi-6b: a (D, M) step with
``accum_steps=A`` computes what the meshless step with ``A * D``
computes.  Two steps on ``SyntheticLM(cfg, 8, 32)``'s batches 0 and 1,
whose ``frontend_embeds`` (32 frames) each data replica runs through the
encoder on its rows before its decoder layers attend them; the loss and
``grad_norm`` of each step and every parameter after both within 1e-5;
every copy of a part that several devices hold bitwise equal to the
others.  (2, 2) and (1, 2) at ``accum_steps`` 1 and 2 under ``remat``
``"none"`` and ``"full"``, bf16 gradient compression once, and (1, 3),
where nothing but the batch splits.

Under ``remat="full"`` the backward gathers every encoder and decoder
layer's FSDP parts again (each layer's gather sits in its checkpoint);
under ``"none"`` each is gathered once.
"""
import pytest
import torch

from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.distributed import place_train, virtual_mesh

from _torch_sharded_train import (assert_matches, init_torch,  # noqa: F401
                                  jax_run, one_thread, port_run)

pytestmark = pytest.mark.usefixtures("one_thread")

NAME = "whisper-base"
# (mesh, accum_steps, grad_compression, remat)
CASES = {"2x2-a1-none": ((2, 2), 1, None, "none"),
         "2x2-a2-full": ((2, 2), 2, None, "full"),
         "1x2-a1-full": ((1, 2), 1, None, "full"),
         "1x2-a2-none": ((1, 2), 2, None, "none"),
         "1x2-bf16": ((1, 2), 1, "bf16", "none"),
         "1x3-a1-full": ((1, 3), 1, None, "full")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_meshless_reference(case):
    shape, accum, compression, remat = CASES[case]
    got = port_run(NAME, shape, accum, False, compression, remat)
    want = jax_run(NAME, accum * shape[0], compression)
    assert_matches(got, want, torch_smoke_config(NAME))


def test_remat_gathers_encoder_and_decoder_layers_again(monkeypatch):
    """Counted at ``all_gather`` on (2, 2): ``remat="full"`` adds one
    gather of every encoder and decoder layer's parts to ``"none"``'s."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import gather_fsdp
    from repro_torch.train import loss_and_grads

    tcfg = torch_smoke_config(NAME)
    mesh = virtual_mesh((2, 2), "cpu")
    placed = place_train(init_torch(NAME), tcfg, mesh)
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, tcfg.vocab_size, (4, 16),
                                     generator=g),
             "frontend_embeds": torch.randn((4, 16, tcfg.frontend_dim),
                                            generator=g)}
    calls = []
    gather = sharding.all_gather

    def spy(parts, dim):
        calls.append(dim)
        return gather(parts, dim)

    monkeypatch.setattr(sharding, "all_gather", spy)
    gather_fsdp(placed, lambda t: t["layers"])
    gather_fsdp(placed, lambda t: t["encoder"]["layers"])
    per_layers = len(calls)
    counts = {}
    for remat in ("none", "full"):
        calls.clear()
        loss_and_grads(placed, tcfg, batch, remat=remat, mesh=mesh)
        counts[remat] = len(calls)
    assert per_layers > 0
    assert counts["full"] == counts["none"] + per_layers
