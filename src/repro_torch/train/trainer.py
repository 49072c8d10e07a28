"""The training loop with checkpoint/restart and a straggler watchdog
(the port of ``repro/train/trainer.py``).

Restart resumes from the newest checkpoint's step; data order is a pure
function of the step (``repro_torch.data.SyntheticLM``), so no pipeline
state is saved.  The watchdog keeps an EWMA of step wall time and flags
steps far beyond it.

With a mesh the parameters are placed by ``param_specs(fsdp=True)``
(``place_train``) and the moments by ``opt_state_specs``; each step
gets the whole batch on the host and the train step feeds each data
replica its ``batch_specs`` rows.  Checkpoints hold whole leaves, so a
restart restores onto whatever mesh the trainer has (the elastic
restart: train on (4, 2), lose 4 devices, go on on (2, 2)).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed.fault import StragglerWatchdog
from repro_torch.distributed.sharding import (init_opt_state,
                                              opt_state_specs, param_specs,
                                              place_train)
from repro_torch.models import init_params
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_map
from repro_torch.train.train_step import make_train_step

PyTree = Any


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    accum_steps: int = 1
    remat: str = "none"
    log_every: int = 10
    seed: int = 0


class Trainer:
    """``Trainer(cfg, tcfg).run()`` trains ``cfg`` on the synthetic
    stream.  ``device=None`` is the CUDA card (raises without one), or
    with ``mesh`` the mesh's first device, where the weights are made
    before they are placed; ``params``, if given, are the initial
    weights (on ``device``, whole) instead of a seeded init."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, *,
                 mesh=None, opt_cfg: Optional[adamw.AdamWConfig] = None,
                 params: Optional[PyTree] = None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        if mesh is not None and device is None:
            device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.watchdog = StragglerWatchdog()
        self.data = SyntheticLM(cfg, tcfg.global_batch, tcfg.seq_len,
                                DataConfig(seed=tcfg.seed))
        self.step_fn = make_train_step(
            cfg, mesh, opt_cfg=self.opt_cfg, accum_steps=tcfg.accum_steps,
            remat=tcfg.remat)
        self._params = params
        self.history: list = []

    def init_or_restore(self):
        params = self._params
        self._params = None             # the loop updates them in place
        if params is None:
            params = init_params(self.cfg, seed=self.tcfg.seed,
                                 device=self.device)
        latest = (ckpt.latest_step_dir(self.tcfg.ckpt_dir)
                  if self.tcfg.ckpt_dir else None)
        start = 0
        if self.mesh is not None:
            pspecs = param_specs(params, self.cfg, self.mesh, fsdp=True)
            if latest:
                like = (params, adamw.init_state(tree_map(
                    lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params)))
                del params
                start, (params, opt_state) = ckpt.restore(
                    latest, like, mesh=self.mesh,
                    specs=(pspecs, opt_state_specs(pspecs)))
            else:
                params = place_train(params, self.cfg, self.mesh)
                opt_state = init_opt_state(params)
        else:
            opt_state = adamw.init_state(params)
            if latest:
                start, (params, opt_state) = ckpt.restore(
                    latest, (params, opt_state))
        if latest:
            print(f"[trainer] restored step {start} from {latest}")
        return start, params, opt_state

    def run(self) -> Dict[str, Any]:
        start, params, opt_state = self.init_or_restore()
        n_stragglers = 0
        for step in range(start, self.tcfg.steps):
            t0 = time.time()
            batch = {k: torch.as_tensor(
                v, device="cpu" if self.mesh is not None else self.device)
                     for k, v in self.data.batch(step).items()}
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if self.watchdog.observe(step, dt):
                n_stragglers += 1
            self.history.append({"step": step, "loss": loss, "dt": dt})
            if step % self.tcfg.log_every == 0:
                print(f"[trainer] step {step:5d} loss {loss:.4f} "
                      f"{dt*1e3:.0f}ms", flush=True)
            if (self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0):
                ckpt.save_step(self.tcfg.ckpt_dir, step + 1,
                               (params, opt_state),
                               extra={"arch": self.cfg.name})
        return {"params": params, "opt_state": opt_state,
                "final_loss": self.history[-1]["loss"] if self.history
                else None,
                "first_loss": self.history[0]["loss"] if self.history
                else None,
                "stragglers": n_stragglers,
                "history": self.history}
