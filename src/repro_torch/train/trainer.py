"""The training loop with checkpoint/restart and a straggler watchdog
(the single-device port of ``repro/train/trainer.py``).

Restart resumes from the newest checkpoint's step; data order is a pure
function of the step (``repro_torch.data.SyntheticLM``), so no pipeline
state is saved.  The watchdog keeps an EWMA of step wall time and flags
steps far beyond it.
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
from repro_torch.models import init_params
from repro_torch.optim import adamw
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
    stream.  ``device=None`` is the CUDA card (raises without one);
    ``params``, if given, are the initial weights (on ``device``) instead
    of a seeded init."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, *,
                 mesh=None, opt_cfg: Optional[adamw.AdamWConfig] = None,
                 params: Optional[PyTree] = None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "sharded training is the distributed slice of the port "
                "(ROADMAP.md)")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.watchdog = StragglerWatchdog()
        self.data = SyntheticLM(cfg, tcfg.global_batch, tcfg.seq_len,
                                DataConfig(seed=tcfg.seed))
        self.step_fn = make_train_step(
            cfg, opt_cfg=self.opt_cfg, accum_steps=tcfg.accum_steps,
            remat=tcfg.remat)
        self._params = params
        self.history: list = []

    def init_or_restore(self):
        params = self._params
        self._params = None             # the loop updates them in place
        if params is None:
            params = init_params(self.cfg, seed=self.tcfg.seed,
                                 device=self.device)
        opt_state = adamw.init_state(params)
        start = 0
        if self.tcfg.ckpt_dir:
            latest = ckpt.latest_step_dir(self.tcfg.ckpt_dir)
            if latest:
                start, (params, opt_state) = ckpt.restore(
                    latest, (params, opt_state))
                print(f"[trainer] restored step {start} from {latest}")
        return start, params, opt_state

    def run(self) -> Dict[str, Any]:
        start, params, opt_state = self.init_or_restore()
        n_stragglers = 0
        for step in range(start, self.tcfg.steps):
            t0 = time.time()
            batch = {k: torch.as_tensor(v, device=self.device)
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
