"""Training launcher (the single-device port of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
        --steps 50 --batch 8 --seq 128

``--device`` defaults to the CUDA card and raises without one;
``--smoke --device cpu`` trains a reduced config on the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.serve import device_name
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[launch.train] arch={cfg.name} "
          f"params~{cfg.params_count()/1e6:.0f}M device={device_name(dev)}")
    tcfg = TrainerConfig(steps=args.steps, global_batch=args.batch,
                         seq_len=args.seq, accum_steps=args.accum,
                         remat=args.remat, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every)
    opt = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)
    out = Trainer(cfg, tcfg, opt_cfg=opt, device=dev).run()
    print(f"[launch.train] done: loss {out['first_loss']:.3f} -> "
          f"{out['final_loss']:.3f}; stragglers {out['stragglers']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
