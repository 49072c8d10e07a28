"""Serving launcher (SISA-aware continuous batching; the port of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-0.5b \
        --engine paged --requests 16

``--device`` defaults to the CUDA card and raises without one;
``--smoke --device cpu`` serves a reduced config on the CPU.  Returns 0
only when every request completes.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import init_params
from repro_torch.serve import make_engine, Request


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else str(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--engine", default="sequential",
                    choices=["sequential", "slot", "paged"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[launch.serve] arch={cfg.name} device={device_name(dev)}")
    params = init_params(cfg, seed=args.seed, device=dev)
    eng = make_engine(cfg, params, kind=args.engine, device=dev,
                      max_slots=8, max_seq=args.max_seq)
    rng = np.random.default_rng(args.seed)
    # paper Fig 1a prompt-length distribution: median 12, mean ~42
    lengths = np.minimum(rng.zipf(1.5, size=args.requests) + 11,
                         args.max_seq // 2)
    for i, L in enumerate(lengths):
        eng.submit(Request(rid=i,
                           prompt=rng.integers(2, cfg.vocab_size, size=int(L)
                                               ).astype(np.int32),
                           max_new_tokens=args.max_new_tokens))
    t0 = time.time()
    done = eng.run(max_steps=4096)
    dt = time.time() - t0
    ttft = eng.stats["ttft"]
    print(f"[launch.serve] {len(done)}/{args.requests} done in {dt:.1f}s; "
          f"TTFT p50={np.median(ttft)*1e3:.0f}ms; "
          f"batch choices={eng.stats['batches']}")
    return 0 if len(done) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
