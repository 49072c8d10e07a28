"""K7's launch plans on one CUDA card, against the alternatives.

    python3 scripts/k7_sweep.py

Times K7 (``csrc/moe_gemm.cu``, the capacity-padded batched expert GEMM)
at phi3.5-moe-42b's expert shapes (16 experts; up and gate 4096 -> 6400,
down 6400 -> 4096; seeded random bf16 weights) at capacities 2 (the
rung-8 decode), 37 (ragged) and 320 (the 2,048-token training step).
Every wgmma plan the library is built for (``K7_PLANS``: wgmma width,
warpgroups, stages), with the raster band ``k7_plan`` gives and with no
band (one row tile at a time), runs beside the plan ``k7_plan`` picks and
``torch.bmm`` (a yardstick the port never calls).  A time is the
CUDA-event time of ``REPS`` launches queued behind a spin kernel
(``chip_smoke._queued_ms``), each result checked against the plain
version first.  Beside it: the host microseconds per
``moe_grouped_gemm`` call and ``torch.bmm``'s, and the least time the
card could take (bytes over 3.35 TB/s or operations over 989 TFLOP/s).

Every line printed is one JSON object; the first names the card and its
power limit.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

E, D, FF = 16, 4096, 6400
SHAPES = {"up": (D, FF), "down": (FF, D)}       # (d, f)
CAPS = (2, 37, 320)
REPS = 6


def _say(obj) -> None:
    print(json.dumps(obj), flush=True)


def _card(torch) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _say({"card": smi, "torch": torch.__version__})


def _host_us(torch, fn) -> float:
    """Host microseconds per call: the best of three runs of ``REPS``
    calls issued without synchronising."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / REPS * 1e6


def _us(torch, cs, fn) -> float:
    return cs._queued_ms(torch, lambda: [fn() for _ in range(REPS)]
                         )[0] / REPS * 1e3


def sweep(torch, cs, kernels) -> None:
    gen = torch.Generator(device="cuda").manual_seed(18)
    stream = torch.cuda.current_stream().cuda_stream
    for gemm, (d, f) in SHAPES.items():
        w = (torch.randn(E, d, f, device="cuda", generator=gen)
             / d ** 0.5).bfloat16()
        for c in CAPS:
            x = torch.randn(E, c, d, device="cuda", generator=gen).bfloat16()
            ref = kernels.moe_grouped_gemm_plain(x, w)
            cs._max_err(f"K7 {gemm} C={c}", kernels.moe_grouped_gemm(x, w),
                        ref, cs.BF16_REL, cs._f32_atol(ref))
            nbytes = 2 * (x.numel() + w.numel() + E * c * f)
            row = {"kernel": "K7", "gemm": gemm, "capacity": c,
                   "bound_us": max(nbytes / 3.35e12,
                                   2 * E * c * d * f / 989e12) * 1e6,
                   "entry_us": _us(torch, cs,
                                   lambda: kernels.moe_grouped_gemm(x, w)),
                   "library_us": _us(torch, cs, lambda: torch.bmm(x, w)),
                   "host_us": _host_us(
                       torch, lambda: kernels.moe_grouped_gemm(x, w)),
                   "library_host_us": _host_us(torch,
                                               lambda: torch.bmm(x, w))}
            mg = sys.modules["repro_torch.kernels.moe_gemm"]
            fn = mg._lib("moe_gemm_wgmma", mg._WGMMA_ARGS)
            out = torch.empty(E, c, f, device="cuda",
                              dtype=torch.bfloat16)
            chosen = kernels.k7_plan(c, d, f)
            cands = []
            for bq, nwg, st in mg.K7_PLANS:
                plan = dataclasses.replace(
                    kernels.k7_plan(c, d, f), bq=bq, nwg=nwg, stages=st)
                plan = dataclasses.replace(
                    plan, band=min(plan.band, -(-c // bq)))
                cands.append(plan)
                if plan.band > 1:
                    cands.append(dataclasses.replace(plan, band=1))

            def key(p):
                return f"bq{p.bq}w{p.nwg}s{p.stages}b{p.band}"

            def time_plan(plan):
                def go():
                    kernels._build.check("moe_gemm", fn(
                        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, c,
                        d, f, plan.bq, plan.nwg, plan.stages, plan.band,
                        stream))
                go()
                cs._max_err(f"K7 {gemm} C={c} {plan}", out, ref,
                            cs.BF16_REL, cs._f32_atol(ref))
                return _us(torch, cs, go)

            times = {key(p): time_plan(p) for p in cands}
            if key(chosen) not in times:
                times[key(chosen)] = time_plan(chosen)
            row.update({"plan": key(chosen),
                        "plan_us": times[key(chosen)],
                        "best": min(times, key=times.get),
                        "us": {k: round(v, 3) for k, v in
                               sorted(times.items(),
                                      key=lambda kv: kv[1])}})
            del out
            _say(row)
            del x, ref
        del w


def main() -> int:
    import chip_smoke as cs  # puts this checkout's src on the path
    import torch
    if not torch.cuda.is_available():
        print("k7_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    _card(torch)
    sweep(torch, cs, kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
