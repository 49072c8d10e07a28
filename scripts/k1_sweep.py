"""K1's launch plans on one CUDA card, against the alternatives.

    python3 scripts/k1_sweep.py

Times K1's wgmma body (``csrc/sisa_gemm.cu``) at the shapes of
qwen2.5-0.5b's projections (K x N = 896 x 896, 896 x 128, 896 x 4864,
4864 x 896; phi3.5-moe-42b's 4096 x 4096 and 4096 x 1024 at decode) for
every CTA tile and cluster size the library is built for, beside the
plan ``k1_plan`` picks and ``torch.matmul``: decode rungs 8 and 16
(swap-AB) and the 208-row prefill's passes of 128 and 80 rows.  Each
time is the CUDA-event time of 24 launches queued behind a spin kernel,
cycling over 8 weight copies so that weights come from device memory as
in a forward; every result is checked against the plain version.  Beside
the plan's time stand the host microseconds per call of ``sisa_gemm``
on the plan's pick (the best of three runs of ``REPS`` calls issued
without synchronising), and ``torch.matmul``'s.

Every line printed is one JSON object; the first names the card and its
power limit.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

QWEN = {"q": (896, 896), "kv": (896, 128), "up": (896, 4864),
        "down": (4864, 896)}
PHI = {"phi_q": (4096, 4096), "phi_kv": (4096, 1024)}
REPS = 24


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


def sweep_plans(torch) -> None:
    import chip_smoke as cs
    from repro_torch import kernels
    sg = sys.modules["repro_torch.kernels.sisa_gemm"]
    fn = sg._lib("sisa_gemm_wgmma", sg._WGMMA_ARGS)
    stream = torch.cuda.current_stream().cuda_stream

    def time_plan(a, ws, n, k, plan):
        bm, bn, stages, s, swap = plan
        out = torch.empty(a.shape[0], n, device="cuda", dtype=torch.bfloat16)

        def go():
            for i in range(REPS):
                kernels._build.check("sisa_gemm", fn(
                    a.data_ptr(), ws[i % len(ws)].data_ptr(), out.data_ptr(),
                    a.shape[0], n, k, k, n, n, 0, 0, int(swap), bm, bn,
                    stages, s, stream))
        ms, _ = cs._queued_ms(torch, go)
        ref = kernels.sisa_gemm_plain(a, ws[(REPS - 1) % len(ws)])
        cs._max_err(f"K1 plan {plan}", out, ref, cs.BF16_REL,
                    cs._f32_atol(ref))
        return ms / REPS * 1e3

    def library_us(a, ws):
        ms, _ = cs._queued_ms(
            torch, lambda: [torch.matmul(a, ws[i % len(ws)])
                            for i in range(REPS)])
        return ms / REPS * 1e3

    for rows in (8, 16, 128, 80):
        for name, (k, n) in {**QWEN, **(PHI if rows <= 16 else {})}.items():
            gen = torch.Generator(device="cuda").manual_seed(rows)
            a = torch.randn(rows, k, device="cuda", generator=gen).bfloat16()
            ws = [(torch.randn(k, n, device="cuda", generator=gen)
                   / k ** 0.5).bfloat16() for _ in range(8)]
            chosen = kernels.k1_plan(rows, n, k)
            ksteps = -(-k // sg.K1_BK)
            clusters = [s for s in sg.K1_CLUSTERS if s == 1 or ksteps >= 2 * s]
            if chosen.swap_ab:
                cands = [(chosen.bm, 64, sg.K1_SWAP_STAGES, s, True)
                         for s in clusters]
            else:
                cands = [(tm, tn, sg.K1_STAGES[(tm, tn)], s, False)
                         for tm, tn in sg.K1_TILES for s in clusters]
            times = {f"{bm}x{bn}s{s}": time_plan(a, ws, n, k,
                                                (bm, bn, st, s, sw))
                     for bm, bn, st, s, sw in cands}
            out = torch.empty(rows, n, device="cuda", dtype=torch.bfloat16)
            cycle = itertools.cycle(ws)
            _say({"rows": rows, "gemm": name, "k": k, "n": n,
                  "plan": f"{chosen.bm}x{chosen.bn}s{chosen.cluster}",
                  "plan_us": times[f"{chosen.bm}x{chosen.bn}s"
                                   f"{chosen.cluster}"],
                  "best": min(times, key=times.get),
                  "library_us": library_us(a, ws),
                  "host_us": _host_us(torch, lambda: kernels.sisa_gemm(
                      a, next(cycle), out=out)),
                  "library_host_us": _host_us(torch, lambda: torch.matmul(
                      a, next(cycle), out=out)),
                  "us": {key: round(v, 3) for key, v in
                         sorted(times.items(), key=lambda kv: kv[1])}})
            del ws


def main() -> int:
    import chip_smoke  # noqa: F401  (puts this checkout's src on the path)
    import torch
    if not torch.cuda.is_available():
        print("k1_sweep: no CUDA device", file=sys.stderr)
        return 1
    _card(torch)
    sweep_plans(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
