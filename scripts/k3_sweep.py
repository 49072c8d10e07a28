"""K3's launch plans on one CUDA card, against the alternatives.

    python3 scripts/k3_sweep.py

Times K3's wgmma route (``sisa_gemm_splitk`` on K1's body in
``csrc/sisa_gemm.cu``) at qwen2.5-0.5b's decode projections (K x N =
896 x 896, 896 x 128, 896 x 4864, 4864 x 896) at rungs 8 and 16, with
the slab depths ``chip_smoke.py`` checks and the decode step's 256.
Every tile the library is built for (swap-AB n8 and n16, K1's 64 x 64)
at the cluster ``k3_plan`` deals the slabs to, and the pick's tile at
fewer ranks (each rank still a run of whole slabs), run beside the plan
``k3_plan`` picks; beside them the CUDA-core route's partials and their
``torch.sum`` (the route every call took before), K1's own plan for the
same product (``sisa_gemm``, no slabs), and ``torch.matmul`` (a
yardstick the port never calls).  A time is the CUDA-event time of
``REPS`` launches queued behind a spin kernel
(``chip_smoke._queued_ms``), cycling over 8 weight copies so the weights
come from device memory as in a decode step; every result is checked
against the plain version first.  Beside the pick: the least time the
card could take (bytes over 3.35 TB/s).

Every line printed is one JSON object; the first names the card and its
power limit.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

QWEN = {"q": (896, 896), "kv": (896, 128), "up": (896, 4864),
        "down": (4864, 896)}
SLABS = {896: (128, 256, 448), 4864: (256, 1216)}
ROWS = (8, 16)
COPIES = 8
REPS = 24


def _say(obj) -> None:
    print(json.dumps(obj), flush=True)


def _card(torch) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _say({"card": smi, "torch": torch.__version__})


def _us(torch, cs, fn) -> float:
    return cs._queued_ms(torch, lambda: [fn(i) for i in range(REPS)]
                         )[0] / REPS * 1e3


def sweep(torch, cs, kernels) -> None:
    sg = sys.modules["repro_torch.kernels.sisa_gemm"]
    fn = sg._lib("sisa_gemm_wgmma", sg._WGMMA_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(19)
    for gemm, (k, n) in QWEN.items():
        ws = [(torch.randn(k, n, device="cuda", generator=gen)
               / k ** 0.5).bfloat16() for _ in range(COPIES)]
        for m in ROWS:
            a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
            out = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
            for bk in SLABS[k]:
                cfg = kernels.BlockConfig(16, bk=bk)
                ref = kernels.sisa_gemm_splitk_plain(a, ws[0], bk).sum(
                    0).to(a.dtype)
                pick = kernels.k3_plan(m, n, k, bk)
                cands = [dataclasses.replace(pick, bm=bm, bn=64, stages=st,
                                             swap_ab=swap)
                         for bm, st, swap in ((8, 8, True), (16, 8, True),
                                              (64, 6, False))
                         if bm >= m or not swap]
                cands += [dataclasses.replace(pick, cluster=s)
                          for s in (1, 2, 4) if s < pick.cluster]

                def key(p):
                    return (f"{'swap' if p.swap_ab else 'tile'}{p.bm}x"
                            f"{p.bn}s{p.cluster}")

                def time_plan(p):
                    def go(i):
                        kernels._build.check("sisa_gemm", fn(
                            a.data_ptr(), ws[i % COPIES].data_ptr(),
                            out.data_ptr(), m, n, k, k, n, n, 0, 0,
                            int(p.swap_ab), p.bm, p.bn, p.stages,
                            p.cluster, p.slab_steps, stream))
                    go(0)
                    cs._max_err(f"K3 {gemm} M={m} bk={bk} {key(p)}", out,
                                ref, cs.BF16_REL, cs._f32_atol(ref))
                    return _us(torch, cs, go)

                times = {key(p): time_plan(p) for p in cands}
                if key(pick) not in times:
                    times[key(pick)] = time_plan(pick)
                partials = sg._splitk_partials
                k1 = kernels.sisa_gemm
                nbytes = 2 * (m * k + k * n + m * n)
                _say({"kernel": "K3", "gemm": gemm, "m": m, "k": k, "n": n,
                      "bk": bk, "plan": key(pick), "plan_us": times[key(pick)],
                      "best": min(times, key=times.get),
                      "us": {x: round(v, 3) for x, v in
                             sorted(times.items(), key=lambda kv: kv[1])},
                      "cuda_core_partials_us": _us(
                          torch, cs, lambda i: partials(
                              a, ws[i % COPIES], cfg).sum(0).to(a.dtype)),
                      "k1_us": _us(torch, cs,
                                   lambda i: k1(a, ws[i % COPIES], out)),
                      "library_us": _us(torch, cs, lambda i: torch.matmul(
                          a, ws[i % COPIES])),
                      "bound_us": nbytes / 3.35e12 * 1e6})
            del a, out
        del ws


def main() -> int:
    import chip_smoke as cs  # puts this checkout's src on the path
    import torch
    if not torch.cuda.is_available():
        print("k3_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    _card(torch)
    sweep(torch, cs, kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
