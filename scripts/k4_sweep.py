"""K4's and K5's launch plans on one CUDA card, against the alternatives.

    python3 scripts/k4_sweep.py

Times the wgmma bodies of K4 (``csrc/grouped_gemm.cu``: the flat grouped
GEMM's forward, and dX reading the weights transposed) and K5
(``csrc/grouped_dw.cu``: the segment-sum dW) at phi3.5-moe-42b's expert
shapes (16 experts, d 4096, d_ff 6400; up 4096 x 6400 and down 6400 x
4096) and the layouts the MoE layer builds at the rung-8 decode (8
tokens), a 208-token prefill and a 2048-token training step, with expert
sizes routed top-2 from seeded random logits.  Every plan the libraries
are built for (``K4_PLANS``, ``K5_PLANS``: wgmma width, warpgroups,
stages) that the layout admits runs beside the plan ``k4_plan``
/ ``k5_plan`` picks and ``torch._grouped_mm`` (a yardstick the port never
calls); K4 at training also with the raster band set to every row tile
(the row tiles fastest, no band).  Each time
is the CUDA-event time of ``REPS`` launches queued behind a spin kernel;
every result is checked against the plain version.  Beside the plan's
time stand the host microseconds per call of the public entry
(``segment_grouped_gemm``, tile table included), and
``torch._grouped_mm``'s.

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

E, D, FF, TOP_K = 16, 4096, 6400, 2
SHAPES = {"up": (D, FF), "down": (FF, D)}       # (k, n) of the forward
TOKENS = {"decode": 8, "prefill": 208, "train": 2048}
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


def _layout(torch, kernels, tokens, gen):
    """(bm, m_flat, starts, sizes, offs, meta) as the MoE layer builds them
    for ``tokens`` tokens routed top-2 over the experts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped_gemm import _tile_metadata
    from repro_torch.models.moe import _capacity

    cap = _capacity(tokens, E, TOP_K,
                    get_config("phi3.5-moe-42b").moe.capacity_factor)
    bm = kernels.flat_block_rows(min(cap, 64), FF, D, torch.bfloat16)
    m_flat = E * -(-cap // bm) * bm
    logits = torch.randn(tokens, E, device="cuda", generator=gen)
    topi = torch.topk(logits, TOP_K, -1).indices
    sizes = torch.bincount(topi.reshape(-1), minlength=E).clamp(
        max=cap).to(torch.int32)
    offs = kernels.flat_group_offsets(sizes, bm)
    gids = torch.arange(E, dtype=torch.int32, device="cuda")
    meta = _tile_metadata(offs[:-1], sizes, gids, m_flat // bm, bm)
    return bm, m_flat, offs, sizes, gids, meta


def _rows(torch, m_flat, cols, offs, sizes, gen):
    mask = torch.zeros(m_flat, 1, device="cuda")
    for s, n in zip(offs[:-1].tolist(), sizes.tolist()):
        mask[s:s + n] = 1
    return (torch.randn(m_flat, cols, device="cuda", generator=gen)
            * mask).bfloat16()


def sweep_k4(torch, cs, kernels, gg, layout, gen) -> None:
    fn = gg._lib("grouped_gemm", "grouped_gemm_wgmma", gg._K4_WGMMA_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    bm, m_flat, offs, sizes, gids, meta = _layout(torch, kernels,
                                                  TOKENS[layout], gen)
    n_mt = m_flat // bm
    modes = ("fwd", "dx") if layout == "train" else ("fwd",)
    for gemm, (k, n) in SHAPES.items():
        w = (torch.randn(E, k, n, device="cuda", generator=gen)
             / k ** 0.5).bfloat16()
        for mode in modes:
            if mode == "fwd":
                x, wv, kk, nn = _rows(torch, m_flat, k, offs, sizes, gen), w, \
                    k, n
            else:               # dX = dY (n wide) @ w^T, w read in place
                x, wv, kk, nn = _rows(torch, m_flat, n, offs, sizes, gen), \
                    w.transpose(1, 2), n, k
            out = torch.empty(m_flat, nn, device="cuda", dtype=torch.bfloat16)
            ref = kernels.segment_grouped_gemm_plain(
                x, wv, offs[:-1], sizes, gids, block_rows=bm)

            def time_plan(plan):
                def go():
                    for _ in range(REPS):
                        kernels._build.check("grouped_gemm", fn(
                            x.data_ptr(), wv.data_ptr(), out.data_ptr(),
                            meta.data_ptr(), n_mt, E, m_flat, nn, kk, bm,
                            x.stride(0), nn, int(mode == "dx"), plan.bq,
                            plan.nwg, plan.stages, plan.band, stream))
                ms, _ = cs._queued_ms(torch, go)
                cs._max_err(f"K4 {layout} {gemm} {mode} {plan}", out, ref,
                            cs.BF16_REL, cs._f32_atol(ref))
                return ms / REPS * 1e3

            chosen = kernels.k4_plan(bm, n_mt, kk)
            cands = [dataclasses.replace(chosen, bq=q, nwg=wg, stages=st)
                     for q, wg, st in gg.K4_PLANS if q >= bm]
            if layout == "train":
                cands += [dataclasses.replace(c, band=n_mt) for c in cands]

            def key(p):
                return f"bq{p.bq}w{p.nwg}s{p.stages}b{p.band}"
            times = {key(p): time_plan(p) for p in cands}
            lib_us = cs._queued_ms(torch, lambda: [
                torch._grouped_mm(x, wv, offs=offs[1:].contiguous())
                for _ in range(REPS)])[0] / REPS * 1e3
            _say({"kernel": "K4", "layout": layout, "mode": mode,
                  "gemm": gemm, "bm": bm, "row_tiles": n_mt,
                  "live_rows": int(sizes.sum()),
                  "plan": key(chosen), "plan_us": times[key(chosen)],
                  "best": min(times, key=times.get),
                  "library_us": lib_us,
                  "host_us": _host_us(torch, lambda: kernels.
                                      segment_grouped_gemm(
                                          x, wv, offs[:-1], sizes, gids,
                                          block_rows=bm)),
                  "library_host_us": _host_us(torch, lambda: torch.
                                              _grouped_mm(
                                                  x, wv,
                                                  offs=offs[1:].contiguous())),
                  "us": {k_: round(v, 3) for k_, v in
                         sorted(times.items(), key=lambda kv: kv[1])}})
            del x, out, ref
        del w


def sweep_k5(torch, cs, kernels, gg, gen) -> None:
    fn = gg._lib("grouped_dw", "grouped_dw_wgmma", gg._K5_WGMMA_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    bm, m_flat, offs, sizes, gids, meta = _layout(torch, kernels,
                                                  TOKENS["train"], gen)
    bounds = torch.searchsorted(
        meta[0].contiguous(), torch.arange(E + 1, dtype=torch.int32,
                                           device="cuda")).to(torch.int32)
    for gemm, (d, f) in SHAPES.items():
        x = _rows(torch, m_flat, d, offs, sizes, gen)
        dy = _rows(torch, m_flat, f, offs, sizes, gen)
        out = torch.empty(E, d, f, device="cuda", dtype=torch.bfloat16)
        ref = kernels.segment_grouped_dw_plain(x, dy, offs[:-1], sizes, gids,
                                               E)

        def time_plan(plan):
            def go():
                for _ in range(REPS):
                    kernels._build.check("grouped_dw", fn(
                        x.data_ptr(), dy.data_ptr(), out.data_ptr(),
                        meta.data_ptr(), bounds.data_ptr(), meta.shape[1],
                        E, m_flat, d, f, bm, d, f, plan.bq, plan.nwg,
                        plan.stages, stream))
            ms, _ = cs._queued_ms(torch, go)
            cs._max_err(f"K5 {gemm} {plan}", out, ref, cs.BF16_REL,
                        cs._f32_atol(ref))
            return ms / REPS * 1e3

        chosen = kernels.k5_plan()

        def key(p):
            return f"bq{p.bq}w{p.nwg}s{p.stages}"
        times = {key(p): time_plan(p)
                 for p in (kernels.K5Plan(*c) for c in gg.K5_PLANS)}
        lib = (lambda: torch._grouped_mm(x.t(), dy,
                                         offs=offs[1:].contiguous()))
        lib_us = cs._queued_ms(torch, lambda: [lib() for _ in range(REPS)]
                               )[0] / REPS * 1e3
        def entry():
            return gg._launch_dw(x, dy, meta, bm, E)
        _say({"kernel": "K5", "layout": "train", "gemm": gemm, "bm": bm,
              "live_rows": int(sizes.sum()), "plan": key(chosen),
              "plan_us": times[key(chosen)],
              "best": min(times, key=times.get), "library_us": lib_us,
              "host_us": _host_us(torch, entry),
              "library_host_us": _host_us(torch, lib),
              "us": {k_: round(v, 3) for k_, v in
                     sorted(times.items(), key=lambda kv: kv[1])}})
        del x, dy, out, ref


def main() -> int:
    import chip_smoke as cs  # puts this checkout's src on the path
    import torch
    if not torch.cuda.is_available():
        print("k4_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    gg = sys.modules["repro_torch.kernels.grouped_gemm"]
    _card(torch)
    gen = torch.Generator(device="cuda").manual_seed(16)
    for layout in TOKENS:
        sweep_k4(torch, cs, kernels, gg, layout, gen)
    sweep_k5(torch, cs, kernels, gg, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
