"""Drive the PyTorch/CUDA port's main path on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the six CUDA sources from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for sm_90a (one process per source, in parallel);
3. the wgmma libraries of K1 and K3 (SISA GEMM and split-K, one
   library), K4 and K5 (the grouped GEMMs), K6 (co-execution) and K7 (the
   capacity MoE GEMM): each one's ``ptxas -v`` report per wgmma kernel and
   its count of
   ``HGMMA`` and ``UTMALDG`` instructions (``cuobjdump -sass``), which must
   be > 0; then K1 against its plain version at the main
   path's shapes (qwen's, and phi3.5-moe's 4096-wide projections at 8 and
   208 rows), every tile height at full height and the ragged residual
   split (the 208-row prefill's 128 + 80), in float32 and bfloat16
   (elementwise, one bf16 ulp in bfloat16), with every branch of the
   wgmma body the main path uses reached (swap-AB at n8 and n16, each
   cluster size, each CTA tile); and K1's backward at 2048 rows (dA with
   B transposed, dB = Aᵀ dC with Aᵀ read in place, the LM head's
   ``table.T``);
4. K2 (split-KV paged attention) against its plain version: GQA 14/2
   with head_dim 64 (qwen) and 32/8 with head_dim 128 (phi3.5-moe),
   16-token pages, q in f32 and bf16, tables with sink entries, a row at
   position 0 (every split but the first empty), rows on page edges and
   on either side of the plan's first two split edges, a full row;
5. K4 (flat grouped GEMM) against its plain version at phi3.5-moe's
   expert shapes (4096 -> 6400 and 6400 -> 4096, 16 experts): decode-
   and prefill-like expert sizes, sizes off the row block, tail tiles, a
   capacity-strided layout, a 2048-token training layout and shared-gid
   a2a segments, in float32 and bfloat16; rows past each tile's ``hi``
   must be exactly 0.  Then the backward at the same layouts: K4's dX
   (``w`` read transposed, through a K-major map) and K5's dW against
   their plain versions, with empty experts' dW blocks exactly 0.  The
   rows outside every segment hold NaN in x and large finite values in
   dy (the reference masks only X).  Every bf16 case must take the wgmma
   route, and together they must reach every route (``k4_plan`` /
   ``k5_plan``: swap-AB width, warpgroups, stages) of phi3.5-moe's
   decode, 208-token prefill and 2048-token training step.  Then K2 on
   int8 pools (``quantize_page_pool``) at the cases of phase 4; K3 (split-K)
   at qwen's decode GEMV shapes, two slab depths each (clusters of 2, 4,
   7 and 8), two taller passes, and ragged edges (bf16 of whole-stage
   slabs one launch of the wgmma body, the rest on the CUDA-core route);
   K7 (the capacity MoE GEMM) at phi3.5-moe's expert shapes with
   capacities 2, 37 and 320; and K6 (co-execution) on the four
   scenarios of ``benchmarks/multi_tenant_bench.py`` at Qwen2.5-0.5B's
   Table 2 widths, tasks in the packer's order: each against its plain
   version in f32 and bf16, padding rows exactly 0, and fused equal to
   ``sequential_matmul`` bit for bit;
6. small float32 models (qwen2.5-0.5b's widths, and phi3.5-moe's layer
   structure at narrow widths with 8 experts, each 2 layers) served on
   the card (kernels) and on the CPU (plain versions) through each
   engine kind (``"paged"``, ``"slot"``, ``"sequential"``): identical
   greedy tokens per kind, and on the card the slot engine's equal to
   the paged engine's; the same requests through ``ServeFrontend`` over
   the slot and paged engines on the card, submitted out of order from
   two threads, equal to the CPU offline ``run()``'s; and one train step
   of each on both: the loss, every gradient and the parameters after
   AdamW;
7. ``qwen2.5-0.5b`` at full width in bfloat16 (seeded random weights)
   served through ``make_engine(kind="paged")``: 8 requests of 16-200
   prompt tokens, two sharing a 32-token prefix, 32 new tokens each;
   the launch counters are zeroed just before and K1's and K2's must be
   > 0 just after, every request prefilled once; the same 8 requests
   through ``kind="slot"`` (after ``warmup()``, ``decode_compiles`` 0)
   and ``kind="sequential"`` on the dense KV cache: K1's counter > 0 and
   K2's 0, every slot drained, and how many completions equal the paged
   serve's (printed, not asserted: bf16 sums at other M may flip a
   greedy token); one ``prefill_batch`` of the 8 prompts on the slot
   engine, its first tokens and parked caches against single prefills
   (``COALESCED_REL``); then the same serve on
   int8 page pools (``kv_quant="int8"``: K2's int8 variant > 0 and its
   float one 0, pool bytes (hd + 2) / (2 hd) of the bf16 pools', one K2
   launch on the serve's own pools against the plain version), and 16
   requests on the 8 slots with and without ``coexec_backend="kernel"``
   (identical tokens, backfilled prefills > 0);
8. the online frontend, after the coalesced-prefill check of phase 7,
   on the same weights: the 8 requests through ``ServeFrontend`` over
   ``make_engine(kind="paged")`` (``warmup()`` first), submitted by a
   separate thread at seeded exponential gaps (mean 100 ms), one with
   an ``on_token`` callback, then ``drain``: every handle at
   ``length``, the callback's stream its handle's tokens, K1 and K2 > 0
   (counters zeroed just before), ``decode_compiles`` 0, the pool
   drained; printed: completions equal to the offline paged serve's,
   user-observed TTFT and TPOT p50/p99 and tok/s beside the offline
   serve's in the same call, and the card's idle share over a second,
   profiled online serve.  Then a seeded fault storm
   (``FaultPlan.random(0, n_events=10, horizon=24)``, a straggler
   watchdog) on a pool of half the pages the 8 requests reserve: every
   handle resolved (``length``, ``cancelled`` or ``deadline``), no
   slot, page, reservation, orphan or prefix entry leaked, faults
   logged, K1 and K2 > 0; printed: the ``length`` survivors equal to
   the online serve's.  Then ``repro_torch.launch.serve.main`` at full
   width on the paged engine (returns 0, K1 and K2 > 0) and
   ``repro_torch.launch.train.main`` on the smoke config (returns 0,
   finite losses).  An exception in a frontend thread is recorded by
   ``threading.excepthook`` and fails the run at the next drain wait;
   both frontend threads must be gone after ``shutdown``;
9. where one decode window's time goes (``torch.profiler``), on the
   paged and on the slot engine: device time per kernel family against
   the window's wall time, and the top host ops;
10. kernel times at the main path's shapes, beside the plain versions',
   one PyTorch library call's where one computes the same function, and
   the least time the card could take (bytes over 3.35 TB/s or
   operations over 989 TFLOP/s, H100 SXM data sheet).  A time is the
   CUDA-event time of calls queued back to back behind a spin kernel, so
   the host's launch gaps do not count; the span of calls issued one
   after another (gaps included) is printed beside it as ``*_span``, and
   the kernel time ``torch.profiler`` recorded as ``*_profiler`` (it can
   drop kernels on this card).  K1's host cost per launch
   (``host_us``, beside ``torch.matmul``'s) is the host time to issue
   one step's calls, and K2's (``host_us``) the host time a
   ``paged_attention`` call.  K2 on bf16 and int8 pools is timed at the
   qwen decode step (24 layers) and at phi3.5-moe's layout (8 layers), K3
   at the qwen decode step (168 launches, every one on the wgmma route);
   K6 on each
   scenario (one fused launch on
   pre-packed operands against ``sequential_matmul``'s launches, with
   the plain version and ``torch._grouped_mm`` as the yardstick in
   bf16), each path first run once
   with the counters zeroed; K7 at phi3.5-moe's expert shapes at
   capacities 2, 37 and 320 (``torch.bmm`` as the yardstick);
11. ``phi3.5-moe-42b`` at full width, 8 of its 32 layers (all 32 do not
    fit in 80 GB), in bfloat16 with seeded random weights, once the qwen
    model is freed: the same workload through ``make_engine(kind=
    "paged")``, with K1's, K2's and K4's counters zeroed before and > 0
    after, finite logits, ``decode_compiles`` 0, a drained pool, peak
    memory, one profiled decode window, and K4's times at the decode
    (rung 8) and 208-row prefill shapes;
12. ``phi3.5-moe-42b`` training at full width, 2 of its 32 layers (the
    most that fit with AdamW's state), once the serve's model is freed:
    ``Trainer(cfg, TrainerConfig(...)).run()`` for 6 steps of 8 x 256
    synthetic tokens, ``remat="none"``, with K1's, K4's (forward and dX)
    and K5's counters zeroed before and > 0 after and finite losses; the
    median step time, tokens/s and peak memory; one profiled step
    (device time per family: K1, K4 forward, K4 dX, K5, optimizer,
    other, and the idle share); and the times of one step's K1 (forward
    and backward), K4 forward, K4 dX and K5 work beside their plain
    versions, bounds and library calls (``torch._grouped_mm`` for K4 and
    K5).  The serve and the training run must launch K4 and K5 only
    through their wgmma routes.

The line before the last is a JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PROMPT_LENS = (16, 40, 64, 97, 128, 150, 176, 200)
NEW_TOKENS = 32
SHARED_PREFIX = 32
# phi3.5-moe-42b: 8 of its 32 layers at full width fit one 80 GB card
# (about 21 GB of bf16 weights; all 32 layers are about 84 GB).
MOE_LAYERS = 8


def _say(msg: str) -> None:
    print(msg, flush=True)


def _cuda_ms(torch, fn, iters: int = 5, warmup: int = 2) -> float:
    """CUDA-event span of one call of ``fn`` (host launch gaps included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, iters: int = 3, label: str = ""):
    """Device time of one call of ``fn``: the self device time of every
    kernel, copy and fill it ran, from ``torch.profiler``, so the host's
    launch gaps between small kernels do not count.  Where two profiles
    in a row record no device time, None, and the events seen are
    printed.  On the H100 machines this profiler has dropped kernels
    (a sum below the work's bound, or nothing at all), so kernel times
    come from :func:`_queued_ms`; this is kept beside them."""
    from torch.profiler import profile, ProfilerActivity

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evts = prof.key_averages()
        us = sum(_self_device_us(e) for e in evts
                 if "CUDA" in str(getattr(e, "device_type", "")))
        if us > 0:
            return us / 1e3 / iters
    seen = sorted(((e.count, str(getattr(e, "device_type", "")), e.key[:60])
                   for e in evts), reverse=True)[:8]
    _say(f"torch.profiler recorded no device time for {label!r}: "
         f"{len(evts)} event kinds, top {seen}")
    return None


def _self_device_us(evt) -> float:
    return (getattr(evt, "self_device_time_total", 0.0)
            or getattr(evt, "self_cuda_time_total", 0.0))


def _queued_ms(torch, fn, iters: int = 5):
    """Device time of one call of ``fn``: CUDA events around ``iters``
    calls that the host queued behind a spin kernel
    (``torch.cuda._sleep``), so they run back to back without the host's
    launch gaps.  Returns ``(ms, clean)``; ``clean`` is False where the
    device reached the timed calls before the host had queued them all
    (a call that waits for the device, or more launches than the queue
    holds): the time then includes launch gaps."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_s = min(2.0, 0.005 + 2 * iters * (time.perf_counter() - t0))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * 2e9))     # cycles, about 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    clean = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / iters, clean


def _times(torch, fns: dict) -> dict:
    """For each callable: its device time under its key (CUDA events
    around calls queued back to back, :func:`_queued_ms`; ``<key>_gaps``
    is true where launch gaps could not be kept out), the CUDA-event span
    of calls issued one after another (host launch gaps included) under
    ``<key>_span``, and the sum of kernel times ``torch.profiler``
    recorded under ``<key>_profiler`` (None where it recorded none; on
    this card it can drop kernels, so it is a lower bound)."""
    out = {}
    for key, fn in fns.items():
        out[key], clean = _queued_ms(torch, fn)
        if not clean:                   # fewer launches behind the spin
            out[key], clean = _queued_ms(torch, fn, iters=1)
        out[key + "_span"] = _cuda_ms(torch, fn, iters=3)
        out[key + "_profiler"] = _device_ms(torch, fn, label=key)
        if not clean:
            out[key + "_gaps"] = True
    return out


# Each kernel's launch counter name, also a substring of its CUDA symbol.
KERNEL_NAMES = ("sisa_gemm", "paged_attn", "grouped_gemm")
K1_ROWS = (1, 8, 16, 32, 64, 128, 200, 208, 256)
K1_PHI_ROWS = (8, 208)      # phi3.5-moe's 4096-wide projections
BF16_REL = 2.0 ** -7        # one bf16 ulp, relative to the value
# A coalesced prefill runs K1 at M = rung x bucket, a single one at M =
# bucket: other plans, other summation orders, and the difference passes
# through 24 layers.  A parked cache tensor must lie within 2^-4 of its
# largest magnitude (8 bf16 ulps there) of the single prefill's, and a
# first token must equal the single prefill's wherever that prefill's
# top-2 logit margin exceeds 2^-4 of its top logit's magnitude.
COALESCED_REL = 2.0 ** -4


def _f32_atol(ref) -> float:
    """f32 sums of up to 4864 terms in different orders."""
    return 2e-5 * max(1.0, ref.float().abs().max().item())


def _max_err(what, got, ref, rel, atol) -> float:
    """Max abs error of ``got`` against ``ref``; raises unless every
    element holds ``|got - ref| <= rel * |ref| + atol``.  bf16 takes
    ``rel`` = one ulp: the kernel and the plain version sum in f32 in
    different orders (``atol``), then each rounds once."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    bad = ~(diff <= rel * ref.abs() + atol)
    if bad.any():
        i = bad.nonzero()[0].tolist()
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements off, first at {i}: got "
            f"{got[tuple(i)].item()}, plain {ref[tuple(i)].item()} "
            f"(rel {rel}, atol {atol})")
    return diff.max().item()


def _k1_cases(torch, gen, dtype, table, m):
    """(name, A's column count, A's row stride, B) at the main path's
    shapes, then ragged edges: K and N off every tile multiple with
    16-byte aligned rows (strided views: TMA's zero fill on the tensor
    cores), and K = 100, whose rows are not 16-byte aligned (the
    CUDA-core body).  phi3.5-moe's 4096-wide q and k/v projections at
    ``K1_PHI_ROWS``."""
    def rand(*shape):
        return (torch.randn(*shape, device="cuda", generator=gen)
                / shape[0] ** 0.5).to(dtype)

    for k, n in ((896, 896), (896, 128), (896, 4864), (4864, 896)):
        yield f"{k}x{n}", k, k, rand(k, n)
    if m in K1_PHI_ROWS:
        for k, n in ((4096, 4096), (4096, 1024)):
            yield f"phi {k}x{n}", k, k, rand(k, n)
    yield "lm_head 896x153600 trans_b", 896, 896, table.T
    yield "ragged 900x1000", 900, 904, rand(900, 1008)[:, :1000]
    yield "ragged 900x1000 trans_b", 900, 904, rand(1000, 904)[:, :900].T
    yield "unaligned 100x36", 100, 100, rand(100, 36)


def _k1_plans_of(kernels, m, k, n):
    """The launch plans of one bf16 K1 call with aligned rows: one per
    row pass (the ragged residual is its own pass)."""
    return [kernels.k1_plan(hi - lo, n, k) for lo, hi in kernels.row_passes(m)]


def check_k1(torch, kernels, gen) -> float:
    """Every tile height at full height (M = 16, 32, 64, 128, 256), the
    decode rungs 1 and 8, and the ragged main-plus-residual split
    (M = 200 and the 208-row prefill's 128 + 80), each at the main path's
    shapes and the ragged cases.  The bf16 plans reached must cover every
    branch of K1's wgmma body that the main path's shapes use: swap-AB at
    n8 and n16, each cluster size, and each CTA tile."""
    worst, n_cases = 0.0, 0
    reached = set()
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        table = (torch.randn(153600, 896, device="cuda", generator=gen)
                 / 896 ** 0.5).to(dtype)
        for m in K1_ROWS:
            for name, k, lda, b in _k1_cases(torch, gen, dtype, table, m):
                a = torch.randn(m, lda, device="cuda",
                                generator=gen).to(dtype)[:, :k]
                ref = kernels.sisa_gemm_plain(a, b)
                err = _max_err(f"K1 {dtype} M={m} {name}",
                               kernels.sisa_matmul(a, b), ref, rel,
                               _f32_atol(ref))
                worst = max(worst, err)
                n_cases += 1
                if dtype == torch.bfloat16 and k % 8 == 0:
                    reached.update((p.swap_ab, p.bm, p.bn, p.cluster)
                                   for p in _k1_plans_of(kernels, m, k,
                                                         b.shape[1]))
    # qwen's serve (decode rungs, the 208-row prefill), phi's serve and
    # training (2048 rows).
    qwen = ((896, 896), (896, 128), (896, 4864), (4864, 896), (896, 153600))
    phi = ((4096, 4096), (4096, 1024), (4096, 32768))
    main_path = [p for ms, shapes in (((1, 8, 16, 208), qwen),
                                      ((8, 208, 2048), phi))
                 for m in ms for k, n in shapes
                 for p in _k1_plans_of(kernels, m, k, n)]

    def branches(plans):
        return ({("swap", p[1]) for p in plans if p[0]}
                | {("cluster", p[3]) for p in plans}
                | {("tile", p[1], p[2]) for p in plans if not p[0]})

    need = branches([(p.swap_ab, p.bm, p.bn, p.cluster) for p in main_path])
    got = branches(reached)
    if need - got:
        raise AssertionError(f"K1 branches of the main path not checked: "
                             f"{sorted(need - got)}")
    _say(f"k1: {n_cases} cases (M in {K1_ROWS}; main-path shapes and "
         f"ragged edges; f32 and bf16) agree with the plain version (max "
         f"abs err {worst}; elementwise tol f32 2e-5*max|ref|, bf16 "
         f"2^-7*|ref| + 2e-5*max|ref|); bf16 plans reached (swap-AB, bm, bn, "
         f"cluster): {sorted(reached)}")
    return worst


# The libraries whose bf16 bodies run on hopper_gemm.cuh's TMA + wgmma
# mainloop, with the template parameters of their wgmma kernels (K3 runs
# K1's instantiations, in sisa_gemm's library; K6's one kernel switches
# over its group widths at run time).
WGMMA_LIBS = {"sisa_gemm": "NWG, BQ, STAGES, X_MN, Y_MN, SWAP",
              "grouped_gemm": "NWG, BQ, STAGES, X_MN",
              "grouped_dw": "NWG, BQ, STAGES",
              "moe_gemm": "NWG, BQ, STAGES",
              "coexec": ""}


def wgmma_build_report(build) -> None:
    """The libraries of K1 and K3, K4, K5, K6 and K7 as built: ``ptxas -v``
    (registers, shared memory, spills) of each wgmma kernel, and the count of
    ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in each
    library's SASS, which must be > 0; then K2's registers and spills."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    for name, params in WGMMA_LIBS.items():
        lib = build.library_path(name)
        lines = lib.with_suffix(".log").read_text().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "wgmma_kernel" in line:
                args = re.findall(r"L[ib](\d+)E",
                                  line.split("wgmma_kernelI")[-1])
                stats = " ".join(x.split("ptxas info    :")[-1].strip()
                                 for x in lines[i + 1:i + 4]
                                 if "registers" in x or "spill" in x)
                n = params.count(",") + 1
                what = (f"<{params}> = <{', '.join(args[:n])}>" if params
                        else "wgmma kernel")
                _say(f"{name} ptxas {what}: {stats}")
        if not tool.exists():
            _say(f"{name} sass: cuobjdump not in the toolkit; HGMMA/UTMALDG "
                 "not counted")
            continue
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        hgmma, utmaldg = sass.count("HGMMA"), sass.count("UTMALDG")
        _say(f"{name} sass: {hgmma} HGMMA, {utmaldg} UTMALDG, "
             f"{sass.count('UTMASTG')} UTMASTG instructions")
        if not hgmma or not utmaldg:
            raise AssertionError(f"{name}'s library has no wgmma or no TMA "
                                 "load")
    # K2's instantiations (<q, pool, head_dim, int8> as mangled): registers
    # and spills.
    lines = build.library_path("paged_attn").with_suffix(
        ".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "split_kernelI" in line:
            args = line.split("split_kernelI")[-1].split("EEv")[0]
            stats = " ".join(x.split("ptxas info    :")[-1].strip()
                             for x in lines[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            _say(f"paged_attn ptxas <{args}>: {stats}")


def _attn_inputs(torch, gen, dtype, pos, n_pages=128, pmax=16,
                 heads=(14, 2, 64)):
    b = len(pos)
    h, hkv, hd = heads
    q = torch.randn(b, h, hd, device="cuda", generator=gen).to(dtype)
    pk = torch.randn(n_pages + 1, 16, hkv, hd, device="cuda",
                     generator=gen).to(dtype)
    pv = torch.randn(n_pages + 1, 16, hkv, hd, device="cuda",
                     generator=gen).to(dtype)
    perm = torch.randperm(n_pages, device="cuda", generator=gen)
    table = perm[:b * pmax].reshape(b, pmax).to(torch.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    live = torch.arange(pmax, device="cuda")[None, :] <= (pos_t // 16)[:, None]
    table = torch.where(live, table, n_pages)          # sink past pos
    return q, pk, pv, table, pos_t


K2_HEADS = ((14, 2, 64), (32, 8, 128))     # qwen2.5-0.5b, phi3.5-moe-42b


def _k2_cases(torch, kernels, gen, quant):
    """K2 against its plain version at both head layouts, q in f32 and
    bf16, float or int8 pools, 8 rows of 16-page tables: a row at ``pos``
    0 (every split but the first empty), rows ending on a page edge and on
    either side of the first two split edges of the plan the wrapper
    takes, a full row (255), and dead table entries on the sink."""
    worst, edges = 0.0, set()
    for heads in K2_HEADS:
        h, hkv, hd = heads
        for dtype in (torch.float32, torch.bfloat16):
            size = 1 if quant else torch.tensor([], dtype=dtype).element_size()
            plan = kernels.k2_plan(8, h, hkv, hd, 16, 16, size, quant)
            edge = plan.pages_per_split * 16
            edges.add(edge)
            pos = [0, 16, edge - 1, edge, 2 * edge - 1, min(2 * edge, 254),
                   128, 255]
            q, pk, pv, table, pos_t = _attn_inputs(torch, gen, dtype, pos,
                                                   heads=heads)
            pools = _int8_pools(kernels, pk, pv) if quant else (pk, pv)
            rel = 0.0 if dtype == torch.float32 else BF16_REL
            worst = max(worst, _max_err(
                f"K2 {'int8 ' if quant else ''}{heads} {dtype} {plan}",
                kernels.paged_attention(q, pools[0], pools[1], table, pos_t,
                                        *pools[2:]),
                kernels.paged_attention_plain(q, pools[0], pools[1], table,
                                              pos_t, *pools[2:]),
                rel, 1e-5))
    return worst, sorted(edges)


def check_k2(torch, kernels, gen) -> float:
    worst, edges = _k2_cases(torch, kernels, gen, quant=False)
    _say(f"k2: GQA 14/2 hd 64 and GQA 32/8 hd 128, psz 16, f32 and bf16, "
         f"split edges at cells {edges}, pos 0, full rows and sink entries, "
         f"agree with the plain version (max abs err {worst}; elementwise "
         f"tol f32 1e-5, bf16 2^-7*|ref| + 1e-5)")
    return worst


# phi3.5-moe-42b's expert FFN: 16 experts, top-2, d 4096, d_ff 6400.
MOE_D, MOE_FF, MOE_E = 4096, 6400, 16


def _k4_layouts(torch, kernels):
    """(name, m, starts, sizes, gids, bm) at the path's row blocks: the
    rung-8 decode (16 pairs over 16 experts, capacity 8, bm 16), 208-token
    prefills (416 pairs; capacity 32 with bm 32 and the serve's capacity
    40 with bm 64, sizes off the row block, some experts full and some
    empty), each with tail tiles past every segment, and a capacity-
    strided layout whose stride 40 forces ``aligned_block_rows`` to 8."""
    def prefix(sizes, cap, bm):
        sizes = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        starts = kernels.flat_group_offsets(sizes, bm)[:-1]
        m = MOE_E * (-(-cap // bm)) * bm
        return m, starts, sizes, torch.arange(MOE_E, dtype=torch.int32,
                                              device="cuda"), bm

    decode = [2, 0, 1, 1, 0, 2, 3, 0, 1, 1, 2, 0, 1, 1, 1, 0]
    pre32 = [32, 0, 32, 17, 32, 32, 5, 0, 32, 31, 32, 32, 9, 32, 32, 32]
    pre40 = [40, 0, 40, 40, 37, 0, 21, 40, 40, 40, 3, 40, 40, 1, 40, 34]
    bm8 = kernels.aligned_block_rows(40, MOE_FF, MOE_D, torch.bfloat16,
                                     align_to=40)
    ar = torch.arange(MOE_E, dtype=torch.int32, device="cuda")
    yield ("decode rung 8",) + prefix(decode, 8, 16)
    yield ("prefill cap 32",) + prefix(pre32, 32, 32)
    yield ("prefill cap 40",) + prefix(pre40, 40, 64)
    yield ("capacity stride 40",  MOE_E * 40, ar * 40,
           torch.tensor(pre40, dtype=torch.int32, device="cuda"), ar, bm8)


DEAD_DY = 3.0e4     # dy's rows outside every segment: large, finite


def _poison(x, covered, value):
    """``x`` with the rows outside every segment set to ``value``: the
    kernels must not let them reach a live output."""
    return x.masked_fill(~covered[:, None], value)


def _covered(torch, m, starts, sizes):
    covered = torch.zeros(m, dtype=torch.bool, device="cuda")
    for s, n in zip(starts.tolist(), sizes.tolist()):
        covered[s:s + n] = True
    return covered


def _main_routes(torch, kernels):
    """The wgmma routes, ``(counter, bq, nwg, stages)``, that phi3.5-moe's
    serve and training take: K4's forward at the rung-8 decode, a
    208-token prefill and a 2048-token step, K4's dX and K5 at the step,
    each at the row block and flat size the MoE layer picks."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cf = get_config("phi3.5-moe-42b").moe.capacity_factor
    routes = set()
    for tokens in (8, 208, 2048):
        cap = moe._capacity(tokens, MOE_E, 2, cf)
        bm = kernels.flat_block_rows(min(cap, 64), MOE_FF, MOE_D,
                                     torch.bfloat16)
        n_mt = MOE_E * -(-cap // bm)
        names = ("grouped_gemm",) + (("grouped_gemm_dx",) if tokens == 2048
                                     else ())
        for k in (MOE_D, MOE_FF):
            p = kernels.k4_plan(bm, n_mt, k)
            routes |= {(name, p.bq, p.nwg, p.stages) for name in names}
    p = kernels.k5_plan()
    return routes | {("grouped_dw", p.bq, p.nwg, p.stages)}


def _wgmma_routed(routes, before, names) -> None:
    """One more launch of each of ``names`` on a wgmma route than
    ``before``: the case did not take the CUDA-core body."""
    for name in names:
        n = sum(c for r, c in routes.items() if r[0] == name)
        m = sum(c for r, c in before.items() if r[0] == name)
        if n != m + 1:
            raise AssertionError(f"a bf16 {name} launch left the wgmma "
                                 f"route ({m} -> {n})")


def check_k4(torch, kernels, gen) -> float:
    """K4 against its plain version at every layout of ``_k5_layouts``,
    up/gate (4096 -> 6400) and down (6400 -> 4096), f32 and bf16, with
    NaN in x's rows outside every segment; those rows must come out
    exactly 0, and each bf16 case must take the wgmma route."""
    from repro_torch.kernels.grouped_gemm import ROUTE_LAUNCHES

    worst, n_cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        ws = {(k, n): (torch.randn(MOE_E, k, n, device="cuda", generator=gen)
                       / k ** 0.5).to(dtype)
              for k, n in ((MOE_D, MOE_FF), (MOE_FF, MOE_D))}
        for name, m, starts, sizes, gids, bm in _k5_layouts(torch, kernels):
            covered = _covered(torch, m, starts, sizes)
            for (k, n), w in ws.items():
                x = _poison(torch.randn(m, k, device="cuda",
                                        generator=gen).to(dtype),
                            covered, float("nan"))
                before = dict(ROUTE_LAUNCHES)
                got = kernels.segment_grouped_gemm(x, w, starts, sizes, gids,
                                                   block_rows=bm)
                ref = kernels.segment_grouped_gemm_plain(
                    x, w, starts, sizes, gids, block_rows=bm)
                what = f"K4 {dtype} {name} bm {bm} {k}x{n}"
                if dtype == torch.bfloat16:
                    _wgmma_routed(ROUTE_LAUNCHES, before, ("grouped_gemm",))
                worst = max(worst, _max_err(what, got, ref, rel,
                                            _f32_atol(ref)))
                if (got[~covered] != 0).any():
                    raise AssertionError(f"{what}: a row outside every "
                                         "segment is not 0")
                n_cases += 1
    _say(f"k4: {n_cases} cases (decode- and prefill-like expert sizes, "
         f"tail tiles, capacity stride, 2048-token training, shared-gid "
         f"a2a; 4096x6400 and 6400x4096; f32 and bf16; NaN in x's rows "
         f"outside every segment) agree with the plain version (max abs "
         f"err {worst}; elementwise tol f32 2e-5*max|ref|, bf16 "
         f"2^-7*|ref| + 2e-5*max|ref|; uncovered rows exactly 0)")
    return worst


def _k5_layouts(torch, kernels):
    """K4's layouts, a training step's (2048 tokens top-2 over 16 experts,
    capacity 320 at bm 64: sizes off the row block, one expert empty,
    some full), and an ``a2a_segments``-style layout in which each
    expert owns two segments (two source ranks, capacity 40 each, bm 8):
    segments that share a gid are summed by K5."""
    yield from _k4_layouts(torch, kernels)
    train = [256, 0, 320, 301, 257, 63, 320, 190, 255, 320, 1, 320, 288,
             320, 129, 300]
    sizes = torch.tensor(train, dtype=torch.int32, device="cuda")
    yield ("train 2048 tokens cap 320", MOE_E * 320,
           kernels.flat_group_offsets(sizes, 64)[:-1], sizes,
           torch.arange(MOE_E, dtype=torch.int32, device="cuda"), 64)
    recv = [[5, 40, 0, 17, 40, 33, 1, 0, 40, 12, 9, 40, 28, 0, 40, 39],
            [40, 3, 0, 40, 21, 40, 0, 8, 40, 40, 31, 2, 0, 40, 19, 40]]
    ms, cap = 2, 40
    sizes = torch.tensor(recv, dtype=torch.int32, device="cuda").T.reshape(-1)
    gids = torch.arange(MOE_E, dtype=torch.int32,
                        device="cuda").repeat_interleave(ms)
    starts = torch.arange(MOE_E * ms, dtype=torch.int32, device="cuda") * cap
    yield "a2a 2 ranks cap 40", MOE_E * ms * cap, starts, sizes, gids, 8


def check_k4_dx_and_k5(torch, kernels, gen):
    """The backward of ``segment_grouped_gemm`` on the card, at every
    layout of ``_k5_layouts``, up/gate (4096 -> 6400) and down (6400 ->
    4096), f32 and bf16, with NaN in x's rows outside every segment and
    ``DEAD_DY`` in dy's: dX (K4 reading ``w`` transposed) against the
    plain K4 with ``w.transpose(1, 2)``, dW (K5) against
    ``segment_grouped_dw_plain``.  Rows of dX outside every segment and
    dW blocks of groups with no rows must be exactly 0; each bf16 case
    must take both wgmma routes.  Then every route of the main path
    (``_main_routes``) must have been reached, here or in ``check_k4``
    (the route counts start at zero there)."""
    from repro_torch.kernels.grouped_gemm import ROUTE_LAUNCHES

    worst = {"dx": 0.0, "dw": 0.0}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        for k, n in ((MOE_D, MOE_FF), (MOE_FF, MOE_D)):
            w = ((torch.randn(MOE_E, k, n, device="cuda", generator=gen)
                  / k ** 0.5).to(dtype).requires_grad_())
            for name, m, starts, sizes, gids, bm in _k5_layouts(torch,
                                                                 kernels):
                covered = _covered(torch, m, starts, sizes)
                rows = torch.zeros(MOE_E, dtype=torch.long, device="cuda")
                rows.index_add_(0, gids.long(), sizes.long())
                x = _poison(torch.randn(m, k, device="cuda",
                                        generator=gen).to(dtype),
                            covered, float("nan")).requires_grad_()
                dy = _poison(torch.randn(m, n, device="cuda",
                                         generator=gen).to(dtype),
                             covered, DEAD_DY)
                w.grad = None
                before = dict(ROUTE_LAUNCHES)
                kernels.segment_grouped_gemm(x, w, starts, sizes, gids,
                                             block_rows=bm).backward(dy)
                if dtype == torch.bfloat16:
                    _wgmma_routed(ROUTE_LAUNCHES, before,
                                  ("grouped_gemm_dx", "grouped_dw"))
                with torch.no_grad():
                    dx_ref = kernels.segment_grouped_gemm_plain(
                        dy, w.transpose(1, 2), starts, sizes, gids,
                        block_rows=bm)
                    dw_ref = kernels.segment_grouped_dw_plain(
                        x, dy, starts, sizes, gids, MOE_E)
                what = f"{dtype} {name} bm {bm} {k}x{n}"
                worst["dx"] = max(worst["dx"], _max_err(
                    f"K4 dX {what}", x.grad, dx_ref, rel, _f32_atol(dx_ref)))
                worst["dw"] = max(worst["dw"], _max_err(
                    f"K5 {what}", w.grad, dw_ref, rel, _f32_atol(dw_ref)))
                if (x.grad[~covered] != 0).any():
                    raise AssertionError(f"K4 dX {what}: a row outside "
                                         "every segment is not 0")
                if (w.grad[rows == 0] != 0).any():
                    raise AssertionError(f"K5 {what}: a group with no rows "
                                         "has a nonzero block")
                n_cases += 1
            del w
    missing = _main_routes(torch, kernels) - {r for r, c in
                                              ROUTE_LAUNCHES.items() if c}
    if missing:
        raise AssertionError(f"wgmma routes of the main path not checked: "
                             f"{sorted(missing)}")
    _say(f"k4 dX and k5: {n_cases} backward cases (decode, prefill, "
         f"capacity-stride, 2048-token training and shared-gid a2a "
         f"layouts; 4096x6400 and 6400x4096; f32 and bf16; NaN in x's and "
         f"{DEAD_DY} in dy's rows outside every segment) agree with the "
         f"plain versions (max abs err dX {worst['dx']}, dW {worst['dw']}; "
         f"elementwise tol f32 2e-5*max|ref|, bf16 2^-7*|ref| + "
         f"2e-5*max|ref|; uncovered dX rows and empty-group dW blocks "
         f"exactly 0); wgmma launches by route (counter, bq, nwg, stages): "
         f"{sorted(ROUTE_LAUNCHES.items())}")
    return worst


# K1's backward at the training shapes of phi3.5-moe-42b (2048 tokens):
# (K, N) of the attention projections and the untied LM head.
K1_TRAIN = ((MOE_D, MOE_D), (MOE_D, 1024), (MOE_D, 32768))


def check_k1_backward(torch, kernels, gen) -> float:
    """``sisa_matmul``'s backward on the card at 2048 rows: dA = dC @ Bᵀ
    (K1 reading B transposed) and dB = Aᵀ @ dC (M = d_model, contracting
    over the 2048 tokens), for row-major weights and for the LM head read
    as ``table.T`` (its gradient lands on the (vocab, d) table), f32 and
    bf16, against the plain K1."""
    worst, n_cases = 0.0, 0
    rows = 2048
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        for k, n in K1_TRAIN:
            a = torch.randn(rows, k, device="cuda",
                            generator=gen).to(dtype).requires_grad_()
            dc = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
            if n == 32768:          # the LM head: B = table.T, in place
                table = ((torch.randn(n, k, device="cuda", generator=gen)
                          / k ** 0.5).to(dtype).requires_grad_())
                b, leaf, name = table.T, table, "lm_head table.T"
            else:
                b = ((torch.randn(k, n, device="cuda", generator=gen)
                      / k ** 0.5).to(dtype).requires_grad_())
                leaf, name = b, f"{k}x{n}"
            kernels.sisa_matmul(a, b).backward(dc)
            with torch.no_grad():
                da = kernels.sisa_gemm_plain(dc, b.detach().t())
                db = kernels.sisa_gemm_plain(a.detach().t(), dc)
                db = db.t() if leaf is not b else db
            worst = max(worst, _max_err(f"K1 dA {dtype} {name}", a.grad, da,
                                        rel, _f32_atol(da)))
            worst = max(worst, _max_err(f"K1 dB {dtype} {name}", leaf.grad,
                                        db, rel, _f32_atol(db)))
            n_cases += 2
    _say(f"k1 backward: {n_cases} cases (2048 rows; dA via B transposed, "
         f"dB = A^T dC contracting over the tokens; 4096x4096, 4096x1024 "
         f"and the LM head's table.T; f32 and bf16) agree with the plain "
         f"version (max abs err {worst})")
    return worst


def _requests(Request, rng, vocab, lens):
    prompts = [rng.integers(0, vocab, n).astype("int32") for n in lens]
    prompts[2][:SHARED_PREFIX] = prompts[1][:SHARED_PREFIX]
    return [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]


def _small_configs():
    """qwen2.5-0.5b's widths, and phi3.5-moe-42b's layer structure (GQA
    32/8 at head_dim 128, top-2 MoE) at narrow widths with 8 experts,
    each cut to 2 layers and a 4096-token vocabulary, in float32."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig

    qwen = dataclasses.replace(get_config("qwen2.5-0.5b"), n_layers=2,
                               vocab_size=4096, param_dtype="float32")
    phi = dataclasses.replace(get_config("phi3.5-moe-42b"), n_layers=2,
                              d_model=512, d_ff=1024, vocab_size=4096,
                              moe=MoEConfig(n_experts=8, top_k=2),
                              param_dtype="float32")
    return {"qwen2.5-0.5b widths": qwen, "phi3.5-moe structure": phi}


def check_small_model(torch, np, label, cfg) -> None:
    """``cfg`` served on the card (kernels) and on the CPU (plain
    versions) through each engine kind: same weights, same requests,
    same greedy tokens per kind; on the card the slot engine's tokens
    equal the paged engine's (rows are independent in both).  Then the
    same requests through ``ServeFrontend`` over the slot and paged
    engines on the card, submitted out of order from two threads: the
    tokens must equal the CPU offline ``run()``'s (the coalesced
    prefill is bitwise the single one in float32)."""
    from repro_torch.models import init_params
    from repro_torch.serve import make_engine, Request, ServeFrontend

    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = _tree_map(lambda t: t.cuda(), cpu)
    outs = {}
    for kind in ("paged", "slot", "sequential"):
        for params, dev in ((cpu, "cpu"), (gpu, "cuda")):
            eng = make_engine(cfg, params, kind=kind, device=dev,
                              max_slots=4, max_seq=64, page_size=16,
                              window=4)
            rng = np.random.default_rng(1)
            for req in _requests(Request, rng, cfg.vocab_size,
                                 (33, 40, 50, 7, 16)):
                req.max_new_tokens = 12
                eng.submit(req)
            outs[kind, dev] = sorted((c.rid, c.tokens) for c in eng.run())
        if outs[kind, "cpu"] != outs[kind, "cuda"]:
            raise AssertionError(
                f"small model, kind={kind}: card tokens {outs[kind, 'cuda']}"
                f" differ from the CPU's {outs[kind, 'cpu']}")
    if outs["slot", "cuda"] != outs["paged", "cuda"]:
        raise AssertionError("small model: slot tokens on the card differ "
                             "from the paged engine's")
    for kind in ("slot", "paged"):
        eng = make_engine(cfg, gpu, kind=kind, device="cuda", max_slots=4,
                          max_seq=64, page_size=16, window=4)
        reqs = _requests(Request, np.random.default_rng(1), cfg.vocab_size,
                         (33, 40, 50, 7, 16))
        fe = ServeFrontend(eng)
        handles = {}
        start = threading.Barrier(2, timeout=60)

        def submitter(rids):
            start.wait()
            for rid in rids:
                handles[rid] = fe.submit(reqs[rid].prompt, 12, rid=rid)

        threads = [threading.Thread(target=submitter, args=(rids,))
                   for rids in ((4, 2, 0), (3, 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        online = sorted((c.rid, c.tokens) for c in _drain(fe, 300))
        _shutdown(fe)
        if online != outs[kind, "cpu"]:
            raise AssertionError(
                f"small model, ServeFrontend over kind={kind}: card tokens "
                f"{online} differ from the CPU offline run's "
                f"{outs[kind, 'cpu']}")
    _say(f"small model ({label}, 2 layers, f32): {len(outs['paged', 'cpu'])}"
         " requests through the paged, slot and sequential engines, tokens "
         "on the card identical to the CPU plain path, slot == paged; "
         "through ServeFrontend over slot and paged (submitted out of "
         "order from two threads) identical to the CPU offline run")


def check_small_train(torch, np, label, cfg) -> None:
    """One train step of ``cfg`` (float32) on the card (kernels) and on
    the CPU (plain versions), from the same weights and batch: the
    loss, every gradient, AdamW's moments and the parameters after the
    update.  The step is ``loss_and_grads`` then ``apply_updates``, what
    ``make_train_step`` runs with ``accum_steps=1``, split so the
    gradients can be read.  lr 1e-3 with one warmup step makes the
    update about 1e-3 per element, far above the tolerances."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import loss_and_grads

    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = _tree_map(lambda t: t.cuda(), cpu)
    batch = SyntheticLM(cfg, 4, 64, DataConfig(seed=1)).batch(0)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    res = {}
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    for params, dev in ((cpu, "cpu"), (gpu, "cuda")):
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, _, grads = loss_and_grads(params, cfg, b, remat="none")
        grads = _tree_map(lambda g: g.detach().clone(), grads)
        before = [p.detach().clone() for p in _leaves(params)]
        params, state, _ = adamw.apply_updates(params, grads,
                                               adamw.init_state(params), opt)
        res[dev] = (float(loss), list(_leaves(grads)), before,
                    list(_leaves(params)), list(_leaves(state.mu)),
                    list(_leaves(state.nu)),
                    float(adamw.global_norm(grads)))
    launches = {k: c.n for k, c in LAUNCH_COUNTERS.items() if c.n}
    l_cpu, g_cpu, p0, p_cpu, mu_cpu, nu_cpu, norm = res["cpu"]
    l_gpu, g_gpu, _, p_gpu, mu_gpu, nu_gpu, norm_gpu = res["cuda"]
    if not abs(l_gpu - l_cpu) <= 1e-5 * max(1.0, abs(l_cpu)):
        raise AssertionError(f"small train ({label}): loss {l_gpu} on the "
                             f"card, {l_cpu} on the CPU")
    lr1 = float(adamw.cosine_lr(opt, 1))
    clip = min(1.0, opt.grad_clip_norm / (norm + 1e-9))
    # The moments carry the clip factor 1/||g||, a sum of squares over
    # every element taken in another order on each side: their tolerance
    # adds the measured relative difference of the two factors.
    if not abs(norm_gpu - norm) <= 1e-3 * norm:
        raise AssertionError(f"small train ({label}): gradient norm "
                             f"{norm_gpu} on the card, {norm} on the CPU")
    dclip = abs(min(1.0, opt.grad_clip_norm / (norm_gpu + 1e-9)) - clip) \
        / clip
    err = {"grad": 0.0, "mu": 0.0, "nu": 0.0, "param": 0.0}
    firm = total = 0
    for i, (gg, gc) in enumerate(zip(g_gpu, g_cpu)):
        gg = gg.cpu()
        # f32 sums in other orders: 1e-4 of the leaf's largest value.
        scale = max(gc.abs().max().item(), 1e-30)
        err["grad"] = max(err["grad"], _max_err(
            f"small train ({label}) grad", gg, gc, 0.0, 1e-4 * scale) / scale)
        for key, got, want, rel in (
                ("mu", mu_gpu, mu_cpu, 1e-4 + 2 * dclip),
                ("nu", nu_gpu, nu_cpu, 2e-4 + 4 * dclip)):
            sc = max(want[i].abs().max().item(), 1e-30)
            err[key] = max(err[key], _max_err(
                f"small train ({label}) {key}", got[i].cpu(), want[i], 0.0,
                rel * sc) / sc)
        # Adam's first step moves an element by lr * g / (|g| + eps)
        # (plus weight decay): about lr * sign(g).  Where the clipped
        # gradient is at least 1000 eps and four times the leaf's
        # card-vs-CPU difference, both sides take the same step within
        # lr / 1000; elsewhere (rounding-noise gradients) the sign may
        # differ, and the step may be any value up to lr either way.
        dev = (gg - gc).abs().max().item()
        sure = ((gc.abs() >= 4 * dev)
                & (gc.abs() * clip >= 1000 * opt.eps))
        diff = (p_gpu[i].cpu() - p_cpu[i]).abs()
        tol = torch.where(sure, torch.full_like(diff, lr1 / 100 + 1e-6),
                          torch.full_like(diff, 2 * lr1 + 1e-6))
        moved = (p_cpu[i] - p0[i]).abs()
        if (diff > tol).any() or (moved[sure] < lr1 / 2).any():
            raise AssertionError(
                f"small train ({label}) params, leaf {i}: max abs err "
                f"{diff.max().item()} (tol lr/100 + 1e-6 where the gradient "
                f"is firm, 2 lr + 1e-6 elsewhere); smallest firm CPU step "
                f"{moved[sure].min().item() if sure.any() else None}")
        err["param"] = max(err["param"], diff[sure].max().item()
                           if sure.any() else 0.0)
        firm += int(sure.sum())
        total += sure.numel()
    _say(f"small train step ({label}, f32, 4x64 tokens, lr {lr1}): loss "
         f"card {l_gpu} CPU {l_cpu}; {len(g_cpu)} leaves agree: gradients "
         f"(max err {err['grad']} of each leaf's max; tol 1e-4), global "
         f"norm card {norm_gpu} CPU {norm} (clip factors differ by "
         f"{dclip}), AdamW mu ({err['mu']}; tol 1e-4 + 2x that) and nu "
         f"({err['nu']}; tol 2e-4 + 4x that), params "
         f"after the step at the {firm} of {total} elements with a firm "
         f"gradient (max abs err {err['param']}; tol lr/100 + 1e-6 = "
         f"{lr1 / 100 + 1e-6}; each moved by >= lr/2 on the CPU), the rest "
         f"within 2 lr + 1e-6; card launches {json.dumps(launches)}")


def serve_full_width(torch, np, cfg, need, params=None, lens=PROMPT_LENS,
                     kind="paged", absent=(), **engine_kw):
    """Serve the workload of ``lens`` prompts (8 by default) through
    ``make_engine(kind=kind, **engine_kw)`` at ``cfg``'s widths with
    seeded random bf16 weights (``params``, or made here).  Every launch
    counter is zeroed just before the serve; those of ``need`` must be
    > 0 just after and those of ``absent`` 0, every request must be
    prefilled once, and the storage must drain.  Returns the engine, the
    weights, the launch counts and the completions."""
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.kernels.grouped_gemm import ROUTE_LAUNCHES
    from repro_torch.models import init_params
    from repro_torch.models.common import padded_vocab
    from repro_torch.serve import make_engine, Request, validate_stats

    if params is None:
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0)
        torch.cuda.synchronize()
        _say(f"params: {cfg.name} full width, {cfg.n_layers} layers, "
             f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} G "
             f"weights ({torch.cuda.memory_allocated() / 1e9:.2f} GB "
             f"allocated), init {time.perf_counter() - t0:.2f} s")
    eng = make_engine(cfg, params, kind=kind, max_slots=8, max_seq=256,
                      page_size=16, window=8, **engine_kw)
    if kind != "sequential":            # it has no warmup, as in the JAX one
        eng.warmup()
    prefill, prefills = eng.prefill_fn, []

    def counted_prefill(p, batch):
        prefills.append(1)
        return prefill(p, batch)

    eng.prefill_fn = counted_prefill
    reqs = _requests(Request, np.random.default_rng(0), cfg.vocab_size,
                     lens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    ROUTE_LAUNCHES.clear()
    t0 = time.perf_counter()
    for req in reqs:
        eng.submit(req)
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.n for name, c in LAUNCH_COUNTERS.items()}
    routes = _only_wgmma_routes(launches)
    n_prefills = len(prefills)
    peak = torch.cuda.max_memory_allocated()
    validate_stats(eng.stats)
    if n_prefills != len(lens):
        raise AssertionError(f"{n_prefills} prefills for {len(lens)} "
                             "requests")
    if len(outs) != len(lens) or any(
            c.n_tokens != NEW_TOKENS or c.finish_reason != "length"
            for c in outs):
        raise AssertionError("incomplete serve: " + str(
            [(c.rid, c.n_tokens, c.finish_reason) for c in outs]))
    if not all(0 <= t < cfg.vocab_size for c in outs for t in c.tokens):
        raise AssertionError("token outside the vocabulary")
    if any(launches[name] <= 0 for name in need):
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if any(launches[name] for name in absent):
        raise AssertionError(f"{kind} serve launched one of {absent}: "
                             f"{launches}")
    if kind != "sequential" and eng.stats["decode_compiles"] != 0:
        raise AssertionError(f"decode_compiles "
                             f"{eng.stats['decode_compiles']} after warmup")
    ext = eng.stats["engine"]
    if kind == "paged" and ext["pages_shared"] < SHARED_PREFIX // 16:
        raise AssertionError(f"prefix not shared: {ext['pages_shared']}")
    if kind == "paged" and eng.cache.n_free_pages != eng.cache.num_pages:
        raise AssertionError("page pool did not drain")
    if kind != "sequential" and eng.cache.n_free != eng.max_batch:
        raise AssertionError(f"{eng.max_batch - eng.cache.n_free} slots "
                             "did not drain")
    # Finite f32 logits of the expected shape from the same weights.
    logits, _ = eng.prefill_fn(params, {
        "tokens": torch.as_tensor(reqs[0].prompt[None], device="cuda"),
        "last_index": len(reqs[0].prompt) - 1})
    if logits.shape != (1, 1, padded_vocab(cfg.vocab_size)) \
            or logits.dtype != torch.float32 \
            or not torch.isfinite(logits[..., :cfg.vocab_size]).all():
        raise AssertionError(f"bad logits {logits.shape} {logits.dtype}")
    n_tok = sum(c.n_tokens for c in outs)
    summary = {"model": cfg.name, "kind": kind, "layers": cfg.n_layers,
               "requests": len(outs), "tokens": n_tok, "wall_s": wall,
               "tok_per_s": n_tok / wall,
               "ttft_p50_ms": statistics.median(eng.stats["ttft"]) * 1e3,
               "peak_memory_gb": peak / 1e9,
               "decode_compiles": eng.stats["decode_compiles"],
               "decode_steps": eng.stats["decode_steps"],
               "batches": eng.stats["batches"], "rungs": ext.get("rungs"),
               "pages_shared": ext.get("pages_shared"),
               "expert_backend": eng.stats["expert_backend"],
               "kv_pool": ext.get("kv_pool"),
               "coexec_backend": eng.stats["coexec_backend"],
               "backfilled": eng.stats["backfilled"],
               "coexec_steps": len(eng.stats["coexec_tiles"]),
               "prefills": n_prefills, "launches": launches,
               "wgmma_routes": routes}
    _say(f"serve: {json.dumps(summary)}")
    return eng, params, launches, sorted(outs, key=lambda c: c.rid)


def serve_dense(torch, np, cfg, params, paged_outs):
    """Phase 7's dense serves: the 8 requests through ``kind="slot"`` and
    ``kind="sequential"`` on the paged serve's weights (K1 > 0, K2 0,
    slots drained), each one's completions compared with the paged
    serve's (printed); then one ``prefill_batch`` on the slot engine and
    one profiled slot window."""
    for kind in ("sequential", "slot"):        # the slot engine stays
        eng, _, _, outs = serve_full_width(
            torch, np, cfg, ("sisa_gemm",), params=params, kind=kind,
            absent=("paged_attn", "paged_attn_int8"))
        same = sum(a.tokens == b.tokens for a, b in zip(outs, paged_outs))
        _say(f"{kind} serve: {same} of {len(outs)} completions equal the "
             "paged serve's")
    check_prefill_batch(torch, np, eng, cfg)
    profile_window(torch, np, eng, cfg)


def check_prefill_batch(torch, np, eng, cfg) -> None:
    """One ``prefill_batch`` of the 8 prompts on the slot engine (runs of
    one bucket coalesce at a ladder rung): every parked cache and first
    token against the request's single prefill at ``COALESCED_REL``;
    then the parked requests are served and the slots drain."""
    from repro_torch.serve import Request

    eng.reset()
    reqs = _requests(Request, np.random.default_rng(0), cfg.vocab_size,
                     PROMPT_LENS)
    eng.prefill_batch(reqs)
    torch.cuda.synchronize()
    ext = eng.stats["engine"]
    if ext["prefill_batches"] < 1 or len(eng._backfilled) != len(reqs):
        raise AssertionError(f"prefill_batch: {ext['prefill_batches']} "
                             f"batches, {len(eng._backfilled)} parked")
    parked = {r.rid: c for r, c, _ in eng._backfilled}
    worst, same = 0.0, 0
    for req in reqs:
        s = len(req.prompt)
        toks = np.zeros(eng._bucket_len(s), np.int32)
        toks[:s] = req.prompt
        logits, cache = eng.prefill_fn(eng.params, {
            "tokens": torch.as_tensor(toks[None], device="cuda"),
            "last_index": s - 1})
        top = torch.topk(logits[0, -1, :cfg.vocab_size], 2).values
        single = int(torch.argmax(logits[0, -1, :cfg.vocab_size]))
        same += req.generated[0] == single
        if req.generated[0] != single and \
                (top[0] - top[1]).item() > COALESCED_REL * top[0].abs().item():
            raise AssertionError(f"prefill_batch rid {req.rid}: first token "
                                 f"{req.generated[0]}, single prefill's "
                                 f"{single} by margin {top.tolist()}")
        for name, t in cache.items():
            ref = t.float().abs().max().item()
            err = (parked[req.rid][name].float() - t.float()).abs().max()
            worst = max(worst, err.item() / ref)
            if err > COALESCED_REL * ref:
                raise AssertionError(f"prefill_batch rid {req.rid} {name}: "
                                     f"max abs err {err.item()} of {ref}")
    outs = eng.run()
    if len(outs) != len(reqs) or eng.cache.n_free != eng.max_batch:
        raise AssertionError("parked requests did not serve and drain")
    _say(f"prefill_batch (slot engine, bf16): {ext['prefill_batches']} "
         f"coalesced prefills of {ext['prefill_batched_reqs']} of "
         f"{len(reqs)} prompts; parked caches within {worst} of their "
         f"largest magnitude of the single prefills' (tol {COALESCED_REL}); "
         f"{same} of {len(reqs)} first tokens equal")


# An exception in a frontend thread ends that thread (the scheduler's
# ends the serve): each one is recorded here and re-raised in the main
# thread by _drain.
THREAD_ERRORS = []


def _record_thread_error(args) -> None:
    THREAD_ERRORS.append(args)
    _say(f"thread {args.thread.name if args.thread else '?'} raised "
         f"{args.exc_type.__name__}: {args.exc_value}")


def _drain(fe, timeout: float):
    """``fe.drain`` in 5-second waits, failing at once on an exception
    recorded from a frontend thread (or at ``timeout``)."""
    end = time.perf_counter() + timeout
    while True:
        if THREAD_ERRORS:
            err = THREAD_ERRORS[0]
            raise RuntimeError(f"frontend thread {err.thread.name} died: "
                               f"{err.exc_type.__name__}") from err.exc_value
        try:
            return fe.drain(timeout=min(5.0, end - time.perf_counter()))
        except TimeoutError:
            if time.perf_counter() >= end:
                raise


def _shutdown(fe) -> None:
    """Stop the frontend; both of its threads must be gone."""
    fe.shutdown(timeout=60)
    alive = [t.name for t in (fe._scheduler_t, fe._emitter_t)
             if t is not None and t.is_alive()]
    if alive or THREAD_ERRORS:
        raise AssertionError(f"frontend threads alive after shutdown: "
                             f"{alive}; thread errors: {THREAD_ERRORS}")


ONLINE_GAP_S = 0.1     # mean inter-arrival gap of the online serve


def _online(torch, fe, prompts, gaps, on_token=None):
    """Submit ``prompts`` (NEW_TOKENS each) from a separate thread at
    ``gaps`` (request 3 carries ``on_token``) and drain.  Returns the
    handles by rid, the completions and the wall from the first submit
    to the drain's end."""
    handles = {}

    def submitter():
        for rid, (p, gap) in enumerate(zip(prompts, gaps)):
            if rid:
                time.sleep(gap)
            handles[rid] = fe.submit(p, NEW_TOKENS, rid=rid,
                                     on_token=on_token if rid == 3
                                     else None)

    t0 = time.perf_counter()
    thread = threading.Thread(target=submitter, name="submitter")
    thread.start()
    thread.join(60)
    done = _drain(fe, 600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(handles) != len(prompts):
        raise AssertionError(f"{len(handles)} of {len(prompts)} submitted")
    return handles, sorted(done, key=lambda c: c.rid), wall


def serve_online(torch, np, cfg, params):
    """The online serve of full-width qwen2.5-0.5b (bf16): the 8 requests
    through ``ServeFrontend`` over the paged engine of phase 7, submitted
    by a separate thread at seeded exponential gaps (mean 100 ms), one
    with an ``on_token`` callback; then a seeded fault storm on a pool of
    half the pages 8 residents reserve.  Each is checked for K1 and K2
    launches, finish reasons and a drained pool; the offline serve of the
    same requests on the same engine runs first, and the online metrics
    are printed beside it."""
    from torch.profiler import profile, ProfilerActivity

    from repro_torch.distributed.fault import StragglerWatchdog
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.serve import (FaultPlan, make_engine, Request,
                                   ServeFrontend)

    opts = dict(kind="paged", max_slots=8, max_seq=256, page_size=16,
                window=8)

    def reqs():
        return _requests(Request, np.random.default_rng(0), cfg.vocab_size,
                         PROMPT_LENS)

    prompts = [r.prompt for r in reqs()]
    gaps = np.random.default_rng(0).exponential(ONLINE_GAP_S,
                                                size=len(prompts))
    eng = make_engine(cfg, params, **opts)
    eng.warmup()
    for req in reqs():
        eng.submit(req)
    t0 = time.perf_counter()
    offline = sorted(eng.run(), key=lambda c: c.rid)
    torch.cuda.synchronize()
    offline_wall = time.perf_counter() - t0

    fe = ServeFrontend(eng)
    fe.warmup()
    stream = []
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    handles, online, wall = _online(torch, fe, prompts, gaps,
                                    on_token=stream.append)
    launches = {k: c.n for k, c in LAUNCH_COUNTERS.items() if c.n}
    stats, metrics = fe.stats, fe.metrics()
    _shutdown(fe)
    if any(not h.done for h in handles.values()) or any(
            c.finish_reason != "length" or c.n_tokens != NEW_TOKENS
            for c in online):
        raise AssertionError("online serve: " + str(
            [(c.rid, c.n_tokens, c.finish_reason) for c in online]))
    if tuple(stream) != handles[3].result(timeout=1).tokens \
            or tuple(handles[3].tokens) != online[3].tokens:
        raise AssertionError(f"on_token stream {stream} differs from its "
                             f"handle's {handles[3].tokens}")
    if launches.get("sisa_gemm", 0) <= 0 or launches.get("paged_attn", 0) <= 0:
        raise AssertionError(f"online serve skipped a kernel: {launches}")
    if stats["decode_compiles"] != 0:
        raise AssertionError(f"online decode_compiles "
                             f"{stats['decode_compiles']} after warmup")
    # PROMPT_LENS fall in 8 different page-multiple buckets, so the
    # paged engine batches no group (prefill_batches stays 0); every
    # admission still goes through the frontend's coalesced prefill.
    if fe.coalesced_prefills <= 0:
        raise AssertionError("no admission through prefill_batch")
    if eng.cache.n_free_pages != eng.cache.num_pages \
            or eng.cache.reserved_total != 0:
        raise AssertionError("online serve: page pool did not drain")
    n_tok = sum(c.n_tokens for c in online)
    pct = lambda xs, q: float(np.percentile(xs, q)) * 1e3  # noqa: E731
    out = {"requests": len(online), "tokens": n_tok,
           "arrival_gaps_s": float(gaps[1:].sum()), "wall_s": wall,
           "tok_per_s": n_tok / wall,
           "ttft_p50_ms": pct(metrics["ttft"], 50),
           "ttft_p99_ms": pct(metrics["ttft"], 99),
           "tpot_p50_ms": pct(metrics["tpot"], 50),
           "tpot_p99_ms": pct(metrics["tpot"], 99),
           "offline_wall_s": offline_wall,
           "offline_tok_per_s": sum(c.n_tokens for c in offline)
           / offline_wall,
           "offline_ttft_p50_ms": statistics.median(
               [c.ttft for c in offline]) * 1e3,
           "equal_to_offline": sum(a.tokens == b.tokens
                                   for a, b in zip(online, offline)),
           "coalesced_prefills": fe.coalesced_prefills,
           "prefill_batches": stats["engine"]["prefill_batches"],
           "decode_compiles": stats["decode_compiles"],
           "decode_steps": stats["decode_steps"],
           "launches": launches}
    _say(f"online serve (ServeFrontend over paged, seeded arrivals): "
         f"{json.dumps(out)}")

    # The same online serve again, under torch.profiler's device trace
    # only: the card's idle share over the serve's wall.
    fe = ServeFrontend(eng)
    fe.warmup()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, pwall = _online(torch, fe, prompts, gaps)
    _shutdown(fe)
    busy = sum(_self_device_us(e) for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", ""))) / 1e3
    _say(f"online serve profile: wall {pwall * 1e3:.1f} ms, device busy "
         f"{busy:.2f} ms, idle share "
         f"{(1 - busy / (pwall * 1e3)) if busy else None}")

    need = sum(eng._pages_for(r) for r in reqs())
    storm = make_engine(cfg, params, num_pages=need // 2, **opts)
    storm.warmup()
    plan = FaultPlan.random(0, n_events=10, horizon=24)
    fe = ServeFrontend(storm, fault_plan=plan, watchdog=StragglerWatchdog())
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    _, faulted, swall = _online(torch, fe, prompts, np.zeros(len(prompts)))
    launches = {k: c.n for k, c in LAUNCH_COUNTERS.items() if c.n}
    _shutdown(fe)
    reasons = [c.finish_reason for c in faulted]
    c = storm.cache
    leaks = {"free_slots": c.n_free - storm.max_batch,
             "free_pages": c.n_free_pages - c.num_pages,
             "reserved": c.reserved_total, "orphaned": c.orphaned_pages,
             "prefix_entries": len(storm._prefix_registry)
             + len(storm._page_key)}
    if len(faulted) != len(prompts) or any(
            r not in ("length", "cancelled", "deadline") for r in reasons):
        raise AssertionError(f"fault storm: reasons {reasons}")
    if any(leaks.values()):
        raise AssertionError(f"fault storm leaked: {leaks}")
    if not fe.fault_log:
        raise AssertionError("fault storm: no fault fired")
    if launches.get("sisa_gemm", 0) <= 0 or launches.get("paged_attn", 0) <= 0:
        raise AssertionError(f"fault storm skipped a kernel: {launches}")
    survivors = [f for f in faulted if f.finish_reason == "length"]
    out = {"num_pages": c.num_pages, "reserve_of_8": need,
           "fault_log": fe.fault_log,
           "finish_reasons": {r: reasons.count(r) for r in set(reasons)},
           "length_survivors": len(survivors),
           "survivors_equal_to_online": sum(
               f.tokens == online[f.rid].tokens for f in survivors),
           "truncated_prefix_of_online": sum(
               f.tokens == online[f.rid].tokens[:f.n_tokens]
               for f in faulted if f.finish_reason != "length"),
           "preemptions": storm.stats["engine"]["preemptions"],
           "wall_s": swall, "leaks": leaks, "launches": launches}
    _say(f"fault storm (FaultPlan.random(0, n_events=10, horizon=24)): "
         f"{json.dumps(out)}")
    del storm, eng


def run_launchers(torch) -> None:
    """Both launchers in-process on the card: ``launch.serve`` at full
    width on the paged engine (returns 0, K1 and K2 launched), then
    ``launch.train`` on the smoke config (returns 0, finite losses)."""
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.launch import serve, train

    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    buf = StringIO()
    with redirect_stdout(buf):
        rc = serve.main(["--arch", "qwen2.5-0.5b", "--engine", "paged",
                         "--requests", "8"])
    launches = {k: c.n for k, c in LAUNCH_COUNTERS.items() if c.n}
    _say(buf.getvalue().rstrip())
    if rc != 0 or launches.get("sisa_gemm", 0) <= 0 \
            or launches.get("paged_attn", 0) <= 0:
        raise AssertionError(f"launch.serve returned {rc}, launches "
                             f"{launches}")
    buf = StringIO()
    with redirect_stdout(buf):
        rc = train.main(["--arch", "qwen2.5-0.5b", "--smoke", "--steps",
                         "2"])
    _say(buf.getvalue().rstrip())
    m = re.search(r"done: loss (\S+) -> (\S+);", buf.getvalue())
    if rc != 0 or not m or not all(math.isfinite(float(x))
                                   for x in m.groups()):
        raise AssertionError(f"launch.train returned {rc}")
    _say(f"launchers: launch.serve rc 0 with launches {json.dumps(launches)};"
         f" launch.train rc 0, loss {m.group(1)} -> {m.group(2)}")


def _only_wgmma_routes(launches) -> dict:
    """Launches of K4 and K5 by wgmma route (``counter bq nwg stages``);
    raises unless every bf16 launch of a run took one (none fell to the
    CUDA-core bodies)."""
    from repro_torch.kernels.grouped_gemm import ROUTE_LAUNCHES

    for name in ("grouped_gemm", "grouped_gemm_dx", "grouped_dw"):
        routed = sum(c for r, c in ROUTE_LAUNCHES.items() if r[0] == name)
        if routed != launches[name]:
            raise AssertionError(f"{launches[name] - routed} of "
                                 f"{launches[name]} {name} launches left "
                                 "the wgmma route")
    return {" ".join(map(str, r)): c for r, c in sorted(
        ROUTE_LAUNCHES.items())}


def profile_window(torch, np, eng, cfg) -> dict:
    """Where one decode window's time goes at rung 8: device time per
    kernel family from ``torch.profiler`` against the window's wall
    time (the rest of the wall is the host launching work)."""
    from torch.profiler import profile, ProfilerActivity

    from repro_torch.serve import Request

    rng = np.random.default_rng(5)
    for req in _requests(Request, rng, cfg.vocab_size, PROMPT_LENS):
        req.max_new_tokens = 2 * eng.window + 1
        eng.submit(req)
    finished = []
    eng.step(finished)                  # admission, prefills, one window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(finished)              # one decode window, nothing else
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run()
    fam = {"sisa_gemm": 0.0, "paged_attn": 0.0, "grouped_gemm": 0.0,
           "other": 0.0}
    host = []
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            host.append((evt.self_cpu_time_total / 1e3, evt.count, evt.key))
            continue                    # host ops; their kernels count below
        dev_us = _self_device_us(evt)
        name = next((k for k in KERNEL_NAMES if k in evt.key), "other")
        fam[name] += dev_us / 1e3
    busy = sum(fam.values())
    out = {"model": cfg.name, "engine": type(eng).__name__,
           "kv_pool": eng.stats["engine"].get("kv_pool"),
           "window_wall_ms": wall_ms, "steps": eng.window,
           "device_ms": fam, "device_busy_ms": busy,
           "idle_share": (1 - busy / wall_ms) if busy else None,
           "host_ops": sum(n for _, n, _ in host),
           "host_self_ms_top": [[key, round(ms, 3), n] for ms, n, key
                                in sorted(host, reverse=True)[:8]]}
    _say(f"decode window profile (rung 8, {eng.window} steps): "
         f"{json.dumps(out)}")
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _bound_ms(nbytes: float, flops: float):
    from repro_torch.hw import H100_SXM
    t_bytes = nbytes / H100_SXM.hbm_bw
    t_ops = flops / H100_SXM.peak_flops_bf16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _host_us(torch, fns: dict, calls: int) -> dict:
    """Host microseconds per call to issue ``calls`` calls (the best of
    three runs, no synchronisation inside): what a host-bound step pays
    for each launch."""
    out = {}
    for key, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
            torch.cuda.synchronize()
        out[key] = best / calls * 1e6
    return out


def time_k1(torch, kernels, params, cfg, rows: int):
    """All K1 work of one forward at ``rows`` rows: 7 linears x 24
    layers, plus the LM head over ``min(rows, 8)`` rows (decode reads
    logits for every row, prefill for the last token only)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    d = cfg.d_model
    x_d = torch.randn(rows, d, device="cuda", generator=gen).bfloat16()
    x_ff = torch.randn(rows, cfg.d_ff, device="cuda",
                       generator=gen).bfloat16()
    head_rows = rows if rows <= 8 else 1
    x_head = x_d[:head_rows]
    table_t = params["embed"]["table"].T
    gemms = []
    for layer in params["layers"]:
        mix, mlp = layer["mixer"], layer["mlp"]
        gemms += [(x_d, mix["q"]["w"]), (x_d, mix["k"]["w"]),
                  (x_d, mix["v"]["w"]), (x_d, mix["o"]["w"]),
                  (x_d, mlp["gate"]["w"]), (x_d, mlp["up"]["w"]),
                  (x_ff, mlp["down"]["w"])]
    gemms.append((x_head, table_t))

    def run(fn):
        return lambda: [fn(a, b) for a, b in gemms]

    out = _times(torch, {"ms": run(kernels.sisa_matmul),
                         "plain_ms": run(kernels.sisa_gemm_plain),
                         "library_ms": run(torch.matmul)})
    out.update(_host_us(torch, {"host_us": run(kernels.sisa_matmul),
                                "library_host_us": run(torch.matmul)},
                        len(gemms)))
    nbytes = sum(2 * (a.shape[0] * a.shape[1] + b.shape[0] * b.shape[1]
                      + a.shape[0] * b.shape[1]) for a, b in gemms)
    flops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in gemms)
    bound, by = _bound_ms(nbytes, flops)
    return {**out, "bound_ms": bound, "bound_by": by, "gemms": len(gemms),
            "bytes": nbytes, "flops": flops}


def time_k2(torch, kernels, heads=K2_HEADS[0], layers=24, quant=False):
    """One decode step of K2 (a launch a layer) at 8 rows, each at the
    position it reaches at the end of the serve phase: qwen2.5-0.5b's
    layout (14/2 heads, hd 64, 24 layers) unless ``heads``/``layers``
    say otherwise, on bf16 pools or (``quant``) int8 pools; with the host
    microseconds a ``paged_attention`` call."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    pos = [n + NEW_TOKENS - 1 for n in PROMPT_LENS]
    q, pk, pv, table, pos_t = _attn_inputs(torch, gen, torch.bfloat16, pos,
                                           heads=heads)
    scales = ()
    if quant:
        pk, pv, *scales = _int8_pools(kernels, pk, pv)

    def run(fn):
        return lambda: [fn(q, pk, pv, table, pos_t, *scales)
                        for _ in range(layers)]

    out = _times(torch, {"ms": run(kernels.paged_attention),
                         "plain_ms": run(kernels.paged_attention_plain)})
    out.update(_host_us(torch, {"host_us": run(kernels.paged_attention)},
                        layers))
    h, hkv, hd = heads
    cells = sum(p + 1 for p in pos)              # cells this data attends
    kv_cell = hd + 2 if quant else 2 * hd        # int8 + bf16 scale, or bf16
    per_layer = (2 * cells * hkv * kv_cell       # K and V
                 + 2 * 2 * len(pos) * h * hd     # q in, out
                 + 4 * (table.numel() + len(pos)))
    flops = layers * 4 * cells * h * hd
    bound, by = _bound_ms(layers * per_layer, flops)
    return {**out, "library_ms": None, "bound_ms": bound, "bound_by": by,
            "launches_timed": layers, "heads": list(heads)}


def time_k4(torch, kernels, params, cfg, n_tokens: int):
    """All K4 work of one forward over ``n_tokens`` tokens: up, gate and
    down of every layer (3 launches a layer), each layer's expert sizes
    routed by its own router from random hidden states, at the row
    block and flat size the MoE layer picks for that count.  The bound
    counts the weights of the experts that hold rows, the live input
    rows and the whole output; FLOPs count live rows only."""
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(6)
    d, ff = cfg.d_model, cfg.d_ff
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = moe._capacity(n_tokens, e, k, cfg.moe.capacity_factor)
    bm = kernels.flat_block_rows(min(cap, 64), ff, d, torch.bfloat16)
    m_flat = e * (-(-cap // bm)) * bm
    gids = torch.arange(e, dtype=torch.int32, device="cuda")
    calls, nbytes, flops, live = [], 0, 0, []
    for layer in params["layers"]:
        p = layer["moe"]
        h = torch.randn(n_tokens, d, device="cuda", generator=gen)
        topi = torch.topk(torch.softmax(h @ p["router"], -1), k, -1).indices
        sizes = torch.bincount(topi.reshape(-1), minlength=e).clamp(
            max=cap).to(torch.int32)
        offs = kernels.flat_group_offsets(sizes, bm)
        x_d = torch.randn(m_flat, d, device="cuda",
                          generator=gen).bfloat16()
        x_ff = torch.randn(m_flat, ff, device="cuda",
                           generator=gen).bfloat16()
        rows, active = int(sizes.sum()), int((sizes > 0).sum())
        live.append([rows, active])
        for x, w in ((x_d, p["up"]), (x_d, p["gate"]), (x_ff, p["down"])):
            calls.append((x, w, offs, sizes))
            kk, nn = w.shape[1:]
            nbytes += 2 * (active * kk * nn + rows * kk + m_flat * nn)
            flops += 2 * rows * kk * nn

    def run(fn):
        return lambda: [fn(x, w, offs[:-1], sizes, gids, block_rows=bm)
                        for x, w, offs, sizes in calls]

    library, lib_name = _k4_library(torch, kernels, calls, gids, bm)
    out = _times(torch, {"ms": run(kernels.segment_grouped_gemm),
                         "plain_ms": run(kernels.segment_grouped_gemm_plain),
                         "library_ms": library})
    bound, by = _bound_ms(nbytes, flops)
    return {**out, "bound_ms": bound, "bound_by": by, "library": lib_name,
            "launches_timed": len(calls), "tokens": n_tokens,
            "capacity": cap, "bm": bm, "m_flat": m_flat,
            "rows_and_active_experts_per_layer": live, "bytes": nbytes,
            "flops": flops}


def _k4_library(torch, kernels, calls, gids, bm):
    """One PyTorch call per K4 launch that computes the same products:
    ``torch._grouped_mm`` over each expert's aligned region where this
    PyTorch runs it on these shapes and agrees with the plain version on
    the live rows, else a per-expert ``torch.matmul`` loop.  A
    yardstick only; the port never calls either."""
    x, w, offs, sizes = calls[0]
    live = torch.zeros(x.shape[0], dtype=torch.bool, device="cuda")
    for s, n in zip(offs[:-1].tolist(), sizes.tolist()):
        live[s:s + n] = True
    ref = kernels.segment_grouped_gemm_plain(x, w, offs[:-1], sizes, gids,
                                             block_rows=bm)
    try:
        got = torch._grouped_mm(x, w, offs=offs[1:].contiguous())
        _max_err("torch._grouped_mm", got[live], ref[live], BF16_REL,
                 _f32_atol(ref))
        return (lambda: [torch._grouped_mm(x_, w_, offs=o[1:].contiguous())
                         for x_, w_, o, _ in calls]), "torch._grouped_mm"
    except (AttributeError, RuntimeError, AssertionError) as exc:
        _say(f"k4 library: torch._grouped_mm unusable here ({exc}); "
             "timing a per-expert torch.matmul loop instead")
    segs = [[(s, n, g) for s, n, g in zip(o[:-1].tolist(), sz.tolist(),
                                          range(w_.shape[0])) if n]
            for _, w_, o, sz in calls]

    def loop():
        return [[x_[s:s + n] @ w_[g] for s, n, g in seg]
                for (x_, w_, _, _), seg in zip(calls, segs)]
    return loop, "per-expert torch.matmul loop"


# phi3.5-moe-42b training: 2 of its 32 layers at full width fit one 80 GB
# card with AdamW (about 12 bytes per parameter of weights, gradients and
# f32 moments: 2.87 G parameters, 34 GB, plus one leaf's f32
# temporaries and the activations; PERF.md section 4).
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 8, 256, 6
TRAIN_NEED = ("sisa_gemm", "grouped_gemm", "grouped_gemm_dx", "grouped_dw")


def train_full_width(torch, cfg):
    """``Trainer(cfg, TrainerConfig(...)).run()`` for ``TRAIN_STEPS`` steps
    of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` synthetic tokens, ``remat="none"``,
    from seeded random bf16 weights.  Every launch counter is zeroed just
    before the run; K1's, K4's (forward and dX) and K5's must be > 0 just
    after, and every loss finite."""
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.kernels.grouped_gemm import ROUTE_LAUNCHES
    from repro_torch.models import init_params
    from repro_torch.train import Trainer, TrainerConfig

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    _say(f"train params: {cfg.name} full width, {cfg.n_layers} layers, "
         f"{n_params / 1e9:.3f} G weights "
         f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), init "
         f"{time.perf_counter() - t0:.2f} s")
    tcfg = TrainerConfig(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ, remat="none", log_every=1)
    trainer = Trainer(cfg, tcfg, params=params)
    del params
    torch.cuda.reset_peak_memory_stats()
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    ROUTE_LAUNCHES.clear()
    out = trainer.run()
    torch.cuda.synchronize()
    launches = {name: c.n for name, c in LAUNCH_COUNTERS.items()}
    routes = _only_wgmma_routes(launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != TRAIN_STEPS or not all(
            l == l and abs(l) < float("inf") for l in losses):
        raise AssertionError(f"train losses {losses}")
    if any(launches[name] <= 0 for name in TRAIN_NEED):
        raise AssertionError(f"training skipped a kernel: {launches}")
    step_s = statistics.median(h["dt"] for h in out["history"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    summary = {"model": cfg.name, "layers": cfg.n_layers,
               "params_g": n_params / 1e9, "steps": TRAIN_STEPS,
               "tokens_per_step": tokens, "remat": "none", "losses": losses,
               "first_step_s": out["history"][0]["dt"],
               "median_step_s": step_s, "tokens_per_s": tokens / step_s,
               "peak_memory_gb": peak / 1e9,
               "launches": launches, "wgmma_routes": routes,
               "launches_per_step": {k: v / TRAIN_STEPS
                                     for k, v in launches.items() if v}}
    _say(f"train: {json.dumps(summary)}")
    return trainer, out, launches, summary


def _train_family(key: str) -> str:
    if "grouped_dw" in key:
        return "K5"
    if "grouped_gemm" in key:        # TRANS_B = true: the backward's dX
        return "K4 dX" if "true>" in key else "K4 forward"
    return "K1" if "sisa_gemm" in key else "other"


def profile_train_step(torch, trainer, params, opt_state) -> dict:
    """Where one train step's time goes: device time per family (K1, K4
    forward, K4 dX, K5, optimizer, other) from ``torch.profiler`` against
    the step's wall time.  The optimizer's device time is that of one
    ``apply_updates`` on the step's gradients, profiled alone."""
    from torch.profiler import profile, ProfilerActivity

    from repro_torch.optim import adamw
    from repro_torch.train import loss_and_grads

    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in trainer.data.batch(TRAIN_STEPS).items()}
    trainer.step_fn(params, opt_state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, _ = trainer.step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = {"K1": 0.0, "K4 forward": 0.0, "K4 dX": 0.0, "K5": 0.0,
           "other": 0.0}
    for evt in prof.key_averages():
        if "CUDA" in str(getattr(evt, "device_type", "")):
            fam[_train_family(evt.key)] += _self_device_us(evt) / 1e3
    busy = sum(fam.values())
    _, _, grads = loss_and_grads(params, trainer.cfg, batch, remat="none")
    fam["optimizer"] = _device_ms(
        torch, lambda: adamw.apply_updates(params, grads, opt_state,
                                           trainer.opt_cfg), iters=1,
        label="optimizer")
    if fam["optimizer"] is None:
        raise AssertionError("torch.profiler recorded no optimizer time")
    fam["other"] -= fam["optimizer"]
    del grads
    out = {"step_wall_ms": wall_ms, "device_ms": fam,
           "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms}
    _say(f"train step profile ({TRAIN_BATCH}x{TRAIN_SEQ} tokens): "
         f"{json.dumps(out)}")
    return out


def time_train_k1(torch, kernels, params, cfg, rows: int):
    """K1's work in one train step at ``rows`` tokens: the forward GEMMs
    (q, k, v, o of every layer and the untied LM head) and their
    backward (dA = dC Bᵀ with B read transposed, dB = Aᵀ dC with Aᵀ
    read in place), as ``sisa_matmul``'s backward runs them; beside the
    backward, ``at_copy_ms``, the time of the Aᵀ copies that reading Aᵀ
    in place saves."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(rows, cfg.d_model, device="cuda",
                    generator=gen).bfloat16()
    gemms = [(x, layer["mixer"][n]["w"]) for layer in params["layers"]
             for n in ("q", "k", "v", "o")]
    gemms.append((x, params["lm_head"]["table"].T))
    dcs = [torch.randn(rows, b.shape[1], device="cuda",
                       generator=gen).bfloat16() for _, b in gemms]

    def fwd(fn):
        return lambda: [fn(a, b) for a, b in gemms]

    def bwd(fn):
        return lambda: [(fn(dc, b.t()), fn(a.t(), dc))
                        for (a, b), dc in zip(gemms, dcs)]

    out = {}
    for label, run in (("fwd", fwd), ("bwd", bwd)):
        fns = {"ms": run(kernels.sisa_matmul),
               "plain_ms": run(kernels.sisa_gemm_plain),
               "library_ms": run(torch.matmul)}
        if label == "bwd":   # what copying each Aᵀ before dB would add
            fns["at_copy_ms"] = lambda: [a.t().contiguous() for a, _ in gemms]
        t = _times(torch, fns)
        mult = 1 if label == "fwd" else 2
        nbytes = mult * sum(2 * (a.numel() + b.numel() + a.shape[0]
                                 * b.shape[1]) for a, b in gemms)
        flops = mult * sum(2 * a.shape[0] * a.shape[1] * b.shape[1]
                           for a, b in gemms)
        bound, by = _bound_ms(nbytes, flops)
        out[label] = {**t, "bound_ms": bound, "bound_by": by,
                      "gemms": mult * len(gemms)}
    _say(f"k1 train step ({rows} tokens, {len(gemms)} forward GEMMs): "
         f"{json.dumps(out)}")
    return out


def time_train_experts(torch, kernels, params, cfg, n_tokens: int):
    """One train step's K4 forward, K4 dX and K5 work at ``n_tokens``
    tokens: up, gate and down of every layer, each layer's expert sizes
    routed by its own router from random hidden states, at the row block
    and flat size the MoE layer picks; rows outside every segment are 0
    in x and dy, as in the layer.  Bounds: K4 (forward and dX) reads the
    live experts' weights and live input rows and writes the whole
    output; K5 reads the live rows of x and dy and writes every expert's
    dW block; FLOPs count live rows."""
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(9)
    d, ff = cfg.d_model, cfg.d_ff
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = moe._capacity(n_tokens, e, k, cfg.moe.capacity_factor)
    bm = kernels.flat_block_rows(min(cap, 64), ff, d, torch.bfloat16)
    m_flat = e * (-(-cap // bm)) * bm
    gids = torch.arange(e, dtype=torch.int32, device="cuda")
    fwd_calls, dx_calls, dw_calls, live = [], [], [], []
    cost = {"fwd": [0, 0], "dx": [0, 0], "dw": [0, 0]}
    for layer in params["layers"]:
        p = layer["moe"]
        h = torch.randn(n_tokens, d, device="cuda", generator=gen)
        topi = torch.topk(torch.softmax(h @ p["router"], -1), k, -1).indices
        sizes = torch.bincount(topi.reshape(-1), minlength=e).clamp(
            max=cap).to(torch.int32)
        offs = kernels.flat_group_offsets(sizes, bm)
        mask = torch.zeros(m_flat, 1, device="cuda")
        for s0, n in zip(offs[:-1].tolist(), sizes.tolist()):
            mask[s0:s0 + n] = 1

        def rand(cols):
            return (torch.randn(m_flat, cols, device="cuda", generator=gen)
                    * mask).bfloat16()
        x_d, x_ff, dy_d, dy_ff = rand(d), rand(ff), rand(d), rand(ff)
        rows, active = int(sizes.sum()), int((sizes > 0).sum())
        live.append([rows, active])
        for x, dy, w in ((x_d, dy_ff, p["up"]), (x_d, dy_ff, p["gate"]),
                         (x_ff, dy_d, p["down"])):
            kk, nn = w.shape[1:]
            fwd_calls.append((x, w, offs, sizes))
            dx_calls.append((dy, w.transpose(1, 2), offs, sizes))
            dw_calls.append((x, dy, offs, sizes))
            cost["fwd"][0] += 2 * (active * kk * nn + rows * kk + m_flat * nn)
            cost["dx"][0] += 2 * (active * kk * nn + rows * nn + m_flat * kk)
            cost["dw"][0] += 2 * (rows * kk + rows * nn + e * kk * nn)
            for key in cost:
                cost[key][1] += 2 * rows * kk * nn

    def run_k4(fn, calls):
        return lambda: [fn(a, w, offs[:-1], sizes, gids, block_rows=bm)
                        for a, w, offs, sizes in calls]

    def run_dw(fn):
        return lambda: [fn(x, dy, offs[:-1], sizes, gids, e)
                        for x, dy, offs, sizes in dw_calls]

    # K5 as the backward runs it: on the tile table the forward built
    # (here built once, outside the timed calls).
    from repro_torch.kernels.grouped_gemm import _launch_dw, _tile_metadata
    metas = [_tile_metadata(offs[:-1], sizes, gids, m_flat // bm, bm)
             for _, _, offs, sizes in dw_calls]

    def run_k5():
        return [_launch_dw(x, dy, meta, bm, e)
                for (x, dy, _, _), meta in zip(dw_calls, metas)]

    k4 = {}
    for key, calls in (("fwd", fwd_calls), ("dx", dx_calls)):
        library, lib_name = _k4_library(torch, kernels, calls, gids, bm)
        k4[key] = _times(torch, {
            "ms": run_k4(kernels.segment_grouped_gemm, calls),
            "plain_ms": run_k4(kernels.segment_grouped_gemm_plain, calls),
            "library_ms": library})
        k4[key].update(zip(("bound_ms", "bound_by"), _bound_ms(*cost[key])))
        k4[key]["library"] = lib_name
    library, lib_name = _k5_library(torch, kernels, dw_calls, gids, e)
    dw = _times(torch, {"ms": run_k5,
                        "plain_ms": run_dw(kernels.segment_grouped_dw_plain),
                        "library_ms": library})
    dw.update(zip(("bound_ms", "bound_by"), _bound_ms(*cost["dw"])))
    dw["library"] = lib_name
    common = {"launches_timed": len(dw_calls), "tokens": n_tokens,
              "capacity": cap, "bm": bm, "m_flat": m_flat,
              "rows_and_active_experts_per_layer": live}
    out = {f"k4_{key}": {**k4[key], **common, "bytes": cost[key][0],
                         "flops": cost[key][1]} for key in k4}
    out["k5"] = {**dw, **common, "bytes": cost["dw"][0],
                 "flops": cost["dw"][1]}
    _say(f"k4 forward, train step ({n_tokens} tokens, {len(fwd_calls)} "
         f"launches): {json.dumps(out['k4_fwd'])}")
    _say(f"k4 dX, train step ({n_tokens} tokens, {len(dx_calls)} launches): "
         f"{json.dumps(out['k4_dx'])}")
    _say(f"k5, train step ({n_tokens} tokens, {len(dw_calls)} launches): "
         f"{json.dumps(out['k5'])}")
    return out


def _k5_library(torch, kernels, calls, gids, e):
    """One PyTorch call per K5 launch that computes the same dW:
    ``torch._grouped_mm`` of xᵀ and dy grouped along the contraction
    (2-D x 2-D, each expert's aligned region one group; rows outside
    every segment are 0), where this PyTorch runs it and agrees with the
    plain version, else a per-expert ``torch.matmul`` loop.  A yardstick
    only; the port never calls either."""
    x, dy, offs, sizes = calls[0]
    ref = kernels.segment_grouped_dw_plain(x, dy, offs[:-1], sizes, gids, e)
    try:
        got = torch._grouped_mm(x.t(), dy, offs=offs[1:].contiguous())
        _max_err("torch._grouped_mm (dW)", got, ref, BF16_REL,
                 _f32_atol(ref))
        return (lambda: [torch._grouped_mm(x_.t(), dy_,
                                           offs=o[1:].contiguous())
                         for x_, dy_, o, _ in calls]), "torch._grouped_mm"
    except (AttributeError, RuntimeError, AssertionError) as exc:
        _say(f"k5 library: torch._grouped_mm unusable here ({exc}); timing "
             "a per-expert torch.matmul loop instead")
    segs = [[(s, n, g) for s, n, g in zip(o[:-1].tolist(), sz.tolist(),
                                          range(e))]
            for _, _, o, sz in calls]

    def loop():
        return [[x_[s:s + n].t() @ dy_[s:s + n] for s, n, g in seg]
                for (x_, dy_, _, _), seg in zip(calls, segs)]
    return loop, "per-expert torch.matmul loop"


# ---------------------------------------------------------------------------
# The fourth slice: K2 on int8 pools, K3 (split-K), K6 (co-execution) and
# K7 (the capacity MoE GEMM).
# ---------------------------------------------------------------------------
def _drive(torch, name, fn) -> int:
    """Run ``fn`` (a path through kernel ``name``'s entry point) once
    with every launch counter zeroed just before; the kernel's count
    just after, which must be > 0."""
    from repro_torch.kernels import LAUNCH_COUNTERS
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    fn()
    torch.cuda.synchronize()
    n = LAUNCH_COUNTERS[name].n
    if n <= 0:
        raise AssertionError(f"{name}: its path launched it no time")
    return n


def _int8_pools(kernels, pk, pv):
    (pk8, pks), (pv8, pvs) = (kernels.quantize_page_pool(pk),
                              kernels.quantize_page_pool(pv))
    return pk8, pv8, pks, pvs


def check_k2_int8(torch, kernels, gen) -> float:
    """K2 on int8 pools made by ``quantize_page_pool``, against its plain
    version, at the cases of :func:`_k2_cases`."""
    worst, edges = _k2_cases(torch, kernels, gen, quant=True)
    _say(f"k2 int8: GQA 14/2 hd 64 and GQA 32/8 hd 128, psz 16, int8 pools "
         f"with bf16 scale planes, q in f32 and bf16, split edges at cells "
         f"{edges}, pos 0, full rows and sink entries, agree with the plain "
         f"version (max abs err {worst}; elementwise tol f32 1e-5, bf16 "
         f"2^-7*|ref| + 1e-5)")
    return worst


# K3 at qwen's decode GEMV shapes (M 8 and 16; K x N) at the slab depths
# of K3_SLABS (clusters of 7, 4 and 2 at K 896, 8 and 4 at K 4864); K 896
# in slabs of 256 is the timed decode step's setup, 3.5 slabs, the last
# rank's run cut at K.  Then one-stage slabs, a cut last slab at K 4864
# (slabs of 384), three taller passes on K1's normal tiles; then ragged
# edges and slabs that are not whole stages, which take the CUDA-core
# route.
K3_SHAPES = ((896, 896), (896, 128), (896, 4864), (4864, 896))
K3_SLABS = {896: (128, 256, 448), 4864: (256, 1216)}
K3_BK = 256                     # slab depth of the timed decode step


def check_k3(torch, kernels, gen) -> float:
    sg = sys.modules["repro_torch.kernels.sisa_gemm"]
    worst, n_cases, timed_setup = 0.0, 0, 0
    clusters = set()
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        cases = [(m, k, n, bk) for m in (8, 16) for k, n in K3_SHAPES
                 for bk in K3_SLABS[k]]
        cases += [(8, 896, 896, 64), (8, 4864, 896, 384),
                  (40, 896, 896, 128), (40, 896, 4864, 256),
                  (130, 4864, 896, 256)]
        ragged = [(13, 904, 1000, 200), (13, 900, 1000, 256)]
        for m, k, n, bk in cases + ragged:
            a = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
            b = (torch.randn(k, n, device="cuda", generator=gen)
                 / k ** 0.5).to(dtype)
            cfg = kernels.BlockConfig(
                kernels.choose_block_config(m, n, k).bm, bk=bk)
            ref = kernels.sisa_gemm_splitk_plain(a, b, bk).sum(0).to(dtype)
            before = (sg.SPLITK_LAUNCHES.n, sg.SPLITK_CORE_LAUNCHES.n)
            got = kernels.sisa_gemm_splitk(a, b, cfg)
            wgmma = sg.SPLITK_LAUNCHES.n - before[0]
            core = sg.SPLITK_CORE_LAUNCHES.n - before[1]
            want = dtype == torch.bfloat16 and (m, k, n, bk) in cases
            if (wgmma, core) != (int(want), int(not want)):
                raise AssertionError(f"K3 {dtype} M={m} K={k} N={n} bk={bk}: "
                                     f"{wgmma} wgmma and {core} CUDA-core "
                                     f"launches")
            if wgmma:
                plan = kernels.k3_plan(m, n, k, bk)
                clusters.add(plan.cluster)
                slices = sg.plan_k_slices(plan, k)
                if (k, bk) == (896, K3_BK) and m <= 16:
                    # The timed step's setup: 4 ranks, the last one's run
                    # cut to K's last 2 of its 4 stages.
                    if plan.cluster != 4 or slices[-1] != (768, 896):
                        raise AssertionError(f"K3 M={m} N={n}: plan {plan}")
                    timed_setup += 1
            worst = max(worst, _max_err(
                f"K3 {dtype} M={m} K={k} N={n} bk={bk}", got, ref, rel,
                _f32_atol(ref)))
            n_cases += 1
    if timed_setup != 6:
        raise AssertionError(f"K3: {timed_setup} wgmma cases at K 896 in "
                             f"slabs of {K3_BK}, not 6")
    _say(f"k3: {n_cases} cases (M 8 and 16 at qwen's decode GEMV shapes at "
         f"the slab depths {K3_SLABS}, among them the timed step's K 896 in "
         f"slabs of {K3_BK} on clusters of 4 with the last run cut at K; "
         f"one-stage slabs, a cut last slab at K 4864, M 40 and 130 on "
         f"normal tiles; ragged M/N/K and slab tails on the CUDA-core route; "
         f"f32 and bf16) agree with the plain version (max abs err {worst}; "
         f"elementwise tol f32 2e-5*max|ref|, bf16 2^-7*|ref| + "
         f"2e-5*max|ref|); bf16 wgmma launches at clusters "
         f"{sorted(clusters)}")
    return worst


# K7 at phi3.5-moe-42b's expert shapes, with the decode capacity (2 rows
# an expert at rung 8), a ragged one and the 2,048-token training
# capacity (320).
K7_CAPS = (2, 37, 320)


def check_k7(torch, kernels, gen) -> float:
    worst, n_cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        shapes = [(MOE_E, c, d, f) for d, f in ((MOE_D, MOE_FF),
                                                (MOE_FF, MOE_D))
                  for c in K7_CAPS] + [(3, 5, 36, 70)]
        for e, c, d, f in shapes:
            x = torch.randn(e, c, d, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(e, d, f, device="cuda", generator=gen)
                 / d ** 0.5).to(dtype)
            ref = kernels.moe_grouped_gemm_plain(x, w)
            worst = max(worst, _max_err(
                f"K7 {dtype} E={e} C={c} d={d} f={f}",
                kernels.moe_grouped_gemm(x, w), ref, rel, _f32_atol(ref)))
            n_cases += 1
            del x, w, ref
    _say(f"k7: {n_cases} cases (E 16, d 4096 -> 6400 and back, C in "
         f"{K7_CAPS}; a ragged C/d/f; f32 and bf16) agree with the plain "
         f"version (max abs err {worst}; elementwise tol f32 2e-5*max|ref|, "
         f"bf16 2^-7*|ref| + 2e-5*max|ref|)")
    return worst


def _k6_scenarios():
    """The four tenant sets of ``benchmarks/multi_tenant_bench.py::
    _scenarios`` at their full sizes, on Qwen2.5-0.5B's Table 2 widths:
    (m, n, k) per tenant (the LM head is shared and batchable, so
    left out)."""
    from repro_torch.core import TABLE2

    layers = [ly for ly in TABLE2["Qwen2.5-0.5B"].layers
              if ly.name != "lm_head"]
    return {
        "decode_batch": [(4, ly.n, ly.k) for _ in range(16) for ly in layers],
        "narrow_proj": [(8, 128, 896)] * 32,
        "moe_dispatch": [(m, 4864, 896) for m in
                         (3, 16, 1, 9, 12, 2, 16, 5, 7, 1, 14, 4, 10, 6, 2,
                          8)],
        "mixed_serving": [(16, ly.n, ly.k) for ly in layers]
        + [(s, ly.n, ly.k) for s in (12, 40, 100, 150) for ly in layers],
    }


def _k6_case(torch, kernels, gen, shapes, dtype):
    """Operands and the plan of one scenario, its tasks in the packer's
    placement order (``coexec_tile_sequence(pack_requests(...))``)."""
    from repro_torch.core import coexec_tile_sequence, pack_requests
    from repro_torch.core.multi import GemmRequest

    reqs = [GemmRequest(rid=i, m=m, n=n, k=k)
            for i, (m, n, k) in enumerate(shapes)]
    order = coexec_tile_sequence(pack_requests(reqs),
                                 rids=[r.rid for r in reqs])
    xs = [torch.randn(m, k, device="cuda", generator=gen).to(dtype)
          for m, n, k in shapes]
    ws = [(torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5)
          .to(dtype) for m, n, k in shapes]
    tenants = [kernels.CoexecTenant(rid=i, m=m, n=n, k=k)
               for i, (m, n, k) in enumerate(shapes)]
    plan = kernels.build_coexec_plan(tenants, dtype, order=order,
                                     device="cuda")
    return xs, ws, plan, order


def _k6_column(plan, field: str):
    """One field of a bf16 plan's CTA rows (``k6_plan``)."""
    co = sys.modules["repro_torch.kernels.coexec"]
    return plan.groups[:, co.K6_FIELDS.index(field)]


def _k6_groups(plan) -> int:
    """Tile groups of a plan's bf16 CTA rows: rank-0 rows."""
    return int((_k6_column(plan, "rank") == 0).sum())


def _k6_widths(plan):
    """The wgmma widths of a plan's bf16 CTA rows."""
    return sorted(set(_k6_column(plan, "width").tolist()))


def check_k6(torch, kernels, gen) -> float:
    """K6 on each scenario in f32 and bf16: the fused launch against its
    plain version, the rows past each tenant's m (inside its blocks)
    exactly 0, and fused equal to ``sequential_matmul`` bit for bit."""
    worst = 0.0
    for name, shapes in _k6_scenarios().items():
        for dtype in (torch.float32, torch.bfloat16):
            xs, ws, plan, _ = _k6_case(torch, kernels, gen, shapes, dtype)
            a, b = kernels.pack_operands(plan, xs, ws)
            out = kernels.run_plan(plan, a, b)
            ref = kernels.run_plan_plain(plan, a, b)
            rel = 0.0 if dtype == torch.float32 else BF16_REL
            worst = max(worst, _max_err(f"K6 {name} {dtype}", out, ref, rel,
                                        _f32_atol(ref)))
            for off, t in zip(plan.row_offsets, plan.tenants):
                end = off + -(-t.m // plan.bm) * plan.bm
                cols = -(-t.n // plan.bn) * plan.bn
                if torch.count_nonzero(out[off + t.m:end, :cols]):
                    raise AssertionError(f"K6 {name} {dtype}: padding rows "
                                         f"of tenant {t.rid} not 0")
            del a, b, ref
            fused = kernels.unpack_outputs(plan, out)
            serial = kernels.sequential_matmul(xs, ws, plan=plan)
            bad = [i for i, (f, s_) in enumerate(zip(fused, serial))
                   if not torch.equal(f, s_)]
            if bad:
                raise AssertionError(f"K6 {name} {dtype}: fused differs from "
                                     f"sequential for tenants {bad}")
            where = (f"{_k6_groups(plan)} tile groups of widths "
                     f"{_k6_widths(plan)} on {len(plan.groups)} CTAs "
                     f"(clusters of {plan.k6_cluster})"
                     if plan.groups is not None else "one block a task")
            _say(f"k6 {name} {dtype}: {len(shapes)} tenants, "
                 f"{plan.n_tasks} tasks (bm {plan.bm}), {where}; fused == "
                 f"sequential bit for bit")
            del xs, ws, out, fused, serial
    _say(f"k6: 4 scenarios x f32/bf16 agree with the plain version (max abs "
         f"err {worst}; elementwise tol f32 2e-5*max|ref|, bf16 2^-7*|ref| + "
         f"2e-5*max|ref|); padding rows exactly 0")
    return worst


def serve_int8(torch, np, kernels, cfg, params, flt_eng, flt_outs):
    """The 8-request serve on int8 page pools: K2's int8 variant (and
    not its float one) on every decode step, the pools' resident bytes
    (hd + 2) / (2 hd) of the bf16 serve's, and one K2 launch on the
    serve's own pools after its last window against the plain
    version."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    eng, _, launches, outs = serve_full_width(
        torch, np, cfg, ("sisa_gemm", "paged_attn_int8"), params=params,
        kv_quant="int8")
    if launches["paged_attn"]:
        raise AssertionError(f"int8 serve launched float K2: {launches}")
    table = eng.cache.table.numel() * eng.cache.table.element_size()
    q8, flt = (e.cache.resident_bytes() - table for e in (eng, flt_eng))
    hd = cfg.resolved_head_dim
    if q8 * 2 * hd != flt * (hd + 2):
        raise AssertionError(f"int8 pools {q8} B vs bf16 pools {flt} B: not "
                             f"(hd + 2) / (2 hd)")
    differ = sum(a.tokens != b.tokens for a, b in zip(outs, flt_outs))
    profile_window(torch, np, eng, cfg)
    pools = {k: v[0] for k, v in eng.cache.pools.items()}
    n_pages = pools["pk"].shape[0] - 1
    pos = [0, 15, 16, 31, 32, 127, 128, 255]
    pmax = eng.cache.max_pages_per_slot
    pages = torch.randperm(n_pages, device="cuda", generator=gen)
    tbl = pages[:len(pos) * pmax].reshape(len(pos), pmax).to(torch.int32)
    q = torch.randn(len(pos), cfg.n_heads, hd, device="cuda",
                    generator=gen).bfloat16()
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    args = (q, pools["pk"], pools["pv"], tbl, pos_t, pools["pk_s"],
            pools["pv_s"])
    err = _max_err("K2 int8 on the serve's pools",
                   kernels.paged_attention(*args),
                   kernels.paged_attention_plain(*args), BF16_REL, 1e-5)
    out = {"resident_bytes_int8_pools": q8, "resident_bytes_bf16_pools": flt,
           "ratio": q8 / flt, "expected": (hd + 2) / (2 * hd),
           "completions_differing_from_bf16_pools": differ,
           "of": len(outs), "serve_pool_check_max_abs_err": err}
    _say(f"int8 serve: {json.dumps(out)}")
    return eng, launches, err


def serve_coexec(torch, np, cfg, params):
    """16 requests on 8 slots, so the queue is non-empty at window
    boundaries, with and without ``coexec_backend="kernel"``: the
    co-scheduled prefills run as backfill, the tokens do not change."""
    lens = PROMPT_LENS + PROMPT_LENS[::-1]
    need = ("sisa_gemm", "paged_attn")
    eng0, _, _, plain = serve_full_width(torch, np, cfg, need, params=params,
                                         lens=lens)
    del eng0
    eng, _, launches, outs = serve_full_width(
        torch, np, cfg, need, params=params, lens=lens,
        coexec_backend="kernel")
    if [c.tokens for c in outs] != [c.tokens for c in plain]:
        raise AssertionError("coexec serve tokens differ from the serve "
                             "without co-execution")
    st = eng.stats
    if st["backfilled"] <= 0 or not st["coexec_tiles"]:
        raise AssertionError(f"no backfill: backfilled {st['backfilled']}, "
                             f"coexec_tiles {st['coexec_tiles']}")
    _say(f"coexec serve: {len(outs)} requests token-identical to the serve "
         f"without co-execution; backfilled {st['backfilled']}, packed "
         f"prefills {st['packed_prefills']}, coexec_tiles "
         f"{st['coexec_tiles']}, coexec_interleave "
         f"{st['coexec_interleave']}")
    return launches


def time_k2_int8(torch, kernels, heads=K2_HEADS[0], layers=24):
    """:func:`time_k2` on int8 pools (``quantize_page_pool``)."""
    return time_k2(torch, kernels, heads, layers, quant=True)


def time_k3(torch, kernels, params, cfg, rows: int = 8):
    """K3 on one qwen2.5-0.5b decode step's projections (7 a layer x 24,
    rung 8), slabs of ``K3_BK``; its path run is one such step, which
    must take the wgmma route only: one launch a GEMM (the partials'
    route added a sum and a cast to each)."""
    sg = sys.modules["repro_torch.kernels.sisa_gemm"]
    gen = torch.Generator(device="cuda").manual_seed(10)
    xs = {}                                     # one activation per K

    def act(w):
        if w.shape[0] not in xs:
            xs[w.shape[0]] = torch.randn(rows, w.shape[0], device="cuda",
                                         generator=gen).bfloat16()
        return xs[w.shape[0]], w

    gemms = [act(layer[part][n]["w"]) for layer in params["layers"]
             for part, n in (("mixer", "q"), ("mixer", "k"), ("mixer", "v"),
                             ("mixer", "o"), ("mlp", "gate"), ("mlp", "up"),
                             ("mlp", "down"))]
    cfg = kernels.BlockConfig(kernels.choose_block_config(rows, 0, 0).bm,
                              bk=K3_BK)

    def run(fn):
        return lambda: [fn(a, b) for a, b in gemms]

    def plain(a, b):
        return kernels.sisa_gemm_splitk_plain(a, b, K3_BK).sum(0).to(a.dtype)

    step = run(lambda a, b: kernels.sisa_gemm_splitk(a, b, cfg))
    launches = _drive(torch, "sisa_gemm_splitk", step)
    if launches != len(gemms) or sg.SPLITK_CORE_LAUNCHES.n:
        raise AssertionError(f"K3's decode step: {launches} wgmma and "
                             f"{sg.SPLITK_CORE_LAUNCHES.n} CUDA-core launches "
                             f"for {len(gemms)} GEMMs")
    out = _times(torch, {"ms": step, "plain_ms": run(plain),
                         "library_ms": run(torch.matmul)})
    nbytes = sum(2 * (a.numel() + b.numel() + a.shape[0] * b.shape[1])
                 for a, b in gemms)
    flops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in gemms)
    bound, by = _bound_ms(nbytes, flops)
    return {**out, "bound_ms": bound, "bound_by": by, "gemms": len(gemms),
            "bk": K3_BK, "launches": launches,
            "clusters": sorted({kernels.k3_plan(a.shape[0], b.shape[1],
                                                a.shape[1], K3_BK).cluster
                                for a, b in gemms})}


def time_k7(torch, kernels, cap: int):
    """K7 at phi3.5-moe-42b's expert shapes (E 16, up and gate 4096 ->
    6400, down 6400 -> 4096; random bf16 weights) at capacity ``cap``;
    its path run is those 3 launches."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    w_in = [(torch.randn(MOE_E, MOE_D, MOE_FF, device="cuda", generator=gen)
             / MOE_D ** 0.5).bfloat16() for _ in range(2)]
    w_dn = (torch.randn(MOE_E, MOE_FF, MOE_D, device="cuda", generator=gen)
            / MOE_FF ** 0.5).bfloat16()
    x_d = torch.randn(MOE_E, cap, MOE_D, device="cuda",
                      generator=gen).bfloat16()
    x_ff = torch.randn(MOE_E, cap, MOE_FF, device="cuda",
                       generator=gen).bfloat16()
    calls = [(x_d, w_in[0]), (x_d, w_in[1]), (x_ff, w_dn)]

    def run(fn):
        return lambda: [fn(x, w) for x, w in calls]

    launches = _drive(torch, "moe_gemm", run(kernels.moe_grouped_gemm))
    out = _times(torch, {"ms": run(kernels.moe_grouped_gemm),
                         "plain_ms": run(kernels.moe_grouped_gemm_plain),
                         "library_ms": run(torch.bmm)})
    nbytes = sum(2 * (x.numel() + w.numel() + x.shape[0] * x.shape[1]
                      * w.shape[2]) for x, w in calls)
    flops = sum(2 * x.shape[0] * x.shape[1] * x.shape[2] * w.shape[2]
                for x, w in calls)
    bound, by = _bound_ms(nbytes, flops)
    return {**out, "bound_ms": bound, "bound_by": by, "capacity": cap,
            "launches": launches}


def _k6_library(torch, kernels, plan, a, b, ref):
    """``torch._grouped_mm`` on the flat A with the tenants' row
    offsets, where this PyTorch runs it and agrees with the plain
    version, else a per-tenant ``torch.matmul`` loop.  A yardstick only;
    the port never calls either."""
    ends = torch.tensor(list(plan.row_offsets[1:]) + [plan.m_flat],
                        dtype=torch.int32, device="cuda")
    try:
        got = torch._grouped_mm(a, b, offs=ends)
        for g, r in zip(kernels.unpack_outputs(plan, got),
                        kernels.unpack_outputs(plan, ref)):
            _max_err("torch._grouped_mm (K6)", g, r, BF16_REL,
                     _f32_atol(ref))
        return (lambda: torch._grouped_mm(a, b, offs=ends)), \
            "torch._grouped_mm"
    except (AttributeError, RuntimeError, AssertionError) as exc:
        _say(f"k6 library: torch._grouped_mm unusable here ({exc}); timing "
             "a per-tenant torch.matmul loop instead")
    spans = [(off, t.m, t.k, t.n, i) for i, (off, t) in
             enumerate(zip(plan.row_offsets, plan.tenants))]
    return (lambda: [a[o:o + m, :k] @ b[i, :k, :n]
                     for o, m, k, n, i in spans]), "per-tenant torch.matmul"


def time_k6(torch, kernels, name: str, dtype, plain: bool):
    """One scenario's placement: K6's one launch on pre-packed operands
    (``run_plan``) against ``sequential_matmul``'s T launches (each on
    its own pre-packed single-tenant operands), the plain version
    (``plain``) and the library yardstick.  The bound counts the live
    bytes (each tenant's A, weight and C once, not the padded stack)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    shapes = _k6_scenarios()[name]
    xs, ws, plan, _ = _k6_case(torch, kernels, gen, shapes, dtype)
    a, b = kernels.pack_operands(plan, xs, ws)
    singles = kernels.single_tenant_plans(plan, dtype)
    packed = [kernels.pack_operands(sp, [x], [w])
              for sp, x, w in zip(singles, xs, ws)]
    del xs, ws
    fns = {"ms": lambda: kernels.run_plan(plan, a, b),
           "sequential_ms": lambda: [kernels.run_plan(sp, a_, b_) for sp,
                                     (a_, b_) in zip(singles, packed)]}
    if plain:
        fns["plain_ms"] = lambda: kernels.run_plan_plain(plan, a, b)
    lib, lib_name = (None, None)
    if dtype == torch.bfloat16:
        lib, lib_name = _k6_library(torch, kernels, plan, a, b,
                                    kernels.run_plan_plain(plan, a, b))
        fns["library_ms"] = lib
    out = _times(torch, fns)
    size = a.element_size()
    nbytes = sum(size * (m * k + k * n + m * n) for m, n, k in shapes)
    flops = sum(2 * m * n * k for m, n, k in shapes)
    bound, by = _bound_ms(nbytes, flops)
    return {**out, "library_ms": out.get("library_ms"), "library": lib_name,
            "plain_ms": out.get("plain_ms"), "bound_ms": bound,
            "bound_by": by, "scenario": name,
            "dtype": str(dtype).replace("torch.", ""),
            "tenants": len(shapes), "tasks": plan.n_tasks, "bm": plan.bm,
            "live_bytes": nbytes, "flops": flops,
            **({"groups": _k6_groups(plan), "ctas": len(plan.groups)}
               if plan.groups is not None else {})}


def drive_k6(torch, kernels):
    """K6's path: ``coexec_matmul`` on the packer's placement of each
    scenario (bf16, tasks in ``coexec_tile_sequence`` order), with the
    launch counters zeroed just before; one launch a scenario."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    cases = [_k6_case(torch, kernels, gen, shapes, torch.bfloat16)
             for shapes in _k6_scenarios().values()]
    return _drive(torch, "coexec", lambda: [
        kernels.coexec_matmul(xs, ws, order=order)
        for xs, ws, _, order in cases])


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing ({exc}); run "
              "from the root of a checkout", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    threading.excepthook = _record_thread_error
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    _say(smi)
    t0 = time.perf_counter()
    secs = _build.build()
    _say(f"build: {json.dumps(secs)}, {time.perf_counter() - t0:.2f} s wall")

    wgmma_build_report(_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_err = check_k1(torch, kernels, gen)
    k1_bwd_err = check_k1_backward(torch, kernels, gen)
    k2_err = check_k2(torch, kernels, gen)
    kernels.grouped_gemm.ROUTE_LAUNCHES.clear()
    k4_err = check_k4(torch, kernels, gen)
    k45_err = check_k4_dx_and_k5(torch, kernels, gen)
    k2_int8_err = check_k2_int8(torch, kernels, gen)
    k3_err = check_k3(torch, kernels, gen)
    k7_err = check_k7(torch, kernels, gen)
    k6_err = check_k6(torch, kernels, gen)
    gc.collect()
    torch.cuda.empty_cache()
    for label, small in _small_configs().items():
        check_small_model(torch, np, label, small)
        check_small_train(torch, np, label, small)

    cfg = get_config("qwen2.5-0.5b")
    eng, params, launches, flt_outs = serve_full_width(
        torch, np, cfg, ("sisa_gemm", "paged_attn"))
    profile_window(torch, np, eng, cfg)
    serve_dense(torch, np, cfg, params, flt_outs)
    serve_online(torch, np, cfg, params)
    run_launchers(torch)
    eng8, int8_launches, k2_pool_err = serve_int8(torch, np, kernels, cfg,
                                                  params, eng, flt_outs)
    del eng8
    serve_coexec(torch, np, cfg, params)
    k1 = time_k1(torch, kernels, params, cfg, rows=8)
    k1_prefill = time_k1(torch, kernels, params, cfg, rows=208)
    k2 = time_k2(torch, kernels, layers=cfg.n_layers)
    k2_int8 = time_k2_int8(torch, kernels, layers=cfg.n_layers)
    k2_phi = time_k2(torch, kernels, K2_HEADS[1], MOE_LAYERS)
    k2_phi_int8 = time_k2_int8(torch, kernels, K2_HEADS[1], MOE_LAYERS)
    k3 = time_k3(torch, kernels, params, cfg)
    _say(f"k1 decode step (rung 8, {k1['gemms']} GEMMs): {json.dumps(k1)}")
    _say(f"k1 prefill (208 rows, LM head on 1 row): {json.dumps(k1_prefill)}")
    _say(f"k2 decode step (8 rows, {k2['launches_timed']} layers): "
         f"{json.dumps(k2)}")
    _say(f"k2 int8 decode step (8 rows, {k2_int8['launches_timed']} "
         f"layers): {json.dumps(k2_int8)}")
    _say(f"k2 phi3.5-moe-42b layout decode step (8 rows, GQA 32/8 hd 128, "
         f"{k2_phi['launches_timed']} layers): {json.dumps(k2_phi)}")
    _say(f"k2 int8 phi3.5-moe-42b layout decode step (8 rows, "
         f"{k2_phi_int8['launches_timed']} layers): "
         f"{json.dumps(k2_phi_int8)}")
    _say(f"k3 decode step (rung 8, {k3['gemms']} GEMMs, slabs of "
         f"{K3_BK}): {json.dumps(k3)}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()

    k6_launches = drive_k6(torch, kernels)
    k6 = {}
    for name in _k6_scenarios():
        for dtype in (torch.bfloat16, torch.float32):
            t = time_k6(torch, kernels, name, dtype,
                        plain=dtype == torch.bfloat16)
            k6[(name, t["dtype"])] = t
            _say(f"k6 {name} {t['dtype']} (fused vs {t['tenants']} "
                 f"sequential launches): {json.dumps(t)}")
            gc.collect()
            torch.cuda.empty_cache()
    k7 = time_k7(torch, kernels, cap=2)
    k7_ragged = time_k7(torch, kernels, cap=37)
    k7_train = time_k7(torch, kernels, cap=320)
    _say(f"k7 decode capacity (E 16, C 2, up/gate/down): {json.dumps(k7)}")
    _say(f"k7 ragged capacity (E 16, C 37, up/gate/down): "
         f"{json.dumps(k7_ragged)}")
    _say(f"k7 training capacity (E 16, C 320, up/gate/down): "
         f"{json.dumps(k7_train)}")
    gc.collect()
    torch.cuda.empty_cache()

    moe_cfg = dataclasses.replace(get_config("phi3.5-moe-42b"),
                                  n_layers=MOE_LAYERS)
    eng, params, moe_launches, _ = serve_full_width(torch, np, moe_cfg,
                                                    KERNEL_NAMES)
    profile_window(torch, np, eng, moe_cfg)
    k4 = time_k4(torch, kernels, params, moe_cfg, n_tokens=8)
    k4_prefill = time_k4(torch, kernels, params, moe_cfg, n_tokens=208)
    _say(f"k4 decode step (rung 8, {k4['launches_timed']} launches): "
         f"{json.dumps(k4)}")
    _say(f"k4 prefill (208 tokens, {k4_prefill['launches_timed']} "
         f"launches): {json.dumps(k4_prefill)}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()

    train_cfg = dataclasses.replace(get_config("phi3.5-moe-42b"),
                                    n_layers=TRAIN_LAYERS)
    trainer, out, train_launches, _ = train_full_width(torch, train_cfg)
    params, opt_state = out["params"], out["opt_state"]
    del out
    profile_train_step(torch, trainer, params, opt_state)
    del opt_state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    time_train_k1(torch, kernels, params, train_cfg,
                  rows=TRAIN_BATCH * TRAIN_SEQ)
    train_t = time_train_experts(torch, kernels, params, train_cfg,
                                 n_tokens=TRAIN_BATCH * TRAIN_SEQ)

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "sisa_gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sisa_gemm.cu",
         "replaces": "src/repro/kernels/sisa_gemm.py:95",
         "launches": launches["sisa_gemm"],
         "max_abs_err": max(k1_err, k1_bwd_err),
         **{k: k1[k] for k in keys}},
        {"name": "paged_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
         "replaces": "src/repro/kernels/paged_attn.py:88",
         "note": "times: one qwen2.5-0.5b decode step (24 launches); "
                 "phi_* at phi3.5-moe-42b's layout (8 launches)",
         "launches": launches["paged_attn"], "max_abs_err": k2_err,
         **{k: k2[k] for k in keys},
         **{f"phi_{k}": k2_phi[k] for k in ("ms", "bound_ms")}},
        {"name": "grouped_gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
         "replaces": "src/repro/kernels/grouped_gemm.py:160",
         "launches": moe_launches["grouped_gemm"], "max_abs_err": k4_err,
         **{k: k4[k] for k in keys}},
        {"name": "grouped_gemm_dx", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
         "replaces": "src/repro/kernels/grouped_gemm.py:160",
         "note": "K4's backward: dX = dY W^T through the same kernel's "
                 "TRANS_B bodies (the VJP at grouped_gemm.py:301-310); "
                 "launches and times from the training run",
         "launches": train_launches["grouped_gemm_dx"],
         "max_abs_err": k45_err["dx"],
         **{k: train_t["k4_dx"][k] for k in keys}},
        {"name": "grouped_dw", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grouped_dw.cu",
         "replaces": "src/repro/kernels/grouped_gemm.py:186",
         "launches": train_launches["grouped_dw"],
         "max_abs_err": k45_err["dw"],
         **{k: train_t["k5"][k] for k in keys}},
        {"name": "paged_attn_int8", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
         "replaces": "src/repro/kernels/paged_attn.py:88",
         "note": "K2's quant=True branch: int8 pools with bf16 scale "
                 "planes; launches from the kv_quant='int8' serve; phi_* "
                 "at phi3.5-moe-42b's layout",
         "launches": int8_launches["paged_attn_int8"],
         "max_abs_err": max(k2_int8_err, k2_pool_err),
         **{k: k2_int8[k] for k in keys},
         **{f"phi_{k}": k2_phi_int8[k] for k in ("ms", "bound_ms")}},
        {"name": "coexec", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/coexec.cu",
         "replaces": "src/repro/kernels/coexec.py:209",
         "note": "launches: coexec_matmul on the packer's placement of the "
                 "four scenarios (bf16); times: mixed_serving, bf16; "
                 "<scenario>_* the other three, bf16",
         "launches": k6_launches, "max_abs_err": k6_err,
         **{k: k6[("mixed_serving", "bfloat16")][k] for k in keys},
         **{f"{name}_{k}": k6[(name, "bfloat16")][k]
            for name in ("decode_batch", "narrow_proj", "moe_dispatch")
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}},
        {"name": "sisa_gemm_splitk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sisa_gemm.cu",
         "replaces": "src/repro/kernels/sisa_gemm.py:111",
         "note": "launches and times: one qwen2.5-0.5b decode step's 168 "
                 "projections through sisa_gemm_splitk, one wgmma launch "
                 "each (no partials, no sum; the partials' route issued "
                 "three kernels a GEMM, 504), slabs of 256",
         "launches": k3["launches"], "max_abs_err": k3_err,
         **{k: k3[k] for k in keys}},
        {"name": "moe_gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm.py:22",
         "note": "launches and times: phi3.5-moe-42b's up, gate and down "
                 "expert GEMMs at decode capacity 2 through "
                 "moe_grouped_gemm; c37_*, c320_* at capacities 37, 320",
         "launches": k7["launches"], "max_abs_err": k7_err,
         **{k: k7[k] for k in keys},
         **{f"c37_{k}": k7_ragged[k] for k in ("ms", "library_ms")},
         **{f"c320_{k}": k7_train[k] for k in ("ms", "library_ms")}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
