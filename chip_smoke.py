"""Drive the PyTorch/CUDA port's main path on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the three CUDA kernels from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for sm_90a (one process per source, in parallel);
3. K1 (SISA GEMM) against its plain version at the main path's shapes,
   every tile height at full height and the ragged residual split, in
   float32 and bfloat16 (elementwise, one bf16 ulp in bfloat16);
4. K2 (paged attention) against its plain version: GQA 14/2 with
   head_dim 64 (qwen) and 32/8 with head_dim 128 (phi3.5-moe), 16-token
   pages, tables with sink entries, positions on page edges;
5. K4 (flat grouped GEMM) against its plain version at phi3.5-moe's
   expert shapes (4096 -> 6400 and 6400 -> 4096, 16 experts): decode-
   and prefill-like expert sizes, sizes off the row block, tail tiles,
   and a capacity-strided layout, in float32 and bfloat16; rows past
   each tile's ``hi`` must be exactly 0;
6. small float32 models (qwen2.5-0.5b's widths, and phi3.5-moe's layer
   structure at narrow widths with 8 experts, each 2 layers) served on
   the card (kernels) and on the CPU (plain versions): identical greedy
   tokens;
7. ``qwen2.5-0.5b`` at full width in bfloat16 (seeded random weights)
   served through ``make_engine(kind="paged")``: 8 requests of 16-200
   prompt tokens, two sharing a 32-token prefix, 32 new tokens each;
   the launch counters are zeroed just before and K1's and K2's must be
   > 0 just after;
8. where one decode window's time goes (``torch.profiler``): device time
   per kernel family against the window's wall time, and the top host
   ops;
9. kernel times at the main path's shapes, beside the plain versions',
   one PyTorch library call's where one computes the same function, and
   the least time the card could take (bytes over 3.35 TB/s or
   operations over 989 TFLOP/s, H100 SXM data sheet).  A time is the
   device time ``torch.profiler`` records for the call's kernels; the
   CUDA-event span, which also holds the host's launch gaps, is printed
   beside it as ``*_span``;
10. ``phi3.5-moe-42b`` at full width, 8 of its 32 layers (all 32 do not
    fit in 80 GB), in bfloat16 with seeded random weights, once the qwen
    model is freed: the same workload through ``make_engine(kind=
    "paged")``, with K1's, K2's and K4's counters zeroed before and > 0
    after, finite logits, ``decode_compiles`` 0, a drained pool, peak
    memory, one profiled decode window, and K4's times at the decode
    (rung 8) and 208-row prefill shapes.

The line before the last is a JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
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


def _device_ms(torch, fn, iters: int = 3) -> float:
    """Device time of one call of ``fn``: the self device time of every
    kernel, copy and fill it ran, from ``torch.profiler``, so the host's
    launch gaps between small kernels do not count."""
    from torch.profiler import profile, ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(_self_device_us(e) for e in prof.key_averages()
             if "CUDA" in str(getattr(e, "device_type", "")))
    if not us > 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / 1e3 / iters


def _self_device_us(evt) -> float:
    return (getattr(evt, "self_device_time_total", 0.0)
            or getattr(evt, "self_cuda_time_total", 0.0))


def _times(torch, fns: dict) -> dict:
    """Device time of each callable under its key, and its CUDA-event span
    (host launch gaps included) under ``<key>_span``."""
    out = {}
    for key, fn in fns.items():
        out[key] = _device_ms(torch, fn)
        out[key + "_span"] = _cuda_ms(torch, fn, iters=3)
    return out


# Each kernel's launch counter name, also a substring of its CUDA symbol.
KERNEL_NAMES = ("sisa_gemm", "paged_attn", "grouped_gemm")
K1_ROWS = (1, 8, 16, 32, 64, 128, 200, 256)
BF16_REL = 2.0 ** -7        # one bf16 ulp, relative to the value


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


def _k1_cases(torch, gen, dtype, table):
    """(name, A's column count, A's row stride, B) at the main path's
    shapes, then ragged edges: K and N off every tile multiple with
    16-byte aligned rows (strided views: partial 16-byte chunks on the
    tensor cores), and K = 100, whose rows are not 16-byte aligned (the
    CUDA-core body)."""
    def rand(*shape):
        return (torch.randn(*shape, device="cuda", generator=gen)
                / shape[0] ** 0.5).to(dtype)

    for k, n in ((896, 896), (896, 128), (896, 4864), (4864, 896)):
        yield f"{k}x{n}", k, k, rand(k, n)
    yield "lm_head 896x153600 trans_b", 896, 896, table.T
    yield "ragged 900x1000", 900, 904, rand(900, 1008)[:, :1000]
    yield "ragged 900x1000 trans_b", 900, 904, rand(1000, 904)[:, :900].T
    yield "unaligned 100x36", 100, 100, rand(100, 36)


def check_k1(torch, kernels, gen) -> float:
    """Every tile height at full height (M = 16, 32, 64, 128, 256), the
    decode rungs 1 and 8, and the ragged main-plus-residual split
    (M = 200), each at the main path's shapes and the ragged cases."""
    worst, n_cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        table = (torch.randn(153600, 896, device="cuda", generator=gen)
                 / 896 ** 0.5).to(dtype)
        for m in K1_ROWS:
            for name, k, lda, b in _k1_cases(torch, gen, dtype, table):
                a = torch.randn(m, lda, device="cuda",
                                generator=gen).to(dtype)[:, :k]
                ref = kernels.sisa_gemm_plain(a, b)
                err = _max_err(f"K1 {dtype} M={m} {name}",
                               kernels.sisa_matmul(a, b), ref, rel,
                               _f32_atol(ref))
                worst = max(worst, err)
                n_cases += 1
    _say(f"k1: {n_cases} cases (M in {K1_ROWS}; main-path shapes and "
         f"ragged edges; f32 and bf16) agree with the plain version (max "
         f"abs err {worst}; elementwise tol f32 2e-5*max|ref|, bf16 "
         f"2^-7*|ref| + 2e-5*max|ref|)")
    return worst


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


def check_k2(torch, kernels, gen) -> float:
    worst = 0.0
    pos = [0, 15, 16, 31, 32, 127, 128, 255]
    for heads in K2_HEADS:
        for dtype in (torch.float32, torch.bfloat16):
            q, pk, pv, table, pos_t = _attn_inputs(torch, gen, dtype, pos,
                                                   heads=heads)
            rel = 0.0 if dtype == torch.float32 else BF16_REL
            err = _max_err(
                f"K2 {heads} {dtype}",
                kernels.paged_attention(q, pk, pv, table, pos_t),
                kernels.paged_attention_plain(q, pk, pv, table, pos_t),
                rel, 1e-5)
            worst = max(worst, err)
    _say(f"k2: GQA 14/2 hd 64 and GQA 32/8 hd 128, psz 16, agree with the "
         f"plain version (max abs err {worst}; elementwise tol f32 1e-5, "
         f"bf16 2^-7*|ref| + 1e-5)")
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


def check_k4(torch, kernels, gen) -> float:
    """K4 against its plain version at every layout of ``_k4_layouts``,
    up/gate (4096 -> 6400) and down (6400 -> 4096), f32 and bf16; rows
    outside every segment must come out exactly 0."""
    worst, n_cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        ws = {(k, n): (torch.randn(MOE_E, k, n, device="cuda", generator=gen)
                       / k ** 0.5).to(dtype)
              for k, n in ((MOE_D, MOE_FF), (MOE_FF, MOE_D))}
        for name, m, starts, sizes, gids, bm in _k4_layouts(torch, kernels):
            covered = torch.zeros(m, dtype=torch.bool, device="cuda")
            for s, n in zip(starts.tolist(), sizes.tolist()):
                covered[s:s + n] = True
            for (k, n), w in ws.items():
                x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
                got = kernels.segment_grouped_gemm(x, w, starts, sizes, gids,
                                                   block_rows=bm)
                ref = kernels.segment_grouped_gemm_plain(
                    x, w, starts, sizes, gids, block_rows=bm)
                what = f"K4 {dtype} {name} bm {bm} {k}x{n}"
                worst = max(worst, _max_err(what, got, ref, rel,
                                            _f32_atol(ref)))
                if (got[~covered] != 0).any():
                    raise AssertionError(f"{what}: a row outside every "
                                         "segment is not 0")
                n_cases += 1
    _say(f"k4: {n_cases} cases (decode- and prefill-like expert sizes, "
         f"tail tiles, capacity stride; 4096x6400 and 6400x4096; f32 and "
         f"bf16) agree with the plain version (max abs err {worst}; "
         f"elementwise tol f32 2e-5*max|ref|, bf16 2^-7*|ref| + "
         f"2e-5*max|ref|; uncovered rows exactly 0)")
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
    versions): same weights, same requests, same greedy tokens."""
    from repro_torch.models import init_params
    from repro_torch.serve import make_engine, Request

    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = _tree_map(lambda t: t.cuda(), cpu)
    outs = []
    for params, dev in ((cpu, "cpu"), (gpu, "cuda")):
        eng = make_engine(cfg, params, kind="paged", device=dev,
                          max_slots=4, max_seq=64, page_size=16, window=4)
        rng = np.random.default_rng(1)
        for req in _requests(Request, rng, cfg.vocab_size,
                             (33, 40, 50, 7, 16)):
            req.max_new_tokens = 12
            eng.submit(req)
        outs.append(sorted((c.rid, c.tokens) for c in eng.run()))
    if outs[0] != outs[1]:
        raise AssertionError(f"small model: card tokens {outs[1]} differ "
                             f"from the CPU's {outs[0]}")
    _say(f"small model ({label}, 2 layers, f32): {len(outs[0])} requests, "
         "tokens on the card identical to the CPU plain path")


def serve_full_width(torch, np, cfg, need):
    """Serve the 8-request workload through ``make_engine(kind="paged")``
    at ``cfg``'s widths with seeded random bf16 weights.  Every launch
    counter is zeroed just before the serve; those of ``need`` must be
    > 0 just after."""
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.models import init_params
    from repro_torch.models.common import padded_vocab
    from repro_torch.serve import make_engine, Request, validate_stats

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    _say(f"params: {cfg.name} full width, {cfg.n_layers} layers, "
         f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} G weights "
         f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), init "
         f"{time.perf_counter() - t0:.2f} s")
    eng = make_engine(cfg, params, kind="paged", max_slots=8, max_seq=256,
                      page_size=16, window=8)
    eng.warmup()
    reqs = _requests(Request, np.random.default_rng(0), cfg.vocab_size,
                     PROMPT_LENS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    t0 = time.perf_counter()
    for req in reqs:
        eng.submit(req)
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.n for name, c in LAUNCH_COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated()
    validate_stats(eng.stats)
    if len(outs) != len(PROMPT_LENS) or any(
            c.n_tokens != NEW_TOKENS or c.finish_reason != "length"
            for c in outs):
        raise AssertionError("incomplete serve: " + str(
            [(c.rid, c.n_tokens, c.finish_reason) for c in outs]))
    if not all(0 <= t < cfg.vocab_size for c in outs for t in c.tokens):
        raise AssertionError("token outside the vocabulary")
    if any(launches[name] <= 0 for name in need):
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if eng.stats["decode_compiles"] != 0:
        raise AssertionError(f"decode_compiles "
                             f"{eng.stats['decode_compiles']} after warmup")
    ext = eng.stats["engine"]
    if ext["pages_shared"] < SHARED_PREFIX // 16:
        raise AssertionError(f"prefix not shared: {ext['pages_shared']}")
    if eng.cache.n_free_pages != eng.cache.num_pages:
        raise AssertionError("page pool did not drain")
    # Finite f32 logits of the expected shape from the same weights.
    logits, _ = eng.prefill_fn(params, {
        "tokens": torch.as_tensor(reqs[0].prompt[None], device="cuda"),
        "last_index": len(reqs[0].prompt) - 1})
    if logits.shape != (1, 1, padded_vocab(cfg.vocab_size)) \
            or logits.dtype != torch.float32 \
            or not torch.isfinite(logits[..., :cfg.vocab_size]).all():
        raise AssertionError(f"bad logits {logits.shape} {logits.dtype}")
    n_tok = sum(c.n_tokens for c in outs)
    summary = {"model": cfg.name, "layers": cfg.n_layers, "requests":
               len(outs), "tokens": n_tok, "wall_s": wall,
               "tok_per_s": n_tok / wall,
               "ttft_p50_ms": statistics.median(eng.stats["ttft"]) * 1e3,
               "peak_memory_gb": peak / 1e9,
               "decode_compiles": eng.stats["decode_compiles"],
               "decode_steps": eng.stats["decode_steps"],
               "rungs": ext["rungs"], "pages_shared": ext["pages_shared"],
               "expert_backend": eng.stats["expert_backend"],
               "launches": launches}
    _say(f"serve: {json.dumps(summary)}")
    return eng, params, launches


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
    out = {"window_wall_ms": wall_ms, "steps": eng.window,
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
    nbytes = sum(2 * (a.shape[0] * a.shape[1] + b.shape[0] * b.shape[1]
                      + a.shape[0] * b.shape[1]) for a, b in gemms)
    flops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in gemms)
    bound, by = _bound_ms(nbytes, flops)
    return {**out, "bound_ms": bound, "bound_by": by, "gemms": len(gemms),
            "bytes": nbytes, "flops": flops}


def time_k2(torch, kernels, cfg):
    """One decode step of K2 (24 launches) at 8 rows, each at the
    position it reaches at the end of the serve phase."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    pos = [n + NEW_TOKENS - 1 for n in PROMPT_LENS]
    q, pk, pv, table, pos_t = _attn_inputs(torch, gen, torch.bfloat16, pos)
    layers = cfg.n_layers

    def run(fn):
        return lambda: [fn(q, pk, pv, table, pos_t) for _ in range(layers)]

    out = _times(torch, {"ms": run(kernels.paged_attention),
                         "plain_ms": run(kernels.paged_attention_plain)})
    hd, h, hkv = 64, 14, 2
    cells = sum(p + 1 for p in pos)              # cells this data attends
    per_layer = (2 * cells * hkv * hd * 2        # K and V, bf16
                 + 2 * 2 * len(pos) * h * hd     # q in, out
                 + 4 * (table.numel() + len(pos)))
    flops = layers * 4 * cells * h * hd
    bound, by = _bound_ms(layers * per_layer, flops)
    return {**out, "library_ms": None, "bound_ms": bound, "bound_by": by,
            "launches_timed": layers}


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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    _say(smi)
    t0 = time.perf_counter()
    secs = _build.build()
    _say(f"build: {json.dumps(secs)}, {time.perf_counter() - t0:.2f} s wall")

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_err = check_k1(torch, kernels, gen)
    k2_err = check_k2(torch, kernels, gen)
    k4_err = check_k4(torch, kernels, gen)
    for label, small in _small_configs().items():
        check_small_model(torch, np, label, small)

    cfg = get_config("qwen2.5-0.5b")
    eng, params, launches = serve_full_width(torch, np, cfg,
                                             ("sisa_gemm", "paged_attn"))
    profile_window(torch, np, eng, cfg)
    k1 = time_k1(torch, kernels, params, cfg, rows=8)
    k1_prefill = time_k1(torch, kernels, params, cfg, rows=208)
    k2 = time_k2(torch, kernels, cfg)
    _say(f"k1 decode step (rung 8, {k1['gemms']} GEMMs): {json.dumps(k1)}")
    _say(f"k1 prefill (208 rows, LM head on 1 row): {json.dumps(k1_prefill)}")
    _say(f"k2 decode step (8 rows, {k2['launches_timed']} layers): "
         f"{json.dumps(k2)}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()

    moe_cfg = dataclasses.replace(get_config("phi3.5-moe-42b"),
                                  n_layers=MOE_LAYERS)
    eng, params, moe_launches = serve_full_width(torch, np, moe_cfg,
                                                 KERNEL_NAMES)
    profile_window(torch, np, eng, moe_cfg)
    k4 = time_k4(torch, kernels, params, moe_cfg, n_tokens=8)
    k4_prefill = time_k4(torch, kernels, params, moe_cfg, n_tokens=208)
    _say(f"k4 decode step (rung 8, {k4['launches_timed']} launches): "
         f"{json.dumps(k4)}")
    _say(f"k4 prefill (208 tokens, {k4_prefill['launches_timed']} "
         f"launches): {json.dumps(k4_prefill)}")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "sisa_gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sisa_gemm.cu",
         "replaces": "src/repro/kernels/sisa_gemm.py:95",
         "launches": launches["sisa_gemm"], "max_abs_err": k1_err,
         **{k: k1[k] for k in keys}},
        {"name": "paged_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
         "replaces": "src/repro/kernels/paged_attn.py:88",
         "launches": launches["paged_attn"], "max_abs_err": k2_err,
         **{k: k2[k] for k in keys}},
        {"name": "grouped_gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
         "replaces": "src/repro/kernels/grouped_gemm.py:160",
         "launches": moe_launches["grouped_gemm"], "max_abs_err": k4_err,
         **{k: k4[k] for k in keys}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
