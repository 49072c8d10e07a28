"""Drive the PyTorch/CUDA port's main path on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build both CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` for sm_90a (one process per source, in parallel);
3. K1 (SISA GEMM) against its plain version at the main path's shapes,
   every tile height at full height and the ragged residual split, in
   float32 and bfloat16 (elementwise, one bf16 ulp in bfloat16);
4. K2 (paged attention) against its plain version: GQA 14/2, head_dim
   64, 16-token pages, tables with sink entries, positions on page
   edges;
5. a small float32 model (qwen2.5-0.5b's widths, 2 layers) served on
   the card (kernels) and on the CPU (plain versions): identical greedy
   tokens;
6. ``qwen2.5-0.5b`` at full width in bfloat16 (seeded random weights)
   served through ``make_engine(kind="paged")``: 8 requests of 16-200
   prompt tokens, two sharing a 32-token prefix, 32 new tokens each;
   both kernels' launch counters are zeroed just before and must be
   > 0 just after;
7. where one decode window's time goes (``torch.profiler``): device time
   per kernel family against the window's wall time, and the top host
   ops;
8. kernel times at the main path's shapes, beside the plain versions',
   one PyTorch library call's where one computes the same function, and
   the least time the card could take (bytes over 3.35 TB/s or
   operations over 989 TFLOP/s, H100 SXM data sheet).  A time is the
   device time ``torch.profiler`` records for the call's kernels; the
   CUDA-event span, which also holds the host's launch gaps, is printed
   beside it as ``*_span``.

The line before the last is a JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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


def _attn_inputs(torch, gen, dtype, pos, n_pages=128, pmax=16):
    b = len(pos)
    q = torch.randn(b, 14, 64, device="cuda", generator=gen).to(dtype)
    pk = torch.randn(n_pages + 1, 16, 2, 64, device="cuda",
                     generator=gen).to(dtype)
    pv = torch.randn(n_pages + 1, 16, 2, 64, device="cuda",
                     generator=gen).to(dtype)
    perm = torch.randperm(n_pages, device="cuda", generator=gen)
    table = perm[:b * pmax].reshape(b, pmax).to(torch.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    live = torch.arange(pmax, device="cuda")[None, :] <= (pos_t // 16)[:, None]
    table = torch.where(live, table, n_pages)          # sink past pos
    return q, pk, pv, table, pos_t


def check_k2(torch, kernels, gen) -> float:
    worst = 0.0
    pos = [0, 15, 16, 31, 32, 127, 128, 255]
    for dtype in (torch.float32, torch.bfloat16):
        q, pk, pv, table, pos_t = _attn_inputs(torch, gen, dtype, pos)
        rel = 0.0 if dtype == torch.float32 else BF16_REL
        err = _max_err(f"K2 {dtype}",
                       kernels.paged_attention(q, pk, pv, table, pos_t),
                       kernels.paged_attention_plain(q, pk, pv, table, pos_t),
                       rel, 1e-5)
        worst = max(worst, err)
    _say(f"k2: GQA 14/2 hd 64 psz 16 agrees with the plain version "
         f"(max abs err {worst}; elementwise tol f32 1e-5, bf16 "
         f"2^-7*|ref| + 1e-5)")
    return worst


def _requests(Request, rng, vocab, lens):
    prompts = [rng.integers(0, vocab, n).astype("int32") for n in lens]
    prompts[2][:SHARED_PREFIX] = prompts[1][:SHARED_PREFIX]
    return [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]


def check_small_model(torch, np) -> None:
    """qwen2.5-0.5b's widths cut to 2 layers and a 4096-token vocabulary,
    in float32, served on the card (kernels) and on the CPU (plain
    versions): same weights, same requests, same greedy tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import make_engine, Request

    cfg = dataclasses.replace(get_config("qwen2.5-0.5b"), n_layers=2,
                              vocab_size=4096, param_dtype="float32")
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
    _say(f"small model (qwen2.5-0.5b widths, 2 layers, f32): "
         f"{len(outs[0])} requests, tokens on the card identical to the "
         "CPU plain path")


def serve_full_width(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import make_engine, Request, validate_stats
    from repro_torch.kernels import LAUNCH_COUNTERS

    cfg = get_config("qwen2.5-0.5b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    _say(f"params: {cfg.name} full width, "
         f"{sum(t.numel() for t in _leaves(params)) / 1e6:.1f} M bf16 "
         f"weights, init {time.perf_counter() - t0:.2f} s")
    eng = make_engine(cfg, params, kind="paged", max_slots=8, max_seq=256,
                      page_size=16, window=8)
    eng.warmup()
    reqs = _requests(Request, np.random.default_rng(0), cfg.vocab_size,
                     PROMPT_LENS)
    torch.cuda.synchronize()
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    t0 = time.perf_counter()
    for req in reqs:
        eng.submit(req)
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.n for name, c in LAUNCH_COUNTERS.items()}
    validate_stats(eng.stats)
    if len(outs) != len(PROMPT_LENS) or any(
            c.n_tokens != NEW_TOKENS or c.finish_reason != "length"
            for c in outs):
        raise AssertionError("incomplete serve: " + str(
            [(c.rid, c.n_tokens, c.finish_reason) for c in outs]))
    if not all(0 <= t < cfg.vocab_size for c in outs for t in c.tokens):
        raise AssertionError("token outside the vocabulary")
    if min(launches.values()) <= 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    ext = eng.stats["engine"]
    if ext["pages_shared"] < SHARED_PREFIX // 16:
        raise AssertionError(f"prefix not shared: {ext['pages_shared']}")
    if eng.cache.n_free_pages != eng.cache.num_pages:
        raise AssertionError("page pool did not drain")
    # Finite f32 logits of the expected shape from the same weights.
    logits, _ = eng.prefill_fn(params, {
        "tokens": torch.as_tensor(reqs[0].prompt[None], device="cuda"),
        "last_index": len(reqs[0].prompt) - 1})
    if logits.shape != (1, 1, 153600) or logits.dtype != torch.float32 \
            or not torch.isfinite(logits[..., :cfg.vocab_size]).all():
        raise AssertionError(f"bad logits {logits.shape} {logits.dtype}")
    n_tok = sum(c.n_tokens for c in outs)
    ttft = statistics.median(eng.stats["ttft"])
    _say(f"serve: {len(outs)} requests, {n_tok} tokens in {wall:.3f} s = "
         f"{n_tok / wall:.1f} tok/s, TTFT p50 {ttft * 1e3:.1f} ms, "
         f"decode_compiles {eng.stats['decode_compiles']}, decode steps "
         f"{eng.stats['decode_steps']}, rungs {ext['rungs']}, pages shared "
         f"{ext['pages_shared']}, launches {launches}")
    return eng, params, cfg, launches


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
    fam = {"sisa_gemm": 0.0, "paged_attn": 0.0, "other": 0.0}
    host = []
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            host.append((evt.self_cpu_time_total / 1e3, evt.count, evt.key))
            continue                    # host ops; their kernels count below
        dev_us = _self_device_us(evt)
        name = ("sisa_gemm" if "sisa_gemm" in evt.key else
                "paged_attn" if "paged_attn_kernel" in evt.key else "other")
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
    check_small_model(torch, np)
    eng, params, cfg, launches = serve_full_width(torch, np)
    profile_window(torch, np, eng, cfg)

    k1 = time_k1(torch, kernels, params, cfg, rows=8)
    k1_prefill = time_k1(torch, kernels, params, cfg, rows=208)
    k2 = time_k2(torch, kernels, cfg)
    _say(f"k1 decode step (rung 8, {k1['gemms']} GEMMs): {json.dumps(k1)}")
    _say(f"k1 prefill (208 rows, LM head on 1 row): {json.dumps(k1_prefill)}")
    _say(f"k2 decode step (8 rows, {k2['launches_timed']} layers): "
         f"{json.dumps(k2)}")
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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
