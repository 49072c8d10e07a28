"""K2's launch plans on one CUDA card, against the alternatives.

    python3 scripts/k2_sweep.py

Times K2 (``csrc/paged_attn.cu``, split-KV paged-attention decode) at the
two serve layouts of ``chip_smoke.py``: qwen2.5-0.5b (14 query and 2 KV
heads, head_dim 64, 24 layers) and phi3.5-moe-42b (32 and 8, head_dim
128, 8 layers), 8 rows of 16-page tables over 16-token pages, on bf16
pools and on int8 pools with bf16 scale planes (``quantize_page_pool``),
at two sets of positions: the end of ``chip_smoke.py``'s serve (each
prompt plus 31 new tokens: 47 ... 231) and a full pool (every row at
255).  Every plan ``k2_plan`` can lay out (1, 2, 4 or 8 pages a split,
where a CTA holds them) runs beside the plan the entry point takes.  A time is the
CUDA-event time of one decode step's launches (one a layer) queued behind
a spin kernel (``chip_smoke._queued_ms``), each result checked against
the plain version first.  Beside it: the host microseconds per
``paged_attention`` call, and the least time the card could take (the
bytes the live cells need over 3.35 TB/s).

Three more position sets take a launch apart (every row at 0, 31 or
47: one, two or three pages), and the device time of 24 trivial kernels
queued back to back is the floor of a launch.

Every line printed is one JSON object; the first names the card and its
power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (name, (query heads, KV heads, head_dim), layers a decode step)
LAYOUTS = (("qwen2.5-0.5b", (14, 2, 64), 24),
           ("phi3.5-moe-42b", (32, 8, 128), 8))
PSZ, PMAX, ROWS = 16, 16, 8
PPS = (1, 2, 4, 8)


def _say(obj) -> None:
    print(json.dumps(obj), flush=True)


def _card(torch) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _say({"card": smi, "torch": torch.__version__})


def _host_us(torch, fn, calls: int) -> float:
    """Host microseconds per call: the best of three runs of ``fn``
    (``calls`` calls) issued without synchronising."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / calls * 1e6


def _positions(cs):
    """The two position sets, and three that take a launch apart: every
    row at 0, 31 or 47 (one, two or three pages; one split, or with fewer
    pages a split than that, the combine)."""
    return {"serve_end": [n + cs.NEW_TOKENS - 1 for n in cs.PROMPT_LENS],
            "full": [PSZ * PMAX - 1] * ROWS,
            "all_0": [0] * ROWS, "all_31": [31] * ROWS,
            "all_47": [47] * ROWS}


def _bound_us(pos, heads, quant) -> float:
    """Bytes the live cells need (K and V, int8 with a bf16 scale a cell
    and KV head, or bf16), q in and out, the table and pos, over 3.35
    TB/s."""
    h, hkv, hd = heads
    cells = sum(p + 1 for p in pos)
    nbytes = (2 * cells * hkv * (hd + 2 if quant else 2 * hd)
              + 2 * 2 * len(pos) * h * hd + 4 * (len(pos) * PMAX + len(pos)))
    return nbytes / 3.35e12 * 1e6


def _key(plan) -> str:
    return f"pps{plan.pages_per_split}"


def _case(torch, cs, kernels, gen, heads, pos, quant):
    q, pk, pv, table, pos_t = cs._attn_inputs(torch, gen, torch.bfloat16,
                                              pos, heads=heads)
    if quant:
        pk, pv, pks, pvs = cs._int8_pools(kernels, pk, pv)
        return q, pk, pv, table, pos_t, pks, pvs
    return q, pk, pv, table, pos_t, None, None


def sweep(torch, cs, kernels) -> None:
    pa = sys.modules["repro_torch.kernels.paged_attn"]
    gen = torch.Generator(device="cuda").manual_seed(17)
    for name, heads, layers in LAYOUTS:
        h, hkv, hd = heads
        for quant in (False, True):
            for label, pos in _positions(cs).items():
                args = _case(torch, cs, kernels, gen, heads, pos, quant)
                ref = kernels.paged_attention_plain(*args)

                def step(fn):
                    return lambda: [fn() for _ in range(layers)]

                def entry():
                    return kernels.paged_attention(*args)

                cs._max_err(f"K2 {name} {label}", entry(), ref,
                            cs.BF16_REL, 1e-5)
                row = {"kernel": "K2", "layout": name,
                       "pool": "int8" if quant else "bf16",
                       "positions": label, "layers": layers,
                       "bound_us_a_step":
                           _bound_us(pos, heads, quant) * layers,
                       "entry_us_a_step":
                           cs._queued_ms(torch, step(entry))[0] * 1e3,
                       "host_us": _host_us(torch, step(entry), layers)}
                chosen = kernels.k2_plan(ROWS, h, hkv, hd, PSZ, PMAX,
                                         args[1].element_size(), quant)
                times = {}
                for pps in PPS:
                    try:
                        plan = kernels.k2_plan(
                            ROWS, h, hkv, hd, PSZ, PMAX,
                            args[1].element_size(), quant,
                            pages_per_split=pps)
                    except ValueError:
                        continue

                    def launch(plan=plan):
                        return pa._paged_attention_kernel(*args, plan=plan)
                    cs._max_err(f"K2 {name} {label} {plan}", launch(), ref,
                                cs.BF16_REL, 1e-5)
                    times[_key(plan)] = cs._queued_ms(
                        torch, step(launch))[0] * 1e3
                key = _key(chosen)
                row.update({"plan": key, "plan_us_a_step": times[key],
                            "best": min(times, key=times.get),
                            "us_a_step": {k: round(v, 3) for k, v in
                                          sorted(times.items(),
                                                 key=lambda kv: kv[1])}})
                _say(row)
                del args, ref


def launch_floor(torch, cs) -> None:
    """The device time of 24 trivial kernels (``torch.cuda._sleep(0)``)
    queued back to back: what a launch costs with nothing in it."""
    us = cs._queued_ms(torch, lambda: [torch.cuda._sleep(0)
                                       for _ in range(24)])[0] * 1e3
    _say({"kernel": "trivial (torch.cuda._sleep(0))", "launches": 24,
          "us": us, "us_a_launch": us / 24})


def main() -> int:
    import chip_smoke as cs  # puts this checkout's src on the path
    import torch
    if not torch.cuda.is_available():
        print("k2_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    _card(torch)
    launch_floor(torch, cs)
    sweep(torch, cs, kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
