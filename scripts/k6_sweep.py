"""K6's tile-group plans on one CUDA card, against the alternatives.

    python3 scripts/k6_sweep.py

Times K6's bf16 body (``csrc/coexec.cu``, one CTA a tile group) on the
four scenarios of ``benchmarks/multi_tenant_bench.py`` at Qwen2.5-0.5B's
widths, placed as ``chip_smoke.py`` places them (the packer's task
order, seeded random operands): the groups ``k6_plan`` gives beside
other limits on the column blocks a group takes (one block, as many as
the CTA's warpgroups, half and twice the pick's weight bytes), and the
pick's groups without cluster pairs and with pairs from 8 K steps; each
variant is ``k6_plan`` with its module constants (``K6_GROUP_BYTES``,
``K6_PAIR_STEPS``, ``K6_PAIR_BLOCKS``) set for the call.  Beside them:
``torch._grouped_mm`` on the same flat operands (a yardstick the port
never calls) and the least time the card could take (the live bytes
over 3.35 TB/s).  A time is the CUDA-event time of ``REPS`` launches
queued behind a spin kernel (``chip_smoke._queued_ms``) on pre-packed
operands; every candidate is checked against the plain version first.

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

REPS = 6


def _say(obj) -> None:
    print(json.dumps(obj), flush=True)


def _card(torch) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _say({"card": smi, "torch": torch.__version__})


def _us(torch, cs, fn) -> float:
    return cs._queued_ms(torch, lambda: [fn() for _ in range(REPS)]
                         )[0] / REPS * 1e3


def _k6_plan_with(co, consts: dict, plan):
    """``k6_plan`` of ``plan``'s table with module constants set to
    ``consts`` for this one call."""
    saved = {name: getattr(co, name) for name in consts}
    try:
        for name, value in consts.items():
            setattr(co, name, value)
        return co.k6_plan(plan.meta, plan.bm, plan.bn)
    finally:
        for name, value in saved.items():
            setattr(co, name, value)


def sweep(torch, cs, kernels) -> None:
    co = sys.modules["repro_torch.kernels.coexec"]
    # k6_plan's constants: the pick; one column block a group; as many as
    # the CTA's warpgroups wherever the tenant has them; half and twice the
    # pick's weight bytes; no cluster pairs; pairs from 8 K steps.
    rules = {"pick": {}, "one_block": {"K6_GROUP_BYTES": 0},
             "most_blocks": {"K6_GROUP_BYTES": 1 << 40},
             "half_bytes": {"K6_GROUP_BYTES": co.K6_GROUP_BYTES // 2},
             "twice_bytes": {"K6_GROUP_BYTES": co.K6_GROUP_BYTES * 2},
             "no_pairs": {"K6_PAIR_STEPS": 1 << 30, "K6_PAIR_BLOCKS": 0},
             "pairs_from_8": {"K6_PAIR_STEPS": 8}}
    gen = torch.Generator(device="cuda").manual_seed(20)
    for name, shapes in cs._k6_scenarios().items():
        xs, ws, plan, _ = cs._k6_case(torch, kernels, gen, shapes,
                                      torch.bfloat16)
        a, b = kernels.pack_operands(plan, xs, ws)
        del xs, ws
        ref = kernels.run_plan_plain(plan, a, b)
        times, groups = {}, {}
        for rule, consts in rules.items():
            g = _k6_plan_with(co, consts, plan)
            p = dataclasses.replace(plan, groups=g, groups_device=torch.
                                    as_tensor(g, device="cuda"))
            cs._max_err(f"K6 {name} {rule}", kernels.run_plan(p, a, b), ref,
                        cs.BF16_REL, cs._f32_atol(ref))
            times[rule] = _us(torch, cs, lambda: kernels.run_plan(p, a, b))
            groups[rule] = len(g)             # CTAs
        lib, lib_name = cs._k6_library(torch, kernels, plan, a, b, ref)
        nbytes = sum(2 * (m * k + k * n + m * n) for m, n, k in shapes)
        _say({"kernel": "K6", "scenario": name, "tenants": len(shapes),
              "bm": plan.bm, "plan_us": times["pick"],
              "best": min(times, key=times.get),
              "us": {x: round(v, 3) for x, v in
                     sorted(times.items(), key=lambda kv: kv[1])},
              "ctas": groups, "library": lib_name,
              "library_us": _us(torch, cs, lib),
              "bound_us": nbytes / 3.35e12 * 1e6})
        del a, b, ref


def main() -> int:
    import chip_smoke as cs  # puts this checkout's src on the path
    import torch
    if not torch.cuda.is_available():
        print("k6_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    _card(torch)
    sweep(torch, cs, kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
