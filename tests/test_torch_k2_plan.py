"""K2's launch plan (``k2_plan``) and its plan-following plain version
(``paged_attention_split_plain``), on the CPU.

The plan lays the split-KV paged-attention decode of
``csrc/paged_attn.cu`` out from static shapes: pages a split and splits,
one KV head a CTA.  Its arithmetic is checked here at qwen2.5-0.5b's,
phi3.5-moe-42b's and internvl2-76b's serve layouts: every page of a row
in exactly one split, the CTA's threads, shared memory and grid within
an H100's limits, and the limits mirrored from the source.  The kernel runs only on the card
(``chip_smoke.py`` holds it against the plain version there).

``paged_attention_split_plain`` computes each split's online softmax
over its own pages and then the kernel's combine.  Under every plan
``k2_plan`` lays out for a case, it is held against the JAX package's
``paged_attention`` in Pallas interpret mode and its XLA twin, in float32
within 1e-5: GQA 14/2 at head_dim 64, 32/8 and 64/8 at 128, MHA, pages
of 16 and 32 cells, positions on page and split edges, at 0 and at a
full row, dead table entries on the sink page, float pools and int8
pools from the reference's ``quantize_page_pool``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as ref_paged_attention
from repro.kernels.paged_attn import quantize_page_pool as ref_quantize
from repro_torch.configs import get_config
from repro_torch.kernels import (k2_plan, paged_attention_plain,
                                 paged_attention_split_plain)
from repro_torch.kernels.paged_attn import (_HEAD_DIMS, K2_MAX_PPS,
                                            K2_MAX_SMEM, K2_PPS,
                                            k2_smem_bytes)

TOL = 1e-5
SMEM_LIMIT = 232448     # bytes of shared memory an H100 block can use
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "paged_attn.cu").read_text()

# (name, query heads, KV heads, head_dim) of the serve layouts: qwen's
# group of 7 at hd 64, phi's 4 at hd 128, internvl2's 8 (64/8) at hd 128,
# the widest group K2 runs.
SERVE = [(name, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
         for name, cfg in ((n, get_config(n)) for n in
                           ("qwen2.5-0.5b", "phi3.5-moe-42b",
                            "internvl2-76b"))]
ROWS, PSZ, PMAX = 8, 16, 16     # chip_smoke.py's serves: max_seq 256


def _to_torch(x):
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(x.copy())


def _case(seed, n_heads, n_kv, hd, psz, pmax, pos, quant):
    """Numpy inputs from a seed, as JAX arrays: each row's live pages
    drawn from a permutation of the pool, every dead entry on the sink
    page (the pool's last)."""
    rng = np.random.default_rng(seed)
    b = len(pos)
    n_pages = sum(p // psz + 1 for p in pos) + 3
    q = rng.standard_normal((b, n_heads, hd)).astype(np.float32)
    kv = [rng.standard_normal((n_pages + 1, psz, n_kv, hd)).astype(
        np.float32) for _ in range(2)]
    table = np.full((b, pmax), n_pages, np.int32)
    pages = rng.permutation(n_pages).astype(np.int32)
    for row, p in enumerate(pos):
        n = p // psz + 1
        table[row, :n] = pages[:n]
        pages = pages[n:]
    case = [jnp.asarray(q)]
    if quant:
        (pk, pks), (pv, pvs) = (ref_quantize(jnp.asarray(x)) for x in kv)
        case += [pk, pv, jnp.asarray(table), jnp.asarray(pos, jnp.int32),
                 pks, pvs]
    else:
        case += [jnp.asarray(kv[0]), jnp.asarray(kv[1]), jnp.asarray(table),
                 jnp.asarray(pos, jnp.int32)]
    return case


def _plans(b, n_heads, n_kv, hd, psz, pmax, itemsize, quant):
    """Every plan ``k2_plan`` lays out: each number of pages a split it
    admits, and the default."""
    plans = {k2_plan(b, n_heads, n_kv, hd, psz, pmax, itemsize, quant)}
    for pps in range(1, K2_MAX_PPS + 1):
        try:
            plans.add(k2_plan(b, n_heads, n_kv, hd, psz, pmax, itemsize,
                              quant, pages_per_split=pps))
        except ValueError:
            pass
    return sorted(plans, key=lambda p: p.pages_per_split)


# (name, query heads, KV heads, head_dim, page size, pages a row,
#  positions, int8 pools): split edges of 1, 2 and 4 pages (16, 32, 64
#  cells at page size 16) on either side, 0 and a full row.
CASES = [
    ("gqa_14_2_hd64", 14, 2, 64, 16, 8,
     [0, 15, 16, 31, 32, 63, 64, 127], False),
    ("gqa_32_8_hd128", 32, 8, 128, 16, 8,
     [0, 16, 31, 32, 63, 64, 95, 127], False),
    ("gqa_64_8_hd128", 64, 8, 128, 16, 8,
     [0, 16, 31, 32, 63, 64, 95, 127], False),
    ("mha_4_4_hd64_psz32", 4, 4, 64, 32, 4, [0, 31, 32, 63, 64, 127], False),
    ("gqa_14_2_hd64_int8", 14, 2, 64, 16, 8,
     [0, 15, 16, 31, 32, 63, 64, 127], True),
    ("gqa_32_8_hd128_int8_psz32", 32, 8, 128, 32, 4,
     [0, 31, 32, 63, 64, 127], True),
    ("mha_4_4_hd64_int8", 4, 4, 64, 16, 8, [0, 16, 47, 48, 127], True),
]


@pytest.mark.parametrize("name,n_heads,n_kv,hd,psz,pmax,pos,quant", CASES,
                         ids=[c[0] for c in CASES])
def test_split_plain_under_every_plan_matches_pallas_and_xla(
        name, n_heads, n_kv, hd, psz, pmax, pos, quant):
    jcase = _case(len(name), n_heads, n_kv, hd, psz, pmax, pos, quant)
    kw = dict(pk_scale=jcase[5], pv_scale=jcase[6]) if quant else {}
    refs = [np.asarray(ref_paged_attention(*jcase[:5], impl=impl, **kw))
            for impl in ("pallas_interpret", "xla")]
    args = [_to_torch(x) for x in jcase]
    plans = _plans(len(pos), n_heads, n_kv, hd, psz, pmax,
                   1 if quant else 4, quant)
    assert len(plans) >= 4
    for plan in plans:
        got = paged_attention_split_plain(*args, plan=plan).numpy()
        for ref in refs:
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL,
                                       err_msg=str(plan))
    np.testing.assert_allclose(
        paged_attention_plain(*args).numpy(), refs[0], rtol=TOL, atol=TOL)


def test_split_plain_ignores_dead_splits_and_sink_contents():
    """Whatever lies in the sink page, and in the cells of a split with
    no live page, never reaches the output."""
    pos = [0, 20, 47]
    jcase = _case(3, 14, 2, 64, 16, 8, pos, False)
    args = [_to_torch(x) for x in jcase]
    plan = k2_plan(3, 14, 2, 64, 16, 8, 4, False, pages_per_split=1)
    before = paged_attention_split_plain(*args, plan=plan)
    pk, pv = args[1].clone(), args[2].clone()
    pk[-1], pv[-1] = 1e4, -1e4                          # the sink page
    after = paged_attention_split_plain(args[0], pk, pv, *args[3:],
                                        plan=plan)
    np.testing.assert_array_equal(before.numpy(), after.numpy())


def test_split_plain_rejects_a_plan_of_other_shapes():
    args = [_to_torch(x) for x in _case(1, 4, 2, 64, 16, 8, [5], False)]
    with pytest.raises(ValueError):
        paged_attention_split_plain(
            *args, plan=k2_plan(1, 4, 2, 64, 16, 3, 4, False))


@pytest.mark.parametrize("pmax", [1, 5, 16, 31])
@pytest.mark.parametrize("pps", [1, 2, 3, 8])
def test_splits_cover_every_page_once(pmax, pps):
    plan = k2_plan(8, 4, 2, 64, 16, pmax, 2, False, pages_per_split=pps)
    covered = [j for s in range(plan.n_splits)
               for j in range(s * plan.pages_per_split,
                              min((s + 1) * plan.pages_per_split, pmax))]
    assert covered == list(range(pmax))
    assert all(s * plan.pages_per_split < pmax
               for s in range(plan.n_splits))     # no split is empty


# (pages a row, page size): chip_smoke.py's serves (a 256-token slot in
# 16-cell pages), the same slot in 32-cell pages, and a 4096-token slot.
POOLS = [(PMAX, PSZ), (8, 32), (256, 16)]


@pytest.mark.parametrize("name,n_heads,n_kv,hd", SERVE)
@pytest.mark.parametrize("itemsize,quant", [(2, False), (4, False),
                                            (1, True)])
@pytest.mark.parametrize("pmax,psz", POOLS)
def test_plan_fits_the_card_at_the_serve_layouts(name, n_heads, n_kv, hd,
                                                 itemsize, quant, pmax, psz):
    plan = k2_plan(ROWS, n_heads, n_kv, hd, psz, pmax, itemsize, quant)
    heads, pps = n_heads // n_kv, plan.pages_per_split
    # One warp a (page of the split, query head) of one KV head.
    assert 32 * heads * pps <= 1024
    smem = k2_smem_bytes(heads, psz, pps, hd, itemsize, quant)
    assert smem <= K2_MAX_SMEM and smem + 16 <= SMEM_LIMIT  # + the ticket
    # Grid (splits, KV heads, rows) within CUDA's limits.
    assert plan.n_splits == -(-pmax // pps) < 2 ** 31
    assert n_kv <= 65535 and ROWS <= 65535
    # K2_PPS pages a split where the CTA holds them, else the most it does.
    assert pps <= K2_PPS
    if pps < min(K2_PPS, pmax):
        assert ((pps + 1) * heads * 32 > 1024
                or k2_smem_bytes(heads, psz, pps + 1, hd, itemsize,
                                 quant) > K2_MAX_SMEM)


def test_plan_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError):          # 33 query heads a KV head
        k2_plan(8, 66, 2, 64, 16, 16)
    with pytest.raises(ValueError):          # more than the kernel keeps
        k2_plan(8, 14, 2, 64, 16, 16, pages_per_split=K2_MAX_PPS + 1)
    with pytest.raises(ValueError):          # 64 warps: 2 pages of 32 heads
        k2_plan(8, 32, 1, 128, 16, 16, 2, pages_per_split=2)
    with pytest.raises(ValueError):          # 3 f32 pages of hd 256, psz 32
        k2_plan(8, 10, 1, 256, 32, 16, 4, pages_per_split=3)
    assert k2_smem_bytes(10, 32, 3, 256, 4, False) > K2_MAX_SMEM
    # A default that does not fit shrinks to one that does.
    plan = k2_plan(8, 32, 1, 256, 32, 16, 4)
    assert plan.pages_per_split == 1
    assert k2_smem_bytes(32, 32, 1, 256, 4, False) <= K2_MAX_SMEM


def test_limits_mirror_the_source():
    assert int(re.search(r"kMaxPps = (\d+);", SOURCE).group(1)) == K2_MAX_PPS
    assert re.search(r"kMaxSmem = 227 \* 1024 - 1024;", SOURCE)
    assert K2_MAX_SMEM == 227 * 1024 - 1024
    dispatched = tuple(int(x) for x in re.findall(
        r"case (\d+): return launch<T, P, \d+, QUANT>", SOURCE))
    assert dispatched == _HEAD_DIMS
