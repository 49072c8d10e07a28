"""K6's tile groups (``repro_torch.kernels.k6_plan``) on the CPU.

On the card, bf16 K6 runs one CTA per tile group: a run of one tenant's
row blocks (up to 128 rows) by a run of its column blocks, derived once
from the plan's task table when the plan is built.  Checked here, at the
four scenarios of ``benchmarks/multi_tenant_bench.py`` at Qwen2.5-0.5B's
widths in the packer's order and at the reference test's tenant sets:
the groups cover every live task exactly once, never mix tenants, follow
the table's order, deal the zero columns past each tenant's blocks out
exactly once, and are the same for a tenant in a fused plan and in its
``single_tenant_plans`` plan — the structural reason fused equals
sequential bit for bit on the card.  A plain version that follows the
groups (each group's K steps in runs of its cluster pair, the runs
summed in rank order, zeros past each tenant's rows and columns) is
held against the JAX package's ``coexec_matmul(interpret=True)`` in
float32 (rtol 1e-5, atol 1e-4, as the other K6 tests).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import coexec as ref_coexec
from repro_torch.core import (coexec_tile_sequence, pack_requests, TABLE2)
from repro_torch.core.multi import GemmRequest
from repro_torch.kernels import (build_coexec_plan, CoexecTenant, k6_plan,
                                 pack_operands, single_tenant_plans,
                                 unpack_outputs)
from repro_torch.kernels import coexec
from repro_torch.kernels.coexec import (K6_FIELDS, K6_GROUP_BYTES,
                                        K6_PAIR_BLOCKS, K6_PAIR_STEPS,
                                        K6_ROWS, K6_STEP, K6_WARPGROUPS,
                                        K6_WIDTHS)

F = {name: i for i, name in enumerate(K6_FIELDS)}
RTOL, ATOL = 1e-5, 1e-4


def _scenarios():
    """The four tenant sets of chip_smoke.py's K6 phase, (m, n, k)."""
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


def _plan(shapes, packed=True, **pins):
    reqs = [GemmRequest(rid=i, m=m, n=n, k=k)
            for i, (m, n, k) in enumerate(shapes)]
    order = (coexec_tile_sequence(pack_requests(reqs),
                                  rids=[r.rid for r in reqs])
             if packed else None)
    return build_coexec_plan([CoexecTenant(rid=i, m=m, n=n, k=k)
                              for i, (m, n, k) in enumerate(shapes)],
                             torch.bfloat16, order=order, **pins)


# The reference test's tenant sets as (m, n, k), and the scenarios.
SMALL = [[(1, 96, 64), (16, 200, 128), (4, 130, 300)],
         [(3, 64, 200), (15, 516, 64), (9, 128, 128), (1, 96, 96)],
         [(1, 128, 64), (16, 200, 96), (7, 64, 128), (512, 128, 64)],
         [(150, 896, 896), (40, 128, 4864), (12, 300, 100)]]
PLANS = ([(name, shapes, {}) for name, shapes in _scenarios().items()]
         + [(f"small{i}", s, {}) for i, s in enumerate(SMALL)]
         + [(f"small{i}_bm{bm}", s, {"block_rows": bm})
            for i, s in enumerate(SMALL) for bm in (16, 32, 64, 128)])


def _rows(plan):
    """The CTA rows of a plan's bf16 launch on the card (``k6_plan``; a
    plan built on the CPU holds none)."""
    return k6_plan(plan.meta, plan.bm, plan.bn)


def _groups(plan):
    """The groups of a plan's CTA rows: each group's rank-0 row."""
    rows = _rows(plan)
    return rows[rows[:, F["rank"]] == 0]


def _tasks(plan):
    return {(int(t), int(r), int(c)) for t, r, c in zip(*plan.meta[:3])}


def _group_tasks(plan, g):
    bm, bn = plan.bm, plan.bn
    return {(int(g[F["tenant"]]), r, c)
            for r in range(g[F["row0"]] // bm,
                           (g[F["row0"]] + g[F["rows"]]) // bm)
            for c in range(g[F["col0"]] // bn,
                           g[F["col0"]] // bn + g[F["chunks"]])}


@pytest.mark.parametrize("name,shapes,pins", PLANS,
                         ids=[p[0] for p in PLANS])
def test_groups_cover_every_task_once_within_one_tenant(name, shapes, pins):
    plan = _plan(shapes, **pins)
    assert _rows(plan).dtype == np.int32
    assert _rows(plan).shape[1] == len(K6_FIELDS)
    g = _groups(plan)
    covered = [t for row in g for t in _group_tasks(plan, row)]
    assert len(covered) == len(set(covered)) == plan.n_tasks
    assert set(covered) == _tasks(plan)      # every task is live here
    for row in g:
        t = plan.tenants[row[F["tenant"]]]
        off = plan.row_offsets[row[F["tenant"]]]
        assert off <= row[F["row0"]]
        assert row[F["row0"]] + row[F["rows"]] <= off + -(-t.m // plan.bm) * plan.bm
        assert 0 < row[F["live"]] == min(row[F["rows"]], off + t.m - row[F["row0"]])
        assert row[F["rows"]] <= max(K6_ROWS, plan.bm)
        assert row[F["rows"]] % plan.bm == 0
        assert row[F["col0"]] + row[F["chunks"]] * plan.bn <= row[F["zero_col"]]
        assert row[F["zero_col"]] == -(-t.n // plan.bn) * plan.bn
        assert row[F["k_steps"]] == -(-t.k // K6_STEP)


@pytest.mark.parametrize("name,shapes,pins", PLANS,
                         ids=[p[0] for p in PLANS])
def test_groups_follow_the_table_order(name, shapes, pins):
    """Groups are ordered by their first task in the table, so the first
    groups launched hold the tenants the packer placed first."""
    plan = _plan(shapes, **pins)
    pos = {(int(t), int(r), int(c)): i
           for i, (t, r, c) in enumerate(zip(*plan.meta[:3]))}
    firsts = [min(pos[t] for t in _group_tasks(plan, row))
              for row in _groups(plan)]
    assert firsts == sorted(firsts) and firsts[0] == 0
    seen = []
    for row in _groups(plan):
        if row[F["tenant"]] not in seen:
            seen.append(int(row[F["tenant"]]))
    first_task_tenants = []
    for t in plan.meta[0]:
        if int(t) not in first_task_tenants:
            first_task_tenants.append(int(t))
    assert seen == first_task_tenants


@pytest.mark.parametrize("name,shapes,pins", PLANS,
                         ids=[p[0] for p in PLANS])
def test_group_shapes_are_the_kernels(name, shapes, pins, monkeypatch):
    """Width the least of K6_WIDTHS holding the live rows; up to
    K6_WARPGROUPS column blocks (one a consumer warpgroup) while their
    weights stay within K6_GROUP_BYTES and the tenant keeps two groups a
    row run; a cluster pair shares K from K6_PAIR_STEPS steps or for a
    tenant of at most K6_PAIR_BLOCKS column blocks."""
    plan = _plan(shapes, **pins)
    for row in _groups(plan):
        t = plan.tenants[row[F["tenant"]]]
        w, live = row[F["width"]], row[F["live"]]
        assert w in K6_WIDTHS and live <= w
        assert w == min(x for x in K6_WIDTHS if x >= live)
        blocks = -(-t.n // plan.bn)
        most = max(1, min(K6_WARPGROUPS, blocks // 2, K6_GROUP_BYTES // (
            plan.bn * row[F["k_steps"]] * K6_STEP * 2)))
        assert 1 <= row[F["chunks"]] <= most
        assert row[F["chunks"]] == most or row[F["col0"]] // plan.bn + \
            row[F["chunks"]] == blocks            # only a run's last group
        assert row[F["ranks"]] == (2 if row[F["k_steps"]] >= K6_PAIR_STEPS
                                   or blocks <= K6_PAIR_BLOCKS else 1)
    groups = len(_groups(plan))
    with monkeypatch.context() as patch:
        patch.setattr(coexec, "K6_GROUP_BYTES", 0)
        assert (_rows(plan)[:, F["chunks"]] == 1).all()
    with monkeypatch.context() as patch:
        patch.setattr(coexec, "K6_PAIR_STEPS", 1 << 30)
        patch.setattr(coexec, "K6_PAIR_BLOCKS", 0)
        alone = _rows(plan)
    assert (alone[:, F["ranks"]] == 1).all() and len(alone) == groups


@pytest.mark.parametrize("name,shapes,pins", PLANS,
                         ids=[p[0] for p in PLANS])
def test_cta_rows_put_each_pair_in_one_cluster(name, shapes, pins):
    """One row a CTA: a pair's rows rank 0 then 1 at rows 2c and 2c + 1
    (one cluster), holes (rank 1 of 1) only just before a pair or at the
    end, an even row count with pairs; without pairs no holes and no
    clusters."""
    plan = _plan(shapes, **pins)
    rows = _rows(plan)
    pairs = rows[:, F["ranks"]] == 2
    holes = (rows[:, F["rank"]] == 1) & (rows[:, F["ranks"]] == 1)
    assert dataclasses.replace(plan, groups=rows).k6_cluster == (
        2 if pairs.any() else 1)
    if not pairs.any():
        assert not holes.any() and (rows[:, F["rank"]] == 0).all()
        return
    assert len(rows) % 2 == 0
    for i in np.flatnonzero(pairs & (rows[:, F["rank"]] == 0)):
        assert i % 2 == 0 and rows[i + 1, F["rank"]] == 1
        np.testing.assert_array_equal(rows[i, :-1], rows[i + 1, :-1])
    for i in np.flatnonzero(holes):
        assert i % 2 == 1
        assert i == len(rows) - 1 or (rows[i + 1, F["ranks"]] == 2
                                      and rows[i + 1, F["rank"]] == 0)


@pytest.mark.parametrize("name,shapes,pins", PLANS,
                         ids=[p[0] for p in PLANS])
def test_zero_columns_are_dealt_once(name, shapes, pins):
    """The 64-wide column chunks from each tenant's last block to the
    buffer's width are written once for each of the tenant's rows."""
    plan = _plan(shapes, **pins)
    runs = {}
    for row in _groups(plan):
        runs.setdefault((int(row[F["tenant"]]), int(row[F["row0"]])),
                        []).append(row)
    for rows in runs.values():
        assert sorted(r[F["zero_idx"]] for r in rows) == list(
            range(rows[0][F["zero_n"]]))
        zc = (plan.np_pad - rows[0][F["zero_col"]]) // 64
        dealt = sorted(z for r in rows
                       for z in range(r[F["zero_idx"]], zc, r[F["zero_n"]]))
        assert dealt == list(range(zc))


@pytest.mark.parametrize("name,shapes,pins", PLANS,
                         ids=[p[0] for p in PLANS])
def test_a_tenants_groups_are_its_single_plans(name, shapes, pins):
    plan = _plan(shapes, **pins)
    singles = single_tenant_plans(plan, torch.bfloat16)
    same = [F[f] for f in ("rows", "live", "col0", "chunks", "k_steps",
                           "width", "zero_col", "zero_idx", "zero_n",
                           "ranks")]
    groups = _groups(plan)
    for i, single in enumerate(singles):
        own = groups[groups[:, F["tenant"]] == i]
        key = np.lexsort((own[:, F["col0"]], own[:, F["row0"]]))
        own = own[key]
        sg = _groups(single)
        alone = sg[np.lexsort((sg[:, F["col0"]], sg[:, F["row0"]]))]
        assert (alone[:, F["tenant"]] == 0).all()
        np.testing.assert_array_equal(
            own[:, F["row0"]] - plan.row_offsets[i], alone[:, F["row0"]])
        np.testing.assert_array_equal(own[:, same], alone[:, same])


def test_default_groups_of_the_scenarios():
    """mixed_serving's 150-row tenants read their weights twice (a group of
    128 rows and one of 22), not once per 16-row block: 116 MB of weight
    tiles, against 424 MB for one read per task."""
    plan = _plan(_scenarios()["mixed_serving"])
    g = _groups(plan)
    weights = int((g[:, F["chunks"]] * 64 * g[:, F["k_steps"]] * 64 * 2).sum())
    per_task = sum(2 * plan.bn * 64 * -(-int(k) // 64)
                   for k in plan.meta[4])
    assert 115e6 < weights < 117e6 and 423e6 < per_task < 425e6
    assert sorted(set(g[:, F["width"]].tolist())) == [16, 32, 64, 128]
    narrow = _plan(_scenarios()["narrow_proj"])
    assert len(_groups(narrow)) == 64 and len(_rows(narrow)) == 128
    assert (_rows(narrow)[:, F["ranks"]] == 2).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_only_a_bf16_plan_for_the_card_holds_groups(dtype):
    """The CUDA-core body (float32) and the plain version read the task
    table alone, so a plan built for either holds no group table."""
    plan = build_coexec_plan([CoexecTenant(rid=0, m=8, n=128, k=896)],
                             dtype, device="cpu")
    assert plan.groups is None and plan.groups_device is None
    assert plan.meta_device is None


def _groups_plain(plan, a, b):
    """The groups' arithmetic in f32: each group's K steps cut into its
    ``ranks`` contiguous runs (the CTAs of a cluster pair), each run's sum
    in step order, the runs added in rank order; rows past ``live`` and
    the columns past each tenant's blocks 0."""
    out = torch.full((plan.m_flat, plan.np_pad), float("nan"))
    for row in _groups(plan):
        t, r0, rows, live = (int(row[F[f]]) for f in
                             ("tenant", "row0", "rows", "live"))
        c0, c1 = int(row[F["col0"]]), int(row[F["col0"]] + 64 * row[F["chunks"]])
        steps, ranks = int(row[F["k_steps"]]), int(row[F["ranks"]])
        runs = []
        for r in range(ranks):
            acc = torch.zeros(live, c1 - c0)
            for i in range(r * steps // ranks, (r + 1) * steps // ranks):
                k0, k1 = i * K6_STEP, min((i + 1) * K6_STEP, plan.kp)
                acc += (a[r0:r0 + live, k0:k1].float()
                        @ b[t, k0:k1, c0:c1].float())
            runs.append(acc)
        tile = torch.zeros(rows, c1 - c0)
        tile[:live] = sum(runs[1:], runs[0])
        out[r0:r0 + rows, c0:c1] = tile
        zc = (plan.np_pad - int(row[F["zero_col"]])) // 64
        for z in range(int(row[F["zero_idx"]]), zc, int(row[F["zero_n"]])):
            z0 = int(row[F["zero_col"]]) + 64 * z
            out[r0:r0 + rows, z0:z0 + 64] = 0
    return out


@pytest.mark.parametrize("shapes", SMALL[:3])
def test_groups_plain_matches_the_reference(shapes):
    """Every element of the flat output is written by some group, and the
    groups' arithmetic agrees with the reference's interpret kernel."""
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((m, k)).astype(np.float32) for m, n, k in shapes]
    ws = [rng.standard_normal((k, n)).astype(np.float32) for m, n, k in shapes]
    plan = build_coexec_plan([CoexecTenant(rid=i, m=m, n=n, k=k)
                              for i, (m, n, k) in enumerate(shapes)])
    a, b = pack_operands(plan, [torch.from_numpy(x) for x in xs],
                         [torch.from_numpy(w) for w in ws])
    out = _groups_plain(plan, a, b)
    assert not torch.isnan(out).any()
    want = ref_coexec.coexec_matmul([jnp.asarray(x) for x in xs],
                                    [jnp.asarray(w) for w in ws],
                                    interpret=True)
    for got, w_, x, w in zip(unpack_outputs(plan, out), want, xs, ws):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got.numpy(), x @ w, rtol=RTOL, atol=ATOL)
    for off, t in zip(plan.row_offsets, plan.tenants):
        end = off + -(-t.m // plan.bm) * plan.bm
        assert torch.count_nonzero(out[off + t.m:end]) == 0
        assert torch.count_nonzero(out[off:end, -(-t.n // 64) * 64:]) == 0
