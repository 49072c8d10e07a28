"""K6 co-execution in the port against the JAX package on the CPU.

* ``build_coexec_plan`` with pinned block shapes equals the reference's
  plan field for field, and ``interleave_order`` the reference's order,
  including one taken from a schedule wider than the fused tenant set;
* ``coexec_matmul`` (its plain version here; the CUDA kernel is held
  against the same plain version on the card by ``chip_smoke.py``)
  agrees with the reference's ``coexec_matmul(interpret=True)`` on the
  reference test's shapes (f32, rtol 1e-5, atol 1e-4: sums of up to 300
  products in another order); fused equals sequential bit for bit; the
  result does not depend on the task order; the empty placement is
  ``[]``;
* the paged engine with ``coexec_backend="kernel"`` gives the tokens it
  gives without the flag and the JAX paged engine's with
  ``coexec_backend="xla"``, with the same backfill and co-execution
  counters, and prefills each request once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.core import coexec_tile_sequence as ref_tile_sequence
from repro.core import SISA_128 as REF_SISA_128
from repro.core.multi import GemmRequest as RefGemmRequest
from repro.core.multi import pack_requests as ref_pack_requests
from repro.hw.specs import SISA_ASIC as REF_SISA_ASIC
from repro.kernels import coexec as ref_coexec
from repro.models import init_params as jax_init
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import coexec_tile_sequence, pack_requests, SISA_128
from repro_torch.core.multi import GemmRequest
from repro_torch.hw.specs import SISA_ASIC
from repro_torch.kernels import (build_coexec_plan, coexec_matmul,
                                 CoexecTenant, interleave_order,
                                 LAUNCH_COUNTERS, pack_operands, run_plan,
                                 sequential_matmul, single_tenant_plans,
                                 sisa_matmul, unpack_outputs)
from repro_torch.serve import make_engine, Request, validate_stats

RTOL, ATOL = 1e-5, 1e-4
# The reference test's tenant sets, (m, k, n) per tenant.
SHAPES = [
    [(1, 64, 96), (16, 128, 200), (4, 300, 130)],
    [(2, 64, 64)],
    [(8, 128, 128)] * 4,
    [(3, 200, 64), (15, 64, 516), (9, 128, 128), (1, 96, 96)],
    [(1, 64, 128), (16, 96, 200), (7, 128, 64), (512, 64, 128)],
]


def _operands(shapes, seed=11, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((m, k)).astype(np.float32)
          for (m, k, n) in shapes]
    ws = [rng.standard_normal((k, n)).astype(np.float32)
          for (m, k, n) in shapes]
    return ([torch.from_numpy(x).to(dtype) for x in xs],
            [torch.from_numpy(w).to(dtype) for w in ws], xs, ws)


def _tenants(cls, shapes):
    return [cls(rid=i, m=m, n=n, k=k) for i, (m, k, n) in enumerate(shapes)]


@pytest.mark.parametrize("blocks", [(8, 128, 128), (16, 64, 32),
                                    (32, 128, 64)])
@pytest.mark.parametrize("order", [None, [2, 1, 0], [1], [3, 0, 0, 2]])
def test_pinned_plan_equals_the_reference(blocks, order):
    shapes = SHAPES[3]
    bm, bn, bk = blocks
    pins = dict(order=order, block_rows=bm, block_cols=bn, block_k=bk)
    got = build_coexec_plan(_tenants(CoexecTenant, shapes), **pins)
    want = ref_coexec.build_coexec_plan(
        _tenants(ref_coexec.CoexecTenant, shapes), jnp.float32, **pins)
    for field in ("bm", "bn", "bk", "m_flat", "kp", "np_pad", "row_offsets",
                  "n_tasks", "n_k"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.meta.dtype == np.int32
    np.testing.assert_array_equal(got.meta, want.meta)
    assert got.meta_device is None
    assert [got.tenant_tasks(i) for i in range(4)] == \
        [want.tenant_tasks(i) for i in range(4)]


def test_default_blocks_are_the_kernels():
    plan = build_coexec_plan(_tenants(CoexecTenant, SHAPES[0]))
    assert (plan.bm, plan.bn, plan.bk) == (16, 64, 32)
    plan = build_coexec_plan(_tenants(CoexecTenant, SHAPES[0]), m_hint=100)
    assert plan.bm == 128


@pytest.mark.parametrize("counts,seq", [
    ([2, 1, 3], None), ([2, 2], [1, 0]), ([1, 1], [0]), ([1, 1], [5, 1, 0]),
    ([2], [7, 8]), ([3, 0, 2, 5], [3, 3, 1, 0]), ([4, 4, 4], []),
])
def test_interleave_order_equals_the_reference(counts, seq):
    assert interleave_order(counts, seq) == \
        ref_coexec.interleave_order(counts, seq)


@pytest.mark.parametrize("n_req,n_fused", [(5, 3), (4, 4)])
def test_order_from_a_wider_schedule(n_req, n_fused):
    """The packer's sequence over more requests than fused tenants: the
    port's packer gives the reference's sequence, the extra rids are
    dropped the same way, and the result is still each tenant's GEMM."""
    reqs = [GemmRequest(rid=i, m=8, n=128, k=64) for i in range(n_req)]
    ref_reqs = [RefGemmRequest(rid=i, m=8, n=128, k=64)
                for i in range(n_req)]
    seq = coexec_tile_sequence(pack_requests(reqs, SISA_128, SISA_ASIC),
                               rids=[r.rid for r in reqs])
    ref_seq = ref_tile_sequence(
        ref_pack_requests(ref_reqs, REF_SISA_128, REF_SISA_ASIC),
        rids=[r.rid for r in ref_reqs])
    assert seq == ref_seq
    assert interleave_order([2] * n_fused, seq) == \
        ref_coexec.interleave_order([2] * n_fused, ref_seq)
    shapes = [(8, 64, 128)] * n_fused
    xs, ws, _, _ = _operands(shapes)
    plan = build_coexec_plan(_tenants(CoexecTenant, shapes), order=seq)
    for x, w, o in zip(xs, ws, coexec_matmul(xs, ws, plan=plan)):
        torch.testing.assert_close(o, x @ w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shapes", SHAPES)
def test_coexec_matmul_matches_the_reference(shapes):
    xs, ws, nxs, nws = _operands(shapes)
    got = coexec_matmul(xs, ws)
    want = ref_coexec.coexec_matmul([jnp.asarray(x) for x in nxs],
                                    [jnp.asarray(w) for w in nws],
                                    interpret=True)
    assert len(got) == len(shapes)
    for g, w_, x, w in zip(got, want, nxs, nws):
        assert tuple(g.shape) == tuple(w_.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(g.numpy(), x @ w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bitwise_equals_sequential(dtype):
    shapes = [(1, 64, 96), (16, 128, 200), (512, 96, 64), (4, 300, 130)]
    xs, ws, _, _ = _operands(shapes, dtype=dtype)
    plan = build_coexec_plan(_tenants(CoexecTenant, shapes), dtype)
    fused = coexec_matmul(xs, ws, plan=plan)
    serial = sequential_matmul(xs, ws, plan=plan)
    singles = single_tenant_plans(plan, dtype)
    assert all((s.bm, s.bn, s.bk) == (plan.bm, plan.bn, plan.bk)
               for s in singles)
    for f, s, x in zip(fused, serial, xs):
        assert f.dtype == dtype and torch.equal(f, s)
    # Rows past each tenant's m, inside its row blocks, are exact zeros.
    out = run_plan(plan, *pack_operands(plan, xs, ws))
    for off, t in zip(plan.row_offsets, plan.tenants):
        pad = out[off + t.m:off + -(-t.m // plan.bm) * plan.bm]
        assert torch.equal(pad, torch.zeros_like(pad))
    assert [tuple(o.shape) for o in unpack_outputs(plan, out)] == \
        [(m, n) for m, _, n in shapes]


def test_grid_order_never_changes_results():
    shapes = [(4, 64, 128), (16, 64, 128), (1, 64, 128)]
    xs, ws, _, _ = _operands(shapes)
    base = None
    for order in (None, [2, 1, 0], [0, 0, 1, 2], [1]):
        plan = build_coexec_plan(_tenants(CoexecTenant, shapes), order=order)
        outs = coexec_matmul(xs, ws, plan=plan)
        base = base or outs
        for a, b in zip(base, outs):
            assert torch.equal(a, b)


def test_empty_placement_and_single_tenant():
    assert coexec_matmul([], []) == []
    assert sequential_matmul([], []) == []
    xs, ws, _, _ = _operands([(12, 160, 224)])
    torch.testing.assert_close(coexec_matmul(xs, ws)[0],
                               sisa_matmul(xs[0], ws[0]), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError):
        coexec_matmul(xs, [])
    with pytest.raises(ValueError):
        build_coexec_plan([])


def test_cpu_plans_hold_no_device_table_and_kernels_never_fall_back():
    """A plan built for the CPU has no device copy of its table; on a
    non-CPU tensor run_plan raises instead of taking the plain version,
    and the CPU path launches nothing."""
    shapes = [(4, 64, 128), (9, 32, 64)]
    xs, ws, _, _ = _operands(shapes)
    before = {k: c.n for k, c in LAUNCH_COUNTERS.items()}
    plan = build_coexec_plan(_tenants(CoexecTenant, shapes), device="cpu")
    assert plan.meta_device is None
    a, b = pack_operands(plan, xs, ws)
    run_plan(plan, a, b)
    assert {k: c.n for k, c in LAUNCH_COUNTERS.items()} == before
    with pytest.raises(ValueError):
        run_plan(plan, a.to("meta"), b.to("meta"))


# The reference test's engine workload (tests/test_coexec.py:156-196):
# 5 requests of 6 tokens, 3 new tokens each, 2 slots, window 4.
ENGINE_OPTS = dict(max_slots=2, max_seq=64, window=4)


def _engine_run(make, request_cls, cfg, params, **kw):
    eng = make(cfg, params, kind="paged", **ENGINE_OPTS, **kw)
    counts = {}
    prefill = eng.prefill_fn

    def counted(p, batch):
        key = int(np.asarray(batch["tokens"]).sum())   # pads are zeros
        counts[key] = counts.get(key, 0) + 1
        return prefill(p, batch)

    eng.prefill_fn = counted
    rng = np.random.default_rng(0)
    for i in range(5):
        eng.submit(request_cls(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=6).astype(np.int32), max_new_tokens=3))
    done = eng.run(max_steps=200)
    return {c.rid: c.tokens for c in done}, counts, eng


def test_coexec_engine_matches_jax_and_runs_without_the_flag():
    name = "yi-6b"
    cfg = smoke_config(name)
    jparams = jax_init(cfg, jax.random.PRNGKey(0))
    tcfg = torch_smoke_config(name)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    plain_tokens, plain_counts, plain = _engine_run(
        make_engine, Request, tcfg, tparams, device="cpu")
    co_tokens, co_counts, co = _engine_run(
        make_engine, Request, tcfg, tparams, device="cpu",
        coexec_backend="kernel")
    jax_tokens, _, jeng = _engine_run(jax_make_engine, JaxRequest, cfg,
                                      jparams, coexec_backend="xla")
    assert len(co_tokens) == 5
    assert co_tokens == plain_tokens == jax_tokens
    validate_stats(co.stats)
    assert co.stats["coexec_backend"] == "kernel"
    assert plain.stats["coexec_backend"] is None
    assert co.stats["backfilled"] > 0 and plain.stats["backfilled"] == 0
    for key in ("backfilled", "packed_prefills", "coexec_tiles",
                "coexec_interleave", "batches"):
        assert co.stats[key] == jeng.stats[key], key
    assert co.stats["coexec_tiles"] and all(
        n > 0 for n in co.stats["coexec_tiles"])
    assert not plain.stats["coexec_tiles"]
    assert sorted(co_counts.values()) == [1] * 5 == sorted(
        plain_counts.values())
    assert co.cache.n_free_pages == co.cache.num_pages


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_interpret",
                                     "triton"])
def test_coexec_backend_takes_only_kernel(backend):
    tcfg = torch_smoke_config("qwen2.5-0.5b")
    from repro_torch.models import init_params
    params = init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="coexec_backend"):
        make_engine(tcfg, params, kind="paged", device="cpu",
                    coexec_backend=backend, **ENGINE_OPTS)
    eng = make_engine(tcfg, params, kind="paged", device="cpu",
                      coexec_backend="kernel", **ENGINE_OPTS)
    eng.reset()
    assert eng.stats["coexec_backend"] == "kernel"
