"""K4's plain version (repro_torch.kernels.grouped_gemm) against the JAX
package's flat grouped GEMM on the CPU.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against this same plain version.  Here the plain version is held against
the reference's Pallas kernel in interpret mode (``interpret=True`` per
call, never the process-wide switch) and its ``repro.kernels.ref``
oracles, on seeded numpy inputs and the same explicit row block, over
prefix layouts with an empty group, sizes that are not a multiple of the
row block, tail tiles past every segment, and an ``a2a_segments``
capacity-strided layout.  float32 agrees within 1e-5; bfloat16 within
one bf16 ulp of the reference (both round one f32 sum, summed in
different orders).

The backward (dX through K4 with ``w`` transposed, dW through K5) is
held the same way: autograd over the plain versions against ``jax.vjp``
of the reference's kernel in interpret mode and of its
``segment_gemm_ref`` oracle, in float32 within 1e-5, on the same
layouts (an empty group, sizes off the row block, shared-gid a2a
segments).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_gemm import _tile_metadata as ref_tile_metadata
from repro.kernels.grouped_gemm import a2a_segments
from repro.kernels.grouped_gemm import aligned_block_rows as ref_aligned_rows
from repro.kernels.grouped_gemm import flat_group_offsets as ref_offsets
from repro.kernels.grouped_gemm import flat_ragged_gemm as ref_flat
from repro.kernels.grouped_gemm import ragged_grouped_gemm as ref_ragged
from repro.kernels.grouped_gemm import segment_grouped_gemm as ref_segment
from repro.kernels.ref import (flat_ragged_gemm_ref, ragged_grouped_gemm_ref,
                               segment_gemm_ref)
from repro_torch.kernels import (_build, aligned_block_rows, flat_block_rows,
                                 flat_group_offsets, flat_ragged_gemm,
                                 LAUNCH_COUNTERS, ragged_grouped_gemm,
                                 segment_grouped_dw_plain,
                                 segment_grouped_gemm)
from repro_torch.kernels.grouped_gemm import _is_transposed, _tile_metadata

TOL = 1e-5
D, F = 40, 48


def _prefix(sizes, bm, tail_tiles):
    """Flat prefix layout at cumulative aligned offsets, ``tail_tiles``
    row tiles past the last group."""
    starts = np.array(ref_offsets(jnp.asarray(sizes, jnp.int32), bm))
    m = int(starts[-1]) + tail_tiles * bm
    return m, starts[:-1], np.asarray(sizes, np.int32), \
        np.arange(len(sizes), dtype=np.int32)


def _a2a():
    """Post-all_to_all layout: 2 local experts x 2 source ranks, each
    segment a prefix inside its 24-row capacity slice."""
    cap = 24
    recv = jnp.asarray([[5, 24], [0, 13]], jnp.int32)
    starts, sizes, gids = (np.array(t) for t in a2a_segments(2, 2, cap,
                                                              recv))
    return 2 * 2 * cap, starts, sizes, gids


LAYOUTS = {
    # an empty group, sizes off the block, a two-tile group, two tail tiles
    "prefix_bm8": (8, lambda: _prefix([5, 0, 16, 9], 8, 2)),
    # one group of a single row, a group past one full tile
    "prefix_bm16": (16, lambda: _prefix([17, 3, 0, 1], 16, 1)),
    # an empty group first and last
    "prefix_empty_ends": (16, lambda: _prefix([0, 20, 0], 16, 0)),
    "a2a_bm8": (8, _a2a),
}


def _operands(seed, m, g, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, D)).astype(np.float32)
    w = (rng.standard_normal((g, D, F)) / np.sqrt(D)).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return jx, jw, torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)


def _within_one_ulp(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    mag = np.maximum(np.abs(ref), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)          # bf16: 8-bit mantissa
    assert (np.abs(got - ref) <= ulp + TOL * 1e-3).all(), \
        np.abs(got - ref).max()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_k4_plain_matches_pallas_and_ref(layout, dtype):
    bm, make = LAYOUTS[layout]
    m, starts, sizes, gids = make()
    g = int(gids.max()) + 1
    jx, jw, tx, tw = _operands(len(layout), m, g, dtype)
    got = segment_grouped_gemm(tx, tw, torch.from_numpy(starts),
                               torch.from_numpy(sizes),
                               torch.from_numpy(gids), block_rows=bm)
    assert got.shape == (m, F) and got.dtype == tx.dtype
    got = got.float().numpy()
    pallas = ref_segment(jx, jw, starts, sizes, gids, block_rows=bm,
                         interpret=True)
    oracle = segment_gemm_ref(jx, jw, jnp.asarray(starts), jnp.asarray(sizes),
                              jnp.asarray(gids))
    for ref in (pallas, oracle):
        ref = np.asarray(ref.astype(jnp.float32))
        if dtype == jnp.float32:
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
        else:
            _within_one_ulp(got, ref)
    # Rows outside every segment are exactly zero.
    covered = np.zeros(m, bool)
    for s, n in zip(starts, sizes):
        covered[s:s + n] = True
    assert (got[~covered] == 0).all()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_k4_tile_metadata_equals_the_reference(layout):
    bm, make = LAYOUTS[layout]
    m, starts, sizes, gids = make()
    n_mt = -(-m // bm)
    ref = ref_tile_metadata(jnp.asarray(starts), jnp.asarray(sizes),
                            jnp.asarray(gids), n_mt, bm, visits=False)
    got = _tile_metadata(torch.from_numpy(starts), torch.from_numpy(sizes),
                         torch.from_numpy(gids), n_mt, bm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_k4_flat_ragged_and_capacity_shim_match_the_reference():
    """The prefix entry point at default offsets, and the (G, C, d)
    capacity shim with C off every multiple of 8."""
    sizes = np.asarray([3, 0, 11, 6], np.int32)
    bm = 8
    m = int(np.asarray(ref_offsets(jnp.asarray(sizes), bm))[-1]) + bm
    jx, jw, tx, tw = _operands(7, m, 4, jnp.float32)
    got = flat_ragged_gemm(tx, tw, torch.from_numpy(sizes), block_rows=bm)
    starts = flat_group_offsets(torch.from_numpy(sizes), bm)
    np.testing.assert_array_equal(
        starts.numpy(), np.asarray(ref_offsets(jnp.asarray(sizes), bm)))
    for ref in (ref_flat(jx, jw, jnp.asarray(sizes), block_rows=bm,
                         interpret=True),
                flat_ragged_gemm_ref(jx, jw, jnp.asarray(sizes),
                                     jnp.asarray(starts.numpy()))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)

    c = 13
    x3 = np.random.default_rng(8).standard_normal((4, c, D)).astype(
        np.float32)
    got = ragged_grouped_gemm(torch.from_numpy(x3), tw,
                              torch.from_numpy(sizes))
    assert got.shape == (4, c, F)
    for ref in (ref_ragged(jnp.asarray(x3), jw, jnp.asarray(sizes),
                           interpret=True),
                ragged_grouped_gemm_ref(jnp.asarray(x3), jw,
                                        jnp.asarray(sizes))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)


def test_k4_block_rows_follow_the_port_scheduler():
    """The row block is the port's Hopper tile height; capacity strides
    halve it exactly as the reference's helper does."""
    for m in (1, 8, 16, 17, 40, 64, 65, 200):
        assert flat_block_rows(m, F, D) in (16, 32, 64, 128)
    for align in (8, 24, 40, 64, 96):
        got = aligned_block_rows(64, F, D, align_to=align)
        assert align % got == 0
        assert got == ref_aligned_rows(64, F, D, jnp.bfloat16,
                                       align_to=align)


def test_k4_rejects_bad_layouts_and_gradients():
    x, w = torch.zeros(32, D), torch.zeros(2, D, F)
    with pytest.raises(ValueError, match="multiples"):
        segment_grouped_gemm(x, w, [0, 12], [4, 4], [0, 1], block_rows=8)
    with pytest.raises(ValueError, match="gids"):
        segment_grouped_gemm(x, w, [0, 16], [4, 4], [1, 0], block_rows=8)
    with pytest.raises(ValueError, match="outside"):
        segment_grouped_gemm(x, w, [0, 16], [4, 4], [0, 2], block_rows=8)
    with pytest.raises(ValueError):
        segment_grouped_gemm(x, w.double(), [0], [4], [0], block_rows=8)
    # A call that needs a gradient checks the layout too, and now records
    # the backward (it raised before the training slice).
    with pytest.raises(ValueError, match="multiples"):
        segment_grouped_gemm(x.requires_grad_(), w, [0, 12], [4, 4], [0, 1],
                             block_rows=8)
    out = segment_grouped_gemm(x, w, [0], [4], [0], block_rows=8)
    assert out.requires_grad and out.grad_fn is not None


def test_k4_cpu_tensors_build_nothing_and_meta_tensors_raise():
    """CPU tensors take the plain version (no nvcc, no launch); a tensor
    on any other device launches the kernel or raises (here, on
    ``meta``, it raises before building anything)."""
    before = LAUNCH_COUNTERS["grouped_gemm"].n
    out = segment_grouped_gemm(torch.ones(16, D), torch.ones(1, D, F), [0],
                               [3], [0], block_rows=8)
    assert LAUNCH_COUNTERS["grouped_gemm"].n == before
    assert (out[:3] == D).all() and (out[3:] == 0).all()
    with pytest.raises(ValueError):
        segment_grouped_gemm(torch.ones(16, D, device="meta"),
                             torch.ones(1, D, F, device="meta"), [0], [3],
                             [0], block_rows=8)
    assert "grouped_gemm" not in _build._LIBS



@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_k4_dx_and_k5_plain_match_jax_grad(layout):
    """dX and dW of ``segment_grouped_gemm`` (autograd over the plain
    K4 with ``w`` transposed and the plain K5) against ``jax.vjp`` of the
    reference's custom-VJP kernel in interpret mode and of the
    ``segment_gemm_ref`` oracle.  Rows outside every segment get dX 0;
    groups with no rows get a dW block of exact zeros."""
    bm, make = LAYOUTS[layout]
    m, starts, sizes, gids = make()
    g = int(gids.max()) + 1
    jx, jw, tx, tw = _operands(11 + len(layout), m, g, jnp.float32)
    dy = np.random.default_rng(3).standard_normal((m, F)).astype(np.float32)
    tx.requires_grad_()
    tw.requires_grad_()
    segment_grouped_gemm(tx, tw, torch.from_numpy(starts),
                         torch.from_numpy(sizes), torch.from_numpy(gids),
                         block_rows=bm).backward(torch.from_numpy(dy))
    refs = [
        lambda x, w: ref_segment(x, w, starts, sizes, gids, block_rows=bm,
                                 interpret=True),
        lambda x, w: segment_gemm_ref(x, w, jnp.asarray(starts),
                                      jnp.asarray(sizes), jnp.asarray(gids)),
    ]
    for fn in refs:
        _, vjp = jax.vjp(fn, jx, jw)
        rx, rw = vjp(jnp.asarray(dy))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rx),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(rw),
                                   rtol=TOL, atol=TOL)
    covered = np.zeros(m, bool)
    rows = np.zeros(g, np.int64)
    for s, n, gid in zip(starts, sizes, gids):
        covered[s:s + n] = True
        rows[gid] += n
    assert (tx.grad.numpy()[~covered] == 0).all()
    assert (tw.grad.numpy()[rows == 0] == 0).all()


def test_k5_plain_sums_shared_gids_and_zeros_empty_groups():
    """``segment_grouped_dw_plain`` directly: two segments of one gid are
    summed, an empty group is exactly 0, and the result has x's dtype."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((32, D)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((32, F)).astype(np.float32))
    starts, sizes, gids = (torch.tensor(v, dtype=torch.int32) for v in
                           ([0, 8, 16], [5, 7, 3], [0, 0, 2]))
    dw = segment_grouped_dw_plain(x, dy, starts, sizes, gids, 3)
    want0 = x[0:5].T @ dy[0:5] + x[8:15].T @ dy[8:15]
    np.testing.assert_allclose(dw[0].numpy(), want0.numpy(), rtol=TOL,
                               atol=TOL)
    assert (dw[1] == 0).all()
    np.testing.assert_allclose(dw[2].numpy(), (x[16:19].T @ dy[16:19]
                                               ).numpy(), rtol=TOL, atol=TOL)
    assert segment_grouped_dw_plain(x.bfloat16(), dy.bfloat16(), starts,
                                    sizes, gids, 3).dtype == torch.bfloat16


def test_k4_backward_on_cpu_builds_nothing():
    """The backward on CPU tensors runs the plain versions: no launch of
    K4 or K5, no library built."""
    before = {k: c.n for k, c in LAUNCH_COUNTERS.items()}
    x = torch.ones(16, D, requires_grad=True)
    w = torch.ones(2, D, F, requires_grad=True)
    segment_grouped_gemm(x, w, [0, 8], [3, 0], [0, 1],
                         block_rows=8).sum().backward()
    assert {k: c.n for k, c in LAUNCH_COUNTERS.items()} == before
    assert (x.grad[:3] == F).all() and (x.grad[3:] == 0).all()
    assert (w.grad[0] == 3).all() and (w.grad[1] == 0).all()
    assert "grouped_dw" not in _build._LIBS


def test_k5_entry_point_and_transposed_weights_on_cpu():
    """K5's entry point, the backward of ``segment_grouped_gemm``, gives
    ``segment_grouped_dw_plain``'s dW, checks the layout and raises off
    the CPU without a card; a transposed weight view through
    ``segment_grouped_gemm`` equals the contiguous transpose (on the
    card K4 reads it in place)."""
    bm, make = LAYOUTS["a2a_bm8"]
    m, starts, sizes, gids = make()
    g = int(gids.max()) + 1
    _, _, x, w = _operands(21, m, g, jnp.float32)
    dy = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (m, F)).astype(np.float32))
    tables = [torch.from_numpy(t) for t in (starts, sizes, gids)]
    w = w.detach().clone().requires_grad_()
    segment_grouped_gemm(x, w, *tables, block_rows=bm).backward(dy)
    want = segment_grouped_dw_plain(x, dy, *tables, g)
    assert torch.equal(w.grad, want)
    with pytest.raises(ValueError, match="multiples"):
        segment_grouped_gemm(x, w, [0, 12], [4, 4], [0, 1], block_rows=8)
    with pytest.raises(ValueError):
        segment_grouped_gemm(x.to("meta"), w.detach().to("meta")
                             .requires_grad_(), *tables, block_rows=bm)
    wt = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (g, D, F)).astype(np.float32))
    view = segment_grouped_gemm(dy, wt.transpose(1, 2), *tables,
                                block_rows=bm)
    copy = segment_grouped_gemm(dy, wt.transpose(1, 2).contiguous(),
                                *tables, block_rows=bm)
    np.testing.assert_allclose(view.numpy(), copy.numpy(), rtol=TOL,
                               atol=TOL)
    assert _is_transposed(wt.transpose(1, 2)) and not _is_transposed(wt)
