"""The port's kernel modules against the JAX package's kernels on the CPU.

K1 (``repro_torch.kernels.sisa_gemm``), K2 (``...paged_attn``), K3
(``sisa_gemm_splitk``) and K7 (``...moe_gemm``) run their plain versions
here — the CUDA kernels run only on the card and
are held against these same plain versions by ``chip_smoke.py``.  The
plain versions are held against the reference's Pallas kernels in
interpret mode and its XLA twins, on seeded numpy inputs, in float32
with rtol/atol 1e-5.  The reference's backends are chosen per call
(never through its process-wide switches, which would leak across test
files sharing a worker).  The port has no backend to choose: the
operands' device picks the kernel or its plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import choose_block_config as ref_block_config
from repro.kernels import paged_attention as ref_paged_attention
from repro.kernels import sisa_matmul as ref_sisa_matmul
from repro.kernels.moe_gemm import moe_grouped_gemm as ref_moe_grouped_gemm
from repro.kernels.ref import gemm_ref, grouped_gemm_ref
from repro.kernels.sisa_gemm import BlockConfig as RefBlockConfig
from repro.kernels.sisa_gemm import sisa_gemm_splitk as ref_sisa_gemm_splitk
from repro_torch.kernels import (_build, BlockConfig, choose_block_config,
                                 LAUNCH_COUNTERS, moe_grouped_gemm,
                                 moe_grouped_gemm_plain, paged_attention,
                                 paged_attention_plain, row_passes,
                                 set_default_backend, set_paged_attn_backend,
                                 sisa_einsum_2d, sisa_gemm, sisa_gemm_splitk,
                                 sisa_gemm_splitk_plain, sisa_matmul)

TOL = 1e-5
M_CASES = [3, 40, 130, 256]
K, N = 96, 160


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("m", M_CASES)
def test_k1_plain_matches_pallas_and_ref(m):
    a, b = _rand(m, m, K), _rand(m + 1, K, N, scale=K ** -0.5)
    got = sisa_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    pallas = np.asarray(ref_sisa_matmul(jnp.asarray(a), jnp.asarray(b),
                                        "pallas_interpret"))
    ref = np.asarray(gemm_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("m", M_CASES)
def test_k1_transposed_b_and_nd_input(m):
    """The tied LM head hands K1 ``table.T``; linears hand it (B, S, K)."""
    a, table = _rand(m, m, K), _rand(m + 1, N, K)
    got = sisa_matmul(torch.from_numpy(a), torch.from_numpy(table).T)
    np.testing.assert_allclose(got.numpy(), a @ table.T, rtol=TOL, atol=TOL)
    x = torch.from_numpy(a).reshape(1, m, K)
    out = sisa_einsum_2d(x, torch.from_numpy(table).T)
    assert out.shape == (1, m, N)
    np.testing.assert_allclose(out[0].numpy(), got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("m", M_CASES)
def test_k1_gradient_matches_jax_grad(m):
    a, b = _rand(m, m, K), _rand(m + 1, K, N, scale=K ** -0.5)
    w = _rand(m + 2, m, N)

    def loss(a_, b_):
        return jnp.sum(ref_sisa_matmul(a_, b_, "pallas_interpret") * w)

    ja, jb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    (sisa_matmul(ta, tb) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb), rtol=TOL,
                               atol=TOL)


def _ref_mode(m, dtype):
    bm = ref_block_config(m, N, K, dtype).bm
    sublane = 8 if dtype == jnp.float32 else 16
    if bm <= sublane:
        return "slab"
    return "fused" if bm <= 64 else "monolithic"


@pytest.mark.parametrize("m", M_CASES)
def test_k1_mode_and_passes_follow_the_reference(m):
    assert choose_block_config(m, N, K).mode == _ref_mode(m, jnp.float32)
    main = (m // 128) * 128
    want = [(0, main), (main, m)] if m > 128 and m % 128 else [(0, m)]
    assert row_passes(m) == want


def test_k1_tile_height_equals_the_reference_bf16_slab_height():
    for m in range(1, 300):
        assert (choose_block_config(m, N, K).bm
                == ref_block_config(m, N, K, jnp.bfloat16).bm), m


def test_k1_rejects_bad_operands():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        sisa_gemm(a, torch.zeros(9, 3))
    with pytest.raises(ValueError):
        sisa_gemm(a, torch.zeros(8, 3, dtype=torch.bfloat16))
    set_default_backend("kernel")
    for name in ("plain", "xla", "dense"):
        with pytest.raises(ValueError):
            set_default_backend(name)


def _attn_case(seed, b, n_heads, n_kv, hd, psz, n_pages, pmax, pos):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n_heads, hd)).astype(np.float32)
    pk = rng.standard_normal((n_pages + 1, psz, n_kv, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pages + 1, psz, n_kv, hd)).astype(np.float32)
    table = np.full((b, pmax), n_pages, np.int32)         # sink everywhere
    pages = rng.permutation(n_pages).astype(np.int32)
    for row, p in enumerate(pos):
        n = p // psz + 1
        table[row, :n] = pages[:n]
        pages = pages[n:]
    return q, pk, pv, table, np.asarray(pos, np.int32)


@pytest.mark.parametrize("heads", [(4, 2), (14, 2), (4, 4)])
def test_k2_plain_matches_pallas_and_xla(heads):
    n_heads, n_kv = heads
    # Positions on page edges (psz 4), rows whose tail maps the sink.
    case = _attn_case(n_heads, 5, n_heads, n_kv, 8, 4, 14, 5,
                      [0, 3, 4, 11, 19])
    got = paged_attention(*map(torch.from_numpy, case)).numpy()
    plain = paged_attention_plain(*map(torch.from_numpy, case)).numpy()
    np.testing.assert_array_equal(got, plain)
    jcase = [jnp.asarray(x) for x in case]
    for impl in ("pallas_interpret", "xla"):
        ref = np.asarray(ref_paged_attention(*jcase, impl=impl))
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_k2_rejects_unknown_backend():
    set_paged_attn_backend("kernel")
    for name in ("plain", "xla", "gather"):
        with pytest.raises(ValueError):
            set_paged_attn_backend(name)


@pytest.mark.parametrize("kernel", ["sisa_gemm", "paged_attn",
                                    "sisa_gemm_splitk", "moe_gemm"])
def test_non_cpu_tensors_never_take_the_plain_version(kernel):
    """Only a CPU tensor selects the plain version: a tensor on any other
    device launches the kernel or raises (here, on ``meta``, it raises
    before building anything)."""
    if kernel == "sisa_gemm":
        args = (torch.zeros(4, 8, device="meta"),
                torch.zeros(8, 3, device="meta"))
        call = sisa_matmul
    elif kernel == "sisa_gemm_splitk":
        args = (torch.zeros(4, 64, device="meta"),
                torch.zeros(64, 3, device="meta"), BlockConfig(16, 64, 32))
        call = sisa_gemm_splitk
    elif kernel == "moe_gemm":
        args = (torch.zeros(2, 4, 8, device="meta"),
                torch.zeros(2, 8, 3, device="meta"))
        call = moe_grouped_gemm
    else:
        args = [torch.from_numpy(x).to("meta") for x in
                _attn_case(0, 1, 2, 1, 8, 4, 2, 1, [0])]
        call = paged_attention
    with pytest.raises(ValueError):
        call(*args)
    assert not _build._LIBS


def test_cpu_tensors_build_nothing():
    """On CPU tensors the wrappers take the plain versions: no nvcc, no
    library, no launch."""
    before = {k: c.n for k, c in LAUNCH_COUNTERS.items()}
    sisa_matmul(torch.ones(2, 3), torch.ones(3, 4))
    paged_attention(*[torch.from_numpy(x) for x in
                      _attn_case(0, 1, 2, 1, 8, 4, 2, 1, [0])])
    sisa_gemm_splitk(torch.ones(2, 64), torch.ones(64, 4),
                     BlockConfig(16, 0, 32))
    moe_grouped_gemm(torch.ones(2, 3, 4), torch.ones(2, 4, 5))
    assert {k: c.n for k, c in LAUNCH_COUNTERS.items()} == before
    assert not _build._LIBS


# K3 at the reference test's shapes (tests/test_kernels.py:138-149), each
# at two slab depths, with the reference's divisible block shapes.
@pytest.mark.parametrize("m,n,k", [(8, 256, 2048), (16, 512, 4096),
                                   (1, 128, 1024)])
@pytest.mark.parametrize("slabs", [2, 4])
def test_k3_splitk_matches_pallas_and_ref(m, n, k, slabs):
    a, b = _rand(m + k, m, k), _rand(n, k, n, scale=k ** -0.5)
    mp = ((m + 7) // 8) * 8
    bk = k // slabs
    got = sisa_gemm_splitk(torch.from_numpy(a), torch.from_numpy(b),
                           BlockConfig(bm=mp, bn=128, bk=bk)).numpy()
    ap = np.pad(a, ((0, mp - m), (0, 0)))
    pallas = np.asarray(ref_sisa_gemm_splitk(
        jnp.asarray(ap), jnp.asarray(b), RefBlockConfig(bm=mp, bn=128, bk=bk),
        interpret=True))[:m]
    ref = np.asarray(gemm_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_k3_ragged_edges_partials_and_errors():
    """Ragged M, N and K (the port masks them; the reference asserts
    divisibility): the partials are the slabs' products, their sum the
    GEMM; bad block shapes raise."""
    a, b = _rand(1, 13, 300), _rand(2, 300, 100, scale=300 ** -0.5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    part = sisa_gemm_splitk_plain(ta, tb, 128)
    assert part.shape == (3, 13, 100) and part.dtype == torch.float32
    np.testing.assert_allclose(part[2].numpy(), a[:, 256:] @ b[256:],
                               rtol=TOL, atol=TOL)
    got = sisa_gemm_splitk(ta, tb, BlockConfig(16, 64, 128))
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=TOL, atol=TOL)
    bf = sisa_gemm_splitk(ta.bfloat16(), tb.bfloat16(),
                          BlockConfig(16, 0, 128))
    assert bf.dtype == torch.bfloat16
    for cfg in (BlockConfig(16, 64, 0), BlockConfig(16, 100, 128)):
        with pytest.raises(ValueError):
            sisa_gemm_splitk(ta, tb, cfg)
    with pytest.raises(ValueError):
        sisa_gemm_splitk(ta, tb[:5], BlockConfig(16, 64, 32))
    assert choose_block_config(8, 896, 896) == BlockConfig(16)


# K7 at the reference test's shapes (tests/test_kernels.py:127-135),
# ragged C, d and f (the reference pads them up to its block grid), and
# k7_plan's capacities (2, 37, 320: decode, ragged, training) on narrow
# widths.
@pytest.mark.parametrize("e,c,d,f", [(4, 20, 64, 96), (16, 96, 128, 256),
                                     (2, 8, 8, 8), (3, 5, 40, 72),
                                     (2, 130, 36, 70), (3, 5, 36, 70),
                                     (4, 2, 64, 96), (4, 37, 64, 96),
                                     (2, 320, 64, 48)])
def test_k7_moe_gemm_matches_pallas_and_ref(e, c, d, f):
    x, w = _rand(c, e, c, d), _rand(f, e, d, f, scale=d ** -0.5)
    got = moe_grouped_gemm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.shape == (e, c, f)
    np.testing.assert_array_equal(
        got, moe_grouped_gemm_plain(torch.from_numpy(x),
                                    torch.from_numpy(w)).numpy())
    pallas = np.asarray(ref_moe_grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                                             interpret=True))
    ref = np.asarray(grouped_gemm_ref(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_k7_rejects_bad_operands():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError):
        moe_grouped_gemm(x, torch.zeros(3, 4, 5))
    with pytest.raises(ValueError):
        moe_grouped_gemm(x, torch.zeros(2, 5, 5))
    with pytest.raises(ValueError):
        moe_grouped_gemm(x, torch.zeros(2, 4, 5, dtype=torch.bfloat16))
