"""The port's kernel modules against the JAX package's kernels on the CPU.

K1 (``repro_torch.kernels.sisa_gemm``) and K2 (``...paged_attn``) run
their plain versions here — the CUDA kernels run only on the card and
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
from repro.kernels.ref import gemm_ref
from repro_torch.kernels import (_build, choose_block_config, LAUNCH_COUNTERS,
                                 paged_attention, paged_attention_plain,
                                 row_passes, set_default_backend,
                                 set_paged_attn_backend, sisa_einsum_2d,
                                 sisa_gemm, sisa_matmul)

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


@pytest.mark.parametrize("kernel", ["sisa_gemm", "paged_attn"])
def test_non_cpu_tensors_never_take_the_plain_version(kernel):
    """Only a CPU tensor selects the plain version: a tensor on any other
    device launches the kernel or raises (here, on ``meta``, it raises
    before building anything)."""
    if kernel == "sisa_gemm":
        args = (torch.zeros(4, 8, device="meta"),
                torch.zeros(8, 3, device="meta"))
        call = sisa_matmul
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
    assert {k: c.n for k, c in LAUNCH_COUNTERS.items()} == before
    assert not _build._LIBS
