"""int8 page pools in the port against the JAX package on the CPU.

* ``quantize_page_pool`` is bit-equal to the reference's (int8 values
  and bf16 scales), in float32 and bfloat16;
* K2's plain version with scale planes agrees with the reference's
  ``paged_attention`` in Pallas interpret mode and its XLA twin (f32,
  rtol/atol 1e-5), for GQA and MHA; what lies in unmapped pages and past
  a row's position never reaches the output;
* ``make_engine(kind="paged", kv_quant="int8", device="cpu")`` gives the
  JAX paged engine's tokens (``kv_quant="int8"``) on a dense and a MoE
  smoke config, with equal ``resident_bytes`` before and after serving
  and after ``reset()``; copy-on-write copies the scale planes with the
  values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.kernels import paged_attention as ref_paged_attention
from repro.kernels.paged_attn import quantize_page_pool as ref_quantize
from repro.models import init_params as jax_init
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import (LAUNCH_COUNTERS, paged_attention,
                                 paged_attention_plain, quantize_page_pool)
from repro_torch.serve import make_engine, Request, validate_stats
from repro_torch.serve.paged_engine import PagedKVCache

TOL = 1e-5
OPTS = dict(max_slots=4, max_seq=64, page_size=8, window=4)
# (prompt length, max_new_tokens); rid 1 extends rid 0's first 16 tokens.
WORKLOAD = [(17, 6), (20, 5), (7, 3), (9, 6), (1, 4), (15, 7)]


def _to_torch(x):
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 8, 2, 64), (3, 4, 7, 16)])
def test_quantize_page_pool_is_bit_equal_to_the_reference(dtype, shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-1] + (1,))
         ).astype(np.float32)
    x[0, 0] = 0.0                                  # scale = 1e-8, values 0
    x[0, 1, 0, :4] = [127.5, -0.5, 0.5, 1.5]       # ties round to even
    jx = jnp.asarray(x).astype(dtype)
    want_q, want_s = ref_quantize(jx)
    got_q, got_s = quantize_page_pool(_to_torch(jx))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.bfloat16
    assert got_s.shape == shape[:-1] + (1,)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.view(torch.int16).numpy(),
                                  np.asarray(want_s).view(np.int16))


def _int8_case(seed, b, n_heads, n_kv, hd, psz, n_pages, pmax, pos):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n_heads, hd)).astype(np.float32)
    kv = [rng.standard_normal((n_pages + 1, psz, n_kv, hd)).astype(
        np.float32) for _ in range(2)]
    (pk, pks), (pv, pvs) = (ref_quantize(jnp.asarray(x)) for x in kv)
    table = np.full((b, pmax), n_pages, np.int32)         # sink everywhere
    pages = rng.permutation(n_pages).astype(np.int32)
    for row, p in enumerate(pos):
        n = p // psz + 1
        table[row, :n] = pages[:n]
        pages = pages[n:]
    return [jnp.asarray(q), pk, pv, jnp.asarray(table),
            jnp.asarray(pos, jnp.int32), pks, pvs]


@pytest.mark.parametrize("heads", [(4, 2), (14, 2), (4, 4)])
def test_k2_int8_plain_matches_pallas_and_xla(heads):
    n_heads, n_kv = heads
    # Positions on page edges (psz 4), rows whose tail maps the sink.
    jcase = _int8_case(n_heads, 5, n_heads, n_kv, 8, 4, 14, 5,
                       [0, 3, 4, 11, 19])
    q, pk, pv, table, pos, pks, pvs = map(_to_torch, jcase)
    got = paged_attention(q, pk, pv, table, pos, pks, pvs).numpy()
    plain = paged_attention_plain(q, pk, pv, table, pos, pks, pvs).numpy()
    np.testing.assert_array_equal(got, plain)
    for impl in ("pallas_interpret", "xla"):
        ref = np.asarray(ref_paged_attention(
            *jcase[:5], pk_scale=jcase[5], pv_scale=jcase[6], impl=impl))
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_k2_int8_ignores_unmapped_pages_and_masked_cells():
    """Overwrite the sink page and every cell past each row's position
    (values and scales) with other content: the output is unchanged."""
    pos = [0, 3, 4, 11, 19]
    case = list(map(_to_torch, _int8_case(1, 5, 4, 2, 8, 4, 14, 5, pos)))
    q, pk, pv, table, pos_t, pks, pvs = case
    before = paged_attention(*case)
    pk2, pv2, pks2, pvs2 = (t.clone() for t in (pk, pv, pks, pvs))
    for row, p in enumerate(pos):
        for j, phys in enumerate(table[row].tolist()):
            for off in range(4):
                if j * 4 + off > p:
                    pk2[phys, off] = 127
                    pv2[phys, off] = -127
                    pks2[phys, off] = 1e4
                    pvs2[phys, off] = 1e4
    after = paged_attention(q, pk2, pv2, table, pos_t, pks2, pvs2)
    assert not torch.equal(pk2, pk)
    torch.testing.assert_close(after, before, rtol=0, atol=0)


def test_k2_int8_launches_count_apart_and_planes_are_checked():
    q, pk, pv, table, pos, pks, pvs = map(
        _to_torch, _int8_case(0, 1, 2, 1, 8, 4, 2, 1, [0]))
    before = {k: c.n for k, c in LAUNCH_COUNTERS.items()}
    paged_attention(q, pk, pv, table, pos, pks, pvs)
    assert {k: c.n for k, c in LAUNCH_COUNTERS.items()} == before
    assert "paged_attn_int8" in LAUNCH_COUNTERS
    with pytest.raises(ValueError):
        paged_attention(q, pk, pv, table, pos, pks, None)
    meta = [t.to("meta") for t in (q, pk, pv, table, pos, pks, pvs)]
    with pytest.raises(ValueError):
        paged_attention(*meta)


def _setup(name):
    cfg = smoke_config(name)
    jparams = jax_init(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              torch_smoke_config(name), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n, _ in WORKLOAD]
    prompts[1][:16] = prompts[0][:16]
    return cfg, jparams, tparams, prompts


def _serve(eng, request_cls, prompts):
    for rid, (prompt, (_, budget)) in enumerate(zip(prompts, WORKLOAD)):
        eng.submit(request_cls(rid=rid, prompt=prompt.copy(),
                               max_new_tokens=budget))
    return sorted(eng.run(), key=lambda c: c.rid)


@pytest.mark.parametrize("name", ["qwen2.5-0.5b", "phi3.5-moe-42b"])
def test_int8_paged_engine_matches_jax(name):
    cfg, jparams, tparams, prompts = _setup(name)
    jeng = jax_make_engine(cfg, jparams, kind="paged", kv_quant="int8",
                           **OPTS)
    teng = make_engine(torch_smoke_config(name), tparams, kind="paged",
                       kv_quant="int8", device="cpu", **OPTS)
    configured = teng.cache.resident_bytes()
    assert configured == jeng.cache.resident_bytes()
    jout, tout = _serve(jeng, JaxRequest, prompts), _serve(teng, Request,
                                                            prompts)
    assert [(c.tokens, c.finish_reason) for c in tout] == \
        [(c.tokens, c.finish_reason) for c in jout]
    assert all(c.n_tokens == budget for c, (_, budget) in zip(tout, WORKLOAD))
    validate_stats(teng.stats)
    ext = teng.stats["engine"]
    assert ext["kv_pool"] == jeng.stats["engine"]["kv_pool"] == "int8"
    assert ext["pages_shared"] == jeng.stats["engine"]["pages_shared"] >= 1
    pools = teng.cache.pools
    assert pools["pk"].dtype == pools["pv"].dtype == torch.int8
    assert pools["pk_s"].dtype == pools["pv_s"].dtype == torch.bfloat16
    assert pools["pk_s"].shape == pools["pk"].shape[:-1] + (1,)
    assert teng.cache.n_free_pages == teng.cache.num_pages
    assert teng.cache.resident_bytes() == configured \
        == jeng.cache.resident_bytes()
    teng.reset()
    assert teng.cache.resident_bytes() == configured


def test_int8_pools_hold_half_the_bytes_and_copy_on_write_copies_scales():
    """Values in one byte plus a bf16 scale per (cell, KV head): the
    pools of a bf16 model take (hd + 2) / (2 hd) of its bf16 pools'.
    Copy-on-write of a shared page copies its scales with its values."""
    n_layers, hkv, hd, psz = 2, 2, 16, 4
    kw = dict(n_layers=n_layers, n_kv_heads=hkv, head_dim=hd,
              dtype=torch.bfloat16, device=torch.device("cpu"))
    flt = PagedKVCache(2, 8, psz, 3, **kw)
    q8 = PagedKVCache(2, 8, psz, 3, quant="int8", **kw)
    table = flt.table.numel() * 4
    assert (q8.resident_bytes() - table) * 2 * hd \
        == (flt.resident_bytes() - table) * (hd + 2)
    with pytest.raises(ValueError):
        PagedKVCache(2, 8, psz, 3, quant="fp8", **kw)

    rng = np.random.default_rng(7)
    kv = {k: torch.from_numpy(rng.standard_normal(
        (n_layers, 1, 2 * psz, hkv, hd)).astype(np.float32)).bfloat16()
        for k in ("k", "v")}
    s0, s1 = q8.acquire(), q8.acquire()
    assert q8.admit(kv, s0, 3) == 2
    pages = q8.mapped_pages(s0)
    want_q, want_s = quantize_page_pool(kv["k"][:, 0].reshape(
        n_layers, 2, psz, hkv, hd))
    assert torch.equal(q8.pools["pk"][:, pages], want_q)
    assert torch.equal(q8.pools["pk_s"][:, pages], want_s)
    assert q8.admit(kv, s1, 2, shared_pages=pages[:1]) == 1
    assert q8.mapped_pages(s1)[0] == pages[0]
    assert q8.make_writable(s1, 0)
    new = q8.mapped_pages(s1)[0]
    assert new != pages[0]
    for name in ("pk", "pv", "pk_s", "pv_s"):
        assert torch.equal(q8.pools[name][:, new], q8.pools[name][:, pages[0]])
    assert q8.pools["pk_s"][:, new].abs().min() > 0
