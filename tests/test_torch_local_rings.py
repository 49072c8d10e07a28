"""Page rings for sliding-window (``LOCAL``) layers in the port's paged
engine, against the JAX package on the CPU, in float32 with TF32 off.

* **The ring allocator, white-box** (``PagedKVCache`` of both packages
  driven by the same calls): admission maps one fresh ring, regathered
  into ring-cell order with the cells ahead of the prompt zeroed and the
  other rows on the sink; ``advance_ring`` recycles the re-targeted
  columns through the FIFO free list; an exactly sized, fully held pool
  swaps a page with itself; rings plus the free list are always the
  pool, through seeded admissions, advances and releases.
* **Modules**: ``paged_local_attn_decode_step`` across the ring's wrap
  through a permuted ring table, and paged ``forward_decode`` on
  ``smoke_config("gemma3-1b")`` (12 layers, 5 LOCAL : 1 ATTN, window
  16) with float and int8 global pools: outputs, logits and pools
  within ``TOL``.
* **Engines**: ``make_engine(kind="paged")`` on gemma3 smoke (4 slots,
  ``max_seq`` 64, window 4, page 8: rings of 4 pages) passes
  ``check_parity`` against the JAX paged engine, with equal paged extras
  (``page_admits``, ``page_grows``, ``pages_mapped_peak``,
  ``pages_shared``, ``window_pages_reclaimed``, ``local_ring_pages``) and
  ``resident_bytes``: prompts across the window and up to ``max_seq``, a
  shared 16-token prefix, int8 pools, ``coexec_backend="kernel"`` and
  ``prefill_batch``; a long decode holds one ring while it reclaims;
  ``ServeFrontend`` under a seeded ``FaultPlan`` storm resolves every
  handle with the JAX offline tokens and leaks nothing; a prompt past
  the page table raises ``ValueError`` in both packages.  Global-only
  models keep their pool names, shapes and bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_frontend import drained, hold, Setup, WAIT
from _torch_serve_parity import (check_parity, engines, PAGE_SIZE,
                                 prompts_of, serve, serve_both, setup,
                                 WORKLOAD)
from repro.kernels.paged_attn import quantize_page_pool as jax_quantize
from repro.models import attention as jattn
from repro.models import forward_decode as jax_decode
from repro.serve import PagedKVCache as JaxPagedKVCache
from repro.serve import Request as JaxRequest
from repro_torch.configs.base import LOCAL
from repro_torch.convert import pools_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import forward_decode
from repro_torch.serve import FaultPlan, PagedKVCache, Request

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5
GEMMA = "gemma3-1b"
# (prompt length, max_new_tokens): around gemma3 smoke's window of 16,
# and up to max_seq = 64 (a 64-token prompt fills the page table).
WINDOW_WORK = [(1, 6), (7, 12), (15, 6), (16, 5), (17, 8), (23, 4),
               (31, 7), (33, 5)]
FULL_WORK = [(63, 3), (64, 2), (57, 8), (40, 30), (5, 6)]
WORKS = {"window": WINDOW_WORK, "full": FULL_WORK}
PAGED_EXTRAS = ("page_admits", "page_grows", "pages_mapped_peak",
                "pages_shared", "window_pages_reclaimed", "local_ring_pages")
# The JAX paged engine's extras on the window workload, as first read
# from it (every ring page of the 4 slots returned afterwards).
WINDOW_EXTRAS = [21, 6, 15, 0, 6, 4]
# The white-box pools: 4 slots, pages of 4, rings of 3 columns.
SLOTS, PAGES, PSZ, PMAX = 4, 10, 4, 6


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


# --------------------------------------------------------------------------
# The ring allocator, white-box
# --------------------------------------------------------------------------
def _caches(ring, n_local, slots=SLOTS):
    """A (JAX, port) pair of pools with one local layer of (1, 1)
    cells and no global layer."""
    return (JaxPagedKVCache(slots, PAGES, PSZ, PMAX, local_ring=ring,
                            num_local_pages=n_local),
            PagedKVCache(slots, PAGES, PSZ, PMAX, n_layers=0, n_kv_heads=1,
                         head_dim=1, dtype=torch.float32,
                         device=torch.device("cpu"), n_local_layers=1,
                         local_ring=ring, num_local_pages=n_local))


def _local_prefill(cap, fill):
    """A prefill whose dense local cell c holds fill + c (K) and
    fill + c + 0.5 (V), in each package's names."""
    vals = (fill + np.arange(cap, dtype=np.float32)).reshape(1, 1, cap, 1, 1)
    return ([{"b0": {"lk": jnp.asarray(vals), "lv": jnp.asarray(vals + .5)}}],
            {"wk": torch.from_numpy(vals.copy()),
             "wv": torch.from_numpy(vals + .5)})


def _same_state(jc, tc):
    """Both allocators and both local pools agree; rings plus the free
    list are the pool."""
    for slot in range(jc.max_slots):
        assert tc.local_pages_of(slot) == jc.local_pages_of(slot)
    assert list(tc._free_local) == list(jc._free_local)
    assert tc._lblock == jc._lblock
    np.testing.assert_array_equal(tc.ltable.numpy(), np.asarray(jc.ltable))
    held = [pg for slot in range(tc.max_slots)
            for pg in tc.local_pages_of(slot)]
    assert sorted(held + list(tc._free_local)) == list(
        range(tc.num_local_pages))
    if jc.pools is not None:
        for name in ("lk", "lv"):
            np.testing.assert_array_equal(
                tc.pools[name].numpy(), np.asarray(jc.pools[0]["b0"][name]))


def _admit(jc, tc, cap, fill, last):
    jcache, tcache = _local_prefill(cap, fill)
    slot = tc.acquire()
    assert jc.acquire() == slot
    assert tc.admit(tcache, slot, 0, last_index=last) == \
        jc.admit(jcache, slot, 0, last_index=last) == 0
    return slot


def test_ring_admission_regathers_and_sinks():
    jc, tc = _caches(3, 12)
    assert tc.tables().keys() == {"global", "local"}
    assert tc.n_free_local == 12 and tc.lsink == 12
    slot = _admit(jc, tc, PSZ, 100.0, last=2)
    _same_state(jc, tc)
    assert tc.n_free_local == 12 - 3
    row = tc.local_pages_of(slot)
    assert len(set(row)) == 3
    for s in range(SLOTS):
        if s != slot:
            assert (tc.ltable[s] == tc.lsink).all()
    lk = tc.pools["lk"][0, :, :, 0, 0].numpy()
    np.testing.assert_array_equal(
        lk[row[0]], np.where(np.arange(PSZ) <= 2, 100.0 + np.arange(PSZ), 0))
    assert not lk[row[1]].any() and not lk[row[2]].any()


@pytest.mark.parametrize("cap,last", [(16, 15), (16, 9), (8, 7), (16, 0)])
def test_ring_admission_of_a_prompt_past_the_ring(cap, last):
    """A dense ring of ``cap`` cells, longer than the 12-cell page ring
    or not, regathered at ``last``: cell t holds the position of (last -
    12, last] that is t mod 12, read from dense cell p mod cap."""
    jc, tc = _caches(3, 12)
    slot = _admit(jc, tc, cap, 10.0, last)
    _same_state(jc, tc)
    assert tc._lblock[slot] == last // PSZ
    flat = tc.pools["lk"][0, tc.local_pages_of(slot), :, 0, 0].reshape(-1)
    p = last - np.mod(last - np.arange(12), 12)
    want = np.where(p >= 0, 10.0 + np.mod(np.maximum(p, 0), cap), 0.0)
    np.testing.assert_array_equal(flat.numpy(), want)


def test_advance_ring_rotates_through_the_free_list():
    jc, tc = _caches(3, 12)
    slot = _admit(jc, tc, PSZ, 1.0, last=2)
    row0, free0 = tc.local_pages_of(slot), list(tc._free_local)
    assert tc.advance_ring(slot, 2) == jc.advance_ring(slot, 2) == 2
    _same_state(jc, tc)
    row1 = tc.local_pages_of(slot)
    assert row1[0] == row0[0] and row1[1:] == free0[:2]
    assert list(tc._free_local)[-2:] == row0[1:]
    assert tc.advance_ring(slot, 2) == 0                  # idempotent
    assert tc.advance_ring(slot, 5) == jc.advance_ring(slot, 5) == 3
    _same_state(jc, tc)
    assert tc.release(slot) == jc.release(slot) == []
    _same_state(jc, tc)
    assert tc.n_free_local == 12 and (tc.ltable[slot] == tc.lsink).all()


def test_an_exactly_sized_pool_swaps_a_page_with_itself():
    jc, tc = _caches(3, 3, slots=1)
    slot = _admit(jc, tc, PSZ, 1.0, last=2)
    row0 = tc.local_pages_of(slot)
    assert tc.n_free_local == 0
    assert tc.advance_ring(slot, 1) == jc.advance_ring(slot, 1) == 1
    assert tc.local_pages_of(slot) == row0
    assert tc.n_free_local == 0
    _same_state(jc, tc)
    with pytest.raises(ValueError, match="local pool"):
        PagedKVCache(1, PAGES, PSZ, PMAX, n_layers=0, n_kv_heads=1,
                     head_dim=1, dtype=torch.float32,
                     device=torch.device("cpu"), n_local_layers=1,
                     local_ring=3, num_local_pages=2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rings_and_the_free_list_are_always_the_pool(seed):
    """Seeded admissions, window advances, releases and a reset, the
    same on both packages: equal state after every call."""
    rng = np.random.default_rng(seed)
    jc, tc = _caches(3, 10)
    live = {}
    for _ in range(40):
        op = rng.integers(3)
        if op == 0 and tc.n_free and tc.n_free_local >= 3:
            last = int(rng.integers(0, 20))
            slot = _admit(jc, tc, 16, float(rng.integers(100)), last)
            live[slot] = last
        elif op == 1 and live:
            slot = int(rng.choice(sorted(live)))
            live[slot] += int(rng.integers(1, 9))
            blk = live[slot] // PSZ
            assert tc.advance_ring(slot, blk) == jc.advance_ring(slot, blk)
        elif live:
            slot = int(rng.choice(sorted(live)))
            del live[slot]
            assert tc.release(slot) == jc.release(slot)
        _same_state(jc, tc)
    tc.reset()
    jc.reset()
    _same_state(jc, tc)
    assert tc.n_free_local == 10 and (tc.ltable == tc.lsink).all()


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------
def _layer_params(jparams, tparams, layer):
    """Layer ``layer``'s mixer params in both packages (smoke gemma3:
    one scan group of 6 blocks, 2 repeats)."""
    rep, blk = divmod(layer, 6)
    jp = jax.tree.map(lambda a: a[rep], jparams["groups"][0][f"b{blk}"])
    return jp["mixer"], tparams["layers"][layer]["mixer"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_local_attn_decode_step_matches_jax(seed):
    """Rows before, at and past the wrap of a 4-page ring of 8-cell
    pages under a 16-cell window: outputs and the written pool."""
    cfg, tcfg, jparams, tparams = setup(GEMMA)
    assert cfg.layer_kinds()[0] == LOCAL
    jp, tp = _layer_params(jparams, tparams, 0)
    rng = np.random.default_rng(seed)
    ring, psz, n_pages, wcap = 4, 8, 40, 16
    pos = np.asarray([0, 5, 15, 16, 31, 32, 47, 70], np.int32)
    b = len(pos)
    table = rng.permutation(n_pages)[:b * ring].reshape(b, ring).astype(
        np.int32)
    table[0, 1:] = n_pages                              # on the sink
    shape = (n_pages + 1, psz, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    lk, lv = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    jout, jcache = jattn.paged_local_attn_decode_step(
        jp, jnp.asarray(x), {"lk": jnp.asarray(lk), "lv": jnp.asarray(lv)},
        jnp.asarray(table), jnp.asarray(pos), cfg, window_cap=wcap)
    tcache = {"lk": torch.from_numpy(lk.copy()),
              "lv": torch.from_numpy(lv.copy())}
    tout, got = tattn.paged_local_attn_decode_step(
        tp, torch.from_numpy(x), tcache, torch.from_numpy(table),
        torch.from_numpy(pos), tcfg, window_cap=wcap)
    assert got is tcache                                # written in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    for name in ("lk", "lv"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=TOL,
                                   atol=TOL)


def _jax_pools(cfg, rng, n_global, n_local, psz, quant):
    """The reference's per-group pools with seeded values: global blocks
    ``pk``/``pv`` (int8 with bf16 scales where ``quant``), local blocks
    ``lk``/``lv``."""
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    groups = []
    for pattern, reps in cfg.layer_groups():
        grp = {}
        for i, kind in enumerate(pattern):
            n, pre = (n_local, "l") if kind == LOCAL else (n_global, "p")
            blk = {}
            for name in "kv":
                x = jnp.asarray(rng.standard_normal(
                    (reps, n + 1, psz, hkv, hd)).astype(np.float32))
                if quant and pre == "p":
                    x, blk[f"p{name}_s"] = jax_quantize(x)
                blk[pre + name] = x
            grp[f"b{i}"] = blk
        groups.append(grp)
    return groups


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_forward_decode_matches_jax(quant):
    """Four steps of paged gemma3 decode (2 global layers through K2's
    plain version, 10 local through their rings) from seeded pools:
    logits and every pool within ``TOL``, greedy tokens equal."""
    cfg, tcfg, jparams, tparams = setup(GEMMA)
    rng = np.random.default_rng(3)
    psz, ring, n_global, n_local, pmax, wcap = 8, 4, 40, 14, 8, 16
    jpools = _jax_pools(cfg, rng, n_global, n_local, psz, quant)
    tpools = pools_from_jax(jax.tree.map(np.asarray, jpools), tcfg,
                            device="cpu")
    want = {"pk", "pv", "lk", "lv"} | ({"pk_s", "pv_s"} if quant else set())
    assert set(tpools) == want
    assert tpools["pk"].shape[0] == 2 and tpools["lk"].shape[0] == 10
    pos = np.asarray([3, 17, 30, 52], np.int32)
    # Rows share no global page; ring pages are drawn per row (two rows
    # may share one: both write it, as the JAX step does).
    tables = {"global": rng.permutation(n_global)[:4 * pmax].reshape(
        4, pmax).astype(np.int32),
        "local": np.stack([rng.permutation(n_local)[:ring]
                           for _ in range(4)]).astype(np.int32)}
    cur = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    for _ in range(4):
        jl, jpools = jax_decode(
            jparams, cfg, jnp.asarray(cur), jpools, jnp.asarray(pos),
            page_table={k: jnp.asarray(t) for k, t in tables.items()},
            window_cap=wcap)
        tl, got = forward_decode(
            tparams, tcfg, torch.from_numpy(cur), tpools,
            torch.from_numpy(pos),
            page_table={k: torch.from_numpy(t) for k, t in tables.items()},
            window_cap=wcap)
        assert got is tpools
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        nxt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1))
        assert (tl[:, -1, :cfg.vocab_size].argmax(-1).numpy() == nxt).all()
        cur, pos = nxt.astype(np.int32)[:, None], pos + 1
    ref = pools_from_jax(jax.tree.map(np.asarray, jpools), tcfg,
                         device="cpu")
    for name, t in tpools.items():
        np.testing.assert_allclose(t.float().numpy(), ref[name].float().numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------
def _check_engine(jeng, teng):
    """Equal paged extras and bytes; every pool class drained; rings plus
    the free list are the local pool."""
    jext, text = jeng.stats["engine"], teng.stats["engine"]
    for key in PAGED_EXTRAS:
        assert text[key] == jext[key], key
    assert teng.cache.resident_bytes() == jeng.cache.resident_bytes()
    c = teng.cache
    assert drained(teng) and c.n_free_local == c.num_local_pages
    assert (c.ltable == c.lsink).all()


def _paged(**kw):
    return engines(GEMMA, "paged", **kw)


@pytest.mark.parametrize("work", sorted(WORKS))
def test_paged_gemma3_matches_jax(work):
    jeng, teng = _paged()
    prompts = prompts_of(WORKS[work], setup(GEMMA)[1].vocab_size, seed=2)
    jout, tout = serve_both(jeng, teng, WORKS[work], prompts)
    check_parity(jeng, jout, teng, tout)
    _check_engine(jeng, teng)
    ext = teng.stats["engine"]
    assert teng.local_ring == ext["local_ring_pages"] == 4
    assert ext["window_pages_reclaimed"] > 0
    assert teng.cache.resident_bytes() == 121_024
    if work == "window":
        assert [ext[k] for k in PAGED_EXTRAS] == WINDOW_EXTRAS


def test_paged_gemma3_shares_a_prefix():
    """rid 1 extends rid 0's first 16 tokens: two global pages shared
    (prefix sharing is on with global layers), rings never shared."""
    jeng, teng = _paged()
    prompts = prompts_of(WORKLOAD, setup(GEMMA)[1].vocab_size, share=True)
    jout, tout = serve_both(jeng, teng, WORKLOAD, prompts)
    check_parity(jeng, jout, teng, tout)
    _check_engine(jeng, teng)
    assert teng.prefix_sharing and teng.stats["engine"]["pages_shared"] >= 2


def test_paged_gemma3_int8_pools_match_jax():
    """int8 global pools with bf16 scales; the rings stay float32."""
    jeng, teng = _paged(kv_quant="int8")
    work = WINDOW_WORK + FULL_WORK
    prompts = prompts_of(work, setup(GEMMA)[1].vocab_size, seed=4)
    jout, tout = serve_both(jeng, teng, work, prompts)
    check_parity(jeng, jout, teng, tout)
    _check_engine(jeng, teng)
    assert {k: v.dtype for k, v in teng.cache.pools.items()} == {
        "pk": torch.int8, "pv": torch.int8, "pk_s": torch.bfloat16,
        "pv_s": torch.bfloat16, "lk": torch.float32, "lv": torch.float32}
    assert teng.stats["engine"]["kv_pool"] == "int8"


def test_paged_gemma3_coexec_backfill_matches_jax():
    """More requests than slots, the packer's co-scheduled prefills run
    as backfill and admitted with their rings regathered."""
    jeng, teng = _paged(coexec="kernel")
    work = WINDOW_WORK + [(9, 5), (40, 6)]
    prompts = prompts_of(work, setup(GEMMA)[1].vocab_size, seed=5)
    jout, tout = serve_both(jeng, teng, work, prompts)
    check_parity(jeng, jout, teng, tout)
    _check_engine(jeng, teng)
    assert teng.stats["backfilled"] > 0


def test_paged_gemma3_prefill_batch_matches_jax():
    jeng, teng = _paged()
    work = WINDOW_WORK
    prompts = prompts_of(work, setup(GEMMA)[1].vocab_size, seed=3)
    reqs = {}
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        eng.reset()
        reqs[req_cls] = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=b)
                         for i, (p, (_, b)) in enumerate(zip(prompts, work))]
        eng.prefill_batch(reqs[req_cls])
    assert teng.stats["engine"]["prefill_batches"] >= 1
    outs = [sorted(eng.run(max_steps=4096), key=lambda c: c.rid)
            for eng in (jeng, teng)]
    check_parity(jeng, outs[0], teng, outs[1])
    for key in ("prefill_batches", "prefill_batched_reqs"):
        assert teng.stats["engine"][key] == jeng.stats["engine"][key]
    _check_engine(jeng, teng)


def test_a_long_decode_holds_one_ring_while_it_reclaims():
    """One request decoding 50 tokens: the local pages held stay at one
    ring after every window while the reclaimed count grows, step for
    step as on the JAX engine."""
    jeng, teng = _paged()
    prompt = np.arange(5, dtype=np.int32)
    trace = {}
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        eng.reset()
        eng.submit(req_cls(rid=0, prompt=prompt.copy(), max_new_tokens=50))
        fin, held, reclaimed = [], [], []
        while eng.step(fin):
            c = eng.cache
            held.append(c.num_local_pages - c.n_free_local)
            reclaimed.append(eng.stats["engine"]["window_pages_reclaimed"])
        trace[req_cls] = (fin[0].generated, held, reclaimed)
    assert trace[Request] == trace[JaxRequest]
    tokens, held, reclaimed = trace[Request]
    assert len(tokens) == 50
    assert set(held[:-1]) == {teng.local_ring} and held[-1] == 0
    assert reclaimed == sorted(reclaimed) and reclaimed[-1] >= 3
    _check_engine(jeng, teng)


def test_a_prompt_past_the_page_table_raises_in_both():
    """70 tokens at max_seq 64 take the exact-length prefill, whose
    cache cannot be cut into whole pages: both packages refuse it."""
    jeng, teng = _paged()
    work = [(70, 3)]
    prompts = prompts_of(work, setup(GEMMA)[1].vocab_size, seed=7)
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        with pytest.raises(ValueError, match="capacity 70 is not a "
                                             "multiple of page_size 8"):
            serve(eng, req_cls, work, prompts)
        eng.reset()


@pytest.mark.parametrize("seed", [0, 1])
def test_frontend_storm_over_paged_gemma3(seed):
    """``ServeFrontend`` over paged gemma3 on a global pool of 10 pages
    under a seeded ``FaultPlan``: every handle resolves, ``length``
    survivors equal the JAX offline serve (others truncate it), and
    every page, ring and slot comes back."""
    lens, budgets = [9, 17, 15, 7, 8, 12], [12] * 6
    jeng, _ = _paged()
    work = list(zip(lens, budgets))
    prompts = prompts_of(work, setup(GEMMA)[1].vocab_size, seed=9)
    want = {c.rid: c.tokens for c in serve(jeng, JaxRequest, work, prompts)}
    fx = Setup(GEMMA)
    try:
        eng = fx.engine("paged", num_pages=10)
        fe = fx.frontend(eng, fault_plan=FaultPlan.random(
            seed, n_events=10, horizon=24))
        _, go = hold(fe)
        hs = [fe.submit(p, b, rid=i)
              for i, (p, b) in enumerate(zip(prompts, budgets))]
        go.set()
        done = fe.drain(timeout=WAIT)
        fe.shutdown()
    finally:
        fx.close()
    assert len(done) == len(hs) and all(h.done for h in hs)
    for c in done:
        assert c.finish_reason in ("length", "cancelled", "deadline")
        n = len(c.tokens) if c.finish_reason != "length" else None
        assert c.tokens == want[c.rid][:n], c.rid
    assert fe.fault_log
    assert drained(eng) and eng.cache.n_free_local == eng.num_local_pages


@pytest.mark.parametrize("name", ["qwen2.5-0.5b", "yi-6b", "phi3.5-moe-42b"])
def test_global_only_models_keep_their_pools(name):
    jeng, teng = engines(name, "paged")
    cfg = setup(name)[1]
    shape = (cfg.n_layers, teng.num_pages + 1, PAGE_SIZE, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    assert {k: tuple(t.shape) for k, t in teng.cache.pools.items()} == \
        {"pk": shape, "pv": shape}
    assert teng.cache.tables().keys() == {"global"}
    assert teng.cache.ltable is None and teng.local_ring == 0
    assert teng.stats["engine"]["local_ring_pages"] == 0
    assert teng.cache.resident_bytes() == jeng.cache.resident_bytes()
    assert teng.prefix_sharing
