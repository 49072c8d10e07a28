"""whisper-base's cross page pool in the port's paged engine, against the
JAX package on the CPU, on ``smoke_config("whisper-base")`` in float32
with TF32 off (12 encoder frames: pages of 8 leave 4 pad cells in a
block's last page).

* **The cross allocator, white-box** (``PagedKVCache`` of both packages
  driven by the same admit/release calls): fresh blocks popped lowest
  first and written once, zero-padded; blocks mapped by reference;
  ``cross_pages_of``, ``cross_refcount``, ``n_free_cross``,
  ``drain_freed_cross``, ``reserved_pages``, ``shared_pages_of``, the
  cross table, the pools and ``resident_bytes``; the two ``ValueError``
  s (cross stacks into a pool without cross pages; a cross pool smaller
  than one block).
* **Modules**: ``paged_cross_attn_decode`` against the JAX function on
  pools from ``pools_from_jax`` with the pad cells poisoned, and bit for
  bit the port's dense ``cross_attn_decode``; paged ``forward_decode``
  steps with a ``"cross"`` table against the JAX step, float and int8
  global pools, ``ck``/``cv`` unchanged.
* **Engines**: ``make_engine(kind="paged")`` against the JAX paged
  engine (4 slots, ``max_seq`` 64, windows of 4, pages of 8) through
  ``check_parity``, with per-request features that share a block, carry
  None and explicit zeros (one block) or their own: ``cross_admits``,
  ``cross_shared``, ``page_admits``, ``pages_mapped_peak`` and
  ``resident_bytes`` equal, ``pages_shared`` 0 (no prefix sharing on
  enc-dec), every page of both classes back; int8 global pools with the
  cross pools at model precision; a preemption storm; ``reset``;
  ``ServeFrontend`` against the JAX offline run; a ``FaultPlan`` storm
  leaking nothing; ``launch.serve --engine paged``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_frontend import drained, hold, WAIT
from _torch_serve_parity import (check_parity, completion, engines, OPTS,
                                 PAGE_SIZE, serve, serve_both, setup, submit)
from repro.kernels.paged_attn import quantize_page_pool as jax_quantize
from repro.models import attention as jattn
from repro.models import forward_decode as jax_decode
from repro.serve import PagedKVCache as JaxPagedKVCache
from repro.serve import Request as JaxRequest
from repro_torch.convert import pools_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as tattn
from repro_torch.models import forward_decode
from repro_torch.serve import (FaultPlan, make_engine, PagedKVCache, Request,
                               ServeFrontend)

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5
NAME = "whisper-base"
# (prompt length, max_new_tokens): 8 requests on 4 slots around the
# window of 4, all within max_seq = 64 (a page table of 8 pages).
WORK = [(1, 6), (7, 12), (15, 6), (16, 5), (17, 8), (23, 4), (31, 7),
        (33, 5)]
EXTRAS = ("cross_admits", "cross_shared", "page_admits", "page_grows",
          "pages_mapped_peak", "pages_shared")
# The white-box pools: 4 slots, pages of 4, 5 frames (2 cross pages a
# block, 3 pad cells), 3 blocks of cross pages.
SLOTS, PAGES, PSZ, PMAX, FRAMES, CROSS, NCROSS = 4, 12, 4, 3, 5, 2, 6


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _cfg():
    return setup(NAME)[1]


# --------------------------------------------------------------------------
# The cross allocator, white-box
# --------------------------------------------------------------------------
def _caches(num_cross=NCROSS):
    """A (JAX, port) pair of pools with one global layer and one cross
    layer of (1, 2) cells."""
    return (JaxPagedKVCache(SLOTS, PAGES, PSZ, PMAX, cross_pages=CROSS,
                            num_cross_pages=num_cross),
            PagedKVCache(SLOTS, PAGES, PSZ, PMAX, n_layers=1, n_kv_heads=1,
                         head_dim=2, dtype=torch.float32,
                         device=torch.device("cpu"), n_cross_layers=1,
                         cross_pages=CROSS, num_cross_pages=num_cross))


def _prefill(rng, cap, feature):
    """A prefill of ``cap`` cells with cross K/V that are a function of
    ``feature`` alone, in each package's names."""
    k, v = (rng.standard_normal((1, 1, cap, 1, 2)).astype(np.float32)
            for _ in "kv")
    xk, xv = (np.random.default_rng(100 + feature + off).standard_normal(
        (1, 1, FRAMES, 1, 2)).astype(np.float32) for off in (0, 50))
    jc = [{"b0": {"self": {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                  "cross": {"ck": jnp.asarray(xk), "cv": jnp.asarray(xv)}}}]
    tc = {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
          "xk": torch.from_numpy(xk), "xv": torch.from_numpy(xv)}
    return jc, tc


def _same_state(jc, tc):
    """Both allocators, tables and pools agree; blocks plus the free list
    are the cross pool."""
    for slot in range(SLOTS):
        assert tc.cross_pages_of(slot) == jc.cross_pages_of(slot)
        assert tc.reserved_pages(slot) == jc.reserved_pages(slot)
        assert tc.shared_pages_of(slot) == jc.shared_pages_of(slot)
        assert tc.mapped_pages(slot) == jc.mapped_pages(slot)
    assert [tc.cross_refcount(p) for p in range(tc.num_cross_pages)] == \
        [jc.cross_refcount(p) for p in range(jc.num_cross_pages)]
    assert tc._free_cross == jc._free_cross
    assert tc.n_free_cross == jc.n_free_cross
    assert tc.n_free_pages == jc.n_free_pages
    np.testing.assert_array_equal(tc.ctable.numpy(), np.asarray(jc.ctable))
    np.testing.assert_array_equal(tc.table.numpy(), np.asarray(jc.table))
    held = {p for slot in range(SLOTS) for p in tc.cross_pages_of(slot)}
    assert sorted(held | set(tc._free_cross)) == list(
        range(tc.num_cross_pages))
    assert not held & set(tc._free_cross)
    if jc.pools is not None:
        assert tc.resident_bytes() == jc.resident_bytes()
        for name, blk in (("pk", "self"), ("pv", "self"), ("ck", "cross"),
                          ("cv", "cross")):
            np.testing.assert_array_equal(
                tc.pools[name].numpy(),
                np.asarray(jc.pools[0]["b0"][blk][name]), err_msg=name)


def test_cross_admission_writes_a_padded_block_and_shares_it():
    jc, tc = _caches()
    assert tc.tables().keys() == {"global", "cross"}
    assert tc.csink == NCROSS and tc.n_free_cross == NCROSS
    rng = np.random.default_rng(0)
    slots = []
    for shared in (None, [0, 1]):
        jcache, tcache = _prefill(rng, PSZ, feature=0)
        slot = tc.acquire()
        assert jc.acquire() == slot
        assert tc.admit(tcache, slot, 2, cross_shared=shared) == \
            jc.admit(jcache, slot, 2, cross_shared=shared) == 1
        slots.append(slot)
        _same_state(jc, tc)
    assert tc.cross_pages_of(slots[0]) == tc.cross_pages_of(slots[1]) \
        == [0, 1]
    assert tc.cross_refcount(0) == tc.cross_refcount(1) == 2
    ck = tc.pools["ck"][0, :2].reshape(2 * PSZ, 2)
    np.testing.assert_array_equal(ck[:FRAMES].numpy(),
                                  tcache["xk"][0, 0, :, 0].numpy())
    assert not ck[FRAMES:].any()                  # the pad cells are zero
    assert (tc.ctable[2:] == tc.csink).all()
    freed = []
    for slot in slots:
        tc.release(slot)
        jc.release(slot)
        got = tc.drain_freed_cross()
        assert got == jc.drain_freed_cross()
        freed.append(got)
        _same_state(jc, tc)
    assert freed == [[], [0, 1]]          # a block drains with its last holder
    assert tc.drain_freed_cross() == [] and (tc.ctable == tc.csink).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_admissions_and_releases_match_jax(seed):
    """Seeded admissions of three feature blocks (by reference while the
    block is live, as the engine's registry does) and releases: both
    allocators, tables and pools agree after every call."""
    jc, tc = _caches()
    rng = np.random.default_rng(seed)
    live, registry, key_of = {}, {}, {}
    for _ in range(24):
        free_slots = tc.n_free
        if live and (not free_slots or rng.random() < 0.4):
            slot = int(rng.choice(sorted(live)))
            tc.release(slot)
            jc.release(slot)
            del live[slot]
            drained = tc.drain_freed_cross()
            assert drained == jc.drain_freed_cross()
            for pg in drained:
                registry.pop(key_of.pop(pg, None), None)
        else:
            feature = int(rng.integers(0, 3))
            block = registry.get(feature)
            if block is None and tc.n_free_cross < CROSS:
                continue
            jcache, tcache = _prefill(rng, PSZ * int(rng.integers(1, 3)),
                                      feature)
            if not tc.can_reserve(PMAX):
                continue
            slot = tc.acquire()
            assert jc.acquire() == slot
            assert tc.admit(tcache, slot, PMAX, cross_shared=block) == \
                jc.admit(jcache, slot, PMAX, cross_shared=block)
            live[slot] = feature
            if block is None:
                registry[feature] = tc.cross_pages_of(slot)
                key_of[registry[feature][0]] = feature
        _same_state(jc, tc)


def test_cross_value_errors_match_jax():
    """Cross stacks into a pool built without cross pages, and a cross
    pool smaller than one block, raise in both packages; the port also
    refuses a fresh block when too few cross pages are free."""
    rng = np.random.default_rng(3)
    jcache, tcache = _prefill(rng, PSZ, feature=0)
    jc = JaxPagedKVCache(SLOTS, PAGES, PSZ, PMAX)
    tc = PagedKVCache(SLOTS, PAGES, PSZ, PMAX, n_layers=1, n_kv_heads=1,
                      head_dim=2, dtype=torch.float32,
                      device=torch.device("cpu"))
    for cache, c in ((jc, jcache), (tc, tcache)):
        with pytest.raises(ValueError, match="cross_pages=0"):
            cache.admit(c, cache.acquire(), 2)
    with pytest.raises(ValueError, match="cannot hold one encoder block"):
        JaxPagedKVCache(SLOTS, PAGES, PSZ, PMAX, cross_pages=CROSS,
                        num_cross_pages=CROSS - 1)
    with pytest.raises(ValueError, match="cannot hold one encoder block"):
        PagedKVCache(SLOTS, PAGES, PSZ, PMAX, n_layers=1, n_kv_heads=1,
                     head_dim=2, dtype=torch.float32,
                     device=torch.device("cpu"), n_cross_layers=1,
                     cross_pages=CROSS, num_cross_pages=CROSS - 1)
    _, tc = _caches(num_cross=CROSS)
    tc.admit(tcache, tc.acquire(), 2)
    with pytest.raises(ValueError, match="no free cross block"):
        tc.admit(tcache, tc.acquire(), 2)
    assert tc.cross_pages_of(1) == [] and tc.n_free_pages == PAGES - 1


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------
def _jax_pools(cfg, rng, n_global, n_cross, psz, quant):
    """The reference's pools with seeded values: ``{"self": pk/pv (int8
    with bf16 scales where ``quant``), "cross": ck/cv}`` per layer."""
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    (pattern, reps), = cfg.layer_groups()

    def vals(n):
        return jnp.asarray(rng.standard_normal(
            (reps, n + 1, psz, hkv, hd)).astype(np.float32))

    own = {}
    for name in "kv":
        x = vals(n_global)
        if quant:
            x, own[f"p{name}_s"] = jax_quantize(x)
        own["p" + name] = x
    return [{"b0": {"self": own,
                    "cross": {"ck": vals(n_cross), "cv": vals(n_cross)}}}]


def _poison_pads(pools, table, enc_len, psz, value=1e4):
    """Fill every cell past ``enc_len`` of each row's block with
    ``value`` (in place)."""
    last = table[:, -1]
    for name in ("ck", "cv"):
        pools[name][:, last, enc_len - (table.shape[1] - 1) * psz:] = value


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_cross_attn_decode_matches_jax_and_dense(seed):
    cfg, tcfg, jparams, tparams = setup(NAME)
    rng = np.random.default_rng(seed)
    psz, n_cross, b = 8, 12, 4
    c = -(-cfg.enc_frames // psz)
    table = rng.permutation(n_cross)[:b * c].reshape(b, c).astype(np.int32)
    jpools = _jax_pools(cfg, rng, 4, n_cross, psz, False)
    tpools = pools_from_jax(jax.tree.map(np.asarray, jpools), tcfg,
                            device="cpu")
    _poison_pads(tpools, table, cfg.enc_frames, psz)
    layer = {n: tpools[n][0] for n in ("ck", "cv")}
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][0]["b0"])["cross"]
    tp = tparams["layers"][0]["cross"]
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    got = tattn.paged_cross_attn_decode(
        tp, torch.from_numpy(x), layer, torch.from_numpy(table), tcfg,
        enc_len=tcfg.enc_frames)
    want = jattn.paged_cross_attn_decode(
        jp, jnp.asarray(x), {n: jnp.asarray(t.numpy())
                             for n, t in layer.items()},
        jnp.asarray(table), cfg, enc_len=cfg.enc_frames)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    dense = {k: layer["c" + k][torch.from_numpy(table).long()].reshape(
        b, -1, tcfg.n_kv_heads, tcfg.resolved_head_dim)[:, :tcfg.enc_frames]
        .contiguous() for k in "kv"}
    assert dense["k"].abs().max() < 1e3           # no poisoned cell in it
    assert torch.equal(got, tattn.cross_attn_decode(
        tp, torch.from_numpy(x), dense, tcfg))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_forward_decode_with_a_cross_table_matches_jax(quant):
    """Three paged decode steps (self attention through K2's plain
    version, cross attention through the cross table) from seeded pools:
    logits and the global pools within ``TOL``, greedy tokens equal, the
    cross pools unchanged."""
    cfg, tcfg, jparams, tparams = setup(NAME)
    rng = np.random.default_rng(4)
    psz, n_global, n_cross, pmax, b = 8, 24, 12, 4, 3
    c = -(-cfg.enc_frames // psz)
    jpools = _jax_pools(cfg, rng, n_global, n_cross, psz, quant)
    tpools = pools_from_jax(jax.tree.map(np.asarray, jpools), tcfg,
                            device="cpu")
    want = {"pk", "pv", "ck", "cv"} | ({"pk_s", "pv_s"} if quant else set())
    assert set(tpools) == want and tpools["ck"].shape[0] == tcfg.n_layers
    held = {n: tpools[n].clone() for n in ("ck", "cv")}
    tables = {"global": rng.permutation(n_global)[:b * pmax].reshape(
        b, pmax).astype(np.int32),
        "cross": np.stack([rng.permutation(n_cross)[:c]
                           for _ in range(b)]).astype(np.int32)}
    pos = np.asarray([2, 9, 20], np.int32)
    cur = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    for _ in range(3):
        jl, jpools = jax_decode(
            jparams, cfg, jnp.asarray(cur), jpools, jnp.asarray(pos),
            page_table={k: jnp.asarray(t) for k, t in tables.items()})
        tl, got = forward_decode(
            tparams, tcfg, torch.from_numpy(cur), tpools,
            torch.from_numpy(pos),
            page_table={k: torch.from_numpy(t) for k, t in tables.items()})
        assert got is tpools
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        nxt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1))
        assert (tl[:, -1, :cfg.vocab_size].argmax(-1).numpy() == nxt).all()
        cur, pos = nxt.astype(np.int32)[:, None], pos + 1
    ref = pools_from_jax(jax.tree.map(np.asarray, jpools), tcfg,
                         device="cpu")
    for name, t in tpools.items():
        np.testing.assert_allclose(t.float().numpy(),
                                   ref[name].float().numpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)
    for name, t in held.items():
        assert torch.equal(tpools[name], t), name


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------
def _prompts(work, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, _cfg().vocab_size, n, dtype=np.int32)
            for n, _ in work]


def _features(n, seed):
    """Seeded feature blocks: rid 3 carries rid 0's, rid 1 None and rid 2
    explicit zeros (one block: the key is the encoder input's bytes),
    the others their own."""
    cfg = _cfg()
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((cfg.enc_frames, cfg.frontend_dim)
                               ).astype(np.float32) for _ in range(n)]
    out[1] = None
    out[2] = np.zeros((cfg.enc_frames, cfg.frontend_dim), np.float32)
    out[3] = out[0]
    return out


def _check_drained(teng):
    """Every slot and page of both classes back, the registries empty."""
    c = teng.cache
    assert drained(teng)
    assert c.n_free_cross == c.num_cross_pages
    assert not any(c.cross_refcount(p) for p in range(c.num_cross_pages))
    assert (c.ctable == c.csink).all()
    assert not teng._cross_registry and not teng._cross_key


def _check_engine(jeng, teng):
    jext, text = jeng.stats["engine"], teng.stats["engine"]
    for key in EXTRAS:
        assert text[key] == jext[key], key
    assert text["pages_shared"] == 0 and not teng.prefix_sharing
    assert teng.cache.resident_bytes() == jeng.cache.resident_bytes()
    _check_drained(teng)


def test_paged_whisper_matches_jax():
    jeng, teng = engines(NAME, "paged")
    prompts, enc = _prompts(WORK, seed=1), _features(len(WORK), seed=2)
    jout, tout = serve_both(jeng, teng, WORK, prompts, enc=enc)
    check_parity(jeng, jout, teng, tout)
    _check_engine(jeng, teng)
    cfg, ext = _cfg(), teng.stats["engine"]
    # rids 0 and 3 are resident together, rids 1 and 2 too
    assert ext["cross_shared"] >= 2
    assert ext["cross_admits"] + ext["cross_shared"] == len(WORK)
    c = -(-cfg.enc_frames // PAGE_SIZE)
    shape = (cfg.n_layers, 4 * c + 1, PAGE_SIZE, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    pools = teng.cache.pools
    assert teng.cross_pages == c and tuple(pools["ck"].shape) == shape
    assert set(pools) == {"pk", "pv", "ck", "cv"}
    assert teng.cache.tables().keys() == {"global", "cross"}


def test_paged_whisper_int8_pools_keep_the_cross_pools_at_model_precision():
    jeng, teng = engines(NAME, "paged", kv_quant="int8")
    prompts, enc = _prompts(WORK, seed=3), _features(len(WORK), seed=4)
    jout, tout = serve_both(jeng, teng, WORK, prompts, enc=enc)
    check_parity(jeng, jout, teng, tout)
    _check_engine(jeng, teng)
    assert {k: v.dtype for k, v in teng.cache.pools.items()} == {
        "pk": torch.int8, "pv": torch.int8, "pk_s": torch.bfloat16,
        "pv_s": torch.bfloat16, "ck": torch.float32, "cv": torch.float32}


def _storm(eng, request_cls, work, prompts, enc):
    """Serve with three forced preemptions after the first window."""
    eng.reset()
    submit(eng, request_cls, work, prompts, enc=enc)
    finished = []
    eng.step(finished)
    assert eng.preempt(3) == 3
    return sorted(eng.run(max_steps=4096)
                  + [completion(r) for r in finished], key=lambda c: c.rid)


def test_preemption_storm_releases_and_remaps_cross_blocks():
    """Residents preempted after the first window release their cross
    references and, on resume, map a still-live block or a fresh one,
    as the JAX engine does: tokens and every stat equal."""
    jeng, teng = engines(NAME, "paged")
    prompts, enc = _prompts(WORK, seed=5), _features(len(WORK), seed=6)
    jout = _storm(jeng, JaxRequest, WORK, prompts, enc)
    tout = _storm(teng, Request, WORK, prompts, enc)
    check_parity(jeng, jout, teng, tout)
    _check_engine(jeng, teng)
    assert teng.stats["engine"]["preemptions"] == 3


def test_reset_clears_both_registries():
    _, teng = engines(NAME, "paged")
    teng.reset()
    prompts, enc = _prompts(WORK[:4], seed=7), _features(4, seed=8)
    submit(teng, Request, WORK[:4], prompts, enc=enc)
    teng.step([])
    assert teng._cross_registry and teng._cross_key
    assert teng.cache.n_free_cross < teng.cache.num_cross_pages
    teng.reset()
    _check_drained(teng)
    assert not teng._prefix_registry and teng.stats["engine"][
        "cross_admits"] == 0


def test_frontend_over_paged_matches_jax_offline():
    """The workload through ``ServeFrontend`` over the paged engine (its
    submit takes no features: every request maps the one zero block),
    submitted while the scheduler is parked: the JAX engine's offline
    streams, and every page of both classes back."""
    jeng, _ = engines(NAME, "paged")
    _, tcfg, _, tparams = setup(NAME)
    prompts = _prompts(WORK, seed=9)
    want = serve(jeng, JaxRequest, WORK, prompts)
    eng = make_engine(tcfg, tparams, kind="paged", device="cpu",
                      page_size=PAGE_SIZE, **OPTS)
    fe = ServeFrontend(eng)
    try:
        reached, release = hold(fe)
        handles = [fe.submit(p, b, rid=i)
                   for i, (p, (_, b)) in enumerate(zip(prompts, WORK))]
        assert reached.wait(WAIT)
        release.set()
        got = {c.rid: c for c in fe.drain(timeout=WAIT)}
    finally:
        fe.shutdown(drain=False)
    assert all(h.done for h in handles)
    assert [(c.rid, c.tokens, c.finish_reason) for c in want] == \
        [(r, got[r].tokens, got[r].finish_reason) for r in sorted(got)]
    assert eng.stats["engine"]["cross_admits"] == 1
    _check_drained(eng)


@pytest.mark.parametrize("seed", [0, 1])
def test_fault_storm_over_paged_whisper_leaks_nothing(seed):
    """``ServeFrontend`` over paged whisper on a global pool of 10 pages
    under a seeded ``FaultPlan``: every handle resolves, ``length``
    survivors equal the JAX offline serve (others truncate it), and
    every slot, global page and cross page comes back."""
    lens, budgets = [9, 17, 15, 7, 8, 12], [12] * 6
    work = list(zip(lens, budgets))
    jeng, _ = engines(NAME, "paged")
    _, tcfg, _, tparams = setup(NAME)
    prompts = _prompts(work, seed=10 + seed)
    want = {c.rid: c.tokens for c in serve(jeng, JaxRequest, work, prompts)}
    eng = make_engine(tcfg, tparams, kind="paged", device="cpu",
                      page_size=PAGE_SIZE, num_pages=10, **OPTS)
    fe = ServeFrontend(eng, fault_plan=FaultPlan.random(
        seed, n_events=10, horizon=24))
    try:
        _, go = hold(fe)
        hs = [fe.submit(p, b, rid=i)
              for i, (p, b) in enumerate(zip(prompts, budgets))]
        go.set()
        done = fe.drain(timeout=WAIT)
    finally:
        fe.shutdown(drain=False)
    assert len(done) == len(hs) and all(h.done for h in hs)
    for c in done:
        assert c.finish_reason in ("length", "cancelled", "deadline")
        n = len(c.tokens) if c.finish_reason != "length" else None
        assert c.tokens == want[c.rid][:n], c.rid
    assert fe.fault_log
    _check_drained(eng)


def test_launch_serve_paged_runs_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", NAME, "--smoke", "--requests", "3",
                              "--max-seq", "64", "--engine", "paged",
                              "--device", "cpu"]) == 0
    assert "3/3 done" in capsys.readouterr().out
