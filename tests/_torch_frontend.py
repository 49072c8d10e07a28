"""Shared pieces of the port's frontend tests (not collected).

yi-6b's smoke config in float32, as the reference's frontend tests use:
JAX weights from ``repro.models.init_params``, the port's converted from
them (``params_from_jax``).  Expected tokens come from the JAX engine's
offline ``run()`` of the same workload; one JAX engine per (kind,
options) is built per module and ``reset()`` between workloads.

No test may depend on how fast a thread runs: where the order of
submissions and scheduler cycles matters, :func:`hold` parks the
scheduler at the start of an intake flush until the test has acted.
"""
import threading

import jax
import numpy as np

from repro.configs import smoke_config
from repro.models import init_params as jax_init
from repro.serve import make_engine as jax_make_engine
from repro.serve import Request as JaxRequest
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.serve import make_engine, ServeFrontend

NAME = "yi-6b"
OPTS = dict(max_slots=4, max_seq=64, window=4)
PSZ = 8
# Every drain/result wait of these tests ends within this many seconds.
WAIT = 120


class Setup:
    """The smoke config's JAX and port weights, port engines on the CPU,
    the JAX offline reference, and every frontend a test made (shut down
    at teardown, also when the test fails)."""

    def __init__(self, name=NAME):
        self.cfg = smoke_config(name)
        self.jparams = jax_init(self.cfg, jax.random.PRNGKey(0))
        self.tcfg = torch_smoke_config(name)
        self.tparams = params_from_jax(
            jax.tree.map(np.asarray, self.jparams), self.tcfg, device="cpu")
        self._jax = {}
        self._frontends = []

    def engine(self, kind="slot", **kw):
        """A fresh port engine of ``kind`` on the CPU."""
        if kind == "paged":
            kw.setdefault("page_size", PSZ)
        return make_engine(self.tcfg, self.tparams, kind=kind,
                           device="cpu", **OPTS, **kw)

    def frontend(self, engine, **kw):
        fe = ServeFrontend(engine, **kw)
        self._frontends.append(fe)
        return fe

    def close(self):
        while self._frontends:
            self._frontends.pop().shutdown(drain=False)

    def prompts(self, lens, seed=0):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, self.cfg.vocab_size, size=s).astype(np.int32)
                for s in lens]

    def offline(self, prompts, budgets, kind="slot", **kw):
        """rid -> tokens of the JAX engine's offline ``run()``."""
        if kind == "paged":
            kw.setdefault("page_size", PSZ)
        key = (kind, tuple(sorted(kw.items())))
        if key not in self._jax:
            self._jax[key] = jax_make_engine(self.cfg, self.jparams,
                                             kind=kind, **OPTS, **kw)
        eng = self._jax[key]
        eng.reset()
        for rid, (p, b) in enumerate(zip(prompts, budgets)):
            eng.submit(JaxRequest(rid=rid, prompt=p.copy(),
                                  max_new_tokens=b))
        return {c.rid: c.tokens for c in eng.run(max_steps=4096)}


def hold(fe, flush=1, until=None):
    """Park ``fe``'s scheduler at the start of its ``flush``-th intake
    flush (outside the mutex, so submits and cancels still go through)
    until ``until`` (an Event; default a new one) is set.  Install it
    before the first submit.  Returns ``(reached, until)``: ``reached``
    is set once the scheduler is parked."""
    reached = threading.Event()
    until = until or threading.Event()
    real = fe._intake_flush
    calls = [0]

    def flush_held():
        calls[0] += 1
        if calls[0] == flush:
            reached.set()
            until.wait(WAIT)
        return real()

    fe._intake_flush = flush_held
    return reached, until


def drained(eng):
    """The paged engine's storage is back to empty: slots, pages,
    reservations, orphans and the prefix registry."""
    c = eng.cache
    return (c.n_free == eng.max_batch and c.n_free_pages == c.num_pages
            and c.reserved_total == 0 and c.orphaned_pages == 0
            and not eng._prefix_registry and not eng._page_key)
