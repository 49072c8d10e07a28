"""The port's sharded train step against the reference's own sharded
step, which runs in a subprocess on 8 fake CPU devices
(``--xla_force_host_platform_device_count=8``): phi3.5-moe-42b smoke on
(2, 2) under both EP impls and yi-6b smoke on (2, 2), two steps each
from ``PRNGKey(0)`` weights on ``SyntheticLM(cfg, 8, 32)``.

Under ``"all_to_all"`` capacity is per (data, sequence-chunk) shard, so
no meshless step equals it (accumulation 1, 2 and 4 give 6.646872,
6.642024 and 6.648749 against its 6.642467): the reference's own step
is its only oracle.  Loss and ``grad_norm`` of each step and every
parameter after two within 1e-5, absolute and relative.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import smoke_config
from repro.models import init_params as jax_init
from repro_torch.configs import smoke_config as torch_smoke_config

from _torch_sharded_train import (assert_matches, port_run,
                                  one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
CASES = (("phi3.5-moe-42b", "psum"), ("phi3.5-moe-42b", "all_to_all"),
         ("yi-6b", "psum"))

_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import smoke_config
from repro.data import SyntheticLM
from repro.distributed.sharding import param_specs, to_named
from repro.models import init_params
from repro.models.moe import set_ep_impl
from repro.optim import adamw
from repro.train.train_step import make_train_step

out = sys.argv[1]
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
for name, impl in %r:
    set_ep_impl(impl)
    cfg = smoke_config(name)
    params = init_params(cfg, jax.random.PRNGKey(0))
    opt = adamw.init_state(params)
    params = jax.tree.map(jax.device_put, params,
                          to_named(param_specs(params, cfg, mesh), mesh))
    step = jax.jit(make_train_step(cfg, mesh, remat="none"))
    data = SyntheticLM(cfg, 8, 32)
    losses, norms = [], []
    with mesh:
        for s in range(2):
            batch = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    leaves = [np.asarray(x) for x in jax.tree.leaves(params)]
    np.savez(f"{out}/{name}-{impl}.npz", losses=np.asarray(losses),
             norms=np.asarray(norms),
             **{f"leaf{i}": x for i, x in enumerate(leaves)})
print("REFERENCE_SHARDED_OK")
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = "src"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _SCRIPT % (CASES,),
                          str(out)], capture_output=True, text=True,
                         timeout=600, env=env, cwd=root)
    assert "REFERENCE_SHARDED_OK" in run.stdout, run.stdout + \
        run.stderr[-3000:]
    return out


@pytest.mark.parametrize("name, impl", CASES,
                         ids=["-".join(c) for c in CASES])
def test_port_matches_reference_sharded_step(reference_runs, name, impl):
    ref = np.load(reference_runs / f"{name}-{impl}.npz")
    shapes = jax_init(smoke_config(name), jax.random.PRNGKey(0))
    leaves = [ref[f"leaf{i}"] for i in range(len(jax.tree.leaves(shapes)))]
    want = (list(ref["losses"]), list(ref["norms"]),
            jax.tree.unflatten(jax.tree.structure(shapes), leaves))
    got = port_run(name, (2, 2), 1, True, None, "none", impl=impl)
    assert_matches(got, want, torch_smoke_config(name))
    if impl == "all_to_all":
        assert abs(want[0][0] - 6.642467) < 1e-5
