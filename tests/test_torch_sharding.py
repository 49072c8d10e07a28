"""The port's mesh, placement and sharding rules against the JAX
package's (``repro.distributed.sharding``, ``repro.distributed.fault``).

* ``_fit`` / ``_spec``, ``param_specs`` (``fsdp`` both ways, with and
  without a pod axis) and ``cache_specs`` (every leaf name the engines
  allocate, ``batch_axes`` both ways) equal the reference's on a
  duck-typed mesh, leaf for leaf, for every registry config's
  ``smoke_config`` at six mesh shapes; a port parameter leaf maps to
  its reference leaf minus the stacked dimension.
* the ``MeshSharder`` role table equals the reference's constraints;
* ``plan_elastic_mesh`` and ``simulate_failure`` give the reference's
  values;
* placement: every device's tensors are allocations of their own, and
  the shards join back bitwise; ``Sharded`` indexing, gathering and
  parts; the collectives against plain NumPy and ``jax.lax``'s under
  ``jax.vmap``; ``Mesh()`` raises without a card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.distributed import fault as jfault
from repro.distributed import sharding as jsh
from repro.models import init_params as jax_init
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import _unstack_layers
from repro_torch.configs.base import BIDIR
from repro_torch.distributed import (all_gather, all_reduce_sum, all_to_all,
                                     cache_specs, Mesh, MeshSharder, P,
                                     param_specs, place_params,
                                     plan_elastic_mesh, shard_tensor,
                                     shard_tree, simulate_failure,
                                     unshard_tensor, unshard_tree,
                                     virtual_mesh)
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.mesh import Sharded
from repro_torch.models import init_params

SHAPES = ((1, 2), (2, 2), (1, 4), (2, 4), (4, 2), (1, 8))
NAMES = tuple(all_configs())


@dataclasses.dataclass
class FakeMesh:
    """Duck-typed mesh: the rules read only ``.shape`` and
    ``.axis_names``."""
    shape: dict
    axis_names: tuple


def _meshes(shape, pod=False):
    axes = ("pod", "data", "model") if pod else ("data", "model")
    sizes = ((2,) if pod else ()) + shape
    return FakeMesh(dict(zip(axes, sizes)), axes)


def _t(spec):
    return tuple(spec)


def test_fit_and_spec_equal_reference():
    for shape in SHAPES:
        for pod in (False, True):
            mesh = _meshes(shape, pod)
            for dim in (1, 2, 3, 4, 6, 8, 12, 16, 64, 96):
                for axes in (None, "model", "data", ("data", "model"),
                             ("pod", "data") if pod else ("data",)):
                    assert tsh._fit(mesh, dim, axes) == \
                        jsh._fit(mesh, dim, axes), (shape, dim, axes)
                assert _t(tsh._spec(mesh, (dim, 8), "model", None)) == \
                    _t(jsh._spec(mesh, (dim, 8), "model", None))


_PARAMS = {}


def _param_trees(name):
    """(JAX cfg, port cfg, JAX shapes, port params) of a smoke config."""
    if name not in _PARAMS:
        cfg = smoke_config(name)
        shapes = jax.eval_shape(lambda: jax_init(cfg, jax.random.PRNGKey(0)))
        tcfg = torch_smoke_config(name)
        _PARAMS[name] = (cfg, tcfg, shapes,
                         init_params(tcfg, 0, device="cpu"))
    return _PARAMS[name]


def _pairs(jtree, ttree, cfg):
    """(JAX spec, port spec, stacked) for every leaf of the two spec
    trees, the port's layers matched to the reference's scanned
    groups."""
    out = []

    def flat(j, t, stacked):
        if isinstance(j, dict):
            assert set(j) == set(t)
            for k in j:
                flat(j[k], t[k], stacked)
        else:
            out.append((j, t, stacked))

    def layers(jgroups, tlayers, groups=None):
        unstacked = _unstack_layers(jgroups, cfg, groups)
        assert len(unstacked) == len(tlayers)
        for (group, b, _r), tl in zip(unstacked, tlayers):
            flat(group[b], tl, True)

    for key, jv in jtree.items():
        if key == "groups":
            layers(jv, ttree["layers"])
        elif key == "encoder":
            layers(jv["groups"], ttree["encoder"]["layers"],
                   [((BIDIR,), cfg.n_enc_layers)])
            flat(jv["final_norm"], ttree["encoder"]["final_norm"], False)
        else:
            flat(jv, ttree[key], False)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_equal_reference(name):
    cfg, tcfg, shapes, tparams = _param_trees(name)
    for shape in SHAPES:
        for pod in (False, True):
            mesh = _meshes(shape, pod)
            for fsdp in (False, True):
                jspecs = jsh.param_specs(shapes, cfg, mesh, fsdp=fsdp)
                tspecs = param_specs(tparams, tcfg, mesh, fsdp=fsdp)
                pairs = _pairs(jspecs, tspecs, tcfg)
                assert pairs
                for jspec, tspec, stacked in pairs:
                    want = _t(jspec)[1:] if stacked else _t(jspec)
                    assert isinstance(tspec, P)
                    assert _t(tspec) == want, (shape, pod, fsdp, jspec,
                                               tspec)


def _cache_trees(tcfg):
    """Every leaf name the port's engines allocate, at engine shapes:
    dense stacks (float and int8 with scale planes), pools, recurrent
    slabs and cross stacks."""
    L, B, cap, pages, psz = 2, 4, 32, 13, 8
    hkv, hd, d = tcfg.n_kv_heads, tcfg.resolved_head_dim, tcfg.d_model
    h = tcfg.n_heads
    kv = (L, B, cap, hkv, hd)
    pool = (L, pages + 1, psz, hkv, hd)
    return {
        "dense": {n: kv for n in ("k", "v", "wk", "wv", "xk", "xv")},
        "dense8": {"k": kv, "v": kv, "k_s": kv[:-1] + (1,),
                   "v_s": kv[:-1] + (1,)},
        "pools": {n: pool for n in ("pk", "pv", "lk", "lv", "ck", "cv")},
        "scales": {"pk_s": pool[:-1] + (1,), "pv_s": pool[:-1] + (1,)},
        "states": {"h": (L, B, d), "conv": (L, B, 3, d),
                   "state": (L, B, h, hd, hd), "shift": (L, B, d)},
        "table": {"pos": (B,)},
    }


@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_equal_reference(name):
    cfg, tcfg = smoke_config(name), torch_smoke_config(name)
    trees = _cache_trees(tcfg)
    jtrees = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                          trees, is_leaf=lambda x: isinstance(x, tuple))
    ttrees = {g: {n: torch.empty(s, device="meta") for n, s in leaves.items()}
              for g, leaves in trees.items()}
    for shape in SHAPES:
        mesh = _meshes(shape)
        for batch_axes in ((), None):
            js = jsh.cache_specs(jtrees, cfg, mesh, batch_axes=batch_axes)
            ts = cache_specs(ttrees, tcfg, mesh, batch_axes=batch_axes)
            for g, leaves in trees.items():
                for n in leaves:
                    assert _t(ts[g][n]) == _t(js[g][n]), (shape, g, n)


def test_sharder_role_table_equals_reference():
    roles = {"hidden": (4, 16, 64), "hidden_decode": (4, 1, 64),
             "mlp_hidden": (4, 16, 128), "attn_q": (4, 16, 4, 8),
             "attn_kv": (4, 16, 2, 8), "attn_logits": (4, 4, 16, 16),
             "kv_cache": (4, 32, 2, 8), "logits": (4, 16, 2048),
             "rnn_state_seq": (4, 16, 64), "unknown": (4, 4)}
    for name in ("yi-6b", "phi3.5-moe-42b", "rwkv6-3b", "gemma3-1b"):
        cfg, tcfg = smoke_config(name), torch_smoke_config(name)
        for shape in SHAPES:
            for pod in (False, True):
                mesh = _meshes(shape, pod)
                for batch_axes in ((), None):
                    ref = jsh.MeshSharder(mesh, cfg, batch_axes=batch_axes)
                    ref._c = lambda x, *axes, m=mesh: jsh._spec(m, x.shape,
                                                                *axes)
                    port = MeshSharder(mesh, tcfg, batch_axes=batch_axes)
                    assert port.seq_shard == ref.seq_shard
                    for role, s in roles.items():
                        want = ref.constrain(np.zeros(s), role)
                        got = port.spec(s, role)
                        if role == "unknown":
                            assert got is None
                        else:
                            assert _t(got) == _t(want), (name, role, shape)


def test_plan_elastic_mesh_and_simulate_failure_equal_reference():
    for n in range(0, 20):
        for mp in (1, 2, 3, 4, 8, 16):
            for min_data in (1, 2):
                assert plan_elastic_mesh(n, model_parallel=mp,
                                         min_data=min_data) == \
                    jfault.plan_elastic_mesh(n, model_parallel=mp,
                                             min_data=min_data)
    assert plan_elastic_mesh(32) == jfault.plan_elastic_mesh(32)
    devs = [torch.device("cpu")] * 6
    for k in range(0, 7):
        assert simulate_failure(devs, k) == \
            jfault.simulate_failure(devs, k)
        assert simulate_failure(list(range(6)), k) == \
            jfault.simulate_failure(list(range(6)), k)


def _random_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 12, generator=g),
            "b": [torch.randn(16, 4, 6, generator=g),
                  torch.randint(-8, 8, (4, 8, 2), generator=g,
                                dtype=torch.int32).to(torch.int8)],
            "c": torch.randn(5, generator=g).to(torch.bfloat16)}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
def test_placement_joins_back_bitwise(shape):
    mesh = virtual_mesh(shape, "cpu")
    tree = _random_tree()
    specs = {"a": tsh._spec(mesh, (8, 12), "model", "data"),
             "b": [tsh._spec(mesh, (16, 4, 6), None, "model"),
                   tsh._spec(mesh, (4, 8, 2), ("data", "model"))],
             "c": P()}
    shards = shard_tree(tree, specs, mesh)
    ptrs = set()
    for coord in mesh.coords():
        for leaf in (shards[coord]["a"], *shards[coord]["b"],
                     shards[coord]["c"]):
            assert leaf.is_contiguous()
            ptrs.add(leaf.untyped_storage().data_ptr())
    # own allocations: no shard is a view of the source or of another
    assert len(ptrs) == 4 * mesh.size
    for t in (tree["a"], *tree["b"], tree["c"]):
        assert t.untyped_storage().data_ptr() not in ptrs
    back = unshard_tree(shards, specs, mesh)
    for x, y in zip((tree["a"], *tree["b"], tree["c"]),
                    (back["a"], *back["b"], back["c"])):
        assert x.dtype == y.dtype and torch.equal(x, y)
    arr = shard_tensor(tree["a"], specs["a"], mesh)
    assert torch.equal(unshard_tensor(arr, specs["a"], mesh), tree["a"])


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_place_params_local_linears():
    """Column-split linears compute with their slice of the replicated
    bias, row-split ones keep it aside; the weights of every device join
    back to the host tree bitwise."""
    tcfg = torch_smoke_config("qwen2.5-0.5b")
    params = init_params(tcfg, 0, device="cpu")
    for lin in ("q", "k", "v", "o"):
        b = params["layers"][0]["mixer"][lin]["b"]
        b.copy_(torch.arange(b.shape[0], dtype=b.dtype))
    mesh = virtual_mesh((2, 2), "cpu")
    placed = place_params(params, tcfg, mesh)
    back = unshard_tree(placed.shards, placed.specs, mesh)
    same = tsh.tree_map(torch.equal, params, back)
    assert all(v for _, v in _leaves(same))
    for r, loc in enumerate(placed.local):
        mix = loc["layers"][0]["mixer"]
        full = params["layers"][0]["mixer"]
        n = mix["q"]["w"].shape[1]
        assert torch.equal(mix["q"]["b"], full["q"]["b"][r * n:(r + 1) * n])
        assert "b" not in mix["o"]
        assert torch.equal(mix["o"]["b_reduced"], full["o"]["b"])
        assert mix["o"]["w"].shape[0] == n


def test_sharded_index_part_gather():
    mesh = virtual_mesh((1, 4), "cpu")
    t = torch.arange(2 * 3 * 8 * 5, dtype=torch.float32).reshape(2, 3, 8, 5)
    s = Sharded.of(t, P(None, None, "model"), mesh)
    assert [x.shape for x in s.shards] == [(2, 3, 2, 5)] * 4
    assert torch.equal(s.gather(), t)
    layer = s[1]
    assert layer.spec == P(None, "model") and layer.shape == (3, 8, 5)
    assert torch.equal(layer.gather(), t[1])
    rows = s[:, :2]
    assert rows.shape == (2, 2, 8, 5) and torch.equal(rows.gather(), t[:, :2])
    with pytest.raises(IndexError):
        s[:, :, :4]
    for r in range(4):
        assert torch.equal(s.part(t, r), s.shards[r])
    assert s.nbytes() == [2 * 3 * 2 * 5 * 4] * 4
    z = Sharded.zeros((4, 8), torch.int8, P(None, "model"), mesh)
    assert [x.shape for x in z.shards] == [(4, 2)] * 4
    assert len({x.untyped_storage().data_ptr() for x in z.shards}) == 4


def test_collectives_equal_reference():
    rng = np.random.default_rng(0)
    n = 4
    xs = [rng.normal(size=(8, 8, 4)).astype(np.float32) for _ in range(n)]
    ts = [torch.from_numpy(x) for x in xs]
    summed = all_reduce_sum(ts)
    want = xs[0].astype(np.float32)
    for x in xs[1:]:
        want = want + x
    assert all(np.array_equal(s.numpy(), want) for s in summed)
    assert torch.equal(all_gather(ts, 1)[2],
                       torch.from_numpy(np.concatenate(xs, 1)))
    stacked = jnp.stack([jnp.asarray(x) for x in xs])
    for split, concat in ((0, 1), (1, 0), (0, 0), (2, 1)):
        ref = jax.vmap(lambda x, s=split, c=concat: jax.lax.all_to_all(
            x, "m", s, c, tiled=True), axis_name="m")(stacked)
        got = all_to_all(ts, split, concat)
        for j in range(n):
            np.testing.assert_array_equal(got[j].numpy(),
                                          np.asarray(ref[j]))
    with pytest.raises(ValueError, match="split"):
        all_to_all([torch.zeros(3, 2)] * 2, 0, 1)


def test_mesh_devices_and_default():
    mesh = Mesh(np.asarray(["cpu"] * 8).reshape(2, 4))
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert mesh.model_row() == [(0, 0), (0, 1), (0, 2), (0, 3)]
    assert all(d == torch.device("cpu") for d in mesh.model_devices())
    with pytest.raises(ValueError, match="rank"):
        Mesh(np.asarray(["cpu"] * 4), ("data", "model"))
    if torch.cuda.is_available():
        assert Mesh().shape["model"] == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh()
