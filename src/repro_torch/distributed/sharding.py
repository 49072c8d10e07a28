"""FSDP x TP x EP sharding rules on a ``("data", "model")`` mesh (the
port of ``repro/distributed/sharding.py``'s parameter, optimizer-state,
batch, cache and activation rules).

Parameters: Megatron-style tensor parallelism over ``model`` (column-
split up-projections and heads, row-split down-projections, vocabulary-
split embedding tables), expert parallelism for MoE weights, and, where
``fsdp`` asks for it, fully sharded storage over the data axes on the
other dimension.  Every rule is divisibility-guarded: a dimension that
does not divide over the proposed axes is replicated instead.  Caches
shard KV heads where both head counts divide, else the sequence (the
page interior of a pool; the page axis never).

The rules are pure functions of shapes and axis sizes and give the
reference's specs leaf for leaf; the port's parameter tree has one dict
a layer where the reference stacks a group, so a port leaf's spec is
the reference's without the stacked dimension.  :func:`shard_tensor`
and :func:`place_params` (serving) and :func:`place_train` (training)
put a tree on a mesh, one own allocation a device (the counterpart of
``to_named`` plus ``device_put``), and :func:`unshard_tensor` joins the
shards back.  In training every device holds its (data, model) part of
each leaf; :func:`gather_fsdp` gathers the parts over the data axes into
each model rank's TP shard before a data replica's forward, and
:func:`reduce_replicas` gives every copy of a leaf that more than one
device holds the sum of the copies' gradients.  The reference's
``MeshSharder`` steers GSPMD with ``with_sharding_constraint``; the
port's computes nothing: the sharded forward reads whether attention
heads split (:func:`heads_split`) from it, and whether the recurrent
mixers split (:func:`rglru_split`, :func:`wkv_split`) through
``TensorParallel``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import WKV
from repro_torch.distributed.collectives import all_gather, all_reduce_sum
from repro_torch.distributed.mesh import (axis_index, Mesh, own_copy, P,
                                          shard_slices)
from repro_torch.optim.adamw import AdamWState, sum_squares

PyTree = Any


# --------------------------------------------------------------------------
# Helpers
# --------------------------------------------------------------------------
def _axes_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    out = 1
    for a in axes:
        out *= mesh.shape[a]
    return out


def _fit(mesh: Mesh, dim: int, axes) -> Optional[Any]:
    """``axes`` (possibly reduced by dropping leading axes) such that
    ``dim`` divides their product, or None for replication."""
    if axes is None:
        return None
    cand = axes if isinstance(axes, tuple) else (axes,)
    for start in range(len(cand)):
        sub = cand[start:]
        size = _axes_size(mesh, sub)
        if size > 1 and dim % size == 0:
            return sub if len(sub) > 1 else sub[0]
    return None


def _canon(entries) -> P:
    """A spec with trailing ``None``s stripped (the reference's canonical
    short form)."""
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _spec(mesh: Mesh, shape: Sequence[int], *axes) -> P:
    """Divisibility-guarded spec builder."""
    return _canon(_fit(mesh, d, a) for d, a in zip(shape, axes))


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    pod: Optional[str] = "pod"       # None when single-pod
    data: str = "data"
    model: str = "model"

    @property
    def batch(self) -> Tuple[str, ...]:
        return (self.pod, self.data) if self.pod else (self.data,)

    @property
    def fsdp(self) -> Tuple[str, ...]:
        return (self.pod, self.data) if self.pod else (self.data,)


def mesh_axes_for(mesh: Mesh) -> MeshAxes:
    return MeshAxes(pod="pod" if "pod" in mesh.axis_names else None)


def heads_split(cfg, mesh: Mesh) -> bool:
    """Whether attention runs head-parallel over ``model``: both head
    counts divide its size (the reference's ``MeshSharder`` rule).
    Otherwise attention is replicated and caches sequence-sharded.  The
    cache specs, the sharded forward (``TensorParallel.head_ok``) and,
    through the pools' specs, ``paged_attention_sharded`` all follow
    this one answer."""
    ms = _model_size(mesh)
    return cfg.n_heads % ms == 0 and cfg.n_kv_heads % ms == 0


def _model_size(mesh: Mesh) -> int:
    return _axes_size(mesh, "model" if "model" in mesh.axis_names else None)


def rglru_split(cfg, mesh: Mesh) -> bool:
    """Whether RG-LRU layers run channel-parallel over ``model``:
    ``d_model`` divides its size, so ``in_gate``/``in_rec`` split on
    their columns, ``out`` on its rows and the state ``h`` on its
    features (``cache_specs``), each rank scanning its own channels.
    Otherwise the block runs whole, once, and its state is replicated.
    The sharded forward reads this through ``TensorParallel``."""
    return cfg.d_model % _model_size(mesh) == 0


def wkv_split(cfg, mesh: Mesh) -> bool:
    """Whether RWKV6 time-mix layers run head-parallel over ``model``:
    their ``d_model / head_dim`` heads divide its size, so the WKV
    ``state`` splits on its heads (``cache_specs``) and each rank runs
    the chunk scan on its own heads (r/k/v/w by columns, ``u`` by rows,
    ``o`` row-parallel).  Otherwise the time-mix runs whole, once, as
    attention does where heads do not split."""
    from repro_torch.models.rwkv6 import rwkv_head_dims
    return rwkv_head_dims(cfg)[0] % _model_size(mesh) == 0


# --------------------------------------------------------------------------
# Trees (nested dicts and lists; a P is a leaf)
# --------------------------------------------------------------------------
def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _tree_of_paths(tree: PyTree, fn: Callable[[str, Any], Any],
                   prefix: str = "") -> PyTree:
    if isinstance(tree, dict):
        return {k: _tree_of_paths(v, fn, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_of_paths(v, fn, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


# --------------------------------------------------------------------------
# Parameter specs (path-pattern rules)
# --------------------------------------------------------------------------
def _param_rule(path: str, shape: Tuple[int, ...], mesh: Mesh, ax: MeshAxes,
                cfg, fsdp: bool) -> P:
    """The spec of one parameter leaf; ``path`` like
    ``'layers/0/mixer/q/w'``."""
    F = ax.fsdp if fsdp else None
    M = ax.model
    ndim = len(shape)

    if ndim <= 1:
        return P()                                   # norms, biases, gates

    # embeddings / lm head: (vocab_padded, d)
    if re.search(r"(embed|lm_head)/table$", path):
        return _spec(mesh, shape, M, F)

    # MoE expert weights: (E, d, ff) / (E, ff, d): EP over model
    if "/moe/" in path:
        if path.endswith("router"):
            return P()
        return _spec(mesh, shape, M, F, None)

    # attention projections: each on its own head count, as the
    # reference splits them (a count that divides is split even where
    # attention runs replicated; the forward then gathers it).
    m = re.search(r"/(mixer|cross)/([qkvo])/w$", path)
    if m:
        which = m.group(2)
        heads = cfg.n_heads if which in ("q", "o") else cfg.n_kv_heads
        head_ok = heads % mesh.shape[M] == 0
        if which == "o":      # (H*hd, d): row-parallel over heads
            return _spec(mesh, shape, M if head_ok else None, F)
        return _spec(mesh, shape, F, M if head_ok else None)

    # dense MLP
    if re.search(r"/mlp/(up|gate)/w$", path):
        return _spec(mesh, shape, F, M)              # (d, ff): col-parallel
    if re.search(r"/mlp/down/w$", path):
        return _spec(mesh, shape, M, F)              # (ff, d): row-parallel

    # recurrent blocks: square projections, col/row parallel
    if re.search(r"/mixer/(in_gate|in_rec|r|k|v|w)/w$", path):
        return _spec(mesh, shape, F, M)
    if re.search(r"/mixer/(out|o)/w$", path):
        return _spec(mesh, shape, M, F)

    if "frontend_proj" in path:
        return _spec(mesh, shape, None, M)

    return _spec(mesh, shape, F, *([None] * (ndim - 1)))


def param_specs(params_shapes: PyTree, cfg, mesh: Mesh,
                fsdp: bool = True) -> PyTree:
    """A spec tree matching ``params_shapes`` (the port's parameter tree,
    or any tree of the same structure whose leaves have ``.shape``)."""
    ax = mesh_axes_for(mesh)
    return _tree_of_paths(params_shapes, lambda path, leaf: _param_rule(
        path, tuple(leaf.shape), mesh, ax, cfg, fsdp))


def opt_state_specs(param_spec_tree: PyTree, opt_state=None):
    """AdamW's moments shard exactly like their parameters; the step is
    replicated."""
    return AdamWState(step=P(), mu=param_spec_tree, nu=param_spec_tree)


def batch_specs(cell_step: str, mesh: Mesh, cfg) -> dict:
    """The input batch's specs: rows over the batch axes (one name where
    there is one, as ``PartitionSpec`` spells it)."""
    ax = mesh_axes_for(mesh)
    b = ax.batch if len(ax.batch) > 1 else ax.batch[0]
    return {"tokens": P(b, None), "labels": P(b, None),
            "frontend_embeds": P(b, None, None)}


# --------------------------------------------------------------------------
# Serving-cache specs (slot buffers, page pools, recurrent states)
# --------------------------------------------------------------------------
_POOL_LEAVES = ("pk", "pv", "pk_s", "pv_s",   # global page pool
                "lk", "lv",                    # sliding-window ring pool
                "ck", "cv")                    # enc-dec cross pool


def _cache_rule(name: str, shape: Tuple[int, ...], mesh: Mesh, M, B,
                head_ok: bool) -> P:
    nd = len(shape)
    if name in _POOL_LEAVES and nd == 5:
        # (L, pages + sink, page_size, Hkv, hd|1): the page axis is never
        # split, since the tables index pages globally.
        if head_ok:
            return _canon((None, None, None, _fit(mesh, shape[3], M), None))
        return _canon((None, None, _fit(mesh, shape[2], M), None, None))
    if name == "state" and nd == 5:
        # WKV state (L, B, H, hd, hd): heads on axis 2.
        return _canon((None, _fit(mesh, shape[1], B),
                       _fit(mesh, shape[2], M), None, None))
    if nd == 5:
        # dense KV (L, B, cap, Hkv, hd|1): heads, else the sequence.
        b = _fit(mesh, shape[1], B)
        if head_ok:
            return _canon((None, b, None, _fit(mesh, shape[3], M), None))
        return _canon((None, b, _fit(mesh, shape[2], M), None, None))
    if nd == 4:
        return _canon((None, _fit(mesh, shape[1], B), None, None))
    if nd == 3:
        return _canon((None, _fit(mesh, shape[1], B), _fit(mesh, shape[2], M)))
    return P()


def cache_specs(cache_shapes: PyTree, cfg, mesh: Mesh, *,
                batch_axes=None) -> PyTree:
    """A spec tree for serving KV storage, dispatching on each leaf's
    name (the last dict key on its path) and rank:

    * pools ``pk``/``pv`` (+ ``pk_s``/``pv_s``), ``lk``/``lv``,
      ``ck``/``cv`` ``(L, pages + sink, page_size, Hkv, hd|1)``: KV heads
      over ``model`` where both head counts divide, else the page
      interior; the page axis never;
    * the WKV ``state`` ``(L, B, H, hd, hd)``: heads over ``model``;
    * other 5-dim leaves (dense ``k``/``v``/``xk``/``xv`` and the port's
      ``wk``/``wv`` stacks, with their scale planes): the slot axis over
      ``batch_axes``, heads where both counts divide, else the sequence;
    * 4-dim (``conv``): the slot axis; 3-dim (``h``, ``shift``): the
      slot axis and the feature dim over ``model``; anything else
      replicated.

    ``batch_axes=None`` means the mesh's data axes; the engines pass
    ``()``, since their leading cache dimension is a slot, not a
    data-parallel batch.  Page tables and positions are replicated."""
    ax = mesh_axes_for(mesh)
    M = ax.model if ax.model in mesh.axis_names else None
    if batch_axes is None:
        B = tuple(a for a in ax.batch if a in mesh.axis_names) or None
    else:
        B = tuple(batch_axes) or None
    head_ok = heads_split(cfg, mesh)
    return _tree_of_paths(cache_shapes, lambda path, leaf: _cache_rule(
        path.rsplit("/", 1)[-1], tuple(leaf.shape), mesh, M, B, head_ok))


# --------------------------------------------------------------------------
# Activation layout (the role table of the reference's MeshSharder)
# --------------------------------------------------------------------------
class MeshSharder:
    """The layout of every activation role of the sharded forward.  The
    reference constrains activations to :meth:`spec` for GSPMD; here the
    sharded forward reads :attr:`head_ok` (:func:`heads_split`).  The
    role table and :attr:`seq_shard` are kept equal to the reference's
    and read by no path of the port: in one controller, sequence
    parallelism would only cut the activations between layers into
    parts that the next layer gathers again, and would change no
    result."""

    def __init__(self, mesh: Mesh, cfg, batch_axes=None):
        self.mesh = mesh
        self.cfg = cfg
        self.ax = mesh_axes_for(mesh)
        self._batch = (self.ax.batch if batch_axes is None
                       else tuple(batch_axes))
        self.head_ok = heads_split(cfg, mesh)
        # Sequence parallelism is dropped for WKV stacks on a pod mesh
        # (the reference's measured trade).
        self.seq_shard = (WKV not in cfg.layer_pattern
                          or "pod" not in mesh.axis_names)

    def spec(self, shape: Sequence[int], role: str) -> Optional[P]:
        """The spec of an activation of ``shape`` in ``role``, or None
        for a role the table does not name (left as it is)."""
        B, M = self._batch, self.ax.model
        heads = M if self.head_ok else None
        table = {
            "hidden": (B, M if self.seq_shard else None, None),
            "hidden_decode": (B, None, None),
            "mlp_hidden": (B, None, M),
            "attn_q": (B, None, heads, None),
            "attn_kv": (B, None, heads, None),
            "attn_logits": ((B, M, None, None) if self.head_ok
                            else (B, None, None, M)),
            "kv_cache": ((B, None, M, None) if self.head_ok
                         else (B, M, None, None)),
            "logits": (B, None, M),
            "rnn_state_seq": (B, M if self.seq_shard else None, None),
        }
        if role not in table:
            return None
        return _spec(self.mesh, shape, *table[role])


# --------------------------------------------------------------------------
# Placement
# --------------------------------------------------------------------------
def shard_tensor(t: torch.Tensor, spec, mesh: Mesh) -> np.ndarray:
    """``t`` cut by ``spec``: a mesh-shaped array with, at each
    coordinate, that device's part in an allocation of its own."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for coord in mesh.coords():
        out[coord] = own_copy(t[shard_slices(t.shape, spec, mesh, coord)],
                              mesh.devices[coord])
    return out


def unshard_tensor(shards: np.ndarray, spec, mesh: Mesh,
                   device="cpu") -> torch.Tensor:
    """The inverse of :func:`shard_tensor`: every shard written back
    into one tensor on ``device``; replicas overwrite each other."""
    first = shards[(0,) * mesh.devices.ndim]
    shape = list(first.shape)
    for i, entry in enumerate(spec):
        if entry is not None:
            shape[i] *= _axes_size(mesh, entry)
    out = torch.empty(tuple(shape), dtype=first.dtype, device=device)
    for coord in mesh.coords():
        out[shard_slices(out.shape, spec, mesh, coord)] = shards[coord].to(
            device)
    return out


def shard_tree(tree: PyTree, specs: PyTree, mesh: Mesh) -> np.ndarray:
    """A mesh-shaped array of trees: each device's tree of its parts of
    ``tree``'s leaves under ``specs``."""
    placed = tree_map(lambda t, s: shard_tensor(t, s, mesh), tree, specs)
    out = np.empty(mesh.devices.shape, dtype=object)
    for coord in mesh.coords():
        out[coord] = tree_map(lambda a: a[coord], placed)
    return out


def unshard_tree(shards: np.ndarray, specs: PyTree, mesh: Mesh,
                 device="cpu") -> PyTree:
    """The inverse of :func:`shard_tree`."""
    def join(spec, *parts):
        arr = np.empty(mesh.devices.shape, dtype=object)
        for coord, part in zip(mesh.coords(), parts):
            arr[coord] = part
        return unshard_tensor(arr, spec, mesh, device=device)
    return tree_map(join, specs, *[shards[c] for c in mesh.coords()])


def _local_linears(tree: PyTree, specs: PyTree, mesh: Mesh, coord):
    """A device's tree as its shard computes with it: a linear whose
    weight is column-split adds its slice of the replicated bias; one
    whose weight is row-split keeps the bias aside as ``"b_reduced"``,
    added once after the partial sums are reduced."""
    if isinstance(tree, list):
        return [_local_linears(t, s, mesh, coord)
                for t, s in zip(tree, specs)]
    if not isinstance(tree, dict):
        return tree
    out = {k: _local_linears(v, specs[k], mesh, coord)
           for k, v in tree.items()}
    w = tree.get("w")
    if isinstance(w, torch.Tensor) and w.dim() == 2 and "b" in tree:
        wspec = tuple(specs["w"]) + (None, None)
        if wspec[1] is not None:
            cols = shard_slices((tree["b"].shape[0],), P(wspec[1]), mesh,
                                coord)
            out["b"] = tree["b"][cols]
        elif wspec[0] is not None:
            out["b_reduced"] = out.pop("b")
    return out


@dataclasses.dataclass
class Placed:
    """A tree placed on ``mesh`` by ``specs``: ``shards`` holds each
    device's tree (own allocations).  For serving parameters,
    :attr:`local` holds the trees that the model row's shards compute
    with (:func:`_local_linears`: views of their own tensors); a
    training tree (parameters, gradients, moments) has none, since its
    forward gathers them (:func:`gather_fsdp`)."""
    mesh: Mesh
    specs: PyTree
    shards: np.ndarray
    local: Optional[List[PyTree]] = None

    def map(self, fn: Callable) -> "Placed":
        """``fn`` over every device's leaves, laid out as this one."""
        out = np.empty(self.shards.shape, dtype=object)
        for c in self.mesh.coords():
            out[c] = tree_map(fn, self.shards[c])
        return Placed(self.mesh, self.specs, out)

    def leaves(self, coord) -> list:
        """The leaves of the device at ``coord``, in the specs' order."""
        return _leaves(self.shards[coord])

    def primary(self, coord) -> List[bool]:
        """Per leaf, whether ``coord`` is the first holder of its part
        (:func:`is_primary`): over the first holders every logical
        element is counted once."""
        return [is_primary(s, self.mesh, coord) for s in _leaves(self.specs)]

    def nbytes(self, unique: bool = False) -> dict:
        """Bytes each device holds; with ``unique``, of the parts it is
        the first holder of, so the devices' counts sum to the bytes of
        the whole tree."""
        out = {}
        for c in self.mesh.coords():
            out[c] = sum(t.numel() * t.element_size() for t, first in zip(
                self.leaves(c), self.primary(c)) if first or not unique)
        return out

    def global_norms(self) -> list:
        """The global norm of the whole tree, a copy on each device in
        ``mesh.coords()`` order: each device's float32 sum of squares
        over the parts it first holds, summed over the devices by
        :func:`all_reduce_sum` (a norm, a router or a leaf FSDP cannot
        split counts once, however many devices hold it)."""
        sums = []
        for c in self.mesh.coords():
            mine = [t for t, first in zip(self.leaves(c), self.primary(c))
                    if first]
            sums.append(sum_squares(mine) if mine else torch.zeros(
                (), dtype=torch.float32, device=self.mesh.devices[c]))
        return [torch.sqrt(s) for s in all_reduce_sum(sums)]


def place_params(params: PyTree, cfg, mesh: Mesh) -> Placed:
    """``params`` on ``mesh`` by ``param_specs(..., fsdp=False)``, the
    serving layout: every device of a data replica holds the same
    shards."""
    specs = param_specs(params, cfg, mesh, fsdp=False)
    shards = shard_tree(params, specs, mesh)
    local = [_local_linears(shards[c], specs, mesh, c)
             for c in mesh.model_row()]
    return Placed(mesh, specs, shards, local)


# --------------------------------------------------------------------------
# Training: FSDP placement, gathers and replica sums
# --------------------------------------------------------------------------
def _leaves(tree: PyTree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> set:
    """Every mesh axis a spec names."""
    return {a for e in spec for a in _entry_axes(e)}


def drop_axes(spec, axes) -> P:
    """``spec`` without the mesh axes ``axes``: the TP spec of an FSDP
    spec when ``axes`` are the data axes."""
    out = []
    for e in spec:
        kept = tuple(a for a in _entry_axes(e) if a not in axes)
        out.append(None if not kept else kept if len(kept) > 1 else kept[0])
    return _canon(out)


def is_primary(spec, mesh: Mesh, coord) -> bool:
    """Whether ``coord`` is the first holder of its part under ``spec``:
    its index is 0 on every mesh axis the spec does not name."""
    used = spec_axes(spec)
    return all(i == 0 for a, i in zip(mesh.axis_names, coord)
               if a not in used)


def replica_groups(spec, mesh: Mesh) -> List[list]:
    """The coordinates that hold the same part under ``spec``, a list a
    part: those that agree on every axis the spec names."""
    used = [k for k, a in enumerate(mesh.axis_names) if a in spec_axes(spec)]
    groups: dict = {}
    for c in mesh.coords():
        groups.setdefault(tuple(c[k] for k in used), []).append(c)
    return list(groups.values())


def place_train(params: PyTree, cfg, mesh: Mesh) -> Placed:
    """``params`` on ``mesh`` by ``param_specs(..., fsdp=True)``, the
    training layout: each device holds its (data, model) part of every
    leaf, and a leaf whose spec degrades is replicated."""
    specs = param_specs(params, cfg, mesh, fsdp=True)
    return Placed(mesh, specs, shard_tree(params, specs, mesh))


def init_opt_state(placed: Placed) -> AdamWState:
    """AdamW's zero float32 moments in ``placed``'s layout
    (``opt_state_specs``: like their parameters), step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=placed.map(zeros), nu=placed.map(zeros))


def _fsdp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes_for(mesh).fsdp if a in mesh.axis_names)


def _per_device(fn: Callable, specs: PyTree, trees: List[PyTree]) -> list:
    """``fn(spec, *parts)`` over the leaves of the devices' ``trees`` (in
    ``mesh.coords()`` order), returning a part a device; the devices'
    trees of its results, in that order."""
    per = tree_map(lambda spec, *parts: tuple(fn(spec, parts)), specs,
                   *trees)
    return [tree_map(lambda t, i=i: t[i], per) for i in range(len(trees))]


def _gather_leaf(spec, parts, mesh: Mesh, fs) -> list:
    """Each device's TP tensor of one leaf: where the spec splits a
    dimension over the FSDP axes, the parts of the devices that differ
    only there, gathered in rank order (:func:`all_gather`)."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if any(a in fs for a in axes):
            break
    else:
        return list(parts)
    if not all(a in fs for a in axes):
        raise ValueError(f"spec {spec} mixes FSDP and model axes in one "
                         "dimension")
    coords = mesh.coords()
    at = [k for k, a in enumerate(mesh.axis_names) if a in axes]
    index = {c: i for i, c in enumerate(coords)}
    out = [None] * len(coords)
    for c in coords:
        if out[index[c]] is not None:
            continue
        group = sorted((g for g in coords
                        if all(g[k] == c[k] for k in range(len(c))
                               if k not in at)),
                       key=lambda g: axis_index(mesh, g, entry)[0])
        for g, t in zip(group, all_gather([parts[index[g]] for g in group],
                                          dim)):
            out[index[g]] = t
    return out


def gather_fsdp(placed: Placed, select: Optional[Callable] = None) -> dict:
    """Each device's TP tree of ``select(params)`` (default: all of it),
    by coordinate: parts split over the data axes gathered into the
    model rank's TP shard, then :func:`_local_linears` by the TP specs.
    Under autograd the gather's backward gives each part the sum of the
    data replicas' gradients: FSDP's reduce-scatter."""
    mesh = placed.mesh
    sel = select or (lambda t: t)
    specs = sel(placed.specs)
    coords = mesh.coords()
    fs = _fsdp_axes(mesh)
    tp = _per_device(lambda spec, parts: _gather_leaf(spec, parts, mesh, fs),
                     specs, [sel(placed.shards[c]) for c in coords])
    tp_specs = tree_map(lambda spec: drop_axes(spec, fs), specs)
    return {c: _local_linears(tree, tp_specs, mesh, c)
            for c, tree in zip(coords, tp)}


def reduce_replicas(placed: Placed) -> Placed:
    """Every device's copy of a part that several devices hold replaced
    by the copies' sum (:func:`all_reduce_sum`: float32 in rank order,
    rounded once, the same bits on every holder); parts one device holds
    are kept."""
    mesh, coords = placed.mesh, placed.mesh.coords()
    index = {c: i for i, c in enumerate(coords)}

    def leaf(spec, parts):
        out = list(parts)
        for group in replica_groups(spec, mesh):
            if len(group) > 1:
                summed = all_reduce_sum([parts[index[g]] for g in group])
                for g, t in zip(group, summed):
                    out[index[g]] = t
        return out

    out = np.empty(mesh.devices.shape, dtype=object)
    for c, tree in zip(coords, _per_device(
            leaf, placed.specs, [placed.shards[c] for c in coords])):
        out[c] = tree
    return Placed(mesh, placed.specs, out)
