"""Distributed pieces of the port: the single-controller mesh and its
collectives, the TP x EP sharding rules for serving, and fault
tolerance (the straggler watchdog, elastic re-mesh planning)."""
from repro_torch.distributed.collectives import (all_gather, all_reduce_sum,
                                                 all_to_all)
from repro_torch.distributed.fault import (plan_elastic_mesh,
                                           simulate_failure,
                                           StragglerWatchdog)
from repro_torch.distributed.mesh import Mesh, P, virtual_mesh
from repro_torch.distributed.sharding import (cache_specs, mesh_axes_for,
                                              MeshSharder, param_specs,
                                              place_params, shard_tensor,
                                              shard_tree, unshard_tensor,
                                              unshard_tree)

__all__ = ["Mesh", "P", "virtual_mesh", "all_reduce_sum", "all_gather",
           "all_to_all", "MeshSharder", "mesh_axes_for", "param_specs",
           "cache_specs", "place_params", "shard_tensor", "shard_tree",
           "unshard_tensor", "unshard_tree", "StragglerWatchdog",
           "plan_elastic_mesh", "simulate_failure"]
