"""Distributed pieces of the port: the single-controller mesh and its
collectives, the FSDP x TP x EP sharding rules for training and
serving, gradient compression, the GPipe pipeline, and fault tolerance
(the straggler watchdog, elastic re-mesh planning)."""
from repro_torch.distributed.collectives import (all_gather, all_reduce_sum,
                                                 all_to_all, ppermute)
from repro_torch.distributed.compression import (compress_grads,
                                                 init_error_state)
from repro_torch.distributed.fault import (plan_elastic_mesh,
                                           simulate_failure,
                                           StragglerWatchdog)
from repro_torch.distributed.mesh import Mesh, P, virtual_mesh
from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              init_opt_state,
                                              mesh_axes_for, MeshSharder,
                                              opt_state_specs, param_specs,
                                              place_params, place_train,
                                              Placed, shard_tensor,
                                              shard_tree, unshard_tensor,
                                              unshard_tree)

__all__ = ["Mesh", "P", "virtual_mesh", "all_reduce_sum", "all_gather",
           "all_to_all", "ppermute", "MeshSharder", "batch_specs",
           "init_opt_state", "mesh_axes_for", "opt_state_specs", "param_specs", "cache_specs",
           "place_params", "place_train", "Placed", "shard_tensor",
           "shard_tree", "unshard_tensor", "unshard_tree",
           "StragglerWatchdog", "plan_elastic_mesh", "simulate_failure",
           "compress_grads", "init_error_state"]
