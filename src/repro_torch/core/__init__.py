"""SISA core, copied from the JAX package's jax-free ``repro.core``: the
slab array geometry, the §3.2 scheduler, the cycle simulator the
serving ladder consults, the Table-2 workloads and the multi-tenant
packer.  The energy and ReDas models are not needed by the port yet."""
from repro_torch.core.multi import (coexec_tile_sequence, GemmRequest,
                                    pack_requests, packed_speedup,
                                    PackedSchedule, requests_from_workload,
                                    simulate_serial, TileRun)
from repro_torch.core.scheduler import ExecutionPlan, Phase, plan_gemm, Tile
from repro_torch.core.simulator import (SimResult, simulate_gemm,
                                        simulate_workload, tile_cycles)
from repro_torch.core.slab import (ExecMode, MONOLITHIC_128, SISA_128,
                                   SlabArrayConfig)
from repro_torch.core.workloads import LLMWorkload, TABLE2

__all__ = [
    "ExecMode", "SlabArrayConfig", "SISA_128", "MONOLITHIC_128",
    "ExecutionPlan", "Phase", "Tile", "plan_gemm",
    "SimResult", "simulate_gemm", "simulate_workload", "tile_cycles",
    "GemmRequest", "PackedSchedule", "TileRun", "pack_requests",
    "packed_speedup", "requests_from_workload", "simulate_serial",
    "coexec_tile_sequence", "TABLE2", "LLMWorkload",
]
