"""Hand-written Hopper kernels for the port's main path.

* ``sisa_gemm`` — K1, the SISA-scheduled GEMM (CUDA C++,
  ``csrc/sisa_gemm.cu`` on the TMA + ``wgmma`` mainloop of
  ``csrc/hopper_gemm.cuh``, laid out by ``k1_plan``), behind every
  linear layer and the LM head.
* ``paged_attn`` — K2, split-KV paged-attention decode over the flat
  page pool (CUDA C++, ``csrc/paged_attn.cu``, laid out by ``k2_plan``).
* ``grouped_gemm`` — K4, the flat ragged grouped GEMM behind every MoE
  expert FFN and its input gradient (CUDA C++, ``csrc/grouped_gemm.cu``),
  and K5, the segment-sum weight gradient of the experts (CUDA C++,
  ``csrc/grouped_dw.cu``), both on the mainloop of
  ``csrc/hopper_gemm.cuh``, laid out by ``k4_plan`` and ``k5_plan``.
* ``coexec`` — K6, fused multi-tenant co-execution: the packer's
  placement of many GEMMs run in one launch (CUDA C++,
  ``csrc/coexec.cu``; bf16 on the mainloop of ``csrc/hopper_gemm.cuh``,
  one CTA a tile group of ``k6_plan``).
* ``moe_gemm`` — K7, the capacity-padded batched expert GEMM (CUDA C++,
  ``csrc/moe_gemm.cu``, bf16 on the mainloop of ``csrc/hopper_gemm.cuh``,
  laid out by ``k7_plan``).
* K3, the split-K GEMM, is ``sisa_gemm.sisa_gemm_splitk`` (CUDA C++, in
  ``csrc/sisa_gemm.cu``): bf16 on K1's wgmma body, one launch a call
  laid out by ``k3_plan`` (K1's plan type with slabs of whole stages).
  The float32 bodies of K3, K6 and K7 share ``csrc/tile_gemm.cuh``'s
  CUDA-core tile.
* ``ops`` — the differentiable, ragged-M entry points for K1.
* ``_build`` — ``nvcc`` build and ``ctypes`` loading of ``csrc/``.

Each kernel module keeps a plain PyTorch version beside the kernel
(used for CPU tensors and as the reference on the card) and a launch
counter (``LAUNCHES``; K4 counts its forward and its transposed-weight
dX launches apart, K2 its int8-pool launches, K1 its CUDA-core body's
launches and K3 its CUDA-core partials' launches), gathered here in
``LAUNCH_COUNTERS`` by kernel name.  Importing builds nothing.
"""
from repro_torch.kernels.coexec import LAUNCHES as _K6_LAUNCHES
from repro_torch.kernels.coexec import (build_coexec_plan, coexec_matmul,
                                        CoexecPlan, CoexecTenant,
                                        interleave_order, k6_plan,
                                        pack_operands,
                                        run_plan, run_plan_plain,
                                        sequential_matmul,
                                        single_tenant_plans, unpack_outputs)
from repro_torch.kernels.grouped_gemm import DW_LAUNCHES as _K5_LAUNCHES
from repro_torch.kernels.grouped_gemm import DX_LAUNCHES as _K4_DX_LAUNCHES
from repro_torch.kernels.grouped_gemm import LAUNCHES as _K4_LAUNCHES
from repro_torch.kernels.grouped_gemm import (a2a_segments,
                                              aligned_block_rows,
                                              flat_block_rows,
                                              flat_group_offsets,
                                              flat_ragged_gemm, K4Plan,
                                              k4_plan, K5Plan, k5_plan,
                                              ragged_grouped_gemm,
                                              segment_grouped_dw_plain,
                                              segment_grouped_gemm,
                                              segment_grouped_gemm_plain)
from repro_torch.kernels.moe_gemm import LAUNCHES as _K7_LAUNCHES
from repro_torch.kernels.moe_gemm import (K7Plan, k7_plan, moe_grouped_gemm,
                                          moe_grouped_gemm_plain)
from repro_torch.kernels.ops import (row_passes, set_default_backend,
                                     sisa_einsum_2d, sisa_matmul)
from repro_torch.kernels.paged_attn import LAUNCHES as _K2_LAUNCHES
from repro_torch.kernels.paged_attn import LAUNCHES_INT8 as _K2_INT8_LAUNCHES
from repro_torch.kernels.paged_attn import (K2Plan, k2_plan,
                                            paged_attention,
                                            paged_attention_plain,
                                            paged_attention_sharded,
                                            paged_attention_split_plain,
                                            quantize_page_pool,
                                            set_paged_attn_backend)
from repro_torch.kernels.sisa_gemm import LAUNCHES as _K1_LAUNCHES
from repro_torch.kernels.sisa_gemm import CORE_LAUNCHES as _K1_CORE_LAUNCHES
from repro_torch.kernels.sisa_gemm import SPLITK_LAUNCHES as _K3_LAUNCHES
from repro_torch.kernels.sisa_gemm import \
    SPLITK_CORE_LAUNCHES as _K3_CORE_LAUNCHES
from repro_torch.kernels.sisa_gemm import (BlockConfig, choose_block_config,
                                           K1Plan, k1_plan, k3_plan,
                                           sisa_gemm, sisa_gemm_plain,
                                           sisa_gemm_splitk,
                                           sisa_gemm_splitk_plain)

LAUNCH_COUNTERS = {"sisa_gemm": _K1_LAUNCHES,
                   "sisa_gemm_core": _K1_CORE_LAUNCHES,
                   "paged_attn": _K2_LAUNCHES,
                   "paged_attn_int8": _K2_INT8_LAUNCHES,
                   "grouped_gemm": _K4_LAUNCHES,
                   "grouped_gemm_dx": _K4_DX_LAUNCHES,
                   "grouped_dw": _K5_LAUNCHES,
                   "coexec": _K6_LAUNCHES,
                   "sisa_gemm_splitk": _K3_LAUNCHES,
                   "sisa_gemm_splitk_core": _K3_CORE_LAUNCHES,
                   "moe_gemm": _K7_LAUNCHES}

__all__ = ["LAUNCH_COUNTERS", "BlockConfig", "choose_block_config", "sisa_gemm",
           "sisa_gemm_plain", "K1Plan", "k1_plan", "sisa_matmul",
           "sisa_einsum_2d",
           "set_default_backend", "row_passes", "paged_attention",
           "paged_attention_plain", "paged_attention_split_plain",
           "paged_attention_sharded", "a2a_segments",
           "K2Plan", "k2_plan", "set_paged_attn_backend",
           "quantize_page_pool",
           "segment_grouped_gemm", "segment_grouped_gemm_plain",
           "segment_grouped_dw_plain",
           "flat_ragged_gemm", "ragged_grouped_gemm", "flat_block_rows",
           "aligned_block_rows", "flat_group_offsets", "K4Plan", "k4_plan",
           "K5Plan", "k5_plan",
           "sisa_gemm_splitk", "sisa_gemm_splitk_plain", "k3_plan",
           "moe_grouped_gemm", "moe_grouped_gemm_plain", "K7Plan",
           "k7_plan",
           "CoexecTenant", "CoexecPlan", "interleave_order",
           "build_coexec_plan", "k6_plan", "pack_operands", "run_plan",
           "run_plan_plain", "unpack_outputs", "coexec_matmul",
           "single_tenant_plans", "sequential_matmul"]
