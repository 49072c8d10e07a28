"""Hand-written Hopper kernels for the port's main path.

* ``sisa_gemm`` — K1, the SISA-scheduled GEMM (CUDA C++,
  ``csrc/sisa_gemm.cu``), behind every linear layer and the LM head.
* ``paged_attn`` — K2, paged-attention decode over the flat page pool
  (CUDA C++, ``csrc/paged_attn.cu``).
* ``grouped_gemm`` — K4, the flat ragged grouped GEMM behind every MoE
  expert FFN and its input gradient (CUDA C++, ``csrc/grouped_gemm.cu``),
  and K5, the segment-sum weight gradient of the experts (CUDA C++,
  ``csrc/grouped_dw.cu``).
* ``ops`` — the differentiable, ragged-M entry points for K1.
* ``_build`` — ``nvcc`` build and ``ctypes`` loading of ``csrc/``.

Each kernel module keeps a plain PyTorch version beside the kernel
(used for CPU tensors and as the reference on the card) and a launch
counter (``LAUNCHES``; K4 counts its forward and its transposed-weight
dX launches apart), gathered here in ``LAUNCH_COUNTERS`` by kernel
name.  Importing builds nothing.
"""
from repro_torch.kernels.grouped_gemm import DW_LAUNCHES as _K5_LAUNCHES
from repro_torch.kernels.grouped_gemm import DX_LAUNCHES as _K4_DX_LAUNCHES
from repro_torch.kernels.grouped_gemm import LAUNCHES as _K4_LAUNCHES
from repro_torch.kernels.grouped_gemm import (aligned_block_rows,
                                              flat_block_rows,
                                              flat_group_offsets,
                                              flat_ragged_gemm,
                                              ragged_grouped_gemm,
                                              segment_grouped_dw_plain,
                                              segment_grouped_gemm,
                                              segment_grouped_gemm_plain)
from repro_torch.kernels.ops import (row_passes, set_default_backend,
                                     sisa_einsum_2d, sisa_matmul)
from repro_torch.kernels.paged_attn import LAUNCHES as _K2_LAUNCHES
from repro_torch.kernels.paged_attn import (paged_attention,
                                            paged_attention_plain,
                                            set_paged_attn_backend)
from repro_torch.kernels.sisa_gemm import LAUNCHES as _K1_LAUNCHES
from repro_torch.kernels.sisa_gemm import (BlockConfig, choose_block_config,
                                           sisa_gemm, sisa_gemm_plain)

LAUNCH_COUNTERS = {"sisa_gemm": _K1_LAUNCHES, "paged_attn": _K2_LAUNCHES,
                   "grouped_gemm": _K4_LAUNCHES,
                   "grouped_gemm_dx": _K4_DX_LAUNCHES,
                   "grouped_dw": _K5_LAUNCHES}

__all__ = ["LAUNCH_COUNTERS", "BlockConfig", "choose_block_config", "sisa_gemm",
           "sisa_gemm_plain", "sisa_matmul", "sisa_einsum_2d",
           "set_default_backend", "row_passes", "paged_attention",
           "paged_attention_plain", "set_paged_attn_backend",
           "segment_grouped_gemm", "segment_grouped_gemm_plain",
           "segment_grouped_dw_plain",
           "flat_ragged_gemm", "ragged_grouped_gemm", "flat_block_rows",
           "aligned_block_rows", "flat_group_offsets"]
