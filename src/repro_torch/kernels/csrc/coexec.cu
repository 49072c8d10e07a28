// K6: fused multi-tenant co-execution, T heterogeneous GEMMs in one grid,
// for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel repro/kernels/coexec.py::
// _coexec_kernel (launched by _coexec_call for run_plan, coexec_matmul and
// sequential_matmul).  Same contract: tenant t's activations are rows
// [row_offset[t], row_offset[t] + m_t) of a flat (M_flat, Kp) A, its weight
// is b_stack[t] of a (T, Kp, Np) stack, zero past (k_t, n_t); a (5, n_tasks)
// int32 table gives each grid task [tenant, row_block, col_block, row_hi,
// k_hi], and the task writes the (bm x bn) tile (row_block, col_block) of
// the flat (M_flat, Np) output with an f32 accumulator, in A's dtype.
//
// One block per task, in table order (the packer's placement order, from
// repro_torch.core.coexec_tile_sequence).  The TPU walks the tasks in
// sequence; here they run in parallel on the SMs, so the order only decides
// which tenants' tiles are co-resident in the first waves.  Scale-in as on
// the TPU: a tile whose first row is at or past row_hi writes zeros and
// reads nothing; rows at or past row_hi are zero-filled, never read, and
// written as exact zeros; K steps at or past k_hi are never loaded.
//
// Bits: a tile accumulates its K steps in one fixed order, and nothing is
// shared between tasks (no atomics, no split reduction), so a tenant's
// result is the same whether it runs fused with others or alone through a
// single-tenant plan of the same block shapes (coexec.py:41-45's contract,
// fused == sequential bit for bit).
//
// What bounds it on an H100: the co-resident GEMMs are decode- and
// prefill-sized (m from 1 to a few hundred), so device-memory bytes, each
// live weight read once per row block of its tenant.  The tile bodies are
// tile_gemm.cuh's (bf16 on the tensor cores, f32 on the CUDA cores); the
// tile height is the plan's bm (16 / 32 / 64 / 128), its width and depth
// the fixed kTileN / kTileK the plan's bn / bk must equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "gemm_tiles.cuh"
#include "tile_gemm.cuh"

struct Task {
  int tenant, row0, n0, live, k_hi;
};

// The task of this block; `live` is the number of its rows below row_hi
// (<= 0: a tile past its tenant's rows).
__device__ __forceinline__ Task task_of(const int* __restrict__ meta,
                                        int n_tasks, int n_tenants, int kp,
                                        int bm) {
  const int t = blockIdx.x;
  Task k;
  k.tenant = min(max(meta[t], 0), n_tenants - 1);
  k.row0 = meta[n_tasks + t] * bm;
  k.n0 = meta[2 * n_tasks + t] * kTileN;
  k.live = min(meta[3 * n_tasks + t] - k.row0, bm);
  k.k_hi = min(meta[4 * n_tasks + t], kp);
  return k;
}

template <int BM>
__global__ void __launch_bounds__(TcTile<BM>::kThreads)
    coexec_tc_kernel(const __nv_bfloat16* __restrict__ a,
                     const __nv_bfloat16* __restrict__ b,
                     __nv_bfloat16* __restrict__ c,
                     const int* __restrict__ meta, int n_tasks, int n_tenants,
                     int kp, int np_pad) {
  extern __shared__ uint4 smem_raw[];
  const Task t = task_of(meta, n_tasks, n_tenants, kp, BM);
  const StoreMasked<__nv_bfloat16> epi{c + (long long)t.row0 * np_pad + t.n0,
                                       np_pad, t.live, kTileN};
  if (t.live <= 0) {  // scale-in: no weight bytes, no MACs
    for (int e = threadIdx.x; e < BM * kTileN; e += blockDim.x)
      epi(e / kTileN, e % kTileN, 0.f);
    return;
  }
  tc_tile<BM>(a + (long long)t.row0 * kp, kp, t.live,
              b + (long long)t.tenant * kp * np_pad + t.n0, np_pad, kTileN,
              t.k_hi, smem_raw, epi);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kFpThreads)
    coexec_fp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ c, const int* __restrict__ meta,
                     int n_tasks, int n_tenants, int kp, int np_pad) {
  const Task t = task_of(meta, n_tasks, n_tenants, kp, BM);
  const StoreMasked<T> epi{c + (long long)t.row0 * np_pad + t.n0, np_pad,
                           t.live, kTileN};
  if (t.live <= 0) {
    for (int e = threadIdx.x; e < BM * kTileN; e += blockDim.x)
      epi(e / kTileN, e % kTileN, 0.f);
    return;
  }
  fp_tile<T, BM>(a + (long long)t.row0 * kp, kp, t.live,
                 b + (long long)t.tenant * kp * np_pad + t.n0, np_pad, kTileN,
                 t.k_hi, epi);
}

template <int BM>
cudaError_t launch(const void* a, const void* b, void* c, const int* meta,
                   int n_tasks, int n_tenants, int kp, int np_pad, int dtype,
                   cudaStream_t s) {
  if (dtype == 1)
    coexec_tc_kernel<BM><<<n_tasks, TcTile<BM>::kThreads,
                           TcTile<BM>::kSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(c), meta, n_tasks, n_tenants, kp, np_pad);
  else
    coexec_fp_kernel<float, BM><<<n_tasks, kFpThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), meta, n_tasks, n_tenants, kp, np_pad);
  return cudaGetLastError();
}

}  // namespace

// a (m_flat, kp), b (n_tenants, kp, np_pad) and c (m_flat, np_pad), all
// contiguous; meta (5, n_tasks) int32.  bm: the plan's row block (16, 32,
// 64 or 128); bn and bk must be kTileN and kTileK.  dtype: 0 = float32 (CUDA
// cores), 1 = bfloat16 (tensor cores; kp and np_pad are multiples of 8 by
// construction).  Returns the launch's cudaError_t.
extern "C" int coexec(const void* a, const void* b, void* c, const void* meta,
                      int n_tasks, int n_tenants, int kp, int np_pad, int bm,
                      int bn, int bk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mt = static_cast<const int*>(meta);
  if (bn != kTileN || bk != kTileK || (dtype != 0 && dtype != 1) ||
      n_tasks <= 0)
    return cudaErrorInvalidValue;
  switch (bm) {
    case 16:
      return launch<16>(a, b, c, mt, n_tasks, n_tenants, kp, np_pad, dtype, s);
    case 32:
      return launch<32>(a, b, c, mt, n_tasks, n_tenants, kp, np_pad, dtype, s);
    case 64:
      return launch<64>(a, b, c, mt, n_tasks, n_tenants, kp, np_pad, dtype, s);
    case 128:
      return launch<128>(a, b, c, mt, n_tasks, n_tenants, kp, np_pad, dtype,
                         s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* coexec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
