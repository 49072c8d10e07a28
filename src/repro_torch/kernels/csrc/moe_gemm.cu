// K7: capacity-padded batched expert GEMM, out[e] = x[e] @ w[e] with
// x (E, C, d), w (E, d, f) and out (E, C, f), for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel repro/kernels/moe_gemm.py::
// _moe_kernel (launched by moe_grouped_gemm).  Same contract: an f32
// accumulator over d per output tile, written once in x's dtype.  The TPU
// wrapper pads C, d and f up to its block grid and slices the result; here
// the ragged edges are masked inside the kernel (rows past C and columns
// past f are never written, A rows past C and K past d are zero-filled by
// cp.async's source size), so nothing is padded or copied.
//
// One block per (f tile, C tile, expert).  What bounds it on an H100: at
// decode capacities (a few rows an expert) the (d, f) weights of every
// expert, read once per C tile, so device-memory bytes; at training
// capacities (hundreds of rows) the operations.  The tile bodies are
// tile_gemm.cuh's: bf16 with 16-byte aligned rows (d and f multiples of 8)
// on the tensor cores, f32 and other bf16 on the CUDA cores; the tile height
// bm (16 / 32 / 64 / 128) comes from choose_block_config(C).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "gemm_tiles.cuh"
#include "tile_gemm.cuh"

template <int BM>
__global__ void __launch_bounds__(TcTile<BM>::kThreads)
    moe_gemm_tc_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ out, int c, int d, int f) {
  extern __shared__ uint4 smem_raw[];
  const int e = blockIdx.z, row0 = blockIdx.y * BM, n0 = blockIdx.x * kTileN;
  const int rows = min(BM, c - row0), cols = min(kTileN, f - n0);
  const StoreTile<__nv_bfloat16> epi{out + ((long long)e * c + row0) * f + n0,
                                     f, rows, cols};
  tc_tile<BM>(x + ((long long)e * c + row0) * d, d, rows,
              w + (long long)e * d * f + n0, f, cols, d, smem_raw, epi);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kFpThreads)
    moe_gemm_fp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       T* __restrict__ out, int c, int d, int f) {
  const int e = blockIdx.z, row0 = blockIdx.y * BM, n0 = blockIdx.x * kTileN;
  const int rows = min(BM, c - row0), cols = min(kTileN, f - n0);
  const StoreTile<T> epi{out + ((long long)e * c + row0) * f + n0, f, rows,
                         cols};
  fp_tile<T, BM>(x + ((long long)e * c + row0) * d, d, rows,
                 w + (long long)e * d * f + n0, f, cols, d, epi);
}

template <int BM>
cudaError_t launch(const void* x, const void* w, void* out, int e, int c,
                   int d, int f, int dtype, int tensor_cores, cudaStream_t s) {
  const dim3 grid((f + kTileN - 1) / kTileN, (c + BM - 1) / BM, e);
  if (dtype == 1 && tensor_cores)
    moe_gemm_tc_kernel<BM><<<grid, TcTile<BM>::kThreads,
                             TcTile<BM>::kSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), c, d, f);
  else if (dtype == 1)
    moe_gemm_fp_kernel<__nv_bfloat16, BM><<<grid, kFpThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), c, d, f);
  else
    moe_gemm_fp_kernel<float, BM><<<grid, kFpThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), c, d, f);
  return cudaGetLastError();
}

}  // namespace

// x (e, c, d), w (e, d, f) and out (e, c, f), all contiguous.  bm: 16, 32,
// 64 or 128.  dtype: 0 = float32, 1 = bfloat16; tensor_cores: bf16 with d
// and f multiples of 8 and 16-byte aligned bases (checked by the caller).
// Returns the launch's cudaError_t.
extern "C" int moe_gemm(const void* x, const void* w, void* out, int e, int c,
                        int d, int f, int bm, int dtype, int tensor_cores,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (bm) {
    case 16:
      return launch<16>(x, w, out, e, c, d, f, dtype, tensor_cores, s);
    case 32:
      return launch<32>(x, w, out, e, c, d, f, dtype, tensor_cores, s);
    case 64:
      return launch<64>(x, w, out, e, c, d, f, dtype, tensor_cores, s);
    case 128:
      return launch<128>(x, w, out, e, c, d, f, dtype, tensor_cores, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* moe_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
