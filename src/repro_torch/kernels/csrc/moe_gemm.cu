// K7: capacity-padded batched expert GEMM, out[e] = x[e] @ w[e] with
// x (E, C, d), w (E, d, f) and out (E, C, f), for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel repro/kernels/moe_gemm.py::
// _moe_kernel (launched by moe_grouped_gemm).  Same contract: an f32
// accumulator over d per output tile, written once in x's dtype.  The TPU
// wrapper pads C, d and f up to its block grid and slices the result; here
// nothing is padded or copied: the ragged edges are zero-filled on load and
// clipped on store.
//
// What bounds it on an H100: the (d, f) weights of every expert, read once
// (decode capacities, a few rows an expert, and at phi3.5-moe's training
// capacity of 320 rows still below the card's balance of about 295
// operations a byte), so device-memory bytes.
//
// bf16 with 16-byte aligned rows (d and f multiples of 8) runs the TMA +
// wgmma mainloop of hopper_gemm.cuh (the producer and consumer loops K4
// runs), swap-AB as K4: 64 * NWG weight columns of w[e] form wgmma's 64-row
// side and BQ (64 or 128) rows of x[e] its n side.  The expert is the
// grid's y axis, so no tile table is built on the host.  x and out go
// through 3-D tensor maps (d or f, C, E): a box at the
// C edge gets zero fill on load and is clipped on store, so a CTA never
// reads or writes the next expert's rows; w through K4's 3-D weight map (f,
// d, E).  Row tiles of one expert run side by side (a raster band) for each
// tile of weight columns, so they read that weight tile from L2 after the
// first read.  The C tile leaves through shared memory in TMA's swizzled
// box layout by 3-D TMA stores.  Every launch is a programmatic dependent
// launch.  The launch plan (repro_torch/kernels/moe_gemm.py::k7_plan) names
// BQ, NWG, the stages and the band; the entry refuses any plan it was not
// instantiated for.
//
// float32 (exact, no TF32), and bf16 rows that are not 16-byte aligned, run
// tile_gemm.cuh's CUDA-core body, one block per (f tile, C tile, expert) at
// the tile height bm (16 / 32 / 64 / 128) that choose_block_config(C)
// gives.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

#include "gemm_tiles.cuh"
#include "hopper_gemm.cuh"
#include "tile_gemm.cuh"

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
                   int d, int f, int dtype, cudaStream_t s) {
  const dim3 grid((f + kTileN - 1) / kTileN, (c + BM - 1) / BM, e);
  if (dtype == 1)
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

// ---------------------------------------------------------------------------
// bf16 body: TMA + wgmma, warp-specialised, swap-AB (hopper_gemm.cuh).
// ---------------------------------------------------------------------------
// CTA (row tile q0 of expert e, weight columns p0) computes D[BP x BQ] =
// w[e]^T x[e]^T: X = w[e] MN-major through the 3-D weight map, Y = BQ rows
// of x[e] K-major through x's 3-D map; D is out[e]^T.
template <int NWG, int BQ, int STAGES>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    moe_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                          const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tout, int c,
                          int f, int ksteps, int band) {
  using S = HgStage<NWG, BQ, true, false>;
  constexpr int BP = S::kBP;
  static_assert(BP * BQ * 2 <= STAGES * S::kBytes, "staging tile");
  extern __shared__ uint4 smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_raw) +
                  ((1024 - (hg_smem(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * S::kBytes);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // Launched with programmatic stream serialization: x may come from the
  // kernel just before, so it is read only after this.
  grid_dependency_wait();

  // Raster bands within the expert: `band` row tiles (fastest) by every
  // weight-column tile.
  const int e = blockIdx.y;
  const int n_ct = (c + BQ - 1) / BQ, p_tiles = (f + BP - 1) / BP;
  const int per_band = band * p_tiles;
  const int b = blockIdx.x / per_band, off = blockIdx.x % per_band;
  const int rows_in_band = min(band, n_ct - b * band);
  const int q0 = (b * band + off % rows_in_band) * BQ;
  const int p0 = (off / rows_in_band) * BP;

  const int warp = threadIdx.x / 32;
  float acc[BQ / 2];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) acc[i] = 0.f;
  if (warp == NWG * 4) {
    if (threadIdx.x % 32 == 0) {
      tma_prefetch_map(&tw);
      tma_prefetch_map(&tx);
      hg_produce_at<NWG, BQ, STAGES, true, false, true, true>(
          ring, full, empty, &tw, &tx, p0, q0, 0, ksteps, e, 0, e);
    }
  } else {
    hg_consume<NWG, BQ, STAGES, true, false>(ring, full, empty, warp / 4,
                                             ksteps, acc);
  }
  launch_dependents();

  // Every wgmma has drained: the ring becomes out[e]'s tile, BP / 64 boxes
  // of (BQ rows x 64 columns) in TMA's 128-byte swizzle.
  __syncthreads();
  if (warp < NWG * 4) {
    // This thread's fragment rows p (r, r + 8) and columns q (hopper_gemm.cuh).
    const int tt = threadIdx.x % 128;
    const int r = (warp / 4) * 64 + (tt / 32) * 16 + (tt % 32) / 4;
    const int c0 = 2 * (tt % 4);
#pragma unroll
    for (int cc = 0; cc < BQ / 8; ++cc)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = r + 8 * h, q = 8 * cc + c0 + j;
          *reinterpret_cast<__nv_bfloat16*>(
              ring + (p / 64) * (BQ * 128) + q * 128 +
              ((((p % 64) / 8) ^ (q % 8)) * 16) + (p % 8) * 2) =
              __float2bfloat16(acc[4 * cc + 2 * h + j]);
        }
    fence_proxy_async();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < BP / 64; ++j)
      if (p0 + 64 * j < f)
        tma_store_3d(&tout, ring + j * (BQ * 128), p0 + 64 * j, q0, e);
    tma_store_commit();
    tma_store_wait_read();
  }
}

template <int NWG, int BQ, int STAGES>
cudaError_t launch_wgmma(const CUtensorMap& tw, const CUtensorMap& tx,
                         const CUtensorMap& tout, int e, int c, int f,
                         int ksteps, int band, cudaStream_t stream) {
  using S = HgStage<NWG, BQ, true, false>;
  constexpr int kSmem = STAGES * S::kBytes + 2 * STAGES * 8 + 1024;
  auto kernel = moe_gemm_wgmma_kernel<NWG, BQ, STAGES>;
  static unsigned long long raised = 0;  // per instantiation, a bit a device
  cudaError_t err = hg_raise_smem(kernel, kSmem, raised);
  if (err != cudaSuccess) return err;
  const long long ctas =
      (long long)((c + BQ - 1) / BQ) * ((f + S::kBP - 1) / S::kBP);
  if (ctas > 0x7fffffff || e > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas, e);
  cfg.blockDim = dim3(NWG * 128 + 32);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tw, tx, tout, c, f, ksteps, band);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x (e, c, d), w (e, d, f) and out (e, c, f), all contiguous.  The
// CUDA-core body: bm 16, 32, 64 or 128; dtype 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t.
extern "C" int moe_gemm(const void* x, const void* w, void* out, int e, int c,
                        int d, int f, int bm, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (bm) {
    case 16: return launch<16>(x, w, out, e, c, d, f, dtype, s);
    case 32: return launch<32>(x, w, out, e, c, d, f, dtype, s);
    case 64: return launch<64>(x, w, out, e, c, d, f, dtype, s);
    case 128: return launch<128>(x, w, out, e, c, d, f, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

// The wgmma body for bf16 with d and f multiples of 8 and 16-byte aligned
// bases (checked by the caller), arguments as above, following a plan of
// k7_plan: bq rows of an expert a CTA, nwg consumer warpgroups (64 nwg
// weight columns a CTA), stages, and band row tiles side by side.  Any
// plan that was not instantiated returns cudaErrorInvalidValue.
extern "C" int moe_gemm_wgmma(const void* x, const void* w, void* out, int e,
                              int c, int d, int f, int bq, int nwg,
                              int stages, int band, void* stream) {
  if (e <= 0 || c <= 0 || d <= 0 || f <= 0 || band <= 0 || d % 8 || f % 8)
    return cudaErrorInvalidValue;
  const int ksteps = (d + kHgBK - 1) / kHgBK;
  CUtensorMap tw, tx, tout;
  // X: the weight stack (e, d, f), f-major; Y: bq rows of x (e, c, d);
  // out (e, c, f), boxes of bq rows by 64 columns.
  cudaError_t err = tensor_map_3d(&tw, w, f, d, e, 64);
  if (err == cudaSuccess) err = tensor_map_3d(&tx, x, d, c, e, bq);
  if (err == cudaSuccess) err = tensor_map_3d(&tout, out, f, c, e, bq);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K7_PLAN(BQ, NWG, ST)                                                  \
  if (bq == BQ && nwg == NWG && stages == ST)                                 \
    return launch_wgmma<NWG, BQ, ST>(tw, tx, tout, e, c, f, ksteps, band, s);
  K7_PLAN(64, 4, 5)
  K7_PLAN(128, 4, 4)
#undef K7_PLAN
  return cudaErrorInvalidValue;
}

extern "C" const char* moe_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
