// K1: SISA-scheduled GEMM, C[M,N] = A[M,K] @ B[K,N], for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel repro/kernels/sisa_gemm.py::_gemm_kernel
// (launched by sisa_gemm).  Same contract: output-stationary, an f32
// accumulator per output held for the whole K sweep, C written once in A's
// dtype, inputs bf16 or f32.
//
// SISA's three execution modes are template instantiations of the tile
// height BM: a skinny slab (BM = 16, one mma row group, covering every decode
// rung up to 16), fused slabs (BM = 32 / 64) and the monolithic 128-row tile.
// The ragged M > 128 residual pass is a second launch on the tail rows
// (repro_torch/kernels/ops.py), writing its own rows of the same C.
//
// What bounds it on an H100: decode (M <= 16) reads every weight once for a
// handful of rows, so it is bound by device-memory bytes (K*N elements);
// prefill (M in the hundreds) is bound by operations.  Two bodies share the
// tile heights:
//
// * bf16 (the serving path): tensor cores through mma.sync m16n8k16 with an
//   f32 accumulator, fed by a cp.async pipeline of STAGES shared-memory
//   tiles so several K steps are in flight while one is multiplied.  Ragged
//   edges are zero-filled by cp.async's source size, so no operand is padded
//   or copied.  The decode slab splits each K tile over WK warps (summed in
//   shared memory at the end) to keep more weight bytes in flight per block.
//   It needs 16-byte aligned rows (the wrapper checks; every main-path
//   shape has them).
// * f32, and bf16 rows that are not 16-byte aligned: a plain shared-memory
//   tiled kernel on the CUDA cores (each thread a TM x TN register tile), so
//   float32 stays exact float32 (no TF32).
//
// B may arrive transposed (the tied LM head reads the (vocab, d) embedding
// table as B = table.T without a copy): TRANS_B instantiations walk the
// contiguous K axis of B.  wgmma and TMA are later work.
//
// K3, the split-K variant (repro/kernels/sisa_gemm.py::_splitk_kernel,
// launched by sisa_gemm_splitk), is the last kernel of this file: K is cut
// into slabs of bk columns, and each slab's block writes its own f32
// partial C into (n_k, M, N); the wrapper sums the partials.  For a decode
// GEMV (M and N both small) this puts n_k times as many blocks, each
// reading a slab of the weights, in flight.  Its tile bodies are
// tile_gemm.cuh's, shared with K6 and K7; K1's own bodies above are not
// touched by it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "gemm_tiles.cuh"
#include "tile_gemm.cuh"

template <typename T, int BM, int BN, int BK, int TM, int TN, bool TRANS_B>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    sisa_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ c, int m, int n, int k, long long lda,
                     long long sbk, long long sbn, long long ldc) {
  constexpr int RT = BM / TM;  // thread rows
  constexpr int CT = BN / TN;  // thread columns
  constexpr int NT = RT * CT;
  // +1 pads keep the transposed stores free of bank conflicts.
  __shared__ float as[BK][BM + 1];
  __shared__ float bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % CT;
  const int ty = tid / CT;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A tile: neighbouring threads read neighbouring k of one row.
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int gr = m0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? to_f32(a[(long long)gr * lda + gk]) : 0.f;
    }
    // B tile: neighbouring threads follow B's contiguous axis.
    for (int e = tid; e < BK * BN; e += NT) {
      int kk, cc;
      if (TRANS_B) {
        cc = e / BK;
        kk = e % BK;
      } else {
        kk = e / BN;
        cc = e % BN;
      }
      const int gk = k0 + kk, gc = n0 + cc;
      bs[kk][cc] = (gk < k && gc < n)
                       ? to_f32(b[(long long)gk * sbk + (long long)gc * sbn])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + i * RT];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + j * CT];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = m0 + ty + i * RT;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = n0 + tx + j * CT;
      if (gc < n) c[(long long)gr * ldc + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k,
                   long long lda, long long sbk, long long sbn, long long ldc,
                   int trans_b, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 block((BM / TM) * (BN / TN));
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* pc = static_cast<T*>(c);
  if (trans_b)
    sisa_gemm_kernel<T, BM, BN, BK, TM, TN, true>
        <<<grid, block, 0, stream>>>(pa, pb, pc, m, n, k, lda, sbk, sbn, ldc);
  else
    sisa_gemm_kernel<T, BM, BN, BK, TM, TN, false>
        <<<grid, block, 0, stream>>>(pa, pb, pc, m, n, k, lda, sbk, sbn, ldc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 tensor-core body.
// ---------------------------------------------------------------------------
// C tile BM x BN per block; warps laid out WM x WN over the tile and WK
// deep over each K tile (WK > 1: partial sums added in shared memory).
template <int BM, int BN, int BK, int WM, int WN, int WK, int STAGES,
          bool TRANS_B>
__global__ void __launch_bounds__(WM* WN* WK * 32)
    sisa_gemm_tc_kernel(const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ b,
                        __nv_bfloat16* __restrict__ c, int m, int n, int k,
                        long long lda, long long ldb, long long ldc) {
  using Stage = TcStage<BM, BN, BK, TRANS_B>;
  constexpr int NT = WM * WN * WK * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  constexpr int FM = WTM / 16, FN = WTN / 8;   // mma fragments per warp
  constexpr int KW = BK / WK;                  // K columns per warp per tile
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && KW % 16 == 0, "tile");
  static_assert(BK % 8 == 0 && BN % 8 == 0, "16-byte chunks");

  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % WM;
  const int wn = (warp / WM) % WN;
  const int wk = warp / (WM * WN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = (k + BK - 1) / BK;

  auto load_tile = [&](int stage, int kt) {
    __nv_bfloat16* as = smem + stage * Stage::kElems;
    __nv_bfloat16* bs = as + Stage::kA;
    const int k0 = kt * BK;
    for (int e = tid; e < BM * (BK / 8); e += NT) {
      const int r = e / (BK / 8), kc = (e % (BK / 8)) * 8;
      const int gr = m0 + r, gk = k0 + kc;
      const int nb = (gr < m) ? 2 * max(0, min(8, k - gk)) : 0;
      cp_async16(as + r * (BK + kPad) + kc,
                 nb ? a + (long long)gr * lda + gk : a, nb);
    }
    if (TRANS_B) {
      for (int e = tid; e < BN * (BK / 8); e += NT) {
        const int r = e / (BK / 8), kc = (e % (BK / 8)) * 8;
        const int gn = n0 + r, gk = k0 + kc;
        const int nb = (gn < n) ? 2 * max(0, min(8, k - gk)) : 0;
        cp_async16(bs + r * (BK + kPad) + kc,
                   nb ? b + (long long)gn * ldb + gk : b, nb);
      }
    } else {
      for (int e = tid; e < BK * (BN / 8); e += NT) {
        const int r = e / (BN / 8), nc = (e % (BN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + nc;
        const int nb = (gk < k) ? 2 * max(0, min(8, n - gn)) : 0;
        cp_async16(bs + r * (BN + kPad) + nc,
                   nb ? b + (long long)gk * ldb + gn : b, nb);
      }
    }
  };

  float acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_tile(next % STAGES, next);
    cp_async_commit();

    const __nv_bfloat16* as = smem + (kt % STAGES) * Stage::kElems;
    const __nv_bfloat16* bs = as + Stage::kA;
#pragma unroll
    for (int ks = 0; ks < KW / 16; ++ks) {
      const int kk = wk * KW + ks * 16;
      uint32_t af[FM][4], bf[FN][2];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        ldmatrix_x4(af[i], as + (wm * WTM + i * 16 + lane % 16) * (BK + kPad) +
                               kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        if (TRANS_B)
          ldmatrix_x2(bf[j], bs + (wn * WTN + j * 8 + lane % 8) * (BK + kPad) +
                                 kk + ((lane / 8) % 2) * 8);
        else
          ldmatrix_x2_trans(bf[j], bs + (kk + lane % 16) * (BN + kPad) +
                                       wn * WTN + j * 8);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // Fragment (i, j) element q sits at row g (+8 for q >= 2), column
  // 2 * (lane % 4) + (q % 2) of its 16 x 8 tile, g = lane / 4.
  const int g = lane / 4, t2 = 2 * (lane % 4);
  if (WK > 1) {
    __syncthreads();  // the pipeline's buffers become the reduction buffer
    float* red = reinterpret_cast<float*>(smem_raw);  // [WK][BM][BN]
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = wm * WTM + i * 16 + g + (q / 2) * 8;
          const int cc = wn * WTN + j * 8 + t2 + q % 2;
          red[(wk * BM + r) * BN + cc] = acc[i][j][q];
        }
    __syncthreads();
    for (int e = tid; e < BM * BN; e += NT) {
      const int r = e / BN, cc = e % BN;
      const int gr = m0 + r, gc = n0 + cc;
      if (gr >= m || gc >= n) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WK; ++w) sum += red[(w * BM + r) * BN + cc];
      c[(long long)gr * ldc + gc] = __float2bfloat16(sum);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gr = m0 + wm * WTM + i * 16 + g + (q / 2) * 8;
        const int gc = n0 + wn * WTN + j * 8 + t2 + q % 2;
        if (gr < m && gc < n)
          c[(long long)gr * ldc + gc] = __float2bfloat16(acc[i][j][q]);
      }
}

template <int BM, int BN, int BK, int WM, int WN, int WK, int STAGES,
          bool TRANS_B>
cudaError_t launch_tc_one(const void* a, const void* b, void* c, int m, int n,
                          int k, long long lda, long long ldb, long long ldc,
                          cudaStream_t stream) {
  constexpr int kStageBytes =
      TcStage<BM, BN, BK, TRANS_B>::kElems * (int)sizeof(__nv_bfloat16);
  constexpr int kRedBytes = WK > 1 ? WK * BM * BN * (int)sizeof(float) : 0;
  constexpr int kSmem =
      STAGES * kStageBytes > kRedBytes ? STAGES * kStageBytes : kRedBytes;
  if (kSmem > 48 * 1024) {
    static bool raised = false;  // once per instantiation
    if (!raised) {
      cudaError_t err = cudaFuncSetAttribute(
          sisa_gemm_tc_kernel<BM, BN, BK, WM, WN, WK, STAGES, TRANS_B>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (err != cudaSuccess) return err;
      raised = true;
    }
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  sisa_gemm_tc_kernel<BM, BN, BK, WM, WN, WK, STAGES, TRANS_B>
      <<<grid, WM * WN * WK * 32, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(c), m, n, k, lda, ldb, ldc);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int WM, int WN, int WK, int STAGES>
cudaError_t launch_tc(const void* a, const void* b, void* c, int m, int n,
                      int k, long long lda, long long sbk, long long sbn,
                      long long ldc, int trans_b, cudaStream_t s) {
  if (trans_b)
    return launch_tc_one<BM, BN, BK, WM, WN, WK, STAGES, true>(
        a, b, c, m, n, k, lda, sbn, ldc, s);
  return launch_tc_one<BM, BN, BK, WM, WN, WK, STAGES, false>(
      a, b, c, m, n, k, lda, sbk, ldc, s);
}

// Tensor-core tile table: the height bm comes from choose_block_config
// (repro_torch/kernels/sisa_gemm.py); width and depth are set only here.
cudaError_t dispatch_tc(int bm, const void* a, const void* b, void* c, int m,
                        int n, int k, long long lda, long long sbk,
                        long long sbn, long long ldc, int trans_b,
                        cudaStream_t s) {
  switch (bm) {
    case 16:  // slab: K split over 4 warps, 3 stages of 128-deep K tiles
      return launch_tc<16, 32, 128, 1, 1, 4, 3>(a, b, c, m, n, k, lda, sbk,
                                                sbn, ldc, trans_b, s);
    case 32:  // fused pair
      return launch_tc<32, 64, 32, 2, 2, 1, 4>(a, b, c, m, n, k, lda, sbk, sbn,
                                               ldc, trans_b, s);
    case 64:  // fused quad
      return launch_tc<64, 64, 32, 2, 2, 1, 4>(a, b, c, m, n, k, lda, sbk, sbn,
                                               ldc, trans_b, s);
    case 128:  // monolithic
      return launch_tc<128, 128, 32, 4, 2, 1, 3>(a, b, c, m, n, k, lda, sbk,
                                                 sbn, ldc, trans_b, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// CUDA-core tile table: bm as above; width and depth are set only here.
template <typename T>
cudaError_t dispatch(int bm, const void* a, const void* b, void* c, int m,
                     int n, int k, long long lda, long long sbk, long long sbn,
                     long long ldc, int trans_b, cudaStream_t s) {
  switch (bm) {
    case 16:  // slab
      return launch<T, 16, 32, 64, 2, 1>(a, b, c, m, n, k, lda, sbk, sbn, ldc,
                                         trans_b, s);
    case 32:  // fused pair
      return launch<T, 32, 64, 32, 4, 2>(a, b, c, m, n, k, lda, sbk, sbn, ldc,
                                         trans_b, s);
    case 64:  // fused quad
      return launch<T, 64, 64, 32, 4, 4>(a, b, c, m, n, k, lda, sbk, sbn, ldc,
                                         trans_b, s);
    case 128:  // monolithic
      return launch<T, 128, 128, 16, 8, 8>(a, b, c, m, n, k, lda, sbk, sbn,
                                           ldc, trans_b, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K3: split-K partials.  Block (column tile, row tile, slab kk) computes
// A[rows, kk*bk : kk*bk + bk] @ B[kk*bk : kk*bk + bk, cols] into
// part[kk] (f32, M x N); the slab's K tail, ragged rows and ragged columns
// are zero-filled.
// ---------------------------------------------------------------------------
template <int BM>
__global__ void __launch_bounds__(TcTile<BM>::kThreads)
    splitk_tc_kernel(const __nv_bfloat16* __restrict__ a,
                     const __nv_bfloat16* __restrict__ b,
                     float* __restrict__ part, int m, int n, int k, int bk,
                     long long lda, long long ldb) {
  extern __shared__ uint4 smem_raw[];
  const int kk = blockIdx.z, row0 = blockIdx.y * BM, n0 = blockIdx.x * kTileN;
  const int k0 = kk * bk;
  const int rows = min(BM, m - row0), cols = min(kTileN, n - n0);
  const StoreTile<float> epi{part + ((long long)kk * m + row0) * n + n0, n,
                             rows, cols};
  tc_tile<BM>(a + (long long)row0 * lda + k0, lda, rows,
              b + (long long)k0 * ldb + n0, ldb, cols, min(bk, k - k0),
              smem_raw, epi);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kFpThreads)
    splitk_fp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     float* __restrict__ part, int m, int n, int k, int bk,
                     long long lda, long long ldb) {
  const int kk = blockIdx.z, row0 = blockIdx.y * BM, n0 = blockIdx.x * kTileN;
  const int k0 = kk * bk;
  const int rows = min(BM, m - row0), cols = min(kTileN, n - n0);
  const StoreTile<float> epi{part + ((long long)kk * m + row0) * n + n0, n,
                             rows, cols};
  fp_tile<T, BM>(a + (long long)row0 * lda + k0, lda, rows,
                 b + (long long)k0 * ldb + n0, ldb, cols, min(bk, k - k0),
                 epi);
}

template <int BM>
cudaError_t splitk_launch(const void* a, const void* b, float* part, int m,
                          int n, int k, int bk, long long lda, long long ldb,
                          int dtype, int tensor_cores, cudaStream_t s) {
  const dim3 grid((n + kTileN - 1) / kTileN, (m + BM - 1) / BM,
                  (k + bk - 1) / bk);
  if (dtype == 1 && tensor_cores)
    splitk_tc_kernel<BM><<<grid, TcTile<BM>::kThreads,
                           TcTile<BM>::kSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), part, m, n, k, bk, lda, ldb);
  else if (dtype == 1)
    splitk_fp_kernel<__nv_bfloat16, BM><<<grid, kFpThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), part, m, n, k, bk, lda, ldb);
  else
    splitk_fp_kernel<float, BM><<<grid, kFpThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), part, m, n,
        k, bk, lda, ldb);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; tensor_cores: bf16 with 16-byte aligned
// rows (checked by the caller).  Returns the launch's cudaError_t.
extern "C" int sisa_gemm(const void* a, const void* b, void* c, int m, int n,
                         int k, long long lda, long long sbk, long long sbn,
                         long long ldc, int trans_b, int dtype, int bm,
                         int tensor_cores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(bm, a, b, c, m, n, k, lda, sbk, sbn, ldc, trans_b, s);
  if (dtype == 1 && tensor_cores)
    return dispatch_tc(bm, a, b, c, m, n, k, lda, sbk, sbn, ldc, trans_b, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(bm, a, b, c, m, n, k, lda, sbk, sbn, ldc,
                                   trans_b, s);
  return cudaErrorInvalidValue;
}

// K3: part (n_k, m, n) f32 partials of a (m, k) @ b (k, n), slabs of bk
// columns of K, n_k = ceil(k / bk); a and b row-major with row strides lda
// and ldb.  bm: 16, 32, 64 or 128; tensor_cores: bf16 with 16-byte aligned
// rows and bk a multiple of 8 (checked by the caller).
extern "C" int sisa_gemm_splitk(const void* a, const void* b, void* part,
                                int m, int n, int k, int bk, long long lda,
                                long long ldb, int dtype, int bm,
                                int tensor_cores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if ((dtype != 0 && dtype != 1) || bk <= 0) return cudaErrorInvalidValue;
  switch (bm) {
    case 16:
      return splitk_launch<16>(a, b, p, m, n, k, bk, lda, ldb, dtype,
                               tensor_cores, s);
    case 32:
      return splitk_launch<32>(a, b, p, m, n, k, bk, lda, ldb, dtype,
                               tensor_cores, s);
    case 64:
      return splitk_launch<64>(a, b, p, m, n, k, bk, lda, ldb, dtype,
                               tensor_cores, s);
    case 128:
      return splitk_launch<128>(a, b, p, m, n, k, bk, lda, ldb, dtype,
                                tensor_cores, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* sisa_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
