// K4: flat ragged grouped GEMM, out[M,f] = x[M,d] @ w[gid(row)][d,f], for
// Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel
// repro/kernels/grouped_gemm.py::_flat_fwd_kernel (launched by _flat_forward
// for segment_grouped_gemm, flat_ragged_gemm and ragged_grouped_gemm).  Same
// contract: the flat buffer is cut into row tiles of `bm` rows; a
// (2, n_tiles) int32 table gives each tile its owning group (row 0) and
// `hi`, the end of its segment's valid rows (row 1).  Row tile i contracts
// against w[gid] with an f32 accumulator; rows >= hi are written 0; the
// output is in x's dtype.
//
// Scale-in: a block whose tile starts at or past `hi` (an empty expert's
// capacity, an alignment gap, the flat buffer's tail) writes zeros and
// exits before it reads a weight byte or does a multiply-add -- the TPU
// kernel's pl.when(row0 < hi).  Live tiles also zero-fill the A rows at
// or past `hi` instead of reading them.
//
// What bounds it on an H100: in MoE decode each expert holds a few rows,
// so the kernel is bound by device-memory bytes, the (d, f) weights of
// the experts that hold rows; at prefill the experts fill their tiles and
// it still reads each live expert's weights once per row tile.  The
// bodies are K1's (sisa_gemm.cu) with the B pointer moved to w[gid]:
// bf16 with 16-byte aligned rows on the tensor cores (mma.sync m16n8k16,
// a cp.async pipeline; the 16-row slab splits each K tile over four
// warps), f32 and unaligned bf16 on the CUDA cores, so f32 stays exact
// f32.  Tile heights follow K1's: the block's height BM is the smallest of
// 16 / 32 / 64 / 128 that holds `bm` (a capacity stride may force bm = 8).
//
// The backward's dX = dY @ W[gid]^T (the TPU kernel's custom VJP,
// grouped_gemm.py:301-310) runs through the same kernel: TRANS_B
// instantiations read w[gid] (d, f) in place as the (f, d) operand, walking
// its contiguous axis, as K1 reads the tied LM head's table.T -- no
// transposed copy of the (G, d, f) expert stack.
//
// One block per (column tile, row tile); the table is built on the device
// (repro_torch/kernels/grouped_gemm.py::_tile_metadata), so the caller
// never copies anything to the host.  gids are clamped into [0, G).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "gemm_tiles.cuh"

// Rows of this block's tile: [row0, live) contract against w[gid];
// [live, end) are written 0.
struct RowTile {
  int gid, row0, live, end;
};

__device__ __forceinline__ RowTile row_tile(const int* __restrict__ meta,
                                            int n_mt, int n_groups, int m,
                                            int bm) {
  const int i = blockIdx.y;
  RowTile t;
  t.row0 = i * bm;
  t.gid = min(max(meta[i], 0), n_groups - 1);
  t.end = min(m, t.row0 + bm);
  t.live = min(t.end, meta[n_mt + i]);
  return t;
}

template <typename T, int BN>
__device__ __forceinline__ void zero_rows(T* __restrict__ c, int r0, int r1,
                                          int n0, int n, long long ldc,
                                          int nt) {
  for (int e = threadIdx.x; e < (r1 - r0) * BN; e += nt) {
    const int gc = n0 + e % BN;
    if (gc < n) c[(long long)(r0 + e / BN) * ldc + gc] = from_f32<T>(0.f);
  }
}

// CUDA-core body (f32, and bf16 rows that are not 16-byte aligned).
// B[k][n] is w[gid][k][n], or w[gid][n][k] under TRANS_B.
template <typename T, int BM, int BN, int BK, int TM, int TN, bool TRANS_B>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ c, const int* __restrict__ meta,
                        int n_mt, int n_groups, int m, int n, int k, int bm,
                        long long ldx, long long ldc) {
  constexpr int RT = BM / TM;  // thread rows
  constexpr int CT = BN / TN;  // thread columns
  constexpr int NT = RT * CT;
  const RowTile t = row_tile(meta, n_mt, n_groups, m, bm);
  const int n0 = blockIdx.x * BN;
  if (t.live <= t.row0) {  // scale-in: no weight bytes, no MACs
    zero_rows<T, BN>(c, t.row0, t.end, n0, n, ldc, NT);
    return;
  }
  const T* __restrict__ b = w + (long long)t.gid * k * n;
  __shared__ float as[BK][BM + 1];
  __shared__ float bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % CT;
  const int ty = tid / CT;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int gr = t.row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < t.live && gk < k)
                      ? to_f32(x[(long long)gr * ldx + gk]) : 0.f;
    }
    // Neighbouring threads follow w's contiguous axis.
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = TRANS_B ? e % BK : e / BN;
      const int cc = TRANS_B ? e / BK : e % BN;
      const int gk = k0 + kk, gc = n0 + cc;
      const long long at = TRANS_B ? (long long)gc * k + gk
                                   : (long long)gk * n + gc;
      bs[kk][cc] = (gk < k && gc < n) ? to_f32(b[at]) : 0.f;
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
    const int gr = t.row0 + ty + i * RT;
    if (gr >= t.end) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = n0 + tx + j * CT;
      if (gc < n)
        c[(long long)gr * ldc + gc] = from_f32<T>(gr < t.live ? acc[i][j] : 0.f);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const void* x, const void* w, void* c, const int* meta,
                   int n_mt, int n_groups, int m, int n, int k, int bm,
                   long long ldx, long long ldc, int trans_b,
                   cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, n_mt);
  const dim3 block((BM / TM) * (BN / TN));
  const T* px = static_cast<const T*>(x);
  const T* pw = static_cast<const T*>(w);
  T* pc = static_cast<T*>(c);
  if (trans_b)
    grouped_gemm_kernel<T, BM, BN, BK, TM, TN, true>
        <<<grid, block, 0, stream>>>(px, pw, pc, meta, n_mt, n_groups, m, n,
                                     k, bm, ldx, ldc);
  else
    grouped_gemm_kernel<T, BM, BN, BK, TM, TN, false>
        <<<grid, block, 0, stream>>>(px, pw, pc, meta, n_mt, n_groups, m, n,
                                     k, bm, ldx, ldc);
  return cudaGetLastError();
}

// bf16 tensor-core body: K1's sisa_gemm_tc_kernel with B at w[gid]
// (row-major, or transposed under TRANS_B) and the tile's rows bounded by
// `hi`.
template <int BM, int BN, int BK, int WM, int WN, int WK, int STAGES,
          bool TRANS_B>
__global__ void __launch_bounds__(WM* WN* WK * 32)
    grouped_gemm_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           __nv_bfloat16* __restrict__ c,
                           const int* __restrict__ meta, int n_mt,
                           int n_groups, int m, int n, int k, int bm,
                           long long ldx, long long ldc) {
  using Stage = TcStage<BM, BN, BK, TRANS_B>;
  constexpr int NT = WM * WN * WK * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  constexpr int FM = WTM / 16, FN = WTN / 8;   // mma fragments per warp
  constexpr int KW = BK / WK;                  // K columns per warp per tile
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && KW % 16 == 0, "tile");
  static_assert(BK % 8 == 0 && BN % 8 == 0, "16-byte chunks");

  const RowTile t = row_tile(meta, n_mt, n_groups, m, bm);
  const int n0 = blockIdx.x * BN;
  if (t.live <= t.row0) {  // scale-in: no weight bytes, no MACs
    zero_rows<__nv_bfloat16, BN>(c, t.row0, t.end, n0, n, ldc, NT);
    return;
  }
  const __nv_bfloat16* __restrict__ b = w + (long long)t.gid * k * n;

  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % WM;
  const int wn = (warp / WM) % WN;
  const int wk = warp / (WM * WN);
  const int ktiles = (k + BK - 1) / BK;

  auto load_tile = [&](int stage, int kt) {
    __nv_bfloat16* as = smem + stage * Stage::kElems;
    __nv_bfloat16* bs = as + Stage::kA;
    const int k0 = kt * BK;
    for (int e = tid; e < BM * (BK / 8); e += NT) {
      const int r = e / (BK / 8), kc = (e % (BK / 8)) * 8;
      const int gr = t.row0 + r, gk = k0 + kc;
      const int nb = (gr < t.live) ? 2 * max(0, min(8, k - gk)) : 0;
      cp_async16(as + r * (BK + kPad) + kc,
                 nb ? x + (long long)gr * ldx + gk : x, nb);
    }
    if (TRANS_B) {  // B tile [BN][BK]: rows of w[gid], k contiguous
      for (int e = tid; e < BN * (BK / 8); e += NT) {
        const int r = e / (BK / 8), kc = (e % (BK / 8)) * 8;
        const int gn = n0 + r, gk = k0 + kc;
        const int nb = (gn < n) ? 2 * max(0, min(8, k - gk)) : 0;
        cp_async16(bs + r * (BK + kPad) + kc,
                   nb ? b + (long long)gn * k + gk : b, nb);
      }
    } else {
      for (int e = tid; e < BK * (BN / 8); e += NT) {
        const int r = e / (BN / 8), nc = (e % (BN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + nc;
        const int nb = (gk < k) ? 2 * max(0, min(8, n - gn)) : 0;
        cp_async16(bs + r * (BN + kPad) + nc,
                   nb ? b + (long long)gk * n + gn : b, nb);
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
      const int gr = t.row0 + r, gc = n0 + cc;
      if (gr >= t.end || gc >= n) continue;
      float sum = 0.f;
#pragma unroll
      for (int ww = 0; ww < WK; ++ww) sum += red[(ww * BM + r) * BN + cc];
      c[(long long)gr * ldc + gc] = __float2bfloat16(gr < t.live ? sum : 0.f);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gr = t.row0 + wm * WTM + i * 16 + g + (q / 2) * 8;
        const int gc = n0 + wn * WTN + j * 8 + t2 + q % 2;
        if (gr < t.end && gc < n)
          c[(long long)gr * ldc + gc] =
              __float2bfloat16(gr < t.live ? acc[i][j][q] : 0.f);
      }
}

template <int BM, int BN, int BK, int WM, int WN, int WK, int STAGES,
          bool TRANS_B>
cudaError_t launch_tc_one(const void* x, const void* w, void* c,
                          const int* meta, int n_mt, int n_groups, int m,
                          int n, int k, int bm, long long ldx, long long ldc,
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
          grouped_gemm_tc_kernel<BM, BN, BK, WM, WN, WK, STAGES, TRANS_B>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (err != cudaSuccess) return err;
      raised = true;
    }
  }
  const dim3 grid((n + BN - 1) / BN, n_mt);
  grouped_gemm_tc_kernel<BM, BN, BK, WM, WN, WK, STAGES, TRANS_B>
      <<<grid, WM * WN * WK * 32, kSmem, stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(w),
          static_cast<__nv_bfloat16*>(c), meta, n_mt, n_groups, m, n, k, bm,
          ldx, ldc);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int WM, int WN, int WK, int STAGES>
cudaError_t launch_tc(const void* x, const void* w, void* c, const int* meta,
                      int n_mt, int n_groups, int m, int n, int k, int bm,
                      long long ldx, long long ldc, int trans_b,
                      cudaStream_t s) {
  if (trans_b)
    return launch_tc_one<BM, BN, BK, WM, WN, WK, STAGES, true>(
        x, w, c, meta, n_mt, n_groups, m, n, k, bm, ldx, ldc, s);
  return launch_tc_one<BM, BN, BK, WM, WN, WK, STAGES, false>(
      x, w, c, meta, n_mt, n_groups, m, n, k, bm, ldx, ldc, s);
}

// Block height: the smallest of K1's tile heights that holds `bm` rows.
int block_height(int bm) {
  return bm <= 16 ? 16 : bm <= 32 ? 32 : bm <= 64 ? 64 : bm <= 128 ? 128 : 0;
}

// Tile widths and depths per height, as in K1's dispatch tables.
cudaError_t dispatch_tc(const void* x, const void* w, void* c,
                        const int* meta, int n_mt, int n_groups, int m, int n,
                        int k, int bm, long long ldx, long long ldc,
                        int trans_b, cudaStream_t s) {
  switch (block_height(bm)) {
    case 16:  // slab: K split over 4 warps, 3 stages of 128-deep K tiles
      return launch_tc<16, 32, 128, 1, 1, 4, 3>(
          x, w, c, meta, n_mt, n_groups, m, n, k, bm, ldx, ldc, trans_b, s);
    case 32:  // fused pair
      return launch_tc<32, 64, 32, 2, 2, 1, 4>(
          x, w, c, meta, n_mt, n_groups, m, n, k, bm, ldx, ldc, trans_b, s);
    case 64:  // fused quad
      return launch_tc<64, 64, 32, 2, 2, 1, 4>(
          x, w, c, meta, n_mt, n_groups, m, n, k, bm, ldx, ldc, trans_b, s);
    case 128:  // monolithic
      return launch_tc<128, 128, 32, 4, 2, 1, 3>(
          x, w, c, meta, n_mt, n_groups, m, n, k, bm, ldx, ldc, trans_b, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* c, const int* meta,
                     int n_mt, int n_groups, int m, int n, int k, int bm,
                     long long ldx, long long ldc, int trans_b,
                     cudaStream_t s) {
  switch (block_height(bm)) {
    case 16:  // slab
      return launch<T, 16, 32, 64, 2, 1>(
          x, w, c, meta, n_mt, n_groups, m, n, k, bm, ldx, ldc, trans_b, s);
    case 32:  // fused pair
      return launch<T, 32, 64, 32, 4, 2>(
          x, w, c, meta, n_mt, n_groups, m, n, k, bm, ldx, ldc, trans_b, s);
    case 64:  // fused quad
      return launch<T, 64, 64, 32, 4, 4>(
          x, w, c, meta, n_mt, n_groups, m, n, k, bm, ldx, ldc, trans_b, s);
    case 128:  // monolithic
      return launch<T, 128, 128, 16, 8, 8>(
          x, w, c, meta, n_mt, n_groups, m, n, k, bm, ldx, ldc, trans_b, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (m, k) with row stride ldx; w contiguous, (n_groups, k, n), or
// (n_groups, n, k) read as its transpose when trans_b; c (m, n) with row
// stride ldc; meta (2, n_mt) int32 [gid; hi], n_mt = ceil(m / bm).
// dtype: 0 = float32, 1 = bfloat16; tensor_cores: bf16 with 16-byte aligned
// rows (checked by the caller).  Returns the launch's cudaError_t.
extern "C" int grouped_gemm(const void* x, const void* w, void* c,
                            const void* meta, int n_mt, int n_groups, int m,
                            int n, int k, int bm, long long ldx, long long ldc,
                            int trans_b, int dtype, int tensor_cores,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mt = static_cast<const int*>(meta);
  if (dtype == 0)
    return dispatch<float>(x, w, c, mt, n_mt, n_groups, m, n, k, bm, ldx, ldc,
                           trans_b, s);
  if (dtype == 1 && tensor_cores)
    return dispatch_tc(x, w, c, mt, n_mt, n_groups, m, n, k, bm, ldx, ldc,
                       trans_b, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, c, mt, n_mt, n_groups, m, n, k, bm,
                                   ldx, ldc, trans_b, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* grouped_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
