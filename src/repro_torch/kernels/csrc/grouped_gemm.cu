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
// Scale-in: a CTA whose tile starts at or past `hi` (an empty expert's
// capacity, an alignment gap, the flat buffer's tail) writes zeros and
// exits before it reads a weight byte or does a multiply-add -- the TPU
// kernel's pl.when(row0 < hi).
//
// What bounds it on an H100, and what the design does about it:
// * MoE decode (a few rows an expert) and prefill (one row tile an
//   expert) read each live expert's (d, f) weights once for a handful of
//   rows: bound by device-memory bytes.  Training (4-5 row tiles an
//   expert) is near the balance of bytes and operations.
// * The bf16 body (16-byte aligned rows) is the TMA + wgmma pipeline of
//   hopper_gemm.cuh, swap-AB in every mode: 64 * NWG weight columns of
//   w[gid] form wgmma's 64-row side and the row tile's rows its n8 ... n128
//   side (BQ, the smallest of 8 / 16 / 32 / 64 / 128 that holds `bm`), so a
//   CTA never spans two row tiles, and so never two experts, and no
//   instruction multiplies the padding rows of a short decode tile.  The
//   weights come through a 3-D tensor map (inner, rows, expert), so a box
//   at an expert's edge gets TMA's zero fill instead of the next expert's
//   rows; x's rows past `hi` are read as they are, and only their own
//   output rows, written as 0, depend on them.
// * The grid is raster-banded: `band` row tiles run side by side for each
//   tile of weight columns, so an expert's row tiles read its weight slab
//   from L2 after the first read, while the band's rows of x stay in L2
//   across the weight tiles (the launch plan sizes the band).
// * The C tile leaves transposed: staged through shared memory and stored
//   as whole 16-byte pieces of output rows, not as scattered 2-byte
//   writes.
// * Every launch is a programmatic dependent launch: barrier setup runs
//   while the kernel before (the tile table's stack) finishes, and the
//   table is read only after griddepcontrol.wait.
// The launch plan (repro_torch/kernels/grouped_gemm.py::k4_plan) names BQ,
// NWG, the stages and the band; the entry refuses any plan it was not
// instantiated for.
//
// The backward's dX = dY @ W[gid]^T (the TPU kernel's custom VJP,
// grouped_gemm.py:301-310) runs through the same body: w[gid] (d, f) is
// read in place as the (f, d) operand through a K-major map -- no
// transposed copy of the (G, d, f) expert stack.
//
// float32 (exact, no TF32), and bf16 rows that are not 16-byte aligned, run
// a shared-memory tiled body on the CUDA cores at the tile height of 16 /
// 32 / 64 / 128 that holds `bm`, one block per (column tile, row tile).
//
// The table is built on the device (repro_torch/kernels/grouped_gemm.py::
// _tile_metadata), so the caller never copies anything to the host.  gids
// are clamped into [0, G).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

#include "gemm_tiles.cuh"
#include "hopper_gemm.cuh"

// Rows of this block's tile: [row0, live) contract against w[gid];
// [live, end) are written 0.
struct RowTile {
  int gid, row0, live, end;
};

__device__ __forceinline__ RowTile row_tile(const int* __restrict__ meta,
                                            int i, int n_mt, int n_groups,
                                            int m, int bm) {
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
  const RowTile t = row_tile(meta, blockIdx.y, n_mt, n_groups, m, bm);
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

// ---------------------------------------------------------------------------
// bf16 body: TMA + wgmma, warp-specialised, swap-AB (hopper_gemm.cuh).
// ---------------------------------------------------------------------------
// CTA (row tile i, weight-column tile p0) computes D[BP x BQ] = W^T * x^T:
// X = w[gid]^T (BP = 64 NWG weight columns by K; MN-major for the forward's
// row-major (K, N) w[gid], K-major for dX's w[gid] read as its transpose),
// Y = the tile's rows of x (K-major), BQ >= bm of them; D is out^T.
template <int NWG, int BQ, int STAGES, bool X_MN>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    grouped_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                              const __grid_constant__ CUtensorMap tx,
                              __nv_bfloat16* __restrict__ c,
                              const int* __restrict__ meta, int n_mt,
                              int n_groups, int m, int n, int ksteps, int bm,
                              int band, long long ldc) {
  using S = HgStage<NWG, BQ, X_MN, false>;
  constexpr int BP = S::kBP;
  constexpr int kPitch = BP + 8;  // staged out^T row (bf16): 16-byte aligned
  static_assert(BQ * kPitch * 2 <= STAGES * S::kBytes, "staging tile");
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
  // Launched with programmatic stream serialization: the tile table is
  // written by the kernels just before, so it is read only after this.
  grid_dependency_wait();

  // Raster bands: `band` row tiles (fastest) by every weight-column tile.
  const int p_tiles = (n + BP - 1) / BP;
  const int per_band = band * p_tiles;
  const int b = blockIdx.x / per_band, off = blockIdx.x % per_band;
  const int rows_in_band = min(band, n_mt - b * band);
  const RowTile t =
      row_tile(meta, b * band + off % rows_in_band, n_mt, n_groups, m, bm);
  const int p0 = (off / rows_in_band) * BP;
  if (t.live <= t.row0) {  // scale-in: no weight bytes, no MACs
    for (int e = threadIdx.x; e < (t.end - t.row0) * BP; e += blockDim.x) {
      const int p = p0 + e % BP;
      if (p < n)
        c[(long long)(t.row0 + e / BP) * ldc + p] = __float2bfloat16(0.f);
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  float acc[BQ / 2];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) acc[i] = 0.f;
  if (warp == NWG * 4) {
    if (threadIdx.x % 32 == 0) {
      tma_prefetch_map(&tw);
      tma_prefetch_map(&tx);
      hg_produce_at<NWG, BQ, STAGES, X_MN, false, true>(
          ring, full, empty, &tw, &tx, p0, t.row0, 0, ksteps, t.gid, 0);
    }
  } else {
    hg_consume<NWG, BQ, STAGES, X_MN, false>(ring, full, empty, warp / 4,
                                             ksteps, acc);
  }
  launch_dependents();

  // Every wgmma has drained: the ring becomes the out^T tile, rows q of
  // the tile at or past `hi` set to 0 (only they read x's rows past hi).
  __syncthreads();
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring);
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
          const int q = 8 * cc + c0 + j;
          tile[q * kPitch + r + 8 * h] = __float2bfloat16(
              t.row0 + q < t.live ? acc[4 * cc + 2 * h + j] : 0.f);
        }
  }
  __syncthreads();
  // Whole output rows: 16-byte pieces of 8 columns, neighbouring threads
  // on neighbouring pieces.
  const bool vec = ldc % 8 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  for (int e = threadIdx.x; e < (t.end - t.row0) * (BP / 8);
       e += blockDim.x) {
    const int q = e / (BP / 8), p = p0 + 8 * (e % (BP / 8));
    const __nv_bfloat16* src = tile + q * kPitch + (p - p0);
    __nv_bfloat16* dst = c + (long long)(t.row0 + q) * ldc + p;
    if (vec && p + 8 <= n) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && p + j < n; ++j) dst[j] = src[j];
    }
  }
}

template <int NWG, int BQ, int STAGES, bool X_MN>
cudaError_t launch_wgmma(const CUtensorMap& tw, const CUtensorMap& tx,
                         void* c, const int* meta, int n_mt, int n_groups,
                         int m, int n, int ksteps, int bm, int band,
                         long long ldc, cudaStream_t stream) {
  using S = HgStage<NWG, BQ, X_MN, false>;
  constexpr int kSmem = STAGES * S::kBytes + 2 * STAGES * 8 + 1024;
  auto kernel = grouped_gemm_wgmma_kernel<NWG, BQ, STAGES, X_MN>;
  static unsigned long long raised = 0;  // per instantiation, a bit a device
  cudaError_t err = hg_raise_smem(kernel, kSmem, raised);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)n_mt * ((n + S::kBP - 1) / S::kBP);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(NWG * 128 + 32);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tw, tx,
                           static_cast<__nv_bfloat16*>(c), meta, n_mt,
                           n_groups, m, n, ksteps, bm, band, ldc);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The plans k4_plan (repro_torch/kernels/grouped_gemm.py) can name, as
// (BQ, NWG, stages), one for each wgmma width; any other is refused.
// trans_b: dX's K-major weights.
cudaError_t dispatch_wgmma(const CUtensorMap& tw, const CUtensorMap& tx,
                           void* c, const int* meta, int n_mt, int n_groups,
                           int m, int n, int ksteps, int bm, int band,
                           long long ldc, int trans_b, int bq, int nwg,
                           int stages, cudaStream_t s) {
#define K4_PLAN(BQ, NWG, ST)                                                  \
  if (bq == BQ && nwg == NWG && stages == ST)                                 \
    return trans_b ? launch_wgmma<NWG, BQ, ST, false>(                        \
                         tw, tx, c, meta, n_mt, n_groups, m, n, ksteps, bm,   \
                         band, ldc, s)                                        \
                   : launch_wgmma<NWG, BQ, ST, true>(                         \
                         tw, tx, c, meta, n_mt, n_groups, m, n, ksteps, bm,   \
                         band, ldc, s);
  K4_PLAN(8, 1, 8)
  K4_PLAN(16, 1, 8)
  K4_PLAN(32, 1, 8)
  K4_PLAN(64, 4, 5)
  K4_PLAN(128, 2, 4)
#undef K4_PLAN
  return cudaErrorInvalidValue;
}

// Block height: the smallest of K1's tile heights that holds `bm` rows.
int block_height(int bm) {
  return bm <= 16 ? 16 : bm <= 32 ? 32 : bm <= 64 ? 64 : bm <= 128 ? 128 : 0;
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
// The CUDA-core body: dtype 0 = float32, 1 = bfloat16 (rows not 16-byte
// aligned).  Returns the launch's cudaError_t.
extern "C" int grouped_gemm(const void* x, const void* w, void* c,
                            const void* meta, int n_mt, int n_groups, int m,
                            int n, int k, int bm, long long ldx, long long ldc,
                            int trans_b, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mt = static_cast<const int*>(meta);
  if (dtype == 0)
    return dispatch<float>(x, w, c, mt, n_mt, n_groups, m, n, k, bm, ldx, ldc,
                           trans_b, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, c, mt, n_mt, n_groups, m, n, k, bm,
                                   ldx, ldc, trans_b, s);
  return cudaErrorInvalidValue;
}

// The wgmma body for bf16 with 16-byte aligned rows (checked by the
// caller), arguments as above, following a plan of k4_plan: bq rows of a
// row tile (>= bm), nwg consumer warpgroups (64 nwg weight columns a CTA),
// stages, and band row tiles side by side.  Any plan that was not
// instantiated returns cudaErrorInvalidValue.
extern "C" int grouped_gemm_wgmma(const void* x, const void* w, void* c,
                                  const void* meta, int n_mt, int n_groups,
                                  int m, int n, int k, int bm, long long ldx,
                                  long long ldc, int trans_b, int bq, int nwg,
                                  int stages, int band, void* stream) {
  const int ksteps = (k + kHgBK - 1) / kHgBK;
  if (m <= 0 || n <= 0 || ksteps <= 0 || n_mt <= 0 || n_groups <= 0 ||
      bm <= 0 || bm > bq || band <= 0 || (long long)n_mt * bm < m)
    return cudaErrorInvalidValue;
  CUtensorMap tw, tx;
  // Y: bq rows of x from the tile's first row, 64 of K a box.
  cudaError_t err = tensor_map(&tx, x, k, m, ldx, bq);
  // X: the weight stack, (G, k, n) N-major, or (G, n, k) K-major for dX.
  if (err == cudaSuccess)
    err = trans_b ? tensor_map_3d(&tw, w, k, n, n_groups, 64 * nwg)
                  : tensor_map_3d(&tw, w, n, k, n_groups, 64);
  if (err != cudaSuccess) return err;
  return dispatch_wgmma(tw, tx, c, static_cast<const int*>(meta), n_mt,
                        n_groups, m, n, ksteps, bm, band, ldc, trans_b, bq,
                        nwg, stages, static_cast<cudaStream_t>(stream));
}

extern "C" const char* grouped_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
