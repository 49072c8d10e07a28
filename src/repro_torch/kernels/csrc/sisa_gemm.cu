// K1: SISA-scheduled GEMM, C[M,N] = A[M,K] @ B[K,N], for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel repro/kernels/sisa_gemm.py::_gemm_kernel
// (launched by sisa_gemm).  Same contract: output-stationary, an f32
// accumulator per output held for the whole K sweep, C written once in A's
// dtype, inputs bf16 or f32.
//
// SISA's three execution modes come from the tile height bm of
// choose_block_config (repro_torch/kernels/sisa_gemm.py): a skinny slab
// (bm 16, every decode rung up to 16), fused slabs (bm 32 / 64) and the
// monolithic 128-row tile.  The ragged M > 128 residual pass is a second
// launch on the tail rows (repro_torch/kernels/ops.py), writing its own rows
// of the same C through ldc.  How each mode is laid out on the card is the
// launch plan's (k1_plan, beside choose_block_config): this file only
// instantiates the plans it names and refuses any other.
//
// What bounds it on an H100, and what the design does about it:
// * Decode slabs (M <= 16) read every weight once for a handful of rows:
//   bound by device-memory bytes (K*N elements), so what matters is the
//   bytes in flight.  The slab runs swap-AB: 64 weight columns form wgmma's
//   64-row side and the 1-16 tokens its n8 / n16 side, so no instruction
//   multiplies rows of zeros, and each CTA keeps 8 stages of 8 KB weight
//   tiles in flight through TMA.  Where N / 64 tiles leave SMs idle and K
//   is deep, a thread-block cluster of s = 2, 4 or 8 CTAs splits K and
//   reduces through distributed shared memory.
// * Prefill passes (M in the tens to hundreds) are too small to fill 132
//   SMs with 128 x 128 tiles: the plan takes the least K split, then the
//   widest tile, that puts half a wave of CTAs on the card.  Each such GEMM
//   lasts a few microseconds, so launch latency counts: every launch is a
//   programmatic dependent launch, whose barrier setup and tensor-map
//   prefetch overlap the previous kernel's tail.
// * Training (M 2048) is bound by operations: 128 x 256 or 128 x 128 tiles,
//   two consumer warpgroups issuing wgmma m64nNk16 from 128-byte swizzled
//   shared memory fed by a producer warp's TMA loads (hopper_gemm.cuh),
//   which spend no registers or instructions of the consumers.
// Operands are read in place: A K-major or, for dB = A^T dC, M-major; B
// N-major (row-major weights) or K-major (the tied LM head's table.T and
// dA = dC B^T) through wgmma's transpose bits.  Ragged M, N and K edges
// arrive as TMA's zero fill and the epilogue masks its stores.
//
// float32 (exact, no TF32), and bf16 rows that are not 16-byte aligned, run
// a plain shared-memory tiled kernel on the CUDA cores (each thread a TM x
// TN register tile) at the same tile heights.
//
// K3, the split-K variant (repro/kernels/sisa_gemm.py::_splitk_kernel,
// launched by sisa_gemm_splitk), runs on the same wgmma body for bf16 with
// slabs a whole number of 64-deep stages: the n_k = ceil(K / bk) slabs are
// dealt to a cluster of s = min(n_k, 8) CTAs as runs of whole slabs, rank r
// summing slabs [r n_k / s, (r + 1) n_k / s), and the cluster adds the
// ranks' f32 tiles in rank order through distributed shared memory before C
// is stored in A's dtype: one launch a call, no (n_k, M, N) partials and no
// summation kernel after it.  A decode GEMV is bound by its weight bytes, as
// K1's slab is; the slab runs multiply the CTAs that stream them.  float32,
// and bf16 shapes TMA cannot read, write f32 partials per slab on the CUDA
// cores (tile_gemm.cuh's fp_tile) and the wrapper sums them.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

#include "gemm_tiles.cuh"
#include "hopper_gemm.cuh"
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
// bf16 tensor-core body: TMA + wgmma, warp-specialised (hopper_gemm.cuh).
// ---------------------------------------------------------------------------
// The CTA computes D[BP x BQ] = X * Y over its K slice, then writes D to C:
// * normal: X = A (rows p of C), Y = B (columns q of C);
// * swap-AB (decode slabs): X = B^T (64 weight columns as wgmma's 64 rows),
//   Y = A^T (the 8 or 16 tokens as its n8 / n16 side); D is C^T.
// Grid (s, P tiles, Q tiles) with clusters of s CTAs along x.  With s > 1
// the cluster's CTAs split K (K1: the steps evenly; K3: runs of whole
// slabs of slab_steps steps), park their f32 tiles in shared memory, and
// rank r sums rows [r BP/s, (r+1) BP/s) of the tile over ranks 0..s-1 in
// order through distributed shared memory, then stores them: one launch,
// no workspace, no atomics, a fixed summation order.
template <int NWG, int BQ, int STAGES, bool X_MN, bool Y_MN, bool SWAP>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    sisa_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap ty,
                           __nv_bfloat16* __restrict__ c, int p_total,
                           int q_total, int ksteps, int slab_steps,
                           int n_slabs, long long ldc) {
  using S = HgStage<NWG, BQ, X_MN, Y_MN>;
  constexpr int BP = S::kBP;
  constexpr int kConsumers = NWG * 128;
  extern __shared__ uint4 smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_raw) +
                  ((1024 - (hg_smem(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * S::kBytes);
  uint64_t* empty = full + STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int s = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int p0 = blockIdx.y * BP, q0 = blockIdx.z * BQ;
  // Rank r's run of whole slabs (K1: slabs of one step, n_slabs = ksteps,
  // so the steps split evenly).
  const int kb = static_cast<int>((long long)rank * n_slabs / s) * slab_steps;
  const int ke = min(
      static_cast<int>((long long)(rank + 1) * n_slabs / s) * slab_steps,
      ksteps);
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // Launched with programmatic stream serialization: everything above ran
  // while the previous kernel on the stream finished; nothing below reads
  // or writes global memory before that kernel is complete.
  grid_dependency_wait();

  float acc[BQ / 2];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) acc[i] = 0.f;
  if (warp == NWG * 4) {
    if (threadIdx.x % 32 == 0)
      hg_produce<NWG, BQ, STAGES, X_MN, Y_MN>(ring, full, empty, &tx, &ty, p0,
                                              q0, kb, ke);
  } else {
    hg_consume<NWG, BQ, STAGES, X_MN, Y_MN>(ring, full, empty, warp / 4,
                                            ke - kb, acc);
  }

  // The next kernel on the stream may start its prologue now.
  launch_dependents();

  // D element (p, q) of the tile is C[p][q], or C[q][p] when swapped.
  auto put = [&](int p, int q, float v) {
    if (p < p_total && q < q_total)
      c[SWAP ? (long long)q * ldc + p : (long long)p * ldc + q] =
          __float2bfloat16(v);
  };
  // This thread's fragment rows (r, r + 8) and first column (hopper_gemm.cuh).
  const int t = threadIdx.x % 128;
  const int r0 = (warp / 4) * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int c0 = 2 * (t % 4);

  if (s == 1) {
    if (warp >= NWG * 4) return;
    const bool vec = !SWAP && ldc % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(c) % 4 == 0;
#pragma unroll
    for (int cc = 0; cc < BQ / 8; ++cc)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + r0 + 8 * h, q = q0 + 8 * cc + c0;
        const float v0 = acc[4 * cc + 2 * h], v1 = acc[4 * cc + 2 * h + 1];
        if (vec && p < p_total && q + 1 < q_total) {
          *reinterpret_cast<__nv_bfloat162*>(c + (long long)p * ldc + q) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          put(p, q, v0);
          put(p, q + 1, v1);
        }
      }
    return;
  }

  // Split-K: the ring becomes the f32 tile red[BP][RS] once every
  // warpgroup's wgmmas have drained.  The row pitch RS = BQ + 8 keeps a
  // half-warp's float2 stores on 32 distinct banks.
  constexpr int RS = BQ + 8;
  static_assert(BP * RS * 4 <= STAGES * S::kBytes, "split-K tile");
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  if (warp < NWG * 4) {
#pragma unroll
    for (int cc = 0; cc < BQ / 8; ++cc)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(red + (r0 + 8 * h) * RS + 8 * cc + c0) =
            make_float2(acc[4 * cc + 2 * h], acc[4 * cc + 2 * h + 1]);
  }
  cluster.sync();
  // Four neighbouring columns q of one row p a step; the s ranks' values
  // are all loaded before they are added, in rank order.
  const float4* src[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    src[r] = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(red, r < s ? r : 0));
  const int p_lo = rank * BP / s, rows = (rank + 1) * BP / s - p_lo;
  for (int e = threadIdx.x; e < rows * (BQ / 4); e += kConsumers + 32) {
    // Neighbouring threads on neighbouring addresses of C.
    const int pr = SWAP ? e % rows : e / (BQ / 4);
    const int q = 4 * (SWAP ? e / rows : e % (BQ / 4));
    const int p = p_lo + pr;
    float4 v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < s) v[r] = src[r][(p * RS + q) / 4];
    float4 sum = v[0];
#pragma unroll
    for (int r = 1; r < 8; ++r)
      if (r < s) {
        sum.x += v[r].x;
        sum.y += v[r].y;
        sum.z += v[r].z;
        sum.w += v[r].w;
      }
    put(p0 + p, q0 + q, sum.x);
    put(p0 + p, q0 + q + 1, sum.y);
    put(p0 + p, q0 + q + 2, sum.z);
    put(p0 + p, q0 + q + 3, sum.w);
  }
  cluster.sync();  // no CTA leaves while another reads its tile
}

template <int NWG, int BQ, int STAGES, bool X_MN, bool Y_MN, bool SWAP>
cudaError_t launch_wgmma(const CUtensorMap& tx, const CUtensorMap& ty,
                         void* c, int p_total, int q_total, int ksteps,
                         int slab_steps, int n_slabs, long long ldc,
                         int cluster, cudaStream_t stream) {
  using S = HgStage<NWG, BQ, X_MN, Y_MN>;
  constexpr int kSmem = STAGES * S::kBytes + 2 * STAGES * 8 + 1024;
  auto kernel = sisa_gemm_wgmma_kernel<NWG, BQ, STAGES, X_MN, Y_MN, SWAP>;
  static unsigned long long raised = 0;  // per instantiation, a bit a device
  cudaError_t err = hg_raise_smem(kernel, kSmem, raised);
  if (err != cudaSuccess) return err;
  const long long ptiles = (p_total + S::kBP - 1) / S::kBP;
  const long long qtiles = (q_total + BQ - 1) / BQ;
  if (ptiles > 65535 || qtiles > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (unsigned)ptiles, (unsigned)qtiles);
  cfg.blockDim = dim3(NWG * 128 + 32);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 2 : 1;  // s = 1: no cluster
  err = cudaLaunchKernelEx(&cfg, kernel, tx, ty,
                           static_cast<__nv_bfloat16*>(c), p_total, q_total,
                           ksteps, slab_steps, n_slabs, ldc);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The plans K1's and K3's launch plans (repro_torch/kernels/sisa_gemm.py::
// k1_plan, k3_plan) can name; any other is refused.  Normal tiles: (bm, bn,
// stages) with bm / 64 consumer warpgroups; swap-AB: 64 weight columns by
// bm = 8 or 16 tokens, 8 stages.  A cluster rank sums the steps of slabs
// [r n_slabs / s, (r + 1) n_slabs / s), slab_steps steps a slab.
cudaError_t dispatch_wgmma(const CUtensorMap& tx, const CUtensorMap& ty,
                           void* c, int m, int n, int ksteps, int slab_steps,
                           int n_slabs, long long ldc, int a_mn, int b_kmajor,
                           int swap_ab, int bm, int bn, int stages,
                           int cluster, cudaStream_t s) {
#define K1_NORMAL(BM, BN, ST)                                                 \
  if (bm == BM && bn == BN && stages == ST) {                                 \
    if (a_mn)                                                                 \
      return launch_wgmma<BM / 64, BN, ST, true, true, false>(                \
          tx, ty, c, m, n, ksteps, slab_steps, n_slabs, ldc, cluster, s);     \
    if (b_kmajor)                                                             \
      return launch_wgmma<BM / 64, BN, ST, false, false, false>(              \
          tx, ty, c, m, n, ksteps, slab_steps, n_slabs, ldc, cluster, s);     \
    return launch_wgmma<BM / 64, BN, ST, false, true, false>(                 \
        tx, ty, c, m, n, ksteps, slab_steps, n_slabs, ldc, cluster, s);       \
  }
#define K1_SWAP(BM, ST)                                                       \
  if (bm == BM && bn == 64 && stages == ST) {                                 \
    if (b_kmajor)                                                             \
      return launch_wgmma<1, BM, ST, false, false, true>(                     \
          tx, ty, c, n, m, ksteps, slab_steps, n_slabs, ldc, cluster, s);     \
    return launch_wgmma<1, BM, ST, true, false, true>(                        \
        tx, ty, c, n, m, ksteps, slab_steps, n_slabs, ldc, cluster, s);       \
  }
  if (swap_ab) {
    K1_SWAP(8, 8)
    K1_SWAP(16, 8)
  } else {
    K1_NORMAL(128, 256, 4)
    K1_NORMAL(128, 128, 4)
    K1_NORMAL(128, 64, 4)
    K1_NORMAL(64, 64, 6)
  }
#undef K1_NORMAL
#undef K1_SWAP
  return cudaErrorInvalidValue;
}

// Tensor maps of a planned wgmma launch, then the launch: A K-major (row
// stride lda) or, with a_mn, M-major; B N-major (row stride ldb) or, with
// b_kmajor, K-major.
cudaError_t run_wgmma(const void* a, const void* b, void* c, int m, int n,
                      int k, long long lda, long long ldb, long long ldc,
                      int a_mn, int b_kmajor, int swap_ab, int bm, int bn,
                      int stages, int cluster, int slab_steps, int n_slabs,
                      cudaStream_t stream) {
  const int ksteps = (k + kHgBK - 1) / kHgBK;
  CUtensorMap tx, ty;
  cudaError_t err;
  if (swap_ab) {  // X = B^T (64-row boxes of weight columns), Y = A^T
    err = b_kmajor ? tensor_map(&tx, b, k, n, ldb, 64)
                   : tensor_map(&tx, b, n, k, ldb, 64);
    if (err == cudaSuccess) err = tensor_map(&ty, a, k, m, lda, bm);
  } else {  // X = A, Y = B
    err = a_mn ? tensor_map(&tx, a, m, k, lda, 64)
               : tensor_map(&tx, a, k, m, lda, bm);
    if (err == cudaSuccess)
      err = b_kmajor ? tensor_map(&ty, b, k, n, ldb, bn)
                     : tensor_map(&ty, b, n, k, ldb, 64);
  }
  if (err != cudaSuccess) return err;
  return dispatch_wgmma(tx, ty, c, m, n, ksteps, slab_steps, n_slabs, ldc,
                        a_mn, b_kmajor, swap_ab, bm, bn, stages, cluster,
                        stream);
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
// K3's CUDA-core route: split-K partials.  Block (column tile, row tile,
// slab kk) computes A[rows, kk*bk : kk*bk + bk] @ B[kk*bk : kk*bk + bk, cols]
// into part[kk] (f32, M x N); the slab's K tail, ragged rows and ragged
// columns are zero-filled.
// ---------------------------------------------------------------------------
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
                          int dtype, cudaStream_t s) {
  const dim3 grid((n + kTileN - 1) / kTileN, (m + BM - 1) / BM,
                  (k + bk - 1) / bk);
  if (dtype == 1)
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

// The CUDA-core body: dtype 0 = float32, 1 = bfloat16 (rows not 16-byte
// aligned); bm: the tile height from choose_block_config.  Returns the
// launch's cudaError_t.
extern "C" int sisa_gemm(const void* a, const void* b, void* c, int m, int n,
                         int k, long long lda, long long sbk, long long sbn,
                         long long ldc, int trans_b, int dtype, int bm,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(bm, a, b, c, m, n, k, lda, sbk, sbn, ldc, trans_b, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(bm, a, b, c, m, n, k, lda, sbk, sbn, ldc,
                                   trans_b, s);
  return cudaErrorInvalidValue;
}

// The wgmma body for bf16 C[m, n] = A[m, k] @ B[k, n] with 16-byte aligned
// rows (checked by the caller), following a plan of k1_plan or k3_plan: A is
// K-major (row stride lda) or, with a_mn, M-major (A^T stored row-major,
// column stride lda); B is N-major (row stride ldb) or, with b_kmajor,
// K-major (B^T stored row-major, as the LM head's table.T).  C is row-major
// with row stride ldc.  A cluster of 1-8 CTAs deals K's slabs of slab_steps
// 64-deep steps as runs of whole slabs (K1: one-step slabs, its even split;
// K3: its bk / 64), at most one rank a slab, and sums the ranks in rank
// order.  Any plan that was not instantiated returns cudaErrorInvalidValue.
extern "C" int sisa_gemm_wgmma(const void* a, const void* b, void* c, int m,
                               int n, int k, long long lda, long long ldb,
                               long long ldc, int a_mn, int b_kmajor,
                               int swap_ab, int bm, int bn, int stages,
                               int cluster, int slab_steps, void* stream) {
  const int ksteps = (k + kHgBK - 1) / kHgBK;
  if (m <= 0 || n <= 0 || ksteps <= 0 || slab_steps <= 0 ||
      (a_mn && (swap_ab || b_kmajor)))
    return cudaErrorInvalidValue;
  const int n_slabs = (ksteps + slab_steps - 1) / slab_steps;
  if (cluster < 1 || cluster > 8 || cluster > n_slabs)
    return cudaErrorInvalidValue;
  return run_wgmma(a, b, c, m, n, k, lda, ldb, ldc, a_mn, b_kmajor, swap_ab,
                   bm, bn, stages, cluster, slab_steps, n_slabs,
                   static_cast<cudaStream_t>(stream));
}

// K3's CUDA-core route: part (n_k, m, n) f32 partials of a (m, k) @ b (k,
// n), slabs of bk columns of K, n_k = ceil(k / bk); a and b row-major with
// row strides lda and ldb; dtype 0 = float32, 1 = bfloat16; bm: 16, 32, 64
// or 128.
extern "C" int sisa_gemm_splitk(const void* a, const void* b, void* part,
                                int m, int n, int k, int bk, long long lda,
                                long long ldb, int dtype, int bm,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if ((dtype != 0 && dtype != 1) || bk <= 0) return cudaErrorInvalidValue;
  switch (bm) {
    case 16:
      return splitk_launch<16>(a, b, p, m, n, k, bk, lda, ldb, dtype, s);
    case 32:
      return splitk_launch<32>(a, b, p, m, n, k, bk, lda, ldb, dtype, s);
    case 64:
      return splitk_launch<64>(a, b, p, m, n, k, bk, lda, ldb, dtype, s);
    case 128:
      return splitk_launch<128>(a, b, p, m, n, k, bk, lda, ldb, dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* sisa_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
