// K5: segment-sum weight gradient of the flat grouped GEMM, for Hopper
// (sm_90a):  dw[g] = sum over the rows r owned by group g of
// x[r]^T (d) outer dy[r] (f),  dw (G, d, f) in x's dtype, f32 accumulation.
//
// Replaces the JAX package's TPU kernel
// repro/kernels/grouped_gemm.py::_flat_dw_kernel (launched by _flat_dw, the
// dW half of segment_grouped_gemm's custom VJP).  Same contract: the flat
// buffer is cut into row tiles of `bm` rows and the (2, n_tiles) int32 table
// [gid; hi] of K4's forward (saved, not rebuilt) gives each tile its group
// and the end of its segment's valid rows.  Rows at or past their tile's
// `hi` contribute nothing (the TPU kernel masks X), segments that share a
// gid (the all-to-all layout of a2a_segments) are summed, and a group with
// no rows gets an exact-zero block.
//
// The TPU kernel carries its accumulator across the sequential row-tile
// grid axis, from a gid run's first tile to its last.  CTAs here run in
// no order, so each CTA owns one (d tile, f tile, group) output tile and
// loops over that group's rows itself, with the f32 accumulator in
// registers: no atomics and no split over rows, so the result is
// deterministic.  gids are non-decreasing over the tiles, so a group's
// tiles are one run [bounds[g], bounds[g+1]) found on the device
// (searchsorted in repro_torch/kernels/grouped_gemm.py); its rows end at
// the last tile's `hi`, so a group's unused capacity is not swept.
//
// What bounds it on an H100: with MoE training's few hundred rows an
// expert, writing dw (G * d * f elements, 839 MB a phi3.5-moe projection)
// costs about as much as the arithmetic (2 * rows * d * f): bytes and
// operations alike.  The bf16 body (16-byte aligned rows, d and f
// multiples of 8) is the TMA + wgmma pipeline of hopper_gemm.cuh: K1's dB
// = A^T dC pass with K running over one group's rows, both operands
// MN-major (x^T read in place from (rows, d), dy as stored), 128 x BQ
// output tiles of two consumer warpgroups.  A training step's K is only
// about 5 steps of 64 rows, so a CTA that fills its pipeline, computes one
// tile and stores it would spend much of its time filling and storing:
// the body is persistent instead, one CTA an SM walking the tiles in
// group-major order (a group's rows of x and dy stay in L2 while the card
// computes all its tiles) through one ring, so the next tile's loads run
// while a tile is rounded to bf16 into shared memory in TMA's swizzled
// layout, and its TMA store drains while the next tile is computed.  TMA
// brings in whatever the flat buffer holds at rows that are not the
// group's (the next segment's rows, NaN in a gap), so the consumers zero
// those rows of the x tile before the wgmma reads them, then fence the
// async proxy.
//
// float32, and bf16 rows that are not 16-byte aligned: a shared-memory
// tiled kernel on the CUDA cores, so f32 stays exact f32 (no TF32).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

#include "gemm_tiles.cuh"
#include "hopper_gemm.cuh"

// Rows [r0, r1) of group g: its tiles [bounds[g], bounds[g + 1]), cut at
// the last tile's `hi` (rows of a tile at or past its own `hi` are masked
// one by one).
struct GroupRows {
  int r0, r1;
};

__device__ __forceinline__ GroupRows group_rows(const int* __restrict__ hi,
                                                const int* __restrict__ bounds,
                                                int g, int m, int bm) {
  const int t0 = bounds[g], t1 = bounds[g + 1];
  GroupRows gr;
  gr.r0 = t0 * bm;
  gr.r1 = t1 > t0 ? max(gr.r0, min(m, hi[t1 - 1])) : gr.r0;
  return gr;
}

__device__ __forceinline__ bool row_live(const int* __restrict__ hi, int r,
                                         int r1, int bm) {
  return r < r1 && r < hi[r / bm];
}

// CUDA-core body: BD x BF output tile, each thread a TM x TN register tile.
template <typename T, int BD, int BF, int BK, int TM, int TN>
__global__ void __launch_bounds__((BD / TM) * (BF / TN))
    grouped_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      T* __restrict__ dw, const int* __restrict__ hi,
                      const int* __restrict__ bounds, int m, int d, int f,
                      int bm, long long ldx, long long ldy) {
  constexpr int RT = BD / TM;  // thread rows (d)
  constexpr int CT = BF / TN;  // thread columns (f)
  constexpr int NT = RT * CT;
  __shared__ float xs[BK][BD + 1];
  __shared__ float ys[BK][BF + 1];

  const GroupRows rows = group_rows(hi, bounds, blockIdx.z, m, bm);
  const int d0 = blockIdx.y * BD, f0 = blockIdx.x * BF;
  const int tid = threadIdx.x;
  const int tx = tid % CT;
  const int ty = tid / CT;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int rb = rows.r0; rb < rows.r1; rb += BK) {
    // Neighbouring threads read neighbouring columns of one row.
    for (int e = tid; e < BK * BD; e += NT) {
      const int r = e / BD, c = e % BD;
      const int gr = rb + r, gd = d0 + c;
      xs[r][c] = (gd < d && row_live(hi, gr, rows.r1, bm))
                     ? to_f32(x[(long long)gr * ldx + gd]) : 0.f;
    }
    for (int e = tid; e < BK * BF; e += NT) {
      const int r = e / BF, c = e % BF;
      const int gr = rb + r, gf = f0 + c;
      ys[r][c] = (gf < f && row_live(hi, gr, rows.r1, bm))
                     ? to_f32(dy[(long long)gr * ldy + gf]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xv[TM], yv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = xs[kk][ty + i * RT];
#pragma unroll
      for (int j = 0; j < TN; ++j) yv[j] = ys[kk][tx + j * CT];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* __restrict__ out = dw + (long long)blockIdx.z * d * f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gd = d0 + ty + i * RT;
    if (gd >= d) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gf = f0 + tx + j * CT;
      if (gf < f) out[(long long)gd * f + gf] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, void* dw, const int* hi,
                   const int* bounds, int n_groups, int m, int d, int f,
                   int bm, long long ldx, long long ldy, cudaStream_t stream) {
  constexpr int BD = 64, BF = 64, BK = 16, TM = 4, TN = 4;
  const dim3 grid((f + BF - 1) / BF, (d + BD - 1) / BD, n_groups);
  grouped_dw_kernel<T, BD, BF, BK, TM, TN>
      <<<grid, (BD / TM) * (BF / TN), 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy),
          static_cast<T*>(dw), hi, bounds, m, d, f, bm, ldx, ldy);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body: TMA + wgmma, warp-specialised (hopper_gemm.cuh).
// ---------------------------------------------------------------------------
// Persistent: the CTAs, one an SM, walk the output tiles in
// group-major order (a group's tiles together, so its rows of x and dy stay
// in L2 while the CTAs on the card compute them).  Tile (group g, d tile
// p0, f tile q0) is D[BP x BQ] = x^T * dy over the group's rows [r0, r1)
// in steps of 64 rows: X = x^T (BP = 64 NWG columns of x by 64 rows,
// MN-major: x is stored (rows, d)), Y = dy (64 rows by BQ columns,
// MN-major).  The tiles' steps follow one another through one ring, so the
// producer loads tile i + 1 while the consumers round and store tile i,
// and tile i's TMA store drains while tile i + 1 is computed.
// A step's rows that are not the group's live rows -- past r1 (the next
// group's), or at or past their tile's `hi` (a segment's tail, a gap
// between segments that share the gid) -- are zeroed in the x tile before
// any wgmma reads it, as the TPU kernel masks X; the producer and the
// consumers run the same steps.
template <int NWG, int BQ, int STAGES>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    grouped_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                            const __grid_constant__ CUtensorMap ty,
                            const __grid_constant__ CUtensorMap tdw,
                            const int* __restrict__ hi,
                            const int* __restrict__ bounds, int m, int d,
                            int f, int bm, int n_groups) {
  using S = HgStage<NWG, BQ, true, true>;
  constexpr int BP = S::kBP;
  static_assert(NWG <= 2, "one named barrier a consumer warpgroup");
  extern __shared__ uint4 smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_raw) +
                  ((1024 - (hg_smem(smem_raw) & 1023)) & 1023);
  // The bf16 dW tile: BQ / 64 swizzled (BP x 64) boxes, TMA's layout.
  uint8_t* out = ring + STAGES * S::kBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + BP * BQ * 2);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // Launched with programmatic stream serialization: the group bounds are
  // written by the kernel just before, so they are read only after this.
  grid_dependency_wait();

  const int p_tiles = (d + BP - 1) / BP, q_tiles = (f + BQ - 1) / BQ;
  const int per_group = p_tiles * q_tiles;
  const int n_tiles = n_groups * per_group;
  struct Tile {
    int g, p0, q0;
    GroupRows rows;
    int n_k;
  };
  auto tile_at = [&](int t) {
    Tile u;
    u.g = t / per_group;
    u.p0 = (t % per_group % p_tiles) * BP;
    u.q0 = (t % per_group / p_tiles) * BQ;
    u.rows = group_rows(hi, bounds, u.g, m, bm);
    u.n_k = (u.rows.r1 - u.rows.r0 + kHgBK - 1) / kHgBK;
    return u;
  };
  const int warp = threadIdx.x / 32;
  if (warp == NWG * 4) {
    if (threadIdx.x % 32 == 0) {
      tma_prefetch_map(&tx);
      tma_prefetch_map(&ty);
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile u = tile_at(t);
        hg_produce_at<NWG, BQ, STAGES, true, true, false>(
            ring, full, empty, &tx, &ty, u.p0, u.q0, u.rows.r0, u.n_k, 0, it);
        it += u.n_k;
      }
    }
  } else {
    const int g = warp / 4, tt = threadIdx.x % 128;
    const int r = g * 64 + (tt / 32) * 16 + (tt % 32) / 4;  // fragment row
    const int c0 = 2 * (tt % 4);
    const bool storer = threadIdx.x == 0;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile u = tile_at(t);
      // Each warpgroup masks its own X chunk: 64 rows of 128 bytes (an
      // MN-major tile keeps one row in one 128-byte swizzle row), two
      // threads a row.
      auto mask = [&](int i, uint8_t* xs) {
        const int row = u.rows.r0 + i * kHgBK + tt / 2;
        if (!row_live(hi, row, u.rows.r1, bm)) {
          uint4* z = reinterpret_cast<uint4*>(xs + (tt / 2) * 128 +
                                              (tt % 2) * 64);
          z[0] = z[1] = z[2] = z[3] = make_uint4(0, 0, 0, 0);
          fence_proxy_async();
        }
        if (g == 0) named_bar_sync<1, 128>();
        else named_bar_sync<2, 128>();
      };
      float acc[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) acc[i] = 0.f;
      hg_consume_prep<NWG, BQ, STAGES, true, true>(ring, full, empty, g, it,
                                                    u.n_k, acc, mask);
      it += u.n_k;
      // The previous tile's store has read the staging tile before it is
      // written again.
      if (storer) tma_store_wait_read();
      named_bar_sync<3, NWG * 128>();
#pragma unroll
      for (int cc = 0; cc < BQ / 8; ++cc)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = r + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(
              out + (cc / 8) * (BP * 128) + p * 128 +
              (((cc % 8) ^ (p % 8)) * 16) + c0 * 2) =
              __floats2bfloat162_rn(acc[4 * cc + 2 * h],
                                    acc[4 * cc + 2 * h + 1]);
        }
      fence_proxy_async();
      named_bar_sync<3, NWG * 128>();
      if (storer) {
#pragma unroll
        for (int j = 0; j < BQ / 64; ++j)
          tma_store_3d(&tdw, out + j * (BP * 128), u.q0 + 64 * j, u.p0, u.g);
        tma_store_commit();
      }
    }
    if (storer) tma_store_wait_read();
  }
  launch_dependents();
}

template <int NWG, int BQ, int STAGES>
cudaError_t launch_wgmma(const CUtensorMap& tx, const CUtensorMap& ty,
                         const CUtensorMap& tdw, const int* hi,
                         const int* bounds, int n_groups, int m, int d, int f,
                         int bm, cudaStream_t stream) {
  using S = HgStage<NWG, BQ, true, true>;
  constexpr int kSmem =
      STAGES * S::kBytes + S::kBP * BQ * 2 + 2 * STAGES * 8 + 1024;
  auto kernel = grouped_dw_wgmma_kernel<NWG, BQ, STAGES>;
  static unsigned long long raised = 0;  // per instantiation, a bit a device
  cudaError_t err = hg_raise_smem(kernel, kSmem, raised);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)n_groups * ((d + S::kBP - 1) / S::kBP) *
                          ((f + BQ - 1) / BQ);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  // One CTA an SM (the ring and the staging tile fill its shared memory).
  cfg.gridDim = dim3((unsigned)(tiles < sms ? tiles : sms));
  cfg.blockDim = dim3(NWG * 128 + 32);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tx, ty, tdw, hi, bounds, m, d, f,
                           bm, n_groups);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x (m, d) with row stride ldx; dy (m, f) with row stride ldy; dw
// (n_groups, d, f) contiguous; meta (2, n_mt) int32 [gid; hi] of the
// forward, n_mt = ceil(m / bm); bounds (n_groups + 1) int32, group g's row
// tiles are [bounds[g], bounds[g + 1]).  The CUDA-core body: dtype 0 =
// float32, 1 = bfloat16 (rows not 16-byte aligned).  Returns the launch's
// cudaError_t.
extern "C" int grouped_dw(const void* x, const void* dy, void* dw,
                          const void* meta, const void* bounds, int n_mt,
                          int n_groups, int m, int d, int f, int bm,
                          long long ldx, long long ldy, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* hi = static_cast<const int*>(meta) + n_mt;
  const int* bd = static_cast<const int*>(bounds);
  if (dtype == 0)
    return launch<float>(x, dy, dw, hi, bd, n_groups, m, d, f, bm, ldx, ldy,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dy, dw, hi, bd, n_groups, m, d, f, bm,
                                 ldx, ldy, s);
  return cudaErrorInvalidValue;
}

// The wgmma body for bf16 with 16-byte aligned rows and d, f multiples of 8
// (checked by the caller), arguments as above, following a plan of
// k5_plan: bq columns of f and nwg consumer warpgroups (64 nwg columns of
// d) a tile, and stages.  Any plan that was not instantiated returns
// cudaErrorInvalidValue.
extern "C" int grouped_dw_wgmma(const void* x, const void* dy, void* dw,
                                const void* meta, const void* bounds,
                                int n_mt, int n_groups, int m, int d, int f,
                                int bm, long long ldx, long long ldy, int bq,
                                int nwg, int stages, void* stream) {
  if (m <= 0 || d <= 0 || f <= 0 || n_groups <= 0 || bm <= 0 ||
      (long long)n_mt * bm < m)
    return cudaErrorInvalidValue;
  CUtensorMap tx, ty, tdw;
  cudaError_t err = tensor_map(&tx, x, d, m, ldx, 64);
  if (err == cudaSuccess) err = tensor_map(&ty, dy, f, m, ldy, 64);
  if (err == cudaSuccess) err = tensor_map_3d(&tdw, dw, f, d, n_groups,
                                              64 * nwg);
  if (err != cudaSuccess) return err;
  const int* hi = static_cast<const int*>(meta) + n_mt;
  const int* bd = static_cast<const int*>(bounds);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5_PLAN(BQ, NWG, ST)                                                  \
  if (bq == BQ && nwg == NWG && stages == ST)                                 \
    return launch_wgmma<NWG, BQ, ST>(tx, ty, tdw, hi, bd, n_groups, m, d, f,  \
                                     bm, s);
  K5_PLAN(256, 2, 3)
#undef K5_PLAN
  return cudaErrorInvalidValue;
}

extern "C" const char* grouped_dw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
