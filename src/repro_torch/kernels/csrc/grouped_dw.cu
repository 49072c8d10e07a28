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
// `hi` contribute nothing (the TPU kernel masks X; here neither operand's
// row is read), segments that share a gid (the all-to-all layout of
// a2a_segments) are summed, and a group with no rows gets an exact-zero
// block.
//
// The TPU kernel carries its accumulator across the sequential row-tile
// grid axis, from a gid run's first tile to its last.  Blocks here run in
// no order, so each block owns one (d tile, f tile, group) output tile and
// loops over that group's rows itself, with the f32 accumulator in
// registers: no atomics and no split over rows, so the result is
// deterministic.  gids are non-decreasing over the tiles, so a group's
// tiles are one run [bounds[g], bounds[g+1]) found on the device
// (searchsorted in repro_torch/kernels/grouped_gemm.py); its rows end at
// the last tile's `hi`, so a group's unused capacity is not swept.
//
// What bounds it on an H100: with MoE training's few hundred rows per
// expert, writing dw (G * d * f elements) outweighs reading x and dy, and
// the arithmetic (2 * rows * d * f) is about as large: bound by bytes
// written and operations alike.  Two bodies:
//
// * bf16 with 16-byte aligned rows: tensor cores through mma.sync
//   m16n8k16 with an f32 accumulator, fed by a cp.async pipeline.  The A
//   operand is x^T: the x tile lands in shared memory as [rows][d] (d
//   contiguous, as x is stored) and ldmatrix.trans reads it column-major;
//   dy is the row-major B operand, read with ldmatrix.trans as in K4.
//   128 x 128 output tiles, 8 warps, 32 rows per pipeline stage.
// * f32, and bf16 rows that are not 16-byte aligned: a shared-memory tiled
//   kernel on the CUDA cores, so f32 stays exact f32 (no TF32).
//
// wgmma, TMA and a persistent schedule that reads each group's rows once
// for several output tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "gemm_tiles.cuh"

// Rows [r0, r1) of group g: its tiles [bounds[g], bounds[g + 1]), cut at
// the last tile's `hi` (rows of a tile at or past its own `hi` are masked
// one by one).
struct GroupRows {
  int r0, r1;
};

__device__ __forceinline__ GroupRows group_rows(const int* __restrict__ hi,
                                                const int* __restrict__ bounds,
                                                int m, int bm) {
  const int g = blockIdx.z;
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

  const GroupRows rows = group_rows(hi, bounds, m, bm);
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

// bf16 tensor-core body: warps laid out WM x WN over the BD x BF output
// tile; BK rows of x and dy per pipeline stage.
template <int BD, int BF, int BK, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM* WN * 32)
    grouped_dw_tc_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ dy,
                         __nv_bfloat16* __restrict__ dw,
                         const int* __restrict__ hi,
                         const int* __restrict__ bounds, int m, int d, int f,
                         int bm, long long ldx, long long ldy) {
  constexpr int NT = WM * WN * 32;
  constexpr int WTM = BD / WM, WTN = BF / WN;  // warp tile
  constexpr int FM = WTM / 16, FN = WTN / 8;   // mma fragments per warp
  constexpr int kA = BK * (BD + kPad);         // x tile, [BK][BD]
  constexpr int kStage = kA + BK * (BF + kPad);  // + dy tile, [BK][BF]
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && BK % 16 == 0, "tile");
  static_assert(BD % 8 == 0 && BF % 8 == 0, "16-byte chunks");

  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const GroupRows rows = group_rows(hi, bounds, m, bm);
  const int d0 = blockIdx.y * BD, f0 = blockIdx.x * BF;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int ktiles = (rows.r1 - rows.r0 + BK - 1) / BK;

  // Rows past the group's end or their tile's `hi` are zero-filled, never
  // read.
  auto load_tile = [&](int stage, int kt) {
    __nv_bfloat16* xs = smem + stage * kStage;
    __nv_bfloat16* ys = xs + kA;
    const int rb = rows.r0 + kt * BK;
    for (int e = tid; e < BK * (BD / 8); e += NT) {
      const int r = e / (BD / 8), dc = (e % (BD / 8)) * 8;
      const int gr = rb + r, gd = d0 + dc;
      const int nb =
          row_live(hi, gr, rows.r1, bm) ? 2 * max(0, min(8, d - gd)) : 0;
      cp_async16(xs + r * (BD + kPad) + dc,
                 nb ? x + (long long)gr * ldx + gd : x, nb);
    }
    for (int e = tid; e < BK * (BF / 8); e += NT) {
      const int r = e / (BF / 8), fc = (e % (BF / 8)) * 8;
      const int gr = rb + r, gf = f0 + fc;
      const int nb =
          row_live(hi, gr, rows.r1, bm) ? 2 * max(0, min(8, f - gf)) : 0;
      cp_async16(ys + r * (BF + kPad) + fc,
                 nb ? dy + (long long)gr * ldy + gf : dy, nb);
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

    const __nv_bfloat16* xs = smem + (kt % STAGES) * kStage;
    const __nv_bfloat16* ys = xs + kA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[FM][4], bf[FN][2];
      // A = x^T (d x rows): 8x8 tile q of the fragment covers d offset
      // 8 * (q % 2) and row offset 8 * (q / 2); its 8 row addresses come
      // from lanes 8q .. 8q + 7.
#pragma unroll
      for (int i = 0; i < FM; ++i)
        ldmatrix_x4_trans(af[i], xs + (kk + lane % 8 + (lane / 16) * 8) *
                                          (BD + kPad) +
                                      wm * WTM + i * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        ldmatrix_x2_trans(bf[j], ys + (kk + lane % 16) * (BF + kPad) +
                                     wn * WTN + j * 8);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // Fragment (i, j) element q sits at d row g (+8 for q >= 2), f column
  // 2 * (lane % 4) + (q % 2) of its 16 x 8 tile, g = lane / 4.
  __nv_bfloat16* __restrict__ out = dw + (long long)blockIdx.z * d * f;
  const int g = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gd = d0 + wm * WTM + i * 16 + g + h * 8;
        const int gf = f0 + wn * WTN + j * 8 + t2;
        if (gd >= d) continue;
        __nv_bfloat16* p = out + (long long)gd * f + gf;
        if (gf + 1 < f)  // f is a multiple of 8 here: 4-byte aligned pair
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        else if (gf < f)
          *p = __float2bfloat16(acc[i][j][2 * h]);
      }
}

cudaError_t launch_tc(const void* x, const void* dy, void* dw, const int* hi,
                      const int* bounds, int n_groups, int m, int d, int f,
                      int bm, long long ldx, long long ldy,
                      cudaStream_t stream) {
  constexpr int BD = 128, BF = 128, BK = 32, WM = 4, WN = 2, STAGES = 4;
  constexpr int kSmem =
      STAGES * BK * (BD + BF + 2 * kPad) * (int)sizeof(__nv_bfloat16);
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        grouped_dw_tc_kernel<BD, BF, BK, WM, WN, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const dim3 grid((f + BF - 1) / BF, (d + BD - 1) / BD, n_groups);
  grouped_dw_tc_kernel<BD, BF, BK, WM, WN, STAGES>
      <<<grid, WM * WN * 32, kSmem, stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(dy),
          static_cast<__nv_bfloat16*>(dw), hi, bounds, m, d, f, bm, ldx, ldy);
  return cudaGetLastError();
}

}  // namespace

// x (m, d) with row stride ldx; dy (m, f) with row stride ldy; dw
// (n_groups, d, f) contiguous; meta (2, n_mt) int32 [gid; hi] of the
// forward, n_mt = ceil(m / bm); bounds (n_groups + 1) int32, group g's row
// tiles are [bounds[g], bounds[g + 1]).  dtype: 0 = float32, 1 = bfloat16;
// tensor_cores: bf16 with 16-byte aligned rows and d, f multiples of 8
// (checked by the caller).  Returns the launch's cudaError_t.
extern "C" int grouped_dw(const void* x, const void* dy, void* dw,
                          const void* meta, const void* bounds, int n_mt,
                          int n_groups, int m, int d, int f, int bm,
                          long long ldx, long long ldy, int dtype,
                          int tensor_cores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* hi = static_cast<const int*>(meta) + n_mt;
  const int* bd = static_cast<const int*>(bounds);
  if (dtype == 0)
    return launch<float>(x, dy, dw, hi, bd, n_groups, m, d, f, bm, ldx, ldy,
                         s);
  if (dtype == 1 && tensor_cores)
    return launch_tc(x, dy, dw, hi, bd, n_groups, m, d, f, bm, ldx, ldy, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dy, dw, hi, bd, n_groups, m, d, f, bm,
                                 ldx, ldy, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* grouped_dw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
