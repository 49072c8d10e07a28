// K6: fused multi-tenant co-execution, T heterogeneous GEMMs in one grid,
// for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel repro/kernels/coexec.py::
// _coexec_kernel (launched by _coexec_call for run_plan, coexec_matmul and
// sequential_matmul).  Same contract: tenant t's activations are rows
// [row_offset[t], row_offset[t] + m_t) of a flat (M_flat, Kp) A, its weight
// is b_stack[t] of a (T, Kp, Np) stack, zero past (k_t, n_t); a (5, n_tasks)
// int32 table gives each task [tenant, row_block, col_block, row_hi, k_hi],
// and the task's (bm x bn) tile (row_block, col_block) of the flat
// (M_flat, Np) output is accumulated in f32 and written in A's dtype.
// Scale-in as on the TPU: rows at or past row_hi are written as exact
// zeros, and K steps at or past k_hi are never loaded.
//
// What bounds it on an H100: the co-resident GEMMs are decode- and
// prefill-sized (m from 1 to a few hundred), so device-memory bytes, each
// live weight read once per row tile of its tenant that reads it.  The TPU
// walks one (bm x bn) task after another; a CTA per such task, as the
// first port ran it, re-reads a prefill tenant's weights once per row
// block (10 times for 150 rows at bm 16), and keeps few bytes in flight.
// What holds this design back is bytes in flight and the tail: a CTA
// streams its group at the rate its ring's bytes in flight allow, so a
// long group started late (a prefill tenant's K 4864 projection) sets the
// launch's end, and a launch of few CTAs (narrow_proj) is latency-bound.
//
// bf16 runs one CTA per row of the table k6_plan builds from the tasks when
// the plan is built (repro_torch/kernels/coexec.py): tile groups, each a
// run of one tenant's row blocks, up to 128 rows, by one or two of its
// 64-column blocks, in the order of each group's first task (the
// packer's placement order decides which tenants share the first wave).
// A group reads its weight tile once for all its rows, on the TMA + wgmma
// mainloop of hopper_gemm.cuh (hg_produce_ring / hg_consume_ring):
// swap-AB, a consumer warpgroup's 64 weight columns as wgmma's 64-row side
// and the group's rows as its n side, at the width 8 / 16 / 32 / 64 / 128
// that holds the group's live rows; the weights through one 3-D tensor map
// over the (T, Kp, Np) stack, A through a 2-D map over the flat (M_flat,
// Kp) buffer whose boxes are the width's rows (one box a stage: a stage of
// 8-row boxes ran 1.2-1.9x slower), 64-deep stages, as many as the 104 KB
// ring holds for the group's slot size, each slot handed back as soon as
// its wgmma completes.  Two CTAs share an SM, so one's start and end hide
// under the other's streaming.  A group of 24 K steps or more, or of a
// tenant with at most two column blocks, is shared by the two CTAs of a
// cluster (each a contiguous half of the K steps): their f32 tiles meet in
// distributed shared memory and each CTA writes half of the rows, rank 0's
// tile plus rank 1's; the launch runs clusters only where a plan has such
// a pair.  Rows past row_hi and the columns past the tenant's last column
// block are written as zeros (so the output needs no memset), and every
// launch is a programmatic dependent launch.
//
// Bits: a group's width, column blocks and cluster split are functions of
// its tenant's own (m, n, k) and the plan's (bm, bn, bk) alone (k6_plan),
// each output element's K steps run in one fixed order and a pair's halves
// are added in rank order, and nothing is shared between groups (no
// atomics), so a tenant's result is the same whether it runs fused with
// others or alone through a single-tenant plan of the same block shapes
// (coexec.py:41-45's contract, fused == sequential bit for bit).  Rows of
// Y past the group's own are read (the next tenant's rows or TMA's zero
// fill) but only reach output columns of D that are never written.
//
// float32 (exact, no TF32) runs tile_gemm.cuh's CUDA-core body, one block
// per task of the (5, n_tasks) table at the plan's tile height bm (16 / 32
// / 64 / 128) with the fixed kTileN / kTileK the plan's bn / bk must equal.
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

// ---------------------------------------------------------------------------
// float32: one block per task on the CUDA cores.
// ---------------------------------------------------------------------------
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
__global__ void __launch_bounds__(kFpThreads)
    coexec_fp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ c, const int* __restrict__ meta,
                     int n_tasks, int n_tenants, int kp, int np_pad) {
  const Task t = task_of(meta, n_tasks, n_tenants, kp, BM);
  const StoreMasked<float> epi{c + (long long)t.row0 * np_pad + t.n0, np_pad,
                               t.live, kTileN};
  if (t.live <= 0) {  // scale-in: no weight bytes, no MACs
    for (int e = threadIdx.x; e < BM * kTileN; e += blockDim.x)
      epi(e / kTileN, e % kTileN, 0.f);
    return;
  }
  fp_tile<float, BM>(a + (long long)t.row0 * kp, kp, t.live,
                     b + (long long)t.tenant * kp * np_pad + t.n0, np_pad,
                     kTileN, t.k_hi, epi);
}

template <int BM>
cudaError_t launch_fp(const void* a, const void* b, void* c, const int* meta,
                      int n_tasks, int n_tenants, int kp, int np_pad,
                      cudaStream_t s) {
  coexec_fp_kernel<BM><<<n_tasks, kFpThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), meta, n_tasks, n_tenants, kp, np_pad);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: one CTA per row of the tile-group table on the TMA + wgmma mainloop.
// ---------------------------------------------------------------------------
// The fields of a CTA's row of k6_plan's (n_rows, kGFields) table: its
// group's tenant; first flat row; rows it writes (whole row blocks); rows
// below row_hi among them; first weight column; 64-column chunks (one a
// consumer warpgroup); K steps of 64 up to k_hi; wgmma width; the first
// column past the tenant's column blocks; the group's index among its row
// run's column groups, and their count (the zero columns past the
// tenant's blocks are dealt out among them); the CTAs that share its K
// steps (1, or 2: a cluster pair); and this CTA's rank among them.
enum GroupField {
  kGTenant, kGRow0, kGRows, kGLive, kGCol0, kGChunks, kGKSteps, kGWidth,
  kGZeroCol, kGZeroIdx, kGZeroN, kGRanks, kGRank, kGFields
};

// Two consumer warpgroups and a ring of 104 KB, so two CTAs share an SM and
// one's start (the table, the barriers, the first loads' round trip) and
// end (the sum and the stores) run while the other streams.
constexpr int kK6Consumers = 2;                       // warpgroups
constexpr int kK6Threads = kK6Consumers * 128 + 32;   // + the producer warp
constexpr int kK6Ring = 104 * 1024;
constexpr int kK6MaxStages = 12;
constexpr int kK6Pitch = 64 + 4;  // f32 row pitch of a chunk's tile
constexpr int kK6Smem = kK6Ring + 2 * kK6MaxStages * 8 + 1024;
static_assert(kK6Consumers * 128 * kK6Pitch * 4 <= kK6Ring,
              "the chunks' tiles fit the ring");

struct Group {
  int tenant, row0, rows, live, col0, chunks, ksteps, width, zero_col,
      zero_idx, zero_n, ranks;
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int BQ>
__device__ __forceinline__ void k6_group(const CUtensorMap* tw,
                                         const CUtensorMap* ta,  // BQ-row boxes
                                         __nv_bfloat16* __restrict__ c,
                                         const Group& g, int np_pad,
                                         uint8_t* ring, uint64_t* full,
                                         uint64_t* empty, int rank) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = g.chunks, R = g.ranks;
  // This CTA's share of the K steps: rank r of R takes a contiguous run.
  const int k0 = rank * g.ksteps / R;
  const int n_k = (rank + 1) * g.ksteps / R - k0;
  const int sbytes = C * kHgChunk + BQ * 128;
  const int stages = min(kK6MaxStages, kK6Ring / sbytes);
  const int warp = threadIdx.x / 32, wg = warp / 4;
  const bool active = g.live > 0 && wg < C;
  float acc[BQ / 2];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) acc[i] = 0.f;

  if (g.live > 0) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < stages; ++st) {
        mbar_init(&full[st], 1);
        mbar_init(&empty[st], 4 * C);
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
  // Launched with programmatic stream serialization: A may come from the
  // kernel just before, and C may be memory it still reads.
  grid_dependency_wait();
  if (g.live > 0) {
    if (warp == kK6Consumers * 4) {
      if (threadIdx.x % 32 == 0)
        hg_produce_ring<BQ>(ring, full, empty, tw, ta, sbytes, stages, C,
                            g.col0, g.tenant, g.row0, k0, n_k);
    } else if (active) {
      hg_consume_ring<BQ>(ring, full, empty, sbytes, stages, C, wg, n_k,
                          acc);
    }
  }
  launch_dependents();

  // Every load has landed and every wgmma drained: the ring becomes the
  // chunks' f32 tiles, warpgroup w's at w.
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  if (active) {
    // This thread's fragment rows p (r, r + 8) and columns q (hopper_gemm.cuh);
    // D (p, q) is C[row0 + q][col0 + 64 chunk + p].
    const int t = threadIdx.x % 128;
    const int r = (t / 32) * 16 + (t % 32) / 4, c0 = 2 * (t % 4);
    float* dst = red + wg * BQ * kK6Pitch;
#pragma unroll
    for (int cc = 0; cc < BQ / 8; ++cc)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          dst[(8 * cc + c0 + j) * kK6Pitch + r + 8 * h] =
              acc[4 * cc + 2 * h + j];
  }
  // With a pair, both CTAs' tiles are parked before either reads the
  // other's; each then writes its half of the rows, rank 0's tile + rank
  // 1's.
  const float* part0 = red;
  const float* part1 = red;
  if (R == 2) {
    cluster.sync();
    part0 = cluster.map_shared_rank(red, 0);
    part1 = cluster.map_shared_rank(red, 1);
  } else {
    __syncthreads();
  }
  const int q_lo = rank * g.rows / R, q_hi = (rank + 1) * g.rows / R;

  // This CTA's rows of the group, 8 columns (16 bytes) a thread; rows at or
  // past live exact zeros.
  const int per_row = C * 8;
  for (int e = threadIdx.x; e < (q_hi - q_lo) * per_row; e += kK6Threads) {
    const int q = q_lo + e / per_row, j = e % per_row;
    const int chunk = j / 8, p = (j % 8) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q < g.live) {
      const int at = (chunk * BQ + q) * kK6Pitch + p;
      float4 lo = *reinterpret_cast<const float4*>(part0 + at);
      float4 hi = *reinterpret_cast<const float4*>(part0 + at + 4);
      if (R == 2) {
        const float4 a = *reinterpret_cast<const float4*>(part1 + at);
        const float4 b = *reinterpret_cast<const float4*>(part1 + at + 4);
        lo.x += a.x; lo.y += a.y; lo.z += a.z; lo.w += a.w;
        hi.x += b.x; hi.y += b.y; hi.z += b.z; hi.w += b.w;
      }
      v = make_uint4(pack_bf16x2(lo.x, lo.y), pack_bf16x2(lo.z, lo.w),
                     pack_bf16x2(hi.x, hi.y), pack_bf16x2(hi.z, hi.w));
    }
    *reinterpret_cast<uint4*>(c + (long long)(g.row0 + q) * np_pad + g.col0 +
                              chunk * 64 + p) = v;
  }
  // This CTA's rows of the group's share of the zero columns past the
  // tenant's blocks: 64-wide chunks zero_idx, zero_idx + zero_n, ... .
  const int zc = (np_pad - g.zero_col) / 64;
  const int mine = zc > g.zero_idx ? (zc - g.zero_idx + g.zero_n - 1) / g.zero_n
                                   : 0;
  const int nq = q_hi - q_lo;
  for (int e = threadIdx.x; e < mine * nq * 8; e += kK6Threads) {
    const int z = g.zero_idx + (e / (nq * 8)) * g.zero_n;
    const int q = q_lo + (e / 8) % nq, p = (e % 8) * 8;
    *reinterpret_cast<uint4*>(c + (long long)(g.row0 + q) * np_pad +
                              g.zero_col + z * 64 + p) = make_uint4(0, 0, 0, 0);
  }
  if (R == 2) cluster.sync();  // no CTA leaves while the other reads it
}

// A's tensor maps, one a width: boxes of 8, 16, 32, 64 and 128 rows.
struct AMaps {
  CUtensorMap w8, w16, w32, w64, w128;
};

// One CTA a row of the table; launched in clusters of two where a pair
// shares a group (its rows at 2 c and 2 c + 1), else without clusters.
__global__ void __launch_bounds__(kK6Threads, 2)
    coexec_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                        const __grid_constant__ AMaps ta,
                        __nv_bfloat16* __restrict__ c,
                        const int* __restrict__ groups, int np_pad) {
  extern __shared__ uint4 smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_raw) +
                  ((1024 - (hg_smem(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kK6Ring);
  uint64_t* empty = full + kK6MaxStages;
  // The table is written once, when the plan is built, and never by a
  // kernel, so it is read before the dependency wait.
  const int* f = groups + (long long)blockIdx.x * kGFields;
  const int rank = f[kGRank];
  const Group g{f[kGTenant],  f[kGRow0],    f[kGRows],    f[kGLive],
                f[kGCol0],    f[kGChunks],  f[kGKSteps],  f[kGWidth],
                f[kGZeroCol], f[kGZeroIdx], f[kGZeroN],   f[kGRanks]};
  if (rank >= g.ranks) return;  // a hole before a pair
  const CUtensorMap* a = g.width == 8    ? &ta.w8
                         : g.width == 16 ? &ta.w16
                         : g.width == 32 ? &ta.w32
                         : g.width == 64 ? &ta.w64
                                         : &ta.w128;
  if (threadIdx.x == kK6Consumers * 128) {  // the producer
    tma_prefetch_map(&tw);
    tma_prefetch_map(a);
  }
  switch (g.width) {
    case 8: k6_group<8>(&tw, a, c, g, np_pad, ring, full, empty, rank); break;
    case 16: k6_group<16>(&tw, a, c, g, np_pad, ring, full, empty, rank); break;
    case 32: k6_group<32>(&tw, a, c, g, np_pad, ring, full, empty, rank); break;
    case 64: k6_group<64>(&tw, a, c, g, np_pad, ring, full, empty, rank); break;
    default: k6_group<128>(&tw, a, c, g, np_pad, ring, full, empty, rank); break;
  }
}

}  // namespace

// float32: a (m_flat, kp), b (n_tenants, kp, np_pad) and c (m_flat, np_pad),
// all contiguous; meta (5, n_tasks) int32.  bm: the plan's row block (16, 32,
// 64 or 128); bn and bk must be kTileN and kTileK.  Returns the launch's
// cudaError_t.
extern "C" int coexec(const void* a, const void* b, void* c, const void* meta,
                      int n_tasks, int n_tenants, int kp, int np_pad, int bm,
                      int bn, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mt = static_cast<const int*>(meta);
  if (bn != kTileN || bk != kTileK || n_tasks <= 0)
    return cudaErrorInvalidValue;
  switch (bm) {
    case 16: return launch_fp<16>(a, b, c, mt, n_tasks, n_tenants, kp, np_pad, s);
    case 32: return launch_fp<32>(a, b, c, mt, n_tasks, n_tenants, kp, np_pad, s);
    case 64: return launch_fp<64>(a, b, c, mt, n_tasks, n_tenants, kp, np_pad, s);
    case 128:
      return launch_fp<128>(a, b, c, mt, n_tasks, n_tenants, kp, np_pad, s);
    default: return cudaErrorInvalidValue;
  }
}

// bfloat16: a, b and c as above (16-byte aligned bases; kp a multiple of 8
// and np_pad of 64, which the plan's blocks give), groups (n_rows,
// kGFields) int32 from k6_plan, one row a CTA, every width in {8, 16, 32,
// 64, 128} and chunks <= kK6Consumers; cluster 2 where a pair
// shares a group (its rows at 2 c and 2 c + 1), else 1.  Every element of
// c inside a group's rows is written.  Returns the launch's cudaError_t.
extern "C" int coexec_wgmma(const void* a, const void* b, void* c,
                            const void* groups, int n_rows, int n_tenants,
                            int m_flat, int kp, int np_pad, int cluster,
                            void* stream) {
  if (n_rows <= 0 || n_tenants <= 0 || m_flat <= 0 || kp <= 0 || kp % 8 ||
      np_pad <= 0 || np_pad % 64 || (cluster != 1 && cluster != 2) ||
      n_rows % cluster)
    return cudaErrorInvalidValue;
  CUtensorMap tw;
  AMaps ta;
  // The weight stack (T, Kp, Np), N-major: 64 x 64 boxes of one plane;
  // the flat A (M_flat, Kp), K-major: boxes of each width's rows.
  cudaError_t err = tensor_map_3d(&tw, b, np_pad, kp, n_tenants, 64);
  CUtensorMap* maps[5] = {&ta.w8, &ta.w16, &ta.w32, &ta.w64, &ta.w128};
  for (int i = 0; i < 5 && err == cudaSuccess; ++i)
    err = tensor_map(maps[i], a, kp, m_flat, kp, 8 << i);
  if (err != cudaSuccess) return err;
  static unsigned long long raised = 0;  // a bit a device
  err = hg_raise_smem(coexec_wgmma_kernel, kK6Smem, raised);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_rows);
  cfg.blockDim = dim3(kK6Threads);
  cfg.dynamicSmemBytes = kK6Smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, coexec_wgmma_kernel, tw, ta,
                           static_cast<__nv_bfloat16*>(c),
                           static_cast<const int*>(groups), np_pad);
  return err != cudaSuccess ? err : cudaGetLastError();
}

extern "C" const char* coexec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
