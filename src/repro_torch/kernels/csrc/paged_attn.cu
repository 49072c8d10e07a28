// K2: split-KV paged-attention decode over a flat page pool, for Hopper
// (sm_90a).
//
// Replaces the JAX package's TPU kernel
// repro/kernels/paged_attn.py::_paged_attn_kernel (launched by
// _paged_attention_pallas).  One query per row attends the row's pages
// through its page-table row; cell j*psz + off is attended only if it is
// <= pos[row]; an online softmax (m, l, acc in f32) carries across pages;
// logits are divided by sqrt(hd); masked cells take finfo(f32).min (not
// -inf), and the output is q's dtype, all as the reference computes them.
//
// int8 pools (the TPU kernel's quant=True branch): pk/pv are int8 and each
// cell (page, offset, KV head) has one bf16 scale in the planes pks/pvs
// (pages, psz, Hkv, 1).  Each value is dequantized as x_f32 * scale_f32
// before it enters a product, exactly as _dequant_block does it (the
// product of an int8 and a bf16 is exact in f32).
//
// What bounds it on an H100.  The bytes are the live K/V cells (a qwen2.5
// decode step reads about 0.6 MB a layer: 0.2 us at 3.35 TB/s), so the
// floor is latency: the launch, and the chain pos -> page table -> page ->
// logits -> output.  The design keeps that chain short and runs it on many
// SMs at once:
// * Split-KV (flash-decoding).  A row's pages are cut into splits of
//   `pps` pages; one CTA per (split, KV head, row).  The
//   plan (repro_torch/kernels/paged_attn.py::k2_plan) comes from static
//   shapes only: no CTA knows pos before it runs, so a CTA whose first page
//   lies past pos[row] // psz returns at once, reading and writing nothing.
// * Every page of a split is in flight at once: pos and the split's table
//   entries are loaded together, then each page's K and V arrive by 16-byte
//   cp.async pieces, kept in the pool's dtype in shared memory.  Rows are
//   padded by 16 bytes so the lanes reading eight neighbouring cells hit
//   eight bank groups.  Table entries are clamped into the pool: a sink or
//   stale entry never faults.
// * Compute is small (a GQA group of 4 to 8 query heads against 16 cells a
//   page: phi3.5-moe and gemma3-1b 4, qwen2.5 7, internvl2 8) and stays in f32 FMAs, but its chain of dependent steps (logits,
//   max, exp, sum, P.V) is long for the few warps a split has.  So the
//   pages of a split run side by side: one warp a (page, query head), each
//   with its own online-softmax state, merged in shared memory in page
//   order.  For the logits, lane (s, o) sums slice s of cell o's dot
//   product and a shuffle adds the slices; for P.V each lane owns hd / 32
//   dimensions.
// * The combine.  A split writes its (m, l, acc[hd]) state in f32 and
//   counts itself on a per-(row, group) arrival counter with one
//   acquire-release atomic; the CTA that arrives last combines the live
//   splits with the usual rescaling (w_s = exp(m_s - max m), out = sum
//   w_s acc_s / sum w_s l_s, in split order) and resets the counter to 0,
//   so no launch needs a memset and the launch can be captured in a CUDA
//   graph.  A row whose pages all lie in split 0 is written by that CTA
//   directly.
// * Every launch is a programmatic dependent launch: its CTAs are placed
//   while the kernel before finishes, and nothing is read before
//   griddepcontrol.wait (q comes from the kernels just before).  K2 itself
//   does not let its dependents start early: back to back, a K2 whose
//   dependents started at the end of its page compute ran 5-16 % slower
//   (scripts/k2_sweep.py --entry).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

#include "hopper_gemm.cuh"

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -3.402823466e38f;  // finfo(float32).min
constexpr int kMaxPps = 8;                   // pages a split keeps in flight
constexpr int kMaxSmem = 227 * 1024 - 1024;  // dynamic bytes a CTA may ask

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   hg_smem(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// atomicAdd with release (of what this thread has observed, the CTA's
// stores before a barrier included) and acquire semantics at device scope.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// The 16-byte piece `raw` of a cell row as f32 values, by shifts (no
// address taken, so the piece stays in registers): a bf16 is the top half
// of its f32, an int8 converts exactly.
template <typename P>
__device__ __forceinline__ void unpack16(const uint4 raw,
                                         float (&v)[16 / sizeof(P)]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(P) == 4) {
      v[i] = __uint_as_float(w[i]);
    } else if constexpr (sizeof(P) == 2) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v[4 * i + b] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * b)));
    }
  }
}

struct K2Args {
  const void* q;
  const void* pk;
  const void* pv;
  const __nv_bfloat16* ks;  // int8 pools: scale planes (pages, psz, Hkv)
  const __nv_bfloat16* vs;
  const int* table;         // (b, pmax)
  const int* pos;           // (b,)
  void* out;                // (b, n_heads, hd)
  float* part;              // (b, n_heads, n_splits, hd) partial acc
  float* part_ml;           // (b, n_heads, n_splits, 2) partial m, l
  int* counters;            // (b, n_kv) arrivals, 0 between launches
  int n_heads, n_kv, psz, pmax, n_pool_pages;
  int pps, n_splits, cell_lanes;  // cell_lanes: pow2 >= psz, <= 32
};

// Shared memory of one CTA: q in f32 (the n_rep heads of its KV head),
// then pps pages of K and V cell rows (psz each, padded by 16 bytes), then each
// (page, head) warp's (m, l, acc[hd]) in f32, then for int8 pools the
// pages' scales in f32.
template <typename P, int HD>
__host__ __device__ constexpr int row_pitch() {
  return HD * static_cast<int>(sizeof(P)) + 16;
}

template <typename P, int HD, bool QUANT>
__host__ __device__ inline int smem_bytes(int heads, int cells, int pps) {
  return heads * HD * 4 + pps * 2 * cells * row_pitch<P, HD>() +
         pps * heads * (HD + 2) * 4 + (QUANT ? pps * 2 * cells * 4 : 0);
}

// T: q's and the output's dtype; P: the pools' (T, or int8_t with QUANT).
// One warp a (page of the split, query head): warp = slot * heads + head.
// Up to 1024 threads and one block an SM asked of ptxas: with the thread
// count alone it held the head_dim-64 float bodies to 32 registers and
// spilled.
template <typename T, typename P, int HD, bool QUANT>
__global__ void __launch_bounds__(1024, 1)
    paged_attn_split_kernel(const K2Args a) {
  constexpr int DPL = HD / 32;                     // P.V dims per lane
  constexpr int kPitch = row_pitch<P, HD>();
  constexpr int kPieces = HD * sizeof(P) / 16;     // 16-byte pieces a row
  constexpr int kVals = 16 / sizeof(P);            // values a piece
  extern __shared__ __align__(16) uint8_t smem[];

  const int split = blockIdx.x, kvhead = blockIdx.y, row = blockIdx.z;
  const int heads = a.n_heads / a.n_kv;            // query heads of the CTA
  const int cells = a.psz;                         // cell rows a page (K or V)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / heads, lr = warp % heads;
  float* qs = reinterpret_cast<float*>(smem);
  uint8_t* pages = smem + heads * HD * 4;
  const int page_bytes = 2 * cells * kPitch;
  float* states = reinterpret_cast<float*>(pages + a.pps * page_bytes);
  float* scl = states + a.pps * heads * (HD + 2);

  // q, pos and the table are written by the kernels just before.
  grid_dependency_wait();
  const int j0 = split * a.pps;
  int phys[kMaxPps];
#pragma unroll
  for (int i = 0; i < kMaxPps; ++i)
    phys[i] = i < a.pps && j0 + i < a.pmax
                  ? a.table[(long long)row * a.pmax + j0 + i] : 0;
  const int p = a.pos[row];
  const int n_live = min(p / a.psz + 1, a.pmax);
  const int live_splits = (n_live + a.pps - 1) / a.pps;
  if (j0 >= n_live) return;  // nothing this split may attend
  const int n_pg = min(a.pps, n_live - j0);

  // Every page of the split in flight: K then V cell rows by 16-byte
  // cp.async pieces.
  const P* pk = static_cast<const P*>(a.pk);
  const P* pv = static_cast<const P*>(a.pv);
#pragma unroll
  for (int i = 0; i < kMaxPps; ++i) {
    if (i >= n_pg) break;
    phys[i] = min(max(phys[i], 0), a.n_pool_pages - 1);
    uint8_t* dst = pages + i * page_bytes;
    for (int e = threadIdx.x; e < 2 * cells * kPieces; e += blockDim.x) {
      const int kv = e / (cells * kPieces), rem = e % (cells * kPieces);
      const int cell = rem / kPieces, c = rem % kPieces;
      const long long src =
          (((long long)phys[i] * a.psz + cell) * a.n_kv + kvhead) * HD +
          c * kVals;
      cp_async16(dst + (kv * cells + cell) * kPitch + c * 16,
                 (kv ? pv : pk) + src);
    }
  }
  cp_async_commit();
  // While the pages land: q (16-byte pieces) and, for int8 pools, the
  // scales, all loaded before any is stored, so neither waits for the
  // other.  A thread has at most two of each: q is heads * HD * sizeof(T)
  // / 16 <= 64 heads pieces and the scales 2 psz pps <= 64 pps values,
  // against 32 heads pps threads.
  constexpr int kQVals = 16 / sizeof(T);
  const int q_pieces = heads * HD / kQVals, n_scl = n_pg * 2 * cells;
  const uint4* q = reinterpret_cast<const uint4*>(
      static_cast<const T*>(a.q) +
      ((long long)row * a.n_heads + kvhead * heads) * HD);
  uint4 qr[2];
  __nv_bfloat16 sr[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < q_pieces) qr[k] = q[e];
    if (QUANT && e < n_scl) {
      const int i = e / (2 * cells), cell = e % cells;
      int ph = phys[0];
#pragma unroll
      for (int t = 1; t < kMaxPps; ++t)
        if (t == i) ph = phys[t];
      const long long at = ((long long)ph * a.psz + cell) * a.n_kv + kvhead;
      sr[k] = e % (2 * cells) < cells ? a.ks[at] : a.vs[at];
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < q_pieces) {
      float v[kQVals];
      unpack16<T>(qr[k], v);
#pragma unroll
      for (int i = 0; i < kQVals; ++i) qs[e * kQVals + i] = v[i];
    }
    if (QUANT && e < n_scl) scl[e] = __bfloat162float(sr[k]);
  }
  cp_async_wait_all();
  __syncthreads();

  // Warp (slot, lr): page j0 + slot for the CTA's query head lr, an
  // online-softmax state of its own: m the page's largest logit, l and
  // acc its sums.
  const int lanes = a.cell_lanes, slices = 32 / lanes;
  const int o_lane = lane % lanes, s_lane = lane / lanes;
  float acc[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
  float m_run = kNegInf, l_run = 0.f;
  if (slot < n_pg) {
    const int j = j0 + slot;
    const uint8_t* kpage = pages + slot * page_bytes;
    const uint8_t* vpage = kpage + cells * kPitch;
    const float* ksc = scl + slot * 2 * cells;
    const float* vsc = ksc + cells;
    const float* qrow = qs + lr * HD;

    // Slice s_lane of cell o_lane's dot product, four pieces' sums apart.
    float pp[4] = {0.f, 0.f, 0.f, 0.f};
    if (o_lane < a.psz) {
      const uint8_t* krow = kpage + o_lane * kPitch;
      const float sc = QUANT ? ksc[o_lane] : 1.f;
#pragma unroll
      for (int i = 0; i < kPieces; ++i) {
        const int c = s_lane + i * slices;
        if (c >= kPieces) break;
        float kv[kVals];
        unpack16<P>(*reinterpret_cast<const uint4*>(krow + c * 16), kv);
        const float* qc = qrow + c * kVals;
#pragma unroll
        for (int v = 0; v < kVals; ++v)
          pp[i % 4] = fmaf(qc[v], QUANT ? kv[v] * sc : kv[v], pp[i % 4]);
      }
    }
    float part = (pp[0] + pp[1]) + (pp[2] + pp[3]);
    for (int off = lanes; off < 32; off <<= 1)
      part += __shfl_xor_sync(kFull, part, off);
    float logit = part / sqrtf(static_cast<float>(HD));
    if (o_lane >= a.psz || j * a.psz + o_lane > p) logit = kNegInf;
    m_run = warp_max(logit);
    // Lane o (< lanes) holds cell o's probability; the other slices 0.
    const float prob =
        s_lane == 0 && o_lane < a.psz ? expf(logit - m_run) : 0.f;
    l_run = warp_sum(prob);
#pragma unroll 4
    for (int o = 0; o < a.psz; ++o) {
      const float po = __shfl_sync(kFull, prob, o);
      const P* vr = reinterpret_cast<const P*>(vpage + o * kPitch);
      const float sc = QUANT ? vsc[o] : 1.f;
#pragma unroll
      for (int d = 0; d < DPL; ++d) {
        const float vx = to_f32(vr[lane + 32 * d]);
        acc[d] = fmaf(po, QUANT ? vx * sc : vx, acc[d]);
      }
    }
  }

  // The split's state: the pages' merged in page order, by slot 0's warps.
  float* st = states + lr * (HD + 2);  // slot 0's, then the split's
  if (a.pps > 1) {
    float* mine = st + slot * heads * (HD + 2);
#pragma unroll
    for (int d = 0; d < DPL; ++d) mine[2 + lane + 32 * d] = acc[d];
    if (lane == 0) {
      mine[0] = m_run;
      mine[1] = l_run;
    }
    __syncthreads();
    if (slot == 0 && n_pg > 1) {
      float m_max = m_run;
      for (int i = 1; i < n_pg; ++i)
        m_max = fmaxf(m_max, st[i * heads * (HD + 2)]);
      l_run = 0.f;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
      for (int i = 0; i < n_pg; ++i) {
        const float* si = st + i * heads * (HD + 2);
        const float w = expf(si[0] - m_max);
        l_run += w * si[1];
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[d] += w * si[2 + lane + 32 * d];
      }
      m_run = m_max;
    }
  }

  const long long head = (long long)row * a.n_heads + kvhead * heads + lr;
  T* orow = static_cast<T*>(a.out) + head * HD;
  if (live_splits == 1) {  // the whole row was this split's
    if (slot == 0) {
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        orow[lane + 32 * d] = from_f32<T>(acc[d] / l_run);
    }
    return;
  }
  if (slot == 0) {
    float* part = a.part + (head * a.n_splits + split) * HD;
#pragma unroll
    for (int d = 0; d < DPL; ++d) part[lane + 32 * d] = acc[d];
    if (lane == 0) {
      a.part_ml[(head * a.n_splits + split) * 2] = m_run;
      a.part_ml[(head * a.n_splits + split) * 2 + 1] = l_run;
    }
  }
  // Arrive: the last of the row's live splits combines them.  Thread 0's
  // atomic releases the CTA's partials (the barrier orders every thread's
  // stores before it) and acquires the others'.
  __shared__ int ticket;
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = a.counters + (long long)row * a.n_kv + kvhead;
    ticket = atomic_add_acq_rel(counter, 1);
    if (ticket == live_splits - 1) *counter = 0;  // ready for the next launch
  }
  __syncthreads();
  if (ticket != live_splits - 1 || slot != 0) return;
  // Lane s holds split s's m and l (s, s + 32, ...); the partials' loads
  // are issued eight splits at a time; sums run in split order.
  const float* ml = a.part_ml + head * a.n_splits * 2;
  const float* pa = a.part + head * a.n_splits * HD;
  float m_max = kNegInf;
  for (int s = lane; s < live_splits; s += 32)
    m_max = fmaxf(m_max, __ldcg(ml + 2 * s));
  m_max = warp_max(m_max);
  float l = 0.f, o[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) o[d] = 0.f;
  for (int s0 = 0; s0 < live_splits; s0 += 32) {
    float w = 0.f, ls = 0.f;
    if (s0 + lane < live_splits) {
      w = expf(__ldcg(ml + 2 * (s0 + lane)) - m_max);
      ls = __ldcg(ml + 2 * (s0 + lane) + 1);
    }
    const int n = min(32, live_splits - s0);
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float wi = __shfl_sync(kFull, w, i);
      l += wi * __shfl_sync(kFull, ls, i);
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        o[d] += wi * __ldcg(pa + (long long)(s0 + i) * HD + lane + 32 * d);
    }
  }
#pragma unroll
  for (int d = 0; d < DPL; ++d) orow[lane + 32 * d] = from_f32<T>(o[d] / l);
}

template <typename T, typename P, int HD, bool QUANT>
cudaError_t launch(const K2Args& a, int b, cudaStream_t stream) {
  const int heads = a.n_heads / a.n_kv;
  const int smem = smem_bytes<P, HD, QUANT>(heads, a.psz, a.pps);
  if (smem > kMaxSmem || a.pps * heads * 32 > 1024)
    return cudaErrorInvalidValue;
  auto kernel = paged_attn_split_kernel<T, P, HD, QUANT>;
  static unsigned long long raised = 0;  // per instantiation, a bit a device
  cudaError_t err = hg_raise_smem(kernel, kMaxSmem, raised);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_splits, a.n_kv, b);
  cfg.blockDim = dim3(a.pps * heads * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename P, bool QUANT>
cudaError_t dispatch(int hd, const K2Args& a, int b, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, P, 64, QUANT>(a, b, s);
    case 128: return launch<T, P, 128, QUANT>(a, b, s);
    case 256: return launch<T, P, 256, QUANT>(a, b, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, n_heads, hd), pools (n_pool_pages, psz, n_kv, hd), table (b, pmax)
// int32, pos (b,) int32, out (b, n_heads, hd), all contiguous.  dtype (q
// and the output): 0 = float32, 1 = bfloat16.  quant: 0 = pools of q's
// dtype (pks / pvs unused), 1 = int8 pools with bf16 scale planes.  The
// plan (k2_plan): pps pages a split (<= 8), n_splits = ceil(pmax / pps).
// part (b, n_heads, n_splits, hd + 2) f32 scratch and counters (b, n_kv)
// int32, zero before the
// first launch (each launch leaves them zero); unused with one split.
// Returns the launch's cudaError_t.
extern "C" int paged_attn(const void* q, const void* pk, const void* pv,
                          const void* pks, const void* pvs, const void* table,
                          const void* pos, void* out, void* part,
                          void* counters, int b, int n_heads, int n_kv,
                          int hd, int psz, int pmax, int n_pool_pages,
                          int pps, int n_splits, int dtype, int quant,
                          void* stream) {
  if (b <= 0 || n_kv <= 0 || n_heads % n_kv || psz <= 0 || psz > 32 ||
      pmax <= 0 || n_pool_pages <= 0 || pps <= 0 || pps > kMaxPps || n_splits != (pmax + pps - 1) / pps)
    return cudaErrorInvalidValue;
  int lanes = 1;
  while (lanes < psz) lanes <<= 1;
  float* pf = static_cast<float*>(part);
  const long long n_part = (long long)b * n_heads * n_splits;
  const K2Args a{q, pk, pv, static_cast<const __nv_bfloat16*>(pks),
                 static_cast<const __nv_bfloat16*>(pvs),
                 static_cast<const int*>(table), static_cast<const int*>(pos),
                 out, pf, pf + n_part * hd, static_cast<int*>(counters),
                 n_heads, n_kv, psz, pmax, n_pool_pages, pps, n_splits,
                 lanes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !quant) return dispatch<float, float, false>(hd, a, b, s);
  if (dtype == 1 && !quant)
    return dispatch<__nv_bfloat16, __nv_bfloat16, false>(hd, a, b, s);
  if (dtype == 0 && quant) return dispatch<float, int8_t, true>(hd, a, b, s);
  if (dtype == 1 && quant)
    return dispatch<__nv_bfloat16, int8_t, true>(hd, a, b, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
