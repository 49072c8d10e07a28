// K2: paged-attention decode over a flat page pool, for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel
// repro/kernels/paged_attn.py::_paged_attn_kernel (launched by
// _paged_attention_pallas).  One query per row attends the row's pages
// through its page-table row; cell j*psz + off is attended only if it is
// <= pos[row]; an online softmax (m, l, acc in f32) carries across pages;
// logits are divided by sqrt(hd); masked cells take finfo(f32).min (not
// -inf), and the output is q's dtype, all as the reference computes them.
//
// Layout: one block per (KV head, row), one warp per query head of the GQA
// group (head = kv_head * n_rep + warp; n_rep = 7 for qwen2.5-0.5b, which
// is why this is CUDA and not a power-of-two Triton block).  Each page's K
// and V slice for the block's KV head is staged in shared memory once and
// read by every warp of the group.  Lane `o` owns the logit of page offset
// `o` (psz <= 32), and each lane owns hd / 32 dimensions of q and of the
// accumulator.
//
// int8 pools (the TPU kernel's quant=True branch): pk/pv are int8 and each
// cell (page, offset, KV head) has one bf16 scale in the planes pks/pvs
// (pages, psz, Hkv, 1).  A cell is dequantized while its page is staged,
// x_f32 * scale_f32, exactly as _dequant_block does it (the product of an
// int8 and a bf16 is exact in f32), so the softmax and both contractions are
// the float body's; q stays in its own dtype, read as f32.
//
// What bounds it on an H100: device-memory bytes, the K/V cells the rows
// actually attend (one byte a value plus two bytes a cell and head for the
// scale with int8 pools).  The TPU kernel DMAs every table entry, dead pages too
// (paged_attn.py:107-110); this kernel bounds its page loop by
// pos // psz + 1, so it reads only live pages.  Table entries are clamped
// into the pool, so a sink (or stale) entry can never fault.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -3.402823466e38f;  // finfo(float32).min

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

// T: q's and the output's dtype; P: the pools' (T, or int8_t with QUANT).
template <typename T, typename P, int HD, bool QUANT>
__global__ void paged_attn_kernel(const T* __restrict__ q,
                                  const P* __restrict__ pk,
                                  const P* __restrict__ pv,
                                  const __nv_bfloat16* __restrict__ k_scale,
                                  const __nv_bfloat16* __restrict__ v_scale,
                                  const int* __restrict__ table,
                                  const int* __restrict__ pos,
                                  T* __restrict__ out, int n_heads, int n_kv,
                                  int psz, int pmax, int n_pool_pages) {
  constexpr int DPL = HD / 32;  // dims per lane
  extern __shared__ float smem[];
  float* ks = smem;             // (psz, HD)
  float* vs = smem + psz * HD;  // (psz, HD)

  const int h = blockIdx.x;
  const int row = blockIdx.y;
  const int n_rep = n_heads / n_kv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int head = h * n_rep + warp;
  const int p = pos[row];
  const float scale = sqrtf(static_cast<float>(HD));

  const T* qrow = q + ((long long)row * n_heads + head) * HD;
  float qv[DPL], acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qv[i] = to_f32(qrow[lane + 32 * i]);
    acc[i] = 0.f;
  }
  float m_run = kNegInf, l_run = 0.f;

  // Pages past the row's position hold nothing it may attend: never read.
  int n_live = p / psz + 1;
  if (n_live > pmax) n_live = pmax;
  for (int j = 0; j < n_live; ++j) {
    int phys = table[(long long)row * pmax + j];
    phys = min(max(phys, 0), n_pool_pages - 1);
    for (int e = threadIdx.x; e < psz * HD; e += blockDim.x) {
      const int o = e / HD, d = e % HD;
      const long long cell = ((long long)phys * psz + o) * n_kv + h;
      const long long src = cell * HD + d;
      float kx = to_f32(pk[src]), vx = to_f32(pv[src]);
      if (QUANT) {
        kx *= __bfloat162float(k_scale[cell]);
        vx *= __bfloat162float(v_scale[cell]);
      }
      ks[e] = kx;
      vs[e] = vx;
    }
    __syncthreads();

    float logit = kNegInf;  // lane o: the logit of offset o
    for (int o = 0; o < psz; ++o) {
      const float* kr = ks + o * HD;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) part = fmaf(qv[i], kr[lane + 32 * i], part);
      float lg = warp_sum(part) / scale;
      if (j * psz + o > p) lg = kNegInf;
      if (lane == o) logit = lg;
    }
    const float m_new = fmaxf(m_run, warp_max(logit));
    const float alpha = expf(m_run - m_new);
    const float prob = lane < psz ? expf(logit - m_new) : 0.f;
    l_run = alpha * l_run + warp_sum(prob);
    float pvs[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) pvs[i] = 0.f;
    for (int o = 0; o < psz; ++o) {
      const float po = __shfl_sync(kFull, prob, o);
      const float* vr = vs + o * HD;
#pragma unroll
      for (int i = 0; i < DPL; ++i) pvs[i] = fmaf(po, vr[lane + 32 * i], pvs[i]);
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = alpha * acc[i] + pvs[i];
    m_run = m_new;
    __syncthreads();  // the next page overwrites ks / vs
  }

  T* orow = out + ((long long)row * n_heads + head) * HD;
#pragma unroll
  for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = from_f32<T>(acc[i] / l_run);
}

template <typename T, typename P, int HD, bool QUANT>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const void* pks, const void* pvs, const int* table,
                   const int* pos, void* out, int b, int n_heads, int n_kv,
                   int psz, int pmax, int n_pool_pages, cudaStream_t stream) {
  const int smem = 2 * psz * HD * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attn_kernel<T, P, HD, QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_kv, b);
  const dim3 block(32 * (n_heads / n_kv));
  paged_attn_kernel<T, P, HD, QUANT><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pk),
      static_cast<const P*>(pv), static_cast<const __nv_bfloat16*>(pks),
      static_cast<const __nv_bfloat16*>(pvs), table, pos,
      static_cast<T*>(out), n_heads, n_kv, psz, pmax, n_pool_pages);
  return cudaGetLastError();
}

template <typename T, typename P, bool QUANT>
cudaError_t dispatch(int hd, const void* q, const void* pk, const void* pv,
                     const void* pks, const void* pvs, const int* table,
                     const int* pos, void* out, int b, int n_heads, int n_kv,
                     int psz, int pmax, int n_pool_pages, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, P, 64, QUANT>(q, pk, pv, pks, pvs, table, pos, out, b,
                                     n_heads, n_kv, psz, pmax, n_pool_pages,
                                     s);
    case 128:
      return launch<T, P, 128, QUANT>(q, pk, pv, pks, pvs, table, pos, out,
                                      b, n_heads, n_kv, psz, pmax,
                                      n_pool_pages, s);
    case 256:
      return launch<T, P, 256, QUANT>(q, pk, pv, pks, pvs, table, pos, out,
                                      b, n_heads, n_kv, psz, pmax,
                                      n_pool_pages, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (q and the output): 0 = float32, 1 = bfloat16.  quant: 0 = pools of
// q's dtype (pks / pvs unused), 1 = int8 pools with bf16 scale planes.
// Returns the launch's cudaError_t.
extern "C" int paged_attn(const void* q, const void* pk, const void* pv,
                          const void* pks, const void* pvs, const void* table,
                          const void* pos, void* out, int b, int n_heads,
                          int n_kv, int hd, int psz, int pmax,
                          int n_pool_pages, int dtype, int quant,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  if (dtype == 0 && !quant)
    return dispatch<float, float, false>(hd, q, pk, pv, pks, pvs, t, ps, out,
                                         b, n_heads, n_kv, psz, pmax,
                                         n_pool_pages, s);
  if (dtype == 1 && !quant)
    return dispatch<__nv_bfloat16, __nv_bfloat16, false>(
        hd, q, pk, pv, pks, pvs, t, ps, out, b, n_heads, n_kv, psz, pmax,
        n_pool_pages, s);
  if (dtype == 0 && quant)
    return dispatch<float, int8_t, true>(hd, q, pk, pv, pks, pvs, t, ps, out,
                                         b, n_heads, n_kv, psz, pmax,
                                         n_pool_pages, s);
  if (dtype == 1 && quant)
    return dispatch<__nv_bfloat16, int8_t, true>(
        hd, q, pk, pv, pks, pvs, t, ps, out, b, n_heads, n_kv, psz, pmax,
        n_pool_pages, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
