// Hopper (sm_90a) building blocks of a TMA + wgmma GEMM mainloop, shared by
// every kernel that multiplies bf16 tiles on the tensor cores (K1 and K3 in
// sisa_gemm.cu, K4 in grouped_gemm.cu, K5 in grouped_dw.cu, K6 in
// coexec.cu, K7 in moe_gemm.cu; K2 in paged_attn.cu takes only its
// programmatic-dependent-launch and shared-memory helpers): mbarrier and
// TMA (cp.async.bulk.tensor.2d / .3d loads, the 3-D store) wrappers, the
// shared-memory matrix descriptors of wgmma for the
// 128-byte swizzle, wgmma.mma_async m64nNk16 (f32 += bf16 * bf16) with its
// fence, commit and wait, the producer and consumer loops of a
// warp-specialised pipeline (a ring fixed at compile time for K1, K3, K4,
// K5 and K7; one whose slots a table sizes at run time for K6), and the
// host-side encoding of tensor maps.
// Included inside a source's anonymous namespace; the source includes
// <cuda.h> (CUtensorMap) and <mutex> before it.
//
// Layouts.  Every operand tile is 64 bf16 (128 bytes) deep along its
// contiguous axis, loaded by TMA with CU_TENSOR_MAP_SWIZZLE_128B into a
// 1024-byte aligned buffer, so one 8-row group is one 1024-byte swizzle
// atom:
// * K-major (K contiguous, e.g. row-major A, or B = W^T read as W): rows of
//   the tile are MN indices, 128 bytes of K each.  Descriptor: SBO = 1024
//   (next 8 rows), LBO unused; a k16 step adds 32 bytes to the start.
// * MN-major (MN contiguous, e.g. row-major B (K, N)): rows are K indices,
//   128 bytes (64 MN indices) each, one 8 KB chunk per 64 MN indices.
//   Descriptor: SBO = 1024 (next 8 K rows), LBO = 8192 (next 64-wide MN
//   chunk); a k16 step adds 2048 bytes.  wgmma reads it through its
//   transpose bit.
#pragma once

constexpr int kHgBK = 64;             // K per stage: one 128-byte swizzle row
constexpr int kHgChunk = 64 * 128;    // bytes of a 64 x 64 bf16 tile

__device__ __forceinline__ uint32_t hg_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(hg_smem(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          hg_smem(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   hg_smem(bar))
               : "memory");
}
// Spin until the phase of parity `parity` has completed.  A wait of more
// than about 10 s (2^34 cycles) can only be a broken pipeline: trap, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = hg_smem(bar);
  uint32_t done;
  long long t0 = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 < 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ---- TMA ------------------------------------------------------------------
// One box of `map` at (c0 along the contiguous axis, c1 along the rows) into
// shared memory; completion counts its bytes on `bar`.  Out-of-range parts of
// the box arrive as zeros (the ragged M, N and K edges).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(hg_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hg_smem(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
// The same from a 3-D map (c2: the outermost coordinate, e.g. the expert of
// a (G, rows, cols) weight stack: a box never reads a neighbouring expert's
// rows, it gets TMA's zero fill past the expert's own).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(hg_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hg_smem(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
// One box of shared memory at `src` to `map` at (c0, c1, c2); the parts of
// the box outside the tensor are not written.  The writes of the generic
// proxy to `src` must be fenced first (fence_proxy_async) and the box may
// be reused only after tma_store_wait_read.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(hg_smem(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until every committed store has read its shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Named barrier ID (1-15; 0 is __syncthreads) over THREADS threads.  The
// id is a constant, so ptxas reserves only the barriers a kernel names.
template <int ID, int THREADS>
__device__ __forceinline__ void named_bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- programmatic dependent launch ----------------------------------------
// A kernel launched with programmatic stream serialization may start while
// the previous kernel on its stream is still running; it waits here, before
// its first access to global memory, until that kernel has completed and
// its writes are visible.  A no-op for an ordinary launch.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// Lets the next kernel on the stream start its prologue (its own wait still
// holds it until this grid has completed).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---- wgmma descriptors ----------------------------------------------------
// Start address, leading and stride byte offsets in 16-byte units; layout
// type 1 = 128-byte swizzle (bits 62-63).
__device__ __forceinline__ uint64_t hg_desc(uint32_t saddr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// Descriptor of the kk-th k16 slice of a 64-deep tile at `base` (1024-byte
// aligned), K-major or MN-major (layouts above).
template <bool MN_MAJOR>
__device__ __forceinline__ uint64_t hg_tile_desc(uint32_t base, int kk) {
  return MN_MAJOR ? hg_desc(base + kk * 2048, kHgChunk, 1024)
                  : hg_desc(base + kk * 32, 16, 1024);
}

// ---- wgmma ----------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x 16] * B[16 x N]; TA / TB: 1 = the operand is MN-major.
// Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+8) and
// columns 8 c + 2 (t % 4) (+1): d[4c + 2h + j] is (row + 8h, col + j).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t da,
                                          uint64_t db) {
  if constexpr (N == 8) wgmma_m64n8k16<TA, TB>(d, da, db);
  else if constexpr (N == 16) wgmma_m64n16k16<TA, TB>(d, da, db);
  else if constexpr (N == 32) wgmma_m64n32k16<TA, TB>(d, da, db);
  else if constexpr (N == 64) wgmma_m64n64k16<TA, TB>(d, da, db);
  else if constexpr (N == 128) wgmma_m64n128k16<TA, TB>(d, da, db);
  else {
    static_assert(N == 256, "wgmma width");
    wgmma_m64n256k16<TA, TB>(d, da, db);
  }
}

// ---- the warp-specialised pipeline ------------------------------------------
// A CTA computes D[BP x BQ] = X[BP x K] * Y[K x BQ] over K steps [kb, ke) of
// 64, with NWG consumer warpgroups (64 rows of D each) and one producer warp.
// Stage s of the ring holds X's tile (BP x 64, BP * 128 bytes) then Y's
// (BQ * 128 bytes); full[s] counts the TMA bytes in, empty[s] one arrival
// per consumer warp out.
template <int NWG, int BQ, bool X_MN, bool Y_MN>
struct HgStage {
  static constexpr int kBP = NWG * 64;
  static constexpr int kX = kBP * 128;
  static constexpr int kY = BQ * 128;
  static constexpr int kBytes = kX + kY;
  static_assert(kX % 1024 == 0 && kY % 1024 == 0, "swizzle atoms");
  static_assert(!Y_MN || BQ % 64 == 0, "MN-major Y comes in 64-wide chunks");
};

// The producer: one thread issues every load.  X (rows p0.., MN-major: its
// map's contiguous axis is P) and Y (columns q0..) at K step i.
template <int NWG, int BQ, int STAGES, bool X_MN, bool Y_MN>
__device__ __forceinline__ void hg_produce(uint8_t* ring, uint64_t* full,
                                           uint64_t* empty,
                                           const CUtensorMap* tx,
                                           const CUtensorMap* ty, int p0,
                                           int q0, int kb, int ke) {
  using S = HgStage<NWG, BQ, X_MN, Y_MN>;
  tma_prefetch_map(tx);
  tma_prefetch_map(ty);
  for (int i = 0; i < ke - kb; ++i) {
    const int st = i % STAGES;
    if (i >= STAGES) mbar_wait(&empty[st], ((i / STAGES) + 1) & 1);
    mbar_expect_tx(&full[st], S::kBytes);
    uint8_t* xs = ring + st * S::kBytes;
    uint8_t* ys = xs + S::kX;
    const int kc = (kb + i) * kHgBK;
    if (X_MN) {
#pragma unroll
      for (int g = 0; g < NWG; ++g)
        tma_load_2d(xs + g * kHgChunk, tx, p0 + g * 64, kc, &full[st]);
    } else {
      tma_load_2d(xs, tx, kc, p0, &full[st]);
    }
    if (Y_MN) {
#pragma unroll
      for (int j = 0; j < BQ / 64; ++j)
        tma_load_2d(ys + j * kHgChunk, ty, q0 + j * 64, kc, &full[st]);
    } else {
      tma_load_2d(ys, ty, kc, q0, &full[st]);
    }
  }
}

// A consumer warpgroup `g`: four k16 wgmmas a stage into acc; one wgmma group
// stays in flight while the next stage is waited for, and the stage before
// it is handed back to the producer.
template <int NWG, int BQ, int STAGES, bool X_MN, bool Y_MN>
__device__ __forceinline__ void hg_consume(uint8_t* ring, uint64_t* full,
                                           uint64_t* empty, int g, int n_k,
                                           float (&acc)[BQ / 2]) {
  using S = HgStage<NWG, BQ, X_MN, Y_MN>;
  const bool signaller = threadIdx.x % 32 == 0;
  for (int i = 0; i < n_k; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const uint32_t xs = hg_smem(ring + st * S::kBytes) + g * kHgChunk;
    const uint32_t ys = hg_smem(ring + st * S::kBytes + S::kX);
    wgmma_fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHgBK / 16; ++kk)
      wgmma_k16<BQ, X_MN, Y_MN>(acc, hg_tile_desc<X_MN>(xs, kk),
                                hg_tile_desc<Y_MN>(ys, kk));
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_fence_acc(acc);
    if (i > 0 && signaller) mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  wgmma_wait<0>();
  wgmma_fence_acc(acc);
}

// The producer of a grouped GEMM: as hg_produce, but K runs over n_k steps
// of 64 from element k0 (K5 contracts over one group's rows, which start
// at any row tile), and with X_3D, X comes from a 3-D map at outermost
// coordinate xz (K4's weight stack, xz = the expert); with Y_3D, a K-major
// Y from a 3-D map at outermost coordinate yz (K7's (E, C, d) rows, yz =
// the expert: a box at the C edge gets zero fill).  The steps are the
// ring's steps it0 .. it0 + n_k - 1, so a persistent CTA walks its tiles
// through one ring without draining it between them.
template <int NWG, int BQ, int STAGES, bool X_MN, bool Y_MN, bool X_3D,
          bool Y_3D = false>
__device__ __forceinline__ void hg_produce_at(uint8_t* ring, uint64_t* full,
                                              uint64_t* empty,
                                              const CUtensorMap* tx,
                                              const CUtensorMap* ty, int p0,
                                              int q0, int k0, int n_k,
                                              int xz, int it0, int yz = 0) {
  using S = HgStage<NWG, BQ, X_MN, Y_MN>;
  static_assert(!(Y_MN && Y_3D), "a 3-D Y is K-major");
  auto load_x = [&](void* dst, int c0, int c1, uint64_t* bar) {
    if constexpr (X_3D) tma_load_3d(dst, tx, c0, c1, xz, bar);
    else tma_load_2d(dst, tx, c0, c1, bar);
  };
  for (int i = 0; i < n_k; ++i) {
    const int it = it0 + i;
    const int st = it % STAGES;
    if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) + 1) & 1);
    mbar_expect_tx(&full[st], S::kBytes);
    uint8_t* xs = ring + st * S::kBytes;
    uint8_t* ys = xs + S::kX;
    const int kc = k0 + i * kHgBK;
    if (X_MN) {
#pragma unroll
      for (int g = 0; g < NWG; ++g)
        load_x(xs + g * kHgChunk, p0 + g * 64, kc, &full[st]);
    } else {
      load_x(xs, kc, p0, &full[st]);
    }
    if (Y_MN) {
#pragma unroll
      for (int j = 0; j < BQ / 64; ++j)
        tma_load_2d(ys + j * kHgChunk, ty, q0 + j * 64, kc, &full[st]);
    } else if constexpr (Y_3D) {
      tma_load_3d(ys, ty, kc, q0, yz, &full[st]);
    } else {
      tma_load_2d(ys, ty, kc, q0, &full[st]);
    }
  }
}

// hg_consume over the ring's steps it0 .. it0 + n_k - 1 (hg_produce_at),
// with a hook: once step i has landed, and before any wgmma reads it, the
// warpgroup calls prep(i, its X tile) (K5 zeroes the rows of x that are
// not its group's there); prep ends with the proxy fence and a barrier of
// the warpgroup if it writes the tile.  Every stage is handed back,
// the last one too, so the next tile's steps can follow in the ring.
template <int NWG, int BQ, int STAGES, bool X_MN, bool Y_MN, class Prep>
__device__ __forceinline__ void hg_consume_prep(uint8_t* ring, uint64_t* full,
                                                uint64_t* empty, int g,
                                                int it0, int n_k,
                                                float (&acc)[BQ / 2],
                                                Prep prep) {
  using S = HgStage<NWG, BQ, X_MN, Y_MN>;
  const bool signaller = threadIdx.x % 32 == 0;
  for (int i = 0; i < n_k; ++i) {
    const int it = it0 + i;
    const int st = it % STAGES;
    mbar_wait(&full[st], (it / STAGES) & 1);
    prep(i, ring + st * S::kBytes + g * kHgChunk);
    const uint32_t xs = hg_smem(ring + st * S::kBytes) + g * kHgChunk;
    const uint32_t ys = hg_smem(ring + st * S::kBytes + S::kX);
    wgmma_fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHgBK / 16; ++kk)
      wgmma_k16<BQ, X_MN, Y_MN>(acc, hg_tile_desc<X_MN>(xs, kk),
                                hg_tile_desc<Y_MN>(ys, kk));
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_fence_acc(acc);
    if (i > 0 && signaller) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  wgmma_fence_acc(acc);
  if (n_k > 0 && signaller) mbar_arrive(&empty[(it0 + n_k - 1) % STAGES]);
}

// ---- a ring of runtime geometry (K6) ---------------------------------------
// One CTA a tile group (or its share of one) whose shape is read from a
// table: K steps k0 + [0, n_k) of 64 through `stages` slots of `sbytes`
// bytes.  A slot holds X as `chunks` MN-major 64 x 64 tiles (chunk j: the
// 64 columns from x0 + 64 j of plane xz of a 3-D map; K6's weight stack),
// then Y as one box of BQ K-major rows from y0 of a 2-D map whose boxes
// are BQ rows (K6's flat activations): 1 + chunks loads a slot.  A slot is
// a 1024-byte multiple, so every tile stays on its swizzle atoms.  The
// caller has prefetched both maps.
template <int BQ>
__device__ __forceinline__ void hg_produce_ring(
    uint8_t* ring, uint64_t* full, uint64_t* empty, const CUtensorMap* tx,
    const CUtensorMap* ty, int sbytes, int stages, int chunks, int x0,
    int xz, int y0, int k0, int n_k) {
  for (int i = 0; i < n_k; ++i) {
    const int st = i % stages, use = i / stages;
    if (use > 0) mbar_wait(&empty[st], (use + 1) & 1);
    mbar_expect_tx(&full[st], sbytes);
    uint8_t* xs = ring + st * sbytes;
    const int kc = (k0 + i) * kHgBK;
    for (int j = 0; j < chunks; ++j)
      tma_load_3d(xs + j * kHgChunk, tx, x0 + 64 * j, kc, xz, &full[st]);
    tma_load_2d(xs + chunks * kHgChunk, ty, kc, y0, &full[st]);
  }
}

// The consumer warpgroup of X chunk `chunk`: every step into acc (D = the
// chunk's 64 columns by BQ rows of Y).  A slot is handed back (one arrival
// a warp; empty[] counts the 4 * chunks consumer warps) as soon as the
// step's wgmma group has completed, so the consumers hold one slot and the
// rest stream: the groups are bound by bytes in flight, not by the tensor
// cores.
template <int BQ>
__device__ __forceinline__ void hg_consume_ring(uint8_t* ring, uint64_t* full,
                                                uint64_t* empty, int sbytes,
                                                int stages, int chunks,
                                                int chunk, int n_k,
                                                float (&acc)[BQ / 2]) {
  const bool signaller = threadIdx.x % 32 == 0;
  for (int i = 0; i < n_k; ++i) {
    const int st = i % stages;
    mbar_wait(&full[st], (i / stages) & 1);
    const uint32_t base = hg_smem(ring + st * sbytes);
    const uint32_t xs = base + chunk * kHgChunk;
    const uint32_t ys = base + chunks * kHgChunk;
    wgmma_fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHgBK / 16; ++kk)
      wgmma_k16<BQ, 1, 0>(acc, hg_tile_desc<true>(xs, kk),
                          hg_tile_desc<false>(ys, kk));
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_acc(acc);
    if (signaller) mbar_arrive(&empty[st]);
  }
}

// ---- tensor maps (host) -----------------------------------------------------
// bf16, 128-byte swizzle, boxes 64 wide along the contiguous axis (one
// swizzle row), encoded through the driver's entry point (no link against
// libcuda) on every call.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// (outer x inner) bf16 matrix at ptr with rows `stride` elements apart;
// boxes of box_rows x 64.
inline cudaError_t tensor_map(CUtensorMap* out, const void* ptr,
                              long long inner, long long outer,
                              long long stride, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A contiguous (planes x rows x inner) bf16 stack at ptr, e.g. an expert
// stack (G, K, N); boxes of box_rows x 64 within one plane.
inline cudaError_t tensor_map_3d(CUtensorMap* out, const void* ptr,
                                 long long inner, long long rows,
                                 long long planes, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)(inner * rows) * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Raises a kernel's dynamic shared memory limit to `bytes`, once per device
// (`raised`: one bit a device, kept by the caller per instantiation).
template <class Kernel>
inline cudaError_t hg_raise_smem(Kernel kernel, int bytes,
                                 unsigned long long& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(raised >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    raised |= 1ull << dev;
  }
  return cudaSuccess;
}
