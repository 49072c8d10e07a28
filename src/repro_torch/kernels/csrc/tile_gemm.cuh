// One output tile of A @ B per block on the CUDA cores, for the kernels
// that write whole tiles without K1's mode tables: K3's CUDA-core route
// (split-K partials, sisa_gemm.cu: float32, and bf16 shapes TMA cannot
// read), K6's float32 body (co-execution, coexec.cu) and K7's float32 body
// (the capacity-padded MoE GEMM, moe_gemm.cu).  Their bf16 bodies run on
// hopper_gemm.cuh's TMA + wgmma mainloop.  Included inside each source's
// anonymous namespace, after gemm_tiles.cuh, whose to_f32 / from_f32 it
// uses.
//
// A block computes acc[r][c] = sum_k A[r][k] * B[k][c] for r < BM,
// c < kTileN, k < kdepth, with an f32 accumulator (exact float32: no
// TF32), and hands every element to an epilogue functor epi(r, c, acc).
// `a` points at the tile's first row (row stride lda), `b` at its first
// column (row stride ldb); rows of A at or past `rows`, columns of B at or
// past `cols` and K past `kdepth` are zero-filled, never read, so ragged
// edges need no padding.  The K loop runs in steps of kTileK in one fixed
// order, so a tile's result depends on its own operands only: where the
// tile sits in a grid, or which other tiles share the launch, cannot
// change a bit of it.  What bounds it is the CUDA cores' f32 rate (67
// TFLOP/s on an H100 SXM) and its shared-memory traffic; it is the f32
// reference route, not a fast one.  The tile height BM is 16, 32, 64 or
// 128, chosen by the wrappers' choose_block_config; the width and depth
// are fixed here and the Python wrappers hold the same two numbers
// (sisa_gemm.TILE_COLS / TILE_K).
#pragma once

constexpr int kTileN = 64;  // tile width
constexpr int kTileK = 32;  // K step

// The CUDA-core body: each of kFpThreads threads owns a TM x TN register
// tile of the BM x kTileN output.
template <int BM>
struct FpLayout {
  static constexpr int TM = BM / 16, TN = 4;
};
constexpr int kFpThreads = 16 * (kTileN / 4);

template <typename T, int BM, class Epi>
__device__ __forceinline__ void fp_tile(const T* __restrict__ a, long long lda,
                                        int rows, const T* __restrict__ b,
                                        long long ldb, int cols, int kdepth,
                                        const Epi& epi) {
  constexpr int BN = kTileN, BK = kTileK;
  constexpr int TM = FpLayout<BM>::TM, TN = FpLayout<BM>::TN;
  constexpr int RT = BM / TM;  // thread rows
  constexpr int CT = BN / TN;  // thread columns
  constexpr int NT = RT * CT;
  static_assert(NT == kFpThreads, "threads");
  // +1 pads keep the transposed stores free of bank conflicts.
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

  for (int k0 = 0; k0 < kdepth; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int gk = k0 + kk;
      as[kk][r] = (r < rows && gk < kdepth)
                      ? to_f32(a[(long long)r * lda + gk]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, cc = e % BN;
      const int gk = k0 + kk;
      bs[kk][cc] = (gk < kdepth && cc < cols)
                       ? to_f32(b[(long long)gk * ldb + cc]) : 0.f;
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
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) epi(ty + i * RT, tx + j * CT, acc[i][j]);
}

// Epilogues.  StoreTile writes the elements inside (rows, cols) of a
// clipped tile; StoreMasked writes every row of a tile that lies wholly
// inside its buffer, rows at or past `live` as exact zeros.
template <typename T>
struct StoreTile {
  T* out;
  long long ldo;
  int rows, cols;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    if (r < rows && c < cols) out[(long long)r * ldo + c] = from_f32<T>(v);
  }
};

template <typename T>
struct StoreMasked {
  T* out;
  long long ldo;
  int live, cols;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    if (c < cols) out[(long long)r * ldo + c] = from_f32<T>(r < live ? v : 0.f);
  }
};
