// One output tile of A @ B per block, for the kernels that write whole
// tiles without K1's mode tables: K3 (split-K partials, sisa_gemm.cu), K6
// (co-execution, coexec.cu) and the CUDA-core body of K7 (the
// capacity-padded MoE GEMM, moe_gemm.cu).  Included inside each source's
// anonymous namespace, after
// gemm_tiles.cuh, whose helpers (cp.async, ldmatrix, mma.sync, TcStage,
// to_f32 / from_f32) it uses.
//
// A block computes acc[r][c] = sum_k A[r][k] * B[k][c] for r < BM,
// c < kTileN, k < kdepth, with an f32 accumulator, and hands every element
// to an epilogue functor epi(r, c, acc).  `a` points at the tile's first
// row (row stride lda), `b` at its first column (row stride ldb); rows of A
// at or past `rows`, columns of B at or past `cols` and K past `kdepth` are
// zero-filled, never read, so ragged edges need no padding.  The K loop
// runs in steps of kTileK in one fixed order, so a tile's result depends on
// its own operands only: where the tile sits in a grid, or which other
// tiles share the launch, cannot change a bit of it.
//
// Two bodies, as in K1: bf16 on the tensor cores (mma.sync m16n8k16 fed by
// a cp.async pipeline; needs 16-byte aligned rows, which the callers check)
// and f32 (and unaligned bf16) on the CUDA cores, so f32 stays f32.  The
// tile height BM is 16, 32, 64 or 128, chosen by the wrappers'
// choose_block_config; the width and depth are fixed here and the Python
// wrappers hold the same two numbers (sisa_gemm.TILE_COLS / TILE_K).
#pragma once

constexpr int kTileN = 64;  // tile width
constexpr int kTileK = 32;  // K step

// Warps of the tensor-core body per tile height: WM x WN over the tile and
// WK deep over each K step (WK > 1: partial sums added in shared memory).
template <int BM>
struct TcLayout;
template <>
struct TcLayout<16> {
  static constexpr int WM = 1, WN = 2, WK = 2, STAGES = 4;
};
template <>
struct TcLayout<32> {
  static constexpr int WM = 2, WN = 2, WK = 1, STAGES = 4;
};
template <>
struct TcLayout<64> {
  static constexpr int WM = 2, WN = 2, WK = 1, STAGES = 3;
};
template <>
struct TcLayout<128> {
  static constexpr int WM = 4, WN = 2, WK = 1, STAGES = 3;
};

template <int BM>
struct TcTile {
  using L = TcLayout<BM>;
  static constexpr int kThreads = L::WM * L::WN * L::WK * 32;
  static constexpr int kStageBytes =
      TcStage<BM, kTileN, kTileK, false>::kElems * (int)sizeof(__nv_bfloat16);
  static constexpr int kRedBytes =
      L::WK > 1 ? L::WK * BM * kTileN * (int)sizeof(float) : 0;
  // Dynamic shared memory of one block; under 48 KB at every height.
  static constexpr int kSmemBytes = L::STAGES * kStageBytes > kRedBytes
                                        ? L::STAGES * kStageBytes
                                        : kRedBytes;
  static_assert(kSmemBytes <= 48 * 1024, "needs the opt-in attribute");
};

template <int BM, class Epi>
__device__ __forceinline__ void tc_tile(const __nv_bfloat16* __restrict__ a,
                                        long long lda, int rows,
                                        const __nv_bfloat16* __restrict__ b,
                                        long long ldb, int cols, int kdepth,
                                        uint4* smem_raw, const Epi& epi) {
  using L = TcLayout<BM>;
  constexpr int BN = kTileN, BK = kTileK;
  constexpr int WM = L::WM, WN = L::WN, WK = L::WK, STAGES = L::STAGES;
  using Stage = TcStage<BM, BN, BK, false>;
  constexpr int NT = WM * WN * WK * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  constexpr int FM = WTM / 16, FN = WTN / 8;   // mma fragments per warp
  constexpr int KW = BK / WK;                  // K columns per warp per step
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && KW % 16 == 0, "tile");

  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % WM;
  const int wn = (warp / WM) % WN;
  const int wk = warp / (WM * WN);
  const int ktiles = (kdepth + BK - 1) / BK;

  auto load_tile = [&](int stage, int kt) {
    __nv_bfloat16* as = smem + stage * Stage::kElems;
    __nv_bfloat16* bs = as + Stage::kA;
    const int k0 = kt * BK;
    for (int e = tid; e < BM * (BK / 8); e += NT) {
      const int r = e / (BK / 8), kc = (e % (BK / 8)) * 8;
      const int gk = k0 + kc;
      const int nb = (r < rows) ? 2 * max(0, min(8, kdepth - gk)) : 0;
      cp_async16(as + r * (BK + kPad) + kc,
                 nb ? a + (long long)r * lda + gk : a, nb);
    }
    for (int e = tid; e < BK * (BN / 8); e += NT) {
      const int r = e / (BN / 8), nc = (e % (BN / 8)) * 8;
      const int gk = k0 + r;
      const int nb = (gk < kdepth) ? 2 * max(0, min(8, cols - nc)) : 0;
      cp_async16(bs + r * (BN + kPad) + nc,
                 nb ? b + (long long)gk * ldb + nc : b, nb);
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
    __syncthreads();  // step kt landed; every warp is done with step kt-1
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
      for (int j = 0; j < FN; ++j)
        ldmatrix_x2_trans(bf[j], bs + (kk + lane % 16) * (BN + kPad) +
                                     wn * WTN + j * 8);
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
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WK; ++w) sum += red[(w * BM + r) * BN + cc];
      epi(r, cc, sum);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        epi(wm * WTM + i * 16 + g + (q / 2) * 8, wn * WTN + j * 8 + t2 + q % 2,
            acc[i][j][q]);
}

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
