// K1 and K4: INT8 and INT4 weight-only dequant-matmuls for Hopper (sm_90a).
//
// K1 replaces the Pallas kernel of block_transformer_tpu/ops/dequant_matmul.py
// (body _int8_kernel :67, int8_matmul_stacked :86 with its pallas_call at
// :117, and the wrapper int8_matmul :133):
//
//   out[M, N] = cast_T( (x[M, K] @ float(w_q[K, N])) * scale[N] )
//
// K4 replaces the same file's _int4_kernel :152 / int4_matmul_stacked :181
// (pallas_call :245) and int4_matmul :261: split-half INT4 with group-wise
// scales,
//
//   out[M, N] = cast_T( x[:, :K/2] @ (lo * s_lo) + x[:, K/2:] @ (hi * s_hi) )
//
// where byte row i of w_p [K/2, N] holds row i in its low nibble and row
// i + K/2 in its high one (both sign-extended as ((b & 0xF) ^ 8) - 8), and
// unpacked row r takes the scale of group r / gs from scale [G, N] (gs = K/G
// divides K/2, or G = 1). The weights are one layer of a stacked [L, K, N]
// (or [L, K/2, N]) array: the caller passes the layer's base pointer, so no
// weight slice is copied. Both accumulate in float32.
//
// What bounds them on the H100. At decode (M = the batch, <= 16 rows) K1
// moves K*N weight bytes and K4 half that against 2*M*K*N operations, far
// below the card's ~295 bf16 operations per byte: bound by bytes. At
// prefill and admission (M in the thousands) both are bound by operations,
// which only the tensor cores deliver (989 TFLOP/s bf16 against 67 float32).
//
// Three routes, chosen in Python (kernels/dequant_matmul.py, plan()) and
// passed to the C entries as a code:
//
// * The tensor-core route "tc" (tc_matmul_kernel), for bf16 x whose K (K1)
//   or K/2 (K4) is a multiple of 32 and whose N and base pointers meet the
//   16-byte copy alignment: every shape of the main path. One template,
//   parameterised by the weight format and the tile, answers the four
//   limits of the first, CUDA-core version:
//   1. Products run on the tensor cores: mma.sync m16n8k16, bf16 in, float32
//      accumulate, as the Pallas kernel casts the weight tile to x's dtype
//      and dots with a float32 accumulator. The x tile is read with
//      ldmatrix, the widened weight tile, kept [K, N] as in the parameter
//      tree, with ldmatrix.trans. Shared-memory rows are padded by 16 bytes,
//      so both are free of bank conflicts.
//   2. Weights are widened into bf16, not float32: int8 -> bf16 is exact and
//      K1's per-channel scale is applied to the float32 sums in the
//      epilogue; K4 widens each nibble times its row's group scale into bf16
//      (one bf16 rounding of each scaled weight; the Pallas kernel scales
//      float32 partial products instead), so any gs dividing K/2, and G = 1,
//      works without tying tiles to groups; when a group holds whole K steps
//      the decode tile keeps the scales in registers until the group
//      changes, and the larger tiles load them once a step. The widening is
//      byte permutes and float adds on a 2^23 bias, not the quarter-rate
//      integer-to-float conversions.
//   3. Bytes in flight: a ring of STAGES shared-memory stages, each the raw
//      int8 / packed weight tile and the bf16 x tile (both x planes for K4),
//      filled with 16-byte cp.async.cg copies (zero-filled past M and N) and
//      awaited with cp.async.wait_group, so the next STAGES - 1 tiles are in
//      flight while the current one is widened and multiplied; the
//      widening of step k + 1 overlaps the products of step k (two sets of
//      bf16 planes, one barrier a step). Tiles by regime, all 8 warps and
//      128 columns (128-byte weight rows): 16 x 128 x 32 with a 6-deep
//      ring at decode (M <= 16), 64 x 128 x 32 for 16 < M <= 64 (the token
//      decoder's M = 32 prefix steps), 128 x 128 x 32 at prefill; the
//      launch bounds hold each to at most 128 registers a thread.
//   4. When the grid has fewer than two blocks per SM, K is split over
//      gridDim.z in whole 32-row steps; each split writes float32 partial
//      sums to a workspace of splits * M * N floats, and the tile's last
//      split to arrive (an atomic counter per tile) adds them up in split
//      order, scales (K1) and casts: no second launch.
//
// * The TF32 route "tf32x2" (tf32_matmul_kernel), for float32 x in the same
//   envelope (K4: a group size that is a multiple of the 32-row K step, or
//   G = 1): every linear of the float32 scoring forward, which is bound by
//   operations (the LM head at M = 16,384: 3.4e12 of them). The CUDA cores
//   give float32 67 TFLOP/s; the tensor cores give TF32 (10 mantissa bits)
//   495. INT8 weights (|q| <= 127) and unscaled INT4 nibbles are exact in
//   TF32, so only x is split, hi = tf32(x), lo = tf32(x - hi) (rounded as
//   cvt.rna rounds, at the fragment load), and x.w = x_lo w + x_hi w: two
//   mma.sync m16n8k8 TF32 passes where 3xTF32 takes three; each product has
//   at most 11 + 8 significant bits, exact in float32, and what is lost is
//   x's last ~2^-22 and the tensor cores' accumulation. Those truncate their
//   float32 sums (K3 found a long chain missing float32's limit), so every
//   chain is short: each 32-row step's products (K1), or each plane's
//   products of a step (K4), sum in a chain that starts from zero, and the
//   chain is added to the running float32 sum in a rounded add; K4 first
//   multiplies a plane's chain by its group's scale (the step lies in one
//   group), as the Pallas kernel scales each tile's partial product. K1's
//   channel scale, and K4's when G = 1, stay in the epilogue. The ring,
//   tiles, split-K and last-arrival merge are the tc route's; the stages
//   hold the float32 x tile(s), the raw weight bytes and (K4 with groups)
//   the step's two scale rows, padded so that the fragment loads are free
//   of bank conflicts. A lane's B fragment takes the weights of NT adjacent
//   columns from one 16- or 32-bit load: its column j of fragment nt is
//   column NT * j + nt of the warp's strip, so its accumulators hold 2 NT
//   adjacent columns of each of its rows, stored with 16-byte stores.
//
// * The CUDA-core route "fma" (int8_matmul_kernel / int4_matmul_kernel),
//   for what the other two do not take (ragged or unaligned K and N,
//   float16, K4 groups of fewer than 32 rows): BM x 64 output tiles
//   walking K in steps of 32, the int8 tile widened to float32 in shared
//   memory, float32 FMAs, the splits added up by a second small launch.
//   Ragged M, N and K edges are masked in the kernel; nothing is padded.

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace bt;   // the PTX helpers of mma.cuh

// ---------------------------------------------------------------------------
// CUDA-core route (ragged or unaligned shapes)

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

union Bytes8 {
  uint2 u;
  int8_t b[8];
};

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ out,
                   float* __restrict__ partial, int M, int K, int N,
                   int k_per_split) {
  constexpr int BM = 16 * TM;
  constexpr int XPT = BM * BK / THREADS;   // x elements loaded per thread
  __shared__ float As[BK][BM + 1];         // x tile, transposed: As[k][m]
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool w_vec = (N % 8 == 0) &&
                     (reinterpret_cast<uintptr_t>(w) % 8 == 0);
  const int wr = tid / 8, wc = (tid % 8) * 8;   // 8 weight bytes per thread

  float xr[XPT];
  Bytes8 wreg;

  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      xr[j] = (gm < M && gk < k_end) ? bt::to_f32(x[(size_t)gm * K + gk])
                                     : 0.f;
    }
    const int gk = k0 + wr, gn = n0 + wc;
    if (w_vec && gk < k_end && gn < N) {
      wreg.u = *reinterpret_cast<const uint2*>(w + (size_t)gk * N + gn);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wreg.b[j] = (gk < k_end && gn + j < N) ? w[(size_t)gk * N + gn + j]
                                               : (int8_t)0;
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (k_begin < k_end) load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = tid + j * THREADS;
      As[i % BK][i / BK] = xr[j];
    }
    *reinterpret_cast<float4*>(&Bs[wr][wc]) =
        make_float4(wreg.b[0], wreg.b[1], wreg.b[2], wreg.b[3]);
    *reinterpret_cast<float4*>(&Bs[wr][wc + 4]) =
        make_float4(wreg.b[4], wreg.b[5], wreg.b[6], wreg.b[7]);
    __syncthreads();
    if (k0 + BK < k_end) load(k0 + BK);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = As[kk][ty * TM + i];
        acc[i][0] += a * b.x;
        acc[i][1] += a * b.y;
        acc[i][2] += a * b.z;
        acc[i][3] += a * b.w;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      if (partial != nullptr)
        partial[((size_t)blockIdx.z * M + gm) * N + gn] = acc[i][j];
      else
        out[(size_t)gm * N + gn] = bt::from_f32<T>(acc[i][j] * scale[gn]);
    }
  }
}

// Adds the splits' partial sums, scales them per column (K1; K4 passes no
// scale, its partials are scaled already) and casts. Both routes use it.
template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ scale,
                                     T* __restrict__ out, int M, int N,
                                     int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[z * total + i];
  out[i] = bt::from_f32<T>(scale != nullptr ? s * scale[i % N] : s);
}

// Sign-extended nibbles of a packed byte: (u << 28) >> 28 and (u << 24) >> 28.
__device__ __forceinline__ float lo_nibble(int8_t b) {
  return (float)((((int)b & 0xF) ^ 8) - 8);
}
__device__ __forceinline__ float hi_nibble(int8_t b) {
  return (float)(((((int)b >> 4) & 0xF) ^ 8) - 8);
}

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ out,
                   float* __restrict__ partial, int M, int Kh, int N, int gs,
                   int k_per_split) {
  constexpr int BM = 16 * TM;
  constexpr int XPT = BM * BK / THREADS;   // x elements per plane per thread
  __shared__ float As[2][BK][BM + 1];      // x tiles (lo, hi), As[p][k][m]
  __shared__ __align__(16) float Bs[2][BK][BN + 4];   // scaled weights

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int K = 2 * Kh;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;   // packed rows
  const int k_end = min(Kh, k_begin + k_per_split);
  const bool vec = (N % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(scale) % 16 == 0);
  const int wr = tid / 8, wc = (tid % 8) * 8;   // 8 weight bytes per thread

  float xr[2][XPT];
  Bytes8 wreg;
  float sr[2][8];                                 // the 8 columns' scales

  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gm < M && gk < k_end;
      const T* row = x + (size_t)gm * K + gk;
      xr[0][j] = ok ? bt::to_f32(row[0]) : 0.f;
      xr[1][j] = ok ? bt::to_f32(row[Kh]) : 0.f;
    }
    const int gk = k0 + wr, gn = n0 + wc;
    const bool in_k = gk < k_end;
    const float* s_lo = scale + (size_t)(gk / gs) * N + gn;
    const float* s_hi = scale + (size_t)((Kh + gk) / gs) * N + gn;
    if (vec && in_k && gn < N) {
      wreg.u = *reinterpret_cast<const uint2*>(w + (size_t)gk * N + gn);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(s_lo + 4 * h);
        const float4 b = *reinterpret_cast<const float4*>(s_hi + 4 * h);
        sr[0][4 * h] = a.x; sr[0][4 * h + 1] = a.y;
        sr[0][4 * h + 2] = a.z; sr[0][4 * h + 3] = a.w;
        sr[1][4 * h] = b.x; sr[1][4 * h + 1] = b.y;
        sr[1][4 * h + 2] = b.z; sr[1][4 * h + 3] = b.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok = in_k && gn + j < N;
        wreg.b[j] = ok ? w[(size_t)gk * N + gn + j] : (int8_t)0;
        sr[0][j] = ok ? s_lo[j] : 0.f;
        sr[1][j] = ok ? s_hi[j] : 0.f;
      }
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (k_begin < k_end) load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = tid + j * THREADS;
      As[0][i % BK][i / BK] = xr[0][j];
      As[1][i % BK][i / BK] = xr[1][j];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 4 * h;
      *reinterpret_cast<float4*>(&Bs[0][wr][wc + j]) = make_float4(
          lo_nibble(wreg.b[j]) * sr[0][j],
          lo_nibble(wreg.b[j + 1]) * sr[0][j + 1],
          lo_nibble(wreg.b[j + 2]) * sr[0][j + 2],
          lo_nibble(wreg.b[j + 3]) * sr[0][j + 3]);
      *reinterpret_cast<float4*>(&Bs[1][wr][wc + j]) = make_float4(
          hi_nibble(wreg.b[j]) * sr[1][j],
          hi_nibble(wreg.b[j + 1]) * sr[1][j + 1],
          hi_nibble(wreg.b[j + 2]) * sr[1][j + 2],
          hi_nibble(wreg.b[j + 3]) * sr[1][j + 3]);
    }
    __syncthreads();
    if (k0 + BK < k_end) load(k0 + BK);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[0][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[1][kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a0 = As[0][kk][ty * TM + i];
        const float a1 = As[1][kk][ty * TM + i];
        acc[i][0] += a0 * b0.x + a1 * b1.x;
        acc[i][1] += a0 * b0.y + a1 * b1.y;
        acc[i][2] += a0 * b0.z + a1 * b1.z;
        acc[i][3] += a0 * b0.w + a1 * b1.w;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      if (partial != nullptr)
        partial[((size_t)blockIdx.z * M + gm) * N + gn] = acc[i][j];
      else
        out[(size_t)gm * N + gn] = bt::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
void reduce_splits(const float* partial, const float* scale, T* out, int M,
                   int N, int splits, cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  splitk_reduce_kernel<T><<<blocks, threads, 0, stream>>>(partial, scale, out,
                                                          M, N, splits);
}

template <typename T>
void launch_fma(const void* x, const void* w, const void* scale, void* out,
                void* workspace, int M, int K, int N, int splits,
                int k_per_split, cudaStream_t stream) {
  float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  const dim3 block(THREADS);
  const int gx = (N + BN - 1) / BN;
  if (M <= 16) {
    const dim3 grid(gx, (M + 15) / 16, splits);
    int8_matmul_kernel<T, 1><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<T*>(out), partial, M, K,
        N, k_per_split);
  } else {
    const dim3 grid(gx, (M + 63) / 64, splits);
    int8_matmul_kernel<T, 4><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<T*>(out), partial, M, K,
        N, k_per_split);
  }
  if (splits > 1)
    reduce_splits<T>(partial, static_cast<const float*>(scale),
                     static_cast<T*>(out), M, N, splits, stream);
}

template <typename T>
void launch4_fma(const void* x, const void* w, const void* scale, void* out,
                 void* workspace, int M, int Kh, int N, int gs, int splits,
                 int k_per_split, cudaStream_t stream) {
  float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  const dim3 block(THREADS);
  const int gx = (N + BN - 1) / BN;
  const T* xt = static_cast<const T*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  const float* st = static_cast<const float*>(scale);
  if (M <= 16)
    int4_matmul_kernel<T, 1><<<dim3(gx, (M + 15) / 16, splits), block, 0,
                                 stream>>>(xt, wt, st, static_cast<T*>(out),
                                           partial, M, Kh, N, gs, k_per_split);
  else
    int4_matmul_kernel<T, 4><<<dim3(gx, (M + 63) / 64, splits), block, 0,
                                 stream>>>(xt, wt, st, static_cast<T*>(out),
                                           partial, M, Kh, N, gs, k_per_split);
  if (splits > 1)
    reduce_splits<T>(partial, nullptr, static_cast<T*>(out), M, N, splits,
                     stream);
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16 x, K or K/2 a multiple of 32, N a multiple of 16,
// 16-byte aligned base pointers)

using bf16 = __nv_bfloat16;

// One tile shape of the tensor-core route. Each of the (BM/WM) x (BN/WN)
// warps owns a WM x WN piece of the BM x BN output tile; K advances BK rows
// (K1) or packed rows (K4) a stage.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_,
          int MIN_BLOCKS_, bool INT4_>
struct TcTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr bool INT4 = INT4_;
  using X = bf16;                           // x and out
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * (BM / WM) * WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr bool SMALL = MT * NT <= 2;   // the decode tile's warps
  // registers to spare for K4's scales across steps: the decode tile only
  static constexpr bool HOIST = SMALL;
  static constexpr int P = INT4 ? 2 : 1;    // x planes and widened planes
  static constexpr int XLD = BK + 8;        // bf16 row pitch: +16 bytes
  static constexpr int SLD = BN;            // a stage's weight row pitch
  static constexpr int WLD = BN + 8;        // a widened plane's row pitch
  static constexpr int X_BYTES = P * BM * XLD * 2;
  static constexpr int W_BYTES = BK * BN;   // raw int8 / packed bytes
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int WIDE_BYTES = P * BK * WLD * 2;   // one widened set
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * WIDE_BYTES;
  static_assert(NT % 2 == 0 && BK % 16 == 0 && BN % 16 == 0, "tile shape");
  static_assert(STAGES >= 3, "the ring runs two steps ahead of the products");
  static_assert(X_BYTES % 16 == 0 && W_BYTES % 16 == 0, "16-byte stages");
};

// The pieces that the tensor-core routes share. A tile shape C gives X (x's
// and out's type), the tile (BM, BN, BK), THREADS, P (x planes: 2 for K4)
// and a stage's row pitches XLD (x values) and SLD (weight bytes).

// Issue the 16-byte copies of the K step at k0 into one stage of the ring:
// C::P planes of BM rows of BK x values (rows past M zero-filled; plane p
// starts at x's column p * Kd) into xs, and BK rows of BN weight bytes
// (columns past N zero-filled) into ws.
template <class C>
__device__ __forceinline__ void load_step(typename C::X* xs, void* ws,
                                          const typename C::X* __restrict__ x,
                                          const int8_t* __restrict__ w,
                                          int M, int Kd, int N, int m0, int n0,
                                          int k0) {
  constexpr int V = 16 / sizeof(typename C::X);   // values a copy
  constexpr int XC = C::BK / V;                   // copies per x row
  const int xk = C::INT4 ? 2 * Kd : Kd;
#pragma unroll
  for (int c = threadIdx.x; c < C::P * C::BM * XC; c += C::THREADS) {
    const int p = c / (C::BM * XC), r = (c / XC) % C::BM, col = (c % XC) * V;
    const bool ok = m0 + r < M;
    cp_async16(smem_u32(xs + (p * C::BM + r) * C::XLD + col),
               x + (size_t)(ok ? m0 + r : 0) * xk + p * Kd + k0 + col, ok);
  }
  constexpr int WC = C::BN / 16;
#pragma unroll
  for (int c = threadIdx.x; c < C::BK * WC; c += C::THREADS) {
    const int r = c / WC, col = (c % WC) * 16;
    const bool ok = n0 + col < N;
    cp_async16(smem_u32(static_cast<unsigned char*>(ws) + r * C::SLD + col),
               w + (size_t)(k0 + r) * N + (ok ? n0 + col : 0), ok);
  }
}

// Start the ring: load(s) issues step s's copies into stage s, for the first
// STAGES - 1 steps, one commit group a stage, empty or not.
template <int STAGES, class Load>
__device__ __forceinline__ void fill_ring(int nk, Load&& load) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// K split over gridDim.z blocks: each publishes its sums acc into its plane
// of partial ([splits, M, N] float32; publish(plane) stores them there), and
// the tile's last split to arrive (a counter per output tile, left at zero
// for the next launch) clears acc and adds every plane to it in split order
// (add(plane), unrolled UNROLL times). Returns whether this block is that
// last one, which then writes the output.
template <int UNROLL, int MT, int NT, class Publish, class Add>
__device__ __forceinline__ bool merge_splits(float (&acc)[MT][NT][4],
                                             float* partial, int* counters,
                                             size_t plane, Publish&& publish,
                                             Add&& add) {
  publish(partial + blockIdx.z * plane);
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) {
    int* ctr = counters + blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(ctr, 1) == (int)gridDim.z - 1;
    if (last) *ctr = 0;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  zero(acc);
#pragma unroll (UNROLL)
  for (int z = 0; z < (int)gridDim.z; ++z) add(partial + z * plane);
  return true;
}

// x [M, XK] bf16 with XK = K (K1) or 2*Kd (K4); w [Kd, N] int8 (K1: the
// weights, K4: packed bytes); scale [N] (K1) or [G, N] (K4); out [M, N]
// bf16. With gridDim.z > 1 splits, partial holds [splits, M, N] float32
// sums and counters one int per output tile, zero on entry and on exit.
// Kd and k_per_split are multiples of C::BK.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
tc_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, bf16* __restrict__ out,
                 float* __restrict__ partial, int* __restrict__ counters,
                 int M, int Kd, int N, int gs, int k_per_split) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, P = C::P;
  constexpr int XLD = C::XLD, WLD = C::WLD, STAGES = C::STAGES;
  constexpr int THREADS = C::THREADS, MT = C::MT, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int nk = (min(Kd, k_begin + k_per_split) - k_begin) / BK;

  auto wide = [&](int kt) {              // [P][BK][WLD] bf16, two sets
    return reinterpret_cast<bf16*>(smem + STAGES * C::STAGE_BYTES +
                                   (kt & 1) * C::WIDE_BYTES);
  };
  auto stage_x = [&](int s) {            // [P][BM][XLD] bf16
    return reinterpret_cast<bf16*>(smem + s * C::STAGE_BYTES);
  };
  auto stage_w = [&](int s) {            // [BK][BN] int8
    return reinterpret_cast<int8_t*>(smem + s * C::STAGE_BYTES + C::X_BYTES);
  };

  auto load = [&](int s, int k0) {       // k-step k0 into stage s
    load_step<C>(stage_x(s), stage_w(s), x, w, M, Kd, N, m0, n0, k0);
  };

  // K4's group scales for this thread's 8 columns (the same in each of its
  // widening units, THREADS being a multiple of BN / 8). When a group holds
  // whole K steps (gs % BK == 0), a step's packed rows share one low and
  // one high group: the decode tile (C::HOIST) keeps both in registers
  // until the group changes; the larger tiles, whose registers hold the
  // accumulators, give each thread one plane and load its scales once a
  // step. Otherwise each row loads its own.
  constexpr int UC = BN / 8;             // widening units (8 bytes) a row
  static_assert(THREADS % UC == 0, "a thread widens one column group");
  const int ucol = (tid % UC) * 8;
  const bool step_groups = C::INT4 && C::HOIST && gs % BK == 0;
  float s_lo[8], s_hi[8];
  int g_lo = -1, g_hi = -1;
  auto load_scales = [&](float (&dst)[8], int group) {
    if (n0 + ucol < N) {
      const float4* src = reinterpret_cast<const float4*>(
          scale + (size_t)group * N + n0 + ucol);
      const float4 a = __ldg(src), b = __ldg(src + 1);
      dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
      dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = 0.f;
    }
  };

  // Widen step kt's weights (stage kt % STAGES) into the bf16 planes
  // wide(kt), 8 bytes a thread at a time.
  auto widen = [&](int kt) {
    const int s = kt % STAGES, k0 = k_begin + kt * BK;
    bf16* dst = wide(kt);
    if constexpr (C::INT4 && !C::HOIST) {
      // threads [0, THREADS/2) widen the low nibbles, the rest the high
      // ones, each its column group over every ROWS-th row of the step
      constexpr int ROWS = THREADS / 2 / UC;
      static_assert(THREADS % (2 * UC) == 0 && BK % ROWS == 0, "mapping");
      const int p = tid / (THREADS / 2), r0 = (tid % (THREADS / 2)) / UC;
      auto row = [&](int r, const float (&sc)[8]) {
        const uint2 raw =
            *reinterpret_cast<const uint2*>(stage_w(s) + r * BN + ucol);
        const uint32_t word[2] = {raw.x, raw.y};
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t u =
              ((word[j / 2] >> (4 * p)) & 0x0F0F0F0Fu) ^ 0x08080808u;
          const int b0 = 2 * (j % 2);
          v[j] = pack_bf16x2(biased_byte<8>(u, b0) * sc[2 * j],
                             biased_byte<8>(u, b0 + 1) * sc[2 * j + 1]);
        }
        *reinterpret_cast<uint4*>(dst + (p * BK + r) * WLD + ucol) =
            make_uint4(v[0], v[1], v[2], v[3]);
      };
      float sc[8];
      if (gs % BK == 0) {                // the step's rows share a group
        load_scales(sc, (p * Kd + k0) / gs);
#pragma unroll
        for (int i = 0; i < BK / ROWS; ++i) row(r0 + i * ROWS, sc);
      } else {
#pragma unroll 1
        for (int i = 0; i < BK / ROWS; ++i) {
          load_scales(sc, (p * Kd + k0 + r0 + i * ROWS) / gs);
          row(r0 + i * ROWS, sc);
        }
      }
      return;
    }
    if (step_groups) {
      if (k0 / gs != g_lo) load_scales(s_lo, g_lo = k0 / gs);
      if ((Kd + k0) / gs != g_hi) load_scales(s_hi, g_hi = (Kd + k0) / gs);
    }
#pragma unroll
    for (int c = tid; c < BK * UC; c += THREADS) {
      const int r = c / UC;
      const uint2 raw =
          *reinterpret_cast<const uint2*>(stage_w(s) + r * BN + ucol);
      const uint32_t word[2] = {raw.x, raw.y};
      auto store = [&](int p, const uint32_t (&v)[4]) {
        *reinterpret_cast<uint4*>(dst + (p * BK + r) * WLD + ucol) =
            make_uint4(v[0], v[1], v[2], v[3]);
      };
      uint32_t v[4];
      if constexpr (!C::INT4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t u = word[j / 2] ^ 0x80808080u;
          const int b0 = 2 * (j % 2);
          v[j] = pack_exact_bf16x2(biased_byte<128>(u, b0),
                                   biased_byte<128>(u, b0 + 1));
        }
        store(0, v);
      } else {
        // one plane at a time (low nibbles, then high), so that only one
        // plane's scales and words are live
        auto plane = [&](int p, const float (&sc)[8]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t u =
                ((word[j / 2] >> (4 * p)) & 0x0F0F0F0Fu) ^ 0x08080808u;
            const int b0 = 2 * (j % 2);
            v[j] = pack_bf16x2(biased_byte<8>(u, b0) * sc[2 * j],
                               biased_byte<8>(u, b0 + 1) * sc[2 * j + 1]);
          }
          store(p, v);
        };
        if (step_groups) {
          plane(0, s_lo);
          plane(1, s_hi);
        } else {
          float sc[8];
          load_scales(sc, (k0 + r) / gs);
          plane(0, sc);
          load_scales(sc, (Kd + k0 + r) / gs);
          plane(1, sc);
        }
      }
    }
  };

  float acc[MT][NT][4];
  zero(acc);
  fill_ring<STAGES>(nk, [&](int s) { load(s, k_begin + s * BK); });

  // Step kt multiplies the planes widened during step kt - 1, then widens
  // step kt + 1's: one barrier a step.
  cp_async_wait<STAGES - 2>();           // step 0's copies
  __syncthreads();
  if (nk > 0) widen(0);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 3>();         // this thread's copies of kt + 1
    __syncthreads();   // everyone's; widen(kt) visible; products of kt - 1
                       // done, so stage kt - 1 and wide(kt + 1) are free
    const int next = kt + STAGES - 1;    // refill the stage kt - 1 used
    if (next < nk) load(next % STAGES, k_begin + next * BK);
    cp_async_commit();
    const bf16* xs = stage_x(kt % STAGES);
    const bf16* wk = wide(kt);
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[MT][4], b[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(a[mt], smem_u32(xs + (p * BM + wm * C::WM + mt * 16 +
                                        (lane & 15)) * XLD +
                                  kk + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldsm_x4_trans(r, smem_u32(wk + (p * BK + kk + (lane & 15)) * WLD +
                                    wn * C::WN + np * 16 + (lane >> 4) * 8));
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
      }
    }
    if (kt + 1 < nk) widen(kt + 1);   // after the products: it overlaps
                                       // the other warps' products
  }
  cp_async_wait<0>();                    // no copy outlives the block

  // Accumulator (mt, nt, h): row lane/4 + 8h, columns 2*(lane%4) + {0, 1}.
  const int g = lane >> 2, t = lane & 3;
  auto each = [&](auto&& f) {            // f(mt, nt, h, row, col) in range
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * C::WN + nt * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * C::WM + mt * 16 + g + 8 * h;
          if (row < M && col < N) f(mt, nt, h, row, col);   // N % 16 == 0
        }
      }
  };
  auto put = [&](int row, int col, float v0, float v1) {
    if constexpr (!C::INT4) {
      const float2 sc = *reinterpret_cast<const float2*>(scale + col);
      v0 *= sc.x;
      v1 *= sc.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
        __floats2bfloat162_rn(v0, v1);
  };
  auto put_all = [&] {
    each([&](int mt, int nt, int h, int row, int col) {
      put(row, col, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    });
  };
  if (partial == nullptr) {
    put_all();
    return;
  }
  // K is split. The merge adds one split at a time over all of this
  // thread's elements, so their loads are in flight together; the decode
  // tile, with few elements a thread and up to ~30 splits, also unrolls
  // over splits.
  if (merge_splits<C::SMALL ? 6 : 1>(
          acc, partial, counters, (size_t)M * N,
          [&](float* dst) {
            each([&](int mt, int nt, int h, int row, int col) {
              *reinterpret_cast<float2*>(dst + (size_t)row * N + col) =
                  make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
            });
          },
          [&](const float* src) {
            each([&](int mt, int nt, int h, int row, int col) {
              const float2 v = __ldcg(reinterpret_cast<const float2*>(
                  src + (size_t)row * N + col));
              acc[mt][nt][2 * h] += v.x;
              acc[mt][nt][2 * h + 1] += v.y;
            });
          }))
    put_all();
}

// ---------------------------------------------------------------------------
// TF32 route (float32 x, two TF32 passes over exact integer weights; the
// tensor-core route's envelope, and for K4 a group size that is a multiple
// of BK or G = 1)

// One tile shape of the TF32 route, as TcTile: (BM/WM) x (BN/WN) warps, each
// owning a WM x WN piece; K advances BK rows (K1) or packed rows (K4) a
// stage.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_,
          int MIN_BLOCKS_, bool INT4_>
struct Tf32Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr bool INT4 = INT4_;
  using X = float;                          // x and out
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * (BM / WM) * WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int P = INT4 ? 2 : 1;    // x planes, widened planes
  // float row pitch BK + 4: the A fragment's (g, t) lies in bank 4g + t;
  // byte row pitch BN + 32: a B fragment's 4 k rows lie 8 banks apart
  static constexpr int XLD = BK + 4;
  static constexpr int SLD = BN + 32;
  static constexpr int X_BYTES = P * BM * XLD * 4;
  static constexpr int W_BYTES = BK * SLD;
  static constexpr int S_BYTES = INT4 ? 2 * BN * 4 : 0;   // two scale rows
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES + S_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(NT == 2 || NT == 4, "a lane's weight bytes in one load");
  static_assert(BK % 8 == 0 && BN % 16 == 0, "tile shape");
  static_assert(STAGES >= 2, "a ring");
  static_assert(X_BYTES % 16 == 0 && W_BYTES % 16 == 0, "16-byte stages");
};

// The NT weight bytes of a lane's B fragments (adjacent columns), as the low
// bytes of a word.
template <int NT>
__device__ __forceinline__ uint32_t weight_bytes(const unsigned char* p) {
  if constexpr (NT == 4) return *reinterpret_cast<const uint32_t*>(p);
  else return *reinterpret_cast<const uint16_t*>(p);
}

// x [M, XK] float32 with XK = K (K1) or 2*Kd (K4); w [Kd, N] int8 (K1: the
// weights, K4: packed bytes); scale [N] (K1) or [G, N] (K4, gs = 2*Kd / G
// rows a group: G = 1 or gs a multiple of BK dividing Kd); out [M, N]
// float32. With gridDim.z > 1 splits, partial holds [splits, M, N] float32
// sums and counters one int per output tile, zero on entry and on exit.
// Kd and k_per_split are multiples of C::BK.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
tf32_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out,
                   float* __restrict__ partial, int* __restrict__ counters,
                   int M, int Kd, int N, int gs, int k_per_split) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, P = C::P;
  constexpr int XLD = C::XLD, SLD = C::SLD, STAGES = C::STAGES;
  constexpr int THREADS = C::THREADS, MT = C::MT, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int nk = (min(Kd, k_begin + k_per_split) - k_begin) / BK;
  // K4 with G > 1 scales each plane's chain by its group's scale; K1 and
  // K4 with G = 1 scale in the epilogue
  const bool grouped = C::INT4 && gs < 2 * Kd;

  auto stage_x = [&](int s) {            // [P][BM][XLD] float
    return reinterpret_cast<float*>(smem + s * C::STAGE_BYTES);
  };
  auto stage_w = [&](int s) {            // [BK][SLD] bytes
    return smem + s * C::STAGE_BYTES + C::X_BYTES;
  };
  auto stage_s = [&](int s) {            // [2][BN] float: the planes' scales
    return reinterpret_cast<float*>(smem + s * C::STAGE_BYTES + C::X_BYTES +
                                    C::W_BYTES);
  };

  // Issue the copies of k-step k0 into stage s (K4 with groups: also the
  // step's two scale rows).
  auto load = [&](int s, int k0) {
    load_step<C>(stage_x(s), stage_w(s), x, w, M, Kd, N, m0, n0, k0);
    if (grouped) {
      constexpr int SC = BN / 4;
      for (int c = tid; c < 2 * SC; c += THREADS) {
        const int p = c / SC, col = (c % SC) * 4;
        const bool ok = n0 + col < N;
        const float* src =
            scale + (size_t)((p * Kd + k0) / gs) * N + (ok ? n0 + col : 0);
        cp_async16(smem_u32(stage_s(s) + p * BN + col), src, ok);
      }
    }
  };

  float acc[MT][NT][4];
  zero(acc);

  // The products of stage s: per plane, a chain from zero over the step's
  // BK / 8 k8 slices (x_lo w, then x_hi w), added to acc once.
  auto products = [&](int s) {
    const float* xs = stage_x(s);
    const unsigned char* ws = stage_w(s);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float ch[MT][NT][4];
      zero(ch);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        // B (k, n) of fragment nt, lane (g, t): rows kk + t and kk + t + 4,
        // column NT * g + nt of the warp's strip
        const unsigned char* wr = ws + (kk + t) * SLD + wn * C::WN + NT * g;
        uint32_t u[2] = {weight_bytes<NT>(wr), weight_bytes<NT>(wr + 4 * SLD)};
        uint32_t b[NT][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (C::INT4) {
            const uint32_t v = ((u[h] >> (4 * p)) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              b[nt][h] = __float_as_uint(biased_byte<8>(v, nt));
          } else {
            const uint32_t v = u[h] ^ 0x80808080u;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              b[nt][h] = __float_as_uint(biased_byte<128>(v, nt));
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* xr =
              xs + (p * BM + wm * C::WM + mt * 16 + g) * XLD + kk + t;
          uint32_t ah[4], al[4];
          split_tf32(xr[0], ah[0], al[0]);                 // (g, t)
          split_tf32(xr[8 * XLD], ah[1], al[1]);           // (g + 8, t)
          split_tf32(xr[4], ah[2], al[2]);                 // (g, t + 4)
          split_tf32(xr[8 * XLD + 4], ah[3], al[3]);       // (g + 8, t + 4)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_tf32(ch[mt][nt], al, b[nt][0], b[nt][1]);
            mma_tf32(ch[mt][nt], ah, b[nt][0], b[nt][1]);
          }
        }
      }
      // chain (mt, nt, e) holds column NT * (2t + (e & 1)) + nt of the strip
      if (grouped) {
        const float* sr = stage_s(s) + p * BN + wn * C::WN + 2 * NT * t;
        float sc[2 * NT];
#pragma unroll
        for (int i = 0; i < 2 * NT; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(sr + i);
          sc[i] = v.x; sc[i + 1] = v.y; sc[i + 2] = v.z; sc[i + 3] = v.w;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] = __fadd_rn(
                  acc[mt][nt][e],
                  __fmul_rn(ch[mt][nt][e], sc[(e & 1) * NT + nt]));
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], ch[mt][nt][e]);
      }
    }
  };

  fill_ring<STAGES>(nk, [&](int s) { load(s, k_begin + s * BK); });
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();         // this thread's copies of step kt
    __syncthreads();   // everyone's; the products of kt - 1 are done, so
                       // its stage is free for step kt + STAGES - 1
    const int next = kt + STAGES - 1;
    if (next < nk) load(next % STAGES, k_begin + next * BK);
    cp_async_commit();
    products(kt % STAGES);
  }
  cp_async_wait<0>();                    // no copy outlives the block

  // A lane's row (mt, h) holds the 2 NT adjacent columns from col0 on:
  // column col0 + i is acc[mt][i % NT][2h + i / NT].
  auto each = [&](auto&& f) {            // f(mt, h, row, col0) in range
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int col0 = n0 + wn * C::WN + 2 * NT * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * C::WM + mt * 16 + g + 8 * h;
        if (row < M && col0 < N) f(mt, h, row, col0);   // N % 16 == 0
      }
    }
  };
  auto put = [&](int mt, int h, float* dst, int col0, bool scaled) {
#pragma unroll
    for (int i = 0; i < 2 * NT; i += 4) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = acc[mt][(i + q) % NT][2 * h + (i + q) / NT];
        if (scaled) v[q] *= __ldg(scale + col0 + i + q);
      }
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  // the tile's sums, scaled (K1, and K4 with G = 1)
  auto put_all = [&] {
    each([&](int mt, int h, int row, int col0) {
      put(mt, h, out + (size_t)row * N + col0, col0, !grouped);
    });
  };
  if (partial == nullptr) {
    put_all();
    return;
  }
  if (merge_splits<1>(
          acc, partial, counters, (size_t)M * N,
          [&](float* dst) {
            each([&](int mt, int h, int row, int col0) {
              put(mt, h, dst + (size_t)row * N + col0, col0, false);
            });
          },
          [&](const float* src) {
            each([&](int mt, int h, int row, int col0) {
              const float* r = src + (size_t)row * N + col0;
#pragma unroll
              for (int i = 0; i < 2 * NT; i += 4) {
                const float4 v = __ldcg(reinterpret_cast<const float4*>(r + i));
                const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  acc[mt][(i + q) % NT][2 * h + (i + q) / NT] += a[q];
              }
            });
          }))
    put_all();
}

// The three tiles of each route, by regime (bm: 16 decode, 64 for
// 16 < M <= 64, 128). The TF32 route's K4 64-row tile holds its step's
// scales beside two sets of accumulators: at two blocks an SM (128
// registers) it spilled, so it takes one.
template <bool INT4> struct TcTiles {
  using Decode = TcTile<16, 128, 32, 16, 16, 6, 3, INT4>;
  using Mid = TcTile<64, 128, 32, 32, 32, 4, 2, INT4>;
  using Prefill = TcTile<128, 128, 32, 64, 32, INT4 ? 3 : 4, 2, INT4>;
};
template <bool INT4> struct Tf32Tiles {
  using Decode = Tf32Tile<16, 128, 32, 16, 16, 6, 3, INT4>;
  using Mid = Tf32Tile<64, 128, 32, 32, 32, 4, INT4 ? 1 : 2, INT4>;
  using Prefill = Tf32Tile<128, 128, 32, 64, 32, 4, 1, INT4>;
};

// The kernel of a tile shape: bf16 x takes tc_matmul_kernel, float32 x
// tf32_matmul_kernel.
template <class C>
auto kernel_of() {
  if constexpr (std::is_same_v<typename C::X, float>)
    return tf32_matmul_kernel<C>;
  else
    return tc_matmul_kernel<C>;
}

template <class C>
cudaError_t launch_tile(const void* x, const void* w, const void* scale,
                        void* out, float* partial, int* counters, int M,
                        int Kd, int N, int gs, int splits, int k_per_split,
                        cudaStream_t stream) {
  using X = typename C::X;
  const auto kernel = kernel_of<C>();
  // Above 48 KB a block's shared memory must be asked for, once a device.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, splits);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const X*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<X*>(out), partial,
      counters, M, Kd, N, gs, k_per_split);
  return cudaGetLastError();
}

// Launch the row tile bm of a route's Tiles.
template <class Tiles>
cudaError_t launch_route(int bm, const void* x, const void* w,
                         const void* scale, void* out, void* workspace,
                         void* counters, int M, int Kd, int N, int gs,
                         int splits, int k_per_split, cudaStream_t stream) {
  float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  int* ctr = static_cast<int*>(counters);
  if (splits > 1 && (partial == nullptr || ctr == nullptr))
    return cudaErrorInvalidValue;
  if (bm == 16)
    return launch_tile<typename Tiles::Decode>(x, w, scale, out, partial, ctr,
                                               M, Kd, N, gs, splits,
                                               k_per_split, stream);
  if (bm == 64)
    return launch_tile<typename Tiles::Mid>(x, w, scale, out, partial, ctr, M,
                                            Kd, N, gs, splits, k_per_split,
                                            stream);
  if (bm == 128)
    return launch_tile<typename Tiles::Prefill>(x, w, scale, out, partial,
                                                ctr, M, Kd, N, gs, splits,
                                                k_per_split, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Route codes (kernels/dequant_matmul.py ROUTE_CODES): 0 the CUDA-core
// kernel ("fma", either x type; k_per_split a multiple of 32, a second
// launch adds the splits up); 1 the bf16 tensor-core kernel ("tc"); 2 the
// float32 TF32 kernel ("tf32x2"). Routes 1 and 2 take the row tile bm in
// {16, 64, 128}, K (K1) or Kh (K4) and k_per_split multiples of 32, N a
// multiple of 16 and 16-byte aligned pointers; with splits > 1, counters
// holds one zero int per output tile (ceil(N / 128) * ceil(M / bm)) and is
// left at zero. A route that does not take x's type returns
// cudaErrorInvalidValue: nothing falls back to another route.
//
// x [M, K] (float if x_bf16 == 0, else bf16); w [K, N] int8; scale [N] f32;
// out [M, N] like x; workspace: splits * M * N floats when splits > 1;
// splits * k_per_split >= K.
extern "C" int bt_int8_matmul(const void* x, const void* w, const void* scale,
                              void* out, void* workspace, void* counters,
                              int M, int K, int N, int splits,
                              int k_per_split, int x_bf16, int route, int bm,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1 && x_bf16)
    return static_cast<int>(launch_route<TcTiles<false>>(
        bm, x, w, scale, out, workspace, counters, M, K, N, 1, splits,
        k_per_split, st));
  if (route == 2 && !x_bf16)
    return static_cast<int>(launch_route<Tf32Tiles<false>>(
        bm, x, w, scale, out, workspace, counters, M, K, N, 1, splits,
        k_per_split, st));
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16)
    launch_fma<__nv_bfloat16>(x, w, scale, out, workspace, M, K, N, splits,
                              k_per_split, st);
  else
    launch_fma<float>(x, w, scale, out, workspace, M, K, N, splits,
                      k_per_split, st);
  return static_cast<int>(cudaGetLastError());
}

// x [M, 2*Kh] (float if x_bf16 == 0, else bf16); w [Kh, N] int8, split-half
// packed; scale [G, N] f32 with gs = 2*Kh / G rows per group (gs divides Kh,
// or G = 1 and gs = 2*Kh; route 2 also needs gs a multiple of 32); out
// [M, N] like x; workspace: splits * M * N floats when splits > 1.
// k_per_split counts packed rows and splits * k_per_split >= Kh. Routes,
// bm and counters as for bt_int8_matmul, with Kh in place of K.
extern "C" int bt_int4_matmul(const void* x, const void* w, const void* scale,
                              void* out, void* workspace, void* counters,
                              int M, int Kh, int N, int gs, int splits,
                              int k_per_split, int x_bf16, int route, int bm,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1 && x_bf16)
    return static_cast<int>(launch_route<TcTiles<true>>(
        bm, x, w, scale, out, workspace, counters, M, Kh, N, gs, splits,
        k_per_split, st));
  // the TF32 kernel's groups hold whole 32-row steps, or G = 1
  if (route == 2 && !x_bf16 && (gs >= 2 * Kh || gs % 32 == 0))
    return static_cast<int>(launch_route<Tf32Tiles<true>>(
        bm, x, w, scale, out, workspace, counters, M, Kh, N, gs, splits,
        k_per_split, st));
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16)
    launch4_fma<__nv_bfloat16>(x, w, scale, out, workspace, M, Kh, N, gs,
                               splits, k_per_split, st);
  else
    launch4_fma<float>(x, w, scale, out, workspace, M, Kh, N, gs, splits,
                       k_per_split, st);
  return static_cast<int>(cudaGetLastError());
}
