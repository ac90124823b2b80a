// K1 and K4: INT8 and INT4 weight-only dequant-matmuls for Hopper (sm_90a).
//
// K1 replaces the Pallas kernel block_transformer_tpu/ops/dequant_matmul.py
// (_int8_kernel / int8_matmul_stacked, and its wrapper int8_matmul):
//
//   out[M, N] = cast_T( (x[M, K] @ float(w_q[K, N])) * scale[N] )
//
// x is float or bf16, w_q int8 (one layer of a stacked [L, K, N] array: the
// caller passes the layer's base pointer, so no weight slice is copied),
// scale float32, accumulation in float32.
//
// What bounds it on the H100: at decode (M = batch, 1..64 rows) it moves the
// int8 weights once, K*N bytes, against 2*M*K*N operations, far below the
// card's ~295 operations per byte: it is bound by bytes. At prefill
// (M in the thousands) it is bound by operations.
//
// Design. The output is cut into BM x 64 tiles (BM = 16 for M <= 16, else
// 64); each block walks K in steps of 32. An int8 weight tile (32 x 64 =
// 2 KB) is read once with 8-byte loads, widened to float32 in shared memory
// and used by all BM rows; the x tile is widened the same way. The next
// tile's global loads are issued into registers before the current tile's
// products, so loads overlap arithmetic. Each thread keeps TM x 4 float32
// accumulators; the per-channel scale is applied once, in the epilogue.
// When the output has too few tiles to fill the card's 132 SMs (decode),
// K is split over gridDim.z: each split writes float32 partial sums to a
// workspace that a second small kernel adds up, scales and casts, so the
// weight stream is spread over enough blocks. Ragged M, N and K edges are
// masked in the kernel; nothing is padded.
//
// K4 replaces the Pallas kernel _int4_kernel / int4_matmul_stacked of the
// same file (and its wrapper int4_matmul): split-half INT4 with group-wise
// scales,
//
//   out[M, N] = cast_T( x[:, :K/2] @ (lo * s_lo) + x[:, K/2:] @ (hi * s_hi) )
//
// where byte row i of w_p [K/2, N] holds row i in its low nibble and row
// i + K/2 in its high one (both sign-extended), and unpacked row r takes the
// scale of group r / gs from scale [G, N] (gs = K / G divides K/2, or G = 1).
// It moves half of K1's weight bytes, K*N/2, so at decode it is bound by
// bytes even harder; at prefill by operations. Design: K1's tiling over the
// packed rows. Each step reads one 32 x 64 byte tile and widens both nibble
// planes into two float32 tiles in shared memory, each value multiplied on
// the way by its row's group scale, so any gs works (and G = 1) and the
// epilogue needs no scale; the matching column slices [k0, k0+32) and
// [K/2+k0, K/2+k0+32) of x are staged beside them. The Pallas kernel scales
// each tile's partial product instead, which differs only by rounding. The
// split-K path and the masking of ragged edges are K1's.
//
// This first version computes on the CUDA cores (FMA); tensor cores
// (mma/wgmma) and TMA are left for later work.

#include "common.cuh"

namespace {

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
// scale, its partials are scaled already) and casts.
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
void launch(const void* x, const void* w, const void* scale, void* out,
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
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    splitk_reduce_kernel<T><<<blocks, threads, 0, stream>>>(
        partial, static_cast<const float*>(scale), static_cast<T*>(out), M, N,
        splits);
  }
}

template <typename T>
void launch4(const void* x, const void* w, const void* scale, void* out,
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
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    splitk_reduce_kernel<T><<<blocks, threads, 0, stream>>>(
        partial, nullptr, static_cast<T*>(out), M, N, splits);
  }
}

}  // namespace

// x [M, K] (float if x_bf16 == 0, else bf16); w [K, N] int8; scale [N] f32;
// out [M, N] like x; workspace: splits * M * N floats when splits > 1.
// k_per_split is a multiple of 32 and splits * k_per_split >= K.
extern "C" int bt_int8_matmul(const void* x, const void* w, const void* scale,
                              void* out, void* workspace, int M, int K, int N,
                              int splits, int k_per_split, int x_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    launch<__nv_bfloat16>(x, w, scale, out, workspace, M, K, N, splits,
                          k_per_split, st);
  else
    launch<float>(x, w, scale, out, workspace, M, K, N, splits, k_per_split,
                  st);
  return static_cast<int>(cudaGetLastError());
}

// x [M, 2*Kh] (float if x_bf16 == 0, else bf16); w [Kh, N] int8, split-half
// packed; scale [G, N] f32 with gs = 2*Kh / G rows per group (gs divides Kh,
// or G = 1 and gs = 2*Kh); out [M, N] like x; workspace: splits * M * N
// floats when splits > 1. k_per_split counts packed rows, is a multiple of
// 32, and splits * k_per_split >= Kh.
extern "C" int bt_int4_matmul(const void* x, const void* w, const void* scale,
                              void* out, void* workspace, int M, int Kh, int N,
                              int gs, int splits, int k_per_split, int x_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    launch4<__nv_bfloat16>(x, w, scale, out, workspace, M, Kh, N, gs, splits,
                           k_per_split, st);
  else
    launch4<float>(x, w, scale, out, workspace, M, Kh, N, gs, splits,
                   k_per_split, st);
  return static_cast<int>(cudaGetLastError());
}
