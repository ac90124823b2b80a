// K1: INT8 weight-only dequant-matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel block_transformer_tpu/ops/dequant_matmul.py
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
  out[i] = bt::from_f32<T>(s * scale[i % N]);
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
