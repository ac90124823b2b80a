// K3: flash attention forward with a structured mask, for Hopper (sm_90a).
//
// Replaces the Pallas kernel block_transformer_tpu/ops/flash_attention.py
// (_kernel / _flash, entry flash_attention). For q [B, H, Q, D] against
// k, v [B, H, K, D]:
//
//   s   = (q . k) / sqrt(D), float32
//   s   = -1e30 where not (kv_idx[k] <= q_idx[b, q] and kv_valid[b, k])
//   out = softmax(s) . v   (online softmax in float32; the probabilities are
//                           rounded to the input type before P.V, as there)
//
// The mask is built per tile from the three index vectors; no Q x K bias
// exists in memory. Keys past K (the ragged last tile) are left out
// entirely, so a row with no allowed key gets the uniform mean over the K
// real keys, as the plain attention does. (The Pallas kernel pads K with
// zero rows that join that average; only such rows differ.)
//
// What bounds it on the H100: 4*B*H*Q*K*D operations against
// 2*B*H*(2*Q + 2*K)*D bytes (bf16). At the main path's prefill tile
// (Q = 128 queries against K = 512 keys, D = 128) that is ~51 operations per
// byte, under the card's ~295 for bf16 tensor cores, so with tensor cores it
// would be bound by bytes; on the CUDA cores it is bound by operations.
//
// Design. One block of 256 threads per (q tile of 64 rows, h, b). The
// query tile is held transposed in shared memory; the block walks the keys
// in tiles of 64: the key tile is stored transposed and the value tile as
// it is, both widened to float32. Each thread computes a 4 x 4 patch of the
// 64 x 64 scores from float4 reads; the 16 threads that share a row reduce
// its max and sum by shuffle. Probabilities go through shared memory to the
// P.V product, in which each thread owns 4 rows and D/16 columns of the
// float32 output accumulator. This first version computes on the CUDA cores;
// tensor cores (mma/wgmma) and TMA are left for later work.

#include <climits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // keys per tile
constexpr int LD = BQ + 4;   // row stride of the transposed tiles
constexpr int PLD = BKV + 1; // row stride of the probability tile
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// reductions over the 16 lanes that share a row (one half of a warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

size_t smem_bytes(int D) {
  return sizeof(float) * (2 * D * LD + BKV * D + BQ * PLD);
}

// DMAX (32, 64 or 128) sizes the per-thread accumulators; the head dim D
// (1 <= D <= DMAX) is a run-time value and columns past it are masked.
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ q_idx,
                  const int* __restrict__ kv_idx,
                  const int* __restrict__ kv_valid, T* __restrict__ out,
                  int H, int Q, int K, int D, float sm_scale) {
  constexpr int NG = DMAX / 16;   // output column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;               // [D][LD]: Qt[d][r]
  float* Kt = Qt + D * LD;        // [D][LD]: Kt[d][c]
  float* Vs = Kt + D * LD;        // [BKV][D]
  float* Ps = Vs + BKV * D;       // [BQ][PLD]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const T* qb = q + bh * Q * D;
  const T* kb = k + bh * K * D;
  const T* vb = v + bh * K * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qt[d * LD + r] = (q0 + r < Q) ? bt::to_f32(qb[(size_t)(q0 + r) * D + d])
                                  : 0.f;
  }

  int qi[4];
  float m[4], l[4], o[4][NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    qi[i] = r < Q ? q_idx[(size_t)b * Q + r] : INT_MIN;
    m[i] = bt::kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) o[i][g] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BKV) {
    __syncthreads();   // the previous tile is done with Kt, Vs and Ps
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const bool in = k0 + c < K;
      const size_t off = (size_t)(k0 + c) * D + d;
      Kt[d * LD + c] = in ? bt::to_f32(kb[off]) : 0.f;
      Vs[c * D + d] = in ? bt::to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LD + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += av[i] * cv[j];
    }

    int kvi[4];
    bool ok[4], in[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx * 4 + j;
      in[j] = c < K;
      kvi[j] = in[j] ? kv_idx[c] : 0;
      ok[j] = in[j] && kv_valid[(size_t)b * K + c] != 0;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = bt::kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float val = s[i][j] * sm_scale;
        if (!(ok[j] && kvi[j] <= qi[i])) val = bt::kNeg;
        if (!in[j]) val = -INFINITY;   // past K: left out entirely
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * PLD + tx * 4 + j] = bt::round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g) o[i][g] *= corr;
    }
    __syncthreads();

    const int n_keys = min(BKV, K - k0);
    for (int c = 0; c < n_keys; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PLD + c];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int col = g * 16 + tx;
        const float vv = col < D ? Vs[c * D + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][g] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = g * 16 + tx;
      if (col < D)
        out[(bh * Q + r) * D + col] = bt::from_f32<T>(o[i][g] / denom);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* q_idx,
           const void* kv_idx, const void* kv_valid, void* out, int B, int H,
           int Q, int K, int D, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid((Q + BQ - 1) / BQ, H, B);
  flash_attn_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_idx),
      static_cast<const int*>(kv_idx), static_cast<const int*>(kv_valid),
      static_cast<T*>(out), H, Q, K, D, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* q_idx,
               const void* kv_idx, const void* kv_valid, void* out, int B,
               int H, int Q, int K, int D, cudaStream_t st) {
  if (D < 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32)
    return launch<T, 32>(q, k, v, q_idx, kv_idx, kv_valid, out, B, H, Q, K, D,
                         st);
  if (D <= 64)
    return launch<T, 64>(q, k, v, q_idx, kv_idx, kv_valid, out, B, H, Q, K, D,
                         st);
  return launch<T, 128>(q, k, v, q_idx, kv_idx, kv_valid, out, B, H, Q, K, D,
                        st);
}

}  // namespace

// q [B, H, Q, D], k/v [B, H, K, D] (float if bf16 == 0, else bf16),
// 1 <= D <= 128; q_idx int32 [B, Q]; kv_idx int32 [K]; kv_valid int32 [B, K];
// out [B, H, Q, D] like q.
extern "C" int bt_flash_attention(const void* q, const void* k, const void* v,
                                  const void* q_idx, const void* kv_idx,
                                  const void* kv_valid, void* out, int B,
                                  int H, int Q, int K, int D, int bf16,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_d<__nv_bfloat16>(q, k, v, q_idx, kv_idx, kv_valid, out, B,
                                     H, Q, K, D, st);
  return dispatch_d<float>(q, k, v, q_idx, kv_idx, kv_valid, out, B, H, Q, K,
                           D, st);
}
