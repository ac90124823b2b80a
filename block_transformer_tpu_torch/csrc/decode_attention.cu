// K2: decode attention over an INT8 KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel block_transformer_tpu/ops/decode_attention.py
// (_make_kernel / _decode_attn, entry decode_attention_int8_stacked), INT8
// form. For each (b, h) and each of S <= 8 query rows:
//
//   s[j]  = (q . k_q[j]) * (k_scale[j] / sqrt(D))
//   s[j]  = -1e30 where not (kv_idx[j] <= q_idx[b, s] and kv_valid[b, j])
//   out   = sum_j softmax(s)[j] * v_scale[j] * v_q[j]     (float32 softmax)
//
// A row with no allowed key gets the uniform mean over all cap slots, like
// the reference. The caller passes one layer's cache (base pointers of
// layer `layer` inside the stacked [L, B, H, cap, D] arrays), so no slice of
// the cache is copied.
//
// What bounds it on the H100: it reads the layer's int8 cache once,
// 2*B*H*cap*D bytes plus 8 bytes of scales per slot, against ~4*S*D
// operations per slot: at S <= 8 it is bound by bytes.
//
// Design. One block of 8 warps per (b, h). The capacity is cut into tiles
// of 32 slots dealt round-robin to the warps; in a tile each lane owns one
// key, reads its int8 row with 16-byte loads and forms the S scores against
// the query rows held in shared memory, so no shuffle is needed per score.
// Each warp keeps its own online-softmax state (max, sum, and S x D float32
// accumulators spread over the lanes); for P.V each lane owns D/32
// contiguous output dims and reads them from each value row, the
// probabilities coming by shuffle from the lane that owns the key. v_scale
// multiplies the probability, k_scale the score, as in the reference, so the
// cache is never dequantized in memory. At the end the 8 warp states are
// merged through shared memory. Only the cap real slots are visited.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int MAX_S = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
decode_attn_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                        const float* __restrict__ ks,
                        const int8_t* __restrict__ vq,
                        const float* __restrict__ vs,
                        const int* __restrict__ q_idx,
                        const int* __restrict__ kv_idx,
                        const int* __restrict__ kv_valid, T* __restrict__ out,
                        int H, int S, int cap, float sm_scale) {
  constexpr int DPL = D / 32;   // output dims per lane
  __shared__ float qs[MAX_S][D];
  __shared__ float m_w[WARPS][MAX_S];
  __shared__ float l_w[WARPS][MAX_S];
  __shared__ float acc_w[WARPS][MAX_S][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t bh = (size_t)b * H + h;

  for (int i = threadIdx.x; i < S * D; i += blockDim.x)
    qs[i / D][i % D] = bt::to_f32(q[bh * S * D + i]);
  __syncthreads();

  const int8_t* kb = kq + bh * cap * D;
  const int8_t* vb = vq + bh * cap * D;
  const float* ksb = ks + bh * cap;
  const float* vsb = vs + bh * cap;
  const int* valid_b = kv_valid + (size_t)b * cap;

  int qi[MAX_S];
  float m[MAX_S], l[MAX_S], acc[MAX_S][DPL];
#pragma unroll
  for (int s = 0; s < MAX_S; ++s) {
    qi[s] = s < S ? q_idx[b * S + s] : 0;
    m[s] = bt::kNeg;
    l[s] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[s][e] = 0.f;
  }

  const int n_tiles = (cap + 31) / 32;
  for (int t = warp; t < n_tiles; t += WARPS) {
    const int j = t * 32 + lane;   // this lane's key
    const bool in_range = j < cap;
    float sc[MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) sc[s] = 0.f;
    if (in_range) {
      const int8_t* krow = kb + (size_t)j * D;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 16) {
        union {
          int4 u;
          int8_t b[16];
        } raw;
        raw.u = *reinterpret_cast<const int4*>(krow + d0);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float kf = static_cast<float>(raw.b[e]);
#pragma unroll
          for (int s = 0; s < MAX_S; ++s)
            if (s < S) sc[s] += qs[s][d0 + e] * kf;
        }
      }
    }
    const float k_mul = in_range ? ksb[j] * sm_scale : 0.f;
    const float v_mul = in_range ? vsb[j] : 0.f;
    const int kvi = in_range ? kv_idx[j] : 0;
    const bool valid = in_range && valid_b[j] != 0;

#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s >= S) break;
      float v = sc[s] * k_mul;
      if (!(valid && kvi <= qi[s])) v = bt::kNeg;
      if (!in_range) v = -INFINITY;   // past the capacity: no weight at all
      const float m_new = fmaxf(m[s], warp_max(v));
      const float corr = expf(m[s] - m_new);
      const float p = expf(v - m_new);
      l[s] = l[s] * corr + warp_sum(p);
      m[s] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[s][e] *= corr;
      sc[s] = p * v_mul;
    }

    const int n_keys = min(32, cap - t * 32);
    for (int jj = 0; jj < n_keys; ++jj) {
      const int8_t* vrow = vb + (size_t)(t * 32 + jj) * D + lane * DPL;
      float vv[DPL];
      if constexpr (DPL == 4) {
        const char4 c = *reinterpret_cast<const char4*>(vrow);
        vv[0] = c.x;
        vv[1] = c.y;
        vv[2] = c.z;
        vv[3] = c.w;
      } else {
#pragma unroll
        for (int e = 0; e < DPL; ++e) vv[e] = vrow[e];
      }
#pragma unroll
      for (int s = 0; s < MAX_S; ++s) {
        if (s >= S) break;
        const float p = __shfl_sync(FULL, sc[s], jj);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[s][e] += p * vv[e];
      }
    }
  }

#pragma unroll
  for (int s = 0; s < MAX_S; ++s) {
    if (s >= S) break;
    if (lane == 0) {
      m_w[warp][s] = m[s];
      l_w[warp][s] = l[s];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc_w[warp][s][lane * DPL + e] = acc[s][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < S * D; i += blockDim.x) {
    const int s = i / D, d = i % D;
    float mx = bt::kNeg;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_w[w][s]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(m_w[w][s] - mx);
      lsum += l_w[w][s] * c;
      a += acc_w[w][s][d] * c;
    }
    out[bh * S * D + i] = bt::from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
void launch(const void* q, const void* kq, const void* ks, const void* vq,
            const void* vs, const void* q_idx, const void* kv_idx,
            const void* kv_valid, void* out, int B, int H, int S, int cap,
            cudaStream_t stream) {
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(D));
  decode_attn_int8_kernel<T, D><<<dim3(H, B), WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const int*>(q_idx),
      static_cast<const int*>(kv_idx), static_cast<const int*>(kv_valid),
      static_cast<T*>(out), H, S, cap, sm_scale);
}

template <typename T>
int dispatch_d(const void* q, const void* kq, const void* ks, const void* vq,
               const void* vs, const void* q_idx, const void* kv_idx,
               const void* kv_valid, void* out, int B, int H, int S, int D,
               int cap, cudaStream_t st) {
  switch (D) {
    case 32:
      launch<T, 32>(q, kq, ks, vq, vs, q_idx, kv_idx, kv_valid, out, B, H, S,
                    cap, st);
      break;
    case 64:
      launch<T, 64>(q, kq, ks, vq, vs, q_idx, kv_idx, kv_valid, out, B, H, S,
                    cap, st);
      break;
    case 128:
      launch<T, 128>(q, kq, ks, vq, vs, q_idx, kv_idx, kv_valid, out, B, H, S,
                     cap, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, S, D] (float if q_bf16 == 0, else bf16), S <= 8, D in {32, 64,
// 128}; kq/vq int8 [B, H, cap, D] and ks/vs f32 [B, H, cap] of one layer;
// q_idx int32 [B, S]; kv_idx int32 [cap]; kv_valid int32 [B, cap];
// out [B, H, S, D] like q.
extern "C" int bt_decode_attention_int8(const void* q, const void* kq,
                                        const void* ks, const void* vq,
                                        const void* vs, const void* q_idx,
                                        const void* kv_idx,
                                        const void* kv_valid, void* out, int B,
                                        int H, int S, int D, int cap,
                                        int q_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > MAX_S) return static_cast<int>(cudaErrorInvalidValue);
  if (q_bf16)
    return dispatch_d<__nv_bfloat16>(q, kq, ks, vq, vs, q_idx, kv_idx,
                                     kv_valid, out, B, H, S, D, cap, st);
  return dispatch_d<float>(q, kq, ks, vq, vs, q_idx, kv_idx, kv_valid, out, B,
                           H, S, D, cap, st);
}
