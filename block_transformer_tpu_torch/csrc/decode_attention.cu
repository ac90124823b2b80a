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
// the reference; slots past cap weigh nothing. The caller passes one
// layer's cache (base pointers of layer `layer` inside the stacked
// [L, B, H, cap, D] arrays), so no slice of the cache is copied. v_scale
// multiplies the probability, kept in float32 (the Pallas kernel casts
// p * v_scale to the query's type before P.V), and k_scale the score, so
// the cache is never dequantized in memory.
//
// What bounds it on the H100: it reads the layer's int8 cache once,
// 2*B*H*cap*D bytes plus 8 bytes of scales per slot, against ~4*S*D
// operations per slot: at S <= 8 it is bound by bytes, and at decode
// (B*H of 128-256) by how many bytes are in flight.
//
// Design (split-KV decoding).
// - The grid is (splits, H, B): the capacity is cut into `splits` runs of
//   slots_per_split slots (whole 32-slot tiles), chosen in Python
//   (kernels/decode_attention.py, plan()) so that the launch puts several
//   blocks on every SM; one split when B*H alone does.
// - A block is 4 warps; a warp walks the 32-slot tiles of its split dealt
//   round-robin, and loads the next tile's key rows, value rows, scales and
//   mask into registers before the current tile's math, so two tiles a warp
//   are in flight.
// - Scores: each lane owns one key, reads its int8 row with 16-byte loads
//   and dots it with the query rows held in shared memory. Int8 is widened
//   by the exact byte permute onto a 2^23 bias (mma.cuh), not the
//   quarter-rate integer-to-float conversions.
// - P.V: every lane reads 4 contiguous bytes of a value row, so a warp
//   reads whole 128-byte lines at every head dim (D = 64: two rows a step,
//   D = 32: four); the probabilities (times v_scale) go through a warp's
//   own shared row. Each warp keeps its online-softmax state (max, sum,
//   S x 4 float32 accumulators a lane) and the block merges its warps
//   through shared memory.
// - With more than one split each block writes its (max, sum, acc[S][D])
//   partials in float32 to a scratch buffer; the last split of a (b, h) to
//   arrive (an atomic counter per (b, h), left at zero for the next launch)
//   merges them and writes the output: no second launch. A split whose
//   every slot is masked holds max -1e30 and merges to nothing beside a
//   split with an allowed key, and to the uniform mean when no split has
//   one.

#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace bt;   // biased_byte

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 32;   // slots a warp step, one a lane
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

// One 32-slot tile as a lane holds it: the int8 row of its key, 4 bytes of
// each value row it reads (RPS rows a step, LPR lanes a row), and its key's
// scales and mask inputs.
template <int D>
struct Tile {
  static constexpr int KW = D / 16;     // 16-byte loads of the key row
  static constexpr int LPR = D / 4;     // lanes a value row
  static constexpr int RPS = 32 / LPR;  // value rows a step
  static constexpr int VW = TILE / RPS; // 4-byte value loads
  uint4 k[KW];
  uint32_t v[VW];
  float ks, vs;
  int idx, ok;

  // Loads the tile of slots [j0, j0 + 32); slots from j_end on read nothing.
  __device__ __forceinline__ void load(const int8_t* kb, const int8_t* vb,
                                       const float* ksb, const float* vsb,
                                       const int* kv_idx, const int* valid,
                                       int j0, int j_end, int lane) {
    const int j = j0 + lane;
    if (j < j_end) {
      const uint4* krow = reinterpret_cast<const uint4*>(kb + (size_t)j * D);
#pragma unroll
      for (int c = 0; c < KW; ++c) k[c] = krow[c];
      ks = ksb[j];
      vs = vsb[j];
      idx = kv_idx[j];
      ok = valid[j] != 0;
    } else {
#pragma unroll
      for (int c = 0; c < KW; ++c) k[c] = make_uint4(0, 0, 0, 0);
      ks = vs = 0.f;
      idx = 0;
      ok = 0;
    }
    const int r0 = j0 + lane / LPR, col = (lane % LPR) * 4;
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      const int row = r0 + i * RPS;
      v[i] = row < j_end
                 ? *reinterpret_cast<const uint32_t*>(vb + (size_t)row * D + col)
                 : 0u;
    }
  }
};

// Registers: two tiles, S x 4 accumulators and the softmax state a lane;
// with one query row the smaller head dims fit four blocks an SM.
constexpr int min_blocks(int D, int NS) {
  return NS > 1 ? 2 : D == 128 ? 3 : 4;
}

// NS (1 or MAX_S) sizes the per-query arrays; S <= NS is a run-time value.
// With gridDim.x > 1 splits, partial holds [B*H][splits][S][D] float32 sums
// followed by [B*H][splits][S][2] (max, sum), and counters one zero int per
// (b, h), left at zero.
template <typename T, int D, int NS>
__global__ void __launch_bounds__(THREADS, min_blocks(D, NS))
decode_attn_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                        const float* __restrict__ ks,
                        const int8_t* __restrict__ vq,
                        const float* __restrict__ vs,
                        const int* __restrict__ q_idx,
                        const int* __restrict__ kv_idx,
                        const int* __restrict__ kv_valid, T* __restrict__ out,
                        float* __restrict__ partial, int* __restrict__ counters,
                        int H, int S, int cap, int slots_per_split,
                        float sm_scale) {
  using TileD = Tile<D>;
  constexpr int LPR = TileD::LPR, RPS = TileD::RPS;
  __shared__ __align__(16) float qs[NS][D];
  __shared__ float pw[WARPS][TILE][NS];
  __shared__ float m_w[WARPS][NS];
  __shared__ float l_w[WARPS][NS];
  __shared__ __align__(16) float acc_w[WARPS][NS][D];
  __shared__ int last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bh = (size_t)b * H + h;

  for (int i = tid; i < NS * D; i += THREADS) {
    const int s = i / D;
    qs[s][i % D] = s < S ? to_f32(q[bh * S * D + i]) : 0.f;
  }
  __syncthreads();

  const int8_t* kb = kq + bh * cap * D;
  const int8_t* vb = vq + bh * cap * D;
  const float* ksb = ks + bh * cap;
  const float* vsb = vs + bh * cap;
  const int* valid_b = kv_valid + (size_t)b * cap;
  const int j_begin = split * slots_per_split;
  const int j_end = min(cap, j_begin + slots_per_split);
  const int n_tiles = (j_end - j_begin + TILE - 1) / TILE;

  int qi[NS];
  float m[NS], l[NS], acc[NS][4];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    qi[s] = s < S ? q_idx[b * S + s] : INT_MIN;
    m[s] = kNeg;
    l[s] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[s][e] = 0.f;
  }

  TileD cur, nxt;
  int t = warp;
  if (t < n_tiles)
    cur.load(kb, vb, ksb, vsb, kv_idx, valid_b, j_begin + t * TILE, j_end,
             lane);
  for (; t < n_tiles; t += WARPS) {
    const bool more = t + WARPS < n_tiles;
    if (more)   // in flight during this tile's math
      nxt.load(kb, vb, ksb, vsb, kv_idx, valid_b,
               j_begin + (t + WARPS) * TILE, j_end, lane);

    float sc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) sc[s] = 0.f;
#pragma unroll
    for (int c = 0; c < TileD::KW; ++c) {
      const uint32_t w[4] = {cur.k[c].x, cur.k[c].y, cur.k[c].z, cur.k[c].w};
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const uint32_t u = w[e4] ^ 0x80808080u;
        const float k0 = biased_byte<128>(u, 0), k1 = biased_byte<128>(u, 1);
        const float k2 = biased_byte<128>(u, 2), k3 = biased_byte<128>(u, 3);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          if (s >= S) break;
          const float4 qv =
              *reinterpret_cast<const float4*>(&qs[s][c * 16 + e4 * 4]);
          sc[s] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
        }
      }
    }

    const bool in = j_begin + t * TILE + lane < j_end;
    const float k_mul = cur.ks * sm_scale;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s >= S) break;
      float x = sc[s] * k_mul;
      if (!(cur.ok && cur.idx <= qi[s])) x = kNeg;
      if (!in) x = -INFINITY;   // past the capacity: no weight at all
      const float m_new = fmaxf(m[s], warp_max(x));
      const float corr = expf(m[s] - m_new);
      const float p = expf(x - m_new);
      l[s] = l[s] * corr + p;   // this lane's share of the sum
      m[s] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][e] *= corr;
      pw[warp][lane][s] = p * cur.vs;
    }
    __syncwarp();

#pragma unroll
    for (int i = 0; i < TileD::VW; ++i) {
      const int r = i * RPS + lane / LPR;   // the tile's value row
      const uint32_t u = cur.v[i] ^ 0x80808080u;
      const float v0 = biased_byte<128>(u, 0), v1 = biased_byte<128>(u, 1);
      const float v2 = biased_byte<128>(u, 2), v3 = biased_byte<128>(u, 3);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (s >= S) break;
        const float p = pw[warp][r][s];
        acc[s][0] += p * v0;
        acc[s][1] += p * v1;
        acc[s][2] += p * v2;
        acc[s][3] += p * v3;
      }
    }
    __syncwarp();   // pw is rewritten by the next tile
    if (more) cur = nxt;
  }

  // The warp's state: sums over lanes, accumulators over the lanes that
  // share a column (those RPS rows apart).
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s >= S) break;
    l[s] = warp_sum(l[s]);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        acc[s][e] += __shfl_xor_sync(FULL, acc[s][e], o);
    if (lane < LPR)
      *reinterpret_cast<float4*>(&acc_w[warp][s][lane * 4]) =
          make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
    if (lane == 0) {
      m_w[warp][s] = m[s];
      l_w[warp][s] = l[s];
    }
  }
  __syncthreads();

  // The block's (max, sum, acc): the output with one split, else this
  // split's partials.
  const size_t base = bh * splits + split;   // [B*H][splits]
  float* part_acc = partial;
  float* part_ml = partial + (size_t)gridDim.z * H * splits * S * D;
  for (int i = tid; i < S * D; i += THREADS) {
    const int s = i / D, d = i % D;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_w[w][s]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(m_w[w][s] - mx);
      lsum += l_w[w][s] * c;
      a += acc_w[w][s][d] * c;
    }
    if (splits == 1) {
      out[bh * S * D + i] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
    } else {
      part_acc[base * S * D + i] = a;
      if (d == 0)
        *reinterpret_cast<float2*>(part_ml + (base * S + s) * 2) =
            make_float2(mx, lsum);
    }
  }
  if (splits == 1) return;

  // The last split of this (b, h) to arrive merges all of them, in split
  // order, and leaves the counter at zero for the next launch.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(counters + bh, 1) == splits - 1;
    if (last) counters[bh] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < S * D; i += THREADS) {
    const int s = i / D;
    float mx = kNeg;
    for (int z = 0; z < splits; ++z)
      mx = fmaxf(mx, __ldcg(part_ml + ((bh * splits + z) * S + s) * 2));
    float lsum = 0.f, a = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          part_ml + ((bh * splits + z) * S + s) * 2));
      const float c = expf(ml.x - mx);
      lsum += ml.y * c;
      a += __ldcg(part_acc + (bh * splits + z) * S * D + i) * c;
    }
    out[bh * S * D + i] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, int NS>
void launch(const void* q, const void* kq, const void* ks, const void* vq,
            const void* vs, const void* q_idx, const void* kv_idx,
            const void* kv_valid, void* out, float* partial, int* counters,
            int B, int H, int S, int cap, int splits, int slots_per_split,
            cudaStream_t stream) {
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(D));
  decode_attn_int8_kernel<T, D, NS>
      <<<dim3(splits, H, B), THREADS, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const int8_t*>(kq),
          static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
          static_cast<const float*>(vs), static_cast<const int*>(q_idx),
          static_cast<const int*>(kv_idx), static_cast<const int*>(kv_valid),
          static_cast<T*>(out), partial, counters, H, S, cap,
          slots_per_split, sm_scale);
}

template <typename T, int D>
void launch_s(const void* q, const void* kq, const void* ks, const void* vq,
              const void* vs, const void* q_idx, const void* kv_idx,
              const void* kv_valid, void* out, float* partial, int* counters,
              int B, int H, int S, int cap, int splits, int slots_per_split,
              cudaStream_t st) {
  if (S == 1)
    launch<T, D, 1>(q, kq, ks, vq, vs, q_idx, kv_idx, kv_valid, out, partial,
                    counters, B, H, S, cap, splits, slots_per_split, st);
  else
    launch<T, D, MAX_S>(q, kq, ks, vq, vs, q_idx, kv_idx, kv_valid, out,
                        partial, counters, B, H, S, cap, splits,
                        slots_per_split, st);
}

template <typename T>
int dispatch_d(const void* q, const void* kq, const void* ks, const void* vq,
               const void* vs, const void* q_idx, const void* kv_idx,
               const void* kv_valid, void* out, float* partial, int* counters,
               int B, int H, int S, int D, int cap, int splits,
               int slots_per_split, cudaStream_t st) {
  switch (D) {
    case 32:
      launch_s<T, 32>(q, kq, ks, vq, vs, q_idx, kv_idx, kv_valid, out,
                      partial, counters, B, H, S, cap, splits,
                      slots_per_split, st);
      break;
    case 64:
      launch_s<T, 64>(q, kq, ks, vq, vs, q_idx, kv_idx, kv_valid, out,
                      partial, counters, B, H, S, cap, splits,
                      slots_per_split, st);
      break;
    case 128:
      launch_s<T, 128>(q, kq, ks, vq, vs, q_idx, kv_idx, kv_valid, out,
                       partial, counters, B, H, S, cap, splits,
                       slots_per_split, st);
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
// out [B, H, S, D] like q. The slots are cut into `splits` runs of
// slots_per_split (a multiple of 32; splits * slots_per_split >= cap >
// (splits - 1) * slots_per_split); with splits > 1, workspace holds
// B*H*splits*S*(D + 2) floats and counters B*H zero ints, left at zero.
extern "C" int bt_decode_attention_int8(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* q_idx, const void* kv_idx,
    const void* kv_valid, void* out, void* workspace, void* counters, int B,
    int H, int S, int D, int cap, int splits, int slots_per_split,
    int q_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > MAX_S || cap < 1 || splits < 1 ||
      slots_per_split % TILE != 0 || (long)splits * slots_per_split < cap ||
      (long)(splits - 1) * slots_per_split >= cap ||
      (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* partial = static_cast<float*>(workspace);
  int* ctr = static_cast<int*>(counters);
  if (q_bf16)
    return dispatch_d<__nv_bfloat16>(q, kq, ks, vq, vs, q_idx, kv_idx,
                                     kv_valid, out, partial, ctr, B, H, S, D,
                                     cap, splits, slots_per_split, st);
  return dispatch_d<float>(q, kq, ks, vq, vs, q_idx, kv_idx, kv_valid, out,
                           partial, ctr, B, H, S, D, cap, splits,
                           slots_per_split, st);
}
