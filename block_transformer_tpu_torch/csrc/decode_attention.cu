// K2: decode attention over a stacked KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel block_transformer_tpu/ops/decode_attention.py
// (_make_kernel / _decode_attn) in both its forms: INT8 (entry
// decode_attention_int8_stacked) and unquantized (quantized=False, entry
// decode_attention_stacked: a bf16 or float32 cache of the query's type).
// For each (b, h) and each of S <= 8 query rows:
//
//   INT8:   s[j] = (q . k_q[j]) * (k_scale[j] / sqrt(D))
//           out  = sum_j softmax(s)[j] * v_scale[j] * v_q[j]
//   float:  s[j] = (q . k[j]) / sqrt(D)
//           out  = sum_j T(softmax(s)[j]) * v[j]
//   s[j]  = -1e30 where not (kv_idx[j] <= q_idx[b, s] and kv_valid[b, j])
//
// with a float32 softmax. A row with no allowed key gets the uniform mean
// over all cap slots, like the reference; slots past cap weigh nothing. The
// caller passes one layer's cache (base pointers of layer `layer` inside the
// stacked [L, B, H, cap, D] arrays), so no slice of the cache is copied.
// INT8: v_scale multiplies the probability, kept in float32 (the Pallas
// kernel casts p * v_scale to the query's type before P.V), and k_scale the
// score, so the cache is never dequantized in memory. Float: the
// probability is rounded to the query's type T before P.V, as the Pallas
// kernel (p.astype(cdt)) and attention_xla do.
//
// What bounds it on the H100: it reads the layer's cache once, B*H*cap
// rows of keys and values (D bytes each plus 8 bytes of scales a slot for
// INT8, 2*D bytes for bf16) against ~4*S*D operations per slot: at S <= 8
// it is bound by bytes, and at decode (B*H of 128-256) by how many bytes
// are in flight.
//
// Design (split-KV decoding), shared by both forms.
// - The grid is (splits, H, B): the capacity is cut into `splits` runs of
//   slots_per_split slots (whole 32-slot tiles), chosen in Python
//   (kernels/decode_attention.py, plan()) so that the launch puts several
//   blocks on every SM; one split when B*H alone does.
// - A block is 4 warps; a warp walks the 32-slot tiles of its split dealt
//   round-robin.
// - Scores: each lane owns one key, reads its row with 16-byte loads and
//   dots it with the query rows held in shared memory.
// - P.V: every lane reads 4 contiguous values of a value row, so a warp
//   reads whole 128-byte lines at every head dim; the probabilities go
//   through a warp's own shared row. Each warp keeps its online-softmax
//   state (max, sum, S x 4 float32 accumulators a lane) and the block
//   merges its warps through shared memory.
// - With more than one split each block writes its (max, sum, acc[S][D])
//   partials in float32 to a scratch buffer; the last split of a (b, h) to
//   arrive (an atomic counter per (b, h), left at zero for the next launch)
//   merges them and writes the output: no second launch. A split whose
//   every slot is masked holds max -1e30 and merges to nothing beside a
//   split with an allowed key, and to the uniform mean when no split has
//   one.
// INT8 form: each warp loads the next tile's key rows, value rows, scales
// and mask into registers before the current tile's math, so two tiles a
// warp are in flight; int8 is widened by the exact byte permute onto a 2^23
// bias (mma.cuh), not the quarter-rate integer-to-float conversions.
// Float form: a bf16 key row is twice the int8 one (256 bytes at D = 128,
// 64 registers a lane), so two tiles in flight would not fit the register
// file; a warp holds one tile at a time, reading a key row, then the tile's
// value rows, in groups of at most 256 bytes a lane, and leaves the
// latency to the other warps of the SM. bf16 is widened exactly by a shift
// into the high half of a float. At the block decoder's decode shape
// plan() gives each warp one tile anyway.

#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace bt;   // biased_byte, to_f32, from_f32, round_to, kNeg

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

// The block's shared memory: the query rows, each warp's probabilities of
// its tile, and each warp's softmax state for the merge.
template <int D, int NS>
struct Smem {
  __align__(16) float qs[NS][D];
  float pw[WARPS][TILE][NS];
  float m_w[WARPS][NS];
  float l_w[WARPS][NS];
  __align__(16) float acc_w[WARPS][NS][D];
  int last;
};

template <typename T, int D, int NS>
__device__ __forceinline__ void load_query(Smem<D, NS>& sm,
                                           const T* __restrict__ q, size_t bh,
                                           int S, int tid) {
  for (int i = tid; i < NS * D; i += THREADS) {
    const int s = i / D;
    sm.qs[s][i % D] = s < S ? to_f32(q[bh * S * D + i]) : 0.f;
  }
  __syncthreads();
}

// The end of a block, the same for both forms: each warp's state (sums over
// lanes, accumulators over the lanes that share a column, those RPS rows
// apart) goes to shared memory; the block's (max, sum, acc) is the output
// with one split, else this split's partials, and the last split of this
// (b, h) to arrive merges all of them, in split order, leaving the counter
// at zero for the next launch. LPR: lanes a value row (D / 4).
template <typename T, int D, int NS, int LPR>
__device__ __forceinline__ void finish(Smem<D, NS>& sm, float (&m)[NS],
                                       float (&l)[NS], float (&acc)[NS][4],
                                       T* __restrict__ out,
                                       float* __restrict__ partial,
                                       int* __restrict__ counters, int H,
                                       int S, size_t bh, int warp, int lane,
                                       int tid) {
  const int split = blockIdx.x, splits = gridDim.x;
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
      *reinterpret_cast<float4*>(&sm.acc_w[warp][s][lane * 4]) =
          make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
    if (lane == 0) {
      sm.m_w[warp][s] = m[s];
      sm.l_w[warp][s] = l[s];
    }
  }
  __syncthreads();

  const size_t base = bh * splits + split;   // [B*H][splits]
  float* part_acc = partial;
  float* part_ml = partial + (size_t)gridDim.z * H * splits * S * D;
  for (int i = tid; i < S * D; i += THREADS) {
    const int s = i / D, d = i % D;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm.m_w[w][s]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm.m_w[w][s] - mx);
      lsum += sm.l_w[w][s] * c;
      a += sm.acc_w[w][s][d] * c;
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

  __threadfence();
  __syncthreads();
  if (tid == 0) {
    sm.last = atomicAdd(counters + bh, 1) == splits - 1;
    if (sm.last) counters[bh] = 0;
  }
  __syncthreads();
  if (!sm.last) return;
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

// One tile's online-softmax step for a lane holding key score sc[s] (before
// masking): updates (m, l), rescales acc and leaves the lane's probability
// in sc[s]. `in`: the slot lies before j_end.
template <int NS>
__device__ __forceinline__ void softmax_step(float (&sc)[NS], float (&m)[NS],
                                             float (&l)[NS],
                                             float (&acc)[NS][4],
                                             const int (&qi)[NS], int S,
                                             float k_mul, bool ok, int idx,
                                             bool in) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s >= S) break;
    float x = sc[s] * k_mul;
    if (!(ok && idx <= qi[s])) x = kNeg;
    if (!in) x = -INFINITY;   // past the capacity: no weight at all
    const float m_new = fmaxf(m[s], warp_max(x));
    const float corr = expf(m[s] - m_new);
    const float p = expf(x - m_new);
    l[s] = l[s] * corr + p;   // this lane's share of the sum
    m[s] = m_new;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[s][e] *= corr;
    sc[s] = p;
  }
}

// ---------------------------------------------------------------------------
// INT8 form
// ---------------------------------------------------------------------------

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
  __shared__ Smem<D, NS> sm;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bh = (size_t)b * H + h;
  load_query<T, D, NS>(sm, q, bh, S, tid);

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
              *reinterpret_cast<const float4*>(&sm.qs[s][c * 16 + e4 * 4]);
          sc[s] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
        }
      }
    }

    const bool in = j_begin + t * TILE + lane < j_end;
    softmax_step<NS>(sc, m, l, acc, qi, S, cur.ks * sm_scale, cur.ok,
                     cur.idx, in);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s >= S) break;
      sm.pw[warp][lane][s] = sc[s] * cur.vs;
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
        const float p = sm.pw[warp][r][s];
        acc[s][0] += p * v0;
        acc[s][1] += p * v1;
        acc[s][2] += p * v2;
        acc[s][3] += p * v3;
      }
    }
    __syncwarp();   // pw is rewritten by the next tile
    if (more) cur = nxt;
  }
  finish<T, D, NS, LPR>(sm, m, l, acc, out, partial, counters, H, S, bh,
                        warp, lane, tid);
}

// ---------------------------------------------------------------------------
// Float form (bf16 or float32 cache, of the query's type T)
// ---------------------------------------------------------------------------

// A 16-byte chunk of T values widened to float32, exactly: 8 bf16 (each the
// high half of a float) or 4 floats.
template <typename T> struct Wide;
template <> struct Wide<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void chunk(const uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  using Four = uint2;   // 4 values, as loaded
  __device__ __forceinline__ static float4 four(const uint2 u) {
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
};
template <> struct Wide<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void chunk(const uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  using Four = uint4;
  __device__ __forceinline__ static float4 four(const uint4 u) {
    return make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                       __uint_as_float(u.z), __uint_as_float(u.w));
  }
};

// One tile a warp, so less in registers than the INT8 form.
constexpr int min_blocks_float(int NS) { return NS > 1 ? 2 : 3; }

template <typename T, int D, int NS>
__global__ void __launch_bounds__(THREADS, min_blocks_float(NS))
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ q_idx,
                   const int* __restrict__ kv_idx,
                   const int* __restrict__ kv_valid, T* __restrict__ out,
                   float* __restrict__ partial, int* __restrict__ counters,
                   int H, int S, int cap, int slots_per_split,
                   float sm_scale) {
  using W = Wide<T>;
  using Four = typename W::Four;
  constexpr int EPC = W::N;                  // values a 16-byte chunk
  constexpr int NCH = D / EPC;               // chunks a key row
  constexpr int KG = NCH < 16 ? NCH : 16;    // chunks loaded together
  constexpr int LPR = D / 4, RPS = 32 / LPR; // value rows: lanes a row, rows a step
  constexpr int VW = TILE / RPS;             // 4-value loads a lane a tile
  constexpr int VG0 = 256 / (4 * (int)sizeof(T));
  constexpr int VG = VW < VG0 ? VW : VG0;    // value loads together
  __shared__ Smem<D, NS> sm;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bh = (size_t)b * H + h;
  load_query<T, D, NS>(sm, q, bh, S, tid);

  const T* kb = kc + bh * cap * D;
  const T* vb = vc + bh * cap * D;
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

  const int col = (lane % LPR) * 4;
  for (int t = warp; t < n_tiles; t += WARPS) {
    const int j0 = j_begin + t * TILE, j = j0 + lane;
    const bool in = j < j_end;
    const int idx = in ? kv_idx[j] : 0;
    const bool ok = in && valid_b[j] != 0;

    float sc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) sc[s] = 0.f;
    if (in) {
      const uint4* krow = reinterpret_cast<const uint4*>(kb + (size_t)j * D);
#pragma unroll
      for (int g = 0; g < NCH; g += KG) {
        uint4 raw[KG];
#pragma unroll
        for (int c = 0; c < KG; ++c) raw[c] = krow[g + c];
#pragma unroll
        for (int c = 0; c < KG; ++c) {
          float f[EPC];
          W::chunk(raw[c], f);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            if (s >= S) break;
#pragma unroll
            for (int e4 = 0; e4 < EPC; e4 += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(
                  &sm.qs[s][(g + c) * EPC + e4]);
              sc[s] += qv.x * f[e4] + qv.y * f[e4 + 1] + qv.z * f[e4 + 2] +
                       qv.w * f[e4 + 3];
            }
          }
        }
      }
    }

    softmax_step<NS>(sc, m, l, acc, qi, S, sm_scale, ok, idx, in);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s >= S) break;
      sm.pw[warp][lane][s] = round_to<T>(sc[s]);
    }
    __syncwarp();

#pragma unroll
    for (int g = 0; g < VW; g += VG) {
      Four raw[VG];
#pragma unroll
      for (int i = 0; i < VG; ++i) {
        const int row = j0 + (g + i) * RPS + lane / LPR;
        raw[i] = row < j_end ? *reinterpret_cast<const Four*>(
                                   vb + (size_t)row * D + col)
                             : Four{};
      }
#pragma unroll
      for (int i = 0; i < VG; ++i) {
        const int r = (g + i) * RPS + lane / LPR;   // the tile's value row
        const float4 v = W::four(raw[i]);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          if (s >= S) break;
          const float p = sm.pw[warp][r][s];
          acc[s][0] += p * v.x;
          acc[s][1] += p * v.y;
          acc[s][2] += p * v.z;
          acc[s][3] += p * v.w;
        }
      }
    }
    __syncwarp();   // pw is rewritten by the next tile
  }
  finish<T, D, NS, LPR>(sm, m, l, acc, out, partial, counters, H, S, bh,
                        warp, lane, tid);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Pointers of one launch: q, the layer's cache (values, and scales for
// INT8), the mask vectors, out and the split's scratch.
struct Args {
  const void *q, *k, *ks, *v, *vs, *q_idx, *kv_idx, *kv_valid;
  void* out;
  float* partial;
  int* counters;
  int B, H, S, cap, splits, slots_per_split;
};

template <typename T, int D, int NS, bool INT8>
void launch(const Args& a, cudaStream_t stream) {
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid(a.splits, a.H, a.B);
  if constexpr (INT8)
    decode_attn_int8_kernel<T, D, NS><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(a.q), static_cast<const int8_t*>(a.k),
        static_cast<const float*>(a.ks), static_cast<const int8_t*>(a.v),
        static_cast<const float*>(a.vs), static_cast<const int*>(a.q_idx),
        static_cast<const int*>(a.kv_idx), static_cast<const int*>(a.kv_valid),
        static_cast<T*>(a.out), a.partial, a.counters, a.H, a.S, a.cap,
        a.slots_per_split, sm_scale);
  else
    decode_attn_kernel<T, D, NS><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const int*>(a.q_idx),
        static_cast<const int*>(a.kv_idx), static_cast<const int*>(a.kv_valid),
        static_cast<T*>(a.out), a.partial, a.counters, a.H, a.S, a.cap,
        a.slots_per_split, sm_scale);
}

template <typename T, bool INT8>
int dispatch(const Args& a, int D, cudaStream_t st) {
  const bool one = a.S == 1;
  switch (D) {
    case 32:
      one ? launch<T, 32, 1, INT8>(a, st) : launch<T, 32, MAX_S, INT8>(a, st);
      break;
    case 64:
      one ? launch<T, 64, 1, INT8>(a, st) : launch<T, 64, MAX_S, INT8>(a, st);
      break;
    case 128:
      one ? launch<T, 128, 1, INT8>(a, st)
          : launch<T, 128, MAX_S, INT8>(a, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_split(int S, int cap, int splits, int slots_per_split,
               const void* workspace, const void* counters) {
  return S < 1 || S > MAX_S || cap < 1 || splits < 1 ||
         slots_per_split % TILE != 0 || (long)splits * slots_per_split < cap ||
         (long)(splits - 1) * slots_per_split >= cap ||
         (splits > 1 && (workspace == nullptr || counters == nullptr));
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
  if (bad_split(S, cap, splits, slots_per_split, workspace, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kq, ks, vq, vs, q_idx, kv_idx, kv_valid, out,
               static_cast<float*>(workspace), static_cast<int*>(counters),
               B, H, S, cap, splits, slots_per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q_bf16 ? dispatch<__nv_bfloat16, true>(a, D, st)
                : dispatch<float, true>(a, D, st);
}

// The float form: q, k, v, out all bf16 (q_bf16 != 0) or all float; k/v
// [B, H, cap, D] of one layer, 16-byte aligned; everything else as above.
extern "C" int bt_decode_attention(
    const void* q, const void* k, const void* v, const void* q_idx,
    const void* kv_idx, const void* kv_valid, void* out, void* workspace,
    void* counters, int B, int H, int S, int D, int cap, int splits,
    int slots_per_split, int q_bf16, void* stream) {
  if (bad_split(S, cap, splits, slots_per_split, workspace, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, nullptr, v, nullptr, q_idx, kv_idx, kv_valid, out,
               static_cast<float*>(workspace), static_cast<int*>(counters),
               B, H, S, cap, splits, slots_per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q_bf16 ? dispatch<__nv_bfloat16, false>(a, D, st)
                : dispatch<float, false>(a, D, st);
}
