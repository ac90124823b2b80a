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
// stacked [L, B, H, cap, D] arrays), so no slice of the cache is copied, and
// the mask's own vectors: q_idx is [S] (q_stride 0) or [B, S] (q_stride S),
// and a null kv_valid means every slot is valid, so the caller makes no
// device copy of the mask. INT8: v_scale multiplies the probability, kept in
// float32 (the Pallas kernel casts p * v_scale to the query's type before
// P.V), and k_scale the score, so the cache is never dequantized in memory.
// Float: the probability is rounded to the query's type T before P.V, as
// the Pallas kernel (p.astype(cdt)) and attention_xla do.
//
// What bounds it on the H100: it reads the layer's cache once, B*H*cap
// rows of keys and values (D bytes each plus 8 bytes of scales a slot for
// INT8, 2*D bytes for bf16) against ~4*S*D operations per slot: at S <= 8
// it is bound by bytes, and at decode (B*H of 128-256) by how many bytes
// are in flight. At the token decoder's local cache (6 slots) it is bound
// by the launch itself: a few kilobytes a launch.
//
// Three kernels; which one runs is the pure function route() in
// kernels/decode_attention.py.
//
// 1. The split route (both forms, and every INT8 launch). The grid is
//    (splits, H, B): the capacity is cut into `splits` runs of
//    slots_per_split slots (whole 32-slot tiles), chosen in Python (plan())
//    so that the launch puts several blocks on every SM; one split when B*H
//    alone does. A block is 4 warps. With more than one split each block
//    writes its (max, sum, acc[S][D]) partials in float32 to a scratch
//    buffer; the last split of a (b, h) to arrive (an atomic counter per
//    (b, h), left at zero for the next launch) merges them and writes the
//    output: no second launch. A split whose every slot is masked holds max
//    -1e30 and merges to nothing beside a split with an allowed key, and to
//    the uniform mean when no split has one.
//    INT8 form: a warp walks the 32-slot tiles of its split dealt
//    round-robin, one key a lane (16-byte loads of its row, dotted with the
//    query rows in shared memory); every lane reads 4 contiguous values of
//    a value row, so a warp reads whole 128-byte lines. Each warp loads the
//    next tile's key rows, value rows, scales and mask into registers
//    before the current tile's math, so two tiles a warp are in flight;
//    int8 is widened by the exact byte permute onto a 2^23 bias (mma.cuh).
//    Float form: a bf16 tile is 16 KB of keys and values at D = 128, too
//    large to hold two of in registers. The block's 128 threads stage the
//    split's tiles into shared memory by 16-byte cp.async copies, in a ring
//    of STAGES tiles (the tile after the current one is in flight during
//    the current one's math, without registers), and each warp reads 8 rows
//    of every tile from the ring with lanes over D (the warp route's math
//    below). The mask of the next tile is loaded into registers a step
//    ahead. Ring, 2 stages: 32 KB a block at bf16 D = 128, so the 5 blocks
//    an SM that plan()'s 640-block launch at the block decoder asks for fit
//    (160 KB of the SM's 228 KB) and the launch runs in one wave; 3 stages
//    (48 KB, 4 blocks an SM) measured 0.0244 ms there against 0.0211 for 2.
//    The merge's shared memory reuses the ring.
// 2. The warp route (float form, cap <= 32: the token decoder's local
//    cache). One warp per (b, h), WPB = 4 warps a block (measured on the
//    H100 at B*H = 128, cap 6, D = 128, bf16: 0.00288 ms a call with 4
//    warps a block, 0.00289 with 2, 0.00300 with 1, which spreads the warps
//    over 128 of the 132 SMs). Each lane owns D/32
//    contiguous dims, so at D = 128 in bf16 a lane reads 8 bytes of a key
//    or value row and a warp reads whole rows. The mask of slot `lane`, the
//    query rows and the keys and values of the first 8 rows are all loaded
//    before any math. Scores: per-lane partial dots of every (query row,
//    key row) pair of the group, reduced across the warp by one butterfly
//    that halves the values a lane holds at every step (8 * NS partials in
//    log2 steps, not one 5-step chain each); the softmax runs in registers
//    in float32, and each lane accumulates P.V for its own dims and writes
//    them. No shared memory, no __syncthreads, no scratch, no counters.
//    NS (the query rows a lane holds) is S rounded up to 1, 2, 4 or 8.

#include <climits>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace bt;   // biased_byte, to_f32, from_f32, round_to, kNeg

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 32;   // slots of a tile
constexpr int G = 8;       // key rows a warp takes at a time, lanes over D
constexpr int MAX_S = 8;
constexpr int WPB = 4;     // warps a block on the warp route
constexpr int STAGES = 2;  // tiles in the float split route's ring
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

// Each warp's softmax state, for the merge of the split route's warps.
template <int D, int NS>
struct MergeSmem {
  float m_w[WARPS][NS];
  float l_w[WARPS][NS];
  __align__(16) float acc_w[WARPS][NS][D];
  int last;
};

// The end of a split-route block, after every warp's state is in `sm` and
// the block has synchronised: the block's (max, sum, acc) is the output
// with one split, else this split's partials, and the last split of this
// (b, h) to arrive merges all of them, in split order, leaving the counter
// at zero for the next launch.
template <typename T, int D, int NS>
__device__ __forceinline__ void merge(MergeSmem<D, NS>& sm,
                                      T* __restrict__ out,
                                      float* __restrict__ partial,
                                      int* __restrict__ counters, int H, int S,
                                      size_t bh, int tid) {
  const int split = blockIdx.x, splits = gridDim.x;
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

// ---------------------------------------------------------------------------
// INT8 form (split route)
// ---------------------------------------------------------------------------

// The block's shared memory: the query rows, each warp's probabilities of
// its tile, and each warp's softmax state for the merge.
template <int D, int NS>
struct Smem {
  __align__(16) float qs[NS][D];
  float pw[WARPS][TILE][NS];
  MergeSmem<D, NS> mg;
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

// Each warp's state (sums over lanes, accumulators over the lanes that
// share a column, those RPS rows apart) into shared memory, then the merge.
// LPR: lanes a value row (D / 4).
template <typename T, int D, int NS, int LPR>
__device__ __forceinline__ void finish(Smem<D, NS>& sm, float (&m)[NS],
                                       float (&l)[NS], float (&acc)[NS][4],
                                       T* __restrict__ out,
                                       float* __restrict__ partial,
                                       int* __restrict__ counters, int H,
                                       int S, size_t bh, int warp, int lane,
                                       int tid) {
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
      *reinterpret_cast<float4*>(&sm.mg.acc_w[warp][s][lane * 4]) =
          make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
    if (lane == 0) {
      sm.mg.m_w[warp][s] = m[s];
      sm.mg.l_w[warp][s] = l[s];
    }
  }
  __syncthreads();
  merge<T, D, NS>(sm.mg, out, partial, counters, H, S, bh, tid);
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
  // valid: the batch row's kv_valid, or null (every slot valid).
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
      ok = valid == nullptr || valid[j] != 0;
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
                        int q_stride, float sm_scale) {
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
  const int* valid_b = kv_valid ? kv_valid + (size_t)b * cap : nullptr;
  const int j_begin = split * slots_per_split;
  const int j_end = min(cap, j_begin + slots_per_split);
  const int n_tiles = (j_end - j_begin + TILE - 1) / TILE;

  int qi[NS];
  float m[NS], l[NS], acc[NS][4];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    qi[s] = s < S ? q_idx[b * q_stride + s] : INT_MIN;
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
// Float form: lanes over D (the warp route, and the split route's warps)
// ---------------------------------------------------------------------------

template <int BYTES> struct RawOf;
template <> struct RawOf<2> { using type = unsigned short; };
template <> struct RawOf<4> { using type = uint32_t; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<16> { using type = uint4; };

// The N = D / 32 contiguous values of a row that a lane owns, as loaded
// (Raw, N * sizeof(T) bytes), and widened exactly to float32: a bf16 is the
// high half of a float.
template <typename T, int D>
struct Part {
  static constexpr int N = D / 32;
  using Raw = typename RawOf<N * (int)sizeof(T)>::type;

  __device__ __forceinline__ static Raw load(const T* row, int lane) {
    return *reinterpret_cast<const Raw*>(row + lane * N);
  }

  __device__ __forceinline__ static void widen(const Raw& r, float (&f)[N]) {
    if constexpr (std::is_same_v<T, float>) {
      if constexpr (N == 1) {
        f[0] = __uint_as_float(r);
      } else if constexpr (N == 2) {
        f[0] = __uint_as_float(r.x);
        f[1] = __uint_as_float(r.y);
      } else {
        f[0] = __uint_as_float(r.x);
        f[1] = __uint_as_float(r.y);
        f[2] = __uint_as_float(r.z);
        f[3] = __uint_as_float(r.w);
      }
    } else {
      if constexpr (N == 1) {
        f[0] = __uint_as_float(static_cast<uint32_t>(r) << 16);
      } else if constexpr (N == 2) {
        f[0] = __uint_as_float(r << 16);
        f[1] = __uint_as_float(r & 0xffff0000u);
      } else {
        f[0] = __uint_as_float(r.x << 16);
        f[1] = __uint_as_float(r.x & 0xffff0000u);
        f[2] = __uint_as_float(r.y << 16);
        f[3] = __uint_as_float(r.y & 0xffff0000u);
      }
    }
  }
};

// Sums each of a lane's N partials over the warp: at each step the lane
// keeps half of its values (the upper half when its bit O is set) and adds
// its partner's copy of that half, so after log2(N) steps (at most 5) value
// i of a lane holds the full sum of index (lane >> (5 - steps)) * rest + i;
// with fewer than 32 values the last value is then summed over the lanes
// that share it.
template <int N, int O>
__device__ __forceinline__ void halve(float* v, int lane) {
  if constexpr (N > 1 && O > 0) {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? v[i] : v[i + N / 2];
      const float keep = up ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, O);
    }
    halve<N / 2, O / 2>(v, lane);
  } else if constexpr (O > 0) {
#pragma unroll
    for (int o = O; o > 0; o >>= 1) v[0] += __shfl_xor_sync(FULL, v[0], o);
  }
}

// A warp's attention over groups of G key rows, lanes over D, for NS query
// rows. The 8 * NS partial scores (index s * G + j) are reduced by halve():
// a lane then holds R of them, indices (lane / DUP) * R + r, the same
// value in DUP lanes; query row s's scores sit in the SEG lanes
// [s * SEG, (s + 1) * SEG), which hold its online-softmax state (m, l).
// Every lane holds acc[s][:] for its own N dims.
template <typename T, int D, int NS>
struct WarpAttn {
  using P_ = Part<T, D>;
  using Raw = typename P_::Raw;
  static constexpr int N = P_::N;
  static constexpr int P = G * NS;
  static constexpr int R = P > 32 ? P / 32 : 1;
  static constexpr int DUP = P >= 32 ? 1 : 32 / P;
  static constexpr int SEG = 32 / NS;

  float q[NS][N];
  float acc[NS][N];
  float m, l;
  int qv;   // q_idx of this lane's query row (lane / SEG)

  // q_bh: the (b, h) query rows [S][D] (any alignment: element loads);
  // qi: lane s < S holds q_idx[b, s].
  __device__ __forceinline__ void init(const T* __restrict__ q_bh, int S,
                                       int qi, int lane) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        q[s][e] = s < S ? to_f32(q_bh[s * D + lane * N + e]) : 0.f;
        acc[s][e] = 0.f;
      }
    }
    m = kNeg;
    l = 0.f;
    qv = __shfl_sync(FULL, qi, lane / SEG);
  }

  // Value row j's parts this lane owns: from registers (the warp route)
  // or from the shared-memory ring (the split route).
  __device__ __forceinline__ static Raw vrow(const Raw (&vr)[G], int j, int) {
    return vr[j];
  }
  __device__ __forceinline__ static Raw vrow(const T* vs, int j, int lane) {
    return P_::load(vs + j * D, lane);
  }

  // One group: kr the G key rows' parts this lane owns, vrows the value
  // rows' (registers, or the ring's rows); zero past the end. Lane j < G
  // holds row j's kv_idx in gidx; bit j of gok: row j exists and is valid;
  // of gin: row j exists.
  template <class V>
  __device__ __forceinline__ void step(const Raw (&kr)[G], const V& vrows,
                                       int gidx, uint32_t gok, uint32_t gin,
                                       float sm_scale, int lane) {
    float part[P];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float kf[N];
      P_::widen(kr[j], kf);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) a = fmaf(q[s][e], kf[e], a);
        part[s * G + j] = a;
      }
    }
    halve<P, 16>(part, lane);

    float x[R];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = ((lane / DUP) * R + r) % G;
      const int kidx = __shfl_sync(FULL, gidx, j);
      float sc = part[r] * sm_scale;
      if (!((gok >> j) & 1u) || kidx > qv) sc = kNeg;
      if (!((gin >> j) & 1u)) sc = -INFINITY;   // no slot: no weight at all
      x[r] = sc;
      mx = fmaxf(mx, sc);
    }
#pragma unroll
    for (int o = DUP; o < SEG; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float p[R], ps = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = expf(x[r] - m_new);
      ps += p[r];
      p[r] = round_to<T>(p[r]);
    }
#pragma unroll
    for (int o = DUP; o < SEG; o <<= 1) ps += __shfl_xor_sync(FULL, ps, o);
    l = l * corr + ps;
    m = m_new;

#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float c = __shfl_sync(FULL, corr, s * SEG);
#pragma unroll
      for (int e = 0; e < N; ++e) acc[s][e] *= c;
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float vf[N];
      P_::widen(vrow(vrows, j, lane), vf);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int idx = s * G + j;
        const float pj = __shfl_sync(FULL, p[idx % R], (idx / R) * DUP);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[s][e] = fmaf(pj, vf[e], acc[s][e]);
      }
    }
  }

  // The output rows [S][D] of this (b, h): this lane's dims.
  __device__ __forceinline__ void store(T* __restrict__ out_bh, int S,
                                        int lane) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s >= S) break;
      const float ls = fmaxf(__shfl_sync(FULL, l, s * SEG), 1e-30f);
#pragma unroll
      for (int e = 0; e < N; ++e)
        out_bh[s * D + lane * N + e] = from_f32<T>(acc[s][e] / ls);
    }
  }

  // This warp's state into the split route's merge memory.
  __device__ __forceinline__ void stash(MergeSmem<D, NS>& sm, int S,
                                        int warp, int lane) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s >= S) break;
#pragma unroll
      for (int e = 0; e < N; ++e) sm.acc_w[warp][s][lane * N + e] = acc[s][e];
    }
    if (lane % SEG == 0 && lane / SEG < S) {
      sm.m_w[warp][lane / SEG] = m;
      sm.l_w[warp][lane / SEG] = l;
    }
  }
};

// The warp route: one warp per (b, h) pair (bh < BH), cap <= 32. With
// float32 rows and 8 query rows a lane holds ~190 values; one block an SM
// lets ptxas give them registers.
template <typename T, int D, int NS>
__global__ void __launch_bounds__(32 * WPB, 1)
decode_attn_warp_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ q_idx,
                        const int* __restrict__ kv_idx,
                        const int* __restrict__ kv_valid, T* __restrict__ out,
                        int BH, int H, int S, int cap, int q_stride,
                        float sm_scale) {
  using A = WarpAttn<T, D, NS>;
  using Row = Part<T, D>;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (bh >= BH) return;   // the whole warp
  const int b = bh / H;
  const T* kb = kc + (size_t)bh * cap * D;
  const T* vb = vc + (size_t)bh * cap * D;

  // Every load before any math: the mask of slot `lane`, q_idx, the query
  // rows, and the first group's key and value rows.
  const bool live = lane < cap;
  const int idx = live ? kv_idx[lane] : 0;
  const bool ok = live && (kv_valid == nullptr ||
                           kv_valid[(size_t)b * cap + lane] != 0);
  const int qi = lane < S ? q_idx[b * q_stride + lane] : INT_MIN;
  typename A::Raw kr[G], vr[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const bool in = j < cap;
    kr[j] = in ? Row::load(kb + (size_t)j * D, lane) : typename A::Raw{};
    vr[j] = in ? Row::load(vb + (size_t)j * D, lane) : typename A::Raw{};
  }
  A st;
  st.init(q + (size_t)bh * S * D, S, qi, lane);
  const uint32_t okb = __ballot_sync(FULL, ok), inb = __ballot_sync(FULL, live);

#pragma unroll 1
  for (int g0 = 0;;) {
    const int gidx = __shfl_sync(FULL, idx, (g0 + (lane & (G - 1))) & 31);
    st.step(kr, vr, gidx, okb >> g0, inb >> g0, sm_scale, lane);
    g0 += G;
    if (g0 >= cap) break;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const bool in = g0 + j < cap;
      kr[j] = in ? Row::load(kb + (size_t)(g0 + j) * D, lane)
                 : typename A::Raw{};
      vr[j] = in ? Row::load(vb + (size_t)(g0 + j) * D, lane)
                 : typename A::Raw{};
    }
  }
  st.store(out + (size_t)bh * S * D, S, lane);
}

// The float split route's shared memory: a ring of STAGES tiles (keys then
// values, [TILE][D] each), reused for the merge once the tiles are read.
template <typename T, int D, int NS>
struct SplitSmem {
  static constexpr int TILE_ELEMS = TILE * D;
  static constexpr int STAGE_BYTES = 2 * TILE_ELEMS * (int)sizeof(T);
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int MERGE = (int)sizeof(MergeSmem<D, NS>);
  static constexpr int BYTES = RING > MERGE ? RING : MERGE;
  static constexpr int CHUNKS = STAGE_BYTES / 16;   // 16-byte copies a stage
  static constexpr int ROW_CHUNKS = D * (int)sizeof(T) / 16;
  static_assert(CHUNKS % THREADS == 0, "a stage is whole copies a thread");
};

// Registers: one query row at bf16 fits the 5 blocks an SM of plan()'s
// launch at the block decoder; float32 rows hold twice the registers.
template <typename T>
constexpr int min_blocks_split(int NS) {
  return NS > 1 ? 2 : std::is_same_v<T, float> ? 3 : 5;
}

template <typename T, int D, int NS>
__global__ void __launch_bounds__(THREADS, min_blocks_split<T>(NS))
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ q_idx,
                   const int* __restrict__ kv_idx,
                   const int* __restrict__ kv_valid, T* __restrict__ out,
                   float* __restrict__ partial, int* __restrict__ counters,
                   int H, int S, int cap, int slots_per_split, int q_stride,
                   float sm_scale) {
  using A = WarpAttn<T, D, NS>;
  using Row = Part<T, D>;
  using L = SplitSmem<T, D, NS>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bh = (size_t)b * H + h;
  const T* kb = kc + bh * cap * D;
  const T* vb = vc + bh * cap * D;
  const int* valid_b = kv_valid ? kv_valid + (size_t)b * cap : nullptr;
  const int j_begin = split * slots_per_split;
  const int j_end = min(cap, j_begin + slots_per_split);
  const int n_tiles = (j_end - j_begin + TILE - 1) / TILE;

  // Tile t of the split into ring stage t % STAGES; rows from j_end on are
  // zero-filled.
  auto copy_tile = [&](int t) {
    const int j0 = j_begin + t * TILE;
    T* stage = reinterpret_cast<T*>(smem + (t % STAGES) * L::STAGE_BYTES);
#pragma unroll
    for (int i = 0; i < L::CHUNKS / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int half = c / (L::CHUNKS / 2), cc = c % (L::CHUNKS / 2);
      const int row = cc / L::ROW_CHUNKS, col = cc % L::ROW_CHUNKS;
      const bool in = j0 + row < j_end;
      const T* src = (half ? vb : kb) + (size_t)(in ? j0 + row : 0) * D;
      cp_async16(smem_u32(stage + half * L::TILE_ELEMS + row * D) + col * 16,
                 reinterpret_cast<const unsigned char*>(src) + col * 16, in);
    }
  };
  // The mask of this warp's rows of tile t: lane j < G holds row j's.
  auto load_mask = [&](int t, int& idx, bool& in, bool& ok) {
    const int j = j_begin + t * TILE + warp * G + lane;
    in = lane < G && j < j_end;
    idx = in ? kv_idx[j] : 0;
    ok = in && (valid_b == nullptr || valid_b[j] != 0);
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) copy_tile(t);
    cp_async_commit();
  }
  int idx_n;
  bool in_n, ok_n;
  load_mask(0, idx_n, in_n, ok_n);
  const int qi = lane < S ? q_idx[b * q_stride + lane] : INT_MIN;
  A st;
  st.init(q + bh * S * D, S, qi, lane);

  for (int t = 0; t < n_tiles; ++t) {
    if (t + STAGES - 1 < n_tiles) copy_tile(t + STAGES - 1);
    cp_async_commit();
    const int idx = idx_n;
    const bool in = in_n, ok = ok_n;
    if (t + 1 < n_tiles) load_mask(t + 1, idx_n, in_n, ok_n);   // a step ahead
    cp_async_wait<STAGES - 1>();
    __syncthreads();

    const T* stage = reinterpret_cast<const T*>(
        smem + (t % STAGES) * L::STAGE_BYTES);
    const T* ks = stage + warp * G * D;
    const T* vs = stage + L::TILE_ELEMS + warp * G * D;
    typename A::Raw kr[G];
#pragma unroll
    for (int j = 0; j < G; ++j) kr[j] = Row::load(ks + j * D, lane);
    st.step(kr, vs, idx, __ballot_sync(FULL, ok), __ballot_sync(FULL, in),
            sm_scale, lane);
    __syncthreads();   // the stage is refilled at the next step
  }
  cp_async_wait<0>();
  __syncthreads();
  MergeSmem<D, NS>& mg = *reinterpret_cast<MergeSmem<D, NS>*>(smem);
  st.stash(mg, S, warp, lane);
  __syncthreads();
  merge<T, D, NS>(mg, out, partial, counters, H, S, bh, tid);
}

__global__ void empty_kernel() {}

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
  int B, H, S, cap, splits, slots_per_split, q_stride;
};

template <typename T, int D, int NS>
cudaError_t launch_int8(const Args& a, cudaStream_t stream) {
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid(a.splits, a.H, a.B);
  decode_attn_int8_kernel<T, D, NS><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const int8_t*>(a.k),
      static_cast<const float*>(a.ks), static_cast<const int8_t*>(a.v),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.q_idx),
      static_cast<const int*>(a.kv_idx), static_cast<const int*>(a.kv_valid),
      static_cast<T*>(a.out), a.partial, a.counters, a.H, a.S, a.cap,
      a.slots_per_split, a.q_stride, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D, int NS>
cudaError_t launch_split(const Args& a, cudaStream_t stream) {
  constexpr int bytes = SplitSmem<T, D, NS>::BYTES;
  // Once a device: the largest shared-memory carveout, so the ring of
  // min_blocks_split() blocks fits an SM, and above 48 KB a block's shared
  // memory must be asked for.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(decode_attn_kernel<T, D, NS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && bytes > 48 * 1024)
      err = cudaFuncSetAttribute(decode_attn_kernel<T, D, NS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid(a.splits, a.H, a.B);
  decode_attn_kernel<T, D, NS><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.q_idx),
      static_cast<const int*>(a.kv_idx), static_cast<const int*>(a.kv_valid),
      static_cast<T*>(a.out), a.partial, a.counters, a.H, a.S, a.cap,
      a.slots_per_split, a.q_stride, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D, int NS>
cudaError_t launch_warp(const Args& a, cudaStream_t stream) {
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(D));
  const int BH = a.B * a.H;
  decode_attn_warp_kernel<T, D, NS><<<(BH + WPB - 1) / WPB, 32 * WPB, 0,
                                      stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.q_idx),
      static_cast<const int*>(a.kv_idx), static_cast<const int*>(a.kv_valid),
      static_cast<T*>(a.out), BH, a.H, a.S, a.cap, a.q_stride, sm_scale);
  return cudaGetLastError();
}

// The split routes take NS = 1 or MAX_S.
template <typename T, bool INT8, int D>
cudaError_t split_ns(const Args& a, cudaStream_t st) {
  if constexpr (INT8)
    return a.S == 1 ? launch_int8<T, D, 1>(a, st)
                    : launch_int8<T, D, MAX_S>(a, st);
  else
    return a.S == 1 ? launch_split<T, D, 1>(a, st)
                    : launch_split<T, D, MAX_S>(a, st);
}

template <typename T, bool INT8>
int dispatch_split(const Args& a, int D, cudaStream_t st) {
  switch (D) {
    case 32: return static_cast<int>(split_ns<T, INT8, 32>(a, st));
    case 64: return static_cast<int>(split_ns<T, INT8, 64>(a, st));
    case 128: return static_cast<int>(split_ns<T, INT8, 128>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The warp route takes NS = S rounded up to 1, 2, 4 or 8.
template <typename T, int D>
cudaError_t warp_ns(const Args& a, cudaStream_t st) {
  if (a.S == 1) return launch_warp<T, D, 1>(a, st);
  if (a.S == 2) return launch_warp<T, D, 2>(a, st);
  if (a.S <= 4) return launch_warp<T, D, 4>(a, st);
  return launch_warp<T, D, 8>(a, st);
}

template <typename T>
int dispatch_warp(const Args& a, int D, cudaStream_t st) {
  switch (D) {
    case 32: return static_cast<int>(warp_ns<T, 32>(a, st));
    case 64: return static_cast<int>(warp_ns<T, 64>(a, st));
    case 128: return static_cast<int>(warp_ns<T, 128>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_mask(int S, int cap, int q_stride) {
  return S < 1 || S > MAX_S || cap < 1 || (q_stride != 0 && q_stride != S);
}

bool bad_split(int S, int cap, int splits, int slots_per_split, int q_stride,
               const void* workspace, const void* counters) {
  return bad_mask(S, cap, q_stride) || splits < 1 ||
         slots_per_split % TILE != 0 || (long)splits * slots_per_split < cap ||
         (long)(splits - 1) * slots_per_split >= cap ||
         (splits > 1 && (workspace == nullptr || counters == nullptr));
}

}  // namespace

// q [B, H, S, D] (float if q_bf16 == 0, else bf16), S <= 8, D in {32, 64,
// 128}; kq/vq int8 [B, H, cap, D] and ks/vs f32 [B, H, cap] of one layer;
// q_idx int32 [S] (q_stride 0) or [B, S] (q_stride S); kv_idx int32 [cap];
// kv_valid int32 [B, cap] or null (every slot valid); out [B, H, S, D] like
// q. The slots are cut into `splits` runs of slots_per_split (a multiple of
// 32; splits * slots_per_split >= cap > (splits - 1) * slots_per_split);
// with splits > 1, workspace holds B*H*splits*S*(D + 2) floats and counters
// B*H zero ints, left at zero.
extern "C" int bt_decode_attention_int8(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* q_idx, const void* kv_idx,
    const void* kv_valid, void* out, void* workspace, void* counters, int B,
    int H, int S, int D, int cap, int splits, int slots_per_split,
    int q_stride, int q_bf16, void* stream) {
  if (bad_split(S, cap, splits, slots_per_split, q_stride, workspace,
                counters))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kq, ks, vq, vs, q_idx, kv_idx, kv_valid, out,
               static_cast<float*>(workspace), static_cast<int*>(counters),
               B, H, S, cap, splits, slots_per_split, q_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q_bf16 ? dispatch_split<__nv_bfloat16, true>(a, D, st)
                : dispatch_split<float, true>(a, D, st);
}

// The float form's split route: q, k, v, out all bf16 (q_bf16 != 0) or all
// float; k/v [B, H, cap, D] of one layer, 16-byte aligned; everything else
// as above.
extern "C" int bt_decode_attention(
    const void* q, const void* k, const void* v, const void* q_idx,
    const void* kv_idx, const void* kv_valid, void* out, void* workspace,
    void* counters, int B, int H, int S, int D, int cap, int splits,
    int slots_per_split, int q_stride, int q_bf16, void* stream) {
  if (bad_split(S, cap, splits, slots_per_split, q_stride, workspace,
                counters))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, nullptr, v, nullptr, q_idx, kv_idx, kv_valid, out,
               static_cast<float*>(workspace), static_cast<int*>(counters),
               B, H, S, cap, splits, slots_per_split, q_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q_bf16 ? dispatch_split<__nv_bfloat16, false>(a, D, st)
                : dispatch_split<float, false>(a, D, st);
}

// The float form's warp route: cap <= 32, WPB (b, h) warps a block;
// operands as above, no scratch.
extern "C" int bt_decode_attention_warp(
    const void* q, const void* k, const void* v, const void* q_idx,
    const void* kv_idx, const void* kv_valid, void* out, int B, int H, int S,
    int D, int cap, int q_stride, int q_bf16, void* stream) {
  if (bad_mask(S, cap, q_stride) || cap > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, nullptr, v, nullptr, q_idx, kv_idx, kv_valid, out,
               nullptr, nullptr, B, H, S, cap, 1, TILE, q_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q_bf16 ? dispatch_warp<__nv_bfloat16>(a, D, st)
                : dispatch_warp<float>(a, D, st);
}

// One launch of an empty kernel (one warp): the launch floor every kernel
// pays, for measurement.
extern "C" int bt_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
