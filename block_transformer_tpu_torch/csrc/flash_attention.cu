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
// 2*B*H*(2*Q + 2*K)*D bytes (bf16), less where the mask lets a query tile
// see no key of a key tile. At the main path's prefill tile (Q = 128
// queries against K = 512 keys, D = 128) that is ~51 operations per byte,
// under the card's ~295 for bf16 tensor cores: bound by bytes; the
// baseline's 2048-token prompt (Q = 2048, K = 2176, D = 64, causal) is
// bound by operations.
//
// Two routes, chosen in Python (kernels/flash_attention.py, route()):
//
// * The tensor-core route (flash_attn_tc_kernel), for bf16 with D = 64 or
//   128 (every shape of the main path), FlashAttention-2's layout on
//   mma.sync: one block of 4 warps per (query tile, h, b), each warp owning
//   16 query rows at D = 128 (64-row tiles) and 32 at D = 64 (128-row
//   tiles: two m16 tiles share each K and V fragment); key tiles of 64.
//   - Q, K and V stay bf16 in shared memory, rows padded by 16 bytes so
//     ldmatrix is free of bank conflicts. K/V tiles and their kv_idx /
//     kv_valid come by cp.async into a two-stage ring, zero-filled past
//     K: the next tile's copies are in flight during the current tile's
//     products.
//   - S = Q.K^T with mma.sync m16n8k16 (bf16 in, float32 accumulate); Q's
//     fragments are loaded once by ldmatrix and kept in registers; K,
//     stored [keys, D], is already the column-major B operand (ldmatrix
//     without .trans).
//   - The mask is built per accumulator element from q_idx, kv_idx and
//     kv_valid; the online softmax runs in the log2 domain with the row
//     max reduced over the quad that shares a row.
//   - P never touches shared memory: the float32 accumulators of two
//     adjacent 8-key tiles are rounded to bf16 (the reference rounds the
//     probabilities to the input type too) and packed straight into the
//     A fragment of P.V; V comes by ldmatrix.trans.
//   - Key tiles in which no key may be seen by any row of the query tile
//     (no valid key with kv_idx <= the tile's largest q_idx; kv_idx need
//     not be sorted) are never loaded: a bitmask of the tiles to visit is
//     built first. A row with no allowed key at all then has seen only the
//     visited tiles, so its output is replaced by a closing pass: the
//     uniform mean over all K value rows.
//   - The output goes through shared memory to 16-byte stores. Query tiles
//     are dealt longest-first (the last tile of a causal prompt sees the
//     most keys).
//
// * The CUDA-core route (flash_attn_kernel), for float32 and other head
//   dims (D <= 128): one block of 256 threads per (q tile of 64 rows, h,
//   b). The query tile is held transposed in shared memory; the block
//   walks every key tile of 64: the key tile is stored transposed and the
//   value tile as it is, both widened to float32. Each thread computes a
//   4 x 4 patch of the 64 x 64 scores from float4 reads; the 16 threads
//   that share a row reduce its max and sum by shuffle. Probabilities go
//   through shared memory to the P.V product, in which each thread owns 4
//   rows and D/16 columns of the float32 output accumulator.

#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// CUDA-core route (float32, or a head dim the tensor-core route does not take)

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

// ---------------------------------------------------------------------------
// Tensor-core route (bf16, D = 64 or 128)

using namespace bt;   // the PTX helpers of mma.cuh
using bf16 = __nv_bfloat16;

// The key tiles' bitmasks have at most this many 32-bit words each:
// K <= 524,288.
constexpr int MAX_VISIT_WORDS = 256;

// 2^x by the SFU's approximation (2 ulp), results below 2^-126 flushed to
// zero: they are probabilities far under bf16's resolution of 1.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D_, int WARPS_, int MT_>
struct FaTile {
  static constexpr int D = D_, WARPS = WARPS_, MT = MT_;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int WQ = 16 * MT;      // query rows a warp
  static constexpr int BQ = WQ * WARPS;   // query rows a block
  static constexpr int BKV = 64;          // keys a tile
  static constexpr int LDS = D + 8;       // bf16 row pitch: +16 bytes
  static constexpr int Q_BYTES = BQ * LDS * 2;
  static constexpr int KV_BYTES = BKV * LDS * 2;      // one K or V tile
  static constexpr int IDX_BYTES = 2 * BKV * 4;       // its kv_idx, kv_valid
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + IDX_BYTES;
  static constexpr int SMEM = Q_BYTES + 2 * STAGE_BYTES;   // + the bitmasks
  static_assert(D % 16 == 0 && THREADS % (D / 8) == 0, "tile shape");
  static_assert(Q_BYTES % 16 == 0 && KV_BYTES % 16 == 0, "16-byte stages");
};
// D = 128: 4 warps of 16 rows, ~90 KB, two blocks an SM; D = 64: 4 warps
// of 32 rows (two m16 tiles share each K and V fragment), ~57 KB. (8 warps
// of 16 rows at D = 64 spilled and were not faster.)
using FaTile128 = FaTile<128, 4, 1>;
using FaTile64 = FaTile<64, 4, 2>;

template <class C>
__global__ void __launch_bounds__(C::THREADS, 2)
flash_attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ q_idx,
                     const int* __restrict__ kv_idx,
                     const int* __restrict__ kv_valid, bf16* __restrict__ out,
                     int H, int Q, int K, float scale_log2) {
  constexpr int D = C::D, BQ = C::BQ, BKV = C::BKV, LDS = C::LDS;
  constexpr int THREADS = C::THREADS, MT = C::MT, WQ = C::WQ;
  constexpr int KD = D / 16;    // k-steps of Q.K^T
  constexpr int NT = BKV / 8;   // 8-key score tiles
  constexpr int ND = D / 8;     // 8-column output tiles
  constexpr int RC = D / 8;     // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;
  __shared__ float colsum[D];
  __shared__ int qmax_s, qmin_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest rows first
  const int w0 = q0 + warp * WQ;                      // the warp's first row
  const size_t bh = (size_t)b * H + h;
  const bf16* qb = q + bh * Q * D;
  const bf16* kb = k + bh * K * D;
  const bf16* vb = v + bh * K * D;
  const int* valid_b = kv_valid + (size_t)b * K;

  bf16* Qs = reinterpret_cast<bf16*>(smem);
  auto stage = [&](int s) { return smem + C::Q_BYTES + s * C::STAGE_BYTES; };
  auto Ks = [&](int s) { return reinterpret_cast<bf16*>(stage(s)); };
  auto Vs = [&](int s) {
    return reinterpret_cast<bf16*>(stage(s) + C::KV_BYTES);
  };
  auto Is = [&](int s) {          // [2][BKV]: kv_idx, then kv_valid
    return reinterpret_cast<int*>(stage(s) + 2 * C::KV_BYTES);
  };
  const int n_tiles = (K + BKV - 1) / BKV;
  const int n_words = (n_tiles + 31) / 32;
  uint32_t* visit = reinterpret_cast<uint32_t*>(smem + C::SMEM);
  uint32_t* partly = visit + n_words;

  // The query tile's copies go out first, in one group with the first key
  // tile's.
  for (int c = tid; c < BQ * RC; c += THREADS) {
    const int r = c / RC, col = (c % RC) * 8;
    const bool ok = q0 + r < Q;
    cp_async16(smem_u32(Qs + r * LDS + col),
               qb + (size_t)(ok ? q0 + r : 0) * D + col, ok);
  }

  // Two bitmasks over the key tiles: `visit`, a tile holding a key that
  // some row of the query tile may see (a valid key with kv_idx <= the
  // tile's largest q_idx); `partly`, a tile with a key that some row may
  // not see (past K, not valid, or kv_idx > the smallest q_idx). A visited
  // tile that is not partly masked skips the mask.
  if (tid == 0) {
    qmax_s = INT_MIN;
    qmin_s = INT_MAX;
  }
  for (int w = tid; w < 2 * n_words; w += THREADS) visit[w] = 0;
  __syncthreads();
  int qmx = INT_MIN, qmn = INT_MAX;
  for (int r = tid; r < BQ; r += THREADS)
    if (q0 + r < Q) {
      const int qv = q_idx[(size_t)b * Q + q0 + r];
      qmx = max(qmx, qv);
      qmn = min(qmn, qv);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qmx = max(qmx, __shfl_xor_sync(FULL, qmx, o));
    qmn = min(qmn, __shfl_xor_sync(FULL, qmn, o));
  }
  if (lane == 0) {
    atomicMax(&qmax_s, qmx);
    atomicMin(&qmin_s, qmn);
  }
  __syncthreads();
  const int qmax = qmax_s, qmin = qmin_s;
  for (int c0 = warp * 32; c0 < K; c0 += THREADS) {   // a warp's 32 keys
    const int c = c0 + lane;                            // share one tile
    const bool ok = c < K && valid_b[c] != 0;
    const int kvi = c < K ? kv_idx[c] : 0;
    const bool seen = __any_sync(FULL, ok && kvi <= qmax);
    const bool all = __all_sync(FULL, ok && kvi <= qmin);
    const uint32_t bit = 1u << (c0 / BKV % 32);
    if (lane == 0 && seen) atomicOr(&visit[c0 / BKV / 32], bit);
    if (lane == 0 && !all) atomicOr(&partly[c0 / BKV / 32], bit);
  }
  __syncthreads();
  auto next_tile = [&](int t) {   // the first tile after t to visit, or -1
    for (int tt = t + 1; tt < n_tiles;) {
      const int w = tt >> 5;
      const uint32_t bits = visit[w] & (~0u << (tt & 31));
      if (bits) return (w << 5) + __ffs(bits) - 1;
      tt = (w + 1) << 5;
    }
    return -1;
  };

  // Start the copies of key tile t into stage s.
  auto load = [&](int s, int t) {
    const int k0 = t * BKV;
    for (int c = tid; c < BKV * RC; c += THREADS) {
      const int r = c / RC, col = (c % RC) * 8;
      const bool ok = k0 + r < K;
      const size_t off = (size_t)(ok ? k0 + r : 0) * D + col;
      cp_async16(smem_u32(Ks(s) + r * LDS + col), kb + off, ok);
      cp_async16(smem_u32(Vs(s) + r * LDS + col), vb + off, ok);
    }
    for (int c = tid; c < 2 * BKV; c += THREADS) {
      const int r = c % BKV;
      const bool ok = k0 + r < K;
      const int* src = (c < BKV ? kv_idx : valid_b) + (ok ? k0 + r : 0);
      cp_async4(smem_u32(Is(s) + c), src, ok);
    }
  };

  // This thread's accumulator rows: g and g + 8 of each of the warp's MT
  // 16-row tiles; row (mt, hh) is warp row mt * 16 + g + 8 * hh.
  int qi[MT][2];
  float o[MT][ND][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = w0 + mt * 16 + g + 8 * hh;
      qi[mt][hh] = row < Q ? q_idx[(size_t)b * Q + row] : INT_MIN;
      m[mt][hh] = kNeg;
      l[mt][hh] = 0.f;
#pragma unroll
      for (int j = 0; j < ND; ++j) o[mt][j][2 * hh] = o[mt][j][2 * hh + 1] = 0.f;
    }
  uint32_t qf[MT][KD][4];

  int cur = next_tile(-1), s = 0;
  if (cur >= 0) load(0, cur);
  cp_async_commit();
  bool first = true;
  while (cur >= 0) {
    const int nxt = next_tile(cur);
    if (nxt >= 0) load(s ^ 1, nxt);   // stage s ^ 1 was freed by the
    cp_async_commit();                // barrier closing the last tile
    cp_async_wait<1>();               // this thread's copies of tile cur
    __syncthreads();                  // everyone's
    if (first) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          ldsm_x4(qf[mt][kd],
                  smem_u32(Qs + (warp * WQ + mt * 16 + (lane & 15)) * LDS +
                           kd * 16 + (lane >> 4) * 8));
      first = false;
    }

    // S = Q.K^T: WQ rows x 64 keys a warp; each K fragment feeds MT tiles
    float sc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
    const bf16* Kt = Ks(s);
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, smem_u32(Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     LDS +
                            kd * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(sc[mt][2 * np], qf[mt][kd], r[0], r[1]);
          mma_bf16(sc[mt][2 * np + 1], qf[mt][kd], r[2], r[3]);
        }
      }

    // Mask a partly masked tile, in the log2 domain. Element
    // (mt, j, 2 * hh + e) is row (mt, hh), key j * 8 + 2 * t4 + e of the
    // tile. A tile every row may wholly see keeps its raw scores, scaled
    // below inside the exponent's FMA.
    const bool partial = (partly[cur >> 5] >> (cur & 31)) & 1u;
    const float mul = partial ? 1.f : scale_log2;
    if (partial) {
      const int k0 = cur * BKV;
      const int* Ix = Is(s);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = j * 8 + 2 * t4;
        const int2 idx = *reinterpret_cast<const int2*>(Ix + c);
        const int2 val = *reinterpret_cast<const int2*>(Ix + BKV + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kidx = e ? idx.y : idx.x;
          const bool ok = (e ? val.y : val.x) != 0;
          const bool in = k0 + c + e < K;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float x = sc[mt][j][2 * hh + e] * scale_log2;
              if (!(ok && kidx <= qi[mt][hh])) x = kNeg;
              if (!in) x = -INFINITY;     // past K: no weight at all
              sc[mt][j][2 * hh + e] = x;
            }
        }
      }
    }

    // Online softmax: the row max over the quad that shares a row; the
    // thread keeps its share of the row sum.
    uint32_t pa[MT][NT / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = sc[mt][0][2 * hh];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(sc[mt][j][2 * hh], sc[mt][j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        mx = fmaxf(m[mt][hh], mx * mul);   // mul > 0: the max commutes
        const float corr = fast_exp2(m[mt][hh] - mx);
        m[mt][hh] = mx;
        l[mt][hh] *= corr;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          o[mt][j][2 * hh] *= corr;
          o[mt][j][2 * hh + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = fast_exp2(fmaf(sc[mt][j][e], mul, -m[mt][e >> 1]));
          l[mt][e >> 1] += p[e];
        }
        // keys j * 8 + 2 * t4 (+1), rows g and g + 8: the A fragment's
        // k-half j % 2
        pa[mt][j / 2][2 * (j % 2)] = pack_bf16x2(p[0], p[1]);
        pa[mt][j / 2][2 * (j % 2) + 1] = pack_bf16x2(p[2], p[3]);
      }
    }

    // O += P.V; each V fragment feeds MT tiles
    const bf16* Vt = Vs(s);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(r, smem_u32(Vt + (kk * 16 + (lane & 15)) * LDS +
                                  dp * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dp], pa[mt][kk], r[0], r[1]);
          mma_bf16(o[mt][2 * dp + 1], pa[mt][kk], r[2], r[3]);
        }
      }
    __syncthreads();                  // stage s is free for the next load
    cur = nxt;
    s ^= 1;
  }
  cp_async_wait<0>();                 // no copy outlives the loop
  __syncthreads();

  bool empty = false;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[mt][hh] += __shfl_xor_sync(FULL, l[mt][hh], 1);
      l[mt][hh] += __shfl_xor_sync(FULL, l[mt][hh], 2);
      empty |= m[mt][hh] == kNeg && w0 + mt * 16 + g + 8 * hh < Q;
    }
  // A row with no allowed key saw only the visited tiles: its output is the
  // uniform mean over all K value rows, summed here once for the block.
  if (__syncthreads_or(empty)) {
    for (int d = tid; d < D; d += THREADS) colsum[d] = 0.f;
    __syncthreads();
    const int col = (tid % RC) * 8;
    float part[8] = {};
    for (int r = tid / RC; r < K; r += THREADS / RC) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(vb + (size_t)r * D + col);
      const bf16* e8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) part[i] += __bfloat162float(e8[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) atomicAdd(&colsum[col + i], part[i]);
    __syncthreads();
  }

  // Epilogue: each warp writes its rows into its own rows of the query
  // tile's shared memory, then stores them 16 bytes a lane.
  bf16* Os = Qs + warp * WQ * LDS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const bool none = m[mt][hh] == kNeg;
      const float inv = 1.f / fmaxf(l[mt][hh], 1e-30f);
      bf16* row = Os + (mt * 16 + g + 8 * hh) * LDS;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int col = j * 8 + 2 * t4;
        const float v0 = none ? colsum[col] / K : o[mt][j][2 * hh] * inv;
        const float v1 =
            none ? colsum[col + 1] / K : o[mt][j][2 * hh + 1] * inv;
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  __syncwarp();
  for (int c = lane; c < WQ * RC; c += 32) {
    const int r = c / RC, col = (c % RC) * 8;
    if (w0 + r < Q)
      *reinterpret_cast<uint4*>(out + (bh * Q + w0 + r) * D + col) =
          *reinterpret_cast<const uint4*>(Os + r * LDS + col);
  }
}

template <class C>
int launch_tc(const void* q, const void* k, const void* v, const void* q_idx,
              const void* kv_idx, const void* kv_valid, void* out, int B,
              int H, int Q, int K, cudaStream_t stream) {
  const int n_words = ((K + C::BKV - 1) / C::BKV + 31) / 32;
  if (n_words > MAX_VISIT_WORDS) return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB a block's shared memory must be asked for, once a device.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(flash_attn_tc_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM + 8 * MAX_VISIT_WORDS);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const float scale_log2 =
      1.4426950408889634f * (1.0f / sqrtf(static_cast<float>(C::D)));
  const dim3 grid(H, B, (Q + C::BQ - 1) / C::BQ);
  flash_attn_tc_kernel<C><<<grid, C::THREADS, C::SMEM + 8 * n_words,
                            stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_idx),
      static_cast<const int*>(kv_idx), static_cast<const int*>(kv_valid),
      static_cast<bf16*>(out), H, Q, K, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, Q, D], k/v [B, H, K, D] (float if is_bf16 == 0, else bf16),
// 1 <= D <= 128; q_idx int32 [B, Q]; kv_idx int32 [K]; kv_valid int32 [B, K];
// out [B, H, Q, D] like q. tc != 0 takes the tensor-core route: bf16, D 64
// or 128, K <= 524,288, every pointer 16-byte aligned.
extern "C" int bt_flash_attention(const void* q, const void* k, const void* v,
                                  const void* q_idx, const void* kv_idx,
                                  const void* kv_valid, void* out, int B,
                                  int H, int Q, int K, int D, int is_bf16,
                                  int tc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    if (D == 128)
      return launch_tc<FaTile128>(q, k, v, q_idx, kv_idx, kv_valid, out, B,
                                  H, Q, K, st);
    if (D == 64)
      return launch_tc<FaTile64>(q, k, v, q_idx, kv_idx, kv_valid, out, B, H,
                                 Q, K, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k, v, q_idx, kv_idx, kv_valid, out, B,
                                     H, Q, K, D, st);
  return dispatch_d<float>(q, k, v, q_idx, kv_idx, kv_valid, out, B, H, Q, K,
                           D, st);
}
