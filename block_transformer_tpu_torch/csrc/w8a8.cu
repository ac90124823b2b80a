// W8A8: the dynamic per-row activation quantization (W8A8-q) and the
// int8 x int8 matmul (W8A8-mm) of the prefill linears, for Hopper (sm_90a).
//
// Not a TPU kernel: the JAX package computes W8A8 with XLA ops
// (block_transformer_tpu/ops/linear.py, _w8a8_dot :219-233, chosen by
// _use_w8a8 :178-216 for INT8 weights at prefill-sized M), a native s8 x s8
// dot on the TPU's matrix unit. Here it is two hand-written kernels:
//
//   W8A8-q:  sx[m]     = f32(max_k |x[m, k]|) / 127 + 1e-12
//            xq[m, k]  = int8(round_half_even(f32(x[m, k]) / sx[m]))
//   W8A8-mm: out[m, n] = cast_T((f32(sum_k xq[m, k] * w[k, n]) * sx[m])
//                               * scale[n])
//
// with w one layer of a stacked [L, K, N] int8 weight (the caller passes the
// layer's base pointer: no weight slice is copied) and scale its [N]
// per-channel scales. Both are bit-exact against that definition: the
// maximum is exact in any order, the division is IEEE (__fdiv_rn, no fast
// math), the rounding half-to-even (__float2int_rn), the int32 sum is exact
// in any order (|sum| <= K * 127 * 128 < 2^31 for K < 2^17), and the
// epilogue rounds in the reference's order: int32 -> f32, times sx, times
// scale, then to T, each step round-to-nearest-even.
//
// What bounds them on the H100. W8A8-q reads x once and writes one byte an
// element: bound by bytes (16.8 MB read and 8.4 MB written at the block
// decoder's qkv, M = 4096, K = 2048). W8A8-mm does 2*M*K*N operations on
// (M + N) * K bytes: at prefill M it is far above the card's ~590 int8
// operations per byte, so bound by operations, at the int8 tensor-core rate
// (1,979 TOPS dense), which only wgmma reaches.
//
// Design of W8A8-mm (w8a8_wgmma_kernel). For 8-bit operands wgmma takes
// both shared-memory operands K-major and has no transpose flag; the
// weights are [K, N] with N contiguous (the parameter tree's layout, kept:
// no transposed copy is made). Two routes were open: (A) swap the roles,
// out^T = w^T . xq^T, with the weights as wgmma's A operand from registers
// and the tokens of xq ([M, K], K-major as a B operand) straight from
// shared memory by descriptor; (B) a pass that rewrites each weight tile
// K-major in shared memory for an all-shared wgmma. (B) writes and reads
// every weight byte once more in shared memory, which is what bounds this
// kernel (below), so the kernel takes (A):
//   * Tiles of 256 weight columns x 128 tokens (wgmma m64n128k32: tokens on
//     N), K in 128-byte stages, a ring of 4 stages (48 KB each) filled by
//     TMA (cp.async.bulk.tensor, 128-byte swizzle, zero-filled past M, N
//     and K) and tracked by full / empty mbarriers.
//   * Warp specialization: one producer warpgroup (setmaxnreg 40; one
//     thread issues the copies) and two consumer warpgroups (setmaxnreg
//     232), each multiplying 128 of the tile's weight columns (two m64
//     tiles, 128 int32 accumulators a thread) against the same 128 tokens.
//     ptxas allocates each role's registers by its setmaxnreg; a build
//     with one producer warp and no setmaxnreg ran slower.
//   * A fragments: a thread loads the 4 x 4 byte block of k rows 4t..4t+3
//     and weight columns 4q..4q+3 (q = 8 * warp + g) from the swizzled
//     stage and transposes it with __byte_perm into four registers, one
//     column's 4 k each. The four columns are the thread's logical rows
//     g, g + 8 of both m64 tiles (column 4q + 2mt + h is row 16 warp + g +
//     8h of m-tile mt), so one load feeds two wgmma. Threads t >= 2 read
//     their rows in an order turned by 2, which puts a warp's loads on 32
//     distinct banks of the swizzle; the last __byte_perm turns it back.
//     A fragments have four buffers: the next k32 step's are built while
//     the last two steps' wgmma run (wgmma.wait_group 2).
//   * Persistent: min(units, SMs) blocks walk the (tile, split) units, in
//     groups of 16 m-tiles so that the tiles in flight share xq and weight
//     slices in L2; the producer loads the next tile's stages while the
//     consumers run the epilogue. The epilogue holds, per thread, 4
//     consecutive output columns of 32 tokens: 8-byte (bf16) or 16-byte
//     (f32) stores, each warp writing whole 32-byte sectors.
//   * When the tiles do not fill the card (small M), K is split over units;
//     the splits publish exact int32 partial sums and the (tile, warpgroup)'s
//     last split to arrive (an atomic counter, left at zero) adds them and
//     runs the epilogue: one launch.
// What holds it below the int8 peak: a 128-byte stage of one SM moves 144
// KB through shared memory (48 KB of TMA writes, 32 KB of A-fragment loads,
// 64 KB of wgmma B reads: each m64 wgmma reads its 4 KB of tokens), 1,152
// clocks at 128 bytes a clock against 1,024 clocks of int8 products, and
// 48 KB a stage from L2 on every SM; a build with the products taken out
// kept most of the kernel's time. Times: PERF.md, section 6.

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace bt;

// ---------------------------------------------------------------------------
// W8A8-q: one block a row.

constexpr int Q_THREADS = 128;

// Element j of a 16-byte vector of T, as float (exact).
template <typename T>
__device__ __forceinline__ float vec_elem(const uint4& u, int j);
template <>
__device__ __forceinline__ float vec_elem<float>(const uint4& u, int j) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  return __uint_as_float(w[j]);
}
template <>
__device__ __forceinline__ float vec_elem<__nv_bfloat16>(const uint4& u,
                                                         int j) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};   // bf16: a float's top half
  return __uint_as_float((j & 1) ? w[j >> 1] & 0xffff0000u : w[j >> 1] << 16);
}

// x [M, K] (T = float or bf16) -> xq [M, K] int8, sx [M] float, in 16-byte
// vectors of x (K a multiple of 16, 16-byte aligned bases).
template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
w8a8_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                  float* __restrict__ sx, int K) {
  constexpr int V = 16 / sizeof(T);        // elements of a 16-byte vector
  union Packed {
    int8_t b[8];
    uint2 u2;
    uint32_t u1;
  };
  const int tid = threadIdx.x;
  const T* xr = x + (size_t)blockIdx.x * K;
  int8_t* qr = xq + (size_t)blockIdx.x * K;

  float amax = 0.f;
  for (int i = tid * V; i < K; i += Q_THREADS * V) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + i);
#pragma unroll
    for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(vec_elem<T>(v, j)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  __shared__ float part[Q_THREADS / 32];
  if ((tid & 31) == 0) part[tid >> 5] = amax;
  __syncthreads();
  amax = part[0];
#pragma unroll
  for (int w = 1; w < Q_THREADS / 32; ++w) amax = fmaxf(amax, part[w]);
  // the reference's order: amax / 127, then + 1e-12, each rounded
  const float s = __fadd_rn(__fdiv_rn(amax, 127.f), 1e-12f);
  if (tid == 0) sx[blockIdx.x] = s;

  // the row comes again from L1 / L2 (it was read just now)
  for (int i = tid * V; i < K; i += Q_THREADS * V) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + i);
    Packed p;
#pragma unroll
    for (int j = 0; j < V; ++j)
      p.b[j] = static_cast<int8_t>(
          __float2int_rn(__fdiv_rn(vec_elem<T>(v, j), s)));
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(qr + i) = p.u2;
    else
      *reinterpret_cast<uint32_t*>(qr + i) = p.u1;
  }
}

// ---------------------------------------------------------------------------
// W8A8-mm: warp-specialized, persistent, wgmma on weights from registers.

constexpr int BT = 128;            // tokens a tile: wgmma's N
constexpr int BW = 128;            // weight columns a consumer warpgroup:
                                   // two m64 wgmma tiles
constexpr int BK = 128;            // k bytes a stage: 4 wgmma k32 steps
constexpr int X_BYTES = BT * BK;   // xq box [128 tokens][128 k]
constexpr int W_BYTES = BK * BW;   // weight box [128 k][128 n]
static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0,
              "every box starts on a 1024-byte swizzle atom");
constexpr int CONSUMERS = 2;       // consumer warpgroups; a tile is BW * 2
constexpr int BN = BW * CONSUMERS; // weight columns a tile (256)
constexpr int STAGES = 4;
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer warpgroup
constexpr int STAGE_BYTES = X_BYTES + CONSUMERS * W_BYTES;   // 49,152
constexpr int BAR_BYTES = 2 * STAGES * 8 + CONSUMERS * 4;
// the stages, their barriers, and 1 KB to align the stages to the
// 1024-byte swizzle atom: 197,700 bytes, one block an SM
constexpr int SMEM = STAGES * STAGE_BYTES + BAR_BYTES + 1024;
// the producer warpgroup gives up registers that the consumers take
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS <= 65536,
              "the register file holds every warpgroup's share");
constexpr int GROUP_M = 16;        // m-tiles a group of the tile order
// k32 steps of wgmma in flight while the next step's A fragments are
// built: 2 (1 was slower, 3 spilled)
constexpr int DEPTH = 2;
static_assert(DEPTH >= 1 && DEPTH <= 3, "4 A buffers: step ks - 3 is done");

// This thread's 4 x 4 byte block of a weight box, transposed: rows (k)
// 4t..4t+3 of the k16 group at `rows`, columns (n) 4q..4q+3 of the box
// (q = 8 * warp + g) -> c[j] = column 4q + j's four k, in increasing k.
// The rows are read in an order turned by 2 for t >= 2 (off[] holds the
// turned rows' offsets), so that a warp's loads touch 32 distinct banks of
// the 128-byte swizzled box; the last byte_perm's selectors (sel_lo,
// sel_hi) turn them back.
__device__ __forceinline__ void load_transposed(uint32_t rows,
                                                const uint32_t (&off)[4],
                                                uint32_t sel_lo,
                                                uint32_t sel_hi,
                                                uint32_t (&c)[4]) {
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(r[j]) : "r"(rows + off[j]));
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, sel_lo);
  c[1] = __byte_perm(t0, t2, sel_hi);
  c[2] = __byte_perm(t1, t3, sel_lo);
  c[3] = __byte_perm(t1, t3, sel_hi);
}

// The A fragments of k32 step ks of a weight box: the thread's logical
// rows g, g + 8 of m-tile 0 are columns 4q, 4q + 1, of m-tile 1 4q + 2,
// 4q + 3; registers 0 / 1 hold k 4t.., 2 / 3 k 16 + 4t..
__device__ __forceinline__ void load_a(uint32_t box, int ks,
                                       const uint32_t (&off)[4],
                                       uint32_t sel_lo, uint32_t sel_hi,
                                       uint32_t (&a)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t c[4];
    load_transposed(box + (32 * ks + 16 * h) * 128, off, sel_lo, sel_hi, c);
    a[0][2 * h] = c[0];
    a[0][2 * h + 1] = c[1];
    a[1][2 * h] = c[2];
    a[1][2 * h + 1] = c[3];
  }
}

template <typename T> struct Out4;           // 4 consecutive outputs
template <> struct Out4<__nv_bfloat16> {
  __device__ static void put(__nv_bfloat16* dst, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  }
};
template <> struct Out4<float> {
  __device__ static void put(float* dst, const float (&v)[4]) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// A unit of work: output tile (m-tile, n-tile) and split z of K.
struct Unit {
  int m0, n0, k0, nkb;
};

// Unit u = tile + tiles * z. Tiles go in groups of GROUP_M m-tiles, m
// fastest inside a group, so that the tiles in flight at once share a few
// m-tiles of xq and a few n-tiles of the weights in L2.
__device__ __forceinline__ Unit unit_of(int u, int m_tiles, int n_tiles,
                                        int K, int k_per_split) {
  const int tiles = m_tiles * n_tiles;
  const int tile = u % tiles, z = u / tiles;
  const int group = tile / (GROUP_M * n_tiles);
  const int first = group * GROUP_M;
  const int gm = min(m_tiles - first, GROUP_M);
  const int in = tile - first * n_tiles;
  Unit w;
  w.m0 = (first + in % gm) * BT;
  w.n0 = (in / gm) * BN;
  w.k0 = z * k_per_split;
  w.nkb = (min(K - w.k0, k_per_split) + BK - 1) / BK;
  return w;
}

// out [M, N] T = T((f32(xq @ w) * sx[m]) * scale[n]), xq [M, K] and w [K, N]
// int8 through the tensor maps tm_x (boxes [BT][BK]) and tm_w (boxes
// [BK][BW]), both with the 128-byte swizzle. Units are (tile, split) pairs,
// u = tile + tiles * z, walked by the grid. With splits > 1, partial holds
// [splits, M, N] int32 sums and counters one int per (tile, warpgroup),
// zero on entry and on exit.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  const float* __restrict__ sx,
                  const float* __restrict__ scale, T* __restrict__ out,
                  int* __restrict__ partial, int* __restrict__ counters,
                  int M, int K, int N, int splits, int k_per_split) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;     // the 1024-byte atom
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  int* last_flag = reinterpret_cast<int*>(smem_raw + (bars - raw) +
                                          16 * STAGES);

  const int m_tiles = (M + BT - 1) / BT, n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  const int units = tiles * splits;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);                      // the producer's arrival
      mbar_init(empty(s), 4 * CONSUMERS);         // one a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full with TMA
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      tma_prefetch_map(&tm_x);
      tma_prefetch_map(&tm_w);
      int s = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, m_tiles, n_tiles, K, k_per_split);
        for (int kb = 0; kb < w.nkb; ++kb) {
          mbar_wait(empty(s), phase ^ 1);
          mbar_arrive_expect_tx(full(s), STAGE_BYTES);
          const uint32_t st = base + s * STAGE_BYTES;
          const int k = w.k0 + kb * BK;
          tma_load_2d(st, &tm_x, full(s), k, w.m0);
#pragma unroll
          for (int c = 0; c < CONSUMERS; ++c)
            tma_load_2d(st + X_BYTES + c * W_BYTES, &tm_w, full(s),
                        w.n0 + c * BW, k);
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg multiplies weight columns n0 + 128 wg..
    setmaxnreg_inc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31, wi = (threadIdx.x / 32) & 3;
    const int g = lane >> 2, t = lane & 3;
    // rows 4t + i of a k16 group, i turned by 2 for t >= 2; columns 4q..
    // 4q + 3, q = 8 wi + g: 16-byte chunk 2 wi + g / 4, word g % 4
    uint32_t off[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 4 * t + ((j + 2 * (t >> 1)) & 3);
      off[j] = row * 128 + (((2 * wi + (g >> 2)) ^ (row & 7)) << 4) +
               4 * (g & 3);
    }
    const uint32_t sel_lo = (t & 2) ? 0x1054u : 0x5410u;
    const uint32_t sel_hi = (t & 2) ? 0x3276u : 0x7632u;

    int s = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(u, m_tiles, n_tiles, K, k_per_split);
      // acc[mt][4j + e]: weight column (logical row) 64 mt + 16 wi + g +
      // 8 (e / 2), token 8j + 2t + e % 2
      int acc[2][64];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[mt][i] = 0;
      uint32_t a[4][2][4] = {};   // [k32 step][m-tile][register]
      // the unit's first stage, and its first step's A fragments
      mbar_wait(full(s), phase);
      __syncwarp();
      uint32_t xs = base + s * STAGE_BYTES;
      uint32_t ws = xs + X_BYTES + wg * W_BYTES;
      load_a(ws, 0, off, sel_lo, sel_hi, a[0]);
      int prev = -1;                 // the stage before, until released
      for (int kb = 0; kb < w.nkb; ++kb) {
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int i = 0; i < 64; ++i) fence_operand(acc[mt][i]);
          wgmma_fence();
          const uint64_t db = desc_sw128(xs + 32 * ks);
          wgmma_m64n128k32_s8_rs(acc[0], a[ks][0], db);
          wgmma_m64n128k32_s8_rs(acc[1], a[ks][1], db);
          wgmma_commit();
          // at most DEPTH steps in flight: step ks - DEPTH is done, so its
          // A registers are free (pinned until here) and, at ks == DEPTH -
          // 1, so is the stage before (its last step was DEPTH steps back)
          wgmma_wait<DEPTH>();
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              fence_operand(a[(ks + 4 - DEPTH) % 4][mt][i]);
          if (ks == DEPTH - 1 && prev >= 0) {
            if (lane == 0) mbar_arrive(empty(prev));
            prev = -1;
          }
          uint32_t (&an)[2][4] = a[(ks + 1) % 4];
          if (ks + 1 < BK / 32) {
            load_a(ws, ks + 1, off, sel_lo, sel_hi, an);
          } else if (kb + 1 < w.nkb) {  // the next stage's first step
            prev = s;
            if (++s == STAGES) {
              s = 0;
              phase ^= 1;
            }
            mbar_wait(full(s), phase);
            __syncwarp();
            xs = base + s * STAGE_BYTES;
            ws = xs + X_BYTES + wg * W_BYTES;
            load_a(ws, 0, off, sel_lo, sel_hi, an);
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[mt][i]);
      if (lane == 0) mbar_arrive(empty(s));     // the stage before went
                                                // at step DEPTH - 1
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }

      // ---- epilogue: this thread holds output columns n .. n + 3 for the
      // tokens m0 + 8j + 2t + e (j < 16, e < 2); column n + 2 mt + h is
      // acc[mt][4j + 2h + e]
      const int n = w.n0 + wg * BW + 32 * wi + 4 * g;
      const bool col_ok = n < N;                 // N % 16 == 0: all 4 or none
      if (splits > 1) {
        // publish this split's sums; the (tile, warpgroup)'s last split to
        // arrive adds them all up and writes the output, then leaves its
        // counter at zero for the next launch
        const size_t plane = (size_t)M * N;
        int* mine = partial + (size_t)(w.k0 / k_per_split) * plane;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tok = w.m0 + 8 * j + 2 * t + e;
            if (tok < M && col_ok)
              *reinterpret_cast<int4*>(mine + (size_t)tok * N + n) =
                  make_int4(acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                            acc[1][4 * j + e], acc[1][4 * j + 2 + e]);
          }
        __threadfence();
        named_sync(1 + wg, 128);
        if (threadIdx.x % 128 == 0) {
          const int tile = u % tiles;
          int* ctr = counters + tile * CONSUMERS + wg;
          const int last = atomicAdd(ctr, 1) == splits - 1;
          if (last) *ctr = 0;
          last_flag[wg] = last;
        }
        named_sync(1 + wg, 128);
        if (!last_flag[wg]) continue;             // the same in the group
        __threadfence();
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[mt][i] = 0;
#pragma unroll 1
        for (int z = 0; z < splits; ++z) {        // 32 loads in flight
          const int* pz = partial + z * plane;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int tok = w.m0 + 8 * j + 2 * t + e;
              if (tok >= M || !col_ok) continue;
              const int4 p = __ldcg(
                  reinterpret_cast<const int4*>(pz + (size_t)tok * N + n));
              acc[0][4 * j + e] += p.x;
              acc[0][4 * j + 2 + e] += p.y;
              acc[1][4 * j + e] += p.z;
              acc[1][4 * j + 2 + e] += p.w;
            }
        }
      }
      if (col_ok) {
        const float4 sc4 = __ldg(reinterpret_cast<const float4*>(scale + n));
        const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tok = w.m0 + 8 * j + 2 * t + e;
            if (tok >= M) continue;
            const float sxm = __ldg(sx + tok);
            const int v[4] = {acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                              acc[1][4 * j + e], acc[1][4 * j + 2 + e]};
            float o[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              o[q] = __fmul_rn(__fmul_rn(__int2float_rn(v[q]), sxm), sc[q]);
            Out4<T>::put(out + (size_t)tok * N + n, o);
          }
      }
    }
  }
}

template <typename T>
cudaError_t launch_mm(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                      const void* sx, const void* scale, void* out,
                      int* partial, int* counters, int M, int K, int N,
                      int splits, int k_per_split, int blocks,
                      cudaStream_t stream) {
  // Above 48 KB a block's shared memory must be asked for, once a device.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(w8a8_wgmma_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  w8a8_wgmma_kernel<T><<<blocks, THREADS, SMEM, stream>>>(
      tm_x, tm_w, static_cast<const float*>(sx),
      static_cast<const float*>(scale), static_cast<T*>(out), partial,
      counters, M, K, N, splits, k_per_split);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] (float if x_bf16 == 0, else bf16) -> xq [M, K] int8 and sx [M]
// float. K a multiple of 16, x and xq 16-byte aligned.
extern "C" int bt_w8a8_quant(const void* x, void* xq, void* sx, int M, int K,
                             int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || K % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(sx);
  if (x_bf16)
    w8a8_quant_kernel<__nv_bfloat16><<<M, Q_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), q, s, K);
  else
    w8a8_quant_kernel<float><<<M, Q_THREADS, 0, st>>>(
        static_cast<const float*>(x), q, s, K);
  return static_cast<int>(cudaGetLastError());
}

// xq [M, K] int8; sx [M] float; w [K, N] int8 (one layer's base); scale [N]
// float; out [M, N] (float if out_bf16 == 0, else bf16). K and N positive
// multiples of 16, k_per_split a multiple of 128 with splits * k_per_split
// >= K > (splits - 1) * k_per_split, blocks the persistent grid, every
// pointer 16-byte aligned. With splits > 1, workspace holds splits * M * N
// int32 and counters one zero int per (tile, consumer warpgroup), 2 *
// ceil(M / 128) * ceil(N / 256), left at zero.
extern "C" int bt_w8a8_matmul(const void* xq, const void* sx, const void* w,
                              const void* scale, void* out, void* workspace,
                              void* counters, int M, int K, int N, int splits,
                              int k_per_split, int blocks, int out_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 || N % 16 || k_per_split <= 0 ||
      k_per_split % BK || splits < 1 || blocks < 1 ||
      (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  int* partial = splits > 1 ? static_cast<int*>(workspace) : nullptr;
  int* ctr = static_cast<int*>(counters);
  if (splits > 1 && (partial == nullptr || ctr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_w;
  if (!encode_u8_sw128(&tm_x, xq, M, K, K, BT, BK) ||
      !encode_u8_sw128(&tm_w, w, K, N, N, BK, BW))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_bf16)
    return static_cast<int>(launch_mm<__nv_bfloat16>(
        tm_x, tm_w, sx, scale, out, partial, ctr, M, K, N, splits,
        k_per_split, blocks, st));
  return static_cast<int>(launch_mm<float>(tm_x, tm_w, sx, scale, out,
                                           partial, ctr, M, K, N, splits,
                                           k_per_split, blocks, st));
}
