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
// (1,979 TOPS dense), twice the bf16 rate that K1 (dequant_matmul.cu) works
// at.
//
// Design of W8A8-mm. mma.sync m16n8k32 with s8 operands wants both A and B
// with K contiguous within each 32-bit register; the weights are [K, N]
// with N contiguous (the parameter tree's layout, kept: no transposed copy).
// So each warp transposes its B fragments in registers:
//   * 128 x 128 output tiles, 8 warps of 64 x 32, K in steps of 64 bytes
//     through a 4-stage ring of 16-byte cp.async copies (zero-filled past
//     M, N and K), awaited with cp.async.wait_group: three steps in flight
//     while one is multiplied, one barrier a step.
//   * A (xq, K contiguous) is read with ldmatrix.x4 as if it were b16 (a
//     16 x 32 int8 tile is a 16 x 16 b16 tile); rows padded to 80 bytes, so
//     free of bank conflicts.
//   * B is read straight from the raw [64][128] weight stage: a thread loads
//     the 4 x 4 byte block of rows 4t..4t+3 and columns 4g..4g+3 (g = lane
//     / 4, t = lane % 4) and transposes it with __byte_perm into 4 registers,
//     one column's 4 k each. The warp's 32 columns are permuted so that
//     these are exactly its fragments: column j of n-tile nt is physical
//     column 4j + nt. The stage's 16-byte chunks are XOR-swizzled by row
//     (chunk ^ 2 * ((row / 4) % 4)), so those loads are free of bank
//     conflicts too. The permutation leaves each thread 8 consecutive
//     output columns, stored as one 16-byte vector (bf16) a row.
//   * When the grid has fewer than two blocks per SM, K is split over
//     gridDim.z; the splits publish int32 partial sums (exact), and the
//     tile's last split to arrive (an atomic counter per tile) adds them
//     and runs the epilogue: no second launch.

#include "common.cuh"
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
// W8A8-mm.

constexpr int BM = 128, BN = 128, BK = 64;   // output tile, K step (bytes)
constexpr int WM = 64, WN = 32;              // a warp's tile
constexpr int WARPS_N = BN / WN;
constexpr int THREADS = 32 * (BM / WM) * WARPS_N;   // 256
constexpr int MT = WM / 16, NT = WN / 8;            // 4 x 4 mma tiles
constexpr int STAGES = 4;
constexpr int A_LD = BK + 16;                // x row pitch: +16 bytes
constexpr int A_BYTES = BM * A_LD;
constexpr int W_BYTES = BK * BN;             // raw weight rows, swizzled
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES;   // 73,728 bytes
static_assert(NT == 4, "a 4 x 4 byte block gives one register to 4 n-tiles");
static_assert(BN == 128 && BK % 32 == 0, "the swizzle assumes 8 chunks a row");
static_assert(A_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "16-byte stages");

// Physical 16-byte chunk of logical chunk c in weight-stage row r.
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ (((r >> 2) & 3) << 1);
}

// Rows r[0..3] (4 bytes each, 4 columns) -> columns c[0..3] (4 bytes each,
// 4 rows), byte i of c[j] = byte j of r[i].
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

template <typename T> struct Out8;           // 8 outputs, one or two stores
template <> struct Out8<__nv_bfloat16> {
  __device__ static void put(__nv_bfloat16* dst, const float (&v)[8]) {
    uint4 u;
    u.x = pack_bf16x2(v[0], v[1]);
    u.y = pack_bf16x2(v[2], v[3]);
    u.z = pack_bf16x2(v[4], v[5]);
    u.w = pack_bf16x2(v[6], v[7]);
    *reinterpret_cast<uint4*>(dst) = u;
  }
};
template <> struct Out8<float> {
  __device__ static void put(float* dst, const float (&v)[8]) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// xq [M, K] int8, sx [M], w [K, N] int8, scale [N], out [M, N] T. K and N
// multiples of 16, k_per_split of BK, 16-byte aligned bases. With gridDim.z
// > 1 splits, partial holds [splits, M, N] int32 sums and counters one int
// per output tile, zero on entry and on exit.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
w8a8_mm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
               const int8_t* __restrict__ w, const float* __restrict__ scale,
               T* __restrict__ out, int* __restrict__ partial,
               int* __restrict__ counters, int M, int K, int N,
               int k_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nk = (k_end - k_begin + BK - 1) / BK;

  auto stage_a = [&](int s) { return smem + s * STAGE_BYTES; };
  auto stage_w = [&](int s) { return smem + s * STAGE_BYTES + A_BYTES; };

  // Issue the copies of the K step at k0 into stage s.
  auto load = [&](int s, int k0) {
    constexpr int AC = BK / 16;            // chunks of an x row
#pragma unroll
    for (int c = tid; c < BM * AC; c += THREADS) {
      const int r = c / AC, col = (c % AC) * 16;
      const bool ok = m0 + r < M && k0 + col < k_end;
      const int8_t* src = xq + (ok ? (size_t)(m0 + r) * K + k0 + col : 0);
      cp_async16(smem_u32(stage_a(s) + r * A_LD + col), src, ok);
    }
    constexpr int WC = BN / 16;            // chunks of a weight row
#pragma unroll
    for (int c = tid; c < BK * WC; c += THREADS) {
      const int r = c / WC, col = c % WC;
      const bool ok = k0 + r < k_end && n0 + col * 16 < N;
      const int8_t* src = w + (ok ? (size_t)(k0 + r) * N + n0 + col * 16 : 0);
      cp_async16(smem_u32(stage_w(s) + r * BN + swz(r, col) * 16), src, ok);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, k_begin + s * BK);
    cp_async_commit();                     // one group a stage, empty or not
  }

  // this thread's B block: 4-byte word g & 3 of chunk (wn * WN + 4g) / 16
  const int b_chunk = (wn * WN + 4 * g) / 16, b_word = 4 * (g & 3);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();           // this thread's copies of kt
    __syncthreads();   // everyone's; and step kt - 1's products are done,
                       // so its stage may be refilled
    const int next = kt + STAGES - 1;
    if (next < nk) load(next % STAGES, k_begin + next * BK);
    cp_async_commit();
    const unsigned char* sa = stage_a(kt % STAGES);
    const unsigned char* sw = stage_w(kt % STAGES);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], smem_u32(sa + (wm * WM + mt * 16 + (lane & 15)) * A_LD +
                                kk + (lane >> 4) * 16));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = kk + 16 * h + 4 * t + i;
          r[i] = *reinterpret_cast<const uint32_t*>(
              sw + row * BN + swz(row, b_chunk) * 16 + b_word);
        }
        transpose4x4(r, c);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) b[nt][h] = c[nt];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
  cp_async_wait<0>();                      // no copy outlives the block

  // Accumulator (mt, nt, e): row g + 8 * (e / 2) of m-tile mt, logical
  // column 2t + e % 2 of n-tile nt, i.e. physical column 4 * (2t + e % 2) +
  // nt: the thread holds columns col .. col + 7, column col + j in
  // (nt, e % 2) = (j % 4, j / 4).
  const int col = n0 + wn * WN + 8 * t;
  const bool col_ok = col < N;             // N % 16 == 0: all 8 or none
  auto row_of = [&](int mt, int h) {
    return m0 + wm * WM + mt * 16 + g + 8 * h;
  };

  if (partial != nullptr) {
    // K is split: publish this split's sums; the tile's last split to
    // arrive adds all of them up and writes the output, then leaves the
    // tile's counter at zero for the next launch.
    const size_t plane = (size_t)M * N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_of(mt, h);
        if (row >= M || !col_ok) continue;
        int4* dst = reinterpret_cast<int4*>(partial + blockIdx.z * plane +
                                            (size_t)row * N + col);
        dst[0] = make_int4(acc[mt][0][2 * h], acc[mt][1][2 * h],
                           acc[mt][2][2 * h], acc[mt][3][2 * h]);
        dst[1] = make_int4(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1],
                           acc[mt][2][2 * h + 1], acc[mt][3][2 * h + 1]);
      }
    __threadfence();
    __syncthreads();
    __shared__ int last;
    if (tid == 0) {
      int* ctr = counters + blockIdx.y * gridDim.x + blockIdx.x;
      last = atomicAdd(ctr, 1) == (int)gridDim.z - 1;
      if (last) *ctr = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_of(mt, h);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[mt][j & 3][2 * h + (j >> 2)] = 0;
        if (row >= M || !col_ok) continue;
#pragma unroll 1
        for (int z = 0; z < (int)gridDim.z; ++z) {
          const int4* src = reinterpret_cast<const int4*>(
              partial + z * plane + (size_t)row * N + col);
          const int4 lo = __ldcg(src), hi = __ldcg(src + 1);
          acc[mt][0][2 * h] += lo.x;
          acc[mt][1][2 * h] += lo.y;
          acc[mt][2][2 * h] += lo.z;
          acc[mt][3][2 * h] += lo.w;
          acc[mt][0][2 * h + 1] += hi.x;
          acc[mt][1][2 * h + 1] += hi.y;
          acc[mt][2][2 * h + 1] += hi.z;
          acc[mt][3][2 * h + 1] += hi.w;
        }
      }
  }

  if (!col_ok) return;
  float sc[8];
  {
    const float4 a = __ldg(reinterpret_cast<const float4*>(scale + col));
    const float4 b = __ldg(reinterpret_cast<const float4*>(scale + col) + 1);
    sc[0] = a.x; sc[1] = a.y; sc[2] = a.z; sc[3] = a.w;
    sc[4] = b.x; sc[5] = b.y; sc[6] = b.z; sc[7] = b.w;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_of(mt, h);
      if (row >= M) continue;
      const float s = __ldg(sx + row);
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = __fmul_rn(__fmul_rn(__int2float_rn(
                                       acc[mt][j & 3][2 * h + (j >> 2)]),
                                   s),
                         sc[j]);
      Out8<T>::put(out + (size_t)row * N + col, v);
    }
}

template <typename T>
cudaError_t launch_mm(const void* xq, const void* sx, const void* w,
                      const void* scale, void* out, int* partial,
                      int* counters, int M, int K, int N, int splits,
                      int k_per_split, cudaStream_t stream) {
  // Above 48 KB a block's shared memory must be asked for, once a device.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(w8a8_mm_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  w8a8_mm_kernel<T><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<T*>(out), partial, counters, M, K, N, k_per_split);
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
// float; out [M, N] (float if out_bf16 == 0, else bf16). K and N multiples
// of 16, k_per_split a multiple of 64 with splits * k_per_split >= K, every
// pointer 16-byte aligned. With splits > 1, workspace holds splits * M * N
// int32 and counters one zero int per output tile (ceil(N / 128) *
// ceil(M / 128)), left at zero.
extern "C" int bt_w8a8_matmul(const void* xq, const void* sx, const void* w,
                              const void* scale, void* out, void* workspace,
                              void* counters, int M, int K, int N, int splits,
                              int k_per_split, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K % 16 || N % 16 || k_per_split % BK || splits < 1 ||
      (long long)splits * k_per_split < K)
    return static_cast<int>(cudaErrorInvalidValue);
  int* partial = splits > 1 ? static_cast<int*>(workspace) : nullptr;
  int* ctr = static_cast<int*>(counters);
  if (splits > 1 && (partial == nullptr || ctr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_bf16)
    return static_cast<int>(launch_mm<__nv_bfloat16>(
        xq, sx, w, scale, out, partial, ctr, M, K, N, splits, k_per_split,
        st));
  return static_cast<int>(launch_mm<float>(xq, sx, w, scale, out, partial,
                                           ctr, M, K, N, splits, k_per_split,
                                           st));
}
