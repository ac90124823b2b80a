// K5-K8: the paged KV pool kernels, for Hopper (sm_90a).
//
// Replace the four Pallas kernels of block_transformer_tpu/ops/
// paged_attention.py. The pool holds int8 values [L, P, H, ps, D] with one
// float32 scale per (layer, page, head, slot) [L, P, H, ps]; row-major, so
// the D bytes of one slot are contiguous. An INT4 pool (K6 and K8 only, as
// in the reference) holds D/2 bytes a slot, split half: byte i carries
// dimension i in its low nibble and i + D/2 in its high one, each a signed
// 4-bit value. A batch row b sees its keys at
// virtual positions j = vp * ps + o, stored at pool page page_table[b, vp].
// Page 0 is the null page: unallocated virtual pages point there and are
// masked by kv_valid.
//
// K5 / K7, paged_write_int8 / paged_write_layers_int8 (Pallas
// _paged_write_kernel and _paged_write_layers_kernel): write one decode
// step's quantized K/V, H*D int8 bytes and H scales each, at
// [l, page[b], h, off[b]] for every layer of the launch. One kernel serves
// both: K5 gets the layer's base pointers and L = 1, K7 all L layers (every
// layer of a slot shares the slot's (page, off) target). A target outside
// the pool (page not in [0, P) or off not in [0, ps)) is dropped: a slot
// whose prompt plus budget fills its capacity keeps writing at off == cap
// after it finished, and the Pallas index map would place that write out of
// bounds. Rows that share a target (dead slots, all on page 0 or on their
// own frozen frontier) race benignly on masked memory. Bound by bytes: it
// moves 2 * B * L * H * (D + 4) bytes in each direction; one block per
// (slot, layer tile) with 16-byte copies keeps every store a full sector.
//
// K5 / K7 fused with the INT8 KV quantization (paged_quantize_write_kernel):
// the decode step's K and V rows [B, H, D] (bf16 or float32, strided) are
// quantized as ops/quant.py quantize_kv does and written in the same launch,
// where the unfused path spent ~10 PyTorch launches a tensor on the
// quantization and one more on the write. That launch count, not the bytes
// (a few hundred KB), is what the decode step pays for on this card: each
// small launch costs ~2 us of device time and several of host time. One warp
// a (b, h) row: each lane loads its D/32 elements of K and of V (vector
// loads where rows are aligned), takes max |x| by __shfl_xor_sync, and
// computes scale = max(a, 1e-8) / 127 and q = clamp(rint(x / scale), -127,
// 127) with IEEE divisions (__fdiv_rn), exactly the plain version's
// operations, so the result is the same bit for bit. Three forms share the
// body (`mode`):
//   QW_POOL (K5): into layer `layer` of the pool at (page[b], off[b]), or of
//     the contiguous cache [L, B, H, cap, D] (no page table: page b), with
//     K5's drop rule; `off` may be one offset for every row.
//   QW_STEP (K7's feed, layers < L - 1 of the paged engine's deferred
//     write): into the step buffers [2, L, B, H(, D)] at layer `layer`, and
//     the dequantized float32 pair q * scale that K6 takes as `fresh`.
//   QW_STEP_LAYERS (K7, the last layer): QW_STEP for layer L - 1, that layer
//     written into the pool from registers, then layers 0..L-2 of the (b, h)
//     copied from the step buffers into the pool. Stream order: the K6
//     launches of layers < L - 1 ran before this launch, so none of them
//     sees the new slot; layer L - 1's K6 runs after it, but masks the
//     frontier slot (q_idx - 1) and reads the fresh pair instead, so writing
//     the pool first changes nothing it reads. A warp writes only its own
//     (b, h), from its registers or from rows earlier launches wrote: no
//     dependency between blocks, and no row is read that this launch writes.
//
// K6, paged_decode_attention_int8 (Pallas _paged_kernel / _paged_attn):
// K2's math (csrc/decode_attention.cu) through the page table, for S <= 8
// query rows:
//
//   s[j]  = (q . k_q[j]) * (k_scale[j] / sqrt(D)),  -1e30 where masked
//   out   = sum_j softmax(s)[j] * v_scale[j] * v_q[j]   (float32 softmax)
//
// at the virtual positions j < n_virt * ps, masked by q_idx, kv_idx and
// kv_valid; a row with no allowed key takes the uniform mean of every
// virtual position's value, as the reference does. With `fresh` (the
// deferred write, S == 1) the current step's dequantized float32 key and
// value join the softmax as one more term with score (q . kf) / sqrt(D);
// the caller masks the stale pool slot at the frontier with q_idx - 1. A
// page id outside [0, P) is read as the null page 0, so no page id makes
// the kernel read outside the pool. K6's INT4 form (the Pallas kernel
// widens any pool dtype) is the template argument INT4 of the same kernel.
//
// What bounds K6 on the H100: the bytes of the key and value rows some
// query row may see, D + 4 bytes a row (INT8) or D/2 + 4 (INT4), against
// ~4 * S * D operations a row. At decode, B * H of 256 pairs over ~800
// virtual slots, the bytes are a few MB, so what it takes is set by how
// many loads are in flight and by the rows it does not have to read. The
// design (K2's split design, csrc/decode_attention.cu, through the page
// table), and what each choice does about that:
// - Split over the virtual capacity. The grid is (splits, H, B), blocks of
//   4 warps; the n_virt * ps slots are cut into runs of slots_per_split
//   (whole 32-slot tiles) by K2's plan() (kernels/decode_attention.py), so
//   the launch puts several blocks on every SM: 3 splits of 256 slots at
//   the engine's B = 16, H = 16, n_virt * ps = 768. A warp walks its
//   split's tiles dealt round-robin.
// - Merge in the same launch. Each split writes its (max, sum, acc[S][D])
//   partials to a scratch buffer; the last split of a (b, h) to arrive (an
//   atomic counter, left at zero) merges them in split order, folds in the
//   fresh term once and writes the output: no second launch. The only
//   block folds it when splits == 1.
// - Page lookup a tile. When ps % 32 == 0 a tile lies in one page: the
//   warp reads one page-table entry and the tile's key and value rows are
//   contiguous in the pool. Otherwise each lane looks up its own slot's
//   page, and the tile's 32 pool slots go through the warp's row of shared
//   memory to the lanes that read the value rows.
// - Loads in flight. Each warp holds two tiles in registers, in turn (no
//   copies between them): the next tile's key rows, value rows, scales and
//   mask are issued before the current tile's math, and the mask of the
//   tile after that before it. Key rows are read with 16-byte loads, one
//   key a lane; value rows whole-line, 4 bytes a lane (INT8: 4 dims, a warp
//   reads a 128-byte row at D = 128; INT4: 8 dims, 4c..4c+3 in the low
//   nibbles and D/2+4c.. in the high ones), with the tile's probabilities
//   (times v_scale) in the warp's shared row: no serial loop of dependent
//   loads. Widening is exact: the byte permute onto 2^23 for int8, nibbles()
//   for int4 (mma.cuh).
// - Skip tiles no query row may see. A warp ballots the tile's mask
//   (kv_valid and kv_idx <= the largest q_idx), loaded ahead; a tile with
//   no allowed key for any of the S rows loads no key, value or scale, so
//   the ragged tail of a short row is not read. A row with an allowed key
//   (or the fresh term) is unchanged: its masked keys weigh exp(-1e30 - m)
//   = 0. A row with no allowed key in any split and no fresh term keeps the
//   reference's uniform mean over all K virtual positions: the merging
//   block sees its max still at -1e30 and computes that mean on a slow
//   path that reads the (b, h)'s value rows, as K3 closes such rows.
//
// K8, paged_page_copy_int8 (Pallas _page_copy_kernel): admission copies G
// prefilled rows [L, G, H, nv * ps, D] (+ scales) page by page into their
// pool pages pt_rows[g, j]; one block per (layer, row, virtual page, head)
// copies ps * D bytes and ps scales with 16-byte loads and stores (D here is
// a slot's bytes: D/2 of the head dim for a packed INT4 pool). An entry
// of pt_rows outside [0, P) is dropped. Pages are written whole, so no
// read-modify-write; duplicate targets (padded admission rows, unallocated
// tails on page 0) write identical or masked data. Bound by bytes.

#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace {

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

// Copy n bytes (a multiple of 16 when vec) with the block's threads.
__device__ __forceinline__ void copy_bytes(int8_t* __restrict__ dst,
                                           const int8_t* __restrict__ src,
                                           size_t n, bool vec) {
  if (vec) {
    int4* d = reinterpret_cast<int4*>(dst);
    const int4* s = reinterpret_cast<const int4*>(src);
    for (size_t i = threadIdx.x; i < n / 16; i += blockDim.x) d[i] = s[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// ---------------------------------------------------------------------------
// K5 / K7
// ---------------------------------------------------------------------------

constexpr int WRITE_THREADS = 128;
constexpr int WRITE_LAYERS = 4;   // layers per block

__global__ void __launch_bounds__(WRITE_THREADS)
paged_write_kernel(int8_t* __restrict__ kpool, float* __restrict__ kspool,
                   int8_t* __restrict__ vpool, float* __restrict__ vspool,
                   const int* __restrict__ page, const int* __restrict__ off,
                   const int8_t* __restrict__ kq, const float* __restrict__ ks,
                   const int8_t* __restrict__ vq, const float* __restrict__ vs,
                   int L, int B, int P, int H, int ps, int D, int vec) {
  const int b = blockIdx.x;
  const int pg = page[b], of = off[b];
  // Out of range: drop the write (see the note at the top of the file).
  if (pg < 0 || pg >= P || of < 0 || of >= ps) return;
  const int l1 = min(L, static_cast<int>(blockIdx.y + 1) * WRITE_LAYERS);
  for (int l = blockIdx.y * WRITE_LAYERS; l < l1; ++l) {
    const size_t src = (static_cast<size_t>(l) * B + b) * H;   // (l, b, h=0)
    const size_t dst =                                          // (l, pg, h=0, of)
        (static_cast<size_t>(l) * P + pg) * H * static_cast<size_t>(ps) + of;
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      kspool[dst + static_cast<size_t>(h) * ps] = ks[src + h];
      vspool[dst + static_cast<size_t>(h) * ps] = vs[src + h];
    }
    if (vec) {
      const int chunks = D / 16;
      for (int i = threadIdx.x; i < H * chunks; i += blockDim.x) {
        const int h = i / chunks, c = (i % chunks) * 16;
        const size_t s = (src + h) * D + c;
        const size_t d = (dst + static_cast<size_t>(h) * ps) * D + c;
        *reinterpret_cast<int4*>(kpool + d) =
            *reinterpret_cast<const int4*>(kq + s);
        *reinterpret_cast<int4*>(vpool + d) =
            *reinterpret_cast<const int4*>(vq + s);
      }
    } else {
      for (int i = threadIdx.x; i < H * D; i += blockDim.x) {
        const int h = i / D, e = i % D;
        const size_t d = (dst + static_cast<size_t>(h) * ps) * D + e;
        kpool[d] = kq[src * D + i];
        vpool[d] = vq[src * D + i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K5 / K7 fused with the INT8 KV quantization
// ---------------------------------------------------------------------------

constexpr int QW_WARPS = 4;      // (b, h) rows a block, one a warp
constexpr int QW_MAX_D = 256;
constexpr int QW_BATCH = 8;      // copies a lane holds in flight (K7 form)
enum { QW_POOL = 0, QW_STEP = 1, QW_STEP_LAYERS = 2 };

struct QuantWriteArgs {
  const void* k;
  const void* v;                 // [B, H, D] rows, last dim contiguous
  int8_t* kpool;                 // [L, P, H, ps, D]
  float* kspool;                 // [L, P, H, ps]
  int8_t* vpool;
  float* vspool;
  const int* page;               // [B]; null: row b's page is b
  const int* off;                // [B]; null: off_value for every row
  int8_t* step_q;                // [2, L, B, H, D]
  float* step_s;                 // [2, L, B, H]
  float* kf;                     // [B, H, D]
  float* vf;
  int kb, kh, vb, vh;            // (b, h) strides of k and v, in elements
  int off_value, mode, B, H, D, P, ps, L, layer;
  int vec;      // every row aligned to its lane's pack: the vector forms
  int copy16;   // D % 16 == 0 and 16-byte aligned pools and step buffers
};

// A lane's elements of a row: with EPL > 0, d = lane * EPL + e (one vector
// load or store a lane); with EPL == 0 (other head dims, unaligned rows),
// d = lane + 32 * e for d < D, one element at a time.
template <int EPL>
struct RowLanes {
  static constexpr int N = EPL > 0 ? EPL : QW_MAX_D / 32;
  __device__ static int d(int lane, int e) {
    return EPL > 0 ? lane * EPL + e : lane + 32 * e;
  }
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T e[N];
};

template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* __restrict__ x, int D,
                                         int lane,
                                         float (&f)[RowLanes<EPL>::N]) {
  if constexpr (EPL > 0) {
    const Pack<T, EPL> p = *reinterpret_cast<const Pack<T, EPL>*>(
        x + lane * EPL);
#pragma unroll
    for (int e = 0; e < EPL; ++e) f[e] = bt::to_f32<T>(p.e[e]);
  } else {
#pragma unroll
    for (int e = 0; e < RowLanes<EPL>::N; ++e) {
      const int d = RowLanes<EPL>::d(lane, e);
      f[e] = d < D ? bt::to_f32<T>(x[d]) : 0.f;
    }
  }
}

// quantize_kv of one row: returns the scale, q the lane's values.
template <int EPL>
__device__ __forceinline__ float quantize_row(
    const float (&f)[RowLanes<EPL>::N], int8_t (&q)[RowLanes<EPL>::N]) {
  float a = 0.f;                       // elements past D hold 0
#pragma unroll
  for (int e = 0; e < RowLanes<EPL>::N; ++e) a = fmaxf(a, fabsf(f[e]));
  const float scale = __fdiv_rn(fmaxf(warp_max(a), 1e-8f), 127.f);
#pragma unroll
  for (int e = 0; e < RowLanes<EPL>::N; ++e)
    q[e] = static_cast<int8_t>(__float2int_rn(
        fminf(fmaxf(rintf(__fdiv_rn(f[e], scale)), -127.f), 127.f)));
  return scale;
}

template <int EPL>
__device__ __forceinline__ void store_q(int8_t* __restrict__ dst,
                                        const int8_t (&q)[RowLanes<EPL>::N],
                                        int D, int lane) {
  if constexpr (EPL > 0) {
    Pack<int8_t, EPL> p;
#pragma unroll
    for (int e = 0; e < EPL; ++e) p.e[e] = q[e];
    *reinterpret_cast<Pack<int8_t, EPL>*>(dst + lane * EPL) = p;
  } else {
#pragma unroll
    for (int e = 0; e < RowLanes<EPL>::N; ++e) {
      const int d = RowLanes<EPL>::d(lane, e);
      if (d < D) dst[d] = q[e];
    }
  }
}

// The dequantized row q * scale in float32 (the fresh pair of K6).
template <int EPL>
__device__ __forceinline__ void store_fresh(
    float* __restrict__ dst, const int8_t (&q)[RowLanes<EPL>::N], float scale,
    int D, int lane) {
  if constexpr (EPL > 0) {
    Pack<float, EPL> p;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      p.e[e] = __fmul_rn(static_cast<float>(q[e]), scale);
    *reinterpret_cast<Pack<float, EPL>*>(dst + lane * EPL) = p;
  } else {
#pragma unroll
    for (int e = 0; e < RowLanes<EPL>::N; ++e) {
      const int d = RowLanes<EPL>::d(lane, e);
      if (d < D) dst[d] = __fmul_rn(static_cast<float>(q[e]), scale);
    }
  }
}

// K7's copy: the warp's (b, h) rows of layers 0..L-2 (K then V), `n_units`
// units of U (16 bytes or 1) a row, from the step buffers into the pool.
// Every lane loads up to QW_BATCH units before it stores them.
template <typename U>
__device__ __forceinline__ void copy_layers(const QuantWriteArgs& a, int b,
                                            int h, int pg, int of,
                                            int lane) {
  const int units = a.D / static_cast<int>(sizeof(U));
  const int total = 2 * (a.L - 1) * units;
  for (int i0 = 0; i0 < total; i0 += 32 * QW_BATCH) {
    U buf[QW_BATCH];
#pragma unroll
    for (int j = 0; j < QW_BATCH; ++j) {
      const int i = i0 + j * 32 + lane;
      if (i < total) {
        const int row = i / units, t = row / (a.L - 1), l = row % (a.L - 1);
        const size_t src = ((static_cast<size_t>(t) * a.L + l) * a.B + b) *
                               a.H + h;
        buf[j] = __ldg(reinterpret_cast<const U*>(a.step_q + src * a.D) +
                       i % units);
      }
    }
#pragma unroll
    for (int j = 0; j < QW_BATCH; ++j) {
      const int i = i0 + j * 32 + lane;
      if (i < total) {
        const int row = i / units, t = row / (a.L - 1), l = row % (a.L - 1);
        const size_t dst =
            ((static_cast<size_t>(l) * a.P + pg) * a.H + h) * a.ps + of;
        reinterpret_cast<U*>((t ? a.vpool : a.kpool) + dst * a.D)[i % units] =
            buf[j];
      }
    }
  }
  for (int i = lane; i < 2 * (a.L - 1); i += 32) {   // the scales
    const int t = i / (a.L - 1), l = i % (a.L - 1);
    const size_t src =
        ((static_cast<size_t>(t) * a.L + l) * a.B + b) * a.H + h;
    const size_t dst =
        ((static_cast<size_t>(l) * a.P + pg) * a.H + h) * a.ps + of;
    (t ? a.vspool : a.kspool)[dst] = __ldg(a.step_s + src);
  }
}

template <typename T, int EPL>
__global__ void __launch_bounds__(32 * QW_WARPS)
paged_quantize_write_kernel(const QuantWriteArgs a) {
  constexpr int N = RowLanes<EPL>::N;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * QW_WARPS + (threadIdx.x >> 5);   // b * H + h
  if (r >= a.B * a.H) return;
  const int b = r / a.H, h = r % a.H;
  const int pg = a.page ? a.page[b] : b;
  const int of = a.off ? a.off[b] : a.off_value;
  // Out of range: the pool write is dropped (see the note at the top).
  const bool to_pool = a.mode != QW_STEP && pg >= 0 && pg < a.P && of >= 0 &&
                       of < a.ps;
  if (a.mode == QW_POOL && !to_pool) return;
  float f[2][N];
  load_row<T, EPL>(static_cast<const T*>(a.k) + static_cast<size_t>(b) * a.kb +
                       static_cast<size_t>(h) * a.kh, a.D, lane, f[0]);
  load_row<T, EPL>(static_cast<const T*>(a.v) + static_cast<size_t>(b) * a.vb +
                       static_cast<size_t>(h) * a.vh, a.D, lane, f[1]);
  // the slot (layer, pg, h, of) of the pool
  const size_t slot =
      ((static_cast<size_t>(a.layer) * a.P + pg) * a.H + h) * a.ps + of;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    int8_t q[N];
    const float scale = quantize_row<EPL>(f[t], q);
    if (to_pool) {
      store_q<EPL>((t ? a.vpool : a.kpool) + slot * a.D, q, a.D, lane);
      if (lane == 0) (t ? a.vspool : a.kspool)[slot] = scale;
    }
    if (a.mode != QW_POOL) {
      const size_t row =
          ((static_cast<size_t>(t) * a.L + a.layer) * a.B + b) * a.H + h;
      store_q<EPL>(a.step_q + row * a.D, q, a.D, lane);
      if (lane == 0) a.step_s[row] = scale;
      store_fresh<EPL>((t ? a.vf : a.kf) + static_cast<size_t>(r) * a.D, q,
                       scale, a.D, lane);
    }
  }
  if (a.mode == QW_STEP_LAYERS && to_pool) {
    if (a.copy16)
      copy_layers<int4>(a, b, h, pg, of, lane);
    else
      copy_layers<int8_t>(a, b, h, pg, of, lane);
  }
}

template <typename T>
int launch_quantize_write(const QuantWriteArgs& a, cudaStream_t st) {
  const dim3 grid((a.B * a.H + QW_WARPS - 1) / QW_WARPS);
  const dim3 block(32 * QW_WARPS);
  // the vector forms need every row aligned to its pack (`vec`)
  switch (a.vec ? a.D : 0) {
    case 32:
      paged_quantize_write_kernel<T, 1><<<grid, block, 0, st>>>(a);
      break;
    case 64:
      paged_quantize_write_kernel<T, 2><<<grid, block, 0, st>>>(a);
      break;
    case 128:
      paged_quantize_write_kernel<T, 4><<<grid, block, 0, st>>>(a);
      break;
    default:
      paged_quantize_write_kernel<T, 0><<<grid, block, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

constexpr int COPY_THREADS = 256;

__global__ void __launch_bounds__(COPY_THREADS)
page_copy_kernel(int8_t* __restrict__ kpool, float* __restrict__ kspool,
                 int8_t* __restrict__ vpool, float* __restrict__ vspool,
                 const int* __restrict__ pt_rows,
                 const int8_t* __restrict__ rk, const float* __restrict__ rks,
                 const int8_t* __restrict__ rv, const float* __restrict__ rvs,
                 int G, int nv, int P, int H, int ps, int D, int vec) {
  const int j = blockIdx.x % nv;
  const int g = (blockIdx.x / nv) % G;
  const int l = blockIdx.x / (nv * G);
  const int h = blockIdx.y;
  const int p = pt_rows[g * nv + j];
  if (p < 0 || p >= P) return;   // out of range: dropped
  // slot index of (l, g, h, j * ps) in [L, G, H, nv * ps] and of
  // (l, p, h, 0) in [L, P, H, ps]
  const size_t src = ((static_cast<size_t>(l) * G + g) * H + h) *
                         (static_cast<size_t>(nv) * ps) +
                     static_cast<size_t>(j) * ps;
  const size_t dst =
      ((static_cast<size_t>(l) * P + p) * H + h) * static_cast<size_t>(ps);
  const size_t n = static_cast<size_t>(ps) * D;
  copy_bytes(kpool + dst * D, rk + src * D, n, vec);
  copy_bytes(vpool + dst * D, rv + src * D, n, vec);
  for (int i = threadIdx.x; i < ps; i += blockDim.x) {
    kspool[dst + i] = rks[src + i];
    vspool[dst + i] = rvs[src + i];
  }
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 32;   // virtual slots a warp step, one a lane
constexpr int MAX_S = 8;

// The four low (hi = false) or high nibbles of the 4 bytes of w, each
// biased by 8 into a byte of its own: bt::biased_byte<8>(result, i) is the
// signed value of byte i's nibble, exactly and without integer-to-float
// conversions (mma.cuh).
__device__ __forceinline__ uint32_t nibbles(uint32_t w, bool hi) {
  const uint32_t u = w ^ 0x88888888u;
  return (hi ? u >> 4 : u) & 0x0F0F0F0Fu;
}

// A form's shapes: RB bytes of a slot's values (D int8, or D/2 packed
// INT4), KW 16-byte loads of a key row; value rows are read 4 bytes a
// lane, LPR lanes a row and RPS rows a warp step, VW loads a lane a tile;
// AW output dims a lane accumulates a query row (INT4: 4 in each half of D).
template <int D, bool INT4>
struct Form {
  static constexpr int RB = INT4 ? D / 2 : D;
  static constexpr int KW = RB / 16;
  static constexpr int LPR = RB / 4;
  static constexpr int RPS = 32 / LPR;
  static constexpr int VW = TILE / RPS;
  static constexpr int AW = INT4 ? 8 : 4;
};

// 4 value bytes of a lane's column c, widened exactly: INT8 dims 4c..4c+3;
// INT4 the low nibbles (dims 4c..4c+3), then the high ones (D/2 + 4c..).
template <bool INT4>
__device__ __forceinline__ void widen(uint32_t w, float (&f)[INT4 ? 8 : 4]) {
  if constexpr (INT4) {
    const uint32_t lo = nibbles(w, false), hi = nibbles(w, true);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[e] = bt::biased_byte<8>(lo, e);
      f[4 + e] = bt::biased_byte<8>(hi, e);
    }
  } else {
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = bt::biased_byte<128>(u, e);
  }
}

// One layer of the pool as the block's (b, h) reads it: virtual position j
// is slot (page * H + h) * ps + j % ps of [P, H, ps], page =
// page_table[b, j / ps], read as the null page 0 when outside [0, P).
struct Pool {
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const int* pt;   // the row's page table [n_virt]
  int P, H, h, ps;
  bool whole;      // ps % TILE == 0: a tile lies in one page

  __device__ __forceinline__ unsigned slot(int j) const {
    const int vp = j / ps;
    int pg = pt[vp];
    if (pg < 0 || pg >= P) pg = 0;   // never read outside the pool
    return (static_cast<unsigned>(pg) * H + h) * ps + (j - vp * ps);
  }
};

// The block's shared memory: the query rows, each warp's probabilities of
// its tile and pool slots of its tile (pages smaller than a tile), each
// warp's softmax state for the merge, the fresh key's score and the rows
// left with no allowed key.
template <int D, int NS>
struct Smem {
  __align__(16) float qs[NS][D];
  float pw[WARPS][TILE][NS];
  unsigned slots[WARPS][TILE];
  float m_w[WARPS][NS];
  float l_w[WARPS][NS];
  __align__(16) float acc_w[WARPS][NS][D];
  float s_fresh;
  int empty[NS];
  int last;
};

// The mask inputs of a lane's slot j0 + lane of a tile; nothing past j_end.
__device__ __forceinline__ void load_mask(int& idx, int& ok,
                                          const int* __restrict__ kv_idx,
                                          const int* __restrict__ valid,
                                          int j0, int j_end, int lane) {
  const int j = j0 + lane;
  const bool in = j < j_end;
  idx = in ? kv_idx[j] : 0;
  ok = in ? valid[j] != 0 : 0;
}

// One 32-slot tile as a lane holds it: its key's row and scales, 4 bytes
// of each value row it reads (row i * RPS + lane / LPR, column lane % LPR),
// its key's mask inputs, and whether any query row may see the tile.
template <int D, bool INT4>
struct Tile {
  using F = Form<D, INT4>;
  uint4 k[F::KW];
  uint32_t v[F::VW];
  float ks, vs;
  int idx, ok;
  bool live;

  // Rows of slots [j0, j0 + 32), none from j_end on; KEYS: the key rows
  // and k_scale too (the uniform mean reads values and v_scale only).
  template <bool KEYS>
  __device__ __forceinline__ void load_rows(const Pool& pool,
                                            unsigned* slots, int j0,
                                            int j_end, int lane) {
    const int j = j0 + lane;
    const bool in = j < j_end;
    unsigned base = 0, kslot;
    if (pool.whole) {   // one page: the tile's rows are contiguous
      base = pool.slot(j0);
      kslot = base + lane;
    } else {            // the value rows' slots through the warp's row
      __syncwarp();     // the last tile's slots are read
      kslot = in ? pool.slot(j) : 0u;
      slots[lane] = kslot;
      __syncwarp();
    }
    if (in) {
      if constexpr (KEYS) {
        const uint4* krow =
            reinterpret_cast<const uint4*>(pool.kq + (size_t)kslot * F::RB);
#pragma unroll
        for (int c = 0; c < F::KW; ++c) k[c] = krow[c];
        ks = pool.ks[kslot];
      }
      vs = pool.vs[kslot];
    } else {
      if constexpr (KEYS) {
#pragma unroll
        for (int c = 0; c < F::KW; ++c) k[c] = make_uint4(0, 0, 0, 0);
        ks = 0.f;
      }
      vs = 0.f;
    }
    const int col = (lane % F::LPR) * 4;
#pragma unroll
    for (int i = 0; i < F::VW; ++i) {
      const int r = i * F::RPS + lane / F::LPR;
      const unsigned s = pool.whole ? base + r : slots[r];
      v[i] = j0 + r < j_end ? *reinterpret_cast<const uint32_t*>(
                                  pool.vq + (size_t)s * F::RB + col)
                            : 0u;
    }
  }
};

// One tile's online-softmax step for a lane holding key score sc[s] (before
// masking): updates (m, l), rescales acc and leaves the lane's probability
// in sc[s]. `in`: the slot lies before j_end.
template <int NS, int AW>
__device__ __forceinline__ void softmax_step(float (&sc)[NS], float (&m)[NS],
                                             float (&l)[NS],
                                             float (&acc)[NS][AW],
                                             const int (&qi)[NS], int S,
                                             float k_mul, bool ok, int idx,
                                             bool in) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s >= S) break;
    float x = sc[s] * k_mul;
    if (!(ok && idx <= qi[s])) x = bt::kNeg;
    if (!in) x = -INFINITY;   // past the split: no weight at all
    const float m_new = fmaxf(m[s], warp_max(x));
    const float corr = expf(m[s] - m_new);
    const float p = expf(x - m_new);
    l[s] = l[s] * corr + p;   // this lane's share of the sum
    m[s] = m_new;
#pragma unroll
    for (int e = 0; e < AW; ++e) acc[s][e] *= corr;
    sc[s] = p;
  }
}

// The tile's math: scores of the lane's key against the S query rows, the
// softmax step, then P.V over the value rows with the probabilities (times
// v_scale) through the warp's shared row.
template <int D, bool INT4, int NS>
__device__ __forceinline__ void attend(
    const Tile<D, INT4>& t, Smem<D, NS>& sm, float (&m)[NS], float (&l)[NS],
    float (&acc)[NS][Form<D, INT4>::AW], const int (&qi)[NS], int S,
    float sm_scale, bool in, int warp, int lane) {
  using F = Form<D, INT4>;
  float sc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) sc[s] = 0.f;
#pragma unroll
  for (int c = 0; c < F::KW; ++c) {
    const uint32_t w[4] = {t.k[c].x, t.k[c].y, t.k[c].z, t.k[c].w};
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) {
      const int d = c * 16 + e4 * 4;   // INT4: byte d holds dims d, D/2 + d
      float f[F::AW];
      widen<INT4>(w[e4], f);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (s >= S) break;
        const float4 qv = *reinterpret_cast<const float4*>(&sm.qs[s][d]);
        sc[s] += qv.x * f[0] + qv.y * f[1] + qv.z * f[2] + qv.w * f[3];
        if constexpr (INT4) {
          const float4 qh =
              *reinterpret_cast<const float4*>(&sm.qs[s][D / 2 + d]);
          sc[s] += qh.x * f[4] + qh.y * f[5] + qh.z * f[6] + qh.w * f[7];
        }
      }
    }
  }
  softmax_step<NS, F::AW>(sc, m, l, acc, qi, S, t.ks * sm_scale, t.ok,
                          t.idx, in);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s >= S) break;
    sm.pw[warp][lane][s] = sc[s] * t.vs;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < F::VW; ++i) {
    const int r = i * F::RPS + lane / F::LPR;   // the tile's value row
    float f[F::AW];
    widen<INT4>(t.v[i], f);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s >= S) break;
      const float p = sm.pw[warp][r][s];
#pragma unroll
      for (int e = 0; e < F::AW; ++e) acc[s][e] += p * f[e];
    }
  }
  __syncwarp();   // pw is rewritten by the next tile
}

// Sums a lane's accumulators over the lanes of its column (those LPR lanes
// apart) and stores them, as dims of row s, in acc_w[warp][s].
template <int D, bool INT4, int NS>
__device__ __forceinline__ void store_acc(Smem<D, NS>& sm, float (&a)[8],
                                          int s, int warp, int lane) {
  using F = Form<D, INT4>;
#pragma unroll
  for (int e = 0; e < F::AW; ++e)
#pragma unroll
    for (int o = F::LPR; o < 32; o <<= 1)
      a[e] += __shfl_xor_sync(FULL, a[e], o);
  if (lane < F::LPR) {
    *reinterpret_cast<float4*>(&sm.acc_w[warp][s][lane * 4]) =
        make_float4(a[0], a[1], a[2], a[3]);
    if constexpr (INT4)
      *reinterpret_cast<float4*>(&sm.acc_w[warp][s][D / 2 + lane * 4]) =
          make_float4(a[4], a[5], a[6], a[7]);
  }
}

// The slow path of a row with no allowed key in any split and no fresh
// term: the uniform mean of v_scale * v_q over all K virtual positions,
// as sum over the block's warps of acc_w[w][0][d], to be divided by K.
template <int D, bool INT4, int NS>
__device__ __forceinline__ void uniform_sum(Smem<D, NS>& sm, const Pool& pool,
                                         int K, int warp, int lane) {
  using F = Form<D, INT4>;
  float a[8] = {};
  Tile<D, INT4> t;
  for (int j0 = warp * TILE; j0 < K; j0 += WARPS * TILE) {
    t.template load_rows<false>(pool, sm.slots[warp], j0, K, lane);
    sm.pw[warp][lane][0] = t.vs;   // 0 past K
    __syncwarp();
#pragma unroll
    for (int i = 0; i < F::VW; ++i) {
      const int r = i * F::RPS + lane / F::LPR;
      float f[F::AW];
      widen<INT4>(t.v[i], f);
      const float p = sm.pw[warp][r][0];
#pragma unroll
      for (int e = 0; e < F::AW; ++e) a[e] += p * f[e];
    }
    __syncwarp();
  }
  store_acc<D, INT4, NS>(sm, a, 0, warp, lane);
  __syncthreads();
}

// The end of a block: each warp's state (sums over lanes, accumulators
// over the lanes of a column) goes to shared memory; the block's (max,
// sum, acc) is the output with one split, else this split's partials, and
// the last split of this (b, h) to arrive merges all of them, in split
// order, leaving the counter at zero for the next launch. The block that
// writes the output folds in the fresh term (score s_fresh, value vf) and
// closes each row whose max is still -1e30 (no allowed key) without it by
// the uniform mean.
template <typename T, int D, int NS, bool INT4>
__device__ __forceinline__ void finish(
    Smem<D, NS>& sm, float (&m)[NS], float (&l)[NS],
    float (&acc)[NS][Form<D, INT4>::AW], const Pool& pool, int K,
    const float* __restrict__ vf, T* __restrict__ out,
    float* __restrict__ partial, int* __restrict__ counters, int S,
    size_t bh, int warp, int lane, int tid) {
  using F = Form<D, INT4>;
  const int split = blockIdx.x, splits = gridDim.x;
  const bool fresh = vf != nullptr;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s >= S) break;
    l[s] = warp_sum(l[s]);
    float a[8];
#pragma unroll
    for (int e = 0; e < F::AW; ++e) a[e] = acc[s][e];
    store_acc<D, INT4, NS>(sm, a, s, warp, lane);
    if (lane == 0) {
      sm.m_w[warp][s] = m[s];
      sm.l_w[warp][s] = l[s];
    }
  }
  __syncthreads();

  bool empty = false;   // this thread left a row to the uniform mean
  auto close = [&](int i, float mx, float lsum, float a) {
    const int s = i / D;
    if (fresh) {   // one more softmax term, always allowed
      const float m2 = fmaxf(mx, sm.s_fresh);
      const float c = expf(mx - m2), pf = expf(sm.s_fresh - m2);
      lsum = lsum * c + pf;
      a = a * c + pf * vf[bh * D + i % D];
    } else if (!(mx > bt::kNeg)) {   // no allowed key in any split
      sm.empty[s] = 1;
      empty = true;
      return;
    }
    out[bh * S * D + i] = bt::from_f32<T>(a / fmaxf(lsum, 1e-30f));
  };

  const size_t base = bh * splits + split;   // [B*H][splits]
  float* part_acc = partial;
  float* part_ml =
      partial + (size_t)gridDim.z * gridDim.y * splits * S * D;
  for (int i = tid; i < S * D; i += THREADS) {
    const int s = i / D, d = i % D;
    float mx = bt::kNeg;
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
      close(i, mx, lsum, a);
    } else {
      part_acc[base * S * D + i] = a;
      if (d == 0)
        *reinterpret_cast<float2*>(part_ml + (base * S + s) * 2) =
            make_float2(mx, lsum);
    }
  }
  if (splits > 1) {
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
      float mx = bt::kNeg;
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
      close(i, mx, lsum, a);
    }
  }
  if (!__syncthreads_or(empty)) return;
  uniform_sum<D, INT4, NS>(sm, pool, K, warp, lane);
  for (int i = tid; i < S * D; i += THREADS) {
    if (!sm.empty[i / D]) continue;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += sm.acc_w[w][0][i % D];
    out[bh * S * D + i] = bt::from_f32<T>(a / K);
  }
}

// Registers: two tiles, S x AW accumulators and the softmax state a lane;
// with one query row the smaller head dims fit four blocks an SM. At D =
// 128 the INT8 form spills at three blocks' cap of 168 registers, so both
// forms take two there (and then use ~240).
constexpr int min_blocks(int D, int NS) {
  return NS > 1 ? 2 : D == 128 ? 2 : 4;
}

// NS (1 or MAX_S) sizes the per-query arrays; S <= NS is a run-time value.
// INT4: the pool holds D/2 packed bytes a slot (see the top of the file).
// With gridDim.x > 1 splits, partial holds [B*H][splits][S][D] float32 sums
// followed by [B*H][splits][S][2] (max, sum), and counters one zero int per
// (b, h), left at zero.
template <typename T, int D, int NS, bool INT4>
__global__ void __launch_bounds__(THREADS, min_blocks(D, NS))
paged_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                  const float* __restrict__ ks, const int8_t* __restrict__ vq,
                  const float* __restrict__ vs,
                  const int* __restrict__ page_table,
                  const int* __restrict__ q_idx,
                  const int* __restrict__ kv_idx,
                  const int* __restrict__ kv_valid,
                  const float* __restrict__ kf, const float* __restrict__ vf,
                  T* __restrict__ out, float* __restrict__ partial,
                  int* __restrict__ counters, int H, int S, int P, int ps,
                  int n_virt, int slots_per_split, float sm_scale) {
  using F = Form<D, INT4>;
  using TileD = Tile<D, INT4>;
  __shared__ Smem<D, NS> sm;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bh = (size_t)b * H + h;
  const int K = n_virt * ps;
  for (int i = tid; i < NS * D; i += THREADS) {
    const int s = i / D;
    sm.qs[s][i % D] = s < S ? bt::to_f32(q[bh * S * D + i]) : 0.f;
  }
  if (tid < NS) sm.empty[tid] = 0;
  __syncthreads();
  if (kf != nullptr && warp == 0) {   // S == 1: the fresh key's score
    float a = 0.f;
    for (int d = lane; d < D; d += 32) a += sm.qs[0][d] * kf[bh * D + d];
    a = warp_sum(a);
    if (lane == 0) sm.s_fresh = a * sm_scale;
  }

  const Pool pool{kq, ks, vq, vs, page_table + (size_t)b * n_virt,
                  P, H, h, ps, ps % TILE == 0};
  const int* valid_b = kv_valid + (size_t)b * K;
  const int j_begin = split * slots_per_split;
  const int j_end = min(K, j_begin + slots_per_split);
  const int n_tiles = (j_end - j_begin + TILE - 1) / TILE;

  int qi[NS], qmax = INT_MIN;
  float m[NS], l[NS], acc[NS][F::AW];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    qi[s] = s < S ? q_idx[b * S + s] : INT_MIN;
    qmax = max(qmax, qi[s]);
    m[s] = bt::kNeg;
    l[s] = 0.f;
#pragma unroll
    for (int e = 0; e < F::AW; ++e) acc[s][e] = 0.f;
  }

  // Tiles t = warp, warp + WARPS, ... of the split, in two register sets
  // used in turn; the mask of the tile after the next waits in (idx_n,
  // ok_n).
  TileD A, B;
  int idx_n = 0, ok_n = 0;
  const auto j0_of = [&](int t) { return j_begin + t * TILE; };
  const auto seen = [&](int idx, int ok) {   // by some query row, warp-wide
    return __any_sync(FULL, ok && idx <= qmax);
  };
  int t = warp;
  if (t < n_tiles) {
    load_mask(A.idx, A.ok, kv_idx, valid_b, j0_of(t), j_end, lane);
    if (t + WARPS < n_tiles)
      load_mask(idx_n, ok_n, kv_idx, valid_b, j0_of(t + WARPS), j_end, lane);
    A.live = seen(A.idx, A.ok);
    if (A.live)
      A.template load_rows<true>(pool, sm.slots[warp], j0_of(t), j_end, lane);
  }
  const auto step = [&](TileD& cur, TileD& nxt, int t) {
    if (t + WARPS < n_tiles) {   // in flight during this tile's math
      nxt.idx = idx_n;
      nxt.ok = ok_n;
      nxt.live = seen(nxt.idx, nxt.ok);
      if (nxt.live)
        nxt.template load_rows<true>(pool, sm.slots[warp], j0_of(t + WARPS),
                                     j_end, lane);
      if (t + 2 * WARPS < n_tiles)
        load_mask(idx_n, ok_n, kv_idx, valid_b, j0_of(t + 2 * WARPS), j_end,
                  lane);
    }
    if (cur.live)
      attend<D, INT4, NS>(cur, sm, m, l, acc, qi, S, sm_scale,
                          j0_of(t) + lane < j_end, warp, lane);
  };
  for (; t < n_tiles; t += 2 * WARPS) {
    step(A, B, t);
    if (t + WARPS >= n_tiles) break;
    step(B, A, t + WARPS);
  }
  finish<T, D, NS, INT4>(sm, m, l, acc, pool, K, vf, out, partial, counters,
                         S, bh, warp, lane, tid);
}

// Pointers and shapes of one K6 launch.
struct AttnArgs {
  const void *q, *kq, *ks, *vq, *vs, *pt, *q_idx, *kv_idx, *kv_valid, *kf,
      *vf;
  void* out;
  float* partial;
  int* counters;
  int B, H, S, P, ps, n_virt, splits, slots_per_split;
};

template <typename T, int D, int NS, bool INT4>
void launch_attn(const AttnArgs& a, cudaStream_t stream) {
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(D));
  paged_attn_kernel<T, D, NS, INT4>
      <<<dim3(a.splits, a.H, a.B), THREADS, 0, stream>>>(
          static_cast<const T*>(a.q), static_cast<const int8_t*>(a.kq),
          static_cast<const float*>(a.ks), static_cast<const int8_t*>(a.vq),
          static_cast<const float*>(a.vs), static_cast<const int*>(a.pt),
          static_cast<const int*>(a.q_idx), static_cast<const int*>(a.kv_idx),
          static_cast<const int*>(a.kv_valid),
          static_cast<const float*>(a.kf), static_cast<const float*>(a.vf),
          static_cast<T*>(a.out), a.partial, a.counters, a.H, a.S, a.P, a.ps,
          a.n_virt, a.slots_per_split, sm_scale);
}

template <typename T, bool INT4>
int attn_dispatch(const AttnArgs& a, int D, cudaStream_t st) {
  const bool one = a.S == 1;
  switch (D) {
    case 32:
      one ? launch_attn<T, 32, 1, INT4>(a, st)
          : launch_attn<T, 32, MAX_S, INT4>(a, st);
      break;
    case 64:
      one ? launch_attn<T, 64, 1, INT4>(a, st)
          : launch_attn<T, 64, MAX_S, INT4>(a, st);
      break;
    case 128:
      one ? launch_attn<T, 128, 1, INT4>(a, st)
          : launch_attn<T, 128, MAX_S, INT4>(a, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5 (L = 1, pool pointers at the layer's base) and K7 (all L layers).
// Pools int8 [L, P, H, ps, D] and f32 [L, P, H, ps]; page/off int32 [B];
// kq/vq int8 [L, B, H, D]; ks/vs f32 [L, B, H]. vec: D % 16 == 0 and every
// int8 pointer 16-byte aligned.
extern "C" int bt_paged_write_int8(void* kpool, void* kspool, void* vpool,
                                   void* vspool, const void* page,
                                   const void* off, const void* kq,
                                   const void* ks, const void* vq,
                                   const void* vs, int L, int B, int P, int H,
                                   int ps, int D, int vec, void* stream) {
  if (B == 0 || L == 0) return 0;
  const dim3 grid(B, (L + WRITE_LAYERS - 1) / WRITE_LAYERS);
  paged_write_kernel<<<grid, WRITE_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(kpool), static_cast<float*>(kspool),
      static_cast<int8_t*>(vpool), static_cast<float*>(vspool),
      static_cast<const int*>(page), static_cast<const int*>(off),
      static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vq), static_cast<const float*>(vs), L, B, P,
      H, ps, D, vec);
  return static_cast<int>(cudaGetLastError());
}

// K5 / K7 fused with the quantization. k, v [B, H, D] of float (bf16 == 0)
// or bf16, last dim contiguous, (b, h) strides kb, kh, vb, vh; D <= 256.
// mode 0 (K5): pools int8 [L, P, H, ps, D] and f32 [L, P, H, ps] written at
// layer `layer`; page int32 [B] or null (page b), off int32 [B] or null
// (off_value). mode 1: step_q int8 [2, L, B, H, D], step_s f32 [2, L, B, H]
// at layer `layer`, kf/vf f32 [B, H, D]. mode 2 (K7): mode 1 at layer =
// L - 1, then every layer of each (b, h) into the pools at (page[b],
// off[b]). vec: each k/v row aligned to D / 32 elements and every other
// pointer to 16 bytes (the vector forms, D in {32, 64, 128}); copy16:
// D % 16 == 0 and the pools and step_q 16-byte aligned.
extern "C" int bt_paged_quantize_write_int8(
    const void* k, const void* v, void* kpool, void* kspool, void* vpool,
    void* vspool, const void* page, const void* off, void* step_q,
    void* step_s, void* kf, void* vf, int kb, int kh, int vb, int vh,
    int off_value, int mode, int B, int H, int D, int P, int ps, int L,
    int layer, int bf16, int vec, int copy16, void* stream) {
  if (D < 1 || D > QW_MAX_D || mode < QW_POOL || mode > QW_STEP_LAYERS ||
      layer < 0 || layer >= L || (mode == QW_STEP_LAYERS && layer != L - 1) ||
      (mode != QW_POOL && (step_q == nullptr || step_s == nullptr ||
                           kf == nullptr || vf == nullptr)) ||
      (mode != QW_STEP && (kpool == nullptr || vpool == nullptr ||
                           (mode == QW_STEP_LAYERS && page == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const QuantWriteArgs a{
      k, v, static_cast<int8_t*>(kpool), static_cast<float*>(kspool),
      static_cast<int8_t*>(vpool), static_cast<float*>(vspool),
      static_cast<const int*>(page), static_cast<const int*>(off),
      static_cast<int8_t*>(step_q), static_cast<float*>(step_s),
      static_cast<float*>(kf), static_cast<float*>(vf), kb, kh, vb, vh,
      off_value, mode, B, H, D, P, ps, L, layer, vec, copy16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_quantize_write<__nv_bfloat16>(a, st)
              : launch_quantize_write<float>(a, st);
}

// K8. Pools as above; pt_rows int32 [G, nv]; rows int8 [L, G, H, nv * ps, D]
// and f32 [L, G, H, nv * ps], D the bytes of a slot (D/2 of the head dim for
// packed INT4 pools and rows). vec: (ps * D) % 16 == 0 and aligned pointers.
extern "C" int bt_paged_page_copy_int8(void* kpool, void* kspool, void* vpool,
                                       void* vspool, const void* pt_rows,
                                       const void* rk, const void* rks,
                                       const void* rv, const void* rvs, int L,
                                       int G, int nv, int P, int H, int ps,
                                       int D, int vec, void* stream) {
  if (L == 0 || G == 0 || nv == 0 || H == 0) return 0;
  const dim3 grid(L * G * nv, H);
  page_copy_kernel<<<grid, COPY_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(kpool), static_cast<float*>(kspool),
      static_cast<int8_t*>(vpool), static_cast<float*>(vspool),
      static_cast<const int*>(pt_rows), static_cast<const int8_t*>(rk),
      static_cast<const float*>(rks), static_cast<const int8_t*>(rv),
      static_cast<const float*>(rvs), G, nv, P, H, ps, D, vec);
  return static_cast<int>(cudaGetLastError());
}

// K6. q [B, H, S, D] (float if q_bf16 == 0, else bf16), S <= 8, D in {32,
// 64, 128}; kq/vq of one layer: int8 [P, H, ps, D], or with int4 != 0
// packed uint8 [P, H, ps, D/2], 16-byte aligned; ks/vs f32 [P, H, ps]
// (P * H * ps < 2^32 slots); page_table int32 [B, n_virt]; q_idx int32
// [B, S]; kv_idx int32 [K]; kv_valid int32 [B, K] with K = n_virt * ps;
// kf/vf f32 [B, H, D], both or neither (only with S == 1); out
// [B, H, S, D] like q. The K virtual slots are cut into `splits` runs of
// slots_per_split (a multiple of 32; splits * slots_per_split >= K >
// (splits - 1) * slots_per_split); with splits > 1, workspace holds
// B*H*splits*S*(D + 2) floats and counters B*H zero ints, left at zero.
extern "C" int bt_paged_decode_attention_int8(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* page_table, const void* q_idx,
    const void* kv_idx, const void* kv_valid, const void* kf, const void* vf,
    void* out, void* workspace, void* counters, int B, int H, int S, int D,
    int P, int ps, int n_virt, int splits, int slots_per_split, int q_bf16,
    int int4, void* stream) {
  const long K = (long)n_virt * ps;
  if (S < 1 || S > MAX_S || (kf != nullptr && S != 1) ||
      (kf == nullptr) != (vf == nullptr) || K < 1 || splits < 1 ||
      slots_per_split % TILE != 0 || (long)splits * slots_per_split < K ||
      (long)(splits - 1) * slots_per_split >= K ||
      (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const AttnArgs a{q, kq, ks, vq, vs, page_table, q_idx, kv_idx, kv_valid,
                   kf, vf, out, static_cast<float*>(workspace),
                   static_cast<int*>(counters), B, H, S, P, ps, n_virt,
                   splits, slots_per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int4)
    return q_bf16 ? attn_dispatch<__nv_bfloat16, true>(a, D, st)
                  : attn_dispatch<float, true>(a, D, st);
  return q_bf16 ? attn_dispatch<__nv_bfloat16, false>(a, D, st)
                : attn_dispatch<float, false>(a, D, st);
}
