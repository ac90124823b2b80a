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
// the kernel read outside the pool. Design as K2: one block of 8 warps per
// (b, h), 32-key tiles dealt round-robin to the warps, one key per lane in
// the score phase (16-byte loads of its int8 row), each lane's pool slot
// passed by shuffle to the lanes that own the value dims in P.V, warp
// states merged through shared memory at the end, where the fresh term is
// folded in. Bound by bytes: it reads each visible key and value row once
// (D + 4 bytes each), against ~4 * S * D operations per key.
//
// K6's INT4 form (the Pallas kernel widens any pool dtype) is the template
// argument INT4 of the same kernel: a lane's key row is D/2 bytes (one to
// four 16-byte loads), each byte widened exactly into its two signed
// nibbles by the byte permute onto 2^23 (mma.cuh), the low one dotted with
// query dim i and the high one with i + D/2; in P.V a lane's DPL output dims
// lie in one half of D, so it reads DPL bytes and takes their low (lanes
// 0-15) or high (lanes 16-31) nibbles.
// It reads (D/2 + 4) bytes a visible key or value row, about half the INT8
// form's at D = 128.
//
// K8, paged_page_copy_int8 (Pallas _page_copy_kernel): admission copies G
// prefilled rows [L, G, H, nv * ps, D] (+ scales) page by page into their
// pool pages pt_rows[g, j]; one block per (layer, row, virtual page, head)
// copies ps * D bytes and ps scales with 16-byte loads and stores (D here is
// a slot's bytes: D/2 of the head dim for a packed INT4 pool). An entry
// of pt_rows outside [0, P) is dropped. Pages are written whole, so no
// read-modify-write; duplicate targets (padded admission rows, unallocated
// tails on page 0) write identical or masked data. Bound by bytes.

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

constexpr int WARPS = 8;
constexpr int MAX_S = 8;

// The four low (hi = false) or high nibbles of the 4 bytes of w, each
// biased by 8 into a byte of its own: bt::biased_byte<8>(result, i) is the
// signed value of byte i's nibble, exactly and without integer-to-float
// conversions (mma.cuh).
__device__ __forceinline__ uint32_t nibbles(uint32_t w, bool hi) {
  const uint32_t u = w ^ 0x88888888u;
  return (hi ? u >> 4 : u) & 0x0F0F0F0Fu;
}

// INT4: the pool holds D/2 packed bytes a slot (see the top of the file).
template <typename T, int D, bool INT4>
__global__ void __launch_bounds__(WARPS * 32)
paged_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                  const float* __restrict__ ks, const int8_t* __restrict__ vq,
                  const float* __restrict__ vs,
                  const int* __restrict__ page_table,
                  const int* __restrict__ q_idx,
                  const int* __restrict__ kv_idx,
                  const int* __restrict__ kv_valid,
                  const float* __restrict__ kf, const float* __restrict__ vf,
                  T* __restrict__ out, int H, int S, int P, int ps,
                  int n_virt, float sm_scale) {
  constexpr int DPL = D / 32;   // output dims per lane
  constexpr int RB = INT4 ? D / 2 : D;   // bytes of a slot's values
  __shared__ float qs[MAX_S][D];
  __shared__ float m_w[WARPS][MAX_S];
  __shared__ float l_w[WARPS][MAX_S];
  __shared__ float acc_w[WARPS][MAX_S][D];
  __shared__ float s_fresh;

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int K = n_virt * ps;
  const bool fresh = kf != nullptr;

  for (int i = threadIdx.x; i < S * D; i += blockDim.x)
    qs[i / D][i % D] = bt::to_f32(q[bh * S * D + i]);
  __syncthreads();
  if (fresh && warp == 0) {   // S == 1: the fresh key's score
    float a = 0.f;
    for (int d = lane; d < D; d += 32) a += qs[0][d] * kf[bh * D + d];
    a = warp_sum(a);
    if (lane == 0) s_fresh = a * sm_scale;
  }

  const int* pt_b = page_table + static_cast<size_t>(b) * n_virt;
  const int* valid_b = kv_valid + static_cast<size_t>(b) * K;

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

  const int n_tiles = (K + 31) / 32;
  for (int t = warp; t < n_tiles; t += WARPS) {
    const int j = t * 32 + lane;   // this lane's virtual position
    const bool in_range = j < K;
    // this key's pool slot: (page * H + h) * ps + o in [P, H, ps]
    unsigned long long slot = 0;
    if (in_range) {
      const int vp = j / ps;
      int pg = pt_b[vp];
      if (pg < 0 || pg >= P) pg = 0;   // never read outside the pool
      slot = (static_cast<unsigned long long>(pg) * H + h) * ps + (j - vp * ps);
    }
    float sc[MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) sc[s] = 0.f;
    if (in_range) {
      const int8_t* krow = kq + slot * RB;
#pragma unroll
      for (int d0 = 0; d0 < RB; d0 += 16) {
        if constexpr (INT4) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + d0);
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t lo = nibbles(w[c], false), hi = nibbles(w[c], true);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int d = d0 + c * 4 + e;
              const float kl = bt::biased_byte<8>(lo, e);
              const float kh = bt::biased_byte<8>(hi, e);
#pragma unroll
              for (int s = 0; s < MAX_S; ++s)
                if (s < S) sc[s] += qs[s][d] * kl + qs[s][d + D / 2] * kh;
            }
          }
        } else {
          union {
            int4 u;
            int8_t b[16];
          } raw;
          raw.u = *reinterpret_cast<const int4*>(krow + d0);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float kv = static_cast<float>(raw.b[e]);
#pragma unroll
            for (int s = 0; s < MAX_S; ++s)
              if (s < S) sc[s] += qs[s][d0 + e] * kv;
          }
        }
      }
    }
    const float k_mul = in_range ? ks[slot] * sm_scale : 0.f;
    const float v_mul = in_range ? vs[slot] : 0.f;
    const int kvi = in_range ? kv_idx[j] : 0;
    const bool valid = in_range && valid_b[j] != 0;

#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s >= S) break;
      float v = sc[s] * k_mul;
      if (!(valid && kvi <= qi[s])) v = bt::kNeg;
      if (!in_range) v = -INFINITY;   // past the virtual capacity: no weight
      const float m_new = fmaxf(m[s], warp_max(v));
      const float corr = expf(m[s] - m_new);
      const float p = expf(v - m_new);
      l[s] = l[s] * corr + warp_sum(p);
      m[s] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[s][e] *= corr;
      sc[s] = p * v_mul;
    }

    const int n_keys = min(32, K - t * 32);
    for (int jj = 0; jj < n_keys; ++jj) {
      const unsigned long long vslot = __shfl_sync(FULL, slot, jj);
      float vv[DPL];
      if constexpr (INT4) {   // this lane's dims, all in one half of D
        const uint8_t* vrow = reinterpret_cast<const uint8_t*>(vq) +
                              vslot * RB + (lane % 16) * DPL;
        uint32_t w;   // the DPL bytes of this lane's dims
        if constexpr (DPL == 4)
          w = *reinterpret_cast<const uint32_t*>(vrow);
        else if constexpr (DPL == 2)
          w = *reinterpret_cast<const uint16_t*>(vrow);
        else
          w = *vrow;
        const uint32_t nib = nibbles(w, lane >= 16);
#pragma unroll
        for (int e = 0; e < DPL; ++e) vv[e] = bt::biased_byte<8>(nib, e);
      } else if constexpr (DPL == 4) {
        const int8_t* vrow = vq + vslot * D + lane * DPL;
        const char4 c = *reinterpret_cast<const char4*>(vrow);
        vv[0] = c.x;
        vv[1] = c.y;
        vv[2] = c.z;
        vv[3] = c.w;
      } else {
        const int8_t* vrow = vq + vslot * D + lane * DPL;
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
    if (fresh) {   // one more softmax term: score s_fresh, value vf
      const float m2 = fmaxf(mx, s_fresh);
      const float c = expf(mx - m2), pf = expf(s_fresh - m2);
      lsum = lsum * c + pf;
      a = a * c + pf * vf[bh * D + d];
    }
    out[bh * S * D + i] = bt::from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, bool INT4>
void launch_attn(const void* q, const void* kq, const void* ks, const void* vq,
                 const void* vs, const void* pt, const void* q_idx,
                 const void* kv_idx, const void* kv_valid, const void* kf,
                 const void* vf, void* out, int B, int H, int S, int P,
                 int ps, int n_virt, cudaStream_t stream) {
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(D));
  paged_attn_kernel<T, D, INT4><<<dim3(H, B), WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(q_idx), static_cast<const int*>(kv_idx),
      static_cast<const int*>(kv_valid), static_cast<const float*>(kf),
      static_cast<const float*>(vf), static_cast<T*>(out), H, S, P, ps,
      n_virt, sm_scale);
}

template <typename T, bool INT4>
int attn_dispatch_d(const void* q, const void* kq, const void* ks,
                    const void* vq, const void* vs, const void* pt,
                    const void* q_idx, const void* kv_idx,
                    const void* kv_valid, const void* kf, const void* vf,
                    void* out, int B, int H, int S, int D, int P, int ps,
                    int n_virt, cudaStream_t st) {
  switch (D) {
    case 32:
      launch_attn<T, 32, INT4>(q, kq, ks, vq, vs, pt, q_idx, kv_idx, kv_valid,
                               kf, vf, out, B, H, S, P, ps, n_virt, st);
      break;
    case 64:
      launch_attn<T, 64, INT4>(q, kq, ks, vq, vs, pt, q_idx, kv_idx, kv_valid,
                               kf, vf, out, B, H, S, P, ps, n_virt, st);
      break;
    case 128:
      launch_attn<T, 128, INT4>(q, kq, ks, vq, vs, pt, q_idx, kv_idx,
                                kv_valid, kf, vf, out, B, H, S, P, ps, n_virt,
                                st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool INT4>
int attn_dispatch_t(const void* q, const void* kq, const void* ks,
                    const void* vq, const void* vs, const void* pt,
                    const void* q_idx, const void* kv_idx,
                    const void* kv_valid, const void* kf, const void* vf,
                    void* out, int B, int H, int S, int D, int P, int ps,
                    int n_virt, int q_bf16, cudaStream_t st) {
  if (q_bf16)
    return attn_dispatch_d<__nv_bfloat16, INT4>(q, kq, ks, vq, vs, pt, q_idx,
                                                kv_idx, kv_valid, kf, vf, out,
                                                B, H, S, D, P, ps, n_virt, st);
  return attn_dispatch_d<float, INT4>(q, kq, ks, vq, vs, pt, q_idx, kv_idx,
                                      kv_valid, kf, vf, out, B, H, S, D, P,
                                      ps, n_virt, st);
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
// packed uint8 [P, H, ps, D/2]; ks/vs f32 [P, H, ps]; page_table int32
// [B, n_virt]; q_idx int32 [B, S]; kv_idx int32 [K]; kv_valid int32 [B, K]
// with K = n_virt * ps; kf/vf f32 [B, H, D] or null (only with S == 1);
// out [B, H, S, D] like q.
extern "C" int bt_paged_decode_attention_int8(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* page_table, const void* q_idx,
    const void* kv_idx, const void* kv_valid, const void* kf, const void* vf,
    void* out, int B, int H, int S, int D, int P, int ps, int n_virt,
    int q_bf16, int int4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > MAX_S || (kf != nullptr && S != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (int4)
    return attn_dispatch_t<true>(q, kq, ks, vq, vs, page_table, q_idx, kv_idx,
                                 kv_valid, kf, vf, out, B, H, S, D, P, ps,
                                 n_virt, q_bf16, st);
  return attn_dispatch_t<false>(q, kq, ks, vq, vs, page_table, q_idx, kv_idx,
                                kv_valid, kf, vf, out, B, H, S, D, P, ps,
                                n_virt, q_bf16, st);
}
