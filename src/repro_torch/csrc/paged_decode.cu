// Paged flash-decode for Hopper (sm_90a): one-token GQA attention per slot
// through a (B, M) page table, fp32 online softmax over chunks of pages.
//
// Replaces the TPU kernel `paged_flash_decode` (src/repro/kernels/
// paged_decode.py) in all its modes: native-dtype pools (q, pools and
// output all fp32 or all bf16) or int8 pools with per-row fp32 scales
// (`k_scale`/`v_scale`; q fp32 or bf16); normalized output (acc / l, in
// q's dtype) or, with `partials`, the raw fp32 online-softmax triple
// (acc, l, m) of one pool shard for the cross-shard merge of sharded
// serving.  The pool argument holds `p_local` pages whose first has the
// GLOBAL id `page_offset` (0 and the whole pool on one card); table entries
// outside that window belong to another shard and are skipped exactly like
// dead pages.  The Python wrappers and the plain PyTorch version live in
// src/repro_torch/kernels/paged_decode.py.
//
// Layouts: q (B, KV, G, D); k/v pools (p_local, page, KV, D) with global
// page 0 the scratch page; int8 scales (p_local, page, KV); table (B, M)
// int32 of global ids; positions (B,) int32; out (B, KV, G, D); partials
// acc (B, KV, G, D), l and m (B, KV, G), all fp32.  A row is read in
// 16-byte loads, so D must be a multiple of 4 (fp32), 8 (bf16) or 16 (int8)
// elements.
//
// Design.  One block per (slot, kv-head).  The block reads its own table row
// and position, and warp 0 lists, with one ballot per 32 entries, the
// slot's live pages (logical page <= pos / page) that lie in the window.
// The block walks only the rows of those pages, in chunks of whole pages
// (64 rows at page 16), so dead pages and other shards' pages are never
// read (a freed slot's all-zero row and an inactive slot at position 0
// read one row of scratch page 0 on the shard that holds it, and nothing
// elsewhere).  Each chunk's rows are first resolved to pool rows once, in
// shared memory (-1 for a row past `pos`), so the staging and score loops
// do no index arithmetic.  A chunk's K and V rows are gathered with 16-byte
// loads into shared memory as fp32, masked rows zeroed (K rows padded to
// D+1 floats so 32 key rows fall in 32 banks).  In the int8 mode each staged
// row's two scales are read once, through the same table entry as the row
// (so a row and its scale never come from different pages, and a dead
// page's scales are never read), into shared memory beside the rows, and
// every element is dequantized as it is staged (`int8 -> fp32 * scale`,
// the plain version's product exactly).  A thread per (query row, key row)
// takes the dot product, a warp per query row updates the running max and
// sum, and the (G, D) accumulator is rescaled and accumulated.  Normalized,
// the result is divided by max(l, 1e-30) once at the end, as the TPU kernel
// does; with `partials` the block writes acc, l and m as they stand, m
// starting at NEG_INF = -1e30, so a slot with no live row in the window
// gives (0, 0, -1e30) and weighs exactly 0 in the merge.
//
// What bounds it.  Decode attention moves the live K/V bytes once and does
// ~2 flops per byte (~4 in the int8 mode, whose rows are half as wide): it
// is bound by memory.  A chunk of several pages puts that many independent
// loads in flight per block before the first barrier, but at B=8, KV=8 the
// B*KV = 64 blocks still underfill the card's 132 SMs and each block walks
// its chunks in order, so the kernel stays latency bound above the byte
// bound; a shard's kernel walks only its own pages, so on n shards each
// block has about 1/n of the rows (fewer when the allocator keeps a slot on
// one shard) but the same 64 blocks.  Splitting a slot's pages over several
// blocks, merged with the same partials math, is the later fix.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kChunkRows = 64;   // rows staged per step (whole pages)

// 16 bytes of pool elements from global memory into fp32 registers.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const int8_t* src, float* dst) {
  const int4 u = *reinterpret_cast<const int4*>(src);
  const int8_t* e = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(e[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// T: q and output; P: pool elements, T itself or int8_t (then with scales);
// kPartials: write the raw fp32 (acc, l, m) triple instead of acc / l.
template <typename T, typename P, bool kPartials>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const P* __restrict__ k_pool,
                                    const P* __restrict__ v_pool,
                                    const float* __restrict__ k_scale,
                                    const float* __restrict__ v_scale,
                                    const int* __restrict__ table,
                                    const int* __restrict__ positions,
                                    T* __restrict__ out,
                                    float* __restrict__ acc_out,
                                    float* __restrict__ l_out,
                                    float* __restrict__ m_out, int KV, int G,
                                    int D, int page, int M, int R,
                                    int page_offset, int p_local,
                                    float scale) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kVec = 16 / sizeof(P);
  extern __shared__ float smem[];
  __shared__ int n_local_s;
  const int Dk = D + 1;
  float* q_s = smem;                 // G * D, pre-scaled
  float* k_s = q_s + G * D;          // R * (D + 1)
  float* v_s = k_s + R * Dk;         // R * D
  float* s_s = v_s + R * D;          // G * R scores, then probabilities
  float* acc_s = s_s + G * R;        // G * D
  float* m_s = acc_s + G * D;        // G running max
  float* l_s = m_s + G;              // G running sum
  float* c_s = l_s + G;              // G correction of this chunk
  float* ks_s = c_s + G;             // R K row scales (int8 pools only)
  float* vs_s = ks_s + R;            // R V row scales
  // M logical page ids of the walk, then their local page ids, then R
  // pool rows of this chunk's rows (-1: masked)
  int* pg_s = reinterpret_cast<int*>(kQuant ? vs_s + R : ks_s);
  int* ph_s = pg_s + M;
  int* ro_s = ph_s + M;

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  const size_t qo = (static_cast<size_t>(b) * KV + h) * G * D;
  for (int i = tid; i < G * D; i += nt) {
    q_s[i] = to_f32(q[qo + i]) * scale;
    acc_s[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = REPRO_NEG_INF;
    l_s[tid] = 0.f;
  }
  // The slot's live pages that lie in this pool's window, in logical order
  // (warp 0, 32 table entries per ballot).  Dead pages and pages outside
  // [page_offset, page_offset + p_local) are never read.
  const int pos = positions[b];
  const int n_live = min(pos / page + 1, M);
  if (warp == 0) {
    int cnt = 0;
    for (int j0 = 0; j0 < n_live; j0 += 32) {
      const int j = j0 + lane;
      const int loc = j < n_live ? table[b * M + j] - page_offset : -1;
      const bool ok = loc >= 0 && loc < p_local;
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int idx = cnt + __popc(mask & ((1u << lane) - 1u));
        pg_s[idx] = j;
        ph_s[idx] = loc;
      }
      cnt += __popc(mask);
    }
    if (lane == 0) n_local_s = cnt;
  }
  __syncthreads();
  const int n_rows = n_local_s * page;                  // rows of the walk
  const size_t row_stride = static_cast<size_t>(KV) * D;
  const int per_row = D / kVec;

  for (int c0 = 0; c0 < n_rows; c0 += R) {
    // each row of the chunk: its pool row, or -1 past the walk or past pos
    // (and, int8, its two scales, read through the same pool row)
    for (int r = tid; r < R; r += nt) {
      const int vr = c0 + r;
      int ro = -1;
      if (vr < n_rows) {
        const int idx = vr / page, rr = vr - idx * page;
        if (pg_s[idx] * page + rr <= pos) ro = ph_s[idx] * page + rr;
      }
      ro_s[r] = ro;
      if constexpr (kQuant) {
        const size_t si = static_cast<size_t>(ro) * KV + h;
        ks_s[r] = ro >= 0 ? k_scale[si] : 0.f;
        vs_s[r] = ro >= 0 ? v_scale[si] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < R * per_row; i += nt) {
      const int r = i / per_row, d = (i - r * per_row) * kVec;
      const int ro = ro_s[r];
      float kf[kVec], vf[kVec];
      if (ro >= 0) {
        const size_t off = static_cast<size_t>(ro) * row_stride +
                           static_cast<size_t>(h) * D + d;
        load16(k_pool + off, kf);
        load16(v_pool + off, vf);
        if constexpr (kQuant) {
          const float ks = ks_s[r], vs = vs_s[r];
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            kf[e] *= ks;
            vf[e] *= vs;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[r * Dk + d + e] = kf[e];
        v_s[r * D + d + e] = vf[e];
      }
    }
    __syncthreads();
    for (int p = tid; p < G * R; p += nt) {
      const int g = p / R, r = p - g * R;
      const float* qr = q_s + g * D;
      const float* kr = k_s + r * Dk;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      s_s[p] = ro_s[r] >= 0 ? dot : REPRO_NEG_INF;
    }
    __syncthreads();
    // Every chunk starts a live page, whose first row is valid, so m_new is
    // a real score and the masked rows' exp(NEG_INF - m_new) is exactly 0.
    for (int g = warp; g < G; g += nwarps) {
      float* s = s_s + g * R;
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int r = lane; r < R; r += 32) m_new = fmaxf(m_new, s[r]);
      m_new = warp_max(m_new);
      float sum = 0.f;
      for (int r = lane; r < R; r += 32) {
        const float e = expf(s[r] - m_new);
        s[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += nt) {
      const int g = i / D, d = i - g * D;
      const float* pr = s_s + g * R;
      float a = acc_s[i] * c_s[g];
      for (int r = 0; r < R; ++r) a += pr[r] * v_s[r * D + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }
  if constexpr (kPartials) {
    // a slot with no live row in this window leaves (0, 0, NEG_INF), the
    // merge's identity element
    for (int i = tid; i < G * D; i += nt) acc_out[qo + i] = acc_s[i];
    if (tid < G) {
      const size_t lo = (static_cast<size_t>(b) * KV + h) * G + tid;
      l_out[lo] = l_s[tid];
      m_out[lo] = m_s[tid];
    }
  } else {
    for (int i = tid; i < G * D; i += nt) {
      const int g = i / D;
      out[qo + i] = from_f32<T>(acc_s[i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *table, *pos;
  void *out, *acc, *l, *m;
  int B, KV, G, D, page, M, page_offset, p_local;
};

template <typename T, typename P, bool kPartials>
static cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  if (a.D % (16 / sizeof(P)) || a.M < 1 || a.p_local < 1)
    return cudaErrorInvalidValue;
  const int G = a.G, D = a.D;
  const int R = a.page * max(1, kChunkRows / a.page);
  const size_t smem = sizeof(float) * (2 * G * D + R * (D + 1) + R * D +
                                       G * R + 3 * G + (kQuant ? 2 * R : 0)) +
                      sizeof(int) * (2 * a.M + R);
  static size_t granted = 0;  // one per (T, P, kPartials)
  cudaError_t err =
      allow_smem(paged_decode_kernel<T, P, kPartials>, smem, &granted);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  paged_decode_kernel<T, P, kPartials><<<a.B * a.KV, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.table),
      static_cast<const int*>(a.pos), static_cast<T*>(a.out),
      static_cast<float*>(a.acc), static_cast<float*>(a.l),
      static_cast<float*>(a.m), a.KV, G, D, a.page, a.M, R, a.page_offset,
      a.p_local, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(int quant, int partials, const Args& a,
                            cudaStream_t s) {
  if (quant)
    return partials ? launch<T, int8_t, true>(a, s)
                    : launch<T, int8_t, false>(a, s);
  return partials ? launch<T, T, true>(a, s) : launch<T, T, false>(a, s);
}

// Every mode of K1.  `dtype` is q's (and, normalized, out's); `quant`: int8
// pools with (P, page, KV) fp32 scales `ks`/`vs`, else pools of q's dtype;
// `partials`: write fp32 acc (B, KV, G, D), l and m (B, KV, G), else `out`.
// The pool holds `p_local` pages whose first has global id `page_offset`;
// table entries outside that window are skipped like dead pages.  Pointers
// a mode does not use may be null.
extern "C" int paged_decode_launch(int dtype, int quant, int partials,
                                   const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, const void* table,
                                   const void* pos, void* out, void* acc,
                                   void* l, void* m, int B, int KV, int G,
                                   int D, int page, int M, int page_offset,
                                   int p_local, void* stream) {
  const Args a{q,   k,  v, ks, vs, table, pos, out, acc, l, m,
               B, KV, G, D, page,  M,   page_offset, p_local};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch<float>(quant, partials, a, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(quant, partials, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
