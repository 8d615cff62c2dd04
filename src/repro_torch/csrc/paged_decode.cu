// Paged flash-decode for Hopper (sm_90a): one-token GQA attention per slot
// through a (B, M) page table, fp32 online softmax over chunks of pages.
//
// Replaces the TPU kernel `paged_flash_decode` (src/repro/kernels/
// paged_decode.py), native-dtype pools with normalized output and page
// offset 0.  The Python wrapper and the plain PyTorch version live in
// src/repro_torch/kernels/paged_decode.py.
//
// Layouts: q (B, KV, G, D); k/v pools (P, page, KV, D) with page 0 the
// scratch page; table (B, M) int32; positions (B,) int32; out (B, KV, G, D).
// D must be a multiple of 8 (16-byte row loads).
//
// Design.  One block per (slot, kv-head).  The block reads its own table row
// and position and walks the slot's rows 0..pos only, in chunks of whole
// pages (64 rows at page 16), so pages past the position are never read (a
// freed slot's all-zero row and an inactive slot at position 0 read one row
// of scratch page 0).  A chunk's K and V rows are gathered through the table
// with 16-byte loads into shared memory as fp32, rows past `pos` zeroed
// (K rows padded to D+1 floats so 32 key rows fall in 32 banks).  A thread
// per (query row, key row) takes the dot product, a warp per query row
// updates the running max and sum, and the (G, D) accumulator is rescaled
// and accumulated.  The result is divided by max(l, 1e-30) once at the end,
// as the TPU kernel does.
//
// What bounds it.  Decode attention moves the live K/V bytes once and does
// ~2 flops per byte: it is bound by memory.  A chunk of several pages puts
// that many independent loads in flight per block before the first barrier,
// but at B=8, KV=8 the B*KV = 64 blocks still underfill the card's 132 SMs
// and each block walks its chunks in order, so the kernel stays latency
// bound above the byte bound; splitting a slot's pages over several blocks
// with a partials merge is the later fix.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kChunkRows = 64;   // rows staged per step (whole pages)

// 16 bytes of T from global memory into fp32 registers.
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pool,
                                    const T* __restrict__ v_pool,
                                    const int* __restrict__ table,
                                    const int* __restrict__ positions,
                                    T* __restrict__ out, int KV, int G, int D,
                                    int page, int M, int R, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int Dk = D + 1;
  float* q_s = smem;                 // G * D, pre-scaled
  float* k_s = q_s + G * D;          // R * (D + 1)
  float* v_s = k_s + R * Dk;         // R * D
  float* s_s = v_s + R * D;          // G * R scores, then probabilities
  float* acc_s = s_s + G * R;        // G * D
  float* m_s = acc_s + G * D;        // G running max
  float* l_s = m_s + G;              // G running sum
  float* c_s = l_s + G;              // G correction of this chunk

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
  const int n_rows = min(positions[b] + 1, M * page);   // rows 0..pos
  const size_t row_stride = static_cast<size_t>(KV) * D;
  const int per_row = D / kVec;
  __syncthreads();

  for (int c0 = 0; c0 < n_rows; c0 += R) {
#pragma unroll 4
    for (int i = tid; i < R * per_row; i += nt) {
      const int r = i / per_row, d = (i - r * per_row) * kVec;
      const int row = c0 + r;
      float kf[kVec], vf[kVec];
      if (row < n_rows) {
        const size_t off =
            (static_cast<size_t>(table[b * M + row / page]) * page +
             row % page) * row_stride + static_cast<size_t>(h) * D + d;
        load16(k_pool + off, kf);
        load16(v_pool + off, vf);
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
      s_s[p] = c0 + r < n_rows ? dot : REPRO_NEG_INF;
    }
    __syncthreads();
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
  for (int i = tid; i < G * D; i += nt) {
    const int g = i / D;
    out[qo + i] = from_f32<T>(acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* table, const void* pos, void* out, int B,
                          int KV, int G, int D, int page, int M,
                          cudaStream_t stream) {
  if (D % (16 / sizeof(T))) return cudaErrorInvalidValue;
  const int R = page * max(1, kChunkRows / page);
  const size_t smem = sizeof(float) * (2 * G * D + R * (D + 1) + R * D +
                                       G * R + 3 * G);
  static size_t granted = 0;  // one per T
  cudaError_t err = allow_smem(paged_decode_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  paged_decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<T*>(out), KV, G, D, page, M,
      R, scale);
  return cudaGetLastError();
}

extern "C" int paged_decode_launch(int dtype, const void* q, const void* k,
                                   const void* v, const void* table,
                                   const void* pos, void* out, int B, int KV,
                                   int G, int D, int page, int M,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, table, pos, out, B, KV, G, D, page, M, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, table, pos, out, B, KV, G, D, page,
                                 M, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
