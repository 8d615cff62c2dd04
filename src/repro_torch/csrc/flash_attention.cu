// Causal (or non-causal) flash attention for Hopper (sm_90a) with GQA K/V
// sharing, fp32 online softmax over KV tiles.
//
// Replaces the TPU kernel `flash_attention_bhsd` (src/repro/kernels/
// flash_attention.py).  The Python wrapper and the plain PyTorch version
// live in src/repro_torch/kernels/flash_attention.py.
//
// Layouts: q (BHG, S, D); k, v (BKV, S, D) with BHG = BKV * G; query row b
// reads K/V row b / G, so GQA never materializes repeated K/V.  out like q.
//
// Design.  One block per (query-head row, 32-row query tile).  The block
// stages its query tile in shared memory as fp32 (pre-scaled by 1/sqrt(D)),
// then walks 32-row KV tiles in order, causal tiles only up to the diagonal
// of its last query row.  Each tile's K and V are staged in shared memory
// (K rows padded to D+1 floats so a warp's 32 key rows fall in 32 banks),
// scores are masked to -1e30 above the diagonal and past S, and the running
// max, sum and (32, D) accumulator update per row.  Unlike the TPU kernel,
// which asserts S % block == 0, ragged tails are masked, because the serve
// engine's prefill bucket min(next_pow2(len), max_seq) need not be a
// multiple of the tile.
//
// What bounds it.  At the prefill buckets (S <= 512, D = 128) the kernel
// does O(S) flops per byte and would be bound by the tensor cores; this
// first version computes on the CUDA cores in fp32 (no wgmma, no TMA), so
// it runs far from either bound.  wgmma tiles fed by TMA are the later fix.
#include "common.cuh"

constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr int kThreads = 256;

template <typename T>
__global__ void flash_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, int G, int S,
                                       int D, int n_qt, int causal,
                                       float scale) {
  extern __shared__ float smem[];
  const int Dk = D + 1;
  float* q_s = smem;                 // kBQ * D, pre-scaled
  float* k_s = q_s + kBQ * D;        // kBK * (D + 1)
  float* v_s = k_s + kBK * Dk;       // kBK * D
  float* s_s = v_s + kBK * D;        // kBQ * kBK scores, then probabilities
  float* acc_s = s_s + kBQ * kBK;    // kBQ * D
  float* m_s = acc_s + kBQ * D;      // kBQ running max
  float* l_s = m_s + kBQ;            // kBQ running sum
  float* c_s = l_s + kBQ;            // kBQ correction of this tile

  const int b = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - b * n_qt) * kBQ;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t qbase = static_cast<size_t>(b) * S * D;
  const size_t kbase = static_cast<size_t>(b / G) * S * D;

  for (int i = tid; i < kBQ * D; i += nt) {
    const int r = i / D;
    q_s[i] = q0 + r < S ? to_f32(q[qbase + static_cast<size_t>(q0) * D + i]) *
                              scale
                        : 0.f;
    acc_s[i] = 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = REPRO_NEG_INF;
    l_s[tid] = 0.f;
  }
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;  // keys [0, kv_end) can be live
  const int n_kt = (kv_end + kBK - 1) / kBK;
  __syncthreads();

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * D; i += nt) {
      const int r = i / D, d = i - r * D;
      const bool in = k0 + r < S;
      const size_t off = kbase + static_cast<size_t>(k0) * D + i;
      k_s[r * Dk + d] = in ? to_f32(k[off]) : 0.f;
      v_s[i] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();
    for (int p = tid; p < kBQ * kBK; p += nt) {
      const int r = p / kBK, c = p - r * kBK;
      const int qpos = q0 + r, kpos = k0 + c;
      float dot = 0.f;
      const float* qr = q_s + r * D;
      const float* kr = k_s + c * Dk;
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      const bool live = kpos < S && (!causal || kpos <= qpos);
      s_s[p] = live ? dot : REPRO_NEG_INF;
    }
    __syncthreads();
    if (tid < kBQ) {
      float* s = s_s + tid * kBK;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int c = 0; c < kBK; ++c) m_new = fmaxf(m_new, s[c]);
      float sum = 0.f;
      for (int c = 0; c < kBK; ++c) {
        const float e = expf(s[c] - m_new);
        s[c] = e;
        sum += e;
      }
      const float corr = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      c_s[tid] = corr;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * D; i += nt) {
      const int r = i / D, d = i - r * D;
      float a = acc_s[i] * c_s[r];
      const float* pr = s_s + r * kBK;
      for (int c = 0; c < kBK; ++c) a += pr[c] * v_s[c * D + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < kBQ * D; i += nt) {
    const int r = i / D;
    if (q0 + r < S)
      out[qbase + static_cast<size_t>(q0) * D + i] =
          from_f32<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* out, int BHG, int BKV, int S, int D,
                          int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D +
                                       kBQ * kBK + kBQ * D + 3 * kBQ);
  static size_t granted = 0;  // one per T
  cudaError_t err = allow_smem(flash_attention_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_attention_kernel<T><<<BHG * n_qt, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), BHG / BKV, S, D, n_qt,
      causal, scale);
  return cudaGetLastError();
}

extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int BHG,
                                      int BKV, int S, int D, int causal,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, out, BHG, BKV, S, D, causal, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, out, BHG, BKV, S, D, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
