// Fused softmax cross-entropy for Hopper (sm_90a): the forward (per-row NLL
// and log-sum-exp over a vocab-padded logits matrix) and its backward.
//
// Replaces the TPU kernel `softmax_xent` (src/repro/kernels/
// softmax_xent.py).  The Python wrapper, the autograd binding and the plain
// PyTorch versions live in src/repro_torch/kernels/softmax_xent.py.
//
// Layouts: logits (N, Vp) row-major, float32 or bfloat16; labels (N,)
// int32 < vocab <= Vp; nll, lse (N,) float32; dlogits like logits.
//
// Forward.  One block per row makes a single pass over the row with an
// online max and sum (each thread keeps its own (max, sum) pair, rescaling
// the sum when the max grows), then merges the pairs with warp shuffles and
// shared memory.  Columns >= vocab are skipped, so the padded vocab tail
// never enters the sum.  The label logit is read directly.  Unlike the TPU
// kernel, which returns only nll, it also writes lse: the z-loss and the
// backward both need it, and recomputing it would read the logits again.
//
// Backward.  dlogits[n, j] = (g_nll[n] + g_lse[n]) * exp(x[n, j] - lse[n])
// - g_nll[n] * [j == label[n]], and 0 for j >= vocab: one read and one write
// of every logit.  A 2-D grid of (column tile, row) blocks fills the card
// whatever the number of rows.
//
// What bounds it.  Both passes do a handful of fp32 operations per element
// and move 2 (bf16) or 4 (fp32) bytes per element each way: they are bound
// by HBM bandwidth.  Rows are read and written as 16-byte packs, so every
// row must start on a 16-byte boundary (the wrapper checks the base pointer
// and Vp * sizeof(T); a vocab padded to a multiple of 128 always passes).
#include "common.cuh"

constexpr int kFwdThreads = 512;
constexpr int kBwdThreads = 256;
constexpr int kBwdIters = 4;  // vector loads per thread per backward block

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Merges the (max, sum) pair (m2, s2) into (m, s).  Sums are scaled to the
// larger max; REPRO_NEG_INF is the "empty" max, for which exp(0) * 0 = 0.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * __expf(m - mn) + s2 * __expf(m2 - mn);
  m = mn;
}

template <typename T, int VEC>
__global__ void softmax_xent_fwd_kernel(const T* __restrict__ logits,
                                        const int* __restrict__ labels,
                                        float* __restrict__ nll,
                                        float* __restrict__ lse, int Vp,
                                        int vocab) {
  const int row = blockIdx.x;
  const T* x = logits + static_cast<size_t>(row) * Vp;
  const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(x);
  const int n_vec = (vocab + VEC - 1) / VEC;  // packs holding a live column
  float m = REPRO_NEG_INF, s = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const Pack<T, VEC> pk = xv[i];
    float v[VEC];
    float cm = REPRO_NEG_INF;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      v[j] = i * VEC + j < vocab ? to_f32(pk.v[j]) : REPRO_NEG_INF;
      cm = fmaxf(cm, v[j]);
    }
    const float mn = fmaxf(m, cm);
    s *= __expf(m - mn);
#pragma unroll
    for (int j = 0; j < VEC; ++j) s += __expf(v[j] - mn);
    m = mn;
  }
  // warp, then block merge of the (max, sum) pairs
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float m_s[32], s_s[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    m_s[warp] = m;
    s_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    m = lane < n_warps ? m_s[lane] : REPRO_NEG_INF;
    s = lane < n_warps ? s_s[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      const float l = m + logf(s);
      const int y = labels[row];
      // an out-of-range label gives NaN rather than a silent wrong loss
      const float picked =
          (y >= 0 && y < vocab) ? to_f32(x[y]) : __int_as_float(0x7fc00000);
      lse[row] = l;
      nll[row] = l - picked;
    }
  }
}

template <typename T, int VEC>
__global__ void softmax_xent_bwd_kernel(
    const T* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ g_nll,
    const float* __restrict__ g_lse, T* __restrict__ dlogits, int N, int Vp,
    int vocab) {
  const int n_vec = Vp / VEC;
  const int per_block = kBwdThreads * kBwdIters;  // packs per block
  const int v0 = blockIdx.x * per_block;
  const int v1 = min(n_vec, v0 + per_block);
  for (int row = blockIdx.y; row < N; row += gridDim.y) {
    const size_t base = static_cast<size_t>(row) * Vp;
    const Pack<T, VEC>* xv =
        reinterpret_cast<const Pack<T, VEC>*>(logits + base);
    Pack<T, VEC>* dv = reinterpret_cast<Pack<T, VEC>*>(dlogits + base);
    const float l = lse[row], gn = g_nll[row], gs = gn + g_lse[row];
    const int y = labels[row];
#pragma unroll 4
    for (int i = v0 + threadIdx.x; i < v1; i += kBwdThreads) {
      const Pack<T, VEC> pk = xv[i];
      Pack<T, VEC> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int c = i * VEC + j;
        float d = 0.f;
        if (c < vocab) {
          d = gs * __expf(to_f32(pk.v[j]) - l);
          if (c == y) d -= gn;
        }
        out.v[j] = from_f32<T>(d);
      }
      dv[i] = out;
    }
  }
}

template <typename T, int VEC>
static cudaError_t launch_fwd(const void* logits, const void* labels,
                              void* nll, void* lse, int N, int Vp, int vocab,
                              cudaStream_t stream) {
  softmax_xent_fwd_kernel<T, VEC><<<N, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const int*>(labels),
      static_cast<float*>(nll), static_cast<float*>(lse), Vp, vocab);
  return cudaGetLastError();
}

template <typename T, int VEC>
static cudaError_t launch_bwd(const void* logits, const void* labels,
                              const void* lse, const void* g_nll,
                              const void* g_lse, void* dlogits, int N, int Vp,
                              int vocab, cudaStream_t stream) {
  const int per_block = kBwdThreads * kBwdIters * VEC;  // columns per block
  const dim3 grid((Vp + per_block - 1) / per_block, N < 65535 ? N : 65535);
  softmax_xent_bwd_kernel<T, VEC><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g_nll),
      static_cast<const float*>(g_lse), static_cast<T*>(dlogits), N, Vp,
      vocab);
  return cudaGetLastError();
}

// Rows start on 16-byte boundaries (checked by the wrapper).  N >= 1.
extern "C" int softmax_xent_fwd_launch(int dtype, const void* logits,
                                       const void* labels, void* nll,
                                       void* lse, int N, int Vp, int vocab,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_fwd<float, 4>(logits, labels, nll, lse, N, Vp, vocab, s);
  if (dtype == kBFloat16)
    return launch_fwd<__nv_bfloat16, 8>(logits, labels, nll, lse, N, Vp, vocab,
                                        s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int softmax_xent_bwd_launch(int dtype, const void* logits,
                                       const void* labels, const void* lse,
                                       const void* g_nll, const void* g_lse,
                                       void* dlogits, int N, int Vp, int vocab,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_bwd<float, 4>(logits, labels, lse, g_nll, g_lse, dlogits, N,
                                Vp, vocab, s);
  if (dtype == kBFloat16)
    return launch_bwd<__nv_bfloat16, 8>(logits, labels, lse, g_nll, g_lse,
                                        dlogits, N, Vp, vocab, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
