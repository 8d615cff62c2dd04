// RWKV6 WKV chunked recurrence for Hopper (sm_90a):
// o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// with the (K, V) state S kept in fp32 and lw = log w.
//
// Replaces the TPU kernel `wkv6_scan_bhsd` (src/repro/kernels/rwkv6_wkv.py).
// The Python wrapper and the plain PyTorch version live in
// src/repro_torch/kernels/rwkv6_wkv.py.
//
// Layouts: r, k (BH, S, K); v (BH, S, V); lw (BH, S, K) fp32 in
// [-2.5, 0]; u (H, K) fp32, row bh reads u[bh % H]; y like v.
//
// Design.  One block per (batch, head) row walks the sequence in chunks of
// Q <= 32 steps, in order, with the state in shared memory.  Per chunk, as
// the TPU kernel: per-channel inclusive and exclusive cumsums cs, ce of lw;
// the rank-1 split of the intra-chunk decay around the chunk midpoint
// M = cs_end / 2, exp(ce_i - cs_j) = exp(ce_i - M) * exp(M - cs_j), each
// factor clipped to [-40, 40]; the strictly lower scores
// A = (r * exp(ce - M)) (k * exp(M - cs))^T; the u-bonus diagonal
// sum(r * u * k); outputs A v + diag * v + (r * exp(ce)) S; then the state
// update S * exp(cs_end) + (k * exp(cs_end - cs))^T v.  The split is exact
// only because the model floors the per-step log decay at -2.5 and the chunk
// is at most 32 steps (32 * 2.5 / 2 = 40, inside the clip); the wrapper
// refuses a longer chunk.  Key rows are padded to K + 1 floats so a warp
// reading one channel of 32 rows hits 32 banks.  The TPU kernel asserts
// S % chunk == 0; here the ragged tail is masked: steps past S load lw = 0
// and r = k = v = 0 (no decay, no state update) and write nothing, as the
// model's padded chunked form does.
//
// What bounds it.  At rwkv6's eval shape (BH = 4 x 32, S = 2048,
// K = V = 64, bf16) the scan moves ~201 MB (bytes bound 0.060 ms at
// 3.35 TB/s) against 5.4 GFLOP of the naive recurrence, so the card bound
// is bytes.  This first
// version computes on the CUDA cores in fp32 with both operands of every
// product read from shared memory and one block per row (128 blocks on 132
// SMs, each walking 64 chunks in order), so it is bound by the latency of
// that walk, far from either card bound.  Splitting V across blocks and
// wgmma tiles are the later fixes.
#include "common.cuh"

constexpr int kQ = 32;         // the longest chunk the rank-1 split allows
constexpr int kThreads = 256;

template <typename T>
__global__ void wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ lw,
                            const float* __restrict__ u, T* __restrict__ y,
                            int H, int S, int K, int V, int Q) {
  extern __shared__ float smem[];
  const int Kp = K + 1;
  float* st = smem;              // K x V state
  float* r_s = st + K * V;       // Q x K: r, then r * exp(ce)
  float* k_s = r_s + kQ * K;     // Q x K: k, then k * exp(cs_end - cs)
  float* v_s = k_s + kQ * K;     // Q x V
  float* cs = v_s + kQ * V;      // Q x K: lw, then its inclusive cumsum
  float* ce = cs + kQ * K;       // Q x K exclusive cumsum
  float* qf = ce + kQ * K;       // Q x Kp: r * exp(clip(ce - M))
  float* kf = qf + kQ * Kp;      // Q x Kp: k * exp(clip(M - cs))
  float* a_s = kf + kQ * Kp;     // Q x Q strictly lower scores
  float* dg = a_s + kQ * kQ;     // Q u-bonus diagonal

  const int row = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const size_t kbase = static_cast<size_t>(row) * S * K;
  const size_t vbase = static_cast<size_t>(row) * S * V;
  const float* u_r = u + static_cast<size_t>(row % H) * K;

  for (int i = tid; i < K * V; i += nt) st[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int len = min(Q, S - t0);
    for (int i = tid; i < Q * K; i += nt) {
      const bool in = i / K < len;
      const size_t off = kbase + static_cast<size_t>(t0) * K + i;
      r_s[i] = in ? to_f32(r[off]) : 0.f;
      k_s[i] = in ? to_f32(k[off]) : 0.f;
      cs[i] = in ? lw[off] : 0.f;
    }
    for (int i = tid; i < Q * V; i += nt)
      v_s[i] = i / V < len
                   ? to_f32(v[vbase + static_cast<size_t>(t0) * V + i])
                   : 0.f;
    __syncthreads();
    for (int kk = tid; kk < K; kk += nt) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        const float l = cs[i * K + kk];
        run += l;
        cs[i * K + kk] = run;
        ce[i * K + kk] = run - l;
      }
    }
    for (int i = warp; i < Q; i += nw) {
      float s = 0.f;
      for (int kk = lane; kk < K; kk += 32)
        s += r_s[i * K + kk] * u_r[kk] * k_s[i * K + kk];
      s = warp_sum(s);
      if (lane == 0) dg[i] = s;
    }
    __syncthreads();
    for (int e = tid; e < Q * K; e += nt) {
      const int i = e / K, kk = e - i * K;
      const float c = cs[e], x = ce[e];
      const float last = cs[(Q - 1) * K + kk], mid = last * 0.5f;
      const float rv = r_s[e], kv = k_s[e];
      qf[i * Kp + kk] = rv * expf(fminf(fmaxf(x - mid, -40.f), 40.f));
      kf[i * Kp + kk] = kv * expf(fminf(fmaxf(mid - c, -40.f), 40.f));
      r_s[e] = rv * expf(x);
      k_s[e] = kv * expf(last - c);
    }
    __syncthreads();
    for (int e = tid; e < Q * Q; e += nt) {
      const int i = e / Q, j = e - i * Q;
      a_s[e] = j < i ? strided_dot(qf + i * Kp, 1, kf + j * Kp, 1, K) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < len * V; e += nt) {
      const int i = e / V, c = e - i * V;
      const float intra = strided_dot(a_s + i * Q, 1, v_s + c, V, i);
      const float inter = strided_dot(r_s + i * K, 1, st + c, V, K);
      y[vbase + static_cast<size_t>(t0 + i) * V + c] =
          from_f32<T>(intra + dg[i] * v_s[i * V + c] + inter);
    }
    __syncthreads();             // the outputs read the state
    for (int e = tid; e < K * V; e += nt) {
      const int kk = e / V, c = e - kk * V;
      st[e] = st[e] * expf(cs[(Q - 1) * K + kk]) +
              strided_dot(k_s + kk, K, v_s + c, V, len);
    }
    __syncthreads();             // the next chunk overwrites every buffer
  }
}

static size_t smem_bytes(int K, int V) {
  return sizeof(float) * (static_cast<size_t>(K) * V + 4 * kQ * K + kQ * V +
                          2 * kQ * (K + 1) + kQ * kQ + kQ);
}

template <typename T>
static cudaError_t launch(const void* r, const void* k, const void* v,
                          const void* lw, const void* u, void* y, int BH,
                          int H, int S, int K, int V, int Q,
                          cudaStream_t stream) {
  if (Q < 1 || Q > kQ) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, V);
  static size_t granted = 0;  // one per T
  cudaError_t err = allow_smem(wkv6_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  wkv6_kernel<T><<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<T*>(y), H, S, K, V, Q);
  return cudaGetLastError();
}

extern "C" int rwkv6_wkv_launch(int dtype, const void* r, const void* k,
                                const void* v, const void* lw, const void* u,
                                void* y, int BH, int H, int S, int K, int V,
                                int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(r, k, v, lw, u, y, BH, H, S, K, V, Q, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(r, k, v, lw, u, y, BH, H, S, K, V, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
