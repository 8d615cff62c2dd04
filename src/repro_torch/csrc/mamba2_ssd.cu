// Mamba2 SSD chunked scan for Hopper (sm_90a): y_t = c_t . h_t with
// h_t = exp(da_t) h_{t-1} + x_t (x) b_t, the (P, N) state kept in fp32.
//
// Replaces the TPU kernel `ssd_scan_bhsd` (src/repro/kernels/mamba2_ssd.py).
// The Python wrapper and the plain PyTorch version live in
// src/repro_torch/kernels/mamba2_ssd.py.
//
// Layouts: x (BH, S, P) pre-scaled by dt; da (BH, S) fp32 = dt * A <= 0;
// b, c (B, S, N) shared by the H heads of batch row bh / H; y like x.
//
// Design.  One block per (batch, head) row walks the sequence in tiles of
// kL = 64 steps, in order, with the state in shared memory (rows padded to
// N + 1 floats so a warp reading one column of 32 rows hits 32 banks).  Per
// tile: the inclusive cumsum cs of da (one warp, a shuffle scan); the
// intra-tile scores (C B^T) * exp(cs_i - cs_j) for j <= i; the outputs
// scores @ X + exp(cs_i) * C @ state^T; then the state update
// state * exp(cs_end) + X^T (B * exp(cs_end - cs)).  Every exponent is <= 0
// (da <= 0), so the tile length is free: a 64-step tile computes the same
// function as the TPU kernel's `chunk`-step blocks (256 for zamba2, whose
// 256 x 256 fp32 score tile would not fit in shared memory).  The TPU kernel
// asserts S % chunk == 0; here the ragged tail is masked: steps past S load
// da = 0 and x = b = c = 0 (no decay, no state update) and write nothing,
// as the models' padded chunked form does.
//
// What bounds it.  At zamba2's eval shape (BH = 4 x 64, S = 2048,
// P = N = 64) the scan moves ~138 MB (bytes bound 0.041 ms at 3.35 TB/s);
// the naive recurrence does 10.7 GFLOP, this kernel ~13 (C B^T is
// recomputed for each of the H heads that share B and C).  This first version computes on the CUDA cores in
// fp32, reading both operands of every product from shared memory, so it is
// bound by shared-memory bandwidth, far from either card bound.  Sharing
// C B^T across heads and wgmma tiles fed by TMA are the later fixes.
#include "common.cuh"

constexpr int kL = 64;         // steps per tile
constexpr int kThreads = 256;

template <typename T>
__global__ void ssd_scan_kernel(const T* __restrict__ x,
                                const float* __restrict__ da,
                                const T* __restrict__ b,
                                const T* __restrict__ c, T* __restrict__ y,
                                int H, int S, int P, int N) {
  extern __shared__ float smem[];
  const int Nb = N + 1;
  float* st = smem;              // P x Nb state
  float* x_s = st + P * Nb;      // kL x P
  float* b_s = x_s + kL * P;     // kL x Nb
  float* c_s = b_s + kL * Nb;    // kL x N
  float* g_s = c_s + kL * N;     // kL x kL decayed scores
  float* cs = g_s + kL * kL;     // kL inclusive cumsum of da
  float* w_s = cs + kL;          // kL decay from each step to the tile end

  const int row = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t xbase = static_cast<size_t>(row) * S * P;
  const size_t bbase = static_cast<size_t>(row / H) * S * N;
  const float* da_r = da + static_cast<size_t>(row) * S;

  for (int i = tid; i < P * Nb; i += nt) st[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kL) {
    const int len = min(kL, S - t0);
    for (int i = tid; i < kL * P; i += nt)
      x_s[i] = i / P < len ? to_f32(x[xbase + static_cast<size_t>(t0) * P + i])
                           : 0.f;
    for (int i = tid; i < kL * N; i += nt) {
      const int r = i / N, n = i - r * N;
      const bool in = r < len;
      const size_t off = bbase + static_cast<size_t>(t0) * N + i;
      b_s[r * Nb + n] = in ? to_f32(b[off]) : 0.f;
      c_s[i] = in ? to_f32(c[off]) : 0.f;
    }
    if (tid < 32) {              // inclusive scan, two steps per lane
      const int i0 = 2 * tid, i1 = 2 * tid + 1;
      const float a0 = i0 < len ? da_r[t0 + i0] : 0.f;
      const float a1 = i1 < len ? da_r[t0 + i1] : 0.f;
      const float pair = a0 + a1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      cs[i0] = incl - pair + a0;
      cs[i1] = incl;
    }
    __syncthreads();
    const float cs_end = cs[kL - 1];
    if (tid < kL) w_s[tid] = expf(cs_end - cs[tid]);
    for (int e = tid; e < kL * kL; e += nt) {
      const int i = e / kL, j = e - i * kL;
      float g = 0.f;
      if (j <= i)
        g = strided_dot(c_s + i * N, 1, b_s + j * Nb, 1, N) *
            expf(cs[i] - cs[j]);
      g_s[e] = g;
    }
    __syncthreads();
    for (int e = tid; e < len * P; e += nt) {
      const int i = e / P, p = e - i * P;
      const float intra = strided_dot(g_s + i * kL, 1, x_s + p, P, i + 1);
      const float inter = strided_dot(c_s + i * N, 1, st + p * Nb, 1, N);
      y[xbase + static_cast<size_t>(t0 + i) * P + p] =
          from_f32<T>(intra + expf(cs[i]) * inter);
    }
    for (int e = tid; e < kL * N; e += nt) {   // B * decay to the tile end
      const int r = e / N;
      b_s[r * Nb + e - r * N] *= w_s[r];
    }
    __syncthreads();             // the outputs read the state
    const float dec = expf(cs_end);
    for (int e = tid; e < P * N; e += nt) {
      const int p = e / N, n = e - p * N;
      st[p * Nb + n] = st[p * Nb + n] * dec +
                       strided_dot(x_s + p, P, b_s + n, Nb, len);
    }
    __syncthreads();             // the next tile overwrites x, b, c, cs
  }
}

static size_t smem_bytes(int P, int N) {
  return sizeof(float) * (static_cast<size_t>(P) * (N + 1) + kL * P +
                          kL * (N + 1) + kL * N + kL * kL + 2 * kL);
}

template <typename T>
static cudaError_t launch(const void* x, const void* da, const void* b,
                          const void* c, void* y, int BH, int H, int S, int P,
                          int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  static size_t granted = 0;  // one per T
  cudaError_t err = allow_smem(ssd_scan_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(da),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      H, S, P, N);
  return cudaGetLastError();
}

extern "C" int mamba2_ssd_launch(int dtype, const void* x, const void* da,
                                 const void* b, const void* c, void* y, int BH,
                                 int H, int S, int P, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, da, b, c, y, BH, H, S, P, N, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, da, b, c, y, BH, H, S, P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
