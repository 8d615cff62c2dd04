// K6, the Mamba2 SSD chunked scan for Hopper (sm_90a): y_t = c_t . h_t with
// h_t = exp(da_t) h_{t-1} + x_t (x) b_t, a (P, N) fp32 state per (batch,
// head) row, B and C shared by the H heads of a batch row.  Two modes,
// chosen by dtype: bf16 on the tensor cores (mma.sync), fp32 on the CUDA
// cores.
//
// Replaces the TPU kernel `ssd_scan_bhsd` (src/repro/kernels/
// mamba2_ssd.py).  The Python wrapper, its launch plan and the plain
// PyTorch version live in src/repro_torch/kernels/mamba2_ssd.py.
//
// Layouts.  Both modes read x (B, S, H, P) and da (B, S, H) and write y
// (B, S, H, P) through element strides (the last dim of x and y
// contiguous), and b, c (B, S, N) through (batch, step) strides.  The
// model's own tensors go in as they are, with no permute or copy before or
// after; the public (B*H, S, P) layout reaches the same entry as views.
// da is fp32 (dt * A <= 0); x is pre-scaled by dt.
//
// The function per tile.  A block walks its row's sequence in tiles of
// kT = 64 steps, in order.  With cs the inclusive cumsum of da inside the
// tile, the tile's outputs and the state it leaves are
//   G = (C B^T) o L,  L[i][j] = exp(cs_i - cs_j) for j <= i, else 0;
//   Y = G X + diag(exp(cs)) C S^T;
//   S <- S exp(cs_end) + (X o w)^T B,  w_j = exp(cs_end - cs_j).
// Every exponent is <= 0 (da <= 0), so the tile length is free: a 64-step
// tile computes the same function as the TPU kernel's `chunk`-step blocks
// (256 for zamba2).  The TPU kernel asserts S % chunk == 0; here the
// ragged tail is masked: steps past S load da = 0 and x = b = c = 0 (no
// decay, no state update) and write nothing, as the models' padded chunked
// form does.
//
// What bounds it.  At zamba2-1.2b's eval shape (B = 4, H = 64, S = 2048,
// P = N = 64) the scan must read x (67.1 MB), da (2.1 MB), B and C (1.0 MB
// each) and write y (67.1 MB): 138,412,032 bytes, 0.0413 ms at 3.35 TB/s.
// The tile's products (C B^T and G X below the diagonal, C S^T and the
// state update in full) are ~0.79 M multiply-adds a tile, 6.5 G over 32
// tiles and 256 rows: 13 GFLOP, 13 us at 989 TFLOP/s.  So the card's bound
// is bytes.  The first version of this kernel did these products in fp32
// on the CUDA cores with both operands of every FMA read from shared
// memory (~52 GB of shared-memory reads at this shape, 2.32 ms).  Here
// every ldmatrix feeds a whole mma fragment, and what sets the pace is the
// chain of one row's 32 tiles (see "Grid").
//
// bf16 mode (ssd_scan_mma_kernel).  P and N are padded to kD = 64 with
// zeros in shared memory (the padded columns are zeroed once and never
// loaded), so one instantiation takes every P, N in 8..64 that is a
// multiple of 8 (the 16-byte rule of the loads).  A block is 4 warps, one
// row of the grid (B*H blocks).
//   - Tile ring: x, B, C (64 x 64 bf16, 8 KB each) and da (64 fp32) of a
//     tile are a stage, 24,832 B; kStages = 3 stages are in flight, loaded
//     by cp.async (16 bytes a thread for x, B, C, 4 for da, zero-filled
//     past S) two tiles ahead of the one being computed, so each tile's
//     loads land under the two tiles before it.  Rows of 128 bytes with
//     the 16-byte chunks XOR-swizzled by the row (chunk ^ row % 8): neither
//     the cp.async writes nor the ldmatrix reads conflict.  One block
//     barrier a tile: it publishes the tile's stage and the state written
//     by the previous tile, and frees the stage the next load overwrites.
//   - The cumsum: each warp scans the tile's 64 da itself (two a lane,
//     five shuffles), in log2 units, so no barrier waits on it; every
//     exp(cs_i - cs_j) the warp needs comes from two shuffles.
//   - Products on the tensor cores, mma.sync.m16n8k16 (bf16 in, fp32
//     accumulators), operands by ldmatrix (.trans where the stored matrix
//     is K x N or K x M).  Warp w owns the tile's rows i in [16w, 16w+16):
//     Z = C S^T for its rows (scaled by e^cs in fp32), then its strip of G
//     (only the column blocks j <= 16w + 15; the diagonal block masked in
//     registers) whose accumulators become the A fragments of Y += G X in
//     registers, as flash attention's P does; y is stored from the
//     fragments.
//   - The state lives in registers, as fp32 accumulator fragments: warp w
//     owns rows p in [16w, 16w+16), 32 floats a thread.  The update scales
//     them by exp(cs_end) and accumulates (X o w)^T B onto them; X o w is
//     formed in registers from X's ldmatrix fragments.  The state leaves
//     registers once a tile, as the B operand of the next tile's C S^T,
//     into one of two shared buffers (double buffering: the tile that
//     reads one buffer never waits for the writes to the other).
//   - Grid: 256 rows at zamba2's shape; a block takes 3 x 24,832 + 2 x
//     8,192 (the state's two buffers) = 90,880 B of shared memory and 159
//     registers a thread, so 2 blocks fit an SM (228 KB, 1 KB reserved a
//     block) and the 256 blocks run in one wave on 132 SMs.  Each block
//     carries its row's 32 tiles in order, and that chain sets the pace:
//     on the card (tools/k6_variants.py, PERF.md) a ring of two stages,
//     whose 66,048 B let 3 blocks share an SM, runs the 256 rows on 86 SMs
//     no slower; dropping the stores or the loads past the first tiles
//     saves under a tenth each; and the mma count of the warp with the
//     most column blocks of G (warp 3) moves the time, not the total.  A
//     split of S into segments (a pass for each segment's end state, then
//     the outputs) would run more chains at once; it needs more blocks an
//     SM than this one's shared memory allows to gain (see PERF.md).
//
// Precision.  The plain version (and the TPU kernel) keeps every
// intermediate in fp32.  Three fp32 values are operands of tensor-core
// products here and are rounded to the nearest bf16: G (C B^T o L, the A
// operand of G X), the state S (the B operand of C S^T), and X o w (the A
// operand of the state update).  C, B and X are bf16 inputs and go in
// exactly; exp(cs_i) scales the fp32 accumulators of C S^T, not C.
// `ssd_scan_mma_emu` is the plain emulation of these rounding points.  At
// zamba2's shape and input distribution they move y by up to ~9e-3 before
// its own rounding (6.4e-3 to 9.1e-3 over the seeds tried on an H100).
// The tests hold the emulation within 1e-2 of the plain version, and on
// the card the kernel's y equal to the emulation's rounded to bf16 in at
// least 99.9% of the elements (99.97% measured; the rest are roundings
// that the kernel's fp32 arithmetic, in another order, flips).  An
// emulation with one rounding point more or fewer matches in at most 92%
// (tools/k6_rounding.py).  Against the 2e-2 gate that is enough: two bf16
// outputs more than one unit apart at |y| < 4 (a unit is 1.56e-2 in [2,
// 4)) need a deviation of ~1.56e-2, and the card tests hold |ref| < 4.
// Each operand could instead go in as two bf16 terms (hi truncated + lo
// rounded, 16 bits), as K2's P does: that takes the deviation to ~2e-5,
// but each second term is an extra mma on the chain that sets the pace,
// measured 7-27% slower (PERF.md), so none is taken.
//
// fp32 mode (ssd_scan_fp32_kernel).  The first version of this kernel, on
// the CUDA cores, kept for fp32 inputs: the tensor cores' fp32 path is
// TF32 (about three digits), which would break the fp32 gates (1e-4
// absolute for the kernel, 1e-3 relative for the full-width fp32 forward).
// One block per row walks 64-step tiles with the state in shared memory;
// it reads the same strided layouts.  Dispatch by dtype is not a fallback:
// both modes are hand kernels and raise on failure.
#include <cstdint>

#include "common.cuh"
#include "ptx.cuh"

typedef __nv_bfloat16 bf16;

struct SsdStrides {  // element strides
  long long xb, xs, xh;   // x (batch, step, head)
  long long db, ds, dh;   // da
  long long bb, bs;       // b (batch, step)
  long long cb, cs;       // c
  long long yb, ys, yh;   // y
};

constexpr int kT = 64;    // steps a tile, both modes

// ------------------------------------------------------------ fp32 mode ----

constexpr int kThreads = 256;

__global__ void ssd_scan_fp32_kernel(const float* __restrict__ x,
                                     const float* __restrict__ da,
                                     const float* __restrict__ b,
                                     const float* __restrict__ c,
                                     float* __restrict__ y, SsdStrides st,
                                     int H, int S, int P, int N) {
  extern __shared__ float smem[];
  const int Nb = N + 1;
  float* sts = smem;             // P x Nb state
  float* x_s = sts + P * Nb;     // kT x P
  float* b_s = x_s + kT * P;     // kT x Nb
  float* c_s = b_s + kT * Nb;    // kT x N
  float* g_s = c_s + kT * N;     // kT x kT decayed scores
  float* cs = g_s + kT * kT;     // kT inclusive cumsum of da
  float* w_s = cs + kT;          // kT decay from each step to the tile end

  const int bi = blockIdx.x / H, hi = blockIdx.x - bi * H;
  const float* xr = x + bi * st.xb + hi * st.xh;
  const float* dr = da + bi * st.db + hi * st.dh;
  const float* br = b + bi * st.bb;
  const float* cr = c + bi * st.cb;
  float* yr = y + bi * st.yb + hi * st.yh;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < P * Nb; i += nt) sts[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int len = min(kT, S - t0);
    for (int i = tid; i < kT * P; i += nt) {
      const int r = i / P, p = i - r * P;
      x_s[i] = r < len ? xr[(t0 + r) * st.xs + p] : 0.f;
    }
    for (int i = tid; i < kT * N; i += nt) {
      const int r = i / N, n = i - r * N;
      const bool in = r < len;
      b_s[r * Nb + n] = in ? br[(t0 + r) * st.bs + n] : 0.f;
      c_s[i] = in ? cr[(t0 + r) * st.cs + n] : 0.f;
    }
    if (tid < 32) {              // inclusive scan, two steps per lane
      const int i0 = 2 * tid, i1 = 2 * tid + 1;
      const float a0 = i0 < len ? dr[(t0 + i0) * st.ds] : 0.f;
      const float a1 = i1 < len ? dr[(t0 + i1) * st.ds] : 0.f;
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
    const float cs_end = cs[kT - 1];
    if (tid < kT) w_s[tid] = expf(cs_end - cs[tid]);
    for (int e = tid; e < kT * kT; e += nt) {
      const int i = e / kT, j = e - i * kT;
      float g = 0.f;
      if (j <= i)
        g = strided_dot(c_s + i * N, 1, b_s + j * Nb, 1, N) *
            expf(cs[i] - cs[j]);
      g_s[e] = g;
    }
    __syncthreads();
    for (int e = tid; e < len * P; e += nt) {
      const int i = e / P, p = e - i * P;
      const float intra = strided_dot(g_s + i * kT, 1, x_s + p, P, i + 1);
      const float inter = strided_dot(c_s + i * N, 1, sts + p * Nb, 1, N);
      yr[(t0 + i) * st.ys + p] = intra + expf(cs[i]) * inter;
    }
    for (int e = tid; e < kT * N; e += nt) {   // B * decay to the tile end
      const int r = e / N;
      b_s[r * Nb + e - r * N] *= w_s[r];
    }
    __syncthreads();             // the outputs read the state
    const float dec = expf(cs_end);
    for (int e = tid; e < P * N; e += nt) {
      const int p = e / N, n = e - p * N;
      sts[p * Nb + n] = sts[p * Nb + n] * dec +
                        strided_dot(x_s + p, P, b_s + n, Nb, len);
    }
    __syncthreads();             // the next tile overwrites x, b, c, cs
  }
}

static size_t fp32_smem_bytes(int P, int N) {
  return sizeof(float) * (static_cast<size_t>(P) * (N + 1) + kT * P +
                          kT * (N + 1) + kT * N + kT * kT + 2 * kT);
}

// ------------------------------------------------------------ bf16 mode ----

constexpr int kD = 64;                    // P and N padded to this
constexpr int kWarps = 4;                 // a 16-row strip of the tile each
constexpr int kTC = 32 * kWarps;
constexpr int kStages = 3;                // tiles in flight
constexpr int kMat = kT * kD * 2;         // one 64 x 64 bf16 matrix, bytes
constexpr int kStageBytes = 3 * kMat + kT * 4;   // x, B, C, da
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kMmaSmem = kRingBytes + 2 * kMat;   // + the state, twice
constexpr float kLog2e = 1.4426950408889634f;

// Byte offset of the 16-byte chunk `chunk` (8 bf16) of row `r` in a
// 64 x 64 bf16 matrix of 128-byte rows: the chunk index XOR the row's low
// three bits, so 8 consecutive rows at one logical chunk hit 8 different
// bank groups.
__device__ __forceinline__ uint32_t swz(int r, int chunk) {
  return static_cast<uint32_t>(r * 128 + ((chunk ^ (r & 7)) << 4));
}

// Tile `tile` of the row into ring stage `stage`: x rows t0.. of P/8 chunks,
// B and C rows of N/8 chunks, da; rows past S are zero-filled (source size
// 0, nothing read).
__device__ __forceinline__ void load_tile(uint32_t stage, const bf16* xr,
                                          const float* dr, const bf16* br,
                                          const bf16* cr,
                                          const SsdStrides& st, int tile,
                                          int S, int P, int N, int tid) {
  const int t0 = tile * kT;
  const int xc = P >> 3, bc = N >> 3;
#pragma unroll
  for (int it = 0; it < kT * 8 / kTC; ++it) {
    const int i = tid + it * kTC, r = i >> 3, k = i & 7;
    const bool in = t0 + r < S;
    const int t = in ? t0 + r : 0;
    const int bytes = in ? 16 : 0;
    const uint32_t off = swz(r, k);
    if (k < xc) cp_async16(stage + off, xr + t * st.xs + k * 8, bytes);
    if (k < bc) {
      cp_async16(stage + kMat + off, br + t * st.bs + k * 8, bytes);
      cp_async16(stage + 2 * kMat + off, cr + t * st.cs + k * 8, bytes);
    }
  }
  if (tid < kT) {
    const bool in = t0 + tid < S;
    cp_async4(stage + 3 * kMat + 4 * tid, dr + (in ? t0 + tid : 0) * st.ds,
              in ? 4 : 0);
  }
}

// One warp's share of tile t: rows i in [16 strip, +16) of y and rows p in
// [16 strip, +16) of the state.
__device__ __forceinline__ void tile_step(int strip, float (&sacc)[8][4],
                                          uint32_t xs, uint32_t bs,
                                          uint32_t cs, const float* das,
                                          uint32_t s_rd,
                                          unsigned char* s_wr, bf16* yr,
                                          long long ys, int t0, int S, int P,
                                          int lane) {
  const int g = lane >> 2, q4 = lane & 3;
  const int i0 = 16 * strip + g, i1 = i0 + 8;   // this thread's rows

  // cumsum of da in log2 units: lane l holds steps 2l and 2l + 1
  float c0, c1;
  {
    const float a0 = das[2 * lane], a1 = das[2 * lane + 1];
    float incl = a0 + a1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    c1 = incl * kLog2e;
    c0 = (incl - a1) * kLog2e;
  }
  const float c_end = __shfl_sync(0xffffffffu, c1, 31);
  float cr0, cr1;   // cs of rows i0, i1
  {
    const float u0 = __shfl_sync(0xffffffffu, c0, i0 >> 1);
    const float u1 = __shfl_sync(0xffffffffu, c1, i0 >> 1);
    const float v0 = __shfl_sync(0xffffffffu, c0, i1 >> 1);
    const float v1 = __shfl_sync(0xffffffffu, c1, i1 >> 1);
    cr0 = (i0 & 1) ? u1 : u0;
    cr1 = (i1 & 1) ? v1 : v0;
  }

  // C strip as A fragments, k = state column n
  uint32_t ca[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm4(cs + swz(16 * strip + (lane & 15), 2 * ks + (lane >> 4)), ca[ks]);

  // Z = C S^T (the state before this tile; zero at the first), rows scaled
  // by e^cs: the start of Y
  float yacc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t a = s_rd + swz(16 * q + (lane & 7) + ((lane >> 4) << 3),
                                    2 * ks + ((lane >> 3) & 1));
      uint32_t r[4];
      ldsm4(a, r);
      mma(yacc[2 * q], ca[ks], r[0], r[1]);
      mma(yacc[2 * q + 1], ca[ks], r[2], r[3]);
    }
  {
    const float e0 = exp2f(cr0), e1 = exp2f(cr1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      yacc[nt][0] *= e0;
      yacc[nt][1] *= e0;
      yacc[nt][2] *= e1;
      yacc[nt][3] *= e1;
    }
  }

  // G = (C B^T) o L for the column blocks q <= strip (the rest is 0),
  // masked and decayed in registers, then Y += G X with G's accumulators as
  // the A fragments
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q > strip) continue;
    float gacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t r[4];
      ldsm4(bs + swz(16 * q + (lane & 7) + ((lane >> 4) << 3),
                     2 * ks + ((lane >> 3) & 1)), r);
      mma(gacc[0], ca[ks], r[0], r[1]);
      mma(gacc[1], ca[ks], r[2], r[3]);
    }
    uint32_t ga[4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = 16 * q + 8 * hf + 2 * q4;   // columns j, j + 1
      const float cj0 = __shfl_sync(0xffffffffu, c0, j >> 1);
      const float cj1 = __shfl_sync(0xffffffffu, c1, j >> 1);
      const float e00 = j <= i0 ? gacc[hf][0] * exp2f(cr0 - cj0) : 0.f;
      const float e01 =
          j + 1 <= i0 ? gacc[hf][1] * exp2f(cr0 - cj1) : 0.f;
      const float e10 = j <= i1 ? gacc[hf][2] * exp2f(cr1 - cj0) : 0.f;
      const float e11 =
          j + 1 <= i1 ? gacc[hf][3] * exp2f(cr1 - cj1) : 0.f;
      ga[2 * hf] = round_bf16(e00, e01);
      ga[2 * hf + 1] = round_bf16(e10, e11);
    }
#pragma unroll
    for (int q2 = 0; q2 < 4; ++q2) {
      uint32_t r[4];
      ldsm4_t(xs + swz(16 * q + (lane & 7) + ((lane >> 3) & 1) * 8,
                       2 * q2 + (lane >> 4)), r);
      mma(yacc[2 * q2], ga, r[0], r[1]);
      mma(yacc[2 * q2 + 1], ga, r[2], r[3]);
    }
  }

  // y rows t0 + i0 and t0 + i1, from the fragments
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = t0 + (hf ? i1 : i0);
    if (row < S) {
      bf16* yp = yr + row * ys + 2 * q4;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        if (8 * nt + 2 * q4 < P)
          *reinterpret_cast<__nv_bfloat162*>(yp + 8 * nt) =
              __floats2bfloat162_rn(yacc[nt][2 * hf], yacc[nt][2 * hf + 1]);
    }
  }

  // S <- S e^{cs_end} + (X o w)^T B for state rows p in [16 strip, +16)
  const float dec = exp2f(c_end);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[nt][e] *= dec;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t xa[4];
    ldsm4_t(xs + swz(16 * ks + (lane & 7) + ((lane >> 4) << 3),
                     2 * strip + ((lane >> 3) & 1)), xa);
    // steps j = 16 ks + 2 q4 (+1) in xa[0], xa[1]; + 8 in xa[2], xa[3]
    const int pa = 8 * ks + q4;
    const float wa0 = exp2f(c_end - __shfl_sync(0xffffffffu, c0, pa));
    const float wa1 = exp2f(c_end - __shfl_sync(0xffffffffu, c1, pa));
    const float wb0 = exp2f(c_end - __shfl_sync(0xffffffffu, c0, pa + 4));
    const float wb1 = exp2f(c_end - __shfl_sync(0xffffffffu, c1, pa + 4));
    uint32_t xw[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = unpack_bf16(xa[e]);
      xw[e] = round_bf16(v.x * (e < 2 ? wa0 : wb0), v.y * (e < 2 ? wa1 : wb1));
    }
#pragma unroll
    for (int q2 = 0; q2 < 4; ++q2) {
      uint32_t r[4];
      ldsm4_t(bs + swz(16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8,
                       2 * q2 + (lane >> 4)), r);
      mma(sacc[2 * q2], xw, r[0], r[1]);
      mma(sacc[2 * q2 + 1], xw, r[2], r[3]);
    }
  }

  // the state, rounded to bf16, for the next tile's C S^T
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = hf ? i1 : i0;   // state row 16 strip + g (+8)
      *reinterpret_cast<uint32_t*>(s_wr + swz(p, nt) + 4 * q4) =
          round_bf16(sacc[nt][2 * hf], sacc[nt][2 * hf + 1]);
    }
}

__global__ void __launch_bounds__(kTC, 2)
    ssd_scan_mma_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ da,
                        const bf16* __restrict__ b,
                        const bf16* __restrict__ c, bf16* __restrict__ y,
                        SsdStrides st, int H, int S, int P, int N) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  const int bi = blockIdx.x / H, hi = blockIdx.x - bi * H;
  const bf16* xr = x + bi * st.xb + hi * st.xh;
  const float* dr = da + bi * st.db + hi * st.dh;
  const bf16* br = b + bi * st.bb;
  const bf16* cr = c + bi * st.cb;
  bf16* yr = y + bi * st.yb + hi * st.yh;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // warp-uniform
  const uint32_t base = smem_u32(smem);

  // Zero the ring (its padded columns are never loaded) and the state.
  for (int i = tid; i < kMmaSmem / 16; i += kTC)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int n_tiles = (S + kT - 1) / kT;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_tile(base + s * kStageBytes, xr, dr, br, cr, st, s, S, P, N, tid);
    cp_async_commit();
  }

  // the state: rows 16 warp + g (+8), columns 8 nt + 2 q4 (+1)
  float sacc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile t
    __syncthreads();                // everyone's; tile t - 1 is done
    if (t + kStages - 1 < n_tiles)
      load_tile(base + ((t + kStages - 1) % kStages) * kStageBytes, xr, dr,
                br, cr, st, t + kStages - 1, S, P, N, tid);
    cp_async_commit();

    const int off = (t % kStages) * kStageBytes;
    const uint32_t xs = base + off, bs = xs + kMat, cs = bs + kMat;
    const float* das = reinterpret_cast<const float*>(smem + off + 3 * kMat);
    const uint32_t s_rd = base + kRingBytes + (t & 1) * kMat;
    unsigned char* s_wr = smem + kRingBytes + ((t + 1) & 1) * kMat;
    tile_step(warp, sacc, xs, bs, cs, das, s_rd, s_wr, yr, st.ys, t * kT, S,
              P, lane);
  }
  cp_async_wait<0>();
}

// ----------------------------------------------------------------- entry ----

extern "C" int mamba2_ssd_smem_bytes(int dtype, int P, int N) {
  return dtype == kBFloat16 ? kMmaSmem
                            : static_cast<int>(fp32_smem_bytes(P, N));
}

// Blocks of the bf16 mode that one SM holds at once (the occupancy API, after
// the launch's shared-memory attributes are set: call after a launch).
extern "C" int mamba2_ssd_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_scan_mma_kernel,
                                                    kTC, kMmaSmem) !=
      cudaSuccess)
    return -1;
  return n;
}

extern "C" int mamba2_ssd_launch(int dtype, const void* x, const void* da,
                                 const void* b, const void* c, void* y, int B,
                                 int H, int S, int P, int N,
                                 const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SsdStrides st{strides[0], strides[1],  strides[2],  strides[3],
                      strides[4], strides[5],  strides[6],  strides[7],
                      strides[8], strides[9],  strides[10], strides[11],
                      strides[12]};
  const int grid = B * H;
  if (dtype == kBFloat16) {
    if (P > kD || N > kD || P % 8 || N % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    static size_t granted = 0;
    cudaError_t err = allow_smem(ssd_scan_mma_kernel, kMmaSmem, &granted);
    if (err != cudaSuccess) return err;
    ssd_scan_mma_kernel<<<grid, kTC, kMmaSmem, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(da),
        static_cast<const bf16*>(b), static_cast<const bf16*>(c),
        static_cast<bf16*>(y), st, H, S, P, N);
    return cudaGetLastError();
  }
  if (dtype == kFloat32) {
    const size_t smem = fp32_smem_bytes(P, N);
    static size_t granted = 0;
    cudaError_t err = allow_smem(ssd_scan_fp32_kernel, smem, &granted);
    if (err != cudaSuccess) return err;
    ssd_scan_fp32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(da),
        static_cast<const float*>(b), static_cast<const float*>(c),
        static_cast<float*>(y), st, H, S, P, N);
    return cudaGetLastError();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
