// K7, the RWKV6 WKV chunked recurrence for Hopper (sm_90a):
// o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// with a (K, V) fp32 state S per (batch, head) row and lw = log w.  Two
// modes, chosen by dtype: bf16 on the tensor cores (mma.sync), fp32 on the
// CUDA cores.
//
// Replaces the TPU kernel `wkv6_scan_bhsd` (src/repro/kernels/
// rwkv6_wkv.py).  The Python wrapper, its launch plan and the plain PyTorch
// version live in src/repro_torch/kernels/rwkv6_wkv.py.
//
// Layouts.  Both modes read r, k, lw (B, S, H, K) and v (B, S, H, V) and
// write y (B, S, H, V) through element strides (batch, step, head; the last
// dim contiguous): the model's own tensors go in as they are, with no
// permute or copy before or after; the public (B*H, S, K) layout reaches
// the same entry as views.  lw is fp32 in [-2.5, 0]; u (H, K) fp32, row
// (b, h) reads u[h].
//
// The function per chunk, as the TPU kernel: with cs, ce the inclusive and
// exclusive cumsums of lw inside the chunk and M = cs_end / 2, the rank-1
// split exp(ce_i - cs_j) = exp(ce_i - M) exp(M - cs_j), each factor clipped
// to [-40, 40];
//   A = (r e^(ce - M)) (k e^(M - cs))^T, strictly lower, plus the u-bonus
//       diagonal sum(r u k);
//   Y = A v + (r e^ce) S;   S <- diag(e^cs_end) S + (k e^(cs_end - cs))^T v.
// The split is exact only because the model floors the per-step log decay
// at -2.5 and a chunk is at most 32 steps (32 * 2.5 / 2 = 40, inside the
// clip); the wrapper refuses a longer chunk.  The TPU kernel asserts
// S % chunk == 0; here the ragged tail is masked: steps past S load lw = 0
// and r = k = v = 0 (no decay, no state update) and write nothing.
//
// What bounds it.  At rwkv6-1.6b's eval shape (B = 4, H = 32, S = 2048,
// K = V = 64, bf16) the scan must read r, k, v (33.6 MB each) and lw
// (67.1 MB, fp32) and write y (33.6 MB): 201.3 MB, 0.060 ms at 3.35 TB/s,
// against 5.4 GFLOP of the naive recurrence (5 ms at 989 TFLOP/s); so the
// card's bound is bytes.  The first version of this kernel ran one block
// per row (128 blocks on 132 SMs) with every product on the CUDA cores and
// both operands from shared memory, loads not overlapped: 2.0 ms.
//
// bf16 mode (wkv6_mma_kernel<KP, NC>).  K is padded to KP = 64 or 128 with
// zeros in shared memory (the padded columns are zeroed once and never
// loaded), so K and V are multiples of 8 up to 128 (the 16-byte rule of the
// loads).  The kernel walks 32-step tiles whatever chunk (<= 32) it is
// given: every factor stays inside the clip at the -2.5 floor, so the tile
// length does not change the function.
//   - The state split over V.  Column c of S evolves from r, k, lw and
//     v[:, c] alone, so a block owns VS = 16 NC columns of one row's state
//     and the row's ceil(V / VS) blocks run side by side (block index =
//     row * slices + slice: a row's blocks are neighbours and read its r, k
//     and lw mostly from L2).  The host picks VS from shapes alone.
//   - Warps.  Four prep warps compute, for tile t + 1, the cumsums (each
//     thread scans 8 or 16 steps of two channels, then a shuffle scan
//     across the warp's segments), the factors and the scores A on the
//     tensor cores, while NC chain warps run tile t's chain: the two
//     products that depend on the previous tile.  One block barrier a tile
//     publishes the prep warps' buffers (double buffered) and frees a ring
//     stage; the prep warps meet once more among themselves before A.
//   - Tile ring.  r, k (32 x KP bf16), lw (32 x KP fp32) and the block's v
//     slice (32 x VS bf16) of a tile are a stage; kStages = 3 stages, loaded
//     by the prep warps with cp.async 16 bytes at a time (zero-filled past
//     S) two tiles ahead of the chain, one tile ahead of the prep.  Rows
//     are XOR-swizzled by 16-byte chunk (swz below): neither the cp.async
//     writes, the prep warps' pair accesses nor the ldmatrix reads conflict.
//   - The state lives in registers, transposed: chain warp w holds S^T for
//     its 16 columns (16 x KP) as fp32 mma accumulator fragments, which are
//     also the A fragments of the next product, Y^T = S^T (r e^ce)^T, once
//     rounded to bf16 (as flash attention's P).  Y^T += v^T A^T takes v^T
//     by ldmatrix.trans and A from shared memory; the state update scales
//     the accumulators by e^cs_end per channel and accumulates
//     v^T (k e^(cs_end - cs)) onto them.  Y^T is stored from the fragments.
//   - Exponentials: e^(ce - M) and e^(M - cs) per element (one MUFU.EX2
//     each, in log2 units), e^M per channel; r e^ce = (r e^(ce - M)) e^M and
//     k e^(cs_end - cs) = (k e^(M - cs)) e^M, e^cs_end = (e^M)^2, which is
//     exact in real arithmetic because at the -2.5 floor the clip never
//     binds (see above).
//   - Grid and pace.  At rwkv6's shape VS = 32: 256 blocks of 6 warps, each
//     84,992 B of shared memory and 128 registers a thread, so 2 blocks
//     fit an SM and all run at once on 132 SMs (16-column slices, 512
//     blocks, ran 0.278 ms against 0.144).  Measured with
//     tools/k7_compare.py (PERF.md): 0.116 ms.  With exp2f (0.144 ms) the
//     same kernel with the chain warps idle ran 0.138 ms, with the prep
//     warps idle 0.090, with both idle (the loads and barriers alone)
//     0.070: the prep warps' elementwise work sets the pace, which the
//     single-instruction 2^x cut by a fifth.  Eight prep warps, or a fourth
//     ring stage, did not help.
//
// Precision.  The plain version (and the TPU kernel) keeps every
// intermediate in fp32.  Six fp32 values are operands of tensor-core
// products here and are rounded to the nearest bf16: qf = r e^(ce - M) and
// kf = k e^(M - cs) (the operands of A), A itself (masked, with the
// u-bonus diagonal; the operand of A v), r e^ce and the state S (the
// operands of (r e^ce) S), and k e^(cs_end - cs) (the operand of the state
// update).  r, k and v are bf16 inputs and go in exactly.
// `wkv6_scan_mma_emu` is the plain emulation of these rounding points and
// of the 32-step tile walk; the tests hold it within 1e-2 of the all-fp32
// plain version, and on the card the kernel's y equal to the emulation's
// rounded to bf16 in at least 99.9% of the elements.
//
// fp32 mode (wkv6_fp32_kernel).  The first version of this kernel, on the
// CUDA cores, kept for fp32 inputs (the tensor cores' fp32 path is TF32,
// about three digits, which would break the fp32 gates), with the state
// split over V as above (VS columns a block, the scores recomputed by each
// slice's block) and the strided layouts.  It walks chunks of the given
// length, with the state in shared memory.  Dispatch by dtype is not a
// fallback: both modes are hand kernels and raise on failure.
#include <cstdint>

#include "common.cuh"
#include "ptx.cuh"

typedef __nv_bfloat16 bf16;

struct WkvStrides {  // element strides (batch, step, head)
  long long rb, rs, rh;
  long long kb, ks, kh;
  long long vb, vs, vh;
  long long lb, ls, lh;
  long long yb, ys, yh;
};

constexpr int kQ = 32;  // the longest chunk the rank-1 split allows; the
                        // bf16 mode's tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClip = 40.f;

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, -kClip), kClip);
}

// 2^x in one MUFU instruction; for the normal results here (|x| <= 58) the
// same bits as exp2f, which adds denormal handling around it (measured 20%
// of the bf16 mode's time at rwkv6's shape)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ fp32 mode ----

constexpr int kFp32Threads = 256;

__global__ void __launch_bounds__(kFp32Threads)
    wkv6_fp32_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ lw,
                     const float* __restrict__ u, float* __restrict__ y,
                     WkvStrides st, int H, int S, int K, int V, int Q,
                     int VS) {
  extern __shared__ float smem_f[];
  const int Kp = K + 1;
  const int n_sl = (V + VS - 1) / VS;
  const int row = blockIdx.x / n_sl, sl = blockIdx.x - row * n_sl;
  const int bi = row / H, hi = row - bi * H;
  const int c0 = sl * VS, W = min(VS, V - c0);   // this block's columns
  float* sts = smem_f;           // K x W state
  float* r_s = sts + K * VS;     // Q x K: r, then r * exp(ce)
  float* k_s = r_s + kQ * K;     // Q x K: k, then k * exp(cs_end - cs)
  float* v_s = k_s + kQ * K;     // Q x W
  float* cs = v_s + kQ * VS;     // Q x K: lw, then its inclusive cumsum
  float* ce = cs + kQ * K;       // Q x K exclusive cumsum
  float* qf = ce + kQ * K;       // Q x Kp: r * exp(clip(ce - M))
  float* kf = qf + kQ * Kp;      // Q x Kp: k * exp(clip(M - cs))
  float* a_s = kf + kQ * Kp;     // Q x Q strictly lower scores
  float* dg = a_s + kQ * kQ;     // Q u-bonus diagonal

  const float* rr = r + bi * st.rb + hi * st.rh;
  const float* kr = k + bi * st.kb + hi * st.kh;
  const float* vr = v + bi * st.vb + hi * st.vh + c0;
  const float* lr = lw + bi * st.lb + hi * st.lh;
  float* yr = y + bi * st.yb + hi * st.yh + c0;
  const float* u_r = u + static_cast<size_t>(hi) * K;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  for (int i = tid; i < K * W; i += nt) sts[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int len = min(Q, S - t0);
    for (int i = tid; i < Q * K; i += nt) {
      const int j = i / K, kk = i - j * K;
      const bool in = j < len;
      r_s[i] = in ? rr[(t0 + j) * st.rs + kk] : 0.f;
      k_s[i] = in ? kr[(t0 + j) * st.ks + kk] : 0.f;
      cs[i] = in ? lr[(t0 + j) * st.ls + kk] : 0.f;
    }
    for (int i = tid; i < Q * W; i += nt) {
      const int j = i / W, c = i - j * W;
      v_s[i] = j < len ? vr[(t0 + j) * st.vs + c] : 0.f;
    }
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
      qf[i * Kp + kk] = rv * expf(clip(x - mid));
      kf[i * Kp + kk] = kv * expf(clip(mid - c));
      r_s[e] = rv * expf(x);
      k_s[e] = kv * expf(last - c);
    }
    __syncthreads();
    for (int e = tid; e < Q * Q; e += nt) {
      const int i = e / Q, j = e - i * Q;
      a_s[e] = j < i ? strided_dot(qf + i * Kp, 1, kf + j * Kp, 1, K) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < len * W; e += nt) {
      const int i = e / W, c = e - i * W;
      const float intra = strided_dot(a_s + i * Q, 1, v_s + c, W, i);
      const float inter = strided_dot(r_s + i * K, 1, sts + c, W, K);
      yr[(t0 + i) * st.ys + c] = intra + dg[i] * v_s[i * W + c] + inter;
    }
    __syncthreads();             // the outputs read the state
    for (int e = tid; e < K * W; e += nt) {
      const int kk = e / W, c = e - kk * W;
      sts[e] = sts[e] * expf(cs[(Q - 1) * K + kk]) +
               strided_dot(k_s + kk, K, v_s + c, W, len);
    }
    __syncthreads();             // the next chunk overwrites every buffer
  }
}

static size_t fp32_smem_bytes(int K, int VS) {
  return sizeof(float) *
         (static_cast<size_t>(K) * VS + 4 * kQ * K + kQ * VS +
          2 * kQ * (K + 1) + kQ * kQ + kQ);
}

// ------------------------------------------------------------ bf16 mode ----

constexpr int kPrepWarps = 4;
constexpr int kPrepThreads = 32 * kPrepWarps;
constexpr int kStages = 3;        // tiles of r, k, lw, v in flight
constexpr int kBarBlock = 1;      // named barriers: every warp of the block
constexpr int kBarPrep = 2;       // the prep warps only

template <int KP, int NC>
struct Cfg {
  static constexpr int VS = 16 * NC;             // state columns a block
  static constexpr int THREADS = 32 * (kPrepWarps + NC);
  static constexpr int CPW = KP / kPrepWarps;    // channels a prep warp
  static constexpr int PAIRS = CPW / 2;          // channel pairs a warp
  static constexpr int SEGS = 32 / PAIRS;        // step segments a warp
  static constexpr int SEGLEN = kQ / SEGS;       // steps a prep thread
  static constexpr int PB = 2 * KP;              // row bytes: r, k, factors
  static constexpr int PL = 4 * KP;              //            lw
  static constexpr int PV = 2 * VS;              //            v slice
  static constexpr int MAT = kQ * PB;            // 32 x KP bf16
  static constexpr int LWB = kQ * PL;            // 32 x KP fp32
  static constexpr int STAGE = 2 * MAT + LWB + kQ * PV;  // r, k, lw, v
  static constexpr int RING = kStages * STAGE;
  static constexpr int AB = kQ * kQ * 2;         // A, 32 x 32 bf16
  // rec = r e^ce, kw = k e^(cs_end - cs), A, dec = e^cs_end (fp32)
  static constexpr int FBUF = 2 * MAT + AB + 4 * KP;
  // + qf, kf and the warps' u-bonus partials (the prep warps' scratch)
  static constexpr int SMEM = RING + 2 * FBUF + 2 * MAT + 4 * kPrepWarps * kQ;
  static constexpr int LOG_PAIRS = PAIRS == 16 ? 4 : PAIRS == 8 ? 3 : 2;
  static_assert((KP == 64 || KP == 128) && (1 << LOG_PAIRS) == PAIRS &&
                    SEGLEN == PAIRS,
                "the diagonal's transpose-reduce");
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Byte offset of 16-byte chunk c of row r in a matrix of P-byte rows.
// P >= 128: the chunk XOR a key of the row that differs for 8 consecutive
// rows (ldmatrix) and, by its bits 1-2, for rows 8 apart (the prep warps'
// segments).  P < 128: the chunk within its 128-byte line XOR the line.
template <int P>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (P >= 128) {
    const int key = (r & 7) ^ (((r >> 3) & 3) << 1);
    return static_cast<uint32_t>(r * P + ((c ^ key) << 4));
  } else {
    const int o = r * P + (c << 4), line = o >> 7;
    return static_cast<uint32_t>((line << 7) + ((((o >> 4) & 7) ^ (line & 7))
                                                << 4));
  }
}

// Tile `tile` of the row into ring stage `stage` (by the prep threads):
// rows of r, k (K/8 chunks), lw (K/4) and the block's v columns (vcols/8);
// rows past S are zero-filled (source size 0, nothing read), padded
// channels and columns are never written.
template <int KP, int NC>
__device__ __forceinline__ void load_tile(uint32_t stage, const bf16* rr,
                                          const bf16* kr, const float* lr,
                                          const bf16* vr,
                                          const WkvStrides& st, int tile,
                                          int S, int K, int vcols, int tid) {
  using C = Cfg<KP, NC>;
  const int t0 = tile * kQ;
  constexpr int CB = KP / 8, CL = KP / 4, CV = C::VS / 8;
#pragma unroll
  for (int it = 0; it < kQ * CB / kPrepThreads; ++it) {
    const int i = tid + it * kPrepThreads, j = i / CB, c = i % CB;
    if (8 * c < K) {
      const bool in = t0 + j < S;
      const long long t = in ? t0 + j : 0;
      const uint32_t off = swz<C::PB>(j, c);
      cp_async16(stage + off, rr + t * st.rs + 8 * c, in ? 16 : 0);
      cp_async16(stage + C::MAT + off, kr + t * st.ks + 8 * c, in ? 16 : 0);
    }
  }
#pragma unroll
  for (int it = 0; it < kQ * CL / kPrepThreads; ++it) {
    const int i = tid + it * kPrepThreads, j = i / CL, c = i % CL;
    if (4 * c < K) {
      const bool in = t0 + j < S;
      const long long t = in ? t0 + j : 0;
      cp_async16(stage + 2 * C::MAT + swz<C::PL>(j, c), lr + t * st.ls + 4 * c,
                 in ? 16 : 0);
    }
  }
#pragma unroll
  for (int it = 0; it < (kQ * CV + kPrepThreads - 1) / kPrepThreads; ++it) {
    const int i = tid + it * kPrepThreads, j = i / CV, c = i % CV;
    if (i < kQ * CV && 8 * c < vcols) {
      const bool in = t0 + j < S;
      const long long t = in ? t0 + j : 0;
      cp_async16(stage + 2 * C::MAT + C::LWB + swz<C::PV>(j, c),
                 vr + t * st.vs + 8 * c, in ? 16 : 0);
    }
  }
}

// A prep warp's share of a tile: channels [CPW warp, +CPW), two a thread,
// SEGLEN steps a thread.  Writes qf, kf (scratch), rec, kw, dec (the
// tile's buffer) and this warp's partial u-bonus sums.
template <int KP, int NC>
__device__ __forceinline__ void prep_tile(const unsigned char* stg,
                                          unsigned char* fb,
                                          unsigned char* scr, float* dgp,
                                          float u0, float u1, int warp,
                                          int lane) {
  using C = Cfg<KP, NC>;
  constexpr int SL = C::SEGLEN;
  const int pair = lane % C::PAIRS, seg = lane / C::PAIRS;
  const int ch = warp * C::CPW + 2 * pair;   // channels ch, ch + 1
  const int j0 = seg * SL;
  const int cb = ch >> 3, wb = (ch & 7) * 2;   // bf16 chunk, byte in it
  const int cl = ch >> 2, wl = (ch & 3) * 4;   // fp32 chunk, byte in it
  const unsigned char* r_s = stg;
  const unsigned char* k_s = stg + C::MAT;
  const unsigned char* l_s = stg + 2 * C::MAT;

  // inclusive cumsum of lw over this thread's steps, then across segments
  float l0[SL], l1[SL], c0[SL], c1[SL];
  float run0 = 0.f, run1 = 0.f;
#pragma unroll
  for (int j = 0; j < SL; ++j) {
    const float2 l =
        *reinterpret_cast<const float2*>(l_s + swz<C::PL>(j0 + j, cl) + wl);
    l0[j] = l.x;
    l1[j] = l.y;
    run0 += l.x;
    run1 += l.y;
    c0[j] = run0;
    c1[j] = run1;
  }
  float in0 = run0, in1 = run1;
#pragma unroll
  for (int off = C::PAIRS; off < 32; off <<= 1) {
    const float a = __shfl_up_sync(0xffffffffu, in0, off);
    const float b = __shfl_up_sync(0xffffffffu, in1, off);
    if (lane >= off) {
      in0 += a;
      in1 += b;
    }
  }
  const float pre0 = in0 - run0, pre1 = in1 - run1;
  const int last = (C::SEGS - 1) * C::PAIRS + pair;
  const float mid0 = 0.5f * __shfl_sync(0xffffffffu, in0, last);
  const float mid1 = 0.5f * __shfl_sync(0xffffffffu, in1, last);
  const float em0 = ex2(mid0 * kLog2e), em1 = ex2(mid1 * kLog2e);

  unsigned char* qf = scr;
  unsigned char* kf = scr + C::MAT;
  unsigned char* rec = fb;
  unsigned char* kw = fb + C::MAT;
  float d[SL];
#pragma unroll
  for (int j = 0; j < SL; ++j) {
    const float cs0 = pre0 + c0[j], cs1 = pre1 + c1[j];
    const float ce0 = cs0 - l0[j], ce1 = cs1 - l1[j];
    const uint32_t off = swz<C::PB>(j0 + j, cb) + wb;
    const float2 rv = unpack_bf16(*reinterpret_cast<const uint32_t*>(r_s + off));
    const float2 kv = unpack_bf16(*reinterpret_cast<const uint32_t*>(k_s + off));
    const float q0 = rv.x * ex2(clip(ce0 - mid0) * kLog2e);
    const float q1 = rv.y * ex2(clip(ce1 - mid1) * kLog2e);
    const float f0 = kv.x * ex2(clip(mid0 - cs0) * kLog2e);
    const float f1 = kv.y * ex2(clip(mid1 - cs1) * kLog2e);
    *reinterpret_cast<uint32_t*>(qf + off) = round_bf16(q0, q1);
    *reinterpret_cast<uint32_t*>(kf + off) = round_bf16(f0, f1);
    *reinterpret_cast<uint32_t*>(rec + off) = round_bf16(q0 * em0, q1 * em1);
    *reinterpret_cast<uint32_t*>(kw + off) = round_bf16(f0 * em0, f1 * em1);
    d[j] = rv.x * u0 * kv.x + rv.y * u1 * kv.y;
  }
  if (seg == C::SEGS - 1)
    *reinterpret_cast<float2*>(fb + 2 * C::MAT + C::AB + 4 * ch) =
        make_float2(em0 * em0, em1 * em1);

  // u-bonus: sum the SL partials over the PAIRS lanes of a segment by
  // halving (each round sends half of what a lane holds); lane (seg, pair)
  // ends with step j0 + bitreverse(pair)
#pragma unroll
  for (int rd = 0; (1 << rd) < C::PAIRS; ++rd) {
    const int m = 1 << rd, n = SL >> (rd + 1);
    const bool up = lane & m;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? d[i] : d[i + n];
      const float keep = up ? d[i + n] : d[i];
      d[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  int step = 0;
#pragma unroll
  for (int b = 0; b < C::LOG_PAIRS; ++b)
    step |= ((pair >> b) & 1) << (C::LOG_PAIRS - 1 - b);
  dgp[warp * kQ + j0 + step] = d[0];
}

// The strictly lower scores of the tile with the u-bonus diagonal, in
// bf16, by three prep warps: (rows, columns) blocks of 16 (0, 0), (1, 0),
// (1, 1).
template <int KP, int NC>
__device__ __forceinline__ void scores(uint32_t scr_u32, unsigned char* fb,
                                       const float* dgp, int warp,
                                       int lane) {
  using C = Cfg<KP, NC>;
  if (warp >= 3) return;
  const int rb = warp ? 1 : 0, cb = warp == 2 ? 1 : 0;
  const uint32_t qf = scr_u32, kf = scr_u32 + C::MAT;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int ks = 0; ks < KP / 16; ++ks) {
    uint32_t a[4], b[4];
    ldsm4(qf + swz<C::PB>(16 * rb + (lane & 15), 2 * ks + (lane >> 4)), a);
    ldsm4(kf + swz<C::PB>(16 * cb + (lane & 7) + ((lane >> 4) << 3),
                          2 * ks + ((lane >> 3) & 1)),
          b);
    mma(acc[0], a, b[0], b[1]);
    mma(acc[1], a, b[2], b[3]);
  }
  const int g = lane >> 2, q4 = lane & 3;
  unsigned char* A = fb + 2 * C::MAT;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = 16 * rb + g + 8 * hf;
    float di = dgp[i];
#pragma unroll
    for (int w = 1; w < kPrepWarps; ++w) di += dgp[w * kQ + i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 16 * cb + 8 * h + 2 * q4;
      const float e0 = acc[h][2 * hf], e1 = acc[h][2 * hf + 1];
      const float v0 = j < i ? e0 : j == i ? di : 0.f;
      const float v1 = j + 1 < i ? e1 : j + 1 == i ? di : 0.f;
      *reinterpret_cast<uint32_t*>(A + swz<2 * kQ>(i, 2 * cb + h) + 4 * q4) =
          round_bf16(v0, v1);
    }
  }
}

// A chain warp's tile: y for its 16 columns, then its state.  sacc holds
// S^T: rows c = g (+8), columns k = 8 nt + 2 q4 (+1).
template <int KP, int NC>
__device__ __forceinline__ void chain_tile(float (&sacc)[KP / 8][4],
                                           uint32_t fb_u32, const float* dec,
                                           uint32_t v_u32, bf16* yr,
                                           long long ys, int t0, int S,
                                           int ncol, int cw, int lane) {
  using C = Cfg<KP, NC>;
  const uint32_t rec = fb_u32, kw = fb_u32 + C::MAT;
  const uint32_t A = fb_u32 + 2 * C::MAT;

  // Y^T = S^T (r e^ce)^T, S^T rounded to bf16 as the A operand
  float yacc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KP / 16; ++ks) {
    const uint32_t sa[4] = {
        round_bf16(sacc[2 * ks][0], sacc[2 * ks][1]),
        round_bf16(sacc[2 * ks][2], sacc[2 * ks][3]),
        round_bf16(sacc[2 * ks + 1][0], sacc[2 * ks + 1][1]),
        round_bf16(sacc[2 * ks + 1][2], sacc[2 * ks + 1][3])};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      uint32_t b[4];
      ldsm4(rec + swz<C::PB>(16 * nb + (lane & 7) + ((lane >> 4) << 3),
                             2 * ks + ((lane >> 3) & 1)),
            b);
      mma(yacc[2 * nb], sa, b[0], b[1]);
      mma(yacc[2 * nb + 1], sa, b[2], b[3]);
    }
  }

  // v^T as A fragments (rows: this warp's columns, k: steps)
  uint32_t va[2][4];
#pragma unroll
  for (int kb = 0; kb < 2; ++kb)
    ldsm4_t(v_u32 + swz<C::PV>(16 * kb + (lane & 7) + ((lane >> 4) << 3),
                               2 * cw + ((lane >> 3) & 1)),
            va[kb]);

  // Y^T += v^T A^T over the step blocks kb <= ib (A is lower triangular)
#pragma unroll
  for (int ib = 0; ib < 2; ++ib)
#pragma unroll
    for (int kb = 0; kb <= ib; ++kb) {
      uint32_t b[4];
      ldsm4(A + swz<2 * kQ>(16 * ib + (lane & 7) + ((lane >> 4) << 3),
                            2 * kb + ((lane >> 3) & 1)),
            b);
      mma(yacc[2 * ib], va[kb], b[0], b[1]);
      mma(yacc[2 * ib + 1], va[kb], b[2], b[3]);
    }

  // y: column g (+8), steps 8 nt + 2 q4 (+1)
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = g + 8 * (e >> 1), i = t0 + 8 * nt + 2 * q4 + (e & 1);
      if (i < S && c < ncol) yr[i * ys + c] = __float2bfloat16_rn(yacc[nt][e]);
    }

  // S^T <- S^T diag(e^cs_end) + v^T (k e^(cs_end - cs))
#pragma unroll
  for (int nt = 0; nt < KP / 8; ++nt) {
    const float2 dd = *reinterpret_cast<const float2*>(dec + 8 * nt + 2 * q4);
    sacc[nt][0] *= dd.x;
    sacc[nt][1] *= dd.y;
    sacc[nt][2] *= dd.x;
    sacc[nt][3] *= dd.y;
  }
#pragma unroll
  for (int kb = 0; kb < 2; ++kb)
#pragma unroll
    for (int q2 = 0; q2 < KP / 16; ++q2) {
      uint32_t b[4];
      ldsm4_t(kw + swz<C::PB>(16 * kb + (lane & 7) + ((lane >> 3) & 1) * 8,
                              2 * q2 + (lane >> 4)),
              b);
      mma(sacc[2 * q2], va[kb], b[0], b[1]);
      mma(sacc[2 * q2 + 1], va[kb], b[2], b[3]);
    }
}

template <int KP, int NC>
__global__ void __launch_bounds__(Cfg<KP, NC>::THREADS, KP == 64 ? 2 : 1)
    wkv6_mma_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ lw,
                    const float* __restrict__ u, bf16* __restrict__ y,
                    WkvStrides st, int H, int S, int K, int V) {
  using C = Cfg<KP, NC>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_sl = (V + C::VS - 1) / C::VS;
  const int row = blockIdx.x / n_sl, sl = blockIdx.x - row * n_sl;
  const int bi = row / H, hi = row - bi * H, c0 = sl * C::VS;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // warp-uniform
  const uint32_t base = smem_u32(smem);
  unsigned char* fbuf = smem + C::RING;               // two tile buffers
  unsigned char* scr = fbuf + 2 * C::FBUF;            // qf, kf
  float* dgp = reinterpret_cast<float*>(scr + 2 * C::MAT);
  const int n_tiles = (S + kQ - 1) / kQ;

  // Zero the ring (its padded channels and columns are never loaded).
  for (int i = tid; i < C::SMEM / 16; i += C::THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  if (warp < kPrepWarps) {
    const bf16* rr = r + bi * st.rb + hi * st.rh;
    const bf16* kr = k + bi * st.kb + hi * st.kh;
    const float* lr = lw + bi * st.lb + hi * st.lh;
    const bf16* vr = v + bi * st.vb + hi * st.vh + c0;
    const int vcols = V - c0;
    const int ch = warp * C::CPW + 2 * (lane % C::PAIRS);
    const float* ur = u + static_cast<size_t>(hi) * K;
    const float u0 = ch < K ? ur[ch] : 0.f, u1 = ch + 1 < K ? ur[ch + 1] : 0.f;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_tiles)
        load_tile<KP, NC>(base + s * C::STAGE, rr, kr, lr, vr, st, s, S, K,
                          vcols, tid);
      cp_async_commit();
    }
    cp_async_wait<kStages - 2>();   // tile 0
    bar_sync(kBarPrep, kPrepThreads);
    prep_tile<KP, NC>(smem, fbuf, scr, dgp, u0, u1, warp, lane);
    bar_sync(kBarPrep, kPrepThreads);
    scores<KP, NC>(base + C::RING + 2 * C::FBUF, fbuf, dgp, warp, lane);
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 3>();   // tile t + 1
      bar_sync(kBarBlock, C::THREADS);
      if (t + kStages - 1 < n_tiles)
        load_tile<KP, NC>(base + ((t + kStages - 1) % kStages) * C::STAGE, rr,
                          kr, lr, vr, st, t + kStages - 1, S, K, vcols, tid);
      cp_async_commit();
      if (t + 1 < n_tiles) {
        unsigned char* fb = fbuf + ((t + 1) & 1) * C::FBUF;
        prep_tile<KP, NC>(smem + ((t + 1) % kStages) * C::STAGE, fb, scr, dgp,
                          u0, u1, warp, lane);
        bar_sync(kBarPrep, kPrepThreads);
        scores<KP, NC>(base + C::RING + 2 * C::FBUF, fb, dgp, warp, lane);
      }
    }
    cp_async_wait<0>();
  } else {
    const int cw = warp - kPrepWarps;
    bf16* yr = y + bi * st.yb + hi * st.yh + c0 + 16 * cw;
    const int ncol = V - c0 - 16 * cw;
    float sacc[KP / 8][4];
#pragma unroll
    for (int nt = 0; nt < KP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      bar_sync(kBarBlock, C::THREADS);   // tile t's buffer and v are in
      const int fo = C::RING + (t & 1) * C::FBUF;
      chain_tile<KP, NC>(
          sacc, base + fo,
          reinterpret_cast<const float*>(smem + fo + 2 * C::MAT + C::AB),
          base + (t % kStages) * C::STAGE + 2 * C::MAT + C::LWB, yr, st.ys,
          t * kQ, S, ncol, cw, lane);
    }
  }
}

// ----------------------------------------------------------------- entry ----

template <int KP, int NC>
static cudaError_t launch_mma(const WkvStrides& st, const void* r,
                              const void* k, const void* v, const void* lw,
                              const void* u, void* y, int B, int H, int S,
                              int K, int V, cudaStream_t s) {
  using C = Cfg<KP, NC>;
  static size_t granted = 0;
  cudaError_t err = allow_smem(wkv6_mma_kernel<KP, NC>, C::SMEM, &granted);
  if (err != cudaSuccess) return err;
  const int grid = B * H * ((V + C::VS - 1) / C::VS);
  wkv6_mma_kernel<KP, NC><<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<bf16*>(y), st, H, S, K, V);
  return cudaGetLastError();
}

template <int KP, int NC>
static int mma_blocks_per_sm() {
  using C = Cfg<KP, NC>;
  static size_t granted = 0;
  int n = 0;
  if (allow_smem(wkv6_mma_kernel<KP, NC>, C::SMEM, &granted) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wkv6_mma_kernel<KP, NC>, C::THREADS, C::SMEM) != cudaSuccess)
    return -1;
  return n;
}

static bool mma_shape(int K, int V, int VS) {
  return K >= 8 && K <= 128 && K % 8 == 0 && V >= 8 && V <= 128 &&
         V % 8 == 0 && (VS == 16 || VS == 32);
}

// Dynamic shared memory a launch requests (-1: a shape the mode refuses).
extern "C" int rwkv6_wkv_smem_bytes(int dtype, int K, int VS) {
  if (dtype == kBFloat16) {
    if (!mma_shape(K, 16, VS)) return -1;
    if (K <= 64) return VS == 16 ? Cfg<64, 1>::SMEM : Cfg<64, 2>::SMEM;
    return VS == 16 ? Cfg<128, 1>::SMEM : Cfg<128, 2>::SMEM;
  }
  return static_cast<int>(fp32_smem_bytes(K, VS));
}

// Blocks of a launch that one SM holds at once (the occupancy API, with the
// launch's shared-memory attribute set).
extern "C" int rwkv6_wkv_blocks_per_sm(int dtype, int K, int VS) {
  if (dtype == kBFloat16) {
    if (!mma_shape(K, 16, VS)) return -1;
    if (K <= 64) return VS == 16 ? mma_blocks_per_sm<64, 1>()
                                 : mma_blocks_per_sm<64, 2>();
    return VS == 16 ? mma_blocks_per_sm<128, 1>() : mma_blocks_per_sm<128, 2>();
  }
  static size_t granted = 0;
  const size_t smem = fp32_smem_bytes(K, VS);
  int n = 0;
  if (allow_smem(wkv6_fp32_kernel, smem, &granted) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wkv6_fp32_kernel, kFp32Threads, smem) != cudaSuccess)
    return -1;
  return n;
}

extern "C" int rwkv6_wkv_launch(int dtype, const void* r, const void* k,
                                const void* v, const void* lw, const void* u,
                                void* y, int B, int H, int S, int K, int V,
                                int Q, int VS, const long long* strides,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WkvStrides st{strides[0],  strides[1],  strides[2],  strides[3],
                      strides[4],  strides[5],  strides[6],  strides[7],
                      strides[8],  strides[9],  strides[10], strides[11],
                      strides[12], strides[13], strides[14]};
  if (Q < 1 || Q > kQ || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBFloat16) {
    if (!mma_shape(K, V, VS)) return static_cast<int>(cudaErrorInvalidValue);
    if (K <= 64)
      return VS == 16 ? launch_mma<64, 1>(st, r, k, v, lw, u, y, B, H, S, K,
                                          V, s)
                      : launch_mma<64, 2>(st, r, k, v, lw, u, y, B, H, S, K,
                                          V, s);
    return VS == 16
               ? launch_mma<128, 1>(st, r, k, v, lw, u, y, B, H, S, K, V, s)
               : launch_mma<128, 2>(st, r, k, v, lw, u, y, B, H, S, K, V, s);
  }
  if (dtype == kFloat32) {
    if (K < 1 || K > 128 || V < 1 || V > 128 || VS < 1 || VS > V)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = fp32_smem_bytes(K, VS);
    static size_t granted = 0;
    cudaError_t err = allow_smem(wkv6_fp32_kernel, smem, &granted);
    if (err != cudaSuccess) return err;
    const int grid = B * H * ((V + VS - 1) / VS);
    wkv6_fp32_kernel<<<grid, kFp32Threads, smem, s>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(lw),
        static_cast<const float*>(u), static_cast<float*>(y), st, H, S, K, V,
        Q, VS);
    return cudaGetLastError();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
