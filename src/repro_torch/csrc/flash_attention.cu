// K2, causal (or non-causal) flash attention for Hopper (sm_90a) with GQA
// K/V sharing and an fp32 online softmax over KV tiles, in two modes chosen
// by dtype: bf16 on the tensor cores (wgmma), fp32 on the CUDA cores.
//
// Replaces the TPU kernel `flash_attention_bhsd` (src/repro/kernels/
// flash_attention.py).  The Python wrapper, its launch plan and the plain
// PyTorch version live in src/repro_torch/kernels/flash_attention.py.
//
// Layouts.  Both modes read q as rows (b, kv, g, s) and k, v as rows
// (b, kv, s) through element strides (the last dim contiguous), and write
// out with strides like q.  Query head h = (b * KV + kv) * G + g reads the
// K/V rows of (b, kv), so GQA never materializes repeated K/V.  The model
// layout (B, S, KV, G, D) and the public (B*KV*G, S, D) layout go through
// the same entry, so the model path launches on its own tensors, with no
// permute or copy before or after.  Any S is taken: the serve engine's
// prefill bucket min(next_pow2(len), max_seq) need not divide the tile;
// keys past S are masked, rows past S are not stored, and loads past the
// end read zeros.
//
// bf16 mode (flash_attention_wgmma_kernel<D>, D in {32, 64, 128}).  A block
// of two warpgroups owns 128 query rows of one head, each warpgroup 64
// rows, wgmma's M.  Q is loaded once into shared memory; K and V tiles of
// BN keys (64 at D = 128, else 128) stream through a four-stage ring.
// Loads are cp.async, 16 bytes a thread, issued two tiles ahead by the same
// threads: cp.async takes the model layout's element strides as they are,
// zero-fills rows past S by a predicated source size, and needs neither a
// tensor map encoded on the host per call (three a launch) nor a producer
// warp.  No block barrier paces the ring: each stage has a
// `full` mbarrier, on which every thread's copies arrive as they land
// (cp.async.mbarrier.arrive.noinc), and an `empty` one, on which every
// thread arrives once it is done with the tile.  Every tile is stored in
// the layout wgmma's shared-memory descriptors read: rows of 64 elements
// (128 bytes; 32 elements and 64 bytes at D = 32) in column blocks, the
// 16-byte chunks XOR-swizzled by the row (128- or 64-byte swizzle), so
// neither the cp.async writes nor the wgmma reads conflict.  Per tile a
// warpgroup issues S = Q K^T as D/16 wgmma m64nBNk16 (both operands
// K-major in shared memory, fp32 accumulators in registers) together with
// the previous tile's O += P V, then runs the online softmax on the
// accumulator fragments in registers while P V finishes: each thread holds
// two rows' values, row max and sum take two quad shuffles, the 1/sqrt(D)
// scale (with log2 e, for exp2) multiplies the fp32 scores, and only tiles
// that cross the diagonal or S are masked (to -1e30, as the TPU kernel), in
// an instantiation of their own.  P is the register A operand of O += P V
// (wgmma m64nDk16), with V the shared-memory B operand in its natural
// (keys, D) layout through the transpose bit of the descriptor: no
// transpose pass.  The two warpgroups take turns at issuing their wgmmas
// (named barriers), so one's softmax runs under the other's wgmmas.  The
// scores never touch shared memory.  Causal blocks skip every tile above
// their last row, a warpgroup skips the math of a tile above its own last
// row, and query tiles are launched longest first within chunks of 16
// heads, so the short diagonal tiles fill the tail of the grid.  ptxas serializes every wgmma
// (C7520, C7514) when a wgmma sits in a branch it takes for divergent, or
// when a branch issues a wgmma that another branch waits for: the
// warpgroup index goes through a shuffle, and every branch that issues
// also waits.
//
// Precision.  The JAX kernel multiplies P V in fp32
// (flash_attention.py:50-51).  A single bf16 P (relative error 2^-9)
// moves an output row, a convex combination of V rows, by up to
// 2^-9 max|v|, and so can flip the output's own bf16 rounding: one unit
// is 3.1e-2 at |o| >= 4, beyond the 2e-2 absolute bound at which bf16 is
// held against the plain version.  So P goes in as two bf16 terms, hi (P
// truncated) and lo (the rest, rounded), two wgmmas each k-step: hi + lo
// keeps 16 bits of P, and P V is within 2^-16 max|v| of the fp32 product,
// well below one output unit.  l is summed over the fp32 P.  The second
// term doubles the P V wgmmas.
//
// fp32 mode (flash_attention_fp32_kernel).  The first version of this
// kernel, kept for fp32 inputs only: CUDA-core fp32 FMAs over 32 x 32
// tiles in shared memory.  It stays because the fp32 gates hold full-width
// fp32 logits to 1e-3 relative and fp32 K2 to 1e-4 absolute against the
// plain version; the tensor cores' fp32 path is TF32, which keeps about
// three digits and would break those bounds.  Dispatch by dtype is not a
// fallback: both modes are hand kernels, count their launches, and raise
// on failure.
//
// What bounds it.  At the serve prefill shape (8 prompts x 32 heads, S =
// 256, D = 128, causal) the kernel moves 42 MB and does 4.3 GFLOP: bound by
// bytes (12.5 us at 3.35 TB/s).  At zamba2-1.2b's shared attention block
// (B = 4, H = 32, S = 2048, D = 64, causal) it does 68.7 GFLOP on 134 MB:
// bound by the tensor cores (69 us at 989 TFLOP/s), with the softmax's
// exponentials (16 a clock an SM) close behind at D = 64.  The design
// keeps the scores in registers and overlaps the loads, one warpgroup's
// wgmmas and the other's softmax; a persistent grid that loads the next
// tile's Q and K/V under this one's math, and a producer warp with TMA,
// are the next steps.
#include <cstdint>

#include "common.cuh"
#include "ptx.cuh"

struct Strides {  // element strides: q, out (b, kv, g, s); k, v (b, kv, s)
  long long qb, qkv, qg, qs, kb, kkv, ks, vb, vkv, vs, ob, okv, og, os;
};

// Block -> (head, query tile): heads go in chunks of kHeadChunk, and a
// chunk's tiles longest (last rows) first across its heads, so long causal
// tiles start early and short ones fill the tail, while the K/V a chunk
// reads stays in L2 (16 heads of zamba2-1.2b's S = 2048 hold 8 MB).  The
// Python plan mirrors this mapping.
constexpr int kHeadChunk = 16;
__device__ __forceinline__ void block_tile(int n_qt, int& h, int& qt) {
  const int n_heads = gridDim.x / n_qt, per_chunk = kHeadChunk * n_qt;
  const int c = blockIdx.x / per_chunk, r = blockIdx.x - c * per_chunk;
  const int heads = min(kHeadChunk, n_heads - c * kHeadChunk);
  qt = n_qt - 1 - r / heads;
  h = c * kHeadChunk + r % heads;
}

// ------------------------------------------------------------ fp32 mode ----

constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr int kThreads = 256;

__global__ void flash_attention_fp32_kernel(const float* __restrict__ q,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            float* __restrict__ out,
                                            Strides st, int KV, int G, int S,
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

  int h, qt;
  block_tile(n_qt, h, qt);
  const int q0 = qt * kBQ;
  const int g = h % G, kvh = (h / G) % KV, b = h / G / KV;
  const float* qh = q + b * st.qb + kvh * st.qkv + g * st.qg;
  const float* kh = k + b * st.kb + kvh * st.kkv;
  const float* vh = v + b * st.vb + kvh * st.vkv;
  float* oh = out + b * st.ob + kvh * st.okv + g * st.og;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < kBQ * D; i += nt) {
    const int r = i / D, d = i - r * D;
    q_s[i] = q0 + r < S ? qh[(q0 + r) * st.qs + d] * scale : 0.f;
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
      k_s[r * Dk + d] = in ? kh[(k0 + r) * st.ks + d] : 0.f;
      v_s[i] = in ? vh[(k0 + r) * st.vs + d] : 0.f;
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
    const int r = i / D, d = i - r * D;
    if (q0 + r < S)
      oh[(q0 + r) * st.os + d] = acc_s[i] / fmaxf(l_s[r], 1e-30f);
  }
}

static size_t fp32_smem_bytes(int D) {
  return sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D + kBQ * kBK +
                          kBQ * D + 3 * kBQ);
}

// ------------------------------------------------------------ bf16 mode ----

typedef __nv_bfloat16 bf16;

constexpr int kWG = 2;            // warpgroups a block
constexpr int kBM = 64 * kWG;     // query rows a block
constexpr int kTC = 128 * kWG;    // threads a block
constexpr int kStages = 4;        // K/V ring stages: K_j, V_{j-1}, and
constexpr int kAhead = kStages - 2;  // the tiles loading ahead of j

// Per head dim: keys a tile (BN), elements a swizzled row (CB: 64 for the
// 128-byte swizzle, 32 for the 64-byte one), the swizzle's row mask and the
// descriptor's layout code (1: 128-byte swizzle, 2: 64-byte swizzle).
template <int D> struct Tile;
template <> struct Tile<32> {
  static constexpr int BN = 128, CB = 32, MASK = 3, LAYOUT = 2;
};
template <> struct Tile<64> {
  static constexpr int BN = 128, CB = 64, MASK = 7, LAYOUT = 1;
};
template <> struct Tile<128> {
  static constexpr int BN = 64, CB = 64, MASK = 7, LAYOUT = 1;
};

// Q for the block, then kStages (K, V) pairs, each region 1024-byte
// aligned (the swizzle's period), then a full and an empty mbarrier a
// stage.
template <int D> constexpr size_t tc_smem_bytes() {
  return static_cast<size_t>(kBM) * D * 2 +
         static_cast<size_t>(kStages) * 2 * Tile<D>::BN * D * 2 +
         16 * kStages;
}

// The 16-byte chunk index (address bits 4-6) XOR the 128-byte row index
// (bits 7-9), as many bits as the swizzle is wide (MASK 7: 128-byte, 3:
// 64-byte): the layout TMA's swizzle modes write and wgmma's descriptors
// read.  Offsets are taken from 1024-byte aligned tile bases.
template <int MASK> __device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & MASK) << 4);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async
// proxy: a reader fences once the tile's `full` mbarrier has completed.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// mbarriers in shared memory: `full` of a ring stage completes when every
// thread's cp.async of its tile landed, `empty` when every thread is done
// with the tile; a wait names the parity of the phase it waits for.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// arrives once this thread's cp.async issued so far have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving a read of an accumulator above the wait,
// or from reusing an A-operand register before the wgmma has read it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory descriptor: start address >> 4 (bits 0-13), leading
// byte offset >> 4 (16-29), stride byte offset >> 4 (32-45), base offset 0
// (tiles are aligned to the swizzle period), layout (62-63).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// 2^x in one MUFU instruction (relative error ~2^-22; 0 for x < -126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P = hi + lo in two bf16 terms, two consecutive values (k, k + 1) a
// register each, as wgmma's A fragments: hi is P truncated to bf16 (its
// upper 16 bits), lo the rest rounded to bf16, so hi + lo keeps 16 bits
// of P.  Truncation takes one byte permute for two values.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  lo = pack_bf16(__floats2bfloat162_rn(x0 - __uint_as_float(u0 & 0xffff0000u),
                                       x1 - __uint_as_float(u1 & 0xffff0000u)));
}

// ---------------------------------------------- wgmma (bf16 in, fp32 out) ----
// One asm statement per shape: m64nNk16, D in registers; SS reads A and B
// from shared memory (both K-major), RS takes A from registers and B from
// shared memory with the transpose bit (MN-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// R rows of D elements from `src` (row stride `rs` elements, rows r0 ..
// r0 + R - 1, zeros past S) into the swizzled tile at `dst`: column block
// e / CB at (e / CB) * R * 2CB bytes, row r at r * 2CB within it.
template <int D, int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          long long rs, int r0, int S,
                                          int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int CB = Tile<D>::CB, RB = 2 * CB;
  static_assert(R * kChunks % kTC == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < R * kChunks / kTC; ++i) {
    const int c = tid + i * kTC;
    const int r = c / kChunks, e = (c % kChunks) * 8;
    const bool in = r0 + r < S;
    const bf16* p = src + (in ? (r0 + r) * rs + e : 0);
    const uint32_t off = (e / CB) * (R * RB) + r * RB + (e % CB) * 2;
    cp_async16(dst + swizzle<Tile<D>::MASK>(off), p, in ? 16 : 0);
  }
}

template <int BN>
__device__ __forceinline__ void qk_wgmma(float (&s)[BN / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (BN == 64)
    wgmma_ss_n64(s, a, b, scale_d);
  else
    wgmma_ss_n128(s, a, b, scale_d);
}

template <int D>
__device__ __forceinline__ void pv_wgmma(float (&o)[D / 2],
                                         const uint32_t (&p)[4], uint64_t b) {
  if constexpr (D == 32)
    wgmma_rs_n32(o, p, b);
  else if constexpr (D == 64)
    wgmma_rs_n64(o, p, b);
  else
    wgmma_rs_n128(o, p, b);
}

// One warpgroup's state and steps.  Accumulator fragment of m64nN: this
// thread's rows are row0 and row0 + 8, its columns 8i + 2 (lane % 4) +
// {0, 1} of every 8-column group i (registers 4i .. 4i + 3).
template <int D> struct Warpgroup {
  using T = Tile<D>;
  static constexpr int BN = T::BN, RB = 2 * T::CB;
  float o[D / 2];                           // O, fp32
  uint32_t hi[BN / 16][4], lo[BN / 16][4];  // P = hi + lo, in bf16
  float m0, m1, l0, l1;  // running max (raw scores), partial sums
  int row0, col;

  // S = Q K^T: k-step kk reads 16 columns, 32 bytes into a column block
  __device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t qw,
                                           uint32_t ks) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t blk = kk * 16 / T::CB, in = (kk * 16 % T::CB) * 2;
      const uint64_t a =
          make_desc(qw + blk * 64 * RB + in, 16, 8 * RB, T::LAYOUT);
      const uint64_t b =
          make_desc(ks + blk * BN * RB + in, 16, 8 * RB, T::LAYOUT);
      if constexpr (BN == 64)
        wgmma_ss_n64(s, a, b, kk > 0);
      else
        wgmma_ss_n128(s, a, b, kk > 0);
    }
  }

  // O += (P_hi + P_lo) V: V is (keys, D), the MN-major B operand; k-step
  // kk starts 16 key rows down
  __device__ __forceinline__ void issue_pv(uint32_t vs) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t b =
          make_desc(vs + kk * 16 * RB, BN * RB, 8 * RB, T::LAYOUT);
#pragma unroll
      for (int part = 0; part < 2; ++part) {  // P_hi, then P_lo
        const uint32_t(&a)[4] = part ? lo[kk] : hi[kk];
        if constexpr (D == 32)
          wgmma_rs_n32(o, a, b);
        else if constexpr (D == 64)
          wgmma_rs_n64(o, a, b);
        else
          wgmma_rs_n128(o, a, b);
      }
    }
  }

  // Online softmax of one tile's scores, in place: s becomes P (fp32);
  // updates m, l; returns the rescale of O for rows row0 and row0 + 8.
  // A tile across the diagonal or S is masked in an instantiation of its
  // own; the rest take no mask instructions.
  template <bool MASKED>
  __device__ __forceinline__ void softmax(float (&s)[BN / 2], int k0, int S,
                                          int causal, float scale_log2,
                                          float& c0, float& c1) {
    if (MASKED) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + col + (i & 1);
        const int row = row0 + ((i >> 1) & 1) * 8;
        if (key >= S || (causal && key > row)) s[i] = REPRO_NEG_INF;
      }
    }
    float mx0 = m0, mx1 = m1;  // the scale is positive: max of raw scores
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the quad shares a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    c0 = ex2((m0 - mx0) * scale_log2);
    c1 = ex2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float b0 = -mx0 * scale_log2, b1 = -mx1 * scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 4) {  // p = 2^(s c - m c), c = scale
      s[i] = ex2(fmaf(s[i], scale_log2, b0));
      s[i + 1] = ex2(fmaf(s[i + 1], scale_log2, b0));
      s[i + 2] = ex2(fmaf(s[i + 2], scale_log2, b1));
      s[i + 3] = ex2(fmaf(s[i + 3], scale_log2, b1));
      sum0 += s[i] + s[i + 1];
      sum1 += s[i + 2] + s[i + 3];
    }
    l0 = l0 * c0 + sum0;  // per-thread partial sums: reduced at the end
    l1 = l1 * c1 + sum1;
  }

  // P as wgmma's A fragments: k-step kk holds columns 16kk .. 16kk + 15,
  // the accumulator groups 2kk and 2kk + 1 (registers 8kk .. 8kk + 7)
  __device__ __forceinline__ void pack(const float (&p)[BN / 2]) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1], hi[kk][r],
                   lo[kk][r]);
  }

  __device__ __forceinline__ void rescale(float c0, float c1) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= c0;
      o[4 * i + 1] *= c0;
      o[4 * i + 2] *= c1;
      o[4 * i + 3] *= c1;
    }
  }

  // Tile k0's softmax (while the previous tile's P V runs, where PV), then
  // O's rescale and the tile's P.
  template <bool PV, bool MASKED>
  __device__ __forceinline__ void tile(float (&s)[BN / 2], int k0, int S,
                                       int causal, float scale_log2) {
    float c0, c1;
    softmax<MASKED>(s, k0, S, causal, scale_log2, c0, c1);
    if (PV) wait_pv();
    rescale(c0, c1);
    pack(s);
  }

  __device__ __forceinline__ void wait_pv() {
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
  }
};

template <int D>
__global__ void __launch_bounds__(kTC, 1)
    flash_attention_wgmma_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 bf16* __restrict__ out, Strides st, int KV,
                                 int G, int S, int n_qt, int causal,
                                 float scale_log2) {
  using W = Warpgroup<D>;
  constexpr int BN = W::BN;
  constexpr uint32_t kQWG = 64 * D * 2;  // one warpgroup's Q rows, bytes
  constexpr uint32_t kKV = BN * D * 2;   // one K or V tile, bytes
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_s = smem_u32(smem_raw);  // 1024-aligned: the swizzle
  const uint32_t ring = q_s + kWG * kQWG;   // stage i: K, then V
  if (q_s & 1023) __trap();  // the swizzle needs 1024-byte aligned tiles

  int h, qt;
  block_tile(n_qt, h, qt);
  const int q0 = qt * kBM;
  const int g = h % G, kvh = (h / G) % KV, b = h / G / KV;
  const bf16* qh = q + b * st.qb + kvh * st.qkv + g * st.qg;
  const bf16* kh = k + b * st.kb + kvh * st.kkv;
  const bf16* vh = v + b * st.vb + kvh * st.vkv;
  bf16* oh = out + b * st.ob + kvh * st.okv + g * st.og;

  const int tid = threadIdx.x;
  // the warpgroup index through a shuffle, so that ptxas knows it is
  // uniform: a branch it takes for divergent would make it serialize every
  // wgmma (C7520)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int wg_first = q0 + wg * 64;
  const uint32_t qw = q_s + wg * kQWG;
  // tiles the block walks, and the ones this warpgroup computes (a causal
  // warpgroup stops at the tile of its own last row)
  const int kv_end = causal ? min(q0 + kBM, S) : S;
  const int n_kt = (kv_end + BN - 1) / BN;
  const int n_w = causal ? min(n_kt, (wg_first + 63) / BN + 1) : n_kt;

  auto stage = [&](int t) { return ring + (t % kStages) * 2 * kKV; };
  const uint32_t bars = ring + kStages * 2 * kKV;
  auto full = [&](int t) { return bars + 8 * (t % kStages); };
  auto empty = [&](int t) { return bars + 8 * (kStages + t % kStages); };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), kTC);
      mbar_init(empty(i), kTC);
    }
  }
  __syncthreads();
  // K/V tile t into its ring stage, once every thread released the stage's
  // previous tile; every thread loads its chunks and arrives on `full`
  auto load_kv = [&](int t) {
    if (t >= kStages) mbar_wait(empty(t), (t / kStages - 1) & 1);
    load_rows<D, BN>(stage(t), kh, st.ks, t * BN, S, tid);
    load_rows<D, BN>(stage(t) + kKV, vh, st.vs, t * BN, S, tid);
    mbar_arrive_cp_async(full(t));
  };
#pragma unroll
  for (int w = 0; w < kWG; ++w)
    load_rows<D, 64>(q_s + w * kQWG, qh, st.qs, q0 + w * 64, S, tid);
#pragma unroll
  for (int t = 0; t < kAhead; ++t)
    if (t < n_kt) load_kv(t);  // tile 0's arrival covers Q too

  W wgs;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) wgs.o[i] = 0.f;
  wgs.m0 = wgs.m1 = REPRO_NEG_INF;
  wgs.l0 = wgs.l1 = 0.f;
  wgs.row0 = wg_first + warp * 16 + lane / 4;
  wgs.col = 2 * (lane % 4);

  // Tile j: S = Q K_j^T and O += P_{j-1} V_{j-1} go to the tensor cores
  // together; the softmax of S_j runs while P V finishes, then O's rescale
  // and P_j.  The ring holds K_j, V_{j-1} and the loads of the kAhead
  // tiles after j.  No block barrier: a warpgroup waits for its tile's
  // `full` mbarrier, and each thread releases a tile on `empty` once its
  // P V is done (a tile it skips, at once).  The two warpgroups take turns
  // at issuing their wgmmas (named barriers 1 and 2), so one's softmax
  // runs under the other's wgmmas; each takes exactly one turn a tile,
  // with or without work, so neither waits on a turn the other never
  // gives.  Every branch that issues a wgmma also waits for it, so ptxas
  // keeps the wgmmas asynchronous.
  auto wait_tile = [&](int j) {  // tile j (and Q) landed for every thread
    mbar_wait(full(j), (j / kStages) & 1);
    fence_proxy_async();  // cp.async wrote it; wgmma reads it
  };
  auto release = [&](int t) { mbar_arrive(empty(t)); };
  auto load_ahead = [&](int j) {
    if (j + kAhead < n_kt) load_kv(j + kAhead);
  };
  auto turn = [&] {  // wait for this warpgroup's turn at the tensor cores
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kTC) : "memory");
  };
  auto pass = [&] {  // give the other warpgroup its turn
    asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(kTC) : "memory");
  };
  auto masked = [&](int k0) {
    return (causal && k0 + BN - 1 > wg_first) || k0 + BN > S;
  };
  static_assert(kWG == 2, "the turns are for two warpgroups");
  if (wg == 1) pass();  // warpgroup 0 goes first
  {
    wait_tile(0);
    float s[BN / 2];
    turn();
    wgmma_fence();
    wgs.issue_qk(s, qw, stage(0));
    wgmma_commit();
    pass();
    wgmma_wait<0>();
    fence_regs(s);
    if (masked(0))
      wgs.template tile<false, true>(s, 0, S, causal, scale_log2);
    else
      wgs.template tile<false, false>(s, 0, S, causal, scale_log2);
    load_ahead(0);
  }
  for (int j = 1; j < n_kt; ++j) {
    if (j < n_w) {
      float s[BN / 2];
      wait_tile(j);
      turn();
      wgmma_fence();
      wgs.issue_qk(s, qw, stage(j));
      wgmma_commit();
      wgs.issue_pv(stage(j - 1) + kKV);
      wgmma_commit();
      pass();
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
      fence_regs(s);
      if (masked(j * BN))
        wgs.template tile<true, true>(s, j * BN, S, causal, scale_log2);
      else
        wgs.template tile<true, false>(s, j * BN, S, causal, scale_log2);
      release(j - 1);
    } else if (j == n_w) {  // this warpgroup's last P V
      turn();
      wgmma_fence();
      wgs.issue_pv(stage(j - 1) + kKV);
      wgmma_commit();
      pass();
      wgs.wait_pv();
      release(j - 1);
      release(j);
    } else {
      turn();
      pass();
      release(j);
    }
    load_ahead(j);
  }
  if (wg == 0) turn();  // takes warpgroup 1's last pass
  if (n_w == n_kt) {    // the last tile's P V
    wgmma_fence();
    wgs.issue_pv(stage(n_kt - 1) + kKV);
    wgmma_commit();
    wgs.wait_pv();
  }
  cp_async_wait_all();  // no copy of this thread outlives it

  float l0 = wgs.l0, l1 = wgs.l1;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int row0 = wgs.row0, col = wgs.col;
  if (row0 < S) {
    bf16* r = oh + row0 * st.os + col;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(r + 8 * i) =
          __floats2bfloat162_rn(wgs.o[4 * i] / d0, wgs.o[4 * i + 1] / d0);
  }
  if (row0 + 8 < S) {
    bf16* r = oh + (row0 + 8) * st.os + col;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(r + 8 * i) =
          __floats2bfloat162_rn(wgs.o[4 * i + 2] / d1, wgs.o[4 * i + 3] / d1);
  }
}

// ---------------------------------------------------------------- launch ----

template <int D>
static cudaError_t launch_tc(const void* q, const void* k, const void* v,
                             void* out, const Strides& st, int n_heads,
                             int KV, int G, int S, int causal,
                             cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static size_t granted = 0;  // one per instantiation
  cudaError_t err =
      allow_smem(flash_attention_wgmma_kernel<D>, smem, &granted);
  if (err != cudaSuccess) return err;
  const int n_qt = (S + kBM - 1) / kBM;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_attention_wgmma_kernel<D><<<n_heads * n_qt, kTC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), st, KV, G, S,
      n_qt, causal, scale_log2);
  return cudaGetLastError();
}

static cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                               void* out, const Strides& st, int n_heads,
                               int KV, int G, int S, int D, int causal,
                               cudaStream_t stream) {
  const size_t smem = fp32_smem_bytes(D);
  static size_t granted = 0;
  cudaError_t err = allow_smem(flash_attention_fp32_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_attention_fp32_kernel<<<n_heads * n_qt, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), st, KV, G, S, D,
      n_qt, causal, scale);
  return cudaGetLastError();
}

// Dynamic shared memory a launch of this mode and D requests (-1: no such
// instantiation); the Python plan holds its own figure against it.
extern "C" int flash_attention_smem_bytes(int dtype, int D) {
  if (dtype == kFloat32) return static_cast<int>(fp32_smem_bytes(D));
  if (dtype != kBFloat16) return -1;
  if (D == 32) return static_cast<int>(tc_smem_bytes<32>());
  if (D == 64) return static_cast<int>(tc_smem_bytes<64>());
  if (D == 128) return static_cast<int>(tc_smem_bytes<128>());
  return -1;
}

// q, out: (b, kv, g, s, d) rows; k, v: (b, kv, s, d) rows, through the 14
// element strides of `strides` (q b, kv, g, s; k b, kv, s; v b, kv, s;
// out b, kv, g, s), each a multiple of 16 bytes, the last dim contiguous.
// No allocation and no host synchronisation: capturable in a CUDA graph.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int KV,
                                      int G, int S, int D, int causal,
                                      const long long* strides,
                                      void* stream) {
  const Strides st{strides[0],  strides[1],  strides[2],  strides[3],
                   strides[4],  strides[5],  strides[6],  strides[7],
                   strides[8],  strides[9],  strides[10], strides[11],
                   strides[12], strides[13]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_heads = B * KV * G;
  if (dtype == kFloat32)
    return launch_fp32(q, k, v, out, st, n_heads, KV, G, S, D, causal, s);
  if (dtype == kBFloat16) {
    if (D == 32)
      return launch_tc<32>(q, k, v, out, st, n_heads, KV, G, S, causal, s);
    if (D == 64)
      return launch_tc<64>(q, k, v, out, st, n_heads, KV, G, S, causal, s);
    if (D == 128)
      return launch_tc<128>(q, k, v, out, st, n_heads, KV, G, S, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
