// Paged flash-decode for Hopper (sm_90a): one-token GQA attention per slot
// through a (B, M) page table, each slot's live pages split over the blocks
// of a thread-block cluster and merged in distributed shared memory.
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
// dead pages.  The Python wrappers, the launch plan (`plan`) and the plain
// PyTorch versions live in src/repro_torch/kernels/paged_decode.py.
//
// Layouts: q (B, KV, G, D); k/v pools (p_local, page, KV, D) with global
// page 0 the scratch page; int8 scales (p_local, page, KV); table (B, M)
// int32 of global ids; positions (B,) int32; out (B, KV, G, D); partials
// acc (B, KV, G, D), l and m (B, KV, G), all fp32.  A row is copied in
// 16-byte pieces, so D must be a multiple of 4 (fp32), 8 (bf16) or 16
// (int8) elements, and at most kMaxD.
//
// What bounds it.  Decode attention moves the live K/V bytes once and does
// ~2 flops per byte (~4 in the int8 mode, whose rows are half as wide): it
// is bound by memory, and at a served batch (a few MB of K/V, in L2) by
// latency: a block's fixed cost (listing, barriers, merge) is ~7 us on the
// H100.  The design keeps loads in flight on every SM and the instructions
// per row few.
//
// Grid.  A cluster of `splits` blocks per (slot, kv-head, group of GB query
// rows); the host picks `splits` (<= 8) from shapes and the SM count alone
// (`plan`), so a call needs no host sync and is graph capturable.  Each
// block lists, with one warp ballot per 32 table entries, the slot's live
// pages (logical page <= pos / page) that lie in the window, then takes the
// rank-th of `splits` equal ranges of that list: ceil(n / splits) pages,
// where n is the slot's live page count here, so a long slot spreads over
// every split and a short one costs one short block (the others hold the
// identity).  Dead pages and other shards' pages are never read; an
// inactive slot at position 0 reads one row of scratch page 0 on the shard
// that holds it.
//
// Block.  4 warps; each warp owns whole stages of R rows (every 4th stage
// of the block's range) and copies them itself with cp.async, 16 bytes a
// lane, into a ring of its own (`stages` in flight), so the main loop has
// no block barrier.  Rows past pos, and past the range, are zero-filled by
// the copy (never read) and masked.  In the int8 mode each row's two
// scales are copied through the same pool row as the row itself (a row and
// its scale never come from different pages, and a dead page's scales are
// never read).  Scores are kept in log2 units (q's scale folds in log2 e;
// MUFU.EX2).  Two ways to the math:
//  - tensor cores, for bf16 q with D a multiple of 16 up to 128: a stage is
//    16 rows (bf16 rows padded by 16 bytes, so ldmatrix meets no bank
//    conflict); S^T = K Q^T on mma.sync m16n8k16 with the rows as M and the
//    8 query rows of the block as N (G = 4 leaves half of N idle: decode
//    has flops to spare), K from ldmatrix, Q^T held in registers; the
//    online softmax on the accumulator fragments; P^T moved into B
//    fragments by movmatrix, as hi + lo bf16 terms (P keeps ~16 bits, so
//    the fp32 triples of the partials mode stay within 1e-4); O^T += V^T
//    P^T with V^T from ldmatrix.trans.  int8 rows are first turned into
//    bf16 (exact: |x| <= 127) in a buffer beside the ring, by integer
//    moves and one fp32 add each; the K scale multiplies the row's scores
//    and the V scale its probabilities, which equals the plain version's
//    `int8 -> fp32 * scale` up to rounding;
//  - CUDA cores, for fp32 q and any other D: a group of lanes holds one
//    row, 8 elements a lane, with the lane's slice of the GB query rows and
//    of the accumulator in registers: the GB query rows share every K/V
//    byte read, and each dot product reduces over the group with shuffles;
//    int8 elements are dequantized as they are read (`int8 -> fp32 *
//    scale`, the plain version's product exactly).  TF32 would break the
//    fp32 gates, so fp32 stays here.
//
// Merge.  All in fixed orders, so equal inputs give bitwise equal outputs:
// the warp's rows, the warps of a block through shared memory, then the
// cluster: once every block is done with its rings (a relaxed cluster
// barrier), each block but rank 0 stores its triple into rank 0's rings
// through distributed shared memory and arrives (release); rank 0 waits
// (acquire), merges the triples in rank order with the math of
// `merge_partials_local` (w = 2^(m - max m), sum acc * w, sum l * w), and
// writes: normalized, acc / max(l, 1e-30); with `partials`, the triple (m
// back in natural units), m starting at NEG_INF = -1e30, so a slot with no
// live row in the window gives exactly (0, 0, -1e30) and weighs 0 in the
// cross-shard merge.  One launch per call.
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kElems = 8;          // elements of a row a lane holds
constexpr int kMaxD = 256;         // 32 lanes of 8 elements
constexpr int kMaxMmaD = 128;      // 8 k-steps of the tensor-core path
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr int kMinBlocksPerSm = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// stages in flight per warp: 16 KB of bf16 rows at D = 128 (CUDA cores),
// a pair of 16-row tiles (tensor cores; a third gained nothing for int8)
__host__ __device__ constexpr int ring_stages(int psize, bool mma) {
  return mma || psize == 4 ? 2 : 4;
}
// rows a lane group takes per stage (CUDA cores): GB * rows score registers
__host__ __device__ constexpr int group_rows(int gb) {
  return gb == 8 ? 2 : 4;
}

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// The block's shape for pool elements of `psize` bytes (plan() in
// kernels/paged_decode.py computes the same figures).
struct Layout {
  int lpr;          // lanes holding a row's elements, ceil(D / 8)
  int lprp;         // lanes of a group: lpr rounded up to a power of two
  int rpw;          // groups (rows at a time) per warp, 32 / lprp
  int rows;         // R, rows of a stage
  int rg;           // rows a group takes per stage, R / rpw
  int row_bytes;    // D * psize
  int pitch;        // bytes between staged rows (tensor cores, bf16: +16)
  int stage_bytes;  // K rows, V rows, (int8) K and V scales, row mask
  int conv_bytes;   // (tensor cores, int8) a stage's K or V rows as bf16
  int warp_bytes;   // a warp's ring; then its (acc, l, m); then, in rank
                    // 0, the cluster's triples
  int blk_bytes;    // the block's merged (acc, l, m)
  int smem;         // 4 rings, the block's triple, the page lists
};

__host__ __device__ inline Layout make_layout(int psize, bool quant,
                                              bool mma, int GB, int D,
                                              int M) {
  Layout L;
  L.lpr = (D + kElems - 1) / kElems;
  L.lprp = 1;
  while (L.lprp < L.lpr) L.lprp <<= 1;
  L.rpw = 32 / L.lprp;
  const int gr = group_rows(GB);
  L.rows = mma ? 16 : gr * L.rpw < 32 ? gr * L.rpw : 32;
  L.rg = mma ? 1 : L.rows / L.rpw;
  L.row_bytes = D * psize;
  L.pitch = L.row_bytes + (mma && psize == 2 ? 16 : 0);
  L.stage_bytes = 2 * L.rows * L.pitch + (quant ? 8 * L.rows : 0) + 16;
  L.conv_bytes = mma && quant ? L.rows * (2 * D + 16) : 0;
  L.blk_bytes = align16(4 * (GB * D + 2 * GB));
  const int ring = ring_stages(psize, mma) * L.stage_bytes + L.conv_bytes;
  const int slots = align16((kMaxSplits * L.blk_bytes + kWarps - 1) / kWarps);
  L.warp_bytes = ring > slots ? ring : slots;
  L.smem = kWarps * L.warp_bytes + L.blk_bytes + 8 * M;
  return L;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* table;
  const int* pos;
  void* out;
  float* acc;
  float* l;
  float* m;
  int KV, G, D, page, M, page_offset, p_local, n_gb;
  float scale;      // log2(e) / sqrt(D): scores are kept in log2 units
  Layout L;
};

// 16 bytes global -> shared; `bytes` 0 zero-fills without reading.  These
// take a generic pointer into shared memory (ptx.cuh's take its address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 2^x (MUFU.EX2): the kernel keeps its scores in log2 units
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Element e (< 8) of lane li's slice of a row (CUDA cores): fp32 lanes
// hold two 16-byte pieces, li and li + lpr, so that 8 neighbouring lanes
// read 128 contiguous bytes; bf16 and int8 lanes hold 8 neighbouring
// elements.
template <typename P>
__device__ __forceinline__ int elem_d(int li, int lpr, int e) {
  if constexpr (sizeof(P) == 4) return 4 * (li + (e >> 2) * lpr) + (e & 3);
  return kElems * li + e;
}

// Lane li's 8 elements of a staged row as fp32 (0 past D).
__device__ __forceinline__ void read_row(const float* r, int li, int lpr,
                                         int D, float (&x)[kElems]) {
  const float4 a = *reinterpret_cast<const float4*>(r + 4 * li);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  if (4 * (li + lpr) < D) {
    const float4 b = *reinterpret_cast<const float4*>(r + 4 * (li + lpr));
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    x[4] = x[5] = x[6] = x[7] = 0.f;
  }
}
__device__ __forceinline__ void read_row(const __nv_bfloat16* r, int li,
                                         int, int, float (&x)[kElems]) {
  const uint4 u = *reinterpret_cast<const uint4*>(r + kElems * li);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void read_row(const int8_t* r, int li, int, int,
                                         float (&x)[kElems]) {
  const uint2 u = *reinterpret_cast<const uint2*>(r + kElems * li);
  const int8_t* e = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < kElems; ++i) x[i] = static_cast<float>(e[i]);
}

// Tensor cores (bf16 q): one m16n8k16 product, D += A B.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// the 8x8 b16 matrix held in fragment layout, transposed
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// x = hi + lo in two bf16 pairs: the product with an exact bf16 operand
// keeps ~16 bits of x, where one bf16 term keeps 8
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// Bytes j and j + 1 of four int8 as a bf16 pair, exactly and without a
// conversion instruction: 2^23 + (x + 128) is a float's bit pattern with
// the biased byte as its low bits, less 2^23 + 128 is x.
__device__ __forceinline__ uint32_t i8x2_bf16(int w, int j) {
  const uint32_t u = static_cast<uint32_t>(w) ^ 0x80808080u;
  const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j));
  const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + j));
  return pack_bf16(a - 8388736.f, b - 8388736.f);
}

// Cluster barriers: `relaxed` orders nothing (every block is past a point);
// the default arrive releases and the wait acquires the shared memory
// written before it, across the cluster.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// T: q and output; P: pool elements, T itself or int8_t (then with scales);
// kPartials: write the raw fp32 (acc, l, m) triple instead of acc / l;
// GB: query rows of a block (G <= GB, or G split over n_gb blocks); kMma:
// the tensor-core path (bf16 q, D a multiple of 16 up to kMaxMmaD, GB 8).
template <typename T, typename P, bool kPartials, int GB, bool kMma>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    paged_decode_split_kernel(const Params p) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kNs = ring_stages(sizeof(P), kMma);
  constexpr int kGr = group_rows(GB);
  // 16-byte pieces a lane copies per pool and stage
  constexpr int kChunks = kMma ? 4 * sizeof(P) : 2 * sizeof(P);
  constexpr int kVec = 16 / sizeof(P);
  constexpr int kQRows = kMma ? 1 : GB;        // CUDA-core state rows
  constexpr int kKSteps = kMma ? kMaxMmaD / 16 : 1;
  static_assert(!kMma || GB == 8, "the tensor-core path holds 8 rows");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_local_s;
  __shared__ float w_s[kMaxSplits][GB];    // the cluster merge's weights
  __shared__ float l_s[GB];

  const Layout& L = p.L;
  const int rank = static_cast<int>(blockIdx.x);    // cluster = grid x
  const int splits = static_cast<int>(gridDim.x);
  const int gb = blockIdx.y % p.n_gb;
  const int bh = blockIdx.y / p.n_gb;          // b * KV + h
  const int b = bh / p.KV, h = bh - b * p.KV;
  const int g0 = gb * GB;
  const int D = p.D, page = p.page;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / L.lprp, li = lane - grp * L.lprp;
  const bool lane_on = li < L.lpr;
  const int g4 = lane >> 2, c2 = (lane & 3) * 2;   // mma fragment lanes

  unsigned char* ring = smem + warp * L.warp_bytes;
  float* blk = reinterpret_cast<float*>(smem + kWarps * L.warp_bytes);
  int* ph_s = reinterpret_cast<int*>(smem + kWarps * L.warp_bytes +
                                     L.blk_bytes);
  int* nv_s = ph_s + p.M;

  // The slot's live pages that lie in this pool's window, in logical order
  // (warp 0, 32 table entries per ballot): local page id and live rows.
  // The table is read 256 entries at a time, the first batch beside the
  // position (not after it).
  if (warp == 0) {
    const int* row = p.table + static_cast<size_t>(b) * p.M;
    const int pos = p.pos[b];
    int cnt = 0;
    for (int j0 = 0;; j0 += 256) {
      int ids[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + 32 * u + lane;
        ids[u] = j < p.M ? row[j] : 0;
      }
      const int last = pos / page;
      const int n_live = min(last + 1, p.M);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + 32 * u + lane;
        const int loc = ids[u] - p.page_offset;
        const bool ok = j < n_live && loc >= 0 && loc < p.p_local;
        const unsigned mask = __ballot_sync(0xffffffffu, ok);
        if (ok) {
          const int idx = cnt + __popc(mask & ((1u << lane) - 1u));
          ph_s[idx] = loc;
          nv_s[idx] = j == last ? pos - last * page + 1 : page;
        }
        cnt += __popc(mask);
      }
      if (j0 + 256 >= n_live) break;
    }
    if (lane == 0) n_local_s = cnt;
  }

  const T* qp = static_cast<const T*>(p.q) +
                (static_cast<size_t>(bh) * p.G + g0) * D;
  // CUDA cores: q pre-scaled in the lane's slice (0 past D and past G), the
  // lane's slice of the accumulator, the group's running max and sum
  float qr[kQRows][kElems], acc[kQRows][kElems];
  float m_run[kMma ? 2 : GB], l_run[kMma ? 2 : GB];
  // tensor cores: Q^T as B fragments (query rows g4, 0 past G), the O^T
  // accumulator fragments, running max and sum of query rows c2, c2 + 1
  uint32_t qb[kKSteps][2];
  float o[kKSteps][4];
  if constexpr (kMma) {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const bool on = kk * 16 < D && g0 + g4 < p.G;
      const T* qr_ = qp + g4 * D + kk * 16 + c2;
      qb[kk][0] = on ? *reinterpret_cast<const uint32_t*>(qr_) : 0u;
      qb[kk][1] = on ? *reinterpret_cast<const uint32_t*>(qr_ + 8) : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) o[kk][i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m_run[j] = REPRO_NEG_INF;
      l_run[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      m_run[g] = REPRO_NEG_INF;
      l_run[g] = 0.f;
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const int d = elem_d<P>(li, L.lpr, e);
        qr[g][e] = lane_on && d < D && g0 + g < p.G
                       ? to_f32(qp[g * D + d]) * p.scale
                       : 0.f;
        acc[g][e] = 0.f;
      }
    }
  }
  __syncthreads();

  // this block's range: rows [row0, row_end) of the listed pages
  const int n = n_local_s;
  const int per = (n + splits - 1) / splits;
  const int lo = min(n, rank * per), hi = min(n, lo + per);
  const int row0 = lo * page, row_end = hi * page;
  const int R = L.rows;            // rows of a stage
  const int n_stages = (row_end - row0 + R - 1) / R;
  const int my_stages = warp < n_stages
                            ? (n_stages - warp + kWarps - 1) / kWarps
                            : 0;

  // the lane's pieces of a stage's K (and V) rows: row t, byte offset c
  const int c16 = L.row_bytes / 16;
  int ct[kChunks], cc[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int i = lane + 32 * j;
    ct[j] = i < R * c16 ? i / c16 : -1;
    cc[j] = i < R * c16 ? i - (i / c16) * c16 : 0;
  }
  const P* k_pool = static_cast<const P*>(p.k);
  const P* v_pool = static_cast<const P*>(p.v);
  const size_t row_stride = static_cast<size_t>(p.KV) * D;
  const int mask_off = L.stage_bytes - 16;
  const int scale_off = 2 * R * L.pitch;

  // the warp's k-th stage (block stage warp + 4k) into ring slot k % kNs
  auto issue = [&](int k) {
    unsigned char* st = ring + (k % kNs) * L.stage_bytes;
    const int vr = row0 + (warp + k * kWarps) * R + lane;
    int ro = -1;                 // pool row of stage row `lane`, -1 masked
    if (lane < R && vr < row_end) {
      const int idx = vr / page, rr = vr - idx * page;
      if (rr < nv_s[idx]) ro = ph_s[idx] * page + rr;
    }
    const unsigned live = __ballot_sync(0xffffffffu, ro >= 0);
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int r = __shfl_sync(0xffffffffu, ro, ct[j] < 0 ? 0 : ct[j]);
      if (ct[j] >= 0) {
        const size_t off = (r >= 0 ? static_cast<size_t>(r) : 0) * row_stride +
                           static_cast<size_t>(h) * D + cc[j] * kVec;
        const int dst = ct[j] * L.pitch + cc[j] * 16;
        const int bytes = r >= 0 ? 16 : 0;
        cp_async16(st + dst, k_pool + off, bytes);
        cp_async16(st + R * L.pitch + dst, v_pool + off, bytes);
      }
    }
    if constexpr (kQuant) {
      if (lane < R) {
        const size_t si = (ro >= 0 ? static_cast<size_t>(ro) : 0) * p.KV + h;
        float* sc = reinterpret_cast<float*>(st + scale_off);
        cp_async4(sc + lane, p.ks + si, ro >= 0 ? 4 : 0);
        cp_async4(sc + R + lane, p.vs + si, ro >= 0 ? 4 : 0);
      }
    }
    if (lane == 0) *reinterpret_cast<unsigned*>(st + mask_off) = live;
  };

#pragma unroll
  for (int k = 0; k < kNs; ++k) {
    if (k < my_stages) issue(k);
    cp_async_commit();
  }
  for (int k = 0; k < my_stages; ++k) {
    cp_async_wait<kNs - 1>();
    __syncwarp();
    const unsigned char* st = ring + (k % kNs) * L.stage_bytes;
    const unsigned live = *reinterpret_cast<const unsigned*>(st + mask_off);
    const float* sc = reinterpret_cast<const float*>(st + scale_off);
    if constexpr (kMma) {
      // 16 rows: S^T = K Q^T (rows x query rows), then O^T += V^T P^T
      const unsigned char* kb = st;
      const unsigned char* vb = st + R * L.pitch;
      int pitch = L.pitch;
      // int8 -> bf16 (exact) of the stage's K (kv 0) or V (kv 1) rows into
      // the warp's conversion buffer, which K and V take in turn
      unsigned char* cv = ring + kNs * L.stage_bytes;
      const int cpitch = 2 * D + 16;
      auto convert = [&](int kv) {
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          if (ct[j] < 0) continue;
          const int4 u = *reinterpret_cast<const int4*>(
              st + kv * R * L.pitch + ct[j] * L.pitch + cc[j] * 16);
          uint4* dst = reinterpret_cast<uint4*>(cv + ct[j] * cpitch +
                                                cc[j] * 32);
          dst[0] = make_uint4(i8x2_bf16(u.x, 0), i8x2_bf16(u.x, 2),
                              i8x2_bf16(u.y, 0), i8x2_bf16(u.y, 2));
          dst[1] = make_uint4(i8x2_bf16(u.z, 0), i8x2_bf16(u.z, 2),
                              i8x2_bf16(u.w, 0), i8x2_bf16(u.w, 2));
        }
        __syncwarp();
      };
      if constexpr (kQuant) {
        convert(0);
        kb = vb = cv;
        pitch = cpitch;
      }
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const uint32_t ka = smem_u32(kb) + (lane & 15) * pitch + (lane >> 4) * 16;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        if (kk * 16 < D) {
          uint32_t a[4];
          ldsm_x4(ka + kk * 32, a);
          mma_bf16(s, a[0], a[1], a[2], a[3], qb[kk][0], qb[kk][1]);
        }
      }
      // rows g4 and g4 + 8, query rows c2 and c2 + 1
      const bool v0 = (live >> g4) & 1u, v1 = (live >> (g4 + 8)) & 1u;
      const float k0 = kQuant ? sc[g4] * p.scale : p.scale;
      const float k1 = kQuant ? sc[g4 + 8] * p.scale : p.scale;
      s[0] = v0 ? s[0] * k0 : REPRO_NEG_INF;
      s[1] = v0 ? s[1] * k0 : REPRO_NEG_INF;
      s[2] = v1 ? s[2] * k1 : REPRO_NEG_INF;
      s[3] = v1 ? s[3] * k1 : REPRO_NEG_INF;
      float corr[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = fmaxf(s[j], s[2 + j]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[j], mx);
        corr[j] = ex2(m_run[j] - m_new);
        s[j] = v0 ? ex2(s[j] - m_new) : 0.f;
        s[2 + j] = v1 ? ex2(s[2 + j] - m_new) : 0.f;
        l_run[j] = l_run[j] * corr[j] + (s[j] + s[2 + j]);
        m_run[j] = m_new;
      }
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        o[kk][0] *= corr[0];
        o[kk][1] *= corr[1];
        o[kk][2] *= corr[0];
        o[kk][3] *= corr[1];
      }
      if constexpr (kQuant) {          // P V = (P * v_scale) V_int8
        const float w0 = sc[R + g4], w1 = sc[R + g4 + 8];
        s[0] *= w0; s[1] *= w0; s[2] *= w1; s[3] *= w1;
      }
      uint32_t h0, l0, h1, l1;
      split_bf16(s[0], s[1], h0, l0);        // rows 0-7 (P, row-major)
      split_bf16(s[2], s[3], h1, l1);        // rows 8-15
      const uint32_t bh0 = movmatrix_trans(h0), bh1 = movmatrix_trans(h1);
      const uint32_t bl0 = movmatrix_trans(l0), bl1 = movmatrix_trans(l1);
      if constexpr (kQuant) convert(1);
      const uint32_t va = smem_u32(vb) +
                          ((lane & 7) + (lane >> 4) * 8) * pitch +
                          ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        if (kk * 16 < D) {
          uint32_t a[4];
          ldsm_x4_trans(va + kk * 32, a);
          mma_bf16(o[kk], a[0], a[1], a[2], a[3], bh0, bh1);
          mma_bf16(o[kk], a[0], a[1], a[2], a[3], bl0, bl1);
        }
      }
    } else {
      const P* krows = reinterpret_cast<const P*>(st);
      const P* vrows = reinterpret_cast<const P*>(st + R * L.pitch);
      float s[kGr][GB];
      bool valid[kGr];
#pragma unroll
      for (int j = 0; j < kGr; ++j) {
        const int t = grp + j * L.rpw;
        valid[j] = j < L.rg && ((live >> t) & 1u);
        float kx[kElems];
        if (j < L.rg && lane_on) {
          read_row(krows + t * D, li, L.lpr, D, kx);
          if constexpr (kQuant) {
            const float ksc = sc[t];
#pragma unroll
            for (int e = 0; e < kElems; ++e) kx[e] *= ksc;
          }
        } else {
#pragma unroll
          for (int e = 0; e < kElems; ++e) kx[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < kElems; ++e) dot += qr[g][e] * kx[e];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            if (off < L.lprp) dot += __shfl_xor_sync(0xffffffffu, dot, off);
          s[j][g] = valid[j] ? dot : REPRO_NEG_INF;
        }
      }
      // online softmax, once per stage; a masked row weighs exactly 0
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float mx = s[0][g];
#pragma unroll
        for (int j = 1; j < kGr; ++j) mx = fmaxf(mx, s[j][g]);
        const float m_new = fmaxf(m_run[g], mx);
        const float corr = ex2(m_run[g] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kGr; ++j) {
          s[j][g] = valid[j] ? ex2(s[j][g] - m_new) : 0.f;
          sum += s[j][g];
        }
        l_run[g] = l_run[g] * corr + sum;
        m_run[g] = m_new;
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int j = 0; j < kGr; ++j) {
        if (j < L.rg && lane_on) {
          const int t = grp + j * L.rpw;
          float vx[kElems];
          read_row(vrows + t * D, li, L.lpr, D, vx);
          if constexpr (kQuant) {
            const float vsc = sc[R + t];
#pragma unroll
            for (int e = 0; e < kElems; ++e) vx[e] *= vsc;
          }
#pragma unroll
          for (int g = 0; g < GB; ++g)
#pragma unroll
            for (int e = 0; e < kElems; ++e) acc[g][e] += s[j][g] * vx[e];
        }
      }
    }
    __syncwarp();
    if (k + kNs < my_stages) issue(k + kNs);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warp's triple into its own ring: acc (GB, D), l (GB), m (GB)
  float* wt = reinterpret_cast<float*>(ring);
  if constexpr (kMma) {
    // sum the rows' partial l over the 8 lanes of each query row pair
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], off);
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      if (kk * 16 < D) {
        const int d = kk * 16 + g4;
        wt[c2 * D + d] = o[kk][0];
        wt[(c2 + 1) * D + d] = o[kk][1];
        wt[c2 * D + d + 8] = o[kk][2];
        wt[(c2 + 1) * D + d + 8] = o[kk][3];
      }
    }
    if (g4 == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wt[GB * D + c2 + j] = l_run[j];
        wt[GB * D + GB + c2 + j] = m_run[j];
      }
    }
  } else {
    // merge the warp's groups (lanes lprp apart hold the same elements)
    for (int off = L.lprp; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m_run[g], off);
        const float lo_ = __shfl_xor_sync(0xffffffffu, l_run[g], off);
        const float mm = fmaxf(m_run[g], mo);
        const float w = ex2(m_run[g] - mm), wo = ex2(mo - mm);
        l_run[g] = l_run[g] * w + lo_ * wo;
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
          acc[g][e] = acc[g][e] * w + ao * wo;
        }
        m_run[g] = mm;
      }
    }
    if (grp == 0 && lane_on) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          const int d = elem_d<P>(li, L.lpr, e);
          if (d < D) wt[g * D + d] = acc[g][e];
        }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        wt[GB * D + g] = l_run[g];
        wt[GB * D + GB + g] = m_run[g];
      }
    }
  }
  __syncthreads();
  // the block's triple: its warps merged in order
  const int n_blk = GB * D + 2 * GB;
  for (int i = tid; i < GB * D + GB; i += kThreads) {
    const int g = i < GB * D ? i / D : i - GB * D;
    if (g0 + g >= p.G) continue;   // padding rows of the tensor cores
    float mm = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wt_w = reinterpret_cast<const float*>(smem + w * L.warp_bytes);
      mm = fmaxf(mm, wt_w[GB * D + GB + g]);
    }
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wt_w = reinterpret_cast<const float*>(smem + w * L.warp_bytes);
      sum += wt_w[i] * ex2(wt_w[GB * D + GB + g] - mm);
    }
    blk[i] = sum;                      // acc, then l
    if (i >= GB * D) blk[GB * D + GB + g] = mm;
  }
  __syncthreads();

  // The cluster's triple.  Once every block is done with its rings, each
  // block but rank 0 stores its triple into rank 0's rings (slot = rank)
  // and leaves; rank 0 merges the slots in rank order and writes.  A slot
  // with at most one page here has it all in rank 0 (the others hold the
  // identity, which weighs 0): every block of the cluster knows n, so they
  // all skip the exchange.
  const int parts = n <= 1 ? 1 : splits;
  float* slots = reinterpret_cast<float*>(smem);
  const int slot_floats = L.blk_bytes / 4;
  if (parts > 1) {
    cluster_arrive_relaxed();
    cluster_wait();                 // every block started and done with its
                                    // rings
    if (rank != 0) {
      float* dst = cg::this_cluster().map_shared_rank(slots, 0) +
                   rank * slot_floats;
      for (int i = tid; i < n_blk; i += kThreads)
        if (i >= GB * D || g0 + i / D < p.G) dst[i] = blk[i];
      cluster_arrive();             // release the stores to rank 0
      return;
    }
    cluster_arrive();
    cluster_wait();                 // every peer's triple is in the slots
  } else if (rank != 0) {
    return;
  }
  auto part = [&](int r) -> const float* {
    return r == 0 ? blk : slots + r * slot_floats;
  };
  if (tid < GB && g0 + tid < p.G) {
    float mm = REPRO_NEG_INF;
    for (int r = 0; r < parts; ++r) mm = fmaxf(mm, part(r)[GB * D + GB + tid]);
    float lsum = 0.f;
    for (int r = 0; r < parts; ++r) {
      const float w = ex2(part(r)[GB * D + GB + tid] - mm);
      w_s[r][tid] = w;
      lsum += part(r)[GB * D + tid] * w;
    }
    l_s[tid] = lsum;
    if (kPartials) {
      const size_t lo_i = static_cast<size_t>(bh) * p.G + g0 + tid;
      p.l[lo_i] = lsum;
      p.m[lo_i] = mm <= REPRO_NEG_INF ? REPRO_NEG_INF : mm * kLn2;
    }
  }
  __syncthreads();
  for (int i = tid; i < GB * D; i += kThreads) {
    const int g = i / D;
    if (g0 + g >= p.G) break;
    float sum = 0.f;
    for (int r = 0; r < parts; ++r) sum += part(r)[i] * w_s[r][g];
    const size_t oi = (static_cast<size_t>(bh) * p.G + g0) * D + i;
    if constexpr (kPartials)
      p.acc[oi] = sum;
    else
      static_cast<T*>(p.out)[oi] = from_f32<T>(sum / fmaxf(l_s[g], 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *table, *pos;
  void *out, *acc, *l, *m;
  int B, KV, G, D, page, M, page_offset, p_local, splits;
};

template <typename T, typename P, bool kPartials, int GB, bool kMma>
static cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n_gb = (a.G + GB - 1) / GB;
  if (a.D % (16 / sizeof(P)) || a.D < 1 || a.D > kMaxD || a.M < 1 ||
      a.p_local < 1 || a.page < 1 || a.splits < 1 || a.splits > kMaxSplits ||
      static_cast<long long>(a.B) * a.KV * n_gb > 65535)
    return cudaErrorInvalidValue;
  const Layout L = make_layout(sizeof(P), std::is_same<P, int8_t>::value,
                               kMma, GB, a.D, a.M);
  auto kernel = paged_decode_split_kernel<T, P, kPartials, GB, kMma>;
  static size_t granted = 0;  // one per instantiation
  cudaError_t err = allow_smem(kernel, L.smem, &granted);
  if (err != cudaSuccess) return err;
  Params prm{a.q, a.k, a.v, static_cast<const float*>(a.ks),
             static_cast<const float*>(a.vs), static_cast<const int*>(a.table),
             static_cast<const int*>(a.pos), a.out,
             static_cast<float*>(a.acc), static_cast<float*>(a.l),
             static_cast<float*>(a.m), a.KV, a.G, a.D, a.page, a.M,
             a.page_offset, a.p_local, n_gb,
             kLog2e / sqrtf(static_cast<float>(a.D)), L};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.B * a.KV * n_gb, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, prm);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// bf16 q with D a multiple of 16 up to kMaxMmaD: the tensor cores (8 query
// rows a block); otherwise the CUDA cores (4 or 8 a block)
inline bool use_mma(int dtype, int D) {
  return dtype == kBFloat16 && D % 16 == 0 && D <= kMaxMmaD;
}
inline int group_of(int dtype, int G, int D) {
  return use_mma(dtype, D) || G > 4 ? 8 : 4;
}

template <typename T, typename P, bool kPartials>
static cudaError_t by_groups(const Args& a, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (use_mma(kBFloat16, a.D)) return launch<T, P, kPartials, 8, true>(a, s);
  return group_of(kFloat32, a.G, a.D) == 4
             ? launch<T, P, kPartials, 4, false>(a, s)
             : launch<T, P, kPartials, 8, false>(a, s);
}

template <typename T>
static cudaError_t dispatch(int quant, int partials, const Args& a,
                            cudaStream_t s) {
  if (quant)
    return partials ? by_groups<T, int8_t, true>(a, s)
                    : by_groups<T, int8_t, false>(a, s);
  return partials ? by_groups<T, T, true>(a, s) : by_groups<T, T, false>(a, s);
}

// Dynamic shared memory of a launch (plan() in kernels/paged_decode.py
// states the same figure): q of `dtype` (0 fp32, 1 bf16), pools of q's
// dtype or, with `quant`, int8; -1 for what the kernel does not take.
extern "C" int paged_decode_smem_bytes(int dtype, int quant, int G, int D,
                                       int M) {
  if (G < 1 || D < 1 || D > kMaxD || M < 1) return -1;
  const int psize = quant ? 1 : dtype == kFloat32 ? 4 : 2;
  return make_layout(psize, quant != 0, use_mma(dtype, D),
                     group_of(dtype, G, D), D, M)
      .smem;
}

// Every mode of K1.  `dtype` is q's (and, normalized, out's); `quant`: int8
// pools with (P, page, KV) fp32 scales `ks`/`vs`, else pools of q's dtype;
// `partials`: write fp32 acc (B, KV, G, D), l and m (B, KV, G), else `out`.
// The pool holds `p_local` pages whose first has global id `page_offset`;
// table entries outside that window are skipped like dead pages.  `splits`
// (1..8, plan()) blocks of one cluster share each slot's pages.  Pointers a
// mode does not use may be null.
extern "C" int paged_decode_launch(int dtype, int quant, int partials,
                                   const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, const void* table,
                                   const void* pos, void* out, void* acc,
                                   void* l, void* m, int B, int KV, int G,
                                   int D, int page, int M, int page_offset,
                                   int p_local, int splits, void* stream) {
  const Args a{q, k,  v, ks, vs,   table, pos,         out,     acc, l,
               m, B, KV, G,  D, page,  M,   page_offset, p_local, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch<float>(quant, partials, a, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(quant, partials, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
