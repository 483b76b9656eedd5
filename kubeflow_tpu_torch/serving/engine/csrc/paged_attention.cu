// Paged decode attention for Hopper (sm_90a), C ABI for ctypes.
//
// Replaces the TPU kernel kubeflow_tpu/serving/engine/paged_attention.py:58
// (_kernel, launched by _call_kernel through pl.pallas_call at :148):
// attention of K query tokens per slot straight over one layer's KV page
// pool, without first gathering each slot's pages into a contiguous cache.
//
// Semantics, identical to the TPU kernel:
//   * pool layout [P, Hkv, ps, hd]: one (page, kv head) tile is ps*hd
//     contiguous elements; pools are f32, bf16, or int8 with a bf16 scale
//     per (page, head, token) ([P, Hkv, ps, 1]), dequantized here;
//   * GQA: kv head h serves the K*group query rows that share it, row
//     r = (draft r / group, query head h*group + r % group);
//   * row r sees positions < seq_len + r / group; pages at or past the
//     furthest horizon seq_len + K - 1 are skipped, the walk bounded by
//     max_pages;
//   * online softmax in f32 from m = NEG_INF (-1e9, finite), l = 0,
//     acc = 0, output acc / max(l, 1e-30) in q's type.  So an idle K=1 slot
//     (seq_len 0) visits no page and returns zeros, and a K>1 row that sees
//     no position of the pages it visits averages V over those positions.
//
// What bounds it on the H100: device-memory bytes.  Each visited page's K
// and V tiles are read once (8 KB each in bf16 at ps=32, hd=128) for ~1
// FLOP per byte, far below the card's ~295 FLOP/byte ridge.  At the
// Llama-3-8B decode shapes of chip_smoke.py phase 3 (B=8, one 2048-token
// slot) the bound is 18 MB of pages, 5.4 us at 3.35 TB/s.
//
// Design: split-K, the merge folded into the same launch through a
// thread-block cluster: ONE device kernel per call.
//   * Split.  Each slot's page walk is cut into chunks of pages_per_split
//     pages, one block per (chunk, kv head [x row tile], slot), so the
//     2048-token slot is walked by many SMs at once instead of by one
//     block per (slot, head).  The split is chosen on the host from the
//     shapes only (paged_attention.py _split_plan), never from seq_lens,
//     which would cost a device->host sync per layer, and it is capped at
//     16 chunks (the largest cluster the card takes).
//   * Cluster.  The chunks of one (slot, kv head, row tile) are the blocks
//     of one cluster (cudaLaunchKernelEx, cluster dimension (splits, 1,
//     1); sizes above 8 need cudaFuncAttributeNonPortableClusterSizeAllowed).
//     Each block owns a share of the hd output columns and keeps, in its
//     shared memory, a slot per chunk for those columns' partials.
//   * Push.  Once its walk is done a block writes its partial (m, l, acc)
//     in f32 straight into the owners' shared memory through distributed
//     shared memory (map_shared_rank): m and l of every row to every block,
//     each acc column to its owner.  m and l stay raw: in f32 -1e9 + log(l)
//     rounds to -1e9, so an lse would lose the counts that give an unseeing
//     row its uniform V average.  A block whose chunk starts at or past its
//     slot's horizon visits no page and pushes nothing, but still takes
//     part in the cluster's barriers.  Stores to another block's memory
//     need no round trip, where loads from it would wait on one each.
//   * Fold.  After a cluster barrier (release / acquire) every block folds
//     its own columns from its own shared memory: out = sum exp(m_i - M)
//     acc_i / max(sum exp(m_i - M) l_i, 1e-30) over the live chunks, zeros
//     for a slot with none (the rule of the former merge kernel).  No
//     partial touches device memory, and no block reads another's memory.
//   * Loads.  A 3-stage ring of (K tile, V tile, int8 scales) in shared
//     memory, filled with 16-byte cp.async copies (8 bf16 or 16 int8 per
//     copy); page j+2 is in flight while page j is computed, one barrier
//     per page.  Rows are padded by 16 bytes so the fragment loads below
//     are free of bank conflicts (an odd number of 16-byte units at hd 64,
//     128 and 192).
//   * Scores on the tensor cores, mma.sync.m16n8k16 bf16 -> f32, at hd 64,
//     128 and 192 (192: the Gemma-7B width of the served pipeline model).
//     The block's rows (K*group: 4 at K=1, 20 at K=5) pad one or two m16
//     tiles (always one at hd 192, where two would not fit the registers);
//     the q fragments are loaded from device memory into registers once.
//     The unscaled q.k is multiplied in f32 by hd**-0.5 (and by k_scale[t]
//     for int8): scaling q to bf16 first would round it off the plain
//     version.  int8 -> bf16 is exact for -128..127.  Every warp computes
//     the whole page's scores and the same softmax, so no warp waits on
//     another; the warps split the hd columns of P.V.
//   * Softmax in registers: the mask per row, row max and sum across the
//     mma quad with __shfl_xor_sync.
//   * P.V on the tensor cores, P as two bf16 terms hi = bf16(p) and
//     lo = bf16(p - hi) (p * v_scale[t] for int8; the sum l stays f32 from
//     the unscaled p), so the output stays within one bf16 ulp of the f32
//     plain version.  V fragments come from ldmatrix.trans (bf16) or from
//     2-byte loads of an hd-permuted column order (int8).
//   * Other inputs (f32 q or pool, which only the tests use, or an hd or
//     page size outside the tensor-core instantiations) take the same
//     split and cluster fold with CUDA-core FMAs over f32 tiles in shared
//     memory.
// Measured by chip_smoke.py phase 3 on an H100 80GB HBM3 at 700 W (bf16,
// K=1, the shapes above; PERF.md): one kernel of 0.021-0.023 ms of device
// time, 0.027-0.035 ms on CUDA events, against SDPA's 0.05 ms over the
// gathered cache; the split and merge kernels it replaced took 0.020 ms of
// device time (0.016 + 0.004) and 0.03 ms on events.  A cluster is placed
// whole, so the card holds fewer blocks at once (45 clusters of 8, 360
// blocks, where 396 loose ones fit), and the fold's shared memory and the
// registers hold an SM to 3 blocks where the split kernel held 4: a grid
// near one round of the old capacity now takes two (paged_sweep.py).  At hd 192
// (16/16 heads) 0.045-0.049 ms of device time against SDPA's 0.107 (the
// CUDA-core kernel before: 0.1345).  The first version, one block per
// (slot, head) walking its pages in series, took 0.505-0.587 ms.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
// chunks per (slot, kv head, row tile): the largest cluster the card
// launches (above 8 only as a non-portable size)
constexpr int kMaxSplits = 16;
constexpr int kPortableCluster = 8;
// returned when no cluster of the requested size fits the card's SMs
constexpr int kErrClusterDoesNotFit = 100000;

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b, one m16n8k16 tile, bf16 inputs, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, `lo` in the low half (the smaller column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bytes i and j of w, as signed int8 values, -> bf16x2 (exact)
__device__ __forceinline__ uint32_t i8x2_bf16(uint64_t w, int i, int j) {
  return pack_bf16(static_cast<float>(static_cast<int8_t>(w >> (8 * i))),
                   static_cast<float>(static_cast<int8_t>(w >> (8 * j))));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Pages slot b walks: min(max_pages, ceil((seq_len + K - 1) / ps)).
__device__ __forceinline__ int pages_to_visit(int seq_len, int K, int ps, int max_pages) {
  return min(max_pages, (seq_len + K - 1 + ps - 1) / ps);
}

// The output columns each block of a cluster of `splits` folds.
__host__ __device__ constexpr int fold_cols(int hd, int splits) { return (hd + splits - 1) / splits; }

// Floats of the fold's shared memory in each block, for `rows` query rows
// (the block's, padded) and a cluster of `splits`: the partials the
// cluster's chunks push for this block's columns (acc [splits][rows][cols],
// m and l [splits][rows]), then the weights [rows][kMaxSplits] and each
// row's denominator.
__host__ __device__ constexpr int fold_floats(int rows, int hd, int splits) {
  return splits * rows * fold_cols(hd, splits) + 2 * splits * rows + rows * (kMaxSplits + 1);
}

// ------------------------------------------------------------ cluster fold

// The clusters' barriers, in PTX: a relaxed arrive at the start of the
// kernel and its wait before the first write to another block's shared
// memory (every block of the cluster has started), then a release arrive
// and an acquire wait once the partials are pushed.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The fold's shared memory in a block (fold_floats); the *_at accessors
// address the same place in the block that owns column c (rank c / cols).
struct Fold {
  float* acc;  // [splits][rows][cols]
  float* m;    // [splits][rows]
  float* l;    // [splits][rows]
  float* w;    // [rows][kMaxSplits]
  float* den;  // [rows]
  int rows, cols;
  __device__ Fold(float* base, int rows_, int hd, int splits) : rows(rows_), cols(fold_cols(hd, splits)) {
    acc = base;
    m = acc + splits * rows * cols;
    l = m + splits * rows;
    w = l + splits * rows;
    den = w + rows * kMaxSplits;
  }
  // chunk `src`'s value of (row r, column c) in the fold of c's owner
  __device__ float* acc_at(int owner, int src, int r, int c) const {
    return cg::this_cluster().map_shared_rank(acc + (src * rows + r) * cols + c - owner * cols, owner);
  }
  __device__ float* m_at(int owner, int src, int r) const {
    return cg::this_cluster().map_shared_rank(m + src * rows + r, owner);
  }
  __device__ float* l_at(int owner, int src, int r) const {
    return cg::this_cluster().map_shared_rank(l + src * rows + r, owner);
  }
};

// This block's share of the fold, once every live chunk has pushed its
// partial: out = sum exp(m_i - M) acc_i / max(sum exp(m_i - M) l_i,
// 1e-30) over the `live` chunks for the block's columns and the rows
// [row_base, row_base + nrows); zeros for a slot with no live chunk.
// Reads this block's shared memory only.
template <typename QT>
__device__ void fold_local(const Fold& f, int nrows, int live, int row_base,
                           QT* __restrict__ out, int b, int K, int Hq, int h, int group, int hd) {
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * f.cols;
  const int nc = min(hd, c0 + f.cols) - c0;
  for (int r = tid; r < nrows; r += kThreads) {
    float M = kNegInf;
    for (int s = 0; s < live; ++s) M = fmaxf(M, f.m[s * f.rows + r]);
    float den = 0.f;
    for (int s = 0; s < live; ++s) {
      const float w = expf(f.m[s * f.rows + r] - M);
      f.w[r * kMaxSplits + s] = w;
      den = fmaf(w, f.l[s * f.rows + r], den);
    }
    f.den[r] = den;
  }
  __syncthreads();
  for (int i = tid; i < nrows * max(nc, 0); i += kThreads) {
    const int r = i / nc, cc = i % nc;
    float num = 0.f;
    for (int s = 0; s < live; ++s)
      num = fmaf(f.w[r * kMaxSplits + s], f.acc[(s * f.rows + r) * f.cols + cc], num);
    const int row = row_base + r;
    const int hq = h * group + row % group;
    store(out + ((static_cast<size_t>(b) * K + row / group) * Hq + hq) * hd + c0 + cc,
          live > 0 ? num / fmaxf(f.den[r], 1e-30f) : 0.f);
  }
}

// ------------------------------------------------- tensor-core split kernel

template <typename KT, int HD, int PS, int MT>
struct TcLayout {
  static constexpr bool kInt8 = sizeof(KT) == 1;
  static constexpr int kRowB = HD * static_cast<int>(sizeof(KT)) + 16;  // padded smem row
  static constexpr int kTileB = PS * kRowB;
  static constexpr int kScaleB = kInt8 ? 2 * PS * 2 : 0;  // k and v scales, bf16
  static constexpr int kStageB = 2 * kTileB + kScaleB;
  static constexpr int kRingB = kStages * kStageB;  // + the fold, then the chunk's page ids
};

// The tensor-core kernel's dynamic shared memory: ring, fold, page ids.
template <typename KT, int HD, int PS, int MT>
__host__ __device__ constexpr size_t tc_smem_bytes(int splits, int pps) {
  return TcLayout<KT, HD, PS, MT>::kRingB +
         sizeof(float) * static_cast<size_t>(fold_floats(16 * MT, HD, splits)) +
         sizeof(int) * static_cast<size_t>(pps);
}

// q bf16 [B, K, Hq, HD]; pools KT [P, Hkv, PS, HD] (bf16, or int8 with bf16
// scales [P, Hkv, PS]).  Grid (splits, Hkv * row tiles, B) in clusters of
// (splits, 1, 1); MT m16 tiles of query rows per block.  Writes out bf16
// [B, K, Hq, HD].
template <typename KT, int HD, int PS, int MT>
__global__ void __launch_bounds__(kThreads) paged_split_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out, int K, int Hq,
    int Hkv, int max_pages, int pps, float scale) {
  using L = TcLayout<KT, HD, PS, MT>;
  constexpr bool kInt8 = L::kInt8;
  constexpr int kNT = PS / 8;          // 8-token n tiles of a page's scores
  constexpr int kKS = HD / 16;         // k steps of q.k
  constexpr int kWD = HD / kWarps;     // hd columns of P.V per warp
  constexpr int kNJ = kWD / 8;         // ... in n8 tiles
  static_assert(PS % 16 == 0 && HD % 64 == 0 && kNJ % 2 == 0, "unsupported tile");

  const int split = blockIdx.x;
  const int rtiles = gridDim.y / Hkv;
  const int h = blockIdx.y / rtiles;
  const int row_base = (blockIdx.y % rtiles) * 16 * MT;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int rows = K * group;
  const int seq_len = seq_lens[b];
  const int visit = pages_to_visit(seq_len, K, PS, max_pages);
  const int j0 = split * pps;
  // a chunk that starts at or past the horizon visits nothing and pushes
  // nothing, but every block of the cluster takes part in its barriers
  const int np = max(0, min(j0 + pps, visit) - j0);

  const int splits = gridDim.x;
  const int live = (visit + pps - 1) / pps;  // the chunks that hold a visited page
  extern __shared__ __align__(128) unsigned char smem[];
  const Fold fold(reinterpret_cast<float*>(smem + L::kRingB), 16 * MT, HD, splits);
  int* pid_s = reinterpret_cast<int*>(fold.den + 16 * MT);
  const int tid = threadIdx.x;
  cluster_arrive_relaxed();  // this block has started (waited on before the push)
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;

  // q fragments (m16n8k16 A layout), loaded before the page ids so the two
  // loads' latencies overlap.  For int8 the k order within each
  // 16-wide step is permuted to match the bytes ldmatrix hands each thread
  // (4 consecutive hd values: see the score loop); the sum is the same.
  uint32_t qf[MT][kKS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row_base + mt * 16 + g + (i & 1) * 8;
      const __nv_bfloat16* qr =
          q + ((static_cast<size_t>(b) * K + r / group) * Hq + h * group + r % group) * HD;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const int col = kInt8 ? ks * 16 + tig * 4 + (i >> 1) * 2 : ks * 16 + (i >> 1) * 8 + tig * 2;
        qf[mt][ks][i] = r < rows && np > 0 ? *reinterpret_cast<const uint32_t*>(qr + col) : 0u;
      }
    }
  }
  for (int i = tid; i < np; i += kThreads)
    pid_s[i] = page_table[static_cast<size_t>(b) * max_pages + j0 + i];
  __syncthreads();  // page ids

  auto load_page = [&](int i) {
    unsigned char* st = smem + (i % kStages) * L::kStageB;
    const size_t tok0 = (static_cast<size_t>(pid_s[i]) * Hkv + h) * PS;
    const unsigned char* kg = reinterpret_cast<const unsigned char*>(k_pool + tok0 * HD);
    const unsigned char* vg = reinterpret_cast<const unsigned char*>(v_pool + tok0 * HD);
    constexpr int kRowChunks = HD * static_cast<int>(sizeof(KT)) / 16;
    constexpr int kChunks = PS * kRowChunks;
#pragma unroll
    for (int it = 0; it < (2 * kChunks + kThreads - 1) / kThreads; ++it) {
      const int c = tid + it * kThreads;
      if (c < 2 * kChunks) {
        const int which = c / kChunks, cc = c % kChunks;
        const int row = cc / kRowChunks, col = cc % kRowChunks;
        cp_async16(st + which * L::kTileB + row * L::kRowB + col * 16,
                   (which ? vg : kg) + row * (HD * static_cast<int>(sizeof(KT))) + col * 16);
      }
    }
    if constexpr (kInt8) {
      constexpr int kScChunks = PS * 2 / 16;
      if (tid < 2 * kScChunks) {
        const int which = tid / kScChunks, cc = tid % kScChunks;
        const unsigned char* sg =
            reinterpret_cast<const unsigned char*>((which ? v_scale : k_scale) + tok0);
        cp_async16(st + 2 * L::kTileB + which * PS * 2 + cc * 16, sg + cc * 16);
      }
    }
  };

  float m_r[MT][2], l_r[MT][2], acc[MT][kNJ][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_r[mt][0] = m_r[mt][1] = kNegInf;
    l_r[mt][0] = l_r[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  }
  // the furthest position each of this thread's rows sees (exclusive)
  int see[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) see[mt][hr] = seq_len + (row_base + mt * 16 + g + hr * 8) / group;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < np) load_page(i);
    cp_async_commit();
  }

  for (int i = 0; i < np; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // page i has landed; every thread is done with page i-1's stage
    if (i + kStages - 1 < np) load_page(i + kStages - 1);
    cp_async_commit();

    const unsigned char* st = smem + (i % kStages) * L::kStageB;
    const unsigned char* k_s = st;
    const unsigned char* v_s = st + L::kTileB;
    const __nv_bfloat16* ks_s = reinterpret_cast<const __nv_bfloat16*>(st + 2 * L::kTileB);
    const __nv_bfloat16* vs_s = ks_s + PS;

    // ---- S = Q K^T (unscaled), every warp the whole page
    float s[MT][kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
      const unsigned char* krow = k_s + (nt * 8 + lane % 8) * L::kRowB;
      if constexpr (kInt8) {
        // matrix m = 16 int8 of hd [64 hs + 16 m, +16): thread gets row g's
        // bytes 4 tig .. 4 tig + 3, b0 = bytes 0,1 and b1 = bytes 2,3
#pragma unroll
        for (int hs = 0; hs < HD / 64; ++hs) {
          uint32_t r[4];
          ldmatrix_x4(r, krow + hs * 64 + (lane / 8) * 16);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const uint32_t b0 = i8x2_bf16(r[m], 0, 1), b1 = i8x2_bf16(r[m], 2, 3);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_bf16(s[mt][nt], qf[mt][hs * 4 + m], b0, b1);
          }
        }
      } else {
#pragma unroll
        for (int hs = 0; hs < HD / 32; ++hs) {
          uint32_t r[4];
          ldmatrix_x4(r, krow + (hs * 32 + (lane / 8) * 8) * 2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][nt], qf[mt][2 * hs], r[0], r[1]);
            mma_bf16(s[mt][nt], qf[mt][2 * hs + 1], r[2], r[3]);
          }
        }
      }
    }

    // ---- scale, mask, online softmax (rows g and g + 8 of each m tile)
    const int pos0 = (j0 + i) * PS;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = nt * 8 + tig * 2 + e;
            float x = s[mt][nt][hr * 2 + e] * scale;
            if constexpr (kInt8) x *= __bfloat162float(ks_s[t]);
            x = pos0 + t < see[mt][hr] ? x : kNegInf;
            s[mt][nt][hr * 2 + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[mt][hr], mx);
        const float corr = expf(m_r[mt][hr] - m_new);
        m_r[mt][hr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(s[mt][nt][hr * 2 + e] - m_new);
            sum += p;
            s[mt][nt][hr * 2 + e] = p;
          }
        }
        l_r[mt][hr] = l_r[mt][hr] * corr + sum;  // this thread's columns; quad-summed at the end
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          acc[mt][j][hr * 2] *= corr;
          acc[mt][j][hr * 2 + 1] *= corr;
        }
      }
    }

    // ---- acc += P V over this warp's hd columns, 16 tokens per k step
#pragma unroll
    for (int kk = 0; kk < PS / 16; ++kk) {
      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) {
          // A register i2: n tile 2 kk + i2 / 2, row half i2 % 2
          const int nt = 2 * kk + i2 / 2, hr = i2 % 2;
          float p0 = s[mt][nt][hr * 2], p1 = s[mt][nt][hr * 2 + 1];
          if constexpr (kInt8) {
            const int t = nt * 8 + tig * 2;
            p0 *= __bfloat162float(vs_s[t]);
            p1 *= __bfloat162float(vs_s[t + 1]);
          }
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          a_hi[mt][i2] = *reinterpret_cast<const uint32_t*>(&hi);
          a_lo[mt][i2] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
        }
      }
      if constexpr (kInt8) {
        // this warp's hd column c of n tile j is hd warp*kWD + c*kNJ + j, so
        // thread g reads kNJ consecutive bytes of each of its 4 token rows
        uint64_t w[4];
#pragma unroll
        for (int tr = 0; tr < 4; ++tr) {
          const int t = kk * 16 + tig * 2 + (tr & 1) + (tr >> 1) * 8;
          const unsigned char* src = v_s + t * L::kRowB + warp * kWD + g * kNJ;
          if constexpr (kNJ == 4) {
            w[tr] = *reinterpret_cast<const uint32_t*>(src);
          } else {
            uint64_t x = 0;
#pragma unroll
            for (int k2 = 0; k2 < kNJ / 2; ++k2)
              x |= static_cast<uint64_t>(*reinterpret_cast<const uint16_t*>(src + 2 * k2)) << (16 * k2);
            w[tr] = x;
          }
        }
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const uint32_t b0 = pack_bf16(static_cast<float>(static_cast<int8_t>(w[0] >> (8 * j))),
                                        static_cast<float>(static_cast<int8_t>(w[1] >> (8 * j))));
          const uint32_t b1 = pack_bf16(static_cast<float>(static_cast<int8_t>(w[2] >> (8 * j))),
                                        static_cast<float>(static_cast<int8_t>(w[3] >> (8 * j))));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][j], a_hi[mt], b0, b1);
            mma_bf16(acc[mt][j], a_lo[mt], b0, b1);
          }
        }
      } else {
#pragma unroll
        for (int jp = 0; jp < kNJ / 2; ++jp) {
          uint32_t r[4];
          const int t = kk * 16 + lane % 8 + ((lane / 8) & 1) * 8;
          const int col = warp * kWD + jp * 16 + (lane / 16) * 8;
          ldmatrix_x4_trans(r, v_s + t * L::kRowB + col * 2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * jp], a_hi[mt], r[0], r[1]);
            mma_bf16(acc[mt][2 * jp], a_lo[mt], r[0], r[1]);
            mma_bf16(acc[mt][2 * jp + 1], a_hi[mt], r[2], r[3]);
            mma_bf16(acc[mt][2 * jp + 1], a_lo[mt], r[2], r[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- push this chunk's partial to the blocks that fold its columns:
  // raw m and l (quad-summed) to every block, acc (unnormalised) to the
  // owner of each column; a chunk past the horizon pushes nothing
  cluster_wait();  // every block of the cluster has started
  const int nrows = min(16 * MT, rows - row_base);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = l_r[mt][hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int lr = mt * 16 + g + hr * 8;
      if (split >= live || lr >= nrows) continue;
      if (warp == 0 && tig == 0) {
        for (int o = 0; o < splits; ++o) {
          *fold.m_at(o, split, lr) = m_r[mt][hr];
          *fold.l_at(o, split, lr) = l;
        }
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = warp * kWD + (kInt8 ? (tig * 2 + e) * kNJ + j : j * 8 + tig * 2 + e);
          *fold.acc_at(c / fold.cols, split, lr, c) = acc[mt][j][hr * 2 + e];
        }
      }
    }
  }
  cluster_arrive();
  cluster_wait();  // every live chunk's partial is in its columns' owner
  fold_local(fold, nrows, live, row_base, out, b, K, Hq, h, group, HD);
}

// ------------------------------------------------- CUDA-core split kernel

// Any q/pool type, any hd and page size: one block per (chunk, kv head,
// slot), threads striding over (row, token) and (row, dim) pairs, f32
// tiles in shared memory.  The same clusters and fold as the tensor-core
// kernel.
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_split_simt_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool, const KT* __restrict__ v_pool,
    const __nv_bfloat16* __restrict__ k_scale, const __nv_bfloat16* __restrict__ v_scale,
    const int32_t* __restrict__ page_table, const int32_t* __restrict__ seq_lens,
    QT* __restrict__ out, int K, int Hq, int Hkv, int hd, int ps, int max_pages, int pps,
    float scale) {
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int group = Hq / Hkv;
  const int rows = K * group;
  const int kstride = hd + 1;
  const int seq_len = seq_lens[b];
  const int visit = pages_to_visit(seq_len, K, ps, max_pages);
  const int j0 = split * pps;
  const int j1 = min(j0 + pps, visit);  // j1 <= j0: nothing to push
  const int splits = gridDim.x;
  const int live = (visit + pps - 1) / pps;

  extern __shared__ float fsmem[];
  float* q_s = fsmem;                   // [rows, hd], pre-scaled
  float* acc_s = q_s + rows * hd;       // [rows, hd]
  float* k_s = acc_s + rows * hd;       // [ps, hd + 1]
  float* v_s = k_s + ps * kstride;      // [ps, hd]
  float* s_s = v_s + ps * hd;           // [rows, ps] scores, then p
  float* m_s = s_s + rows * ps;         // [rows]
  float* l_s = m_s + rows;              // [rows]
  float* c_s = l_s + rows;              // [rows] this page's correction
  const Fold fold(c_s + rows, rows, hd, splits);
  cluster_arrive_relaxed();  // this block has started (waited on before the push)

  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int hq = h * group + r % group;
    q_s[i] = to_f32(q[((static_cast<size_t>(b) * K + r / group) * Hq + hq) * hd + d]) * scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int j = j0; j < j1; ++j) {
    const size_t page = static_cast<size_t>(page_table[static_cast<size_t>(b) * max_pages + j]);
    const size_t tok0 = (page * Hkv + h) * ps;
    const KT* kt = k_pool + tok0 * hd;
    const KT* vt = v_pool + tok0 * hd;
    for (int i = tid; i < ps * hd; i += kThreads) {
      const int t = i / hd, d = i - t * hd;
      float kv = to_f32(kt[i]);
      float vv = to_f32(vt[i]);
      if (k_scale != nullptr) {
        kv *= __bfloat162float(k_scale[tok0 + t]);
        vv *= __bfloat162float(v_scale[tok0 + t]);
      }
      k_s[t * kstride + d] = kv;
      v_s[i] = vv;
    }
    __syncthreads();

    for (int i = tid; i < rows * ps; i += kThreads) {
      const int r = i / ps, t = i - r * ps;
      const float* qr = q_s + r * hd;
      const float* kr = k_s + t * kstride;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      s_s[i] = (j * ps + t < seq_len + r / group) ? dot : kNegInf;
    }
    __syncthreads();

    for (int r = tid; r < rows; r += kThreads) {
      float* sr = s_s + r * ps;
      float m_new = m_s[r];
      for (int t = 0; t < ps; ++t) m_new = fmaxf(m_new, sr[t]);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = expf(sr[t] - m_new);
        sr[t] = p;
        sum += p;
      }
      const float corr = expf(m_s[r] - m_new);
      l_s[r] = l_s[r] * corr + sum;
      c_s[r] = corr;
      m_s[r] = m_new;
    }
    __syncthreads();

    for (int i = tid; i < rows * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = s_s + r * ps;
      float a = acc_s[i] * c_s[r];
      for (int t = 0; t < ps; ++t) a = fmaf(pr[t], v_s[t * hd + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  // push this chunk's partial to the blocks that fold its columns, then
  // fold this block's own
  cluster_wait();  // every block of the cluster has started
  if (split < live) {
    for (int i = tid; i < rows * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      *fold.acc_at(d / fold.cols, split, r, d) = acc_s[i];
    }
    for (int i = tid; i < rows * splits; i += kThreads) {
      const int r = i / splits, o = i - r * splits;
      *fold.m_at(o, split, r) = m_s[r];
      *fold.l_at(o, split, r) = l_s[r];
    }
  }
  cluster_arrive();
  cluster_wait();  // every live chunk's partial is in its columns' owner
  fold_local(fold, rows, live, 0, out, b, K, Hq, h, group, hd);
}

// ----------------------------------------------------------------- launch

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *page_table, *seq_lens;
  void* out;
  int B, K, Hq, Hkv, hd, ps, max_pages, pps, splits;
  float scale;
  cudaStream_t stream;
  int* occ;  // non-null: report the occupancy (launch_cluster) and launch nothing
};

// One kernel instantiation's launch state: the dynamic shared memory it
// was granted, whether it may form clusters above the portable 8, and for
// each cluster size the largest shared memory at which a cluster was
// found to fit the card.
struct LaunchState {
  size_t granted = 48 * 1024;
  bool nonportable = false;
  size_t fits[kMaxSplits + 1] = {};
};

// Launch `kernel` over `grid` with the grid's x blocks (the chunks of one
// slot, kv head and row tile) as one cluster.  The first launch at a
// (cluster size, shared memory) asks cudaOccupancyMaxActiveClusters
// whether such a cluster fits the card and returns kErrClusterDoesNotFit
// if it does not.  With `occ` non-null it launches nothing and writes the
// blocks one SM holds and the clusters the card holds at once (occ[0],
// occ[1]).  Returns the first CUDA error, 0 on success.
template <typename... KArgs, typename... Args2>
int launch_cluster(void (*kernel)(KArgs...), LaunchState& st, dim3 grid, size_t smem,
                   cudaStream_t stream, int* occ, Args2... args) {
  const int splits = static_cast<int>(grid.x);
  if (splits < 1 || splits > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > st.granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    st.granted = smem;
  }
  if (splits > kPortableCluster && !st.nonportable) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    st.nonportable = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (occ) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ[0], kernel, kThreads, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&occ[1], reinterpret_cast<const void*>(kernel), &cfg);
    return static_cast<int>(err);
  }
  if (st.fits[splits] < smem) {
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void*>(kernel), &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return kErrClusterDoesNotFit;
    st.fits[splits] = smem;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Query-row m16 tiles per block: two where they fit the registers.
template <int HD>
constexpr int tc_mt(int rows) {
  return rows <= 16 || HD == 192 ? 1 : 2;
}

template <typename KT, int HD, int PS, int MT>
int launch_tc(const Args& a) {
  static LaunchState st;
  const int rows = a.K * (a.Hq / a.Hkv);
  const int rtiles = (rows + 16 * MT - 1) / (16 * MT);
  const size_t smem = tc_smem_bytes<KT, HD, PS, MT>(a.splits, a.pps);
  return launch_cluster(
      paged_split_tc_kernel<KT, HD, PS, MT>, st, dim3(a.splits, a.Hkv * rtiles, a.B), smem,
      a.stream, a.occ, static_cast<const __nv_bfloat16*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), static_cast<const __nv_bfloat16*>(a.k_scale),
      static_cast<const __nv_bfloat16*>(a.v_scale), static_cast<const int32_t*>(a.page_table),
      static_cast<const int32_t*>(a.seq_lens), static_cast<__nv_bfloat16*>(a.out), a.K, a.Hq,
      a.Hkv, a.max_pages, a.pps, a.scale);
}

template <typename KT, int HD, int PS>
int launch_tc_rows(const Args& a) {
  if (tc_mt<HD>(a.K * (a.Hq / a.Hkv)) == 1) return launch_tc<KT, HD, PS, 1>(a);
  if constexpr (HD != 192) return launch_tc<KT, HD, PS, 2>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Calls f(hd, ps) with the tensor-core kernel's (hd, page size) as
// compile-time constants; use_tc() shapes only.
template <typename F>
auto with_tc_shape(int hd, int ps, F f) {
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  using I192 = std::integral_constant<int, 192>;
  using P16 = std::integral_constant<int, 16>;
  using P32 = std::integral_constant<int, 32>;
  if (hd == 192) return ps == 32 ? f(I192{}, P32{}) : f(I192{}, P16{});
  if (hd == 128) return ps == 32 ? f(I128{}, P32{}) : f(I128{}, P16{});
  return ps == 32 ? f(I64{}, P32{}) : f(I64{}, P16{});
}

template <typename KT>
int launch_tc_shape(const Args& a) {
  return with_tc_shape(a.hd, a.ps, [&](auto H, auto P) {
    return launch_tc_rows<KT, decltype(H)::value, decltype(P)::value>(a);
  });
}

// The tensor-core kernel's shared memory; use_tc() shapes only.
template <typename KT>
size_t tc_smem(int hd, int ps, int rows, int splits, int pps) {
  return with_tc_shape(hd, ps, [&](auto H, auto P) -> size_t {
    constexpr int HD = decltype(H)::value, PS = decltype(P)::value;
    return tc_mt<HD>(rows) == 1 ? tc_smem_bytes<KT, HD, PS, 1>(splits, pps)
                                : tc_smem_bytes<KT, HD, PS, 2>(splits, pps);
  });
}

size_t simt_smem(int rows, int hd, int ps, int splits) {
  const size_t floats = 2 * static_cast<size_t>(rows) * hd  // q, acc
                        + static_cast<size_t>(ps) * (hd + 1)  // K tile (padded)
                        + static_cast<size_t>(ps) * hd        // V tile
                        + static_cast<size_t>(rows) * ps      // scores
                        + 3 * static_cast<size_t>(rows)       // m, l, corr
                        + fold_floats(rows, hd, splits);      // the fold
  return floats * sizeof(float);
}

template <typename QT, typename KT>
int launch_simt(const Args& a) {
  static LaunchState st;
  return launch_cluster(
      paged_split_simt_kernel<QT, KT>, st, dim3(a.splits, a.Hkv, a.B),
      simt_smem(a.K * (a.Hq / a.Hkv), a.hd, a.ps, a.splits), a.stream, a.occ, static_cast<const QT*>(a.q),
      static_cast<const KT*>(a.k_pool), static_cast<const KT*>(a.v_pool),
      static_cast<const __nv_bfloat16*>(a.k_scale), static_cast<const __nv_bfloat16*>(a.v_scale),
      static_cast<const int32_t*>(a.page_table), static_cast<const int32_t*>(a.seq_lens),
      static_cast<QT*>(a.out), a.K, a.Hq, a.Hkv, a.hd, a.ps, a.max_pages, a.pps, a.scale);
}

template <typename QT>
int launch_simt_kv(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case 0: return launch_simt<QT, float>(a);
    case 1: return launch_simt<QT, __nv_bfloat16>(a);
    case 2: return launch_simt<QT, int8_t>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool use_tc(int q_dtype, int kv_dtype, int hd, int ps) {
  return q_dtype == 1 && (kv_dtype == 1 || kv_dtype == 2) && (hd == 64 || hd == 128 || hd == 192) &&
         (ps == 16 || ps == 32);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one split block in a cluster of `splits`.
size_t paged_attention_smem_bytes(int q_dtype, int kv_dtype, int rows, int hd, int ps, int pps,
                                  int splits) {
  if (!use_tc(q_dtype, kv_dtype, hd, ps)) return simt_smem(rows, hd, ps, splits);
  return kv_dtype == 2 ? tc_smem<int8_t>(hd, ps, rows, splits, pps)
                       : tc_smem<__nv_bfloat16>(hd, ps, rows, splits, pps);
}

// The most chunks one call may cut a slot's walk into (the cluster size).
int paged_attention_max_splits() { return kMaxSplits; }

// q_dtype: 0 = f32, 1 = bf16 (out has q's type).  kv_dtype: 0 = f32,
// 1 = bf16, 2 = int8 with bf16 scales.  splits = ceil(max_pages / pps)
// must be 1..16: the chunks of a slot are one cluster.  Launches ONE
// kernel on `stream` and returns the first CUDA error (0 on success;
// kErrClusterDoesNotFit when no such cluster fits the card); never
// synchronises.
int paged_attention_launch(const void* q, int q_dtype, const void* k_pool, const void* v_pool,
                           int kv_dtype, const void* k_scale, const void* v_scale,
                           const void* page_table, const void* seq_lens, void* out, int B, int K,
                           int Hq, int Hkv, int hd, int ps, int max_pages, int pps, float scale,
                           void* stream) {
  if (pps < 1 || (q_dtype != 0 && q_dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k_pool, v_pool, k_scale, v_scale, page_table, seq_lens, out,
         B, K, Hq, Hkv, hd, ps, max_pages, pps, (max_pages + pps - 1) / pps, scale,
         static_cast<cudaStream_t>(stream), nullptr};
  if (use_tc(q_dtype, kv_dtype, hd, ps))
    return kv_dtype == 2 ? launch_tc_shape<int8_t>(a) : launch_tc_shape<__nv_bfloat16>(a);
  return q_dtype == 0 ? launch_simt_kv<float>(kv_dtype, a) : launch_simt_kv<__nv_bfloat16>(kv_dtype, a);
}

// The occupancy of the kernel that paged_attention_launch would run for
// these shapes: the blocks one SM holds (occ[0]) and the clusters of
// ceil(max_pages / pps) blocks the card holds at once (occ[1]), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor and
// cudaOccupancyMaxActiveClusters.  Launches nothing.  Returns the first
// CUDA error, 0 on success.
int paged_attention_occupancy(int q_dtype, int kv_dtype, int B, int K, int Hq, int Hkv, int hd,
                              int ps, int max_pages, int pps, int* occ) {
  if (pps < 1 || (q_dtype != 0 && q_dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         B, K, Hq, Hkv, hd, ps, max_pages, pps, (max_pages + pps - 1) / pps, 1.f,
         nullptr, occ};
  if (use_tc(q_dtype, kv_dtype, hd, ps))
    return kv_dtype == 2 ? launch_tc_shape<int8_t>(a) : launch_tc_shape<__nv_bfloat16>(a);
  return q_dtype == 0 ? launch_simt_kv<float>(kv_dtype, a) : launch_simt_kv<__nv_bfloat16>(kv_dtype, a);
}

const char* paged_attention_error_string(int err) {
  if (err == kErrClusterDoesNotFit)
    return "no cluster of the call's split blocks fits the card (cudaOccupancyMaxActiveClusters)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
