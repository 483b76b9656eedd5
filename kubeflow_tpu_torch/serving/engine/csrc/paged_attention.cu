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
// Design: split-K with a merge pass, two device kernels per call.
//   * Split.  Each slot's page walk is cut into chunks of pages_per_split
//     pages, one block per (chunk, kv head [x row tile], slot), so the
//     2048-token slot is walked by many SMs at once instead of by one
//     block per (slot, head).  The split is chosen on the host from the
//     shapes only (paged_attention.py _split_plan), never from seq_lens,
//     which would cost a device->host sync per layer.  A block whose chunk
//     starts at or past its slot's horizon exits at once.
//   * Loads.  A 3-stage ring of (K tile, V tile, int8 scales) in shared
//     memory, filled with 16-byte cp.async copies (8 bf16 or 16 int8 per
//     copy); page j+2 is in flight while page j is computed, one barrier
//     per page.  Rows are padded by 16 bytes so the fragment loads below
//     are free of bank conflicts.
//   * Scores on the tensor cores, mma.sync.m16n8k16 bf16 -> f32.  The
//     block's rows (K*group: 4 at K=1, 20 at K=5) pad one or two m16 tiles;
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
//     4-byte loads of an hd-permuted column order (int8).
//   * Each block writes its partial (m, l, acc) in f32, m and l raw: in f32
//     -1e9 + log(l) rounds to -1e9, so an lse would lose the counts that
//     give an unseeing row its uniform V average.
//   * Merge: one thread per output element folds the live chunks'
//     partials, out = sum exp(m_i - M) acc_i / max(sum exp(m_i - M) l_i,
//     1e-30); a slot with no live chunk writes zeros.
//   * Other inputs (f32 q or pool, which only the tests use, or an hd or
//     page size outside the tensor-core instantiations) take the same split
//     and merge with CUDA-core FMAs over f32 tiles in shared memory.
// Measured by chip_smoke.py phase 3 on an H100 80GB HBM3 at 700 W (bf16,
// K=1, the shapes above): 0.020 ms of device time (split 0.016 + merge
// 0.004), 0.03 ms on CUDA events, against SDPA's 0.05 ms over the
// gathered cache; the first version, one block per (slot, head) walking
// its pages in series, took 0.505-0.587 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;

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
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, int i, int j) {
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

// Index of row r's partial of chunk s: [B, Hkv, splits, rows].
__device__ __forceinline__ size_t part_index(int b, int h, int s, int r, int Hkv, int splits,
                                             int rows) {
  return ((static_cast<size_t>(b) * Hkv + h) * splits + s) * rows + r;
}

// ------------------------------------------------- tensor-core split kernel

template <typename KT, int HD, int PS>
struct TcLayout {
  static constexpr bool kInt8 = sizeof(KT) == 1;
  static constexpr int kRowB = HD * static_cast<int>(sizeof(KT)) + 16;  // padded smem row
  static constexpr int kTileB = PS * kRowB;
  static constexpr int kScaleB = kInt8 ? 2 * PS * 2 : 0;  // k and v scales, bf16
  static constexpr int kStageB = 2 * kTileB + kScaleB;
  static constexpr int kSmem = kStages * kStageB;  // + the chunk's page ids
};

// q bf16 [B, K, Hq, HD]; pools KT [P, Hkv, PS, HD] (bf16, or int8 with bf16
// scales [P, Hkv, PS]).  Grid (splits, Hkv * row tiles, B); MT m16 tiles
// of query rows per block.  Writes part_{m,l} [B, Hkv, splits, rows] and
// part_acc [.., HD] for the chunks that hold a visited page.
template <typename KT, int HD, int PS, int MT>
__global__ void __launch_bounds__(kThreads) paged_split_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ seq_lens, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int K, int Hq, int Hkv,
    int max_pages, int pps, int splits, float scale) {
  using L = TcLayout<KT, HD, PS>;
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
  const int j0 = split * pps;
  const int np = min(j0 + pps, pages_to_visit(seq_len, K, PS, max_pages)) - j0;
  if (np <= 0) return;  // the chunk starts past the horizon: no partial

  extern __shared__ __align__(128) unsigned char smem[];
  int* pid_s = reinterpret_cast<int*>(smem + L::kSmem);
  const int tid = threadIdx.x;
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
        qf[mt][ks][i] = r < rows ? *reinterpret_cast<const uint32_t*>(qr + col) : 0u;
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
        uint32_t w[4];
#pragma unroll
        for (int tr = 0; tr < 4; ++tr) {
          const int t = kk * 16 + tig * 2 + (tr & 1) + (tr >> 1) * 8;
          const unsigned char* src = v_s + t * L::kRowB + warp * kWD + g * kNJ;
          w[tr] = kNJ == 4 ? *reinterpret_cast<const uint32_t*>(src)
                           : *reinterpret_cast<const uint16_t*>(src);
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

  // ---- the partial: raw m and l (quad-summed), unnormalised acc
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = l_r[mt][hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int r = row_base + mt * 16 + g + hr * 8;
      if (r >= rows) continue;
      const size_t pi = part_index(b, h, split, r, Hkv, splits, rows);
      if (warp == 0 && tig == 0) {
        part_m[pi] = m_r[mt][hr];
        part_l[pi] = l;
      }
      float* pa = part_acc + pi * HD + warp * kWD;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = tig * 2 + e;
          pa[kInt8 ? c * kNJ + j : j * 8 + c] = acc[mt][j][hr * 2 + e];
        }
      }
    }
  }
}

// ------------------------------------------------- CUDA-core split kernel

// Any q/pool type, any hd and page size: one block per (chunk, kv head,
// slot), threads striding over (row, token) and (row, dim) pairs, f32
// tiles in shared memory.  Same partials as the tensor-core kernel.
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_split_simt_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool, const KT* __restrict__ v_pool,
    const __nv_bfloat16* __restrict__ k_scale, const __nv_bfloat16* __restrict__ v_scale,
    const int32_t* __restrict__ page_table, const int32_t* __restrict__ seq_lens,
    float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc,
    int K, int Hq, int Hkv, int hd, int ps, int max_pages, int pps, int splits, float scale) {
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int group = Hq / Hkv;
  const int rows = K * group;
  const int kstride = hd + 1;
  const int seq_len = seq_lens[b];
  const int j0 = split * pps;
  const int j1 = min(j0 + pps, pages_to_visit(seq_len, K, ps, max_pages));
  if (j0 >= j1) return;

  extern __shared__ float fsmem[];
  float* q_s = fsmem;                   // [rows, hd], pre-scaled
  float* acc_s = q_s + rows * hd;       // [rows, hd]
  float* k_s = acc_s + rows * hd;       // [ps, hd + 1]
  float* v_s = k_s + ps * kstride;      // [ps, hd]
  float* s_s = v_s + ps * hd;           // [rows, ps] scores, then p
  float* m_s = s_s + rows * ps;         // [rows]
  float* l_s = m_s + rows;              // [rows]
  float* c_s = l_s + rows;              // [rows] this page's correction

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

  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    part_acc[part_index(b, h, split, r, Hkv, splits, rows) * hd + d] = acc_s[i];
  }
  for (int r = tid; r < rows; r += kThreads) {
    const size_t pi = part_index(b, h, split, r, Hkv, splits, rows);
    part_m[pi] = m_s[r];
    part_l[pi] = l_s[r];
  }
}

// ------------------------------------------------------------------ merge

// One thread per output element (row, dim) of a (kv head, slot): out =
// sum_i exp(m_i - M) acc_i / max(sum_i exp(m_i - M) l_i, 1e-30) over the
// slot's live chunks, zeros when it has none.  The chunk loops are unrolled
// so their independent loads are in flight together.
template <typename QT>
__global__ void __launch_bounds__(kThreads) paged_merge_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, const int32_t* __restrict__ seq_lens,
    QT* __restrict__ out, int K, int Hq, int Hkv, int hd, int ps, int max_pages, int pps,
    int splits) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int rows = K * group;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * hd) return;
  const int r = i / hd, d = i - r * hd;
  const int live = (pages_to_visit(seq_lens[b], K, ps, max_pages) + pps - 1) / pps;
  const size_t p0 = part_index(b, h, 0, r, Hkv, splits, rows);
  float M = kNegInf;
#pragma unroll 8
  for (int s = 0; s < live; ++s) M = fmaxf(M, part_m[p0 + static_cast<size_t>(s) * rows]);
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int s = 0; s < live; ++s) {
    const size_t pi = p0 + static_cast<size_t>(s) * rows;
    const float w = expf(part_m[pi] - M);
    num = fmaf(w, part_acc[pi * hd + d], num);
    den = fmaf(w, part_l[pi], den);
  }
  const int hq = h * group + r % group;
  store(out + ((static_cast<size_t>(b) * K + r / group) * Hq + hq) * hd + d,
        live > 0 ? num / fmaxf(den, 1e-30f) : 0.f);
}

// ----------------------------------------------------------------- launch

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *page_table, *seq_lens;
  void* out;
  float *part_m, *part_l, *part_acc;
  int B, K, Hq, Hkv, hd, ps, max_pages, pps, splits;
  float scale;
  cudaStream_t stream;
};

// Raise a kernel's dynamic shared-memory limit once per size it grows to
// (one host call per kernel instead of one per launch); `granted` is the
// calling launcher's own record for its kernel.
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem, size_t& granted) {
  if (smem <= granted) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) granted = smem;
  return static_cast<int>(err);
}

template <typename KT, int HD, int PS, int MT>
int launch_tc(const Args& a, int rtiles) {
  auto kernel = paged_split_tc_kernel<KT, HD, PS, MT>;
  const size_t smem = TcLayout<KT, HD, PS>::kSmem + sizeof(int) * a.pps;
  static size_t granted = 48 * 1024;
  if (int err = set_smem(kernel, smem, granted)) return err;
  kernel<<<dim3(a.splits, a.Hkv * rtiles, a.B), kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), static_cast<const __nv_bfloat16*>(a.k_scale),
      static_cast<const __nv_bfloat16*>(a.v_scale), static_cast<const int32_t*>(a.page_table),
      static_cast<const int32_t*>(a.seq_lens), a.part_m, a.part_l, a.part_acc, a.K, a.Hq, a.Hkv,
      a.max_pages, a.pps, a.splits, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT, int HD, int PS>
int launch_tc_rows(const Args& a) {
  const int rows = a.K * (a.Hq / a.Hkv);
  if (rows <= 16) return launch_tc<KT, HD, PS, 1>(a, 1);
  return launch_tc<KT, HD, PS, 2>(a, (rows + 31) / 32);
}

template <typename KT>
int launch_tc_shape(const Args& a) {
  if (a.hd == 128 && a.ps == 32) return launch_tc_rows<KT, 128, 32>(a);
  if (a.hd == 128 && a.ps == 16) return launch_tc_rows<KT, 128, 16>(a);
  if (a.hd == 64 && a.ps == 32) return launch_tc_rows<KT, 64, 32>(a);
  if (a.hd == 64 && a.ps == 16) return launch_tc_rows<KT, 64, 16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

size_t simt_smem(int rows, int hd, int ps) {
  const size_t floats = 2 * static_cast<size_t>(rows) * hd  // q, acc
                        + static_cast<size_t>(ps) * (hd + 1)  // K tile (padded)
                        + static_cast<size_t>(ps) * hd        // V tile
                        + static_cast<size_t>(rows) * ps      // scores
                        + 3 * static_cast<size_t>(rows);      // m, l, corr
  return floats * sizeof(float);
}

template <typename QT, typename KT>
int launch_simt(const Args& a) {
  auto kernel = paged_split_simt_kernel<QT, KT>;
  const size_t smem = simt_smem(a.K * (a.Hq / a.Hkv), a.hd, a.ps);
  static size_t granted = 48 * 1024;
  if (int err = set_smem(kernel, smem, granted)) return err;
  kernel<<<dim3(a.splits, a.Hkv, a.B), kThreads, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), static_cast<const __nv_bfloat16*>(a.k_scale),
      static_cast<const __nv_bfloat16*>(a.v_scale), static_cast<const int32_t*>(a.page_table),
      static_cast<const int32_t*>(a.seq_lens), a.part_m, a.part_l, a.part_acc, a.K, a.Hq, a.Hkv,
      a.hd, a.ps, a.max_pages, a.pps, a.splits, a.scale);
  return static_cast<int>(cudaGetLastError());
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

template <typename QT>
int launch_merge(const Args& a) {
  const int elems = a.K * (a.Hq / a.Hkv) * a.hd;
  paged_merge_kernel<QT><<<dim3((elems + kThreads - 1) / kThreads, a.Hkv, a.B), kThreads, 0,
                           a.stream>>>(
      a.part_m, a.part_l, a.part_acc, static_cast<const int32_t*>(a.seq_lens),
      static_cast<QT*>(a.out), a.K, a.Hq, a.Hkv, a.hd, a.ps, a.max_pages, a.pps, a.splits);
  return static_cast<int>(cudaGetLastError());
}

// The ring of the tensor-core kernel at (hd, ps); use_tc() shapes only.
template <typename KT>
size_t tc_smem(int hd, int ps) {
  if (hd == 128) return ps == 32 ? TcLayout<KT, 128, 32>::kSmem : TcLayout<KT, 128, 16>::kSmem;
  return ps == 32 ? TcLayout<KT, 64, 32>::kSmem : TcLayout<KT, 64, 16>::kSmem;
}

bool use_tc(int q_dtype, int kv_dtype, int hd, int ps) {
  return q_dtype == 1 && (kv_dtype == 1 || kv_dtype == 2) && (hd == 64 || hd == 128) &&
         (ps == 16 || ps == 32);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one split block.
size_t paged_attention_smem_bytes(int q_dtype, int kv_dtype, int rows, int hd, int ps, int pps) {
  if (!use_tc(q_dtype, kv_dtype, hd, ps)) return simt_smem(rows, hd, ps);
  return (kv_dtype == 2 ? tc_smem<int8_t>(hd, ps) : tc_smem<__nv_bfloat16>(hd, ps)) +
         sizeof(int) * static_cast<size_t>(pps);
}

// q_dtype: 0 = f32, 1 = bf16 (out has q's type).  kv_dtype: 0 = f32,
// 1 = bf16, 2 = int8 with bf16 scales.  part_m/part_l [B, Hkv, splits,
// K*Hq/Hkv] and part_acc [.., hd] f32 are the caller's scratch, splits =
// ceil(max_pages / pps).  Launches the split kernel and the merge kernel
// on `stream` and returns the first cudaGetLastError() that is not 0
// (0 on success); never synchronises.
int paged_attention_launch(const void* q, int q_dtype, const void* k_pool, const void* v_pool,
                           int kv_dtype, const void* k_scale, const void* v_scale,
                           const void* page_table, const void* seq_lens, void* out,
                           void* part_m, void* part_l, void* part_acc, int B, int K, int Hq,
                           int Hkv, int hd, int ps, int max_pages, int pps, float scale,
                           void* stream) {
  if (pps < 1 || (q_dtype != 0 && q_dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k_pool, v_pool, k_scale, v_scale, page_table, seq_lens, out,
         static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc),
         B, K, Hq, Hkv, hd, ps, max_pages, pps, (max_pages + pps - 1) / pps, scale,
         static_cast<cudaStream_t>(stream)};
  int err;
  if (use_tc(q_dtype, kv_dtype, hd, ps))
    err = kv_dtype == 2 ? launch_tc_shape<int8_t>(a) : launch_tc_shape<__nv_bfloat16>(a);
  else
    err = q_dtype == 0 ? launch_simt_kv<float>(kv_dtype, a) : launch_simt_kv<__nv_bfloat16>(kv_dtype, a);
  if (err != 0) return err;
  return q_dtype == 0 ? launch_merge<float>(a) : launch_merge<__nv_bfloat16>(a);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
