// Flash attention forward for Hopper (sm_90a), C ABI for ctypes.
//
// Replaces the TPU kernel kubeflow_tpu/ops/flash_attention.py:40
// (_fwd_kernel, launched by _flash_fwd through pl.pallas_call at :112):
// blockwise attention over [B*H, S, d] rows with an online softmax over key
// tiles, emitting the output in q's type and the f32 log-sum-exp of every
// query row.
//
// Semantics, identical to the TPU kernel:
//   * logits = (q . k) * d**-0.5 in f32 (the TPU kernel scales q in f32
//     before the product: the same value up to one f32 rounding, and exactly
//     the same for a power-of-two scale such as d = 64's); a causal mask
//     (key > query) and a key-side padding mask (mask[b, key] <= 0.5, row
//     bh reads batch bh / heads) set a logit to the finite NEG_INF = -1e9;
//   * online softmax from m = NEG_INF, l = 0, acc = 0; the output is
//     acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30));
//   * the keys a row visits follow the CALLER's block_q / block_k, not this
//     kernel's tiles: under causal, query row i visits the keys below
//     min((i / block_q + 1) * block_q - 1) / block_k + 1, T / block_k) *
//     block_k (the TPU kernel skips whole key blocks past the diagonal),
//     otherwise every key.  Keys past a row's horizon get a weight of
//     exactly 0 (a true -inf logit here), masked keys inside it the weight
//     exp(NEG_INF - m).  So a row whose visited keys are all masked has
//     m = NEG_INF, p = 1 on each visited key, and averages V uniformly over
//     them, exactly as the TPU kernel does.
//
// What bounds it on the H100.  At BERT-base (B*H = 384, S = T = 512, d = 64,
// bf16) one call reads q, k, v and writes o, 4 x 25.2 MB, for 25.8 GFLOP:
// 30 us of bytes at 3.35 TB/s against 26 us of bf16 tensor-core work, so
// bytes by a hair and the tensor cores close behind.  With P fed as two
// bf16 terms (below), the tensor cores do 1.5x the model's FLOPs: a floor of
// ~39 us of tensor-core time.
//
// Design (bf16 at D = 64 and 128, every shape of the training path): the
// Hopper pipeline, warp-specialised, TMA-fed, on wgmma.
//   * Warp specialisation.  Warpgroup 0 is the producer, whose first warp
//     issues every load and whose registers setmaxnreg cuts to 24; each
//     consumer warpgroup owns 64 query rows (232 or 240 registers).  At D
//     128 a work item is 128 rows with two consumers; at D 64 64 rows
//     with one, two CTAs an SM (consumers(): each the faster where it is
//     used, on the H100).
//   * Persistent CTAs: as many as the card holds at once, each walking
//     work items (a q block of one bh) with the ring's tile count running
//     on, Q in two slots, so an item's Q and first tiles load under the
//     item before, and its epilogue runs under the next one's loads.
//     Without causal the q blocks of a bh run side by side (K and V shared
//     in L2); under causal the costliest items go first, over every bh.
//   * Loads.  TMA (cp.async.bulk.tensor) boxes of [64 rows x 64 columns]
//     from tensor maps encoded on the host for each call (cuTensorMapEncode-
//     Tiled over [BH, rows, D], passed as __grid_constant__), 128-byte
//     swizzled as wgmma's shared-memory descriptors read them; rows past S
//     or Tk arrive as zeros (the horizon logic below still gives every key
//     >= Tk a weight of exactly 0).  Q once an item; K, V and the tile's key-mask
//     values (plus an all-dead / all-live flag) through a 3-stage ring with
//     full and empty mbarriers: the producer warp issues a tile's TMA
//     first, then its lanes stage the mask (loaded a tile ahead) and arrive
//     on `full`, which also counts the TMA bytes; each consumer warp
//     arrives on `empty` once its products have read the stage.
//   * S = Q K^T by wgmma.mma_async m64n64k16 (Q and K K-major from shared
//     memory, the k step advancing 32 bytes inside the swizzled rows) into
//     registers; S never touches shared memory.
//   * Overlap, in FlashAttention-3's order: a consumer issues tile j's S,
//     then O's rescale and tile j-1's P V, waits for S alone and computes
//     tile j's softmax while P V (the larger product, two terms) runs on the
//     tensor cores.  Every iteration ends with nothing in flight: a loop
//     that carried a product across iterations (S of tile j+1 under tile
//     j's softmax) made ptxas serialise every wgmma of the kernel (warning
//     C7514).
//   * Softmax in registers on the wgmma accumulator layout (the m16n8
//     layout per warp): scale, the row horizon, causal and key mask, the row
//     max and sum across the 4 threads of a quad, O rescaled by the
//     correction; base-2 logits, one FMA and one ex2 per score where a tile
//     is all visible to a row.  A warpgroup skips (bar.red.and over its 128
//     threads) a tile past all its rows' horizons, or one whose keys are all
//     masked once each row has a visible key: their weights are exactly 0.
//   * O += P V by wgmma m64nDk16 with P from registers as the A operand, in
//     two bf16 terms, hi = bf16(P) and lo = bf16(P - hi), into one f32
//     accumulator: P to ~2**-17, so the output stays within one bf16 ulp of
//     the f32 plain version (one bf16 term missed it: tests/test_torch_-
//     kernels_cuda.py, bf16, d=16).  V is read MN-major (transposed) from its
//     swizzled boxes.  l stays f32, from the unrounded P.
//   * Epilogue: O / max(l, 1e-30) and lse in registers; the output is
//     staged through shared memory (the Q boxes' swizzle) for 16-byte
//     stores.
// bf16 at D = 16 and 32 (tests only) keeps the Ampere-style kernel below
// it: mma.sync.m16n8k16 from registers, a 2-stage cp.async ring; a
// 128-byte swizzle box needs 64 columns.
// f32 inputs (tests only): 64-row blocks of f32 tiles in shared memory,
// both products as f32 FMAs on the CUDA cores, the softmax in shared memory.
// Measured on an H100 80GB HBM3 at 700 W (the BERT-base shapes above,
// ragged key mask; chip_smoke.py phase 7 and PERF.md): 0.187-0.20 ms on
// CUDA events, against SDPA's 0.12-0.13 and the mma.sync kernel it
// replaced, 0.17-0.20; at 64 rows a CTA with no products at all (TMA,
// barriers, epilogue) already takes ~0.13 ms, and one key tile a CTA
// ~0.07: the loop's fixed costs, not the tensor cores, hold it back.  The
// first version (wmma, S and O round-tripping through shared memory) took
// 0.889-0.981 ms.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// NEG_INF in the tensor-core kernel's base-2 logits (logit * log2 e)
constexpr float kNegInfL2 = kNegInf * kLog2e;
constexpr int kBK = 64;  // keys per tile

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
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

// 2**x on the special-function unit (max relative error ~2**-22; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Exclusive end of the keys that query `row` visits (see the header).
__device__ __forceinline__ int row_horizon(int row, int Tk, int causal, int block_q,
                                           int block_k) {
  if (!causal) return Tk;
  const int qi = row / block_q;
  const int last_kb = min(((qi + 1) * block_q - 1) / block_k + 1, Tk / block_k);
  return last_kb * block_k;
}

// ------------------------------ bf16, D 16 and 32: the mma.sync kernel

template <int D>
struct TcLayout {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;                // query rows per block
  static constexpr int kRowB = D * 2 + 16;               // padded smem row, bytes
  static constexpr int kTileB = kBK * kRowB;             // a K or V tile
  static constexpr int kStageB = 2 * kTileB + kBK * 4;   // K, V, key mask
  static constexpr int kQB = kBQ * kRowB;
  static constexpr int kSmem = kQB + 2 * kStageB;
};

// Copy `rows` rows of D bf16 into padded smem rows with 16-byte cp.async,
// rows from `live` on zero-filled.
template <int D, int kThreads>
__device__ __forceinline__ void load_rows(unsigned char* dst, const __nv_bfloat16* src, int rows,
                                          int live, int tid) {
  constexpr int kRowChunks = D * 2 / 16;
  constexpr int kRowB = D * 2 + 16;
  const int chunks = rows * kRowChunks;
  for (int c = tid; c < chunks; c += kThreads) {
    const int row = c / kRowChunks, col = c % kRowChunks;
    unsigned char* d = dst + row * kRowB + col * 16;
    if (row < live)
      cp_async16(d, src + static_cast<size_t>(row) * D + col * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Two blocks per SM: at d <= 32 that caps a thread at 128 registers, which
// the kernel fits without spilling, and doubles the warps that hide each
// other's latency.
template <int D>
__global__ void __launch_bounds__(TcLayout<D>::kThreads, 2) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q,  // [BH, S, D]
    const __nv_bfloat16* __restrict__ k,  // [BH, Tk, D]
    const __nv_bfloat16* __restrict__ v,  // [BH, Tk, D]
    const float* __restrict__ mask,       // [BH / heads, Tk] or null
    __nv_bfloat16* __restrict__ out,      // [BH, S, D]
    float* __restrict__ lse,              // [BH, S]
    int S, int Tk, int heads, float scale, int causal, int block_q, int block_k) {
  using L = TcLayout<D>;
  constexpr int kThreads = L::kThreads, kBQ = L::kBQ, kRowB = L::kRowB;
  constexpr int kKS = D / 16;    // k steps of Q K^T
  constexpr int kNT = kBK / 8;   // 8-key n tiles of S
  constexpr int kNO = D / 8;     // 8-column n tiles of O
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* ring = smem + L::kQB;

  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * Tk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * Tk * D;
  const float* mrow = mask != nullptr ? mask + static_cast<size_t>(bh / heads) * Tk : nullptr;

  // horizons grow with the row, so the block's last live row has the largest
  const int end = row_horizon(min(q0 + kBQ, S) - 1, Tk, causal, block_q, block_k);
  const int n_tiles = (end + kBK - 1) / kBK;

  auto load_tile = [&](int t) {
    unsigned char* st = ring + (t % 2) * L::kStageB;
    const int k0 = t * kBK;
    load_rows<D, kThreads>(st, kb + static_cast<size_t>(k0) * D, kBK, Tk - k0, tid);
    load_rows<D, kThreads>(st + L::kTileB, vb + static_cast<size_t>(k0) * D, kBK, Tk - k0, tid);
    float* km = reinterpret_cast<float*>(st + 2 * L::kTileB);
    for (int j = tid; j < kBK; j += kThreads)
      km[j] = mrow != nullptr && k0 + j < Tk ? mrow[k0 + j] : 1.f;
  };

  load_rows<D, kThreads>(q_s, q + (static_cast<size_t>(bh) * S + q0) * D, kBQ, S - q0, tid);
  load_tile(0);
  cp_async_commit();

  // this thread's rows: r and r + 8 of the warp's 16
  const int r0 = q0 + warp * 16 + g;
  int hz[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    hz[hr] = r0 + hr * 8 < S ? row_horizon(r0 + hr * 8, Tk, causal, block_q, block_k) : 0;
  // the running max in base-2 logits (logit * log2 e), so p = 2**(t - m)
  // takes one FMA and one ex2; NEG_INF maps to kNegInfL2
  float m_r[2] = {kNegInfL2, kNegInfL2}, l_r[2] = {0.f, 0.f};
  const float c = scale * kLog2e;
  float o[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  uint32_t qf[kKS][4];

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t (and Q) landed; every thread is done with tile t-1's stage
    if (t == 0) {
      // A fragments of the warp's 16 rows: matrices (rows 0-7 | 8-15) x
      // (k 0-7 | 8-15) of each 16-wide k step
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const int row = warp * 16 + lane % 8 + ((lane / 8) & 1) * 8;
        const int col = ks * 16 + (lane / 16) * 8;
        ldmatrix_x4(qf[ks], q_s + row * kRowB + col * 2);
      }
    }
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();

    const unsigned char* st = ring + (t % 2) * L::kStageB;
    const unsigned char* k_s = st;
    const unsigned char* v_s = st + L::kTileB;
    const float* km = reinterpret_cast<const float*>(st + 2 * L::kTileB);
    const int k0 = t * kBK;

    // A key is dead when it is masked or past Tk: its weight is exactly 0
    // once the row has a visible key (2**(kNegInfL2 - m) underflows for any
    // m above kNegInfL2 / 2).  A warp whose rows all have one skips a tile of
    // dead keys: the update it skips would leave m, l and O bit for bit as
    // they are (corr = 1, p = 0).
    const bool dead0 = !(km[2 * lane] > 0.5f) || k0 + 2 * lane >= Tk;
    const bool dead1 = !(km[2 * lane + 1] > 0.5f) || k0 + 2 * lane + 1 >= Tk;
    if (__all_sync(0xffffffffu, dead0 && dead1) &&
        __all_sync(0xffffffffu, m_r[0] > 0.5f * kNegInfL2 && m_r[1] > 0.5f * kNegInfL2))
      continue;
    const bool all_live = __all_sync(0xffffffffu, !dead0 && !dead1);

    // ---- S = Q K^T (unscaled), in registers
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const unsigned char* krow = k_s + (nt * 8 + lane % 8) * kRowB;
      if constexpr (kKS % 2 == 0) {
#pragma unroll
        for (int ks = 0; ks < kKS; ks += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, krow + (ks * 16 + (lane / 8) * 8) * 2);
          mma_bf16(s[nt], qf[ks], r[0], r[1]);
          mma_bf16(s[nt], qf[ks + 1], r[2], r[3]);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          uint32_t r[2];
          ldmatrix_x2(r, krow + (ks * 16 + ((lane / 8) & 1) * 8) * 2);
          mma_bf16(s[nt], qf[ks], r[0], r[1]);
        }
      }
    }

    // ---- scale, masks, online softmax (rows r0 and r0 + 8)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + hr * 8;
      // the causal test can only fire on a tile that reaches past the row
      const bool diag = causal && k0 + kBK - 1 > row;
      // every key visible to the row (the same for the 4 threads of its
      // quad): the max of the raw scores, scaled once (c > 0), and
      // p = 2**(s c - m) in one FMA
      const bool visible = all_live && !diag && k0 + kBK <= hz[hr];
      float mx = -INFINITY;
      if (visible) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) mx = fmaxf(mx, s[nt][hr * 2 + e]);
      } else {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = nt * 8 + tig * 2 + e;
            const int key = k0 + j;
            float x = km[j] > 0.5f && !(diag && key > row) ? s[nt][hr * 2 + e] * c : kNegInfL2;
            if (key >= hz[hr]) x = -INFINITY;  // not visited by this row: weight exactly 0
            s[nt][hr * 2 + e] = x;
            mx = fmaxf(mx, x);
          }
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (visible) mx *= c;
      const float m_new = fmaxf(m_r[hr], mx);  // >= kNegInfL2: never -inf
      const float corr = ex2(m_r[hr] - m_new);
      m_r[hr] = m_new;
      float sum = 0.f;
      if (visible) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(s[nt][hr * 2 + e], c, -m_new));
            sum += p;
            s[nt][hr * 2 + e] = p;
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // subtract first: kNegInfL2 - kNegInfL2 must be exactly 0
            const float p = ex2(s[nt][hr * 2 + e] - m_new);
            sum += p;
            s[nt][hr * 2 + e] = p;
          }
        }
      }
      l_r[hr] = l_r[hr] * corr + sum;  // this thread's columns; quad-summed at the end
#pragma unroll
      for (int j = 0; j < kNO; ++j) {
        o[j][hr * 2] *= corr;
        o[j][hr * 2 + 1] *= corr;
      }
    }

    // ---- O += P V, P as hi + lo bf16 terms, 16 keys per k step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2) {
        // A register i2: n tile 2 kk + i2 / 2, row half i2 % 2
        const float p0 = s[2 * kk + i2 / 2][(i2 % 2) * 2];
        const float p1 = s[2 * kk + i2 / 2][(i2 % 2) * 2 + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        a_hi[i2] = *reinterpret_cast<const uint32_t*>(&hi);
        a_lo[i2] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
      }
      const unsigned char* vrow = v_s + (kk * 16 + lane % 8 + ((lane / 8) & 1) * 8) * kRowB;
#pragma unroll
      for (int jp = 0; jp < kNO / 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vrow + (jp * 16 + (lane / 16) * 8) * 2);
        mma_bf16(o[2 * jp], a_hi, r[0], r[1]);
        mma_bf16(o[2 * jp], a_lo, r[0], r[1]);
        mma_bf16(o[2 * jp + 1], a_hi, r[2], r[3]);
        mma_bf16(o[2 * jp + 1], a_lo, r[2], r[3]);
      }
    }
  }
  cp_async_wait_all();

  // ---- epilogue: normalise in registers, stage through the warp's Q rows
  unsigned char* o_s = q_s + warp * 16 * kRowB;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int row = r0 + hr * 8;
    // back to natural logits; a row that saw only NEG_INF keeps it exactly,
    // as lse = NEG_INF + log(l) rounds in the plain version (the backward
    // recomputes its p from this lse)
    const float m = m_r[hr] == kNegInfL2 ? kNegInf : m_r[hr] * kLn2;
    if (tig == 0 && row < S) lse[static_cast<size_t>(bh) * S + row] = m + logf(den);
#pragma unroll
    for (int j = 0; j < kNO; ++j)
      *reinterpret_cast<uint32_t*>(o_s + (g + hr * 8) * kRowB + (j * 8 + tig * 2) * 2) =
          pack_bf16(o[j][hr * 2] / den, o[j][hr * 2 + 1] / den);
  }
  __syncwarp();
  constexpr int kRowChunks = D * 2 / 16;
  __nv_bfloat16* ob = out + (static_cast<size_t>(bh) * S + q0 + warp * 16) * D;
#pragma unroll
  for (int c = lane; c < 16 * kRowChunks; c += 32) {
    const int row = c / kRowChunks, col = c % kRowChunks;
    if (q0 + warp * 16 + row < S)
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(row) * D + col * 8) =
          *reinterpret_cast<const uint4*>(o_s + row * kRowB + col * 16);
  }
}

// ------------------------------------- bf16, D 64 and 128: the Hopper kernel

// mbarriers, TMA and wgmma, in PTX

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// arrive, and expect `bytes` more of TMA traffic in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// expect `bytes` more of TMA traffic in this phase, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one [64 rows x 64 columns] bf16 box of a [BH, rows, D] tensor, 128-byte
// swizzled, completing on `bar`; rows past the tensor's arrive as zeros
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                             int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo_bytes, int sbo_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin a register array after a wgmma wait: the compiler may not move a read
// of an asynchronously written accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// true on every thread of a consumer warpgroup iff `pred` holds on all 128
// (named barrier `id`)
__device__ __forceinline__ bool wg_all(bool pred, int id) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\nbar.red.and.pred q, %2, 128, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(pred)), "r"(id)
      : "memory");
  return r != 0;
}

// d (+)= A B over one k16 step, m64n64k16, A and B from shared memory
// (both K-major, 128-byte swizzle); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A B over one k16 step, m64n64k16, A from registers (the m16n8k16
// A layout per warp), B from shared memory MN-major (transposed, 128-byte
// swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A B over one k16 step, m64n128k16, A from registers (the m16n8k16
// A layout per warp), B from shared memory MN-major (transposed, 128-byte
// swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Does a consumer warpgroup compute tile t?  Not when every one of its
// rows is past the tile (k0 >= the row's horizon: weight exactly 0) or the
// tile's keys are all dead and the row already has a visible key
// (2**(kNegInfL2 - m) underflows to 0 for any m above kNegInfL2 / 2): the
// update it skips would leave m, l and O bit for bit as they are.  m may be
// a tile behind (the pipeline decides before the previous softmax), which
// only skips less.  The same answer on all 128 threads.
__device__ __forceinline__ bool wg_computes(int t, bool dead, const int (&hz)[2],
                                            const float (&m_r)[2], int bar_id) {
  const int k0 = t * kBK;
  bool skip = true;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    skip = skip && (k0 >= hz[hr] || (dead && m_r[hr] > 0.5f * kNegInfL2));
  return !wg_all(skip, bar_id);
}

// A consumer warp is done with tile t's stage.
__device__ __forceinline__ void release_stage(uint64_t* empty, int t, int stages, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[t % stages]);
}

// The next tile from `scan` on, below `limit`, that the warpgroup computes
// (waiting for each to land), releasing the ones it skips; -1 when there is
// none below the limit.  Tile t of the work item is tile g0 + t of the ring.
template <int kStages>
__device__ __forceinline__ int next_tile(int& scan, int limit, int n_tiles, int g0, uint64_t* full,
                                         uint64_t* empty, const int* flag_s, const int (&hz)[2],
                                         const float (&m_r)[2], int bar_id, int lane) {
  for (; scan < min(limit, n_tiles); ++scan) {
    const int r = g0 + scan;
    mbar_wait(&full[r % kStages], (r / kStages) & 1);
    if (wg_computes(scan, (flag_s[r % kStages] & 1) != 0, hz, m_r, bar_id)) return scan++;
    release_stage(empty, r, kStages, lane);
  }
  return -1;
}

// Issue S = Q K^T of tile t (async, one commit group): D / 16 k steps of
// m64n64k16, box ks / 4, 32 bytes into its swizzled 128-byte rows.
template <int D, int kStages>
__device__ __forceinline__ void issue_s(float (&s)[32], uint64_t q_desc, const unsigned char* k_s,
                                        int t) {
  constexpr int kBoxB = 64 * 128;
  const uint64_t k_desc = smem_desc(k_s + (t % kStages) * (D / 64) * kBoxB, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint64_t off = ((ks / 4) * kBoxB + (ks % 4) * 32) >> 4;
    wgmma_ss_n64(s, q_desc + off, k_desc + off, ks > 0);
  }
  wgmma_commit();
}

// The online softmax of one tile's scores for this thread's rows r0 and
// r0 + 8, in place: s holds the raw scores on entry (the wgmma accumulator
// layout, the m16n8 layout per warp) and p on exit; m and l are updated
// and corr is each row's rescale of O.  Base-2 logits (cs = scale * log2
// e): one FMA and one ex2 per score where the tile is all visible to a row.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m_r)[2], float (&l_r)[2],
                                             float (&corr)[2], const float* km, bool all_live,
                                             int k0, int causal, int r0, const int (&hz)[2],
                                             float cs, int tig) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + hr * 8;
    // the causal test can only fire on a tile that reaches past the row
    const bool diag = causal && k0 + kBK - 1 > row;
    // every key visible to the row (the same for the 4 threads of its
    // quad): the max of the raw scores, scaled once (cs > 0), and
    // p = 2**(s cs - m) in one FMA
    const bool visible = all_live && !diag && k0 + kBK <= hz[hr];
    float mx = -INFINITY;
    if (visible) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) mx = fmaxf(mx, s[j * 4 + hr * 2 + e]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + tig * 2 + e;
          const int key = k0 + col;
          float x = km[col] > 0.5f && !(diag && key > row) ? s[j * 4 + hr * 2 + e] * cs
                                                          : kNegInfL2;
          if (key >= hz[hr]) x = -INFINITY;  // not visited by this row: weight exactly 0
          s[j * 4 + hr * 2 + e] = x;
          mx = fmaxf(mx, x);
        }
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (visible) mx *= cs;
    const float m_new = fmaxf(m_r[hr], mx);  // >= kNegInfL2: never -inf
    corr[hr] = ex2(m_r[hr] - m_new);
    m_r[hr] = m_new;
    float sum = 0.f;
    if (visible) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(s[j * 4 + hr * 2 + e], cs, -m_new));
          sum += p;
          s[j * 4 + hr * 2 + e] = p;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // subtract first: kNegInfL2 - kNegInfL2 must be exactly 0
          const float p = ex2(s[j * 4 + hr * 2 + e] - m_new);
          sum += p;
          s[j * 4 + hr * 2 + e] = p;
        }
    }
    l_r[hr] = l_r[hr] * corr[hr] + sum;  // this thread's columns; quad-summed at the end
  }
}

// P as the A operand of P V, in two bf16 terms hi = bf16(p) and
// lo = bf16(p - hi), 16 keys per k step: A register i2 of k step kk is n
// tile 2 kk + i2 / 2 of the scores, row half i2 % 2.
__device__ __forceinline__ void p_fragments(const float (&s)[32], uint32_t (&a_hi)[4][4],
                                            uint32_t (&a_lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i2 = 0; i2 < 4; ++i2) {
      const float p0 = s[(2 * kk + i2 / 2) * 4 + (i2 % 2) * 2];
      const float p1 = s[(2 * kk + i2 / 2) * 4 + (i2 % 2) * 2 + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      a_hi[kk][i2] = *reinterpret_cast<const uint32_t*>(&hi);
      a_lo[kk][i2] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
    }
  }
}

// O = O * corr + P V for one tile (async, one commit group): O rescaled in
// registers, then 4 k steps of m64nDk16 with P from registers (hi and lo
// into the one accumulator) and V MN-major (transposed) from the stage's
// swizzled boxes, the next 64 columns one box on.
template <int D, int kStages>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const float (&corr)[2],
                                         const uint32_t (&a_hi)[4][4],
                                         const uint32_t (&a_lo)[4][4],
                                         const unsigned char* v_s, int t) {
  constexpr int kBoxB = 64 * 128;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[j * 4 + 0] *= corr[0];
    o[j * 4 + 1] *= corr[0];
    o[j * 4 + 2] *= corr[1];
    o[j * 4 + 3] *= corr[1];
  }
  const uint64_t v_desc = smem_desc(v_s + (t % kStages) * (D / 64) * kBoxB, kBoxB, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t off = (kk * 16 * 128) >> 4;  // 16 keys of 128-byte rows
    if constexpr (D == 64) {
      wgmma_rs_n64(o, a_hi[kk], v_desc + off);
      wgmma_rs_n64(o, a_lo[kk], v_desc + off);
    } else {
      wgmma_rs_n128(o, a_hi[kk], v_desc + off);
      wgmma_rs_n128(o, a_lo[kk], v_desc + off);
    }
  }
  wgmma_commit();
}

template <int D, int NWG>
struct WgLayout {
  static constexpr int kCB = D / 64;              // 64-column (128-byte) boxes of a row
  static constexpr int kBoxB = 64 * 128;          // one [64 x 64] bf16 box
  static constexpr int kStages = 3;
  static constexpr int kThreads = 128 * (NWG + 1);  // producer warpgroup + consumers
  static constexpr int kQB = NWG * kCB * kBoxB;   // Q of a work item, 64 rows per consumer
  static constexpr int kKVB = kCB * kBoxB;        // one K or V tile of 64 keys
  static constexpr int kKOff = 2 * kQB;           // Q in two slots: the next item's loads early
  static constexpr int kVOff = kKOff + kStages * kKVB;
  static constexpr int kOOff = kVOff + kStages * kKVB;           // the output's staging
  static constexpr int kMaskOff = kOOff + kQB;                    // [stages][64] f32
  static constexpr int kFlagOff = kMaskOff + kStages * kBK * 4;  // [stages] int
  static constexpr int kBarOff = kFlagOff + kStages * 8;  // q_full[2], q_empty[2], full[], empty[]
  static constexpr int kSmem = kBarOff + (4 + 2 * kStages) * 8 + 1024;  // + alignment slack
};

// Hopper forward, persistent: each CTA walks work items (64 * NWG query
// rows of one bh) item = blockIdx.x, + gridDim.x, ...  Warpgroup 0 is the
// producer (one warp issues TMA, its registers cut to 24); warpgroups
// 1..NWG each own 64 query rows of the item.  Q goes to one of two slots,
// so the next item's Q loads under the current item's last tiles; K, V and
// the key-mask values of a 64-key tile go through a ring of kStages stages
// with full and empty mbarriers, its tile count running on across items.
template <int D, int NWG>
__global__ void __launch_bounds__(WgLayout<D, NWG>::kThreads, NWG == 1 ? 2 : 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const float* __restrict__ mask,  // [BH / heads, Tk] or null
                           __nv_bfloat16* __restrict__ out,  // [BH, S, D]
                           float* __restrict__ lse,          // [BH, S]
                           int BH, int S, int Tk, int heads, float scale, int causal, int block_q,
                           int block_k) {
  using L = WgLayout<D, NWG>;
  constexpr int kCB = L::kCB, kStages = L::kStages;
  constexpr int kNO = D / 8;  // 8-column n tiles of O
  constexpr int kRows = 64 * NWG;
  const int q_blocks = (S + kRows - 1) / kRows;
  const int n_items = BH * q_blocks;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes need 1024-byte aligned bases
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* k_s = smem + L::kKOff;
  unsigned char* v_s = smem + L::kVOff;
  unsigned char* o_s = smem + L::kOOff;
  float* km_s = reinterpret_cast<float*>(smem + L::kMaskOff);
  int* flag_s = reinterpret_cast<int*>(smem + L::kFlagOff);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kStages;

  // Item i's (bh, first row).  Without causal every item costs the same:
  // the q blocks of one bh run side by side and share its K and V in L2.
  // Under causal an item's cost grows with its q block: the most costly
  // come first, over every bh, so each CTA's share balances (a CTA would
  // otherwise meet the same q block every time: the grid is a multiple of
  // the q blocks).
  auto item_at = [&](int i, int& bh, int& q0) {
    const int qb = causal ? q_blocks - 1 - i / BH : i % q_blocks;
    bh = causal ? i % BH : i / q_blocks;
    q0 = qb * kRows;
  };
  // the key tiles an item visits: horizons grow with the row, so the
  // item's last live row has the largest
  auto item_tiles = [&](int q0) {
    return (row_horizon(min(q0 + kRows, S) - 1, Tk, causal, block_q, block_k) + kBK - 1) / kBK;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 4 * NWG);  // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);        // the producer warp's lanes, and the TMA bytes
      mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 0) {
      int g0 = 0;  // the ring's tiles before this item's
      for (int item = blockIdx.x, li = 0; item < n_items; item += gridDim.x, ++li) {
        int bh, q0;
        item_at(item, bh, q0);
        const int n_tiles = item_tiles(q0);
        const int qs = li & 1;
        if (lane == 0) {
          mbar_wait(&q_empty[qs], ((li >> 1) & 1) ^ 1);
          mbar_arrive_tx(&q_full[qs], L::kQB);
#pragma unroll
          for (int w = 0; w < NWG; ++w)
#pragma unroll
            for (int cb = 0; cb < kCB; ++cb)
              tma_load_box(q_s + qs * L::kQB + (w * kCB + cb) * L::kBoxB, &tq, &q_full[qs],
                           cb * 64, q0 + 64 * w, bh);
        }
        const float* mrow =
            mask != nullptr ? mask + static_cast<size_t>(bh / heads) * Tk : nullptr;
        // a tile's key-mask values are loaded a tile ahead, so their latency
        // hides under the wait for a free stage
        float mk[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          mk[e] = mrow != nullptr && 2 * lane + e < Tk ? mrow[2 * lane + e] : 1.f;
        for (int t = 0; t < n_tiles; ++t) {
          const int r = g0 + t;
          const int st = r % kStages;
          mbar_wait(&empty[st], ((r / kStages) & 1) ^ 1);
          const int k0 = t * kBK;
          if (lane == 0) {
            mbar_expect_tx(&full[st], 2 * L::kKVB);
#pragma unroll
            for (int cb = 0; cb < kCB; ++cb) {
              tma_load_box(k_s + st * L::kKVB + cb * L::kBoxB, &tk, &full[st], cb * 64, k0, bh);
              tma_load_box(v_s + st * L::kKVB + cb * L::kBoxB, &tv, &full[st], cb * 64, k0, bh);
            }
          }
          float* km = km_s + st * kBK;
          bool dead[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            km[2 * lane + e] = mk[e];
            dead[e] = !(mk[e] > 0.5f) || k0 + 2 * lane + e >= Tk;
          }
          const bool all_dead = __all_sync(0xffffffffu, dead[0] && dead[1]);
          const bool all_live = __all_sync(0xffffffffu, !dead[0] && !dead[1]);
          if (lane == 0) flag_s[st] = (all_dead ? 1 : 0) | (all_live ? 2 : 0);
          mbar_arrive(&full[st]);  // after this lane's mask (and lane 0's flag) stores
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + kBK + 2 * lane + e;
            mk[e] = mrow != nullptr && key < Tk ? mrow[key] : 1.f;
          }
        }
        g0 += n_tiles;
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(NWG == 1 ? 232 : 240) : "memory");
    const int c = wg - 1;            // this warpgroup's 64 rows of an item
    const int bar_id = 1 + c;        // its named barrier
    const int g = lane / 4, tig = lane % 4;
    const float cs = scale * kLog2e;
    int g0 = 0;  // the ring's tiles before this item's
    for (int item = blockIdx.x, li = 0; item < n_items; item += gridDim.x, ++li) {
      int bh, q0;
      item_at(item, bh, q0);
      const int n_tiles = item_tiles(q0);
      const int qs = li & 1;
      const int r0 = q0 + 64 * c + warp * 16 + g;  // this thread's rows: r0, r0 + 8
      int hz[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        hz[hr] = r0 + hr * 8 < S ? row_horizon(r0 + hr * 8, Tk, causal, block_q, block_k) : 0;
      // the running max in base-2 logits (logit * log2 e), so p = 2**(t - m)
      // takes one FMA and one ex2; NEG_INF maps to kNegInfL2
      float m_r[2] = {kNegInfL2, kNegInfL2}, l_r[2] = {0.f, 0.f};
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      const uint64_t q_desc = smem_desc(q_s + qs * L::kQB + c * kCB * L::kBoxB, 16, 1024);

      // The pipeline, as FlashAttention-3 orders it: S of tile t is issued,
      // then O's rescale and P V of the tile before it, and the softmax of
      // t runs while that P V (the larger product: two terms) is on the
      // tensor cores.  Each iteration ends with nothing in flight, so every
      // wgmma's registers are settled where ptxas can see it.  The stages
      // held: `prev`'s (its V not yet read); tile t lands only after tile
      // t - kStages is released, so the search for the next tile stops
      // short of prev + kStages, and past it prev's P V runs first.
      int scan = 0, prev = -1;
      float corr[2];
      uint32_t a_hi[4][4], a_lo[4][4];
#define NEXT_TILE(limit) \
  next_tile<kStages>(scan, limit, n_tiles, g0, full, empty, flag_s, hz, m_r, bar_id, lane)
#define SOFTMAX(t)                                                                    \
  softmax_tile(s, m_r, l_r, corr, km_s + ((g0 + (t)) % kStages) * kBK,                \
               (flag_s[(g0 + (t)) % kStages] & 2) != 0, (t) * kBK, causal, r0, hz, cs, tig)
      mbar_wait(&q_full[qs], (li >> 1) & 1);
      for (;;) {
        float s[32];
        int t = prev >= 0 ? NEXT_TILE(prev + kStages) : -1;
        if (t < 0) {
          // nothing to compute in the window: finish prev, then look on
          if (prev >= 0) {
            issue_pv<D, kStages>(o, corr, a_hi, a_lo, v_s, g0 + prev);
            wgmma_wait<0>();
            fence_regs(o);
            release_stage(empty, g0 + prev, kStages, lane);
            prev = -1;
          }
          t = NEXT_TILE(n_tiles);
          if (t < 0) break;
          issue_s<D, kStages>(s, q_desc, k_s, g0 + t);
          wgmma_wait<0>();
          fence_regs(s);
        } else {
          issue_s<D, kStages>(s, q_desc, k_s, g0 + t);
          issue_pv<D, kStages>(o, corr, a_hi, a_lo, v_s, g0 + prev);
          wgmma_wait<1>();  // S of t; P V of prev runs under the softmax
          fence_regs(s);
        }
        SOFTMAX(t);
        if (prev >= 0) {
          wgmma_wait<0>();
          fence_regs(o);
          release_stage(empty, g0 + prev, kStages, lane);
        }
        p_fragments(s, a_hi, a_lo);
        prev = t;
      }
#undef SOFTMAX
#undef NEXT_TILE
      // every product of the item is done: its Q slot is free for the item
      // after next
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[qs]);
      g0 += n_tiles;

      // ---- epilogue: normalise in registers, stage the warp's 16 rows
      // through its rows of the output buffer (the 128-byte swizzle of the
      // Q boxes) for 16-byte stores
      unsigned char* ow = o_s + c * kCB * L::kBoxB;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float l = l_r[hr];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float den = fmaxf(l, 1e-30f);
        const int row = r0 + hr * 8;
        // back to natural logits; a row that saw only NEG_INF keeps it
        // exactly, as lse = NEG_INF + log(l) rounds in the plain version
        // (the backward recomputes its p from this lse)
        const float m = m_r[hr] == kNegInfL2 ? kNegInf : m_r[hr] * kLn2;
        if (tig == 0 && row < S) lse[static_cast<size_t>(bh) * S + row] = m + logf(den);
        const int lr = warp * 16 + g + hr * 8;  // row within the warpgroup's 64
#pragma unroll
        for (int j = 0; j < kNO; ++j) {
          const int col = j * 8 + tig * 2;
          const int cb = col / 64, chunk = (col % 64) / 8;
          *reinterpret_cast<uint32_t*>(ow + cb * L::kBoxB + lr * 128 +
                                       ((chunk ^ (lr % 8)) * 16) + (col % 8) * 2) =
              pack_bf16(o[j * 4 + hr * 2] / den, o[j * 4 + hr * 2 + 1] / den);
        }
      }
      __syncwarp();
      constexpr int kRowChunks = D / 8;  // 16-byte chunks of an output row
      __nv_bfloat16* ob = out + (static_cast<size_t>(bh) * S + q0 + 64 * c + warp * 16) * D;
#pragma unroll
      for (int i = lane; i < 16 * kRowChunks; i += 32) {
        const int rr = i / kRowChunks, ch = i % kRowChunks;
        const int lr = warp * 16 + rr;
        const int cb = ch / 8, cc = ch % 8;
        if (q0 + 64 * c + lr < S)
          *reinterpret_cast<uint4*>(ob + static_cast<size_t>(rr) * D + ch * 8) =
              *reinterpret_cast<const uint4*>(ow + cb * L::kBoxB + lr * 128 + ((cc ^ (lr % 8)) * 16));
      }
      __syncwarp();  // the warp's staged rows are read before the next item writes them
    }
  }
}

// ------------------------------------------------- f32: CUDA-core kernel

constexpr int kF32BQ = 64;        // query rows per block
constexpr int kF32Threads = 128;  // two threads per query row

// Shared-memory row strides, in floats, padded by 16 bytes.
template <int D> constexpr int kLdT = D + 4;  // Q, K, V
constexpr int kLdS = kBK + 4;                 // scores, then P
template <int D> constexpr int kLdO = D + 4;  // accumulator

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int live, int tid) {
  constexpr int kChunks = 64 * D / 4;
  static_assert(kChunks % kF32Threads == 0, "tile chunks must split evenly");
#pragma unroll
  for (int it = 0; it < kChunks / kF32Threads; ++it) {
    const int c = tid + it * kF32Threads;
    const int row = c * 4 / D, col = c * 4 - row * D;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < live) val = reinterpret_cast<const float4*>(src)[c];
    *reinterpret_cast<float4*>(dst + row * kLdT<D> + col) = val;
  }
}

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (3 * static_cast<size_t>(kF32BQ) * kLdT<D>  // Q, K, V tiles
                          + static_cast<size_t>(kF32BQ) * kLdS        // scores / P
                          + static_cast<size_t>(kF32BQ) * kLdO<D>     // accumulator
                          + 3 * kF32BQ + kBK)                         // m, l, corr, key mask
         + sizeof(int) * kF32BQ;                                      // horizons
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse, int S,
    int Tk, int heads, float scale, int causal, int block_q, int block_k) {
  constexpr int LT = kLdT<D>, LO = kLdO<D>;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kF32BQ;
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kF32BQ * LT;
  float* v_s = k_s + kBK * LT;
  float* p_s = v_s + kBK * LT;
  float* o_s = p_s + kF32BQ * kLdS;
  float* m_s = o_s + kF32BQ * LO;
  float* l_s = m_s + kF32BQ;
  float* c_s = l_s + kF32BQ;
  float* km_s = c_s + kF32BQ;  // this tile's key mask, 1 where no mask is given
  int* hz_s = reinterpret_cast<int*>(km_s + kBK);

  const float* qb = q + static_cast<size_t>(bh) * S * D;
  const float* kb = k + static_cast<size_t>(bh) * Tk * D;
  const float* vb = v + static_cast<size_t>(bh) * Tk * D;
  const float* mrow = mask != nullptr ? mask + static_cast<size_t>(bh / heads) * Tk : nullptr;

  load_tile_f32<D>(q_s, qb + static_cast<size_t>(q0) * D, S - q0, tid);
  for (int i = tid; i < kF32BQ * LO; i += kF32Threads) o_s[i] = 0.f;
  for (int r = tid; r < kF32BQ; r += kF32Threads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    // rows past S visit nothing: they stay finite and are never stored
    hz_s[r] = q0 + r < S ? row_horizon(q0 + r, Tk, causal, block_q, block_k) : 0;
  }
  const int end = row_horizon(min(q0 + kF32BQ, S) - 1, Tk, causal, block_q, block_k);
  const int r = tid / 2;     // this thread's softmax row
  const int half = tid % 2;  // ... and which half of the key tile it takes

  for (int k0 = 0; k0 < end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile_f32<D>(k_s, kb + static_cast<size_t>(k0) * D, Tk - k0, tid);
    load_tile_f32<D>(v_s, vb + static_cast<size_t>(k0) * D, Tk - k0, tid);
    for (int j = tid; j < kBK; j += kF32Threads)
      km_s[j] = mrow != nullptr && k0 + j < Tk ? mrow[k0 + j] : 1.f;
    __syncthreads();

    for (int i = tid; i < kF32BQ * kBK; i += kF32Threads) {
      const int rr = i / kBK, j = i - rr * kBK;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[rr * LT + d], k_s[j * LT + d], dot);
      p_s[rr * kLdS + j] = dot;
    }
    __syncthreads();

    // online softmax: two threads per row, 32 keys each, each lane starting
    // at its own offset so the warp's lanes hit different banks
    {
      const int row = q0 + r;
      const int hz = hz_s[r];
      float* sr = p_s + r * kLdS + half * (kBK / 2);
      float mloc = -INFINITY;
      for (int t = 0; t < kBK / 2; ++t) {
        const int jj = (t + lane) % (kBK / 2);
        const int key = k0 + half * (kBK / 2) + jj;
        float s;
        if (key >= hz) {
          s = -INFINITY;  // not visited by this row: weight exactly 0
        } else {
          s = sr[jj] * scale;
          if (causal && key > row) s = kNegInf;
          if (!(km_s[key - k0] > 0.5f)) s = kNegInf;
        }
        sr[jj] = s;
        mloc = fmaxf(mloc, s);
      }
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mloc);  // >= NEG_INF: never -inf
      float sum = 0.f;
      for (int t = 0; t < kBK / 2; ++t) {
        const int jj = (t + lane) % (kBK / 2);
        const float p = expf(sr[jj] - m_new);
        sr[jj] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float corr = expf(m_old - m_new);
      // both threads of the row hold m_old, m_new, sum and corr here: the
      // shuffles above ordered their reads of m_s before this write
      if (half == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
      float* orow = o_s + r * LO + half * (D / 2);
      for (int t = 0; t < D / 2; ++t) orow[(t + lane) % (D / 2)] *= corr;
    }
    __syncthreads();

    for (int i = tid; i < kF32BQ * D; i += kF32Threads) {
      const int rr = i / D, d = i - rr * D;
      float a = o_s[rr * LO + d];
      for (int j = 0; j < kBK; ++j) a = fmaf(p_s[rr * kLdS + j], v_s[j * LT + d], a);
      o_s[rr * LO + d] = a;
    }
  }
  __syncthreads();

  float* ob = out + static_cast<size_t>(bh) * S * D;
  for (int i = tid; i < kF32BQ * D; i += kF32Threads) {
    const int rr = i / D, d = i - rr * D;
    if (q0 + rr < S)
      ob[static_cast<size_t>(q0) * D + i] = o_s[rr * LO + d] / fmaxf(l_s[rr], 1e-30f);
  }
  for (int rr = tid; rr < kF32BQ; rr += kF32Threads) {
    if (q0 + rr < S)
      lse[static_cast<size_t>(bh) * S + q0 + rr] = m_s[rr] + logf(fmaxf(l_s[rr], 1e-30f));
  }
}

// ----------------------------------------------------------------- launch

// Raise a kernel's dynamic shared-memory limit once (one host call per
// kernel instead of one per launch).
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem, bool& done) {
  if (done || smem <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* mask, void* out,
              void* lse, int BH, int S, int Tk, int heads, float scale, int causal,
              int block_q, int block_k, cudaStream_t stream) {
  using L = TcLayout<D>;
  auto kernel = flash_fwd_tc_kernel<D>;
  static bool done = false;
  if (int err = set_smem(kernel, L::kSmem, done)) return err;
  kernel<<<dim3((S + L::kBQ - 1) / L::kBQ, BH), L::kThreads, L::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), S, Tk, heads, scale, causal,
      block_q, block_k);
  return static_cast<int>(cudaGetLastError());
}

// returned when the host cannot encode a tensor map for the inputs
constexpr int kErrTensorMap = 100001;
// Consumer warpgroups per CTA at head_dim D: two (128 rows, one CTA per
// SM at 168 registers a thread) at D 128, where a thread's O takes 64
// registers; one (64 rows, two CTAs per SM, each CTA's prologue and
// epilogue under the other's main loop) at D 64.  Each measured the faster
// at its shapes on the H100 (PERF.md).
constexpr int consumers(int D) { return D == 128 ? 2 : 1; }

// A TMA map of a [BH, rows, D] bf16 tensor in boxes of [64 rows x 64
// columns], 128-byte swizzled; reads past `rows` fill with zeros.
int encode_rows(CUtensorMap* map, const void* base, int D, int rows, int BH) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int D, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, const void* mask, void* out,
                 void* lse, int BH, int S, int Tk, int heads, float scale, int causal,
                 int block_q, int block_k, cudaStream_t stream) {
  using L = WgLayout<D, NWG>;
  auto kernel = flash_fwd_wgmma_kernel<D, NWG>;
  static bool done = false;
  if (int err = set_smem(kernel, L::kSmem, done)) return err;
  // persistent: as many CTAs as the card holds at once, or one per item
  static int slots = 0;
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, L::kThreads, L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    slots = sms * per_sm;
  }
  CUtensorMap tq, tk, tv;
  if (encode_rows(&tq, q, D, S, BH) || encode_rows(&tk, k, D, Tk, BH) ||
      encode_rows(&tv, v, D, Tk, BH))
    return kErrTensorMap;
  const int items = BH * ((S + 64 * NWG - 1) / (64 * NWG));
  kernel<<<min(items, slots), L::kThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), BH, S, Tk, heads, scale, causal, block_q, block_k);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* mask, void* out,
               void* lse, int BH, int S, int Tk, int heads, float scale, int causal,
               int block_q, int block_k, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<D>;
  constexpr size_t smem = f32_smem_bytes<D>();
  static bool done = false;
  if (int err = set_smem(kernel, smem, done)) return err;
  kernel<<<dim3((S + kF32BQ - 1) / kF32BQ, BH), kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(mask), static_cast<float*>(out), static_cast<float*>(lse), S, Tk,
      heads, scale, causal, block_q, block_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = f32 (CUDA-core FMAs), 1 = bf16 (tensor cores: wgmma at D 64
// and 128, mma.sync at 16 and 32).  head_dim D is one of 16, 32, 64, 128.
// mask may be null.  q, k and v must be 16-byte aligned.  Launches on
// `stream` and returns cudaGetLastError() (0 on success; kErrTensorMap when
// a TMA map cannot be encoded); never synchronises.
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                        void* out, void* lse, int dtype, int BH, int S, int Tk, int D,
                        int heads, float scale, int causal, int block_q, int block_k,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, mask, out, lse, BH, S, Tk, heads, scale, causal, block_q, block_k, s
  if (dtype == 1) {
    switch (D) {
      case 16: return launch_tc<16>(FLASH_ARGS);
      case 32: return launch_tc<32>(FLASH_ARGS);
      case 64: return launch_wgmma<64, consumers(64)>(FLASH_ARGS);
      case 128: return launch_wgmma<128, consumers(128)>(FLASH_ARGS);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 16: return launch_f32<16>(FLASH_ARGS);
      case 32: return launch_f32<32>(FLASH_ARGS);
      case 64: return launch_f32<64>(FLASH_ARGS);
      case 128: return launch_f32<128>(FLASH_ARGS);
    }
  }
#undef FLASH_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled refused the inputs' TMA map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
