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
// bf16 terms (below), the tensor cores do 1.5x the model's FLOPs.
//
// Design (bf16, the training path): FlashAttention-2 with everything that
// can stay in registers in registers.
//   * A block takes 128 query rows with 8 warps, 16 rows a warp (64 rows
//     and 4 warps at d = 128, where the register-resident O is twice as
//     wide).  The Q fragments are loaded into registers once (ldmatrix).
//   * K and V tiles of 64 keys go through a 2-stage cp.async ring of
//     16-byte copies, one barrier per tile: tile j+1 loads while tile j is
//     computed.  Every shared-memory row is padded by 16 bytes, which makes
//     the ldmatrix row addresses of one 8x8 matrix fall in 8 different
//     4-bank groups.  The tile's key-mask values are staged beside it.
//   * S = Q K^T by mma.sync.m16n8k16 (bf16 in, f32 out) into registers; S
//     never touches shared memory.  Scale, the row horizon, causal and key
//     mask are applied in registers; the row max and sum run across the 4
//     threads of an mma quad with __shfl_xor_sync, and the register O is
//     rescaled by the correction.  The softmax runs in base-2 logits, one
//     FMA and one ex2 per score where a tile is all visible to a row, and
//     a warp whose rows have a visible key skips a tile whose keys are all
//     masked (their weight is exactly 0 then).
//   * P goes from the S accumulator registers straight into A fragments,
//     as two bf16 terms, hi = bf16(P) and lo = bf16(P - hi), two mma per
//     k step into one f32 accumulator: P to ~2**-17, so the output stays
//     within one bf16 ulp of the f32 plain version (one bf16 term missed
//     it: tests/test_torch_kernels_cuda.py, bf16, d=16).  l stays f32, from
//     the unrounded P.  V's B fragments come from ldmatrix.trans.
//   * Epilogue: O / max(l, 1e-30) and lse in registers; the output is
//     staged through the warp's rows of the Q tile for 16-byte stores.
// f32 inputs (tests only): 64-row blocks of f32 tiles in shared memory,
// both products as f32 FMAs on the CUDA cores, the softmax in shared memory.
// Measured by chip_smoke.py phase 7 on an H100 80GB HBM3 at 700 W (the
// BERT-base shapes above, ragged key mask): 0.17-0.20 ms, against SDPA's
// 0.12-0.14 ms with the same mask; the first version (wmma, S and O
// round-tripping through shared memory) took 0.889-0.981 ms.

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

// ------------------------------------------------ bf16: tensor-core kernel

template <int D>
struct TcLayout {
  static constexpr int kWarps = D == 128 ? 4 : 8;
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

// Two blocks per SM: at d <= 64 that caps a thread at 128 registers, which
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

// dtype: 0 = f32 (CUDA-core FMAs), 1 = bf16 (tensor cores).  head_dim D is
// one of 16, 32, 64, 128.  mask may be null.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); never synchronises.
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
      case 64: return launch_tc<64>(FLASH_ARGS);
      case 128: return launch_tc<128>(FLASH_ARGS);
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
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
