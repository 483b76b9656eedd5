// Flash attention forward for Hopper (sm_90a), C ABI for ctypes.
//
// Replaces the TPU kernel kubeflow_tpu/ops/flash_attention.py (_fwd_kernel,
// launched by _flash_fwd through pl.pallas_call): blockwise attention over
// [B*H, S, d] rows with an online softmax over key tiles, emitting the
// output in q's type and the f32 log-sum-exp of every query row.
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
// Design.  The TPU grid walks (row, q block) and keeps a whole row's K and V
// in VMEM.  Here one block of 4 warps takes 64 query rows of one (batch,
// head) row and walks 64-key tiles of K and V through shared memory, up to
// the largest horizon among its rows; the per-row running max, sum and
// correction sit in shared memory, the f32 accumulator of the 64 rows too.
// Each key tile takes three steps: scores S = Q K^T, the online-softmax
// update (two threads per row, a shuffle to combine their halves), then
// O = O * corr + P V.
//   * bf16 inputs (the training path): the two products run on tensor cores
//     through nvcuda::wmma 16x16x16 bf16 fragments with f32 accumulation;
//     warp w owns query rows [16w, 16w + 16).  The tensor cores take P in
//     bf16, whose 2**-9 relative rounding is too coarse: an output that is a
//     near-cancellation of V rows then misses the f32 reference by more
//     than one bf16 ulp (a version with P in one bf16 term failed
//     tests/test_torch_kernels_cuda.py on the card that way).
//     So P goes in as two bf16 terms, hi = bf16(P) and lo = bf16(P - hi),
//     two products into one f32 accumulator: P to ~2**-17, as good as f32
//     for a bf16 output.  Its sum l stays f32, from the unrounded values.
//   * f32 inputs: the same tiles, with both products in f32 FMAs on the CUDA
//     cores, so the result matches the f32 reference to rounding order.
//
// What bounds it.  At BERT-base (B*H = 384, S = T = 512, d = 64, bf16) one
// call reads q, k, v and writes o, 4 x 25.2 MB, for 25.8 GFLOP: 30 us of
// bytes at 3.35 TB/s against 26 us of bf16 tensor-core work, so bytes by a
// hair and compute close behind.  This first version does not come near
// either (chip_smoke.py phase 7 measures ~0.9 ms on an H100 at 700 W): the
// wmma path stages every product through shared memory, round-trips the
// accumulator through shared memory once per key tile, runs the softmax
// on two threads per row between block-wide barriers, and loads tiles
// synchronously.  mma.sync or wgmma with the accumulator in registers, TMA
// loads double-buffered behind an mbarrier and a larger query tile per
// block are the known next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e9f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps: two threads per query row

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory row strides, in elements.  Every row is padded by 16 bytes
// (8 bf16, 4 floats): unpadded, the rows of a tile are 128 or 256 bytes
// apart, so the rows a wmma fragment load or store touches all start in the
// same bank and serialise.  The strides keep wmma's rules: a multiple of 8
// elements for bf16, of 4 for floats, fragment starts 32-byte aligned.
template <typename T, int D> constexpr int kLdT = D + 16 / sizeof(T);  // Q, K, V
constexpr int kLdP = kBK + 8;                                          // P
constexpr int kLdS = kBK + 4;                                          // scores
template <int D> constexpr int kLdO = D + 4;                           // accumulator

// Copy a 64-row tile of D-wide rows into shared memory (row stride
// kLdT<T, D>) in 16-byte chunks, rows from `live` on zero-filled.  The trip
// count is a compile-time constant, so every thread issues its chunks
// together and their latencies overlap.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int live, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = 64 * D / kVec;
  static_assert(kChunks % kThreads == 0, "tile chunks must split evenly");
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int c = tid + it * kThreads;
    const int row = c * kVec / D, col = c * kVec - row * D;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < live) val = reinterpret_cast<const uint4*>(src)[c];
    *reinterpret_cast<uint4*>(dst + row * kLdT<T, D> + col) = val;
  }
}

// Exclusive end of the keys that query `row` visits (see the header).
__device__ __forceinline__ int row_horizon(int row, int Tk, int causal, int block_q,
                                           int block_k) {
  if (!causal) return Tk;
  const int qi = row / block_q;
  const int last_kb = min(((qi + 1) * block_q - 1) / block_k + 1, Tk / block_k);
  return last_kb * block_k;
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(T) * (3 * static_cast<size_t>(kBQ) * kLdT<T, D>  // Q, K, V tiles
                      + 2 * static_cast<size_t>(kBQ) * kLdP)     // P (hi, lo)
         + sizeof(float) * (static_cast<size_t>(kBQ) * kLdS       // scores
                            + static_cast<size_t>(kBQ) * kLdO<D>  // accumulator
                            + 3 * kBQ + kBK)                      // m, l, corr, key mask
         + sizeof(int) * kBQ;                                     // horizons
}

// kTC: the two products on tensor cores (bf16 only), else f32 FMAs.
template <typename T, int D, bool kTC>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q,        // [BH, S, D]
    const T* __restrict__ k,        // [BH, Tk, D]
    const T* __restrict__ v,        // [BH, Tk, D]
    const float* __restrict__ mask, // [BH / heads, Tk] or null
    T* __restrict__ out,            // [BH, S, D]
    float* __restrict__ lse,        // [BH, S]
    int S, int Tk, int heads, float scale, int causal, int block_q, int block_k) {
  constexpr int LT = kLdT<T, D>, LO = kLdO<D>;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kBQ * LT;
  T* v_s = k_s + kBK * LT;
  T* p_s = v_s + kBK * LT;      // P, rounded to T
  T* plo_s = p_s + kBQ * kLdP;  // bf16 only: P - bf16(P), rounded to bf16
  float* s_s = reinterpret_cast<float*>(plo_s + kBQ * kLdP);
  float* o_s = s_s + kBQ * kLdS;
  float* m_s = o_s + kBQ * LO;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;
  float* km_s = c_s + kBQ;      // this tile's key mask, 1 where no mask is given
  int* hz_s = reinterpret_cast<int*>(km_s + kBK);

  const T* qb = q + static_cast<size_t>(bh) * S * D;
  const T* kb = k + static_cast<size_t>(bh) * Tk * D;
  const T* vb = v + static_cast<size_t>(bh) * Tk * D;
  const float* mrow = mask != nullptr ? mask + static_cast<size_t>(bh / heads) * Tk : nullptr;

  load_tile<T, D>(q_s, qb + static_cast<size_t>(q0) * D, S - q0, tid);
  for (int i = tid; i < kBQ * LO; i += kThreads) o_s[i] = 0.f;
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    // rows past S visit nothing: they stay finite and are never stored
    hz_s[r] = q0 + r < S ? row_horizon(q0 + r, Tk, causal, block_q, block_k) : 0;
  }
  // horizons grow with the row, so the block's last live row has the largest
  const int end = row_horizon(min(q0 + kBQ, S) - 1, Tk, causal, block_q, block_k);
  const int r = tid / 2;     // this thread's softmax row
  const int half = tid % 2;  // ... and which half of the key tile it takes

  for (int k0 = 0; k0 < end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, D>(k_s, kb + static_cast<size_t>(k0) * D, Tk - k0, tid);
    load_tile<T, D>(v_s, vb + static_cast<size_t>(k0) * D, Tk - k0, tid);
    for (int j = tid; j < kBK; j += kThreads)
      km_s[j] = mrow != nullptr && k0 + j < Tk ? mrow[k0 + j] : 1.f;
    __syncthreads();

    // ---- scores S = Q K^T (unscaled)
    if constexpr (kTC) {
      for (int n = 0; n < kBK / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(a, q_s + warp * 16 * LT + kk * 16, LT);
          wmma::load_matrix_sync(b, k_s + n * 16 * LT + kk * 16, LT);
          wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(s_s + warp * 16 * kLdS + n * 16, c, kLdS, wmma::mem_row_major);
      }
    } else {
      for (int i = tid; i < kBQ * kBK; i += kThreads) {
        const int rr = i / kBK, j = i - rr * kBK;
        float dot = 0.f;
        for (int d = 0; d < D; ++d)
          dot = fmaf(q_s[rr * LT + d], k_s[j * LT + d], dot);
        s_s[rr * kLdS + j] = dot;
      }
    }
    __syncthreads();

    // ---- online softmax: two threads per row, 32 keys each.  Every lane
    // starts its walk at its own lane offset, so the 32 lanes of a warp hit
    // 32 different shared-memory banks.
    {
      const int row = q0 + r;
      const int hz = hz_s[r];
      float* sr = s_s + r * kLdS + half * (kBK / 2);
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
      T* pr = p_s + r * kLdP + half * (kBK / 2);
      float sum = 0.f;
      for (int t = 0; t < kBK / 2; ++t) {
        const int jj = (t + lane) % (kBK / 2);
        const float p = expf(sr[jj] - m_new);
        const T hi = from_f32<T>(p);
        pr[jj] = hi;
        if constexpr (kTC) pr[kBQ * kLdP + jj] = from_f32<T>(p - __bfloat162float(hi));
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

    // ---- O += P V
    if constexpr (kTC) {
      for (int dn = 0; dn < D / 16; ++dn) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::load_matrix_sync(c, o_s + warp * 16 * LO + dn * 16, LO, wmma::mem_row_major);
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, v_s + kk * 16 * LT + dn * 16, LT);
          wmma::load_matrix_sync(a, p_s + warp * 16 * kLdP + kk * 16, kLdP);
          wmma::mma_sync(c, a, b, c);
          wmma::load_matrix_sync(a, plo_s + warp * 16 * kLdP + kk * 16, kLdP);
          wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(o_s + warp * 16 * LO + dn * 16, c, LO, wmma::mem_row_major);
      }
    } else {
      for (int i = tid; i < kBQ * D; i += kThreads) {
        const int rr = i / D, d = i - rr * D;
        float a = o_s[rr * LO + d];
        for (int j = 0; j < kBK; ++j)
          a = fmaf(p_s[rr * kLdP + j], v_s[j * LT + d], a);
        o_s[rr * LO + d] = a;
      }
    }
  }
  __syncthreads();

  T* ob = out + static_cast<size_t>(bh) * S * D;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i - rr * D;
    if (q0 + rr < S)
      ob[static_cast<size_t>(q0) * D + i] = from_f32<T>(o_s[rr * LO + d] / fmaxf(l_s[rr], 1e-30f));
  }
  for (int rr = tid; rr < kBQ; rr += kThreads) {
    if (q0 + rr < S)
      lse[static_cast<size_t>(bh) * S + q0 + rr] = m_s[rr] + logf(fmaxf(l_s[rr], 1e-30f));
  }
}

template <typename T, int D, bool kTC>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           void* lse, int BH, int S, int Tk, int heads, float scale, int causal,
           int block_q, int block_k, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D, kTC>;
  const size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((S + kBQ - 1) / kBQ, BH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(out), static_cast<float*>(lse),
      S, Tk, heads, scale, causal, block_q, block_k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTC>
int launch_d(int D, const void* q, const void* k, const void* v, const void* mask,
             void* out, void* lse, int BH, int S, int Tk, int heads, float scale,
             int causal, int block_q, int block_k, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16, kTC>(q, k, v, mask, out, lse, BH, S, Tk, heads, scale, causal, block_q, block_k, s);
    case 32: return launch<T, 32, kTC>(q, k, v, mask, out, lse, BH, S, Tk, heads, scale, causal, block_q, block_k, s);
    case 64: return launch<T, 64, kTC>(q, k, v, mask, out, lse, BH, S, Tk, heads, scale, causal, block_q, block_k, s);
    case 128: return launch<T, 128, kTC>(q, k, v, mask, out, lse, BH, S, Tk, heads, scale, causal, block_q, block_k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (dtype == 0)
    return launch_d<float, false>(D, q, k, v, mask, out, lse, BH, S, Tk, heads, scale,
                                  causal, block_q, block_k, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16, true>(D, q, k, v, mask, out, lse, BH, S, Tk, heads,
                                         scale, causal, block_q, block_k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
