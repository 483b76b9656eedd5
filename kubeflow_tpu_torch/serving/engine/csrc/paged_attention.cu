// Paged decode attention for Hopper (sm_90a), C ABI for ctypes.
//
// Replaces the TPU kernel kubeflow_tpu/serving/engine/paged_attention.py
// (_kernel, launched by _call_kernel through pl.pallas_call): attention of
// K query tokens per slot straight over one layer's KV page pool, without
// first gathering each slot's pages into a contiguous cache.
//
// Semantics, identical to the TPU kernel:
//   * pool layout [P, Hkv, ps, hd]: one (page, kv head) tile is ps*hd
//     contiguous elements; pools are f32, bf16, or int8 with a bf16 scale
//     per (page, head, token) ([P, Hkv, ps, 1]), dequantized here;
//   * GQA: the block of kv head h owns the K*group query rows that share
//     it, row r = (draft r / group, query head h*group + r % group);
//   * row r sees positions < seq_len + r / group; pages at or past the
//     furthest horizon seq_len + K - 1 are skipped, the walk bounded by
//     max_pages;
//   * online softmax in f32 from m = NEG_INF (-1e9, finite), l = 0,
//     acc = 0, output acc / max(l, 1e-30) in q's type.  So an idle K=1 slot
//     (seq_len 0) visits no page and returns zeros, and a K>1 row that sees
//     no position of the pages it visits averages V over those positions.
//
// Design.  The TPU grid walks pages as its sequential last axis and carries
// the accumulator in VMEM scratch between grid steps.  Blocks on a GPU run
// in no order, so here one block per (slot, kv head) walks the slot's pages
// itself: it reads the page id from the page table, stages the page's K and
// V tiles in shared memory (dequantized to f32), scores the K*group rows
// against them, and folds them into an f32 accumulator kept in shared
// memory.  Threads stride over (row, token) pairs for the scores and over
// (row, dim) pairs for the accumulator; the K tile's rows are padded by one
// float so the score loop reads shared memory without bank conflicts.
//
// What bounds it: HBM bytes.  Each visited page's K and V tiles are read
// once (8 KB each in bf16 at ps=32, hd=128) for a few FLOPs per byte, far
// below the card's ~295 FLOP/byte ridge.  This first version is simple and
// serial within a block (B*Hkv blocks, one page in flight per block), so it
// does not reach the bandwidth bound; splitting the page walk across blocks
// with a log-sum-exp merge, cp.async/TMA prefetch of the next page and
// tensor-core scores are the known next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q,                  // [B, K, Hq, hd]
    const KT* __restrict__ k_pool,             // [P, Hkv, ps, hd]
    const KT* __restrict__ v_pool,             // [P, Hkv, ps, hd]
    const __nv_bfloat16* __restrict__ k_scale, // [P, Hkv, ps] or null
    const __nv_bfloat16* __restrict__ v_scale, // [P, Hkv, ps] or null
    const int32_t* __restrict__ page_table,    // [B, max_pages]
    const int32_t* __restrict__ seq_lens,      // [B]
    QT* __restrict__ out,                      // [B, K, Hq, hd]
    int K, int Hq, int Hkv, int hd, int ps, int max_pages, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int group = Hq / Hkv;
  const int rows = K * group;
  const int kstride = hd + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                    // [rows, hd], pre-scaled
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
  const int seq_len = seq_lens[b];
  const int horizon = seq_len + K - 1;  // furthest row sees positions < this
  __syncthreads();

  for (int j = 0; j < max_pages && j * ps < horizon; ++j) {
    const size_t page = static_cast<size_t>(page_table[static_cast<size_t>(b) * max_pages + j]);
    const size_t tok0 = (page * Hkv + h) * ps;  // first (page, head, token) row
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
    const int hq = h * group + r % group;
    store(out + ((static_cast<size_t>(b) * K + r / group) * Hq + hq) * hd + d,
          acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* seq_lens, void* out, int B, int K, int Hq, int Hkv,
           int hd, int ps, int max_pages, float scale, size_t smem,
           cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QT, KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(seq_lens), static_cast<QT*>(out),
      K, Hq, Hkv, hd, ps, max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_kv(int kv_dtype, const void* q, const void* k_pool, const void* v_pool,
              const void* k_scale, const void* v_scale, const void* page_table,
              const void* seq_lens, void* out, int B, int K, int Hq, int Hkv,
              int hd, int ps, int max_pages, float scale, size_t smem,
              cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float>(q, k_pool, v_pool, nullptr, nullptr, page_table,
                               seq_lens, out, B, K, Hq, Hkv, hd, ps, max_pages,
                               scale, smem, stream);
    case 1:
      return launch<QT, __nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr,
                                       page_table, seq_lens, out, B, K, Hq, Hkv,
                                       hd, ps, max_pages, scale, smem, stream);
    case 2:
      return launch<QT, int8_t>(q, k_pool, v_pool, k_scale, v_scale, page_table,
                                seq_lens, out, B, K, Hq, Hkv, hd, ps, max_pages,
                                scale, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for one (slot, kv head) block.
size_t paged_attention_smem_bytes(int rows, int hd, int ps) {
  const size_t floats = 2 * static_cast<size_t>(rows) * hd  // q, acc
                        + static_cast<size_t>(ps) * (hd + 1)  // K tile (padded)
                        + static_cast<size_t>(ps) * hd        // V tile
                        + static_cast<size_t>(rows) * ps      // scores
                        + 3 * static_cast<size_t>(rows);      // m, l, corr
  return floats * sizeof(float);
}

// q_dtype: 0 = f32, 1 = bf16 (out has q's type).  kv_dtype: 0 = f32,
// 1 = bf16, 2 = int8 with bf16 scales.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
int paged_attention_launch(const void* q, int q_dtype, const void* k_pool,
                           const void* v_pool, int kv_dtype, const void* k_scale,
                           const void* v_scale, const void* page_table,
                           const void* seq_lens, void* out, int B, int K, int Hq,
                           int Hkv, int hd, int ps, int max_pages, float scale,
                           void* stream) {
  const size_t smem = paged_attention_smem_bytes(K * (Hq / Hkv), hd, ps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_kv<float>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale,
                            page_table, seq_lens, out, B, K, Hq, Hkv, hd, ps,
                            max_pages, scale, smem, s);
  if (q_dtype == 1)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale,
                                    page_table, seq_lens, out, B, K, Hq, Hkv, hd,
                                    ps, max_pages, scale, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
