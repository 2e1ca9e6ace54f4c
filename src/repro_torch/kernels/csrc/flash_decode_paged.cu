// Paged, cost-packed budgeted flash-decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_paged_kernel (body _flash_decode_paged_kernel, pallas_call at
// flash_decode.py:587), reached on the serving main path through
// ops.flash_decode_packed_paged.
//
// What it computes.  For each run of a packed decode item table (items
// [L, 6]: batch row, kv head, LOGICAL kv block, first, last, valid), the
// online-softmax attention of the run's G query rows (GQA group of one kv
// head) over the run's selected kv blocks, read from the block pool
// [N, Hkv, block, D] through the per-row block table [B, T] (-1 = unmapped,
// masked).  Key positions come from the logical block id; the mask is
// kpos <= pos[row] (and kpos > pos - window with a window).  Finalization
// happens on the run's `last` item, valid or not.  Returns f32 out
// [B, Hkv, G, D] plus the m / l softmax partials [B, Hkv, G]; (row, head)
// pairs no run covers keep the wrapper's initial values (0, -1e30, 0).
//
// Design.  The TPU grid runs in order and carries (acc, m, l) in VMEM from
// one item to the next; CUDA blocks run concurrently, so that carry is not
// legal here.  Instead one CTA is launched per item index: a CTA whose item
// is not `first` exits at once, and a `first` CTA walks its whole run in a
// loop, keeping (acc, m, l) on chip.  q.k takes the pool's element type and
// accumulates in f32; p.V stays true f32 (no TF32, no rounding of p), so a
// later striped (out, m, l) merge stays bit-compatible with a single pass.
//
// What bounds it.  Decode attention is memory-bound: the least time is the
// bytes of the selected K/V blocks (2 * block * D * 2 bytes each in bf16)
// over the card's 3.35 TB/s.  This first version reads K and V straight from
// device memory (row-per-thread for q.k, column-per-thread for p.V) and
// leaves cp.async / TMA staging and splitting long runs across CTAs to later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 4;  // GQA group bound: SmolLM-135M has G = 3
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

constexpr int D_BATCH = 0, D_KVHEAD = 1, D_KVBLK = 2, D_FIRST = 3,
              D_LAST = 4, D_VALID = 5, DEC_FIELDS = 6;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Block-wide max or sum of kMaxG per-thread values; every thread gets the
// result.  Must be reached by all threads of the block.
template <bool kMax>
__device__ void block_reduce(float (&v)[kMaxG], float (*red)[kMaxG]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[g], off);
      v[g] = kMax ? fmaxf(v[g], o) : v[g] + o;
    }
    if (lane == 0) red[warp][g] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    float r = red[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      r = kMax ? fmaxf(r, red[w][g]) : r + red[w][g];
    v[g] = r;
  }
  __syncthreads();
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_paged_kernel(const T* __restrict__ q,       // [B,Hkv,G,D]
                              const T* __restrict__ k_pool,  // [N,Hkv,blk,D]
                              const T* __restrict__ v_pool,
                              const int* __restrict__ items,  // [L, 6]
                              const int* __restrict__ table,  // [B, T]
                              const int* __restrict__ pos,    // [B]
                              float* __restrict__ out,        // [B,Hkv,G,D]
                              float* __restrict__ m_out,      // [B,Hkv,G]
                              float* __restrict__ l_out, int L, int Hkv,
                              int G, int blk, int Tw, float scale,
                              int window) {
  constexpr int kAcc = (kMaxG * D + kThreads - 1) / kThreads;
  const int i = blockIdx.x;
  const int* it = items + (size_t)i * DEC_FIELDS;
  if (it[D_FIRST] != 1) return;
  // runs are homogeneous in (row, kv head): the packer emits them so
  const int b = it[D_BATCH], h = it[D_KVHEAD];
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;           // [G][D] query rows in f32
  float* p_s = smem + G * D;   // [G][blk] scores, then probabilities
  __shared__ float red[kWarps][kMaxG];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG], mnew_s[kMaxG];

  const T* qb = q + ((size_t)b * Hkv + h) * G * D;
  for (int idx = tid; idx < G * D; idx += kThreads) q_s[idx] = to_f32(qb[idx]);
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;
  const int p = pos[b];
  __syncthreads();

  for (int j = i; j < L; ++j) {
    const int* jt = items + (size_t)j * DEC_FIELDS;
    // a new run before this one finalized: the reference scan would reset
    // and never write this run, so stop here without writing
    if (j > i && jt[D_FIRST] == 1) return;
    const int kvblk = jt[D_KVBLK];
    int phys = -1;
    if (kvblk >= 0 && kvblk < Tw) phys = table[(size_t)b * Tw + kvblk];
    const bool ok = (jt[D_VALID] == 1) && phys >= 0;
    if (ok) {
      const size_t tile = ((size_t)phys * Hkv + h) * blk * D;
      const T* kt = k_pool + tile;
      const T* vt = v_pool + tile;
      float mx[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) mx[g] = kNegInf;
      // scores: one key row per thread
      for (int kk = tid; kk < blk; kk += kThreads) {
        const int kpos = kvblk * blk + kk;
        bool msk = kpos <= p;
        if (window > 0) msk = msk && (kpos > p - window);
        float s[kMaxG];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
        if (msk) {
          const T* krow = kt + (size_t)kk * D;
#pragma unroll 8
          for (int d = 0; d < D; ++d) {
            const float kf = to_f32(krow[d]);
#pragma unroll
            for (int g = 0; g < kMaxG; ++g)
              if (g < G) s[g] = fmaf(q_s[g * D + d], kf, s[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float sv = msk ? s[g] * scale : -CUDART_INF_F;
            p_s[g * blk + kk] = sv;
            mx[g] = fmaxf(mx[g], sv);
          }
        }
      }
      block_reduce<true>(mx, red);
      if (tid < G) {
        const float mn = fmaxf(m_s[tid], mx[tid]);
        mnew_s[tid] = mn;
        alpha_s[tid] = expf(m_s[tid] - mn);
      }
      __syncthreads();
      float ls[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) ls[g] = 0.f;
      for (int kk = tid; kk < blk; kk += kThreads) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float sv = p_s[g * blk + kk];
            const float pr = (sv == -CUDART_INF_F) ? 0.f : expf(sv - mnew_s[g]);
            p_s[g * blk + kk] = pr;
            ls[g] += pr;
          }
        }
      }
      block_reduce<false>(ls, red);  // also orders the p_s writes
      // p.V in true f32: thread owns output columns (g, d)
#pragma unroll
      for (int r = 0; r < kAcc; ++r) {
        const int o = tid + r * kThreads;
        if (o < G * D) {
          const int g = o / D, d = o - (o / D) * D;
          const float* pg = p_s + g * blk;
          float pv = 0.f;
          for (int kk = 0; kk < blk; ++kk)
            pv = fmaf(pg[kk], to_f32(vt[(size_t)kk * D + d]), pv);
          acc[r] = acc[r] * alpha_s[g] + pv;
        }
      }
      if (tid < G) {
        l_s[tid] = l_s[tid] * alpha_s[tid] + ls[tid];
        m_s[tid] = mnew_s[tid];
      }
      __syncthreads();
    }
    if (jt[D_LAST] == 1) {
      float* ob = out + ((size_t)b * Hkv + h) * G * D;
#pragma unroll
      for (int r = 0; r < kAcc; ++r) {
        const int o = tid + r * kThreads;
        if (o < G * D) {
          const float l = l_s[o / D];
          ob[o] = l > 0.f ? acc[r] / fmaxf(l, 1e-30f) : 0.f;
        }
      }
      if (tid < G) {
        m_out[((size_t)b * Hkv + h) * G + tid] = m_s[tid];
        l_out[((size_t)b * Hkv + h) * G + tid] = l_s[tid];
      }
      return;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* items, const int* table, const int* pos,
                   float* out, float* m_out, float* l_out, int L, int Hkv,
                   int G, int blk, int Tw, float scale, int window,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(G * D + G * blk) * sizeof(float);
  auto kern = flash_decode_paged_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<L, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), items, table, pos, out, m_out, l_out, L,
      Hkv, G, blk, Tw, scale, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k_pool,
                       const void* v_pool, const int* items, const int* table,
                       const int* pos, float* out, float* m_out, float* l_out,
                       int L, int Hkv, int G, int blk, int Tw, float scale,
                       int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, items, table, pos, out, m_out,
                           l_out, L, Hkv, G, blk, Tw, scale, window, stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, items, table, pos, out, m_out,
                           l_out, L, Hkv, G, blk, Tw, scale, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (q and both pools share it).
// window <= 0 means no sliding window.  Returns the launch's cudaError_t.
extern "C" int flash_decode_paged(const void* q, const void* k_pool,
                                  const void* v_pool, const int* items,
                                  const int* table, const int* pos,
                                  float* out, float* m_out, float* l_out,
                                  int L, int Hkv, int G, int D, int block_kv,
                                  int table_width, float scale, int window,
                                  int dtype, void* stream) {
  if (L <= 0 || G < 1 || G > kMaxG || block_kv < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<__nv_bfloat16>(D, q, k_pool, v_pool, items, table, pos,
                                     out, m_out, l_out, L, Hkv, G, block_kv,
                                     table_width, scale, window, s);
  if (dtype == 1)
    return dispatch_d<float>(D, q, k_pool, v_pool, items, table, pos, out,
                             m_out, l_out, L, Hkv, G, block_kv, table_width,
                             scale, window, s);
  return cudaErrorInvalidValue;
}
