// Budgeted flash-decode over a work-item table, for Hopper (sm_90a): the one
// kernel body behind three entry points, which differ only in where a
// (row, kv head, logical block) K/V tile lives and in the run rules.
//
//   flash_decode_paged.cu   TPU kernel flash_decode.py::flash_decode_paged_kernel
//                           (pallas_call :587): tiles from the block pool
//                           [N, Hkv, block, D] through a table [B, T].
//   flash_decode_contig.cu  TPU kernel flash_decode.py::flash_decode_kernel
//                           (pallas_call :294): tiles of the slot cache
//                           [B, Hkv, Smax, D], read in place.
//   sparse_decode.cu        TPU kernel sparse_decode.py::sparse_decode_attention
//                           (pallas_call :241): the legacy budgeted decode
//                           over the slot cache.
//
// What it computes.  For each run of items [L, 6] (batch row, kv head,
// LOGICAL kv block, first, last, valid), the online-softmax attention of the
// run's G query rows (the GQA group of one kv head) over the run's selected
// tiles.  Key positions come from the logical block id; the mask is
// kpos <= last_pos (and kpos > last_pos - window with a window), where
// last_pos is pos[row] (flash decode) or cache_len - 1 (legacy decode).
// Flash decode starts a run on `first` and finalizes on `last`, valid or not
// (the padded table from per-slot block ids ends short runs on an invalid
// row), and returns f32 out plus the m / l partials; the legacy decode
// starts on `valid & first`, finalizes on `valid & last` and returns out
// only, in q's dtype.  Runs that never finalize leave the caller's initial
// values (out 0, m -1e30, l 0).
//
// Design.  The TPU grid runs in order and carries (acc, m, l) in VMEM from
// one item to the next; CUDA blocks run concurrently, so that carry is not
// legal here.  One CTA is launched per item index: a CTA whose item does
// not start a run exits at once, and a starting CTA walks its run in a loop,
// keeping (acc, m, l) on chip.  q.k takes the cache's element type and
// accumulates in f32; p.V stays true f32.  Both layouts run this one body,
// so paged and contiguous caches holding the same values give the same bits.
//
// What bounds it.  Decode attention is memory-bound: the least time is the
// bytes of the selected K/V tiles over the card's 3.35 TB/s.  This first
// version reads K and V straight from device memory (row-per-thread for q.k,
// column-per-thread for p.V); cp.async / TMA staging and splitting long runs
// across CTAs are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace decode {

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
__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// Where a tile lives: find() sets `row0`, the tile's first cache row (in
// units of D elements), and returns whether the logical block is mapped.
// Offsets stay unsigned (size_t): signed 64-bit offsets cost extra
// sign-extension instructions in the p.V loop that reads from them.

// Tiles of the block pool [N, Hkv, blk, D] through the table [B, Tw].
struct PoolTiles {
  const int* table;
  int Tw, Hkv, blk;
  __device__ bool find(int b, int h, int kvblk, size_t& row0) const {
    int phys = -1;
    if (kvblk >= 0 && kvblk < Tw) phys = table[(size_t)b * Tw + kvblk];
    row0 = ((size_t)phys * Hkv + h) * blk;
    return phys >= 0;
  }
};

// Tiles of the slot cache [B, Hkv, Smax, D] (Smax a multiple of blk),
// addressed in place; a block outside the cache is unmapped.
struct SlotTiles {
  int Hkv, nblk, blk;
  __device__ bool find(int b, int h, int kvblk, size_t& row0) const {
    row0 = (((size_t)b * Hkv + h) * nblk + kvblk) * blk;
    return kvblk >= 0 && kvblk < nblk;
  }
};

// Block-wide max or sum of kMaxG per-thread values; every thread gets the
// result.  Must be reached by all threads of the block.  Inlined, so the
// caller's arrays stay in registers instead of a local-memory stack frame.
template <bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[kMaxG],
                                             float (*red)[kMaxG]) {
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

// kLegacy selects the legacy decode's run rules (see the file comment);
// the legacy decode gets every row's last position cache_len - 1 in pos.
template <typename T, typename OutT, int D, class Tiles, bool kLegacy>
__global__ void __launch_bounds__(kThreads)
    decode_runs_kernel(const T* __restrict__ q,  // [B, Hkv, G, D]
                       const T* __restrict__ k,  // pool or slot cache
                       const T* __restrict__ v,
                       const int* __restrict__ items,  // [L, 6]
                       const int* __restrict__ pos,    // [B]
                       OutT* __restrict__ out,     // [B, Hkv, G, D]
                       float* __restrict__ m_out,  // [B, Hkv, G]
                       float* __restrict__ l_out, int L, int Hkv, int G,
                       int blk, Tiles tiles, float scale, int window) {
  constexpr int kAcc = (kMaxG * D + kThreads - 1) / kThreads;
  auto starts = [](const int* t) {
    return t[D_FIRST] == 1 && (!kLegacy || t[D_VALID] == 1);
  };
  auto ends = [](const int* t) {
    return t[D_LAST] == 1 && (!kLegacy || t[D_VALID] == 1);
  };
  const int i = blockIdx.x;
  const int* it = items + (size_t)i * DEC_FIELDS;
  if (!starts(it)) return;
  // runs are homogeneous in (row, kv head): the packers emit them so
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
    if (j > i && starts(jt)) return;
    const int kvblk = jt[D_KVBLK];
    size_t row0;
    const bool mapped = tiles.find(b, h, kvblk, row0);
    const bool ok = (jt[D_VALID] == 1) && mapped;
    if (ok) {
      const T* kt = k + row0 * D;
      const T* vt = v + row0 * D;
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
    if (ends(jt)) {
      OutT* ob = out + ((size_t)b * Hkv + h) * G * D;
#pragma unroll
      for (int r = 0; r < kAcc; ++r) {
        const int o = tid + r * kThreads;
        if (o < G * D) {
          const float l = l_s[o / D];
          store(l > 0.f ? acc[r] / fmaxf(l, 1e-30f) : 0.f, ob + o);
        }
      }
      if (!kLegacy && tid < G) {
        m_out[((size_t)b * Hkv + h) * G + tid] = m_s[tid];
        l_out[((size_t)b * Hkv + h) * G + tid] = l_s[tid];
      }
      return;
    }
  }
}

template <typename T, int D, class Tiles, bool kLegacy>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* items, const int* pos, void* out,
                   float* m_out, float* l_out, int L, int Hkv, int G, int blk,
                   Tiles tiles, float scale, int window, cudaStream_t stream) {
  using OutT = std::conditional_t<kLegacy, T, float>;
  const size_t smem = (size_t)(G * D + G * blk) * sizeof(float);
  auto kern = decode_runs_kernel<T, OutT, D, Tiles, kLegacy>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<L, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), items, pos, static_cast<OutT*>(out), m_out,
      l_out, L, Hkv, G, blk, tiles, scale,
      window);
  return cudaGetLastError();
}

// dtype: 0 = bfloat16, 1 = float32 (q and the cache share it); head_dim
// 32 or 64.  Returns the launch's cudaError_t.
template <class Tiles, bool kLegacy>
cudaError_t dispatch(int dtype, int D, const void* q, const void* k,
                     const void* v, const int* items, const int* pos,
                     void* out, float* m_out, float* l_out,
                     int L, int Hkv, int G, int blk, Tiles tiles, float scale,
                     int window, cudaStream_t stream) {
  if (L <= 0 || G < 1 || G > kMaxG || blk < 1) return cudaErrorInvalidValue;
#define DECODE_LAUNCH(T, DD)                                                 \
  return launch<T, DD, Tiles, kLegacy>(q, k, v, items, pos, out, m_out,     \
                                       l_out, L, Hkv, G, blk, tiles, scale,  \
                                       window, stream)
  if (dtype == 0 && D == 32) DECODE_LAUNCH(__nv_bfloat16, 32);
  if (dtype == 0 && D == 64) DECODE_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 32) DECODE_LAUNCH(float, 32);
  if (dtype == 1 && D == 64) DECODE_LAUNCH(float, 64);
#undef DECODE_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace decode
