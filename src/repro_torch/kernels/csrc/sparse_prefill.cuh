// Work-list block-sparse causal prefill attention for Hopper (sm_90a): the
// one kernel body behind two entry points, which differ only in where a
// (kv head, logical block) K/V tile lives.
//
//   sparse_prefill_paged.cu   tiles from the block pool [N, Hkv, block_kv, D]
//                             through the sequence's table [T] (the paged
//                             serving path, the reference's jnp twin
//                             attention/worklist_jnp.py::worklist_attention_paged)
//   sparse_prefill_contig.cu  tiles of contiguous K/V [Hkv, Skv, D], read in
//                             place (the contiguous serving path's
//                             worklist_attention, and the TPU kernel's own
//                             contiguous signature)
//
// Both replace the TPU kernel src/repro/kernels/sparse_prefill.py::
// sparse_prefill_attention (body _sparse_prefill_kernel, pallas_call at
// sparse_prefill.py:165).  The dense flash attention (flash_attention.cu)
// shares this file's per-row tile update.
//
// What it computes.  Items [L, 7] (q head, chunk-local q block, LOGICAL kv
// block, first, last, valid, kv head) name (head, q_blk, kv_blk) flash
// tiles; the items of one (head, q_blk) run are contiguous.  Queries sit at
// global positions q_offset + i; the mask is kpos <= qpos, kpos < klim (the
// caller's min(kv_len, cache length)) and i < Sq.  A run initializes on its
// `first` item and writes its normalized tile on its valid `last` item; rows
// of (head, q_blk) pairs no run covers stay at the wrapper's zeros.
//
// Design.  The TPU's sequential-grid carry of (acc, m, l) becomes one CTA per
// item index: non-`first` CTAs exit, a `first` CTA loops over its run.  One
// thread owns one query row and keeps its q row, accumulator and softmax
// state in registers; each item's K and V tiles are staged in shared memory,
// read back as broadcasts.  Each tile takes two passes over the keys (row
// max, then probabilities and p.V), in f32 FMA loops: tensor-core MMA
// (mma.sync / wgmma) and TMA staging are later work.  Both layouts run this
// one body, so they give the same bits on equal K/V.
//
// What bounds it.  The least time is the larger of the bytes of the selected
// K/V blocks (plus q and out) over 3.35 TB/s and the FLOPs of the unmasked
// (query, key) pairs (4 * D each) over the bf16 tensor-core rate; this FMA
// version is far from either and is bound by its own instruction rate.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace prefill {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int F_HEAD = 0, F_QBLK = 1, F_KVBLK = 2, F_FIRST = 3, F_LAST = 4,
              F_VALID = 5, F_KVHEAD = 6, ITEM_FIELDS = 7;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// Stage `rows` rows of a K and a V tile (row-major [rows, D] at `k`/`v`)
// into shared memory [bkv, D]; rows past `rows` are zero, as in the
// reference's zero-padded cache.  Ends with a barrier.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(T* k_s, T* v_s, const T* k,
                                           const T* v, int rows, int bkv) {
  __syncthreads();  // the previous tile is no longer read
  const int have = rows * D;
  for (int e = threadIdx.x; e < have; e += blockDim.x) {
    k_s[e] = k[e];
    v_s[e] = v[e];
  }
  if (rows < bkv) {
    T zero;
    from_f32(0.f, &zero);
    for (int e = have + threadIdx.x; e < bkv * D; e += blockDim.x) {
      k_s[e] = zero;
      v_s[e] = zero;
    }
  }
  __syncthreads();
}

// One query row's online-softmax update over one staged tile: keys kk in
// [0, bkv) at positions kbase + kk take part where keep(kpos) holds.
template <typename T, int D, class Keep>
__device__ __forceinline__ void row_tile_update(const float (&qr)[D],
                                                float (&acc)[D], float& m,
                                                float& l, const T* k_s,
                                                const T* v_s, int bkv,
                                                int kbase, float scale,
                                                Keep keep) {
  // pass 1: row max over the tile (masked scores count as NEG_INF)
  float mx = kNegInf;
  for (int kk = 0; kk < bkv; ++kk) {
    if (keep(kbase + kk)) {
      const T* krow = k_s + (size_t)kk * D;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], to_f32(krow[d]), s);
      mx = fmaxf(mx, s * scale);
    }
  }
  const float m_new = fmaxf(m, mx);
  const float alpha = expf(m - m_new);
  // pass 2: probabilities and p.V
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= alpha;
  float lsum = 0.f;
  for (int kk = 0; kk < bkv; ++kk) {
    if (keep(kbase + kk)) {
      const T* krow = k_s + (size_t)kk * D;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], to_f32(krow[d]), s);
      const float p = expf(s * scale - m_new);
      lsum += p;
      const T* vrow = v_s + (size_t)kk * D;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, to_f32(vrow[d]), acc[d]);
    }
  }
  l = l * alpha + lsum;
  m = m_new;
}

// Tiles of the block pool [N, Hkv, bkv, D] through the table [Tw].
struct PoolTiles {
  const int* table;
  int Tw, Hkv, bkv;
  // First row of the tile (in units of D elements), or -1 when unmapped;
  // `rows` is how many of its bkv rows exist.  The reference clamps the
  // logical index into the table; positions past it are masked by klim.
  __device__ long long row0(int kvh, int kvblk, int& rows) const {
    rows = bkv;
    const int phys = table[min(max(kvblk, 0), Tw - 1)];
    return phys < 0 ? -1 : ((long long)phys * Hkv + kvh) * bkv;
  }
};

// Tiles of contiguous K/V [Hkv, Skv, D], in place.  As the reference's
// dynamic_slice of the zero-padded K/V, the tile start is clamped into
// [0, Skv_pad - bkv]; rows past Skv are zero.
struct RowTiles {
  int Skv, bkv;
  __device__ long long row0(int kvh, int kvblk, int& rows) const {
    const int nb = (Skv + bkv - 1) / bkv;
    const int start = min(max(kvblk, 0), nb - 1) * bkv;
    rows = min(bkv, Skv - start);
    return (long long)kvh * Skv + start;
  }
};

template <typename T, int D, class Tiles>
__global__ void sparse_prefill_kernel(
    const T* __restrict__ q,  // [H, Sq, D]
    const T* __restrict__ k,  // pool or [Hkv, Skv, D]
    const T* __restrict__ v,
    const int* __restrict__ items,  // [L, 7]
    T* __restrict__ out,            // [H, Sq, D], zero-filled by the caller
    int L, int Sq, int bq, int bkv, Tiles tiles, int q_offset, int klim,
    float scale) {
  const int i = blockIdx.x;
  const int* it = items + (size_t)i * ITEM_FIELDS;
  if (it[F_FIRST] != 1) return;
  // runs are homogeneous in (head, q_blk): build_worklist emits them so
  const int head = it[F_HEAD], qblk = it[F_QBLK];
  const int r = threadIdx.x;
  const int qpos = qblk * bq + r;         // chunk-local row
  const bool row_ok = qpos < Sq;
  const int qg = qpos + q_offset;          // global query position

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [bkv][D]
  T* v_s = k_s + (size_t)bkv * D;           // [bkv][D]

  float qr[D], acc[D];
  const T* qrow = q + ((size_t)head * Sq + (row_ok ? qpos : 0)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? to_f32(qrow[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;
  auto keep = [&](int kpos) { return row_ok && kpos <= qg && kpos < klim; };

  for (int j = i; j < L; ++j) {
    const int* jt = items + (size_t)j * ITEM_FIELDS;
    // a new run before this one finalized: the reference scan resets and
    // never writes this run
    if (j > i && jt[F_FIRST] == 1) return;
    const bool valid = jt[F_VALID] == 1;
    const int kvblk = jt[F_KVBLK];
    int rows = 0;
    const long long row0 = valid ? tiles.row0(jt[F_KVHEAD], kvblk, rows) : -1;
    if (row0 >= 0) {
      stage_tile<T, D>(k_s, v_s, k + row0 * D, v + row0 * D, rows, bkv);
      row_tile_update<T, D>(qr, acc, m, l, k_s, v_s, bkv, kvblk * bkv,
                            scale, keep);
    }
    if (valid && jt[F_LAST] == 1) {
      if (row_ok) {
        T* orow = out + ((size_t)head * Sq + qpos) * D;
#pragma unroll
        for (int d = 0; d < D; ++d)
          from_f32(l > 0.f ? acc[d] / fmaxf(l, 1e-30f) : 0.f, orow + d);
      }
      return;
    }
  }
}

template <typename T, int D, class Tiles>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* items, void* out, int L, int Sq, int bq,
                   int bkv, Tiles tiles, int q_offset, int klim, float scale,
                   cudaStream_t stream) {
  const size_t smem = 2 * (size_t)bkv * D * sizeof(T);
  auto kern = sparse_prefill_kernel<T, D, Tiles>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<L, bq, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), items, static_cast<T*>(out), L, Sq, bq, bkv,
      tiles, q_offset, klim, scale);
  return cudaGetLastError();
}

// dtype: 0 = bfloat16, 1 = float32 (q, K/V and out share it); head_dim 32
// or 64; block_q is the CTA width (one thread per query row, <= 1024).
// Returns the launch's cudaError_t.
template <class Tiles>
cudaError_t dispatch(int dtype, int D, const void* q, const void* k,
                     const void* v, const int* items, void* out, int L,
                     int Sq, int bq, int bkv, Tiles tiles, int q_offset,
                     int klim, float scale, cudaStream_t stream) {
  if (L <= 0 || bq < 1 || bq > 1024 || bkv < 1) return cudaErrorInvalidValue;
#define PREFILL_LAUNCH(T, DD)                                              \
  return launch<T, DD, Tiles>(q, k, v, items, out, L, Sq, bq, bkv, tiles,  \
                              q_offset, klim, scale, stream)
  if (dtype == 0 && D == 32) PREFILL_LAUNCH(__nv_bfloat16, 32);
  if (dtype == 0 && D == 64) PREFILL_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 32) PREFILL_LAUNCH(float, 32);
  if (dtype == 1 && D == 64) PREFILL_LAUNCH(float, 64);
#undef PREFILL_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace prefill
