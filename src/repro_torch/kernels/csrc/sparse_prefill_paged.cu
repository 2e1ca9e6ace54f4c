// Paged work-list block-sparse causal prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_prefill.py::
// sparse_prefill_attention (body _sparse_prefill_kernel, pallas_call at
// sparse_prefill.py:165) together with its paged twin on the serving main
// path, attention/worklist_jnp.py::worklist_attention_paged, which the
// reference runs as a jnp scan with the same item protocol.  The contiguous
// form is this kernel over an identity block table.
//
// What it computes.  Items [L, 7] (q head, chunk-local q block, LOGICAL kv
// block, first, last, valid, kv head) name (head, q_blk, kv_blk) flash
// tiles; the items of one (head, q_blk) run are contiguous.  K/V tiles come
// from the block pool [N, Hkv, block_kv, D] through the sequence's table
// [T] (-1 = unmapped, masked).  Queries sit at global positions
// q_offset + i; the mask is kpos <= qpos, kpos < min(kv_len, T*block_kv) and
// i < Sq.  A run initializes on its `first` item and writes its normalized
// tile on its valid `last` item; rows of (head, q_blk) pairs no run covers
// stay at the wrapper's zeros.
//
// Design.  As in the decode kernel, the TPU's sequential-grid carry of
// (acc, m, l) becomes one CTA per item index: non-`first` CTAs exit, a
// `first` CTA loops over its run.  One thread owns one query row and keeps
// its q row, accumulator and softmax state in registers; each item's K and
// V tiles are staged in shared memory, read back as broadcasts.  Each tile
// takes two passes over the keys (row max, then probabilities and p.V), in
// f32 FMA loops: tensor-core MMA (mma.sync / wgmma) and TMA staging are
// later work.
//
// What bounds it.  The least time is the larger of the bytes of the
// selected K/V blocks (plus q and out) over 3.35 TB/s and the FLOPs of the
// unmasked (query, key) pairs (4 * D each) over the bf16 tensor-core rate;
// this FMA version is far from either and is bound by its own instruction
// rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

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

template <typename T, int D>
__global__ void sparse_prefill_paged_kernel(
    const T* __restrict__ q,       // [H, Sq, D]
    const T* __restrict__ k_pool,  // [N, Hkv, bkv, D]
    const T* __restrict__ v_pool,
    const int* __restrict__ items,  // [L, 7]
    const int* __restrict__ table,  // [Tw]
    T* __restrict__ out,            // [H, Sq, D], zero-filled by the caller
    int L, int Sq, int Hkv, int bq, int bkv, int Tw, int q_offset, int kv_len,
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
  const int klim = min(kv_len, Tw * bkv);

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

  for (int j = i; j < L; ++j) {
    const int* jt = items + (size_t)j * ITEM_FIELDS;
    // a new run before this one finalized: the reference scan resets and
    // never writes this run
    if (j > i && jt[F_FIRST] == 1) return;
    const bool valid = jt[F_VALID] == 1;
    const int kvblk = jt[F_KVBLK];
    // the reference clamps the logical index into the table; positions past
    // the table are masked by klim anyway
    const int idx = min(max(kvblk, 0), Tw - 1);
    const int phys = table[idx];
    if (valid && phys >= 0) {
      const int kvh = jt[F_KVHEAD];
      const size_t tile = ((size_t)phys * Hkv + kvh) * bkv * D;
      __syncthreads();  // the previous item's tiles are no longer read
      for (int e = r; e < bkv * D; e += blockDim.x) {
        k_s[e] = k_pool[tile + e];
        v_s[e] = v_pool[tile + e];
      }
      __syncthreads();
      const int kbase = kvblk * bkv;
      // pass 1: row max over the tile (masked scores count as NEG_INF)
      float mx = kNegInf;
      for (int kk = 0; kk < bkv; ++kk) {
        const int kpos = kbase + kk;
        if (row_ok && kpos <= qg && kpos < klim) {
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
        const int kpos = kbase + kk;
        if (row_ok && kpos <= qg && kpos < klim) {
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* items, const int* table, void* out, int L,
                   int Sq, int Hkv, int bq, int bkv, int Tw, int q_offset,
                   int kv_len, float scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)bkv * D * sizeof(T);
  auto kern = sparse_prefill_paged_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<L, bq, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), items, table, static_cast<T*>(out), L,
      Sq, Hkv, bq, bkv, Tw, q_offset, kv_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k_pool,
                       const void* v_pool, const int* items, const int* table,
                       void* out, int L, int Sq, int Hkv, int bq, int bkv,
                       int Tw, int q_offset, int kv_len, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, items, table, out, L, Sq, Hkv,
                           bq, bkv, Tw, q_offset, kv_len, scale, stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, items, table, out, L, Sq, Hkv,
                           bq, bkv, Tw, q_offset, kv_len, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (q, both pools and out share it).
// block_q is the CTA width (one thread per query row, <= 1024).  Returns the
// launch's cudaError_t.
extern "C" int sparse_prefill_paged(const void* q, const void* k_pool,
                                    const void* v_pool, const int* items,
                                    const int* table, void* out, int L,
                                    int Sq, int Hkv, int D, int block_q,
                                    int block_kv, int table_width,
                                    int q_offset, int kv_len, float scale,
                                    int dtype, void* stream) {
  if (L <= 0 || block_q < 1 || block_q > 1024 || block_kv < 1 ||
      table_width < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<__nv_bfloat16>(D, q, k_pool, v_pool, items, table, out,
                                     L, Sq, Hkv, block_q, block_kv,
                                     table_width, q_offset, kv_len, scale, s);
  if (dtype == 1)
    return dispatch_d<float>(D, q, k_pool, v_pool, items, table, out, L, Sq,
                             Hkv, block_q, block_kv, table_width, q_offset,
                             kv_len, scale, s);
  return cudaErrorInvalidValue;
}
