// Dense flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (body _flash_kernel, pallas_call at flash_attn.py:117), the paper's dense
// baseline, reached through the library entry ops.flash_attention.
//
// What it computes.  q [H, Sq, D] attends k/v [Hkv, Skv, D], query head h
// reading kv head h / n_rep (GQA, no repeated copy).  Queries sit at
// positions 0..Sq-1 and keys at 0..Skv-1; keys at kpos >= Skv are masked,
// and with `causal` so are keys at kpos > qpos.  Output [H, Sq, D] in q's
// dtype, finalized as acc / max(l, 1e-30) (no zeroing, as the reference).
//
// Design.  The TPU grid (H, nQ, nKV) carries (acc, m, l) across its
// innermost kv axis; here one CTA per (q block, head) loops over the kv
// tiles, skipping those strictly above the diagonal when causal.  One thread
// owns one query row, as in the sparse prefill, whose tile staging and
// per-row online-softmax update (sparse_prefill.cuh) it shares.
//
// What bounds it.  The larger of the bytes (q, K, V read once, out written
// once) over 3.35 TB/s and the FLOPs of the unmasked (query, key) pairs
// (4 * D each) over the bf16 tensor-core rate: at 4096 tokens it is the
// operations.  This f32 FMA version is bound by its own instruction rate;
// tensor-core MMA is later work.
#include "sparse_prefill.cuh"

namespace {

template <typename T, int D>
__global__ void flash_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, int Sq, int Skv,
                                       int n_rep, int bq, int bkv,
                                       bool causal, float scale) {
  const int qblk = blockIdx.x, head = blockIdx.y, kvh = head / n_rep;
  const int qpos = qblk * bq + threadIdx.x;
  const bool row_ok = qpos < Sq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [bkv][D]
  T* v_s = k_s + (size_t)bkv * D;           // [bkv][D]

  float qr[D], acc[D];
  const T* qrow = q + ((size_t)head * Sq + (row_ok ? qpos : 0)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? prefill::to_f32(qrow[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;
  auto keep = [&](int kpos) {
    return row_ok && kpos < Skv && (!causal || kpos <= qpos);
  };
  const int nkv = (Skv + bkv - 1) / bkv;
  // causal: tiles with k_start > q_start + bq - 1 are skipped
  const int last = causal ? min(nkv - 1, (qblk * bq + bq - 1) / bkv)
                          : nkv - 1;
  for (int kb = 0; kb <= last; ++kb) {
    const size_t row0 = (size_t)kvh * Skv + (size_t)kb * bkv;
    prefill::stage_tile<T, D>(k_s, v_s, k + row0 * D, v + row0 * D,
                              min(bkv, Skv - kb * bkv), bkv);
    prefill::row_tile_update<T, D>(qr, acc, m, l, k_s, v_s, bkv, kb * bkv,
                                   scale, keep);
  }
  if (row_ok) {
    T* orow = out + ((size_t)head * Sq + qpos) * D;
#pragma unroll
    for (int d = 0; d < D; ++d)
      prefill::from_f32(acc[d] / fmaxf(l, 1e-30f), orow + d);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int H, int Sq, int Skv, int n_rep, int bq, int bkv,
                   bool causal, float scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)bkv * D * sizeof(T);
  auto kern = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + bq - 1) / bq, H);
  kern<<<grid, bq, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, n_rep, bq,
      bkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (q, k, v and out share it); head_dim 32
// or 64; block_q is the CTA width (one thread per query row, <= 1024).
// Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int H, int Hkv, int Sq, int Skv,
                               int D, int block_q, int block_kv, int causal,
                               float scale, int dtype, void* stream) {
  if (H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Skv < 1 || block_q < 1 ||
      block_q > 1024 || block_kv < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rep = H / Hkv;
  const bool c = causal != 0;
#define FLASH_LAUNCH(T, DD)                                                  \
  return launch<T, DD>(q, k, v, out, H, Sq, Skv, n_rep, block_q, block_kv,   \
                       c, scale, s)
  if (dtype == 0 && D == 32) FLASH_LAUNCH(__nv_bfloat16, 32);
  if (dtype == 0 && D == 64) FLASH_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 32) FLASH_LAUNCH(float, 32);
  if (dtype == 1 && D == 64) FLASH_LAUNCH(float, 64);
#undef FLASH_LAUNCH
  return cudaErrorInvalidValue;
}
