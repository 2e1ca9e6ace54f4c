// Paged work-list block-sparse causal prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_prefill.py::
// sparse_prefill_attention (pallas_call at sparse_prefill.py:165) together
// with its paged twin on the serving main path,
// attention/worklist_jnp.py::worklist_attention_paged.  K/V tiles come from
// the block pool [N, Hkv, block_kv, D] through the sequence's table [T]
// (-1 = unmapped, masked), in bf16 / f32 or as int8 / fp8 codes with
// per-(block, kv head) scales (the twin's quantized branch).  The kernel
// body, its design and its bound are in sparse_prefill.cuh, shared with the
// contiguous form.
#include "sparse_prefill.cuh"

// dtype: q's and out's element type, 0 = bfloat16, 1 = float32.  kv_dtype:
// the pools', equal to dtype, or 2 = int8 / 3 = fp8 e4m3 codes with
// k_scales / v_scales [N, Hkv] f32 at the physical block (null otherwise).
// Keys at positions >= min(kv_len, table_width * block_kv) are masked, and
// with window > 0 (the window form; -1: none) those at kpos <= qpos -
// window.  Returns the launch's cudaError_t.
extern "C" int sparse_prefill_paged(const void* q, const void* k_pool,
                                    const void* v_pool,
                                    const float* k_scales,
                                    const float* v_scales, const int* items,
                                    const int* table, void* out, int L,
                                    int Sq, int Hkv, int D, int block_q,
                                    int block_kv, int table_width,
                                    int q_offset, int kv_len, float scale,
                                    int dtype, int kv_dtype, int window,
                                    void* stream) {
  if (table_width < 1) return cudaErrorInvalidValue;
  const prefill::PoolTiles tiles{table, table_width, Hkv, block_kv};
  const int klim = kv_len < table_width * block_kv ? kv_len
                                                   : table_width * block_kv;
  return prefill::dispatch(dtype, kv_dtype, D, q, k_pool, v_pool, k_scales,
                           v_scales, items, out, L, Sq, block_q, block_kv,
                           tiles, q_offset, klim, scale, window,
                           static_cast<cudaStream_t>(stream));
}
