// Paged work-list block-sparse causal prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_prefill.py::
// sparse_prefill_attention (pallas_call at sparse_prefill.py:165) together
// with its paged twin on the serving main path,
// attention/worklist_jnp.py::worklist_attention_paged.  K/V tiles come from
// the block pool [N, Hkv, block_kv, D] through the sequence's table [T]
// (-1 = unmapped, masked).  The kernel body, its design and its bound are in
// sparse_prefill.cuh, shared with the contiguous form.
#include "sparse_prefill.cuh"

// dtype: 0 = bfloat16, 1 = float32 (q, both pools and out share it).
// Keys at positions >= min(kv_len, table_width * block_kv) are masked.
// Returns the launch's cudaError_t.
extern "C" int sparse_prefill_paged(const void* q, const void* k_pool,
                                    const void* v_pool, const int* items,
                                    const int* table, void* out, int L,
                                    int Sq, int Hkv, int D, int block_q,
                                    int block_kv, int table_width,
                                    int q_offset, int kv_len, float scale,
                                    int dtype, void* stream) {
  if (table_width < 1) return cudaErrorInvalidValue;
  const prefill::PoolTiles tiles{table, table_width, Hkv, block_kv};
  const int klim = kv_len < table_width * block_kv ? kv_len
                                                   : table_width * block_kv;
  return prefill::dispatch(dtype, D, q, k_pool, v_pool, items, out, L, Sq,
                           block_q, block_kv, tiles, q_offset, klim, scale,
                           static_cast<cudaStream_t>(stream));
}
