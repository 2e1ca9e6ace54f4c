// Contiguous work-list block-sparse causal prefill attention for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_prefill.py::
// sparse_prefill_attention (pallas_call at sparse_prefill.py:165) in its own
// contiguous layout, with the chunked-prefill offsets of its jnp twin
// attention/worklist_jnp.py::worklist_attention (used by the contiguous
// serving layout's prefill_chunk).  K/V tiles are read in place from
// [Hkv, Skv, D] (a slot row of the cache); nothing is copied into a pool
// layout.  The kernel body, its design and its bound are in
// sparse_prefill.cuh, shared with the paged form.
#include "sparse_prefill.cuh"

// dtype: 0 = bfloat16, 1 = float32 (q, K/V and out share it).  Keys at
// positions >= min(kv_len, Skv) are masked, and with window > 0 (the window
// form; -1: none) those at kpos <= qpos - window.  Returns the launch's
// cudaError_t.
extern "C" int sparse_prefill_contig(const void* q, const void* k,
                                     const void* v, const int* items,
                                     void* out, int L, int Sq, int Skv, int D,
                                     int block_q, int block_kv, int q_offset,
                                     int kv_len, float scale, int dtype,
                                     int window, void* stream) {
  if (Skv < 1) return cudaErrorInvalidValue;
  const prefill::RowTiles tiles{Skv, block_kv};
  return prefill::dispatch(dtype, dtype, D, q, k, v, nullptr, nullptr,
                           items, out, L, Sq, block_q, block_kv, tiles,
                           q_offset, kv_len < Skv ? kv_len : Skv, scale,
                           window, static_cast<cudaStream_t>(stream));
}
