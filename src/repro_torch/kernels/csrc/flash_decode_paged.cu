// Paged, cost-packed budgeted flash-decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_paged_kernel (body _flash_decode_paged_kernel, pallas_call at
// flash_decode.py:587), reached on the serving main path through
// ops.flash_decode_packed_paged (packed items) and ops.flash_decode_paged
// (items from per-slot block ids).  K/V tiles come from the block pool
// [N, Hkv, block, D] through the per-row block table [B, T] (-1 =
// unmapped, masked).  The kernel body, its design and its bound are in
// flash_decode.cuh, shared with the contiguous and legacy decodes.
#include "flash_decode.cuh"

// dtype: 0 = bfloat16, 1 = float32 (q and both pools share it).
// window <= 0 means no sliding window.  Returns the launch's cudaError_t.
extern "C" int flash_decode_paged(const void* q, const void* k_pool,
                                  const void* v_pool, const int* items,
                                  const int* table, const int* pos,
                                  float* out, float* m_out, float* l_out,
                                  int L, int Hkv, int G, int D, int block_kv,
                                  int table_width, float scale, int window,
                                  int dtype, void* stream) {
  const decode::PoolTiles tiles{table, table_width, Hkv, block_kv};
  return decode::dispatch<decode::PoolTiles, false>(
      dtype, D, q, k_pool, v_pool, items, pos, out, m_out, l_out, L, Hkv,
      G, block_kv, tiles, scale, window, static_cast<cudaStream_t>(stream));
}
