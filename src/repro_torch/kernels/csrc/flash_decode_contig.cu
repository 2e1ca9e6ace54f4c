// Budgeted flash-decode over the contiguous slot cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_kernel (body _flash_decode_kernel, pallas_call at
// flash_decode.py:294), reached on the contiguous serving layout through
// ops.flash_decode_packed (packed items) and ops.flash_decode (items from
// per-slot block ids).  K/V tiles are read in place from the slot cache
// [B, Hkv, Smax, D]; nothing is copied into a pool layout.  The kernel body,
// its design and its bound are in flash_decode.cuh, shared with the paged
// decode, so both layouts keep one per-tile arithmetic order.
#include "flash_decode.cuh"

// dtype: 0 = bfloat16, 1 = float32 (q and both caches share it).
// window <= 0 means no sliding window.  Returns the launch's cudaError_t.
extern "C" int flash_decode_contig(const void* q, const void* k_cache,
                                   const void* v_cache, const int* items,
                                   const int* pos, float* out, float* m_out,
                                   float* l_out, int L, int Hkv, int G, int D,
                                   int block_kv, int max_len, float scale,
                                   int window, int dtype, void* stream) {
  if (block_kv < 1 || max_len % block_kv) return cudaErrorInvalidValue;
  const decode::SlotTiles tiles{Hkv, max_len / block_kv, block_kv};
  return decode::dispatch<decode::SlotTiles, false>(
      dtype, D, q, k_cache, v_cache, items, pos, out, m_out, l_out, L,
      Hkv, G, block_kv, tiles, scale, window,
      static_cast<cudaStream_t>(stream));
}
