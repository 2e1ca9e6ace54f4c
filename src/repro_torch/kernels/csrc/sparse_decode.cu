// Legacy work-list budgeted decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_decode.py::
// sparse_decode_attention (body _sparse_decode_kernel, pallas_call at
// sparse_decode.py:241), reached through the library entry
// ops.sparse_decode on item tables from build_decode_worklist.  K/V tiles
// are read in place from the slot cache [B, Hkv, Smax, D]; the mask is the
// static kpos < cache_len (no per-row position, no window); a run starts on
// `valid & first` and writes its tile, in q's dtype, on `valid & last`.
// The kernel body, its design and its bound are in flash_decode.cuh.
#include "flash_decode.cuh"

// dtype: 0 = bfloat16, 1 = float32 (q, both caches and out share it).
// last_pos [B] holds cache_len - 1 for every row (the static mask
// kpos < cache_len).  Returns the launch's cudaError_t.
extern "C" int sparse_decode(const void* q, const void* k_cache,
                             const void* v_cache, const int* items,
                             const int* last_pos, void* out, int L, int Hkv,
                             int G, int D, int block_kv, int max_len,
                             float scale, int dtype, void* stream) {
  if (block_kv < 1 || max_len % block_kv) return cudaErrorInvalidValue;
  const decode::SlotTiles tiles{Hkv, max_len / block_kv, block_kv};
  return decode::dispatch<decode::SlotTiles, true>(
      dtype, D, q, k_cache, v_cache, items, last_pos, out, nullptr, nullptr,
      L, Hkv, G, block_kv, tiles, scale, 0,
      static_cast<cudaStream_t>(stream));
}
