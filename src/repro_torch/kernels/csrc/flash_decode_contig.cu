// Budgeted flash-decode over the contiguous slot cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_kernel (body _flash_decode_kernel, pallas_call at
// flash_decode.py:294), reached on the contiguous serving layout through
// ops.flash_decode_packed (packed items) and ops.flash_decode (items from
// per-slot block ids).  K/V tiles are read in place from the slot cache
// [B, Hkv, Smax, D], in bf16 / f32 or as int8 / fp8 codes with per-(row,
// kv head, block) scales; nothing is copied into a pool layout.  The
// kernel body (one CTA a tile: K/V bulk-copied before the run scans,
// coalesced q.k, one p.V pass, the one merge), its design and its bound
// are in flash_decode.cuh, shared with the paged decode, so both layouts
// keep one per-tile arithmetic order.
#include "flash_decode.cuh"

// dtype: the caches' element type, 0 = bfloat16, 1 = float32 (q shares
// either), 2 = int8 codes, 3 = fp8 e4m3 codes (q float32; k_scales /
// v_scales [B, Hkv, max_len / block_kv] f32, null otherwise).
// window <= 0 means no sliding window.  partials: f32 [L * G * (D + 2)]
// workspace; tickets: int32 [L], zero at the call and left zero.
// Returns the launch's cudaError_t.
extern "C" int flash_decode_contig(const void* q, const void* k_cache,
                                   const void* v_cache, const float* k_scales,
                                   const float* v_scales, const int* items,
                                   const int* pos, float* out, float* m_out,
                                   float* l_out, float* partials,
                                   int* tickets, int L, int Hkv, int G,
                                   int D, int block_kv, int max_len,
                                   float scale, int window, int dtype,
                                   void* stream) {
  if (block_kv < 1 || max_len % block_kv) return cudaErrorInvalidValue;
  const decode::SlotTiles tiles{Hkv, max_len / block_kv, block_kv};
  const decode::Call c{q, k_cache, v_cache, k_scales, v_scales, items, pos,
                       out, m_out, l_out, partials, tickets, L, Hkv, G,
                       block_kv, scale, window,
                       static_cast<cudaStream_t>(stream)};
  return decode::dispatch(dtype, D, c, tiles);
}
