// Paged, cost-packed budgeted flash-decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_paged_kernel (body _flash_decode_paged_kernel, pallas_call at
// flash_decode.py:587), reached on the serving main path through
// ops.flash_decode_packed_paged (packed items) and ops.flash_decode_paged
// (items from per-slot block ids).  K/V tiles come from the block pool
// [N, Hkv, block, D] through the per-row block table [B, T] (-1 =
// unmapped, masked), in bf16 / f32 or as int8 / fp8 codes with per-(block,
// kv head) scales (the TPU kernel's quantized branch).  The kernel body
// (one CTA a tile: K/V bulk-copied before the run scans, coalesced q.k, one
// p.V pass, the one merge), its design and its bound are in
// flash_decode.cuh, shared with the contiguous decode.
#include "flash_decode.cuh"

// dtype: the pools' element type, 0 = bfloat16, 1 = float32 (q shares
// either), 2 = int8 codes, 3 = fp8 e4m3 codes (q float32; k_scales /
// v_scales [N, Hkv] f32 at the physical block, null otherwise).
// window <= 0 means no sliding window.  partials: f32 [L * G * (D + 2)]
// workspace; tickets: int32 [L], zero at the call and left zero.
// Returns the launch's cudaError_t.
extern "C" int flash_decode_paged(const void* q, const void* k_pool,
                                  const void* v_pool, const float* k_scales,
                                  const float* v_scales, const int* items,
                                  const int* table, const int* pos,
                                  float* out, float* m_out, float* l_out,
                                  float* partials, int* tickets, int L,
                                  int Hkv, int G, int D, int block_kv,
                                  int table_width, float scale, int window,
                                  int dtype, void* stream) {
  const decode::PoolTiles tiles{table, table_width, Hkv, block_kv};
  const decode::Call c{q, k_pool, v_pool, k_scales, v_scales, items, pos,
                       out, m_out, l_out, partials, tickets, L, Hkv, G,
                       block_kv, scale, window,
                       static_cast<cudaStream_t>(stream)};
  return decode::dispatch(dtype, D, c, tiles);
}
