"""Public entry points of the attention kernels in the serving layout.

CPU tensors run each kernel's plain PyTorch version; CUDA tensors launch the
CUDA kernel.  Models and the serving engine call through this module.
"""
from __future__ import annotations

from repro_torch.kernels.flash_decode import flash_decode_paged_kernel
# chunked prefill: the wrapper already takes the serving layout
# (q [H, C, D] of one sequence, its table [T], q_offset / kv_len)
from repro_torch.kernels.sparse_prefill import (  # noqa: F401
    sparse_prefill_paged as sparse_prefill)


def flash_decode_packed_paged(q, k_pool, v_pool, items, table, pos, *,
                              block_kv: int = 128, scale: float | None = None,
                              window: int | None = None,
                              partials: bool = False):
    """Cost-packed paged flash-decode in the serving layout.

    q ``[B, H, 1, D]`` (the GQA grouping happens here); pools ``[N, Hkv,
    block_kv, D]``; ``items [L, DEC_FIELDS]`` int32 packed decode work list
    (LOGICAL kv blocks); ``table [B, T]`` int32 (-1 = unmapped, masked);
    ``pos [B]`` int32 per-row last position.  Returns ``out [B, H, 1, D]``
    in q's dtype, or with ``partials`` the float32 ``(out, m, l)``.
    """
    B, H, _, dh = q.shape
    hkv = k_pool.shape[1]
    qg = q.reshape(B, hkv, H // hkv, dh)
    out, m, l = flash_decode_paged_kernel(
        qg, k_pool, v_pool, items, table, pos, block_kv=block_kv,
        scale=scale, window=window)
    out = out.reshape(B, H, 1, dh)
    if partials:
        return out, m, l
    return out.to(q.dtype)

