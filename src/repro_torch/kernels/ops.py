"""Public entry points of the attention kernels, with the reference's
signatures (``repro/kernels/ops.py``).

CPU tensors run each kernel's plain PyTorch version; CUDA tensors launch the
CUDA kernel.  Models and the serving engine call through this module.
"""
from __future__ import annotations

# the library-only kernels, with the reference's signatures: dense flash
# attention (q [H, Sq, D], k/v [Hkv, Skv, D]) and the legacy budgeted decode
# (q [B, Hkv, G, D], slot caches, items from build_decode_worklist)
from repro_torch.kernels.flash_attn import flash_attention  # noqa: F401
from repro_torch.kernels.flash_decode import (
    decode_items_from_ids, flash_decode_kernel, flash_decode_paged_kernel)
from repro_torch.kernels.sparse_decode import (  # noqa: F401
    DecodeWorkList, build_decode_worklist,
    sparse_decode_attention as sparse_decode)
# chunked prefill: the wrappers already take the serving layout (q [H, C,
# D] of one sequence, q_offset / kv_len), over the pool through its table
# [T] or over one contiguous slot row [Hkv, Smax, D]
from repro_torch.kernels.sparse_prefill import (  # noqa: F401
    sparse_prefill_attention as sparse_prefill_contiguous,
    sparse_prefill_paged as sparse_prefill)


def _serving(fn, q, hkv, *args, partials: bool, **kw):
    """Group q ``[B, H, 1, D]`` by kv head, run ``fn`` and return ``out [B,
    H, 1, D]`` in q's dtype, or with ``partials`` the float32 ``(out, m,
    l)``."""
    B, H, _, dh = q.shape
    out, m, l = fn(q.reshape(B, hkv, H // hkv, dh), *args, **kw)
    out = out.reshape(B, H, 1, dh)
    if partials:
        return out, m, l
    return out.to(q.dtype)


def flash_decode(q, k_cache, v_cache, block_ids, pos, *, block_kv: int = 128,
                 scale: float | None = None, window: int | None = None,
                 partials: bool = False):
    """Budgeted flash-decode over the slot cache from per-slot block ids.

    q ``[B, H, 1, D]`` (the GQA grouping happens here); caches ``[B, Hkv,
    Smax, D]``; ``block_ids [B, Hkv, nb]`` int32 selected blocks (-1 pad,
    trailing), run as the padded item table; ``pos [B]`` int32 per-row last
    position.  Returns ``out [B, H, 1, D]`` in q's dtype, or with
    ``partials`` the float32 ``(out, m, l)``.
    """
    return _serving(flash_decode_kernel, q, k_cache.shape[1], k_cache,
                    v_cache, decode_items_from_ids(block_ids), pos,
                    partials=partials, block_kv=block_kv, scale=scale,
                    window=window)


def flash_decode_packed(q, k_cache, v_cache, items, pos, *,
                        block_kv: int = 128, scale: float | None = None,
                        window: int | None = None, partials: bool = False):
    """Cost-packed flash-decode over the slot cache: ``items [L,
    DEC_FIELDS]`` int32 packed decode work list; otherwise as
    :func:`flash_decode`."""
    return _serving(flash_decode_kernel, q, k_cache.shape[1], k_cache,
                    v_cache, items, pos, partials=partials,
                    block_kv=block_kv, scale=scale, window=window)


def flash_decode_paged(q, k_pool, v_pool, block_ids, table, pos, *,
                       block_kv: int = 128, scale: float | None = None,
                       window: int | None = None, partials: bool = False):
    """Budgeted flash-decode over the block pool ``[N, Hkv, block_kv, D]``
    from per-slot LOGICAL block ids, through ``table [B, T]`` int32 (-1 =
    unmapped, masked); otherwise as :func:`flash_decode`."""
    return _serving(flash_decode_paged_kernel, q, k_pool.shape[1], k_pool,
                    v_pool, decode_items_from_ids(block_ids), table, pos,
                    partials=partials, block_kv=block_kv, scale=scale,
                    window=window)


def flash_decode_packed_paged(q, k_pool, v_pool, items, table, pos, *,
                              block_kv: int = 128, scale: float | None = None,
                              window: int | None = None,
                              partials: bool = False):
    """Cost-packed flash-decode over the block pool: ``items [L,
    DEC_FIELDS]`` int32 packed decode work list (LOGICAL kv blocks),
    ``table [B, T]`` int32; otherwise as :func:`flash_decode`."""
    return _serving(flash_decode_paged_kernel, q, k_pool.shape[1], k_pool,
                    v_pool, items, table, pos, partials=partials,
                    block_kv=block_kv, scale=scale, window=window)
