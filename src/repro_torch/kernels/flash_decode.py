"""Budgeted flash-decode over a work-item table: the CUDA kernels' wrappers
and their plain PyTorch versions, for the paged pool and the contiguous
slot cache.

- :func:`flash_decode_paged_kernel` is the port of the TPU kernel
  ``repro/kernels/flash_decode.py::flash_decode_paged_kernel``: it launches
  ``csrc/flash_decode_paged.cu`` on CUDA tensors and runs
  :func:`packed_decode_attention_paged` (the port of the reference's jnp
  twin ``attention/worklist_jnp.py::packed_decode_attention_paged``) on CPU
  tensors.  Pools ``[N, Hkv, block, D]``, table ``[B, T]`` (-1 = unmapped).
- :func:`flash_decode_kernel` is the port of the TPU kernel
  ``repro/kernels/flash_decode.py::flash_decode_kernel``: it launches
  ``csrc/flash_decode_contig.cu`` on CUDA tensors, reading the slot cache
  ``[B, Hkv, Smax, D]`` in place, and runs :func:`packed_decode_attention`
  (the port of ``worklist_jnp.py::packed_decode_attention``) on CPU tensors.

Both CUDA kernels are one body (``csrc/flash_decode.cuh``) over two tile
addressings, so the two layouts give the same bits on equal cache contents.
Both take q ``[B, Hkv, G, D]``, items ``[L, DEC_FIELDS]`` with LOGICAL kv
blocks (cost-packed, or the padded table of :func:`decode_items_from_ids`)
and pos ``[B]`` (last position, inclusive), and return ``(out f32 [B, Hkv,
G, D], m, l [B, Hkv, G])``.  :func:`flash_decode_reference` and
:func:`flash_decode_paged_reference` are the plain versions of the
per-slot block-id forms.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.worklist import (
    D_BATCH, D_FIRST, D_KVBLK, D_KVHEAD, D_LAST, D_VALID, DEC_FIELDS)
from repro_torch.kernels.build import check_launch, kernel_function

NEG_INF = -1e30
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
_CONTIG_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p])


def decode_items_from_ids(block_ids: torch.Tensor) -> torch.Tensor:
    """``block_ids [B, Hkv, nb]`` (-1 pad, trailing) -> the PADDED
    fixed-stride item table ``[B*Hkv*nb, DEC_FIELDS]`` int32 on the ids'
    device: row ``(b, h, j)`` at index ``(b*Hkv + h)*nb + j``, ``first`` /
    ``last`` at ``j == 0`` / ``j == nb-1`` unconditionally (an empty
    selection finalizes to out 0, m -1e30, l 0), -1 ids become valid=0 rows
    with kv block 0."""
    B, hkv, nb = block_ids.shape
    flat = block_ids.reshape(-1).to(torch.int32)
    idx = torch.arange(flat.shape[0], dtype=torch.int32,
                       device=block_ids.device)
    j, bh = idx % nb, idx // nb
    return torch.stack([bh // hkv, bh % hkv, flat.clamp_min(0),
                        (j == 0).int(), (j == nb - 1).int(),
                        (flat >= 0).int()], dim=1).contiguous()


def decode_scan(qf, tile, items, last_pos, *, block_kv: int, scale: float,
                window: int | None = None, legacy: bool = False):
    """The reference's decode item scan in float32, one item at a time —
    the plain version every decode kernel of the port is held against.

    ``qf [B, Hkv, G, D]`` float32 query rows; ``tile(b, h, blk)`` returns
    ``(k, v)`` float32 ``[block_kv, D]`` of a logical block or None when
    unmapped;
    ``last_pos[b]`` is row b's last position (keys at ``kpos <= last_pos``
    count).  Flash-decode rules: a run starts on ``first`` and finalizes on
    ``last`` whether or not that item is valid; with ``legacy`` (the legacy
    budgeted decode) only valid items start or finalize a run.  Invalid or
    unmapped items leave the running state untouched.  Returns ``(out, m,
    l)``; (row, head) pairs no run finalizes keep (0, -1e30, 0).
    """
    B, hkv, G, dh = qf.shape
    dev = qf.device
    out = torch.zeros((B, hkv, G, dh), dtype=torch.float32, device=dev)
    m_out = torch.full((B, hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l_out = torch.zeros((B, hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((G, dh), dtype=torch.float32, device=dev)
    m = torch.full((G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((G, 1), dtype=torch.float32, device=dev)
    offs = torch.arange(block_kv, device=dev)
    for it in items.tolist():
        b, h, blk = it[D_BATCH], it[D_KVHEAD], it[D_KVBLK]
        valid = it[D_VALID] == 1
        counts = valid or not legacy
        if it[D_FIRST] == 1 and counts:
            acc = torch.zeros_like(acc)
            m = torch.full_like(m, NEG_INF)
            l = torch.zeros_like(l)
        kv = tile(b, h, blk) if valid else None
        if kv is not None:
            kt, vt = kv
            s = (qf[b, h] @ kt.T) * scale                     # [G, blk]
            kpos = blk * block_kv + offs
            mask = kpos <= last_pos[b]
            if window is not None:
                mask &= kpos > last_pos[b] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            pr = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + pr.sum(dim=-1, keepdim=True)
            acc = acc * alpha + pr @ vt
            m = m_new
        if it[D_LAST] == 1 and counts:
            out[b, h] = torch.where(l > 0.0, acc / l.clamp_min(1e-30), 0.0)
            m_out[b, h] = m[:, 0]
            l_out[b, h] = l[:, 0]
    return out, m_out, l_out


def _scale(dh: int, scale: float | None) -> float:
    return float(dh ** -0.5) if scale is None else float(scale)


def slot_tiles(k_cache, v_cache, block_kv: int):
    """``tile`` for :func:`decode_scan` over a slot cache ``[B, Hkv, Smax,
    D]`` of whole blocks: block ``blk`` of row b is rows ``[blk*block_kv,
    +block_kv)``; a block outside the cache is unmapped."""
    smax = k_cache.shape[2]

    def tile(b, h, blk):
        lo = blk * block_kv
        if blk < 0 or lo >= smax:
            return None
        return (k_cache[b, h, lo:lo + block_kv].to(torch.float32),
                v_cache[b, h, lo:lo + block_kv].to(torch.float32))
    return tile


def packed_decode_attention(q, k_cache, v_cache, items, pos, *,
                            block_kv: int = 128, scale: float | None = None,
                            window: int | None = None):
    """Plain PyTorch version of :func:`flash_decode_kernel`: the reference's
    item scan over the slot cache ``[B, Hkv, Smax, D]``.  q.k multiplies q
    cast to the cache dtype with the cache tile and sums in float32; p.V is
    float32."""
    qf = q.to(k_cache.dtype).to(torch.float32)
    return decode_scan(qf, slot_tiles(k_cache, v_cache, block_kv), items,
                       pos.tolist(), block_kv=block_kv,
                       scale=_scale(q.shape[-1], scale), window=window)


def packed_decode_attention_paged(q, k_pool, v_pool, items, table, pos, *,
                                  block_kv: int = 128,
                                  scale: float | None = None,
                                  window: int | None = None):
    """Plain PyTorch version of :func:`flash_decode_paged_kernel`: the
    reference's item scan over the block pool through ``table [B, T]``
    (logical index clamped into the table, -1 entries unmapped).  Same
    arithmetic as :func:`packed_decode_attention`."""
    T = table.shape[1]
    tbl = table.tolist()

    def tile(b, h, blk):
        phys = tbl[b][min(max(blk, 0), T - 1)]
        if phys < 0:
            return None
        return (k_pool[phys, h].to(torch.float32),
                v_pool[phys, h].to(torch.float32))
    qf = q.to(k_pool.dtype).to(torch.float32)
    return decode_scan(qf, tile, items, pos.tolist(), block_kv=block_kv,
                       scale=_scale(q.shape[-1], scale), window=window)


def flash_decode_reference(q, k_cache, v_cache, block_ids, pos, *,
                           block_kv: int = 128, scale: float | None = None,
                           window: int | None = None):
    """Plain version of the per-slot block-id form over the slot cache
    (the reference's ``flash_decode_reference``): ``block_ids [B, Hkv, nb]``
    (-1 pad) run as the padded item table."""
    return packed_decode_attention(
        q, k_cache, v_cache, decode_items_from_ids(block_ids), pos,
        block_kv=block_kv, scale=scale, window=window)


def flash_decode_paged_reference(q, k_pool, v_pool, block_ids, table, pos, *,
                                 block_kv: int = 128,
                                 scale: float | None = None,
                                 window: int | None = None):
    """Plain version of the per-slot block-id form over the pool (the
    reference's ``flash_decode_paged_reference``)."""
    return packed_decode_attention_paged(
        q, k_pool, v_pool, decode_items_from_ids(block_ids), table, pos,
        block_kv=block_kv, scale=scale, window=window)


def flash_decode_paged_kernel(q, k_pool, v_pool, items, table, pos, *,
                              block_kv: int = 128,
                              scale: float | None = None,
                              window: int | None = None):
    """Budgeted flash-decode over the block pool (see module docstring).

    CPU tensors run :func:`packed_decode_attention_paged`.  CUDA tensors
    launch the CUDA kernel (bf16 or f32 pools, head_dim 32/64, G <= 4)
    or raise; there is no fallback.  ``launches`` counts kernel launches.
    """
    B, hkv, G, dh = q.shape
    check_decode_args(q, k_pool, v_pool, items, block_kv, pos, table)
    if k_pool.shape[1:] != (hkv, block_kv, dh):
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)} at block_kv={block_kv}")
    if q.device.type == "cpu":
        return packed_decode_attention_paged(
            q, k_pool, v_pool, items, table, pos, block_kv=block_kv,
            scale=scale, window=window)
    check_cuda_decode("flash_decode_paged", q, k_pool)
    out, m, l = _partials(q)
    if items.shape[0] == 0:
        return out, m, l
    fn = kernel_function("flash_decode_paged", _PAGED_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.to(k_pool.dtype).data_ptr(), k_pool.data_ptr(),
                 v_pool.data_ptr(), items.data_ptr(), table.data_ptr(),
                 pos.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
                 items.shape[0], hkv, G, dh, block_kv, table.shape[1],
                 _scale(dh, scale), 0 if window is None else int(window),
                 DTYPES[k_pool.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_decode_paged", err)
    flash_decode_paged_kernel.launches += 1
    return out, m, l


flash_decode_paged_kernel.launches = 0


def flash_decode_kernel(q, k_cache, v_cache, items, pos, *,
                        block_kv: int = 128, scale: float | None = None,
                        window: int | None = None):
    """Budgeted flash-decode over the slot cache ``[B, Hkv, Smax, D]``, in
    place (see module docstring).

    CPU tensors run :func:`packed_decode_attention`.  CUDA tensors launch
    the CUDA kernel (bf16 or f32 caches, head_dim 32/64, G <= 4) or raise;
    there is no fallback.  ``launches`` counts kernel launches.
    """
    B, hkv, G, dh = q.shape
    check_decode_args(q, k_cache, v_cache, items, block_kv, pos)
    if (k_cache.shape[0], k_cache.shape[1], k_cache.shape[3]) != (B, hkv, dh):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return packed_decode_attention(q, k_cache, v_cache, items, pos,
                                       block_kv=block_kv, scale=scale,
                                       window=window)
    check_cuda_decode("flash_decode_contig", q, k_cache)
    out, m, l = _partials(q)
    if items.shape[0] == 0:
        return out, m, l
    fn = kernel_function("flash_decode_contig", _CONTIG_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.to(k_cache.dtype).data_ptr(), k_cache.data_ptr(),
                 v_cache.data_ptr(), items.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), m.data_ptr(), l.data_ptr(),
                 items.shape[0], hkv, G, dh, block_kv, k_cache.shape[2],
                 _scale(dh, scale), 0 if window is None else int(window),
                 DTYPES[k_cache.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_decode_contig", err)
    flash_decode_kernel.launches += 1
    return out, m, l


flash_decode_kernel.launches = 0


def _partials(q):
    B, hkv, G, dh = q.shape
    return (torch.zeros((B, hkv, G, dh), dtype=torch.float32,
                        device=q.device),
            torch.full((B, hkv, G), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((B, hkv, G), dtype=torch.float32, device=q.device))


def check_cuda_decode(name: str, q, k):
    """Raise unless ``q`` lies on CUDA and the kernel ``name`` takes the
    cache's dtype, the head_dim and the GQA group size."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {q.device}")
    dh, G = q.shape[-1], q.shape[-2]
    if k.dtype not in DTYPES or dh not in (32, 64) or G > 4:
        raise ValueError(f"{name} kernel takes bf16/f32 caches, head_dim "
                         f"32/64 and G <= 4; got {k.dtype}, {dh}, {G}")


def check_decode_args(q, k, v, items, block_kv: int, pos=None, table=None):
    """Shapes, dtypes, devices and contiguity every decode wrapper needs:
    q ``[B, Hkv, G, D]``, 4-D K/V of one shape holding whole ``block_kv``
    tiles along dim 2 (a pool's block, or a slot cache's Smax), items
    ``[L, DEC_FIELDS]``, int32 pos ``[B]`` and table ``[B, T]`` where
    given."""
    B = q.shape[0]
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Hkv, G, D] and K/V 4-D of one "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[2] % block_kv:
        raise ValueError(f"K/V rows {k.shape[2]} are not whole "
                         f"{block_kv}-row blocks")
    if items.dim() != 2 or items.shape[1] != DEC_FIELDS:
        raise ValueError(f"items must be [L, {DEC_FIELDS}], got "
                         f"{tuple(items.shape)}")
    if pos is not None and pos.shape != (B,):
        raise ValueError(f"pos must be [B] for B={B}")
    if table is not None and (table.dim() != 2 or table.shape[0] != B):
        raise ValueError(f"table must be [B, T] for B={B}")
    named = [("q", q), ("k", k), ("v", v), ("items", items)]
    named += [(n, t) for n, t in (("pos", pos), ("table", table))
              if t is not None]
    for name, t in named[3:]:
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
