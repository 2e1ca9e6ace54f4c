"""Work-list block-sparse prefill attention: the CUDA kernels' wrappers and
their plain PyTorch versions, for the paged pool and contiguous K/V.

Both are ports of the TPU kernel
``repro/kernels/sparse_prefill.py::sparse_prefill_attention`` with the
chunked-prefill offsets of its jnp twins, one CUDA body
(``csrc/sparse_prefill.cuh``) over two tile addressings:

- :func:`sparse_prefill_paged` (the paged serving path, twin
  ``attention/worklist_jnp.py::worklist_attention_paged``) launches
  ``csrc/sparse_prefill_paged.cu`` on CUDA tensors and runs
  :func:`worklist_attention_paged` on CPU tensors.  Pools ``[N, Hkv,
  block_kv, D]``, table ``[T]`` (-1 = unmapped).
- :func:`sparse_prefill_attention` (the contiguous serving path, twin
  ``worklist_attention``) launches ``csrc/sparse_prefill_contig.cu`` on
  CUDA tensors, reading K/V ``[Hkv, Skv, D]`` in place, and runs
  :func:`worklist_attention` on CPU tensors.

q ``[H, Sq, D]``, items ``[L, ITEM_FIELDS]`` with chunk-local q blocks and
LOGICAL kv blocks.  Queries sit at positions ``q_offset + i`` and attend
keys ``< kv_len``.  Output ``[H, Sq, D]`` in q's dtype; rows of (head,
q_blk) pairs no item covers are zero.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.worklist import (
    F_FIRST, F_HEAD, F_KVBLK, F_KVHEAD, F_LAST, F_QBLK, F_VALID, ITEM_FIELDS)
from repro_torch.kernels.build import check_launch, kernel_function

NEG_INF = -1e30
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_CONTIG_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def worklist_scan(q, tile, items, *, block_q: int, block_kv: int,
                  scale: float | None, q_offset: int, klim: int):
    """The reference's prefill item scan in float32, one item at a time —
    the plain version both prefill kernels are held against.

    ``tile(kv_head, kv_blk)`` returns ``(k, v, mapped)``: float32 ``[block_kv,
    D]`` tiles and whether the block is mapped (an unmapped block is
    computed fully masked, as the reference does).  A run initializes on
    ``first`` and writes its tile on a valid ``last``; keys at ``kpos <
    klim`` and ``kpos <= q_offset + i`` count for query row i."""
    hq, sq, dh = q.shape
    dev = q.device
    scale_v = float(dh ** -0.5) if scale is None else float(scale)
    qp = F.pad(q, (0, 0, 0, (-sq) % block_q)).to(torch.float32)
    out = torch.zeros((hq, qp.shape[1], dh), dtype=torch.float32, device=dev)
    acc = torch.zeros((block_q, dh), dtype=torch.float32, device=dev)
    m = torch.full((block_q, 1), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((block_q, 1), dtype=torch.float32, device=dev)
    qi = torch.arange(block_q, device=dev)[:, None]
    ki = torch.arange(block_kv, device=dev)[None, :]
    for it in items.tolist():
        head, qblk, kvblk = it[F_HEAD], it[F_QBLK], it[F_KVBLK]
        if it[F_FIRST] == 1:
            acc = torch.zeros_like(acc)
            m = torch.full_like(m, -torch.inf)
            l = torch.zeros_like(l)
        if it[F_VALID] != 1:
            continue
        kt, vt, mapped = tile(it[F_KVHEAD], kvblk)
        rows = slice(qblk * block_q, (qblk + 1) * block_q)
        s = (qp[head, rows] @ kt.T) * scale_v
        qpos = qblk * block_q + qi
        kpos = kvblk * block_kv + ki
        mask = ((kpos <= qpos + q_offset) & (kpos < klim) & (qpos < sq)
                & mapped)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vt
        m = m_new
        if it[F_LAST] == 1:
            out[head, rows] = torch.where(l > 0.0, acc / l.clamp_min(1e-30),
                                          0.0)
    return out[:, :sq].to(q.dtype)


def worklist_attention_paged(q, k_pool, v_pool, items, table, *,
                             block_q: int = 128, block_kv: int = 128,
                             scale: float | None = None, q_offset: int = 0,
                             kv_len: int | None = None):
    """Plain version of :func:`sparse_prefill_paged` (the reference's jnp
    twin of the same name): tiles through the table, the logical index
    clamped into it, -1 entries masked."""
    T = table.shape[0]
    klim = T * block_kv if kv_len is None else min(int(kv_len), T * block_kv)
    tbl = table.tolist()

    def tile(kvh, kvblk):
        phys = tbl[min(max(kvblk, 0), T - 1)]
        safe = max(phys, 0)
        return (k_pool[safe, kvh].to(torch.float32),
                v_pool[safe, kvh].to(torch.float32), phys >= 0)
    return worklist_scan(q, tile, items, block_q=block_q, block_kv=block_kv,
                         scale=scale, q_offset=q_offset, klim=klim)


def worklist_attention(q, k, v, items, *, block_q: int = 128,
                       block_kv: int = 128, scale: float | None = None,
                       q_offset: int = 0, kv_len: int | None = None):
    """Plain version of :func:`sparse_prefill_attention` (the reference's
    jnp twin ``worklist_attention``): K/V ``[Hkv, Skv, D]`` zero-padded to
    whole blocks, a tile's start clamped into them as ``dynamic_slice``
    does."""
    skv = k.shape[1]
    nb = -(-skv // block_kv)
    klim = skv if kv_len is None else min(int(kv_len), skv)

    def tile(kvh, kvblk):
        lo = min(max(kvblk, 0), nb - 1) * block_kv
        pad = (0, 0, 0, block_kv - min(block_kv, skv - lo))
        return (F.pad(k[kvh, lo:lo + block_kv], pad).to(torch.float32),
                F.pad(v[kvh, lo:lo + block_kv], pad).to(torch.float32), True)
    return worklist_scan(q, tile, items, block_q=block_q, block_kv=block_kv,
                         scale=scale, q_offset=q_offset, klim=klim)


def sparse_prefill_paged(q, k_pool, v_pool, items, table, *,
                         block_q: int = 128, block_kv: int = 128,
                         scale: float | None = None, q_offset: int = 0,
                         kv_len: int | None = None):
    """Work-list sparse prefill over the block pool (see module docstring).

    CPU tensors run :func:`worklist_attention_paged`.  CUDA tensors launch
    the CUDA kernel (q and pools of one dtype, bf16 or f32; head_dim
    32/64; block_q <= 1024) or raise; there is no fallback.
    ``launches`` counts kernel launches.
    """
    hq, sq, dh = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be [N, Hkv, block, D] of one shape; "
                         f"got {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    if k_pool.shape[2] != block_kv or k_pool.shape[3] != dh:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)} at block_kv={block_kv}")
    if table.dim() != 1 or table.shape[0] < 1:
        raise ValueError(f"table must be [T] with T >= 1, got "
                         f"{tuple(table.shape)}")
    _check_common(q, k_pool, v_pool, items, table)
    if q.device.type == "cpu":
        return worklist_attention_paged(
            q, k_pool, v_pool, items, table, block_q=block_q,
            block_kv=block_kv, scale=scale, q_offset=q_offset, kv_len=kv_len)
    _check_cuda("sparse_prefill_paged", q, k_pool, block_q)
    out = torch.zeros_like(q)
    L = items.shape[0]
    if L == 0:
        return out
    T = table.shape[0]
    kv = T * block_kv if kv_len is None else int(kv_len)
    scale_v = float(dh ** -0.5) if scale is None else float(scale)
    fn = kernel_function("sparse_prefill_paged", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 items.data_ptr(), table.data_ptr(), out.data_ptr(),
                 L, sq, k_pool.shape[1], dh, block_q, block_kv, T,
                 int(q_offset), kv, scale_v, _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("sparse_prefill_paged", err)
    sparse_prefill_paged.launches += 1
    return out


sparse_prefill_paged.launches = 0


def sparse_prefill_attention(q, k, v, items, *, block_q: int = 128,
                             block_kv: int = 128,
                             scale: float | None = None, q_offset: int = 0,
                             kv_len: int | None = None):
    """Work-list sparse prefill over contiguous K/V ``[Hkv, Skv, D]``, read
    in place: the TPU kernel's own signature, with the chunked-prefill
    ``q_offset`` / ``kv_len`` of its jnp twin (keys at ``kpos < min(kv_len,
    Skv)``; ``kv_len`` defaults to Skv).

    CPU tensors run :func:`worklist_attention`.  CUDA tensors launch
    ``csrc/sparse_prefill_contig.cu`` (q and K/V of one dtype, bf16 or f32;
    head_dim 32/64; block_q <= 1024) or raise; there is no fallback.
    ``launches`` counts kernel launches.
    """
    hq, sq, dh = q.shape
    if k.dim() != 3 or k.shape != v.shape or k.shape[2] != dh:
        raise ValueError(f"K/V must be [Hkv, Skv, {dh}] of one shape; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _check_common(q, k, v, items)
    if q.device.type == "cpu":
        return worklist_attention(q, k, v, items, block_q=block_q,
                                  block_kv=block_kv, scale=scale,
                                  q_offset=q_offset, kv_len=kv_len)
    _check_cuda("sparse_prefill_contig", q, k, block_q)
    out = torch.zeros_like(q)
    L = items.shape[0]
    if L == 0:
        return out
    skv = k.shape[1]
    kv = skv if kv_len is None else int(kv_len)
    scale_v = float(dh ** -0.5) if scale is None else float(scale)
    fn = kernel_function("sparse_prefill_contig", _CONTIG_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), items.data_ptr(),
                 out.data_ptr(), L, sq, skv, dh, block_q, block_kv,
                 int(q_offset), kv, scale_v, _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("sparse_prefill_contig", err)
    sparse_prefill_attention.launches += 1
    return out


sparse_prefill_attention.launches = 0


def _check_cuda(name: str, q, k, block_q: int):
    if q.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {q.device}")
    dh = q.shape[-1]
    if (q.dtype != k.dtype or q.dtype not in _DTYPES or dh not in (32, 64)
            or not 0 < block_q <= 1024):
        raise ValueError(
            f"{name} kernel takes q and K/V of one dtype (bf16/f32), "
            f"head_dim 32/64 and block_q <= 1024; got {q.dtype}/{k.dtype}, "
            f"{dh}, {block_q}")


def _check_common(q, k, v, items, table=None):
    if q.dim() != 3:
        raise ValueError(f"q must be [H, Sq, D], got {tuple(q.shape)}")
    if items.dim() != 2 or items.shape[1] != ITEM_FIELDS:
        raise ValueError(f"items must be [L, {ITEM_FIELDS}], got "
                         f"{tuple(items.shape)}")
    named = [("q", q), ("k", k), ("v", v), ("items", items)]
    if table is not None:
        named.append(("table", table))
    for name, t in named[3:]:
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
