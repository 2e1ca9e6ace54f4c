"""Paged, cost-packed budgeted flash-decode: the CUDA kernel's wrapper and
its plain PyTorch version.

:func:`flash_decode_paged_kernel` is the port of the TPU kernel
``repro/kernels/flash_decode.py::flash_decode_paged_kernel``: it launches
``csrc/flash_decode_paged.cu`` on CUDA tensors and runs
:func:`packed_decode_attention_paged` (the port of the reference's jnp twin
``attention/worklist_jnp.py::packed_decode_attention_paged``) on CPU
tensors.  Both take the reference's layouts: q ``[B, Hkv, G, D]``, pools
``[N, Hkv, block, D]``, items ``[L, DEC_FIELDS]`` with LOGICAL kv blocks,
table ``[B, T]`` (-1 = unmapped), pos ``[B]`` (last position, inclusive);
both return ``(out f32 [B, Hkv, G, D], m, l [B, Hkv, G])``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.worklist import (
    D_BATCH, D_FIRST, D_KVBLK, D_KVHEAD, D_LAST, D_VALID, DEC_FIELDS)
from repro_torch.kernels.build import check_launch, kernel_function

NEG_INF = -1e30
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def packed_decode_attention_paged(q, k_pool, v_pool, items, table, pos, *,
                                  block_kv: int = 128,
                                  scale: float | None = None,
                                  window: int | None = None):
    """Plain PyTorch version: the reference's item scan, one item at a time.

    q.k multiplies q cast to the pool dtype with the pool tile and sums in
    float32; p.V is float32.  A run finalizes on its ``last`` item whether
    or not that item is valid; invalid or unmapped items leave the running
    state untouched.
    """
    B, hkv, G, dh = q.shape
    dev = q.device
    scale_v = float(dh ** -0.5) if scale is None else float(scale)
    qc = q.to(k_pool.dtype).to(torch.float32)
    T = table.shape[1]
    tbl = table.tolist()
    pos_l = pos.tolist()
    out = torch.zeros((B, hkv, G, dh), dtype=torch.float32, device=dev)
    m_out = torch.full((B, hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l_out = torch.zeros((B, hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((G, dh), dtype=torch.float32, device=dev)
    m = torch.full((G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((G, 1), dtype=torch.float32, device=dev)
    offs = torch.arange(block_kv, device=dev)
    for it in items.tolist():
        b, h, blk = it[D_BATCH], it[D_KVHEAD], it[D_KVBLK]
        if it[D_FIRST] == 1:
            acc = torch.zeros_like(acc)
            m = torch.full_like(m, NEG_INF)
            l = torch.zeros_like(l)
        phys = tbl[b][min(max(blk, 0), T - 1)]
        if it[D_VALID] == 1 and phys >= 0:
            kt = k_pool[phys, h].to(torch.float32)
            vt = v_pool[phys, h].to(torch.float32)
            s = (qc[b, h] @ kt.T) * scale_v                   # [G, blk]
            kpos = blk * block_kv + offs
            mask = kpos <= pos_l[b]
            if window is not None:
                mask &= kpos > pos_l[b] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            pr = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + pr.sum(dim=-1, keepdim=True)
            acc = acc * alpha + pr @ vt
            m = m_new
        if it[D_LAST] == 1:
            out[b, h] = torch.where(l > 0.0, acc / l.clamp_min(1e-30), 0.0)
            m_out[b, h] = m[:, 0]
            l_out[b, h] = l[:, 0]
    return out, m_out, l_out


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
    _check(q, k_pool, v_pool, items, table, pos, block_kv)
    if q.device.type == "cpu":
        return packed_decode_attention_paged(
            q, k_pool, v_pool, items, table, pos, block_kv=block_kv,
            scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged takes CPU or CUDA tensors, got "
                         f"{q.device}")
    if k_pool.dtype not in _DTYPES or dh not in (32, 64) or G > 4:
        raise ValueError(
            f"flash_decode_paged kernel takes bf16/f32 pools, head_dim "
            f"32/64 and G <= 4; got {k_pool.dtype}, {dh}, {G}")
    qc = q.to(k_pool.dtype)
    out = torch.zeros((B, hkv, G, dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, hkv, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, hkv, G), dtype=torch.float32, device=q.device)
    L = items.shape[0]
    if L == 0:
        return out, m, l
    scale_v = float(dh ** -0.5) if scale is None else float(scale)
    fn = kernel_function("flash_decode_paged", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 items.data_ptr(), table.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), m.data_ptr(), l.data_ptr(),
                 L, hkv, G, dh, block_kv, table.shape[1], scale_v,
                 0 if window is None else int(window), _DTYPES[k_pool.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_decode_paged", err)
    flash_decode_paged_kernel.launches += 1
    return out, m, l


flash_decode_paged_kernel.launches = 0


def _check(q, k_pool, v_pool, items, table, pos, block_kv):
    B, hkv, G, dh = q.shape
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4:
        raise ValueError(f"pools must be [N, Hkv, block, D], got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if (k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]) != (
            hkv, block_kv, dh):
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)} at block_kv={block_kv}")
    if items.dim() != 2 or items.shape[1] != DEC_FIELDS:
        raise ValueError(f"items must be [L, {DEC_FIELDS}], got "
                         f"{tuple(items.shape)}")
    if table.dim() != 2 or table.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"table must be [B, T] and pos [B] for B={B}")
    for name, t in (("items", items), ("table", table), ("pos", pos)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("items", items), ("table", table), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
