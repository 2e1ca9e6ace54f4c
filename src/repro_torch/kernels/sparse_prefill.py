"""Paged work-list block-sparse prefill attention: the CUDA kernel's
wrapper and its plain PyTorch version.

:func:`sparse_prefill_paged` is the port of the TPU kernel
``repro/kernels/sparse_prefill.py::sparse_prefill_attention`` joined with
its paged twin on the serving main path,
``attention/worklist_jnp.py::worklist_attention_paged``: it launches
``csrc/sparse_prefill_paged.cu`` on CUDA tensors and runs
:func:`worklist_attention_paged` (the port of the jnp twin) on CPU tensors.
:func:`sparse_prefill_attention` is the same kernel over contiguous K/V and
an identity block table.

Layouts are the reference's: q ``[H, Sq, D]``, pools ``[N, Hkv, block_kv,
D]``, items ``[L, ITEM_FIELDS]`` with chunk-local q blocks and LOGICAL kv
blocks, table ``[T]`` (-1 = unmapped).  Queries sit at positions
``q_offset + i`` and attend keys ``< kv_len``.  Output ``[H, Sq, D]`` in
q's dtype; rows of (head, q_blk) pairs no item covers are zero.
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


def worklist_attention_paged(q, k_pool, v_pool, items, table, *,
                             block_q: int = 128, block_kv: int = 128,
                             scale: float | None = None, q_offset: int = 0,
                             kv_len: int | None = None):
    """Plain PyTorch version: the reference's item scan in float32, one item
    at a time.  A run initializes on ``first`` and writes its tile on a
    valid ``last``; unmapped table entries are masked."""
    hq, sq, dh = q.shape
    dev = q.device
    scale_v = float(dh ** -0.5) if scale is None else float(scale)
    qp = F.pad(q, (0, 0, 0, (-sq) % block_q)).to(torch.float32)
    T = table.shape[0]
    klim = T * block_kv if kv_len is None else min(int(kv_len), T * block_kv)
    tbl = table.tolist()
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
        phys = tbl[min(max(kvblk, 0), T - 1)]
        safe = max(phys, 0)
        rows = slice(qblk * block_q, (qblk + 1) * block_q)
        kt = k_pool[safe, it[F_KVHEAD]].to(torch.float32)
        vt = v_pool[safe, it[F_KVHEAD]].to(torch.float32)
        s = (qp[head, rows] @ kt.T) * scale_v
        qpos = qblk * block_q + qi
        kpos = kvblk * block_kv + ki
        mask = ((kpos <= qpos + q_offset) & (kpos < klim) & (qpos < sq)
                & (phys >= 0))
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
    _check(q, k_pool, v_pool, items, table, block_kv)
    if q.device.type == "cpu":
        return worklist_attention_paged(
            q, k_pool, v_pool, items, table, block_q=block_q,
            block_kv=block_kv, scale=scale, q_offset=q_offset, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"sparse_prefill_paged takes CPU or CUDA tensors, "
                         f"got {q.device}")
    if (q.dtype != k_pool.dtype or q.dtype not in _DTYPES
            or dh not in (32, 64) or not 0 < block_q <= 1024):
        raise ValueError(
            f"sparse_prefill_paged kernel takes q and pools of one dtype "
            f"(bf16/f32), head_dim 32/64 and block_q <= 1024; got "
            f"{q.dtype}/{k_pool.dtype}, {dh}, {block_q}")
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
                             scale: float | None = None):
    """Contiguous form (the TPU kernel's own signature): q ``[H, Sq, D]``,
    k/v ``[Hkv, Skv, D]``.  Runs :func:`sparse_prefill_paged` over the K/V
    re-blocked into a pool ``[nb, Hkv, block_kv, D]`` (a copy) with an
    identity table and ``kv_len = Skv``."""
    hkv, skv, dh = k.shape
    nb = -(-skv // block_kv)

    def as_pool(t):
        t = F.pad(t, (0, 0, 0, nb * block_kv - skv))
        return t.reshape(hkv, nb, block_kv, dh).transpose(0, 1).contiguous()

    table = torch.arange(nb, dtype=torch.int32, device=q.device)
    return sparse_prefill_paged(q, as_pool(k), as_pool(v), items, table,
                                block_q=block_q, block_kv=block_kv,
                                scale=scale, q_offset=0, kv_len=skv)


def _check(q, k_pool, v_pool, items, table, block_kv):
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"q must be [H, Sq, D] and pools [N, Hkv, block, D]"
                         f"; got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    if k_pool.shape[2] != block_kv or k_pool.shape[3] != q.shape[2]:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)} at block_kv={block_kv}")
    if items.dim() != 2 or items.shape[1] != ITEM_FIELDS:
        raise ValueError(f"items must be [L, {ITEM_FIELDS}], got "
                         f"{tuple(items.shape)}")
    if table.dim() != 1 or table.shape[0] < 1:
        raise ValueError(f"table must be [T] with T >= 1, got "
                         f"{tuple(table.shape)}")
    for name, t in (("items", items), ("table", table)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("items", items), ("table", table)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
