"""Legacy work-list budgeted decode: the host work-list construction, the
CUDA kernel's wrapper and its plain PyTorch version.

:func:`sparse_decode_attention` is the port of the TPU kernel
``repro/kernels/sparse_decode.py::sparse_decode_attention``, reached
through the library entry ``ops.sparse_decode``: it launches
``csrc/sparse_decode.cu`` (the decode body of ``csrc/flash_decode.cuh``
with the legacy run rules) on CUDA tensors and runs
:func:`sparse_decode_reference` on CPU tensors.  q ``[B, Hkv, G, D]``,
caches ``[B, Hkv, Smax, D]`` (whole ``block_kv`` blocks), items ``[L,
DEC_FIELDS]`` from :func:`build_decode_worklist`; keys at ``kpos <
cache_len`` count (one static length for every row, no window).  A run
starts on ``valid & first`` and writes its tile on ``valid & last``; the
output is in q's dtype, zero for (row, head) pairs no run covers.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.core.worklist import (
    D_BATCH, D_FIRST, D_KVBLK, D_KVHEAD, D_LAST, D_VALID, DEC_FIELDS)
from repro_torch.kernels.build import check_launch, kernel_function
from repro_torch.kernels.flash_decode import (
    DTYPES, check_cuda_decode, check_decode_args, decode_scan, slot_tiles)

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


@dataclasses.dataclass
class DecodeWorkList:
    items: np.ndarray        # [D, L_pad, DEC_FIELDS] int32
    lengths: np.ndarray
    block: int

    @property
    def padded_length(self) -> int:
        return self.items.shape[-2]

    @property
    def padded_total(self) -> int:
        d = self.items.shape[0] if self.items.ndim == 3 else 1
        return self.padded_length * d

    @property
    def padding_waste(self) -> float:
        """Fraction of grid steps that are padding."""
        tot = self.padded_total
        return 1.0 - int(self.lengths.sum()) / tot if tot else 0.0

    @property
    def imbalance(self) -> float:
        mean = float(self.lengths.mean())
        return float(self.lengths.max() / mean) if mean > 0 else 1.0


def build_decode_worklist(selections, *, num_devices: int,
                          kv_heads_per_device: int, block: int,
                          pad_multiple: int = 8) -> DecodeWorkList:
    """``selections[b][kv_head_global] -> kv block ids`` for each sequence.
    Device ``d`` owns global kv heads ``[d*kv_heads_per_device,
    (d+1)*kv_heads_per_device)``; each device's list is padded to a
    multiple of ``pad_multiple`` by repeating its last item with first,
    last and valid cleared."""
    per_dev: list[list[np.ndarray]] = [[] for _ in range(num_devices)]
    for b, sels in enumerate(selections):
        for kv_g, sel in enumerate(sels):
            sel = np.sort(np.asarray(sel, dtype=np.int64))
            if len(sel) == 0:
                continue
            it = np.zeros((len(sel), DEC_FIELDS), dtype=np.int32)
            it[:, D_BATCH] = b
            it[:, D_KVHEAD] = kv_g % kv_heads_per_device
            it[:, D_KVBLK] = sel
            it[0, D_FIRST] = 1
            it[-1, D_LAST] = 1
            it[:, D_VALID] = 1
            per_dev[kv_g // kv_heads_per_device].append(it)
    dev_items = [np.concatenate(g, axis=0) if g
                 else np.zeros((0, DEC_FIELDS), np.int32) for g in per_dev]
    lengths = np.array([len(x) for x in dev_items], dtype=np.int64)
    L_pad = int(lengths.max()) if len(lengths) else 0
    L_pad = max(pad_multiple, -(-L_pad // pad_multiple) * pad_multiple)
    items = np.zeros((num_devices, L_pad, DEC_FIELDS), dtype=np.int32)
    for d, x in enumerate(dev_items):
        items[d, :len(x)] = x
        if len(x):
            pad_row = x[-1].copy()
            pad_row[[D_FIRST, D_LAST, D_VALID]] = 0
            items[d, len(x):] = pad_row
    return DecodeWorkList(items=items, lengths=lengths, block=block)


def sparse_decode_reference(q, k_cache, v_cache, items, *, cache_len: int,
                            block_kv: int = 128, scale: float | None = None):
    """Plain PyTorch version: the TPU kernel's item scan in float32 (q
    taken in its own precision), with the legacy run rules."""
    dh = q.shape[-1]
    out, _, _ = decode_scan(
        q.to(torch.float32), slot_tiles(k_cache, v_cache, block_kv), items,
        [int(cache_len) - 1] * q.shape[0], block_kv=block_kv,
        scale=float(dh ** -0.5) if scale is None else float(scale),
        legacy=True)
    return out.to(q.dtype)


def sparse_decode_attention(q, k_cache, v_cache, items, *, cache_len: int,
                            block_kv: int = 128, scale: float | None = None):
    """Legacy budgeted decode (see module docstring).

    CPU tensors run :func:`sparse_decode_reference`.  CUDA tensors launch
    the CUDA kernel (q and caches of one dtype, bf16 or f32; head_dim
    32/64; G <= 4) or raise; there is no fallback.  ``launches`` counts
    kernel launches.
    """
    B, hkv, G, dh = q.shape
    check_decode_args(q, k_cache, v_cache, items, block_kv)
    if (k_cache.shape[0], k_cache.shape[1], k_cache.shape[3]) != (B, hkv, dh):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not 0 < cache_len <= k_cache.shape[2]:
        raise ValueError(f"cache_len {cache_len} outside (0, "
                         f"{k_cache.shape[2]}]")
    if q.device.type == "cpu":
        return sparse_decode_reference(q, k_cache, v_cache, items,
                                       cache_len=cache_len,
                                       block_kv=block_kv, scale=scale)
    check_cuda_decode("sparse_decode", q, k_cache)
    if q.dtype != k_cache.dtype:
        raise ValueError(f"sparse_decode kernel takes q and caches of one "
                         f"dtype; got {q.dtype}/{k_cache.dtype}")
    out = torch.zeros_like(q)
    if items.shape[0] == 0:
        return out
    last_pos = torch.full((B,), int(cache_len) - 1, dtype=torch.int32,
                          device=q.device)
    fn = kernel_function("sparse_decode", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 items.data_ptr(), last_pos.data_ptr(), out.data_ptr(),
                 items.shape[0], hkv, G, dh, block_kv, k_cache.shape[2],
                 float(dh ** -0.5) if scale is None else float(scale),
                 DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("sparse_decode", err)
    sparse_decode_attention.launches += 1
    return out


sparse_decode_attention.launches = 0
