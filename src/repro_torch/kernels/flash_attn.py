"""Dense flash attention: the CUDA kernel's wrapper and its plain PyTorch
version.

:func:`flash_attention` is the port of the TPU kernel
``repro/kernels/flash_attn.py::flash_attention`` (the paper's dense
baseline), reached through the library entry ``ops.flash_attention``: it
launches ``csrc/flash_attention.cu`` on CUDA tensors and runs
:func:`flash_attention_reference` on CPU tensors.  q ``[H, Sq, D]``, k/v
``[Hkv, Skv, D]``, query head h reading kv head ``h // (H // Hkv)``; ragged
Sq / Skv; queries at positions ``0..Sq-1``, so with ``causal`` and Sq != Skv
the mask is ``kpos <= qpos`` from position 0.  Output in q's dtype.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import check_launch, kernel_function

NEG_INF = -1e30
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              block_q: int = 128, block_kv: int = 128,
                              scale: float | None = None):
    """Plain PyTorch version: the TPU kernel's online softmax in float32,
    one kv tile at a time for every (head, q block) together.  Tiles the
    TPU kernel skips above the causal diagonal run fully masked here, which
    leaves the running state exactly as it was."""
    hq, sq, dh = q.shape
    hkv, skv, _ = k.shape
    scale_v = float(dh ** -0.5) if scale is None else float(scale)
    nq = -(-sq // block_q)
    nkv = -(-skv // block_kv)
    qp = F.pad(q, (0, 0, 0, nq * block_q - sq)).to(torch.float32)
    qp = qp.reshape(hq, nq, block_q, dh)

    def heads(t):       # [Hkv, Skv, D] -> [H, Skv_pad, D] in float32
        t = F.pad(t, (0, 0, 0, nkv * block_kv - skv)).to(torch.float32)
        return t.repeat_interleave(hq // hkv, dim=0)
    kp, vp = heads(k), heads(v)
    dev = q.device
    acc = torch.zeros((hq, nq, block_q, dh), dtype=torch.float32, device=dev)
    m = torch.full((hq, nq, block_q, 1), -torch.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((hq, nq, block_q, 1), dtype=torch.float32, device=dev)
    qpos = torch.arange(nq * block_q, device=dev).reshape(nq, block_q, 1)
    for kb in range(nkv):
        sl = slice(kb * block_kv, (kb + 1) * block_kv)
        s = torch.einsum("hnqd,hkd->hnqk", qp, kp[:, sl]) * scale_v
        kpos = kb * block_kv + torch.arange(block_kv, device=dev)
        mask = kpos < skv
        if causal:
            mask = mask & (kpos <= qpos)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("hnqk,hkd->hnqd", p, vp[:, sl])
        m = m_new
    out = (acc / l.clamp_min(1e-30)).reshape(hq, nq * block_q, dh)
    return out[:, :sq].to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_kv: int = 128, scale: float | None = None):
    """Dense flash attention (see module docstring).

    CPU tensors run :func:`flash_attention_reference`.  CUDA tensors launch
    the CUDA kernel (q, k, v of one dtype, bf16 or f32; head_dim 32/64;
    block_q <= 1024) or raise; there is no fallback.  ``launches`` counts
    kernel launches.
    """
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q must be [H, Sq, D] and k/v [Hkv, Skv, D] of one "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    hq, sq, dh = q.shape
    hkv, skv, _ = k.shape
    if k.shape[2] != dh or hq % hkv or sq < 1 or skv < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} need "
                         f"one head_dim, H % Hkv == 0 and non-empty lengths")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         block_q=block_q, block_kv=block_kv,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got "
                         f"{q.device}")
    if (q.dtype != k.dtype or k.dtype != v.dtype or q.dtype not in _DTYPES
            or dh not in (32, 64) or not 0 < block_q <= 1024):
        raise ValueError(
            f"flash_attention kernel takes q, k, v of one dtype (bf16/f32), "
            f"head_dim 32/64 and block_q <= 1024; got {q.dtype}/{k.dtype}/"
            f"{v.dtype}, {dh}, {block_q}")
    out = torch.empty_like(q)
    scale_v = float(dh ** -0.5) if scale is None else float(scale)
    fn = kernel_function("flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 hq, hkv, sq, skv, dh, block_q, block_kv, int(bool(causal)),
                 scale_v, _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
