"""Quantized KV-cache block math: the port of ``repro/core/quant.py``.

The quantized pool stores KV blocks as int8 or fp8 (e4m3) codes with ONE
float32 scale per (block, kv head) tile.  Quantization is symmetric
absmax:

    scale = max(|x|) / qmax          over the [block, Dh] tile
    codes = round(x / scale)         (int8, round half to even)
          | (x / scale) cast to e4m3 (fp8)

Dequantization is linear in the codes, so the attention kernels never
build a dequantized pool: the tile's scale multiplies the q.k logits and
the p.V partial after the dot.

Decode appends one token per tick into a partly filled block, which needs
a requantize in place (:func:`insert_token_requant`): the block's scale
only grows within a sequence, existing codes are rescaled by ``old/new``
(an exact no-op while the scale is unchanged), and the first token of a
block (``offs == 0``) resets it, so a reused block never inherits a freed
sequence's range.

Layout-free math on ``[..., block, Dh]`` tiles, the same arithmetic as the
reference, with one difference at the edge: a value past e4m3's range
saturates at +-448 in torch where JAX gives NaN.  The quantizer never
produces such a value (``|x / scale| <= 448``).
"""
from __future__ import annotations

import torch

# engine-facing names -> storage dtypes; "bf16" is the unquantized default
# (no scales tensor exists, every path is the full-precision one)
KV_DTYPES = {
    "bf16": torch.bfloat16,
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
}
# symmetric range of the code dtype (e4m3fn max finite = 448)
QMAX = {"int8": 127.0, "fp8": 448.0}


def is_quantized(kv_dtype: str) -> bool:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {sorted(KV_DTYPES)}, got {kv_dtype!r}")
    return kv_dtype != "bf16"


def kv_cache_dtype(kv_dtype: str, default=None):
    """Storage dtype of the pool; ``default`` (the model dtype) for bf16."""
    if is_quantized(kv_dtype):
        return KV_DTYPES[kv_dtype]
    return default


def kv_dtype_bytes(kv_dtype: str, *, block: int = 128,
                   head_dim: int = 64) -> float:
    """Bytes per cached element including the amortized per-(block, kv
    head) f32 scale: what the decode packer weighs a streamed block by."""
    if not is_quantized(kv_dtype):
        return float(torch.bfloat16.itemsize)
    return float(KV_DTYPES[kv_dtype].itemsize) + 4.0 / (block * head_dim)


def _encode(x: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """float32 values already divided by their scale -> storage codes."""
    if kv_dtype == "int8":
        return torch.round(x).clamp(-QMAX["int8"],
                                    QMAX["int8"]).to(torch.int8)
    return x.to(torch.float8_e4m3fn)


def quantize_tiles(x: torch.Tensor, kv_dtype: str):
    """Quantize ``[..., block, Dh]`` tiles, one scale per leading index.

    Returns ``(codes [..., block, Dh], scales [...] f32)``.  All-zero
    tiles get scale 1.0 (their codes are zero either way)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=(-2, -1))
    scale = torch.where(amax > 0, amax / QMAX[kv_dtype],
                        torch.ones_like(amax))
    codes = _encode(xf / scale[..., None, None], kv_dtype)
    return codes, scale


def dequantize_tiles(codes: torch.Tensor, scales: torch.Tensor):
    """``[..., block, Dh]`` codes and ``[...]`` scales -> float32 values.
    For tests and yardsticks only: the kernels fold the scale into the
    post-dot rescale instead."""
    return codes.to(torch.float32) * scales[..., None, None]


def insert_token_requant(blk: torch.Tensor, scale: torch.Tensor,
                         tok: torch.Tensor, offs: torch.Tensor,
                         kv_dtype: str):
    """Insert one decode token into a quantized block, rescaling in place.

    ``blk [B, Hkv, block, Dh]`` gathered codes, ``scale [B, Hkv]`` their
    scales, ``tok [B, Hkv, Dh]`` the new token's full-precision K (or V),
    ``offs [B]`` in-block write offsets.  Returns the new ``(codes,
    scales)``: ``offs == 0`` zeroes the block and takes the token's own
    scale; ``offs > 0`` grows the scale to ``max(old, token_absmax/qmax)``
    and rescales the old codes by ``old/new``.
    """
    qmax = QMAX[kv_dtype]
    B, hkv = scale.shape
    tokf = tok.to(torch.float32)
    tmax = tokf.abs().amax(dim=-1)                          # [B, Hkv]
    tok_scale = torch.where(tmax > 0, tmax / qmax, torch.ones_like(tmax))
    fresh = (offs == 0)[:, None]                            # [B, 1]
    new_scale = torch.where(fresh, tok_scale,
                            torch.maximum(scale, tok_scale))
    ratio = scale / new_scale
    vals = blk.to(torch.float32) * ratio[..., None, None]
    vals = torch.where(fresh[..., None, None], torch.zeros_like(vals), vals)
    codes = _encode(vals, kv_dtype)
    tok_codes = _encode(tokf / new_scale[..., None], kv_dtype)
    rows = torch.arange(B, device=blk.device)[:, None]
    heads = torch.arange(hkv, device=blk.device)[None, :]
    at = (rows, heads, offs.long()[:, None])
    code_bits(codes)[at] = code_bits(tok_codes)
    return codes, new_scale


def code_bits(codes: torch.Tensor) -> torch.Tensor:
    """The codes viewed as int8 (no copy): gathers, scatters and ``where``
    move these bits alike for int8 and fp8 codes, on every device."""
    return codes.view(torch.int8)


def quantize_seq_cache(cache: torch.Tensor, block: int, kv_dtype: str):
    """Quantize a contiguous cache ``[L, 2, B, Hkv, Smax, Dh]`` (Smax a
    block multiple) -> ``(codes, scales [L, 2, B, Hkv, Smax // block])``."""
    L, two, B, hkv, smax, dh = cache.shape
    tiles = cache.reshape(L, two, B, hkv, smax // block, block, dh)
    codes, scales = quantize_tiles(tiles, kv_dtype)
    return codes.reshape(cache.shape), scales


def quantize_pool_blocks(blocks: torch.Tensor, kv_dtype: str):
    """Quantize pool-layout blocks ``[..., Hkv, block, Dh]`` -> codes of
    the same shape and scales ``[..., Hkv]``."""
    return quantize_tiles(blocks, kv_dtype)


def roundtrip_error_bound(kv_dtype: str) -> float:
    """Worst-case elementwise ``|dequant(quant(x)) - x| / tile_absmax``:
    half an LSB of the absmax/127 grid for int8, 2^-4 relative for e4m3's
    three mantissa bits."""
    if kv_dtype == "int8":
        return 0.5 / QMAX["int8"]
    return 2.0 ** -4 + 1e-6


__all__ = [
    "KV_DTYPES",
    "QMAX",
    "code_bits",
    "dequantize_tiles",
    "insert_token_requant",
    "is_quantized",
    "kv_cache_dtype",
    "kv_dtype_bytes",
    "quantize_pool_blocks",
    "quantize_seq_cache",
    "quantize_tiles",
    "roundtrip_error_bound",
]
