"""Decoder-only GQA transformer: the serving main path of the reference's
``models/transformer.py`` in PyTorch.

Parameters are plain dicts of tensors in the reference's layout (a list of
per-layer dicts under ``"layers"``), so weights converted from the JAX
pytree (:mod:`repro_torch.weights`) drop in unchanged.  The paged KV pool
is ``[L, 2, N+1, Hkv, block, Dh]``; its last block is the trash block that
absorbs writes of padding rows.  The contiguous slot cache is ``[L, 2, B,
Hkv, Smax, Dh]``, one row per batch slot (the reference's parity baseline).
The layer loop is a Python loop; cache writes are in place.  An 'L'
layer of ``cfg.attn_pattern`` decodes within its last ``cfg.local_window``
positions; the chunked prefill attends unwindowed on every layer, as the
reference's does.

A quantized cache (``kv_dtype`` int8 or fp8) holds codes in the pool or
slot cache and one float32 scale per (block, kv head) tile beside it:
``[L, 2, N+1, Hkv]`` for the pool, ``[L, 2, B, Hkv, Smax / block]`` for the
slot cache.  The paged chunked prefill quantizes the chunk's blocks as it
scatters them; each decode step requantizes the block its token lands in
(:func:`repro_torch.core.quant.insert_token_requant`); the attention
kernels take the scales beside the codes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.attention.rope import apply_rope
from repro_torch.configs import TransformerConfig
from repro_torch.core import quant
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import common


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: str | torch.device = "cuda",
                host_rng: bool = True) -> dict:
    """Random weights from a seed, with the reference's shapes and init
    scales (``N(0, 1/in_dim)`` projections, ``N(0, 1/d_model)``
    embeddings, unit norms).  Projections and embeddings are in
    ``cfg.dtype``; norm weights are float32.  The normals come from
    numpy's generator (the same values on every device), or, with
    ``host_rng=False``, from a torch generator on ``device`` (no host
    draw: for billions of weights on a GPU; the values are that
    generator's)."""
    if host_rng:
        rng = np.random.default_rng(seed)

        def normal(shape, scale):
            w = rng.standard_normal(shape, dtype=np.float32)
            w *= np.float32(scale)
            return torch.from_numpy(w).to(device=device, dtype=cfg.dtype)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)

        def normal(shape, scale):
            return torch.randn(shape, generator=gen, device=device).mul_(
                scale).to(cfg.dtype)

    def dense(din, dout):
        return normal((din, dout), 1.0 / np.sqrt(din))

    def ones():
        return torch.ones(cfg.d_model, dtype=torch.float32, device=device)

    d, dh = cfg.d_model, cfg.head_dim_
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "attn": {"wq": dense(d, cfg.num_heads * dh),
                     "wk": dense(d, cfg.num_kv_heads * dh),
                     "wv": dense(d, cfg.num_kv_heads * dh),
                     "wo": dense(cfg.num_heads * dh, d)},
            "ln1": ones(), "ln2": ones(),
            "mlp": {"gate": dense(d, cfg.d_ff), "up": dense(d, cfg.d_ff),
                    "down": dense(cfg.d_ff, d)},
        })
    params = {"embed": normal((cfg.vocab_size, d), 1.0 / np.sqrt(d)),
              "layers": layers, "ln_f": ones()}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.vocab_size)
    return params


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda", dtype=None):
    """Contiguous KV cache ``[L, 2, batch, Hkv, max_len, Dh]`` of zeros."""
    return torch.zeros(
        (cfg.num_layers, 2, batch, cfg.num_kv_heads, max_len, cfg.head_dim_),
        dtype=dtype or cfg.dtype, device=device)


def init_paged_cache(cfg: TransformerConfig, num_blocks: int, block: int,
                     device: str | torch.device = "cuda", dtype=None):
    """Paged KV block pool ``[L, 2, num_blocks, Hkv, block, Dh]`` of zeros.
    ``num_blocks`` is the total physical count (callers that want a trash
    block include it)."""
    return torch.zeros(
        (cfg.num_layers, 2, num_blocks, cfg.num_kv_heads, block,
         cfg.head_dim_), dtype=dtype or cfg.dtype, device=device)


def init_paged_scales(cfg: TransformerConfig, num_blocks: int,
                      device: str | torch.device = "cuda"):
    """Scales of a quantized pool: ``[L, 2, num_blocks, Hkv]`` float32
    ones (the scale an all-zero tile gets, so unwritten blocks dequantize
    to their zeros)."""
    return torch.ones((cfg.num_layers, 2, num_blocks, cfg.num_kv_heads),
                      dtype=torch.float32, device=device)


def init_cache_scales(cfg: TransformerConfig, batch: int, max_len: int,
                      block: int, device: str | torch.device = "cuda"):
    """Scales of a quantized slot cache: ``[L, 2, batch, Hkv, max_len /
    block]`` float32 ones; ``max_len`` must be a whole number of blocks."""
    if max_len % block:
        raise ValueError("a quantized slot cache needs max_len % block == 0 "
                         "(one scale per block tile)")
    return torch.ones((cfg.num_layers, 2, batch, cfg.num_kv_heads,
                       max_len // block), dtype=torch.float32, device=device)


def _qkv(x, ap, cfg: TransformerConfig, positions):
    """x [B,S,d] -> q [B,H,S,Dh], k/v [B,Hkv,S,Dh] with RoPE applied."""
    q = common.split_heads(x @ ap["wq"], cfg.num_heads)
    k = common.split_heads(x @ ap["wk"], cfg.num_kv_heads)
    v = common.split_heads(x @ ap["wv"], cfg.num_kv_heads)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block_out(x, o, lp):
    """Attention output projection + residual, then the SwiGLU FFN."""
    x = x + common.merge_heads(o) @ lp["attn"]["wo"]
    h = common.rmsnorm(x, lp["ln2"])
    return x + common.swiglu(h, lp["mlp"]["gate"], lp["mlp"]["up"],
                             lp["mlp"]["down"])


def _logits(x, params, cfg: TransformerConfig):
    x = common.rmsnorm(x, params["ln_f"])
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    return logits.to(torch.float32)


def _window_of(cfg: TransformerConfig, layer: int) -> int | None:
    """The decode kernels' sliding window of ``layer``: the config's
    ``local_window`` on an 'L' layer, none on a 'G' one."""
    return cfg.local_window if cfg.layer_kind(layer) == "L" else None


def prefill_chunk(params, cache, tokens, slot: int, q_offset: int,
                  cfg: TransformerConfig, *, kv_len: int | None = None,
                  sparse_items, last_index: int | None = None):
    """Contiguous partial prefill of one sequence chunk into row ``slot`` of
    ``cache [L, 2, B, Hkv, Smax, Dh]``, in place.

    ``tokens [1, C]`` (the chunk bucket); ``slot`` / ``q_offset`` /
    ``kv_len`` / ``last_index`` are host ints; ``sparse_items [L, P,
    ITEM_FIELDS]`` int32 chunk work lists.  Each layer writes the chunk's
    K/V at rows ``[q_offset, q_offset + C)`` of the slot, then the chunk's
    queries attend the slot row in place (keys ``< kv_len``) with the
    sparse prefill kernel.  Returns logits ``[1, V]`` float32 at
    chunk-local ``last_index`` (default: the last row).
    """
    if sparse_items is None:
        raise NotImplementedError("dense chunked prefill is not ported yet")
    _, C = tokens.shape
    if q_offset + C > cache.shape[4]:
        raise ValueError("chunk overruns the slot cache")
    kv_len = q_offset + C if kv_len is None else kv_len
    positions = q_offset + torch.arange(C, device=tokens.device)
    rows = slice(q_offset, q_offset + C)
    x = params["embed"][tokens]                            # [1, C, d]
    for l, lp in enumerate(params["layers"]):
        h = common.rmsnorm(x, lp["ln1"])
        q, k, v = _qkv(h, lp["attn"], cfg, positions)
        kc, vc = cache[l, 0, slot], cache[l, 1, slot]      # [Hkv, Smax, Dh]
        kc[:, rows] = k[0].to(kc.dtype)
        vc[:, rows] = v[0].to(vc.dtype)
        # no window here: the reference's chunked prefill attends its work
        # list unwindowed on every layer (only its decode applies
        # local_window), and the port keeps its tokens
        o = kernel_ops.sparse_prefill_contiguous(
            q[0], kc, vc, sparse_items[l], block_q=cfg.block_q,
            block_kv=cfg.block_kv, q_offset=q_offset, kv_len=kv_len)[None]
        x = _block_out(x, o, lp)
    last = C - 1 if last_index is None else last_index
    return _logits(x[:, last:last + 1], params, cfg)[:, 0]


def prefill_chunk_paged(params, pool, tokens, table, q_offset: int,
                        cfg: TransformerConfig, *, kv_len: int | None = None,
                        sparse_items, last_index: int | None = None,
                        scales=None, kv_dtype: str = "bf16"):
    """Paged partial prefill of one sequence chunk; writes ``pool`` in
    place.

    ``tokens [1, C]`` with C a whole number of cache blocks (the chunk
    bucket); ``table [T]`` int32 logical -> pool block of this sequence (-1
    pad: bucket-padding blocks past the prompt scatter into the trash
    block); ``q_offset`` / ``kv_len`` / ``last_index`` are host ints;
    ``sparse_items [L, P, ITEM_FIELDS]`` int32 chunk work lists.  Each
    layer scatters the chunk's K/V into its pool blocks in place
    (``index_put_``), then the chunk's queries attend the resident prefix
    through the table with the sparse prefill kernel.  Returns logits
    ``[1, V]`` float32 at chunk-local ``last_index`` (default: the last
    row).

    Quantized pool: pass ``scales [L, 2, N+1, Hkv]`` float32 and the
    ``kv_dtype``.  The chunk's blocks are quantized as they scatter, their
    scales scatter through the same block ids, and the kernel takes the
    scales beside the codes.  Returns ``(logits, pool, scales)`` then
    (both written in place).
    """
    if sparse_items is None:
        raise NotImplementedError("dense chunked prefill is not ported yet")
    _, C = tokens.shape
    block = pool.shape[4]
    trash = pool.shape[2] - 1
    hkv, dh = cfg.num_kv_heads, cfg.head_dim_
    if C % block or q_offset % block:
        raise ValueError("chunk bucket and offset must be whole cache blocks")
    nblk, ob = C // block, q_offset // block
    if ob + nblk > table.shape[0]:
        raise ValueError("chunk overruns the sequence's block table")
    kv_len = q_offset + C if kv_len is None else kv_len
    positions = q_offset + torch.arange(C, device=tokens.device)
    gsl = table[ob:ob + nblk]
    gids = torch.where(gsl >= 0, gsl, trash).long()
    qz = scales is not None
    ks = vs = None
    x = params["embed"][tokens]                            # [1, C, d]
    for l, lp in enumerate(params["layers"]):
        h = common.rmsnorm(x, lp["ln1"])
        q, k, v = _qkv(h, lp["attn"], cfg, positions)
        kc, vc = pool[l, 0], pool[l, 1]
        k_blocks = k[0].reshape(hkv, nblk, block, dh).transpose(0, 1)
        v_blocks = v[0].reshape(hkv, nblk, block, dh).transpose(0, 1)
        if qz:
            ks, vs = scales[l, 0], scales[l, 1]
            for c, sc, new in ((kc, ks, k_blocks), (vc, vs, v_blocks)):
                codes, sc_new = quant.quantize_pool_blocks(new, kv_dtype)
                quant.code_bits(c)[gids] = quant.code_bits(codes)
                sc[gids] = sc_new
        else:
            kc[gids] = k_blocks.to(kc.dtype)
            vc[gids] = v_blocks.to(vc.dtype)
        # unwindowed on every layer, as the reference's paged chunked
        # prefill (see prefill_chunk)
        o = kernel_ops.sparse_prefill(
            q[0], kc, vc, sparse_items[l], table, block_q=cfg.block_q,
            block_kv=block, q_offset=q_offset, kv_len=kv_len, k_scales=ks,
            v_scales=vs)[None]
        x = _block_out(x, o, lp)
    last = C - 1 if last_index is None else last_index
    logits = _logits(x[:, last:last + 1], params, cfg)[:, 0]
    return (logits, pool, scales) if qz else logits


def decode_step(params, cache, token, pos, cfg: TransformerConfig, *,
                packed_items=None, block_ids=None, active=None,
                scales=None, kv_dtype: str = "bf16"):
    """One contiguous decode step over all rows; writes ``cache [L, 2, B,
    Hkv, Smax, Dh]`` in place.

    ``token [B]`` int; ``pos [B]`` int32 (the position each row writes);
    ``packed_items [L, Lb, DEC_FIELDS]`` int32 cost-packed decode work lists
    or, instead, ``block_ids [L, B, Hkv, nb]`` int32 per-slot selections
    (-1 pad), run as the padded item table; ``active
    [B]`` bool.  Active rows write their new K/V token at ``pos``; inactive
    rows write their current row back, so their cache rows keep their
    values (the contiguous layout has no trash block).  Returns logits
    ``[B, V]`` float32.

    Quantized cache: pass ``scales [L, 2, B, Hkv, Smax / block_kv]``
    float32 and the ``kv_dtype``.  Each row's token write becomes a gather
    of its current block tile and scale, :func:`quant.insert_token_requant`
    and a scatter back; inactive rows keep their tile and scale (a
    ``where``).  Returns ``(logits, cache, scales)`` then (both written in
    place).
    """
    if (packed_items is None) == (block_ids is None):
        raise ValueError("pass exactly one of packed_items and block_ids")
    B = token.shape[0]
    dev = token.device
    qz = scales is not None
    blk = cfg.block_kv
    if qz and cache.shape[4] % blk:
        raise ValueError("a quantized slot cache needs Smax % block_kv == 0")
    act = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
           else active)[:, None, None]
    rows = torch.arange(B, device=dev)[:, None]
    heads = torch.arange(cfg.num_kv_heads, device=dev)[None, :]
    at = pos.long()[:, None]
    if qz:   # each row's current block and the token's offset in it
        row, blk_i, offs = rows[:, 0], (pos // blk).long(), (pos % blk).long()
    rope_pos = pos.view(B, 1, 1)
    ks = vs = None
    x = params["embed"][token][:, None, :]                 # [B, 1, d]
    for l, lp in enumerate(params["layers"]):
        h = common.rmsnorm(x, lp["ln1"])
        q, k, v = _qkv(h, lp["attn"], cfg, rope_pos)
        kc, vc = cache[l, 0], cache[l, 1]                  # [B, Hkv, Smax, Dh]
        if qz:
            ks, vs = scales[l, 0], scales[l, 1]            # [B, Hkv, nb]
            for c, sc, new in ((kc, ks, k), (vc, vs, v)):
                # the row's current block tile [B, Hkv, blk, Dh] and scale
                bits = quant.code_bits(c).view(B, c.shape[1], -1, blk,
                                               c.shape[3])
                cur = bits[row, :, blk_i]
                cur_s = sc[row, :, blk_i]
                codes, sc_new = quant.insert_token_requant(
                    cur.view(c.dtype), cur_s, new[:, :, 0, :], offs,
                    kv_dtype)
                bits[row, :, blk_i] = torch.where(
                    act[..., None], quant.code_bits(codes), cur)
                sc[row, :, blk_i] = torch.where(act[:, :, 0], sc_new, cur_s)
        else:
            for c, new in ((kc, k), (vc, v)):
                c[rows, heads, at] = torch.where(
                    act, new[:, :, 0, :].to(c.dtype), c[rows, heads, at])
        if packed_items is not None:
            o = kernel_ops.flash_decode_packed(
                q, kc, vc, packed_items[l], pos, block_kv=blk,
                window=_window_of(cfg, l), k_scales=ks, v_scales=vs)
        else:
            o = kernel_ops.flash_decode(
                q, kc, vc, block_ids[l], pos, block_kv=blk,
                window=_window_of(cfg, l), k_scales=ks, v_scales=vs)
        x = _block_out(x, o, lp)
    logits = _logits(x, params, cfg)[:, 0]
    return (logits, cache, scales) if qz else logits


def decode_step_paged(params, pool, token, pos, table,
                      cfg: TransformerConfig, *, packed_items=None,
                      block_ids=None, active=None, scales=None,
                      kv_dtype: str = "bf16"):
    """One paged decode step over all rows; writes ``pool`` in place.

    ``token [B]`` int; ``pos [B]`` int32 (the position each row writes);
    ``table [B, T]`` int32 per-row block tables (-1 = unmapped);
    ``packed_items [L, Lb, DEC_FIELDS]`` int32 cost-packed decode work
    lists (LOGICAL kv blocks) or, instead, ``block_ids [L, B, Hkv, nb]``
    int32 LOGICAL per-slot selections (-1 pad), run as the padded item
    table; ``active [B]`` bool.  Each row's new K/V
    token is written in place (``index_put_``) into its current block,
    ``(table[b, pos // block], pos % block)``; inactive or unmapped rows
    write the trash block.  Returns logits ``[B, V]`` float32.

    Quantized pool: pass ``scales [L, 2, N+1, Hkv]`` float32 and the
    ``kv_dtype``.  The token write becomes a gather of the row's block tile
    and scale, :func:`quant.insert_token_requant` and a full-tile scatter
    back (inactive rows still land in the trash block, whose codes and
    scale are junk), and the kernels take the scales at the physical
    block.  Returns ``(logits, pool, scales)`` then (both written in
    place).
    """
    if (packed_items is None) == (block_ids is None):
        raise ValueError("pass exactly one of packed_items and block_ids")
    B = token.shape[0]
    block = pool.shape[4]
    trash = pool.shape[2] - 1
    dev = token.device
    act = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
           else active)
    phys = table.gather(1, (pos // block).long()[:, None])[:, 0]
    gids = torch.where(act & (phys >= 0), phys, trash).long()[:, None]
    offs = (pos % block).long()[:, None]
    heads = torch.arange(cfg.num_kv_heads, device=dev)[None, :]
    rope_pos = pos.view(B, 1, 1)
    qz = scales is not None
    ks = vs = None
    x = params["embed"][token][:, None, :]                 # [B, 1, d]
    for l, lp in enumerate(params["layers"]):
        h = common.rmsnorm(x, lp["ln1"])
        q, k, v = _qkv(h, lp["attn"], cfg, rope_pos)
        kc, vc = pool[l, 0], pool[l, 1]
        if qz:
            ks, vs = scales[l, 0], scales[l, 1]
            for c, sc, new in ((kc, ks, k), (vc, vs, v)):
                bits = quant.code_bits(c)
                codes, sc_new = quant.insert_token_requant(
                    bits[gids[:, 0]].view(c.dtype), sc[gids[:, 0]],
                    new[:, :, 0, :], offs[:, 0], kv_dtype)
                bits[gids[:, 0]] = quant.code_bits(codes)
                sc[gids[:, 0]] = sc_new
        else:
            kc[gids, heads, offs] = k[:, :, 0, :].to(kc.dtype)
            vc[gids, heads, offs] = v[:, :, 0, :].to(vc.dtype)
        if packed_items is not None:
            o = kernel_ops.flash_decode_packed_paged(
                q, kc, vc, packed_items[l], table, pos, block_kv=block,
                window=_window_of(cfg, l), k_scales=ks, v_scales=vs)
        else:
            o = kernel_ops.flash_decode_paged(
                q, kc, vc, block_ids[l], table, pos, block_kv=block,
                window=_window_of(cfg, l), k_scales=ks, v_scales=vs)
        x = _block_out(x, o, lp)
    logits = _logits(x, params, cfg)[:, 0]
    return (logits, pool, scales) if qz else logits
