"""Decoder-only GQA transformer: the serving main path of the reference's
``models/transformer.py`` in PyTorch.

Parameters are plain dicts of tensors in the reference's layout (a list of
per-layer dicts under ``"layers"``), so weights converted from the JAX
pytree (:mod:`repro_torch.weights`) drop in unchanged.  The paged KV pool
is ``[L, 2, N+1, Hkv, block, Dh]``; its last block is the trash block that
absorbs writes of padding rows.  The contiguous slot cache is ``[L, 2, B,
Hkv, Smax, Dh]``, one row per batch slot (the reference's parity baseline).
The layer loop is a Python loop; cache writes are in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.attention.rope import apply_rope
from repro_torch.configs import TransformerConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import common


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """Random weights from a numpy seed, with the reference's shapes and
    init scales (``N(0, 1/in_dim)`` projections, ``N(0, 1/d_model)``
    embeddings, unit norms).  Projections and embeddings are in
    ``cfg.dtype``; norm weights are float32."""
    rng = np.random.default_rng(seed)

    def dense(din, dout):
        w = rng.standard_normal((din, dout), dtype=np.float32)
        w *= np.float32(1.0 / np.sqrt(din))
        return torch.from_numpy(w).to(device=device, dtype=cfg.dtype)

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
    emb = rng.standard_normal((cfg.vocab_size, d), dtype=np.float32)
    emb *= np.float32(1.0 / np.sqrt(d))
    params = {"embed": torch.from_numpy(emb).to(device=device,
                                                dtype=cfg.dtype),
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
        o = kernel_ops.sparse_prefill_contiguous(
            q[0], kc, vc, sparse_items[l], block_q=cfg.block_q,
            block_kv=cfg.block_kv, q_offset=q_offset, kv_len=kv_len)[None]
        x = _block_out(x, o, lp)
    last = C - 1 if last_index is None else last_index
    return _logits(x[:, last:last + 1], params, cfg)[:, 0]


def prefill_chunk_paged(params, pool, tokens, table, q_offset: int,
                        cfg: TransformerConfig, *, kv_len: int | None = None,
                        sparse_items, last_index: int | None = None):
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
    x = params["embed"][tokens]                            # [1, C, d]
    for l, lp in enumerate(params["layers"]):
        h = common.rmsnorm(x, lp["ln1"])
        q, k, v = _qkv(h, lp["attn"], cfg, positions)
        kc, vc = pool[l, 0], pool[l, 1]
        kc[gids] = k[0].reshape(hkv, nblk, block, dh).transpose(0, 1).to(
            kc.dtype)
        vc[gids] = v[0].reshape(hkv, nblk, block, dh).transpose(0, 1).to(
            vc.dtype)
        o = kernel_ops.sparse_prefill(
            q[0], kc, vc, sparse_items[l], table, block_q=cfg.block_q,
            block_kv=block, q_offset=q_offset, kv_len=kv_len)[None]
        x = _block_out(x, o, lp)
    last = C - 1 if last_index is None else last_index
    return _logits(x[:, last:last + 1], params, cfg)[:, 0]


def decode_step(params, cache, token, pos, cfg: TransformerConfig, *,
                packed_items=None, block_ids=None, active=None):
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
    """
    if (packed_items is None) == (block_ids is None):
        raise ValueError("pass exactly one of packed_items and block_ids")
    B = token.shape[0]
    dev = token.device
    act = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
           else active)[:, None, None]
    rows = torch.arange(B, device=dev)[:, None]
    heads = torch.arange(cfg.num_kv_heads, device=dev)[None, :]
    at = pos.long()[:, None]
    rope_pos = pos.view(B, 1, 1)
    x = params["embed"][token][:, None, :]                 # [B, 1, d]
    for l, lp in enumerate(params["layers"]):
        h = common.rmsnorm(x, lp["ln1"])
        q, k, v = _qkv(h, lp["attn"], cfg, rope_pos)
        kc, vc = cache[l, 0], cache[l, 1]                  # [B, Hkv, Smax, Dh]
        for c, new in ((kc, k), (vc, v)):
            c[rows, heads, at] = torch.where(
                act, new[:, :, 0, :].to(c.dtype), c[rows, heads, at])
        if packed_items is not None:
            o = kernel_ops.flash_decode_packed(
                q, kc, vc, packed_items[l], pos, block_kv=cfg.block_kv)
        else:
            o = kernel_ops.flash_decode(
                q, kc, vc, block_ids[l], pos, block_kv=cfg.block_kv)
        x = _block_out(x, o, lp)
    return _logits(x, params, cfg)[:, 0]


def decode_step_paged(params, pool, token, pos, table,
                      cfg: TransformerConfig, *, packed_items=None,
                      block_ids=None, active=None):
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
    x = params["embed"][token][:, None, :]                 # [B, 1, d]
    for l, lp in enumerate(params["layers"]):
        h = common.rmsnorm(x, lp["ln1"])
        q, k, v = _qkv(h, lp["attn"], cfg, rope_pos)
        kc, vc = pool[l, 0], pool[l, 1]
        kc[gids, heads, offs] = k[:, :, 0, :].to(kc.dtype)
        vc[gids, heads, offs] = v[:, :, 0, :].to(vc.dtype)
        if packed_items is not None:
            o = kernel_ops.flash_decode_packed_paged(
                q, kc, vc, packed_items[l], table, pos, block_kv=block)
        else:
            o = kernel_ops.flash_decode_paged(
                q, kc, vc, block_ids[l], table, pos, block_kv=block)
        x = _block_out(x, o, lp)
    return _logits(x, params, cfg)[:, 0]
