"""Decoder-only GQA transformer: the serving main path of the reference's
``models/transformer.py`` in PyTorch.

Parameters are plain dicts of tensors in the reference's layout (a list of
per-layer dicts under ``"layers"``), so weights converted from the JAX
pytree (:mod:`repro_torch.weights`) drop in unchanged.  The paged KV pool
is ``[L, 2, N+1, Hkv, block, Dh]``; its last block is the trash block that
absorbs writes of padding rows.  The contiguous slot cache is ``[L, 2, B,
Hkv, Smax, Dh]``, one row per batch slot (the reference's parity baseline).
The layer loop is a Python loop; cache writes are in place.  The FFN is
SwiGLU, or with ``cfg.moe`` the MoE FFN (:mod:`repro_torch.models.moe`),
which routes every row of a call together: all slots of a decode step, the
whole chunk bucket of a chunk, the whole prompt bucket of a monolithic
prefill (see :func:`_prefill_out`).  An 'L' layer of ``cfg.attn_pattern``
decodes, and prefills densely, within its last ``cfg.local_window``
positions; the sparse prefill attends unwindowed on every layer, as the
reference's does.

Attention is S-HPLB sparse (work lists) or dense, the reference's baseline.
Dense chunks run the sparse prefill kernel over a dense causal work list
(:func:`dense_chunk_items`), the monolithic :func:`prefill` runs the dense
flash attention kernel over the prompt, and dense decode runs the decode
kernels over every resident block (:func:`dense_decode_items`).  On
'L' layers both dense prefills pass the window to their kernels (the
window forms of the sparse prefill and flash attention kernels), as the
reference masks its dense chunks and windows its flash scan there.

A quantized cache (``kv_dtype`` int8 or fp8) holds codes in the pool or
slot cache and one float32 scale per (block, kv head) tile beside it:
``[L, 2, N+1, Hkv]`` for the pool, ``[L, 2, B, Hkv, Smax / block]`` for the
slot cache.  The paged chunked prefill quantizes the chunk's blocks as it
scatters them; each decode step requantizes the block its token lands in
(:func:`repro_torch.core.quant.insert_token_requant`); the attention
kernels take the scales beside the codes.

Sequence stripes (§2.11): the paged decode step can run one partial pass of
the paged decode kernel per seq stripe of the pool, each over only the
blocks that stripe holds (its packed list, or a table masked to its
blocks), and merge the ``(out, m, l)`` partials with the flash-decoding
combine (:func:`_merge_stripe_partials`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.attention.dense import attention_maps
from repro_torch.attention.rope import apply_rope
from repro_torch.configs import TransformerConfig
from repro_torch.core import quant
from repro_torch.core.worklist import (
    F_FIRST, F_HEAD, F_KVBLK, F_KVHEAD, F_LAST, F_QBLK, F_VALID, ITEM_FIELDS,
    padded_decode_items)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.flash_decode import merge_partials
from repro_torch.models import common
from repro_torch.models.moe import moe_ffn


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: str | torch.device = "cuda",
                host_rng: bool = True) -> dict:
    """Random weights from a seed, with the reference's shapes and init
    scales (``N(0, 1/in_dim)`` projections, experts and router,
    ``N(0, 1/d_model)`` embeddings, unit norms).  Projections, experts and
    embeddings are in ``cfg.dtype``; norm weights and a MoE layer's router
    are float32.  The normals come from numpy's generator (the same values
    on every device), or, with ``host_rng=False``, from a torch generator
    on ``device`` (no host draw: for billions of weights on a GPU; the
    values are that generator's)."""
    if host_rng:
        rng = np.random.default_rng(seed)

        def normal(shape, scale, dtype=cfg.dtype):
            w = rng.standard_normal(shape, dtype=np.float32)
            w *= np.float32(scale)
            return torch.from_numpy(w).to(device=device, dtype=dtype)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)

        def normal(shape, scale, dtype=cfg.dtype):
            return torch.randn(shape, generator=gen, device=device).mul_(
                scale).to(dtype)

    def dense(din, dout):
        return normal((din, dout), 1.0 / np.sqrt(din))

    def ones():
        return torch.ones(cfg.d_model, dtype=torch.float32, device=device)

    d, dh, f = cfg.d_model, cfg.head_dim_, cfg.d_ff
    layers = []
    for _ in range(cfg.num_layers):
        lp = {"attn": {"wq": dense(d, cfg.num_heads * dh),
                       "wk": dense(d, cfg.num_kv_heads * dh),
                       "wv": dense(d, cfg.num_kv_heads * dh),
                       "wo": dense(cfg.num_heads * dh, d)},
              "ln1": ones(), "ln2": ones()}
        if cfg.moe is not None:
            E = cfg.moe.num_experts
            lp["moe"] = {"router": normal((d, E), 1.0 / np.sqrt(d),
                                          torch.float32),
                         "gate": normal((E, d, f), 1.0 / np.sqrt(d)),
                         "up": normal((E, d, f), 1.0 / np.sqrt(d)),
                         "down": normal((E, f, d), 1.0 / np.sqrt(f))}
        else:
            lp["mlp"] = {"gate": dense(d, f), "up": dense(d, f),
                         "down": dense(f, d)}
        layers.append(lp)
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
    """x [B,S,d] -> q [B,H,S,Dh], k/v [B,Hkv,S,Dh] with RoPE applied (the
    head counts are those the weights hold: a tensor-parallel rank's own
    heads)."""
    dh = cfg.head_dim_
    q = common.split_heads(x @ ap["wq"], ap["wq"].shape[1] // dh)
    k = common.split_heads(x @ ap["wk"], ap["wk"].shape[1] // dh)
    v = common.split_heads(x @ ap["wv"], ap["wv"].shape[1] // dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_residual(x, o, lp, cfg: TransformerConfig, mesh=None):
    """Attention output projection + residual, and the FFN's pre-norm."""
    x = x + _tp_sum(common.merge_heads(o) @ lp["attn"]["wo"],
                    _attn_sharded(lp, cfg), mesh)
    return x, common.rmsnorm(x, lp["ln2"])


def _ffn(h, lp, cfg: TransformerConfig):
    """The FFN of normed rows ``h [B, S, d]``: SwiGLU, or the MoE FFN,
    which routes all ``B * S`` rows together."""
    if cfg.moe is not None:
        return moe_ffn(h, lp["moe"], cfg.moe)
    mlp = lp["mlp"]
    return common.swiglu(h, mlp["gate"], mlp["up"], mlp["down"])


def _block_out(x, o, lp, cfg: TransformerConfig, mesh=None):
    """Attention output projection + residual, then the FFN."""
    x, h = _attn_residual(x, o, lp, cfg, mesh)
    return x + _tp_sum(_ffn(h, lp, cfg), _ffn_sharded(lp, cfg), mesh)


# -- the tensor-parallel form: a rank of a mesh holds its block of each
# weight (repro_torch.sharding.specs.shard_params), and what a weight holds
# is read from its shape.  Row-sharded products (wo, down) are summed over
# `model`, the embedding is vocab-parallel and the logits are gathered.
# Without a mesh every weight is whole and these are identities.

def _attn_sharded(lp, cfg: TransformerConfig) -> bool:
    return lp["attn"]["wo"].shape[0] < cfg.num_heads * cfg.head_dim_


def _ffn_sharded(lp, cfg: TransformerConfig) -> bool:
    return "mlp" in lp and lp["mlp"]["down"].shape[0] < cfg.d_ff


def _tp_sum(y, sharded: bool, mesh):
    """A row-sharded product's partial ``y``, summed over ``model``."""
    return mesh.all_reduce(y, "model") if sharded else y


def _embed(params, tokens, cfg: TransformerConfig, mesh=None):
    """Token embeddings.  A vocab-parallel table (this rank's rows) looks up
    the tokens it holds, zeros elsewhere, and sums over ``model``: one
    rank adds the row, every other an exact zero."""
    emb = params["embed"]
    n = emb.shape[0]
    if n == cfg.vocab_size:
        return emb[tokens]
    local = tokens - mesh.axis_index("model") * n
    held = ((local >= 0) & (local < n)).to(emb.dtype)
    return mesh.all_reduce(emb[local.clamp(0, n - 1)] * held[..., None],
                           "model")


def _tiles(n: int, tile: int) -> list[slice]:
    """Row slices of ``tile`` rows covering ``n`` (the last may be
    short)."""
    return [slice(i, min(i + tile, n)) for i in range(0, n, tile)]


def _prefill_qkv(x, lp, cfg: TransformerConfig, positions):
    """A prefill layer's rows ``x [B, S, d]`` -> q, k, v (``_qkv`` after the
    pre-norm), one q block of rows at a time.

    Prefill's row-wise work (norms, projections, FFN) runs in tiles of
    ``cfg.block_q`` rows so that a row meets the same op shapes whichever
    prefill holds it, a chunk or the whole prompt: the matmul and
    reduction kernels a library picks, and the order of their sums, can
    change with the row count.  Chunks start on whole blocks, so their
    tiles line up with the prompt's, and chunked == monolithic bit for
    bit."""
    parts = [_qkv(common.rmsnorm(x[:, t], lp["ln1"]), lp["attn"], cfg,
                  positions[t]) for t in _tiles(x.shape[1], cfg.block_q)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat([p[i] for p in parts], dim=2) for i in range(3))


def _prefill_out(x, o, lp, cfg: TransformerConfig,
                 routed: int | None = None, mesh=None):
    """``_block_out`` of prefill rows, one q block of rows at a time (see
    :func:`_prefill_qkv`).

    A MoE FFN instead routes the first ``routed`` rows (default all) in
    one call, as the reference routes every row of its prefill call: an
    expert's capacity, and so which pairs it drops, depends on the rows
    routed together.  Rows past ``routed`` (the monolithic prefill's
    padding to whole q blocks) keep the attention residual alone."""
    tiles = _tiles(x.shape[1], cfg.block_q)
    if mesh is not None:
        return _prefill_out_tp(x, o, lp, cfg, tiles, routed, mesh)
    if cfg.moe is None:
        parts = [_block_out(x[:, t], o[:, :, t], lp, cfg) for t in tiles]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    xs, hs = zip(*(_attn_residual(x[:, t], o[:, :, t], lp, cfg)
                   for t in tiles))
    x, h = torch.cat(xs, dim=1), torch.cat(hs, dim=1)
    n = x.shape[1] if routed is None else routed
    y = x[:, :n] + _ffn(h[:, :n], lp, cfg)
    return y if n == x.shape[1] else torch.cat([y, x[:, n:]], dim=1)


def _prefill_out_tp(x, o, lp, cfg: TransformerConfig, tiles, routed, mesh):
    """:func:`_prefill_out` on a mesh rank: the same products a q block
    of rows at a time, each row-sharded sum taken once over all rows (one
    collective a sum, not one a tile).  The MoE FFN's experts are whole on
    every rank, so its output needs no sum."""
    cat = (lambda ps: ps[0] if len(ps) == 1 else torch.cat(ps, dim=1))
    a = cat([common.merge_heads(o[:, :, t]) @ lp["attn"]["wo"]
             for t in tiles])
    x = x + _tp_sum(a, _attn_sharded(lp, cfg), mesh)
    h = common.rmsnorm(x, lp["ln2"])
    if cfg.moe is not None:
        n = x.shape[1] if routed is None else routed
        y = x[:, :n] + _ffn(h[:, :n], lp, cfg)
        return y if n == x.shape[1] else torch.cat([y, x[:, n:]], dim=1)
    f = cat([_ffn(h[:, t], lp, cfg) for t in tiles])
    return x + _tp_sum(f, _ffn_sharded(lp, cfg), mesh)


def _logits(x, params, cfg: TransformerConfig, mesh=None):
    """Float32 logits; over a vocab-parallel head (this rank's columns)
    the ranks' columns are gathered over ``model``."""
    x = common.rmsnorm(x, params["ln_f"])
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    logits = logits.to(torch.float32)
    if logits.shape[-1] < cfg.vocab_size:
        logits = mesh.all_gather(logits, "model", dim=-1)
    return logits


def _window_of(cfg: TransformerConfig, layer: int) -> int | None:
    """The sliding window of ``layer`` (decode and dense prefill): the
    config's ``local_window`` on an 'L' layer, none on a 'G' one."""
    return cfg.local_window if cfg.layer_kind(layer) == "L" else None


def _prefill_window(sparse_items, cfg: TransformerConfig,
                    layer: int) -> int | None:
    """The window a prefill passes to its kernel at ``layer``: the layer's
    on a dense prefill, none on a sparse one (the reference's sparse
    prefill attends its work list unwindowed on every layer, and the port
    keeps its tokens)."""
    return _window_of(cfg, layer) if sparse_items is None else None


def dense_chunk_items(num_heads: int, group_size: int, *, block_q: int,
                      block_kv: int, q_offset: int,
                      q_blocks: int) -> np.ndarray:
    """The dense causal work list of a prefill chunk, ``[N, ITEM_FIELDS]``
    int32: for every head (kv head ``head // group_size``) and each of the
    chunk's first ``q_blocks`` q blocks (chunk-local), one run over every
    kv block up to its diagonal, ``0 .. (q_offset + (qb + 1) * block_q - 1)
    // block_kv``, heads outer and q blocks inner as the sparse lists."""
    runs = []
    for qb in range(q_blocks):
        n = (q_offset + (qb + 1) * block_q - 1) // block_kv + 1
        it = np.zeros((n, ITEM_FIELDS), np.int32)
        it[:, F_QBLK] = qb
        it[:, F_KVBLK] = np.arange(n)
        it[0, F_FIRST] = 1
        it[-1, F_LAST] = 1
        it[:, F_VALID] = 1
        runs.append(it)
    one = np.concatenate(runs)
    items = np.tile(one, (num_heads, 1))
    heads = np.repeat(np.arange(num_heads, dtype=np.int32), len(one))
    items[:, F_HEAD] = heads
    items[:, F_KVHEAD] = heads // group_size
    return items


@functools.lru_cache(maxsize=256)
def _dense_chunk_list(num_heads: int, group_size: int, block_q: int,
                      block_kv: int, q_offset: int, q_blocks: int,
                      device: torch.device) -> torch.Tensor:
    """:func:`dense_chunk_items` on ``device``, memoized."""
    return torch.from_numpy(dense_chunk_items(
        num_heads, group_size, block_q=block_q, block_kv=block_kv,
        q_offset=q_offset, q_blocks=q_blocks)).to(device)


def _chunk_lists(sparse_items, cfg: TransformerConfig, C: int, q_offset: int,
                 kv_len: int, device):
    """Per-layer prefill work lists of a chunk: ``sparse_items``, or the
    dense causal list over the q blocks that hold a row below ``kv_len``
    (the same list for every layer; an 'L' layer's window masks it in the
    kernel)."""
    if sparse_items is not None:
        return sparse_items
    rows = min(max(kv_len - q_offset, 1), C)
    dense = _dense_chunk_list(cfg.num_heads, cfg.group_size, cfg.block_q,
                              cfg.block_kv, q_offset, -(-rows // cfg.block_q),
                              torch.device(device))
    return [dense] * cfg.num_layers


def dense_decode_ids(positions: np.ndarray, active: np.ndarray,
                     num_kv_heads: int, block: int) -> np.ndarray:
    """Dense decode's per-slot block ids ``[B, Hkv, W]`` int32: every
    resident block, ``0 .. positions[b] // block``, for each kv head of an
    active row (-1 pads to the widest row's W; an inactive row selects
    nothing and its output is zero)."""
    nb = np.where(active, np.asarray(positions) // block + 1, 0)
    width = max(int(nb.max()), 1)
    j = np.arange(width)
    ids = np.where(j[None, :] < nb[:, None], j[None, :], -1).astype(np.int32)
    return np.repeat(ids[:, None, :], num_kv_heads, axis=1)


def dense_decode_items(positions: np.ndarray, active: np.ndarray,
                       num_kv_heads: int, block: int) -> np.ndarray:
    """Dense decode's item table ``[B*Hkv*W, DEC_FIELDS]`` int32: the padded
    table of :func:`dense_decode_ids` — the reference's dense decode under
    striping, with one stripe."""
    return padded_decode_items(
        dense_decode_ids(positions, active, num_kv_heads, block))


def scatter_seq_cache_paged(pool, seq_cache, table, *, scales=None,
                            kv_dtype: str = "bf16"):
    """Land a whole prefilled sequence cache in the pool, in place (the
    monolithic prefill's paged merge).

    ``seq_cache [L, 2, 1, Hkv, S, Dh]`` with ``S`` a block multiple;
    ``table [T]`` int32 logical -> pool block (-1 pad: blocks past the
    mapped prefix scatter into the trash block, the pool's last).  A
    quantized pool (``scales [L, 2, N+1, Hkv]`` and the storage
    ``kv_dtype``) takes each block's codes and its scale, quantized at the
    scatter as the reference does.  Returns ``pool``, or ``(pool,
    scales)``."""
    L, _, _, hkv, S, dh = seq_cache.shape
    block = pool.shape[4]
    trash = pool.shape[2] - 1
    nblk = S // block
    blocks = seq_cache[:, :, 0].reshape(L, 2, hkv, nblk, block,
                                        dh).transpose(2, 3)
    tbl = table[:nblk]
    gids = torch.where(tbl >= 0, tbl, trash).long()
    if scales is None:
        pool[:, :, gids] = blocks.to(pool.dtype)
        return pool
    codes, s = quant.quantize_pool_blocks(blocks, kv_dtype)
    quant.code_bits(pool)[:, :, gids] = quant.code_bits(codes)
    scales[:, :, gids] = s
    return pool, scales


def prefill(params, tokens, cfg: TransformerConfig, *,
            cache_len: int | None = None, sparse_items=None,
            last_index: int | None = None, maps_out: list | None = None,
            attn_override=None, mesh=None):
    """Monolithic prefill: ``tokens [B, S]`` (the prompt bucket) -> (logits
    ``[B, V]`` float32 at ``last_index``, default the last row; the
    sequence cache ``[L, 2, B, Hkv, cache_len, Dh]`` in the model's dtype,
    the K/V of every bucket row and zeros past ``S``).

    ``sparse_items``: per-layer ``[P, ITEM_FIELDS]`` int32 work lists of the
    prompt bucket (S-HPLB sparse prefill over the sequence's own K/V, the
    contiguous sparse prefill kernel at ``q_offset`` 0), or None for dense
    causal attention (the flash attention kernel, windowed on 'L' layers).
    The cache holds the full K/V either way.

    ``maps_out``: the profiling forward (the reference's ``forward(...,
    maps_out=)``).  Each layer appends :func:`attention_maps` ``[B, H, S,
    S]`` float32 of the same post-RoPE q and k its attention takes; the
    attention itself still runs through the kernels.  As in the reference
    the maps are causal but unwindowed, also on an 'L' layer.

    ``attn_override(l, q, k, v) -> o`` replaces layer l's attention (the
    reference's hook, through which the step builders run the mesh
    islands): q ``[B, H, S, Dh]``, k / v ``[B, Hkv, S, Dh]`` of the prompt
    rows, o like q.  ``mesh``: the tensor-parallel form on a rank of a
    :class:`repro_torch.launch.mesh.Mesh`, with ``params`` this rank's
    blocks (:func:`repro_torch.sharding.specs.shard_params`): head counts
    come from the weights, the row-sharded products are summed over
    ``model``, the embedding is vocab-parallel, the logits gathered; the
    cache holds the kv heads this rank computes."""
    B, S = tokens.shape
    max_len = S if cache_len is None else cache_len
    if max_len < S:
        raise ValueError(f"cache_len {max_len} < prompt bucket {S}")
    # the row-wise work runs on whole q blocks of rows (_prefill_qkv): a
    # ragged bucket's last block is padded with token 0 rows, which
    # attention never sees and the cache never holds
    rows = -(-S // cfg.block_q) * cfg.block_q
    positions = torch.arange(rows, device=tokens.device)
    x = _embed(params, torch.nn.functional.pad(tokens, (0, rows - S)), cfg,
               mesh)
    dh = cfg.head_dim_
    attn0 = params["layers"][0]["attn"]
    cache = x.new_zeros((cfg.num_layers, 2, B, attn0["wk"].shape[1] // dh,
                         max_len, dh))
    o = x.new_zeros((B, attn0["wq"].shape[1] // dh, rows, dh))
    for l, lp in enumerate(params["layers"]):
        q, k, v = _prefill_qkv(x, lp, cfg, positions)
        cache[l, 0, :, :, :S] = k[:, :, :S]
        cache[l, 1, :, :, :S] = v[:, :, :S]
        if maps_out is not None:
            maps_out.append(attention_maps(q[:, :, :S], k[:, :, :S]))
        if attn_override is not None:
            o[:, :, :S] = attn_override(l, q[:, :, :S], k[:, :, :S],
                                        v[:, :, :S])
        else:
            for b in range(B):
                qb = q[b, :, :S].contiguous()
                kb, vb = k[b, :, :S].contiguous(), v[b, :, :S].contiguous()
                if sparse_items is None:
                    o[b, :, :S] = kernel_ops.flash_attention(
                        qb, kb, vb, causal=True, block_q=cfg.block_q,
                        block_kv=cfg.block_kv, window=_window_of(cfg, l))
                else:
                    o[b, :, :S] = kernel_ops.sparse_prefill_contiguous(
                        qb, kb, vb, sparse_items[l], block_q=cfg.block_q,
                        block_kv=cfg.block_kv)
        x = _prefill_out(x, o, lp, cfg, routed=S, mesh=mesh)
    last = S - 1 if last_index is None else last_index
    return _logits(x[:, last:last + 1], params, cfg, mesh)[:, 0], cache


def attention_maps_of(params, tokens, cfg: TransformerConfig) -> torch.Tensor:
    """The profiling forward of one prompt: ``tokens [S]`` (or ``[1, S]``)
    -> ``[L, H, S, S]`` float32 softmax maps (:func:`prefill` with
    ``maps_out``, dense attention through the flash attention kernel), on
    the params' device: the ``attn_map_fn`` of
    :func:`repro_torch.core.sparsity.profile_model`."""
    dev = params["embed"].device
    toks = torch.as_tensor(np.asarray(tokens, np.int64).reshape(1, -1),
                           device=dev)
    maps: list = []
    prefill(params, toks, cfg, maps_out=maps)
    return torch.stack([m[0] for m in maps])


def prefill_chunk(params, cache, tokens, slot: int, q_offset: int,
                  cfg: TransformerConfig, *, kv_len: int | None = None,
                  sparse_items=None, last_index: int | None = None):
    """Contiguous partial prefill of one sequence chunk into row ``slot`` of
    ``cache [L, 2, B, Hkv, Smax, Dh]``, in place.

    ``tokens [1, C]`` (the chunk bucket); ``slot`` / ``q_offset`` /
    ``kv_len`` / ``last_index`` are host ints; ``sparse_items [L, P,
    ITEM_FIELDS]`` int32 chunk work lists, or None for dense attention
    (:func:`dense_chunk_items`, windowed on 'L' layers).  Each layer writes
    the chunk's K/V at rows ``[q_offset, q_offset + C)`` of the slot, then
    the chunk's queries attend the slot row in place (keys ``< kv_len``)
    with the sparse prefill kernel.  Returns logits ``[1, V]`` float32 at
    chunk-local ``last_index`` (default: the last row).
    """
    _, C = tokens.shape
    if q_offset + C > cache.shape[4]:
        raise ValueError("chunk overruns the slot cache")
    kv_len = q_offset + C if kv_len is None else kv_len
    lists = _chunk_lists(sparse_items, cfg, C, q_offset, kv_len,
                         tokens.device)
    positions = q_offset + torch.arange(C, device=tokens.device)
    rows = slice(q_offset, q_offset + C)
    x = params["embed"][tokens]                            # [1, C, d]
    for l, lp in enumerate(params["layers"]):
        q, k, v = _prefill_qkv(x, lp, cfg, positions)
        kc, vc = cache[l, 0, slot], cache[l, 1, slot]      # [Hkv, Smax, Dh]
        kc[:, rows] = k[0].to(kc.dtype)
        vc[:, rows] = v[0].to(vc.dtype)
        o = kernel_ops.sparse_prefill_contiguous(
            q[0], kc, vc, lists[l], block_q=cfg.block_q,
            block_kv=cfg.block_kv, q_offset=q_offset, kv_len=kv_len,
            window=_prefill_window(sparse_items, cfg, l))[None]
        x = _prefill_out(x, o, lp, cfg)
    last = C - 1 if last_index is None else last_index
    return _logits(x[:, last:last + 1], params, cfg)[:, 0]


def prefill_chunk_paged(params, pool, tokens, table, q_offset: int,
                        cfg: TransformerConfig, *, kv_len: int | None = None,
                        sparse_items=None, last_index: int | None = None,
                        scales=None, kv_dtype: str = "bf16"):
    """Paged partial prefill of one sequence chunk; writes ``pool`` in
    place.

    ``tokens [1, C]`` with C a whole number of cache blocks (the chunk
    bucket); ``table [T]`` int32 logical -> pool block of this sequence (-1
    pad: bucket-padding blocks past the prompt scatter into the trash
    block); ``q_offset`` / ``kv_len`` / ``last_index`` are host ints;
    ``sparse_items [L, P, ITEM_FIELDS]`` int32 chunk work lists, or None for
    dense attention (:func:`dense_chunk_items`, windowed on 'L' layers).
    Each layer scatters the chunk's K/V into its pool blocks in place
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
    lists = _chunk_lists(sparse_items, cfg, C, q_offset, kv_len,
                         tokens.device)
    positions = q_offset + torch.arange(C, device=tokens.device)
    gsl = table[ob:ob + nblk]
    gids = torch.where(gsl >= 0, gsl, trash).long()
    qz = scales is not None
    ks = vs = None
    x = params["embed"][tokens]                            # [1, C, d]
    for l, lp in enumerate(params["layers"]):
        q, k, v = _prefill_qkv(x, lp, cfg, positions)
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
        o = kernel_ops.sparse_prefill(
            q[0], kc, vc, lists[l], table, block_q=cfg.block_q,
            block_kv=block, q_offset=q_offset, kv_len=kv_len, k_scales=ks,
            v_scales=vs, window=_prefill_window(sparse_items, cfg, l))[None]
        x = _prefill_out(x, o, lp, cfg)
    last = C - 1 if last_index is None else last_index
    logits = _logits(x[:, last:last + 1], params, cfg)[:, 0]
    return (logits, pool, scales) if qz else logits


def _decode_work(packed_items, block_ids, pos, active, cfg, block: int,
                 as_ids: bool = False):
    """The decode step's per-layer work as ``(packed_items, block_ids)``:
    the given one and None; or, given neither, dense decode's (the same for
    every layer, from the rows' positions read on the host): its padded
    item table, or with ``as_ids`` its per-slot block ids ``[L, B, Hkv,
    W]``."""
    if packed_items is not None and block_ids is not None:
        raise ValueError("pass at most one of packed_items and block_ids")
    if packed_items is not None or block_ids is not None:
        return packed_items, block_ids
    act = (np.ones(pos.shape[0], bool) if active is None
           else active.cpu().numpy())
    ids = dense_decode_ids(pos.cpu().numpy(), act, cfg.num_kv_heads, block)
    if as_ids:
        ids = torch.from_numpy(ids).to(pos.device)
        return None, ids.expand(cfg.num_layers, -1, -1, -1)
    items = torch.from_numpy(padded_decode_items(ids)).to(pos.device)
    return items.expand(cfg.num_layers, -1, -1), None


def _merge_stripe_partials(parts, B: int, hkv: int, dh: int, dtype):
    """Combine per-stripe decode partials: the reference's
    ``models/transformer.py::_merge_stripe_partials``.

    ``parts``: one ``(out [B, H, 1, dh] float32, m [B, Hkv, G], l [B, Hkv,
    G])`` a stripe, as the decode wrappers return with ``partials``.  They
    stack on a leading stripe axis and take the flash-decoding merge
    (:func:`repro_torch.kernels.flash_decode.merge_partials`); a stripe
    that holds none of a (row, head)'s blocks (``l`` 0) drops out, and a
    pair held by one stripe keeps that stripe's output bitwise.  Returns
    ``[B, H, 1, dh]`` in ``dtype``."""
    outs = torch.stack([o.reshape(B, hkv, -1, dh) for o, _, _ in parts])
    ms = torch.stack([m for _, m, _ in parts])
    ls = torch.stack([l for _, _, l in parts])
    merged = merge_partials(outs, ms, ls)[0]            # [B, Hkv, G, dh]
    return merged.reshape(B, -1, 1, dh).to(dtype)


def decode_step(params, cache, token, pos, cfg: TransformerConfig, *,
                packed_items=None, block_ids=None, active=None,
                scales=None, kv_dtype: str = "bf16", attn_override=None,
                mesh=None, seq_offset: int | None = None):
    """One contiguous decode step over all rows; writes ``cache [L, 2, B,
    Hkv, Smax, Dh]`` in place.

    ``token [B]`` int; ``pos [B]`` int32 (the position each row writes);
    ``packed_items [L, Lb, DEC_FIELDS]`` int32 cost-packed decode work lists
    or, instead, ``block_ids [L, B, Hkv, nb]`` int32 per-slot selections
    (-1 pad), run as the padded item table, or neither for dense attention
    over every resident block (:func:`dense_decode_items`); ``active
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

    ``attn_override(l, q, kc, vc[, ks, vs]) -> o [B, H, 1, Dh]`` replaces
    layer l's attention over the written cache (the reference's hook: the
    step builders' mesh islands).  ``mesh``: the tensor-parallel form of
    :func:`prefill`, over this rank's cache block.  ``seq_offset``: the
    cache holds the positions ``[seq_offset, seq_offset + Smax)`` of a
    sequence striped over ranks; a row whose ``pos`` lies outside writes
    nothing here.
    """
    B = token.shape[0]
    dev = token.device
    qz = scales is not None
    blk = cfg.block_kv
    if attn_override is None:
        packed_items, block_ids = _decode_work(packed_items, block_ids, pos,
                                               active, cfg, blk)
    if qz and cache.shape[4] % blk:
        raise ValueError("a quantized slot cache needs Smax % block_kv == 0")
    act = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
           else active)
    wpos = pos
    if seq_offset is not None:
        local = pos - seq_offset
        act = act & (local >= 0) & (local < cache.shape[4])
        wpos = local.clamp(0, cache.shape[4] - 1)
    act = act[:, None, None]
    rows = torch.arange(B, device=dev)[:, None]
    heads = torch.arange(cache.shape[3], device=dev)[None, :]
    at = wpos.long()[:, None]
    if qz:   # each row's current block and the token's offset in it
        row, blk_i = rows[:, 0], (wpos // blk).long()
        offs = (wpos % blk).long()
    rope_pos = pos.view(B, 1, 1)
    ks = vs = None
    x = _embed(params, token, cfg, mesh)[:, None, :]       # [B, 1, d]
    for l, lp in enumerate(params["layers"]):
        h = common.rmsnorm(x, lp["ln1"])
        q, k, v = _qkv(h, lp["attn"], cfg, rope_pos)
        kc, vc = cache[l, 0], cache[l, 1]                  # [B, Hkv, Smax, Dh]
        if k.shape[1] != kc.shape[1]:
            # whole k / v (row mode's weights) into this rank's kv-head block
            hl = kc.shape[1]
            lo = mesh.axis_index("model") * hl
            k, v = k[:, lo:lo + hl], v[:, lo:lo + hl]
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
        if attn_override is not None:
            o = (attn_override(l, q, kc, vc, ks, vs) if qz
                 else attn_override(l, q, kc, vc))
        elif packed_items is not None:
            o = kernel_ops.flash_decode_packed(
                q, kc, vc, packed_items[l], pos, block_kv=blk,
                window=_window_of(cfg, l), k_scales=ks, v_scales=vs)
        else:
            o = kernel_ops.flash_decode(
                q, kc, vc, block_ids[l], pos, block_kv=blk,
                window=_window_of(cfg, l), k_scales=ks, v_scales=vs)
        x = _block_out(x, o, lp, cfg, mesh)
    logits = _logits(x, params, cfg, mesh)[:, 0]
    return (logits, cache, scales) if qz else logits


def decode_step_paged(params, pool, token, pos, table,
                      cfg: TransformerConfig, *, packed_items=None,
                      block_ids=None, active=None, seq_stripes: int = 1,
                      stripe_size: int | None = None, scales=None,
                      kv_dtype: str = "bf16"):
    """One paged decode step over all rows; writes ``pool`` in place.

    ``token [B]`` int; ``pos [B]`` int32 (the position each row writes);
    ``table [B, T]`` int32 per-row block tables (-1 = unmapped);
    ``packed_items [L, Lb, DEC_FIELDS]`` int32 cost-packed decode work
    lists (LOGICAL kv blocks) or, instead, ``block_ids [L, B, Hkv, nb]``
    int32 LOGICAL per-slot selections (-1 pad), run as the padded item
    table, or neither for dense attention over every resident block
    (:func:`dense_decode_items`); ``active [B]`` bool.  Each row's new K/V
    token is written in place (``index_put_``) into its current block,
    ``(table[b, pos // block], pos % block)``; inactive or unmapped rows
    write the trash block.  Returns logits ``[B, V]`` float32.

    Sequence stripes (§2.11): with ``seq_stripes`` S > 1 the pool's usable
    blocks belong to S stripes of ``stripe_size`` ids each, and attention
    runs one partial pass a stripe over only that stripe's blocks, merged
    by :func:`_merge_stripe_partials`.  ``packed_items`` then holds the
    stripes' lists ``[L, S, Lb, DEC_FIELDS]`` (each list names only its
    stripe's blocks); ``block_ids`` and dense decode run every pass under
    the table masked to the stripe's blocks.  The token write is the same:
    the table routes it.

    Quantized pool: pass ``scales [L, 2, N+1, Hkv]`` float32 and the
    ``kv_dtype``.  The token write becomes a gather of the row's block tile
    and scale, :func:`quant.insert_token_requant` and a full-tile scatter
    back (inactive rows still land in the trash block, whose codes and
    scale are junk), and the kernels take the scales at the physical
    block.  Returns ``(logits, pool, scales)`` then (both written in
    place).
    """
    B = token.shape[0]
    block = pool.shape[4]
    trash = pool.shape[2] - 1
    dev = token.device
    striped = seq_stripes > 1
    if striped and stripe_size is None:
        raise ValueError("striped decode needs the allocator's stripe_size")
    packed_items, block_ids = _decode_work(packed_items, block_ids, pos,
                                           active, cfg, block,
                                           as_ids=striped)
    hkv, dh = cfg.num_kv_heads, cfg.head_dim_
    if striped and packed_items is None:
        # each block is read by exactly the stripe that holds it: entries
        # another stripe owns become -1 (masked)
        stripe_tables = [torch.where((table >= 0)
                                     & (table // stripe_size == s), table, -1)
                         for s in range(seq_stripes)]
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
        kw = dict(block_kv=block, window=_window_of(cfg, l), k_scales=ks,
                  v_scales=vs)
        if striped:
            # one partial pass a stripe, then the flash-decoding merge
            if packed_items is not None:
                parts = [kernel_ops.flash_decode_packed_paged(
                    q, kc, vc, packed_items[l][s], table, pos,
                    partials=True, **kw) for s in range(seq_stripes)]
            else:
                parts = [kernel_ops.flash_decode_paged(
                    q, kc, vc, block_ids[l], stripe_tables[s], pos,
                    partials=True, **kw) for s in range(seq_stripes)]
            o = _merge_stripe_partials(parts, B, hkv, dh, q.dtype)
        elif packed_items is not None:
            o = kernel_ops.flash_decode_packed_paged(
                q, kc, vc, packed_items[l], table, pos, **kw)
        else:
            o = kernel_ops.flash_decode_paged(
                q, kc, vc, block_ids[l], table, pos, **kw)
        x = _block_out(x, o, lp, cfg)
    logits = _logits(x, params, cfg)[:, 0]
    return (logits, pool, scales) if qz else logits


# -- plan epochs: the cache's kv-head re-permutation and the recovery probe --

def permute_cache_kv_heads(cache: torch.Tensor, kv_perm) -> torch.Tensor:
    """A plan-epoch swap's gather of a resident cache's kv-head axis.

    ``cache``: the paged pool ``[L, 2, N, Hkv, block, Dh]`` or the slot
    cache ``[L, 2, B, Hkv, Smax, Dh]`` (kv heads on axis 3 in both), in the
    model dtype or int8 / fp8 codes; ``kv_perm [L, Hkv]``: per layer, the
    previous slot each new kv slot takes
    (:meth:`repro_torch.core.planner.PlanDelta.kv_perm_table`).  Returns a
    new tensor (one gather per layer): weights permuted by the delta expect
    the cache's kv-head slots shuffled the same way."""
    idx = torch.as_tensor(np.asarray(kv_perm), dtype=torch.long,
                          device=cache.device)
    bits = quant.code_bits(cache) if cache.element_size() == 1 else cache
    out = torch.empty_like(bits)
    for l in range(cache.shape[0]):
        torch.index_select(bits[l], 2, idx[l], out=out[l])
    return out.view(cache.dtype)


def permute_cache_scales(scales: torch.Tensor, kv_perm) -> torch.Tensor:
    """:func:`permute_cache_kv_heads` of a quantized cache's scales (paged
    ``[L, 2, N, Hkv]``, contiguous ``[L, 2, B, Hkv, Smax / block]``; kv
    heads on axis 3), so every tile's scale moves with its codes."""
    idx = torch.as_tensor(np.asarray(kv_perm), dtype=torch.long,
                          device=scales.device)
    return torch.stack([scales[l].index_select(2, idx[l])
                        for l in range(scales.shape[0])])


def _resident_keys(kc, scales, table, blk: int):
    """A layer's keys ``[B, Hkv, nkvb * blk, Dh]`` float32 for the probe's
    Quest summaries: gathered through ``table [B, T]`` from the pool
    (``kc [N, Hkv, blk, Dh]``), or the slot cache ``kc [B, Hkv, Smax,
    Dh]`` padded to whole blocks; codes dequantized by their tile's scale
    (pool ``[N, Hkv]``, slot cache ``[B, Hkv, Smax / blk]``)."""
    if table is not None:
        ids = table.clamp_min(0).long()                    # [B, T]
        k = kc[ids].to(torch.float32)                  # [B, T, Hkv, blk, D]
        if scales is not None:
            k = k * scales[ids][..., None, None]
        B, T, hkv, _, dh = k.shape
        return k.transpose(1, 2).reshape(B, hkv, T * blk, dh)
    B, hkv, smax, dh = kc.shape
    k = kc.to(torch.float32)
    if scales is not None:
        k = (k.reshape(B, hkv, -1, blk, dh)
             * scales[..., None, None]).reshape(B, hkv, smax, dh)
    return torch.nn.functional.pad(k, (0, 0, 0, (-smax) % blk))


def decode_telemetry(params, cache, token, pos, cfg: TransformerConfig, *,
                     block_ids, cache_len, table=None, scales=None,
                     with_health: bool = False):
    """Quest-bound estimate of the recovery each head's decode selection
    realizes (plan epochs, the reference's ``decode_telemetry``).

    Runs one decode forward over the RESIDENT cache prefix (keys ``kpos <
    cache_len``: the tick's token is not written yet) and per layer
    computes, from Quest's per-block key min / max summaries, the share of
    the estimated attention mass that the selected blocks capture::

        rec[l, b, h] = sum_{blk in sel} w / sum_{blk resident} w,
        w = exp(ub - max ub) * resident_tokens(blk)

    and the normalized budget spent, ``frac[l, b, h] = selected resident
    tokens / cache_len``.  The hidden state propagates through DENSE
    attention over the prefix (an estimator forward: nothing is sampled and
    no cache is written), run by the decode kernels (#1 paged, #3
    contiguous; their code forms over an int8 / fp8 cache) over dense
    decode's table of every resident block, with no window on any layer,
    as the reference's.  The Quest summaries are torch ops.

    ``cache``: the pool ``[L, 2, N+1, Hkv, block, Dh]`` with ``table [B,
    T]`` int32 (logical -> pool block, -1 pad), or the slot cache ``[L, 2,
    B, Hkv, Smax, Dh]``; ``scales`` beside a quantized cache (pool ``[L, 2,
    N+1, Hkv]``, slot cache ``[L, 2, B, Hkv, Smax / block]``): summaries and
    forward both see the dequantized values.  ``token [B]``, ``pos [B]``
    int32, ``cache_len [B]`` int32 (the resident length, the tick's
    ``pos``), ``block_ids [L, B, Hkv, nb]`` LOGICAL selections (-1 pad), the
    engine's position-aware decode tables.  Returns ``(rec, frac)`` float32
    ``[L, B, H]`` (rows with ``cache_len`` 0 are garbage the caller masks)
    and, with ``with_health``, ``fin [B]`` bool: whether the row's hidden
    state stayed finite through every layer."""
    B = token.shape[0]
    dev = token.device
    hkv, dh = cfg.num_kv_heads, cfg.head_dim_
    n_rep = cfg.num_heads // hkv
    paged = table is not None
    blk = cache.shape[4] if paged else cfg.block_kv
    clen = torch.as_tensor(cache_len, dtype=torch.int32, device=dev)
    clen = clen.expand(B) if clen.dim() == 0 else clen
    skv = table.shape[1] * blk if paged else cache.shape[4]
    nkvb = -(-skv // blk)
    kpos = torch.arange(nkvb * blk, device=dev)
    valid = kpos[None] < clen[:, None].long()              # [B, Skv]
    ntok = (clen[:, None] - torch.arange(nkvb, device=dev)[None] * blk
            ).clamp(0, blk).to(torch.float32)              # [B, nkvb]
    ids = torch.as_tensor(block_ids, device=dev).long()
    clen_np = clen.cpu().numpy()
    items = torch.from_numpy(dense_decode_items(
        np.maximum(clen_np - 1, 0), clen_np > 0, hkv, blk)).to(dev)
    last = (clen - 1).clamp_min(0).to(torch.int32)
    vmask = valid.reshape(B, 1, nkvb, blk, 1)
    has = vmask.any(dim=3)                                 # [B, 1, nkvb, 1]
    bvalid = has[..., 0]                                   # [B, 1, nkvb]
    blocks = torch.arange(nkvb, device=dev)
    x = params["embed"][token][:, None, :]                 # [B, 1, d]
    recs, fracs = [], []
    for l, lp in enumerate(params["layers"]):
        h = common.rmsnorm(x, lp["ln1"])
        q = apply_rope(common.split_heads(h @ lp["attn"]["wq"], cfg.num_heads),
                       pos.view(B, 1, 1), cfg.rope_theta)  # [B, H, 1, Dh]
        kc, vc = cache[l, 0], cache[l, 1]
        ks = vs = None
        if scales is not None:
            ks, vs = scales[l, 0], scales[l, 1]
        # -- Quest summaries over the resident prefix -----------------------
        kb = _resident_keys(kc, ks, table, blk).reshape(B, hkv, nkvb, blk, dh)
        kmin = torch.where(vmask, kb, torch.inf).amin(dim=3)
        kmax = torch.where(vmask, kb, -torch.inf).amax(dim=3)
        kmin = torch.where(has, kmin, 0.0).repeat_interleave(n_rep, dim=1)
        kmax = torch.where(has, kmax, 0.0).repeat_interleave(n_rep, dim=1)
        qf = q[:, :, 0, :].to(torch.float32) * dh ** -0.5
        ub = (torch.einsum("bhd,bhkd->bhk", qf.clamp_min(0.0), kmax)
              + torch.einsum("bhd,bhkd->bhk", qf.clamp_max(0.0), kmin))
        ub = torch.where(bvalid, ub, -torch.inf)
        m = torch.exp(ub - ub.amax(dim=-1, keepdim=True))
        w = torch.where(bvalid, m, 0.0) * ntok[:, None]    # [B, H, nkvb]
        sel = (ids[l][..., None] == blocks).any(dim=2)     # [B, Hkv, nkvb]
        sel = sel.repeat_interleave(n_rep, dim=1) & bvalid
        tot = w.sum(-1).clamp_min(1e-30)
        recs.append(torch.where(sel, w, 0.0).sum(-1) / tot)
        fracs.append(torch.where(sel, ntok[:, None], 0.0).sum(-1)
                     / clen[:, None].clamp_min(1))
        # -- the dense estimator forward (decode kernels, no window) --------
        if paged:
            o = kernel_ops.flash_decode_packed_paged(
                q, kc, vc, items, table, last, block_kv=blk, k_scales=ks,
                v_scales=vs)
        else:
            if kc.shape[2] % blk:   # the kernels take whole blocks
                kc, vc = (torch.nn.functional.pad(
                    t, (0, 0, 0, (-t.shape[2]) % blk)) for t in (kc, vc))
            o = kernel_ops.flash_decode_packed(
                q, kc, vc, items, last, block_kv=blk, k_scales=ks,
                v_scales=vs)
        x = _block_out(x, o, lp, cfg)
    rec, frac = torch.stack(recs), torch.stack(fracs)
    if with_health:
        return rec, frac, torch.isfinite(x).all(dim=2).all(dim=1)
    return rec, frac
