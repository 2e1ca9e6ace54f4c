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
The body splits each run (a ``first`` item to its ``last``) across CTAs:
the item at position p of its run belongs to split ``p // SPLIT_TILES``,
each split's partial ``(out, m, l)`` starts from the initial state, and a
run of several splits is merged in item order by :func:`merge_partials`.
The plain versions run the same split algebra (:func:`split_decode_scan`),
so the card and the CPU compute one arithmetic.
Both take q ``[B, Hkv, G, D]``, items ``[L, DEC_FIELDS]`` with LOGICAL kv
blocks (cost-packed, or the padded table of :func:`decode_items_from_ids`)
and pos ``[B]`` (last position, inclusive), and return ``(out f32 [B, Hkv,
G, D], m, l [B, Hkv, G])``.  :func:`flash_decode_reference` and
:func:`flash_decode_paged_reference` are the plain versions of the
per-slot block-id forms.

Quantized caches (the TPU kernels' ``k_scales`` / ``v_scales`` branch):
int8 or fp8 (e4m3) codes with one float32 scale per (block, kv head) tile,
``[N, Hkv]`` at the PHYSICAL block for the pool, ``[B, Hkv, Smax /
block_kv]`` for the slot cache.  q is taken in float32 (never cast to the
code dtype), the codes are dotted raw and the scales multiply after the
dots: ``s = (q . codes) * scale * k_scale``, ``pv = (p . codes) *
v_scale``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.worklist import (
    D_BATCH, D_FIRST, D_KVBLK, D_KVHEAD, D_LAST, D_VALID, DEC_FIELDS)
from repro_torch.kernels.build import (
    HEAD_DIMS, MAX_GROUP, check_launch, count_launch, kernel_function,
    reset_launches)

NEG_INF = -1e30
# tiles per split of a flash-decode run, as csrc/flash_decode.cuh's
# kSplitTiles
SPLIT_TILES = 1
# the kernels' element-type codes: caches that q shares, and code caches
# (q float32, with scales)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
CODE_DTYPES = {torch.int8: 2, torch.float8_e4m3fn: 3}
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
_CONTIG_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
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


def _add_tile(state, qf_bh, kv, kpos, last_pos, scale: float,
              window: int | None):
    """One tile into the running state ``(acc [..., G, D], m [..., G, 1],
    l [..., G, 1])`` of the online softmax: ``kv = (k, v, k_scale,
    v_scale)`` float32 tiles ``[..., blk, D]`` of key positions ``kpos``
    (scales None for a full-precision cache).  Leading dimensions, if any,
    hold a stack of independent states (the splits of
    :func:`split_decode_scan`), each with its own q rows, tile, scales and
    ``last_pos``, shaped to broadcast."""
    acc, m, l = state
    kt, vt, ks, vs = kv
    s = (qf_bh @ kt.transpose(-1, -2)) * scale            # [..., G, blk]
    if ks is not None:
        s = s * ks
    mask = kpos <= last_pos
    if window is not None:
        mask &= kpos > last_pos - window
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    pr = torch.where(mask, torch.exp(s - m_new), 0.0)
    alpha = torch.exp(m - m_new)
    l = l * alpha + pr.sum(dim=-1, keepdim=True)
    pv = pr @ vt
    if vs is not None:
        pv = pv * vs
    return acc * alpha + pv, m_new, l


def _initial_state(G: int, dh: int, dev):
    return (torch.zeros((G, dh), dtype=torch.float32, device=dev),
            torch.full((G, 1), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((G, 1), dtype=torch.float32, device=dev))


def _normalized(acc, l):
    """A run's or a split's output: ``acc / l``, 0 where ``l == 0``."""
    return torch.where(l > 0.0, acc / l.clamp_min(1e-30), 0.0)


def decode_scan(qf, tile, items, last_pos, *, block_kv: int, scale: float,
                window: int | None = None):
    """The reference's decode item scan in float32, one item at a time:
    the reference order the split plain version (:func:`split_decode_scan`)
    is tested against.

    ``qf [B, Hkv, G, D]`` float32 query rows; ``tile(b, h, blk)`` returns
    ``(k, v, k_scale, v_scale)`` of a logical block, float32 ``[block_kv,
    D]`` tiles and their scales (None for a full-precision cache), or None
    when unmapped;
    ``last_pos[b]`` is row b's last position (keys at ``kpos <= last_pos``
    count).  Flash-decode rules: a run starts on ``first`` and finalizes on
    ``last`` whether or not that item is valid.  Invalid or unmapped items
    leave the running state untouched.  Returns ``(out, m, l)``; (row,
    head) pairs no run finalizes keep (0, -1e30, 0).
    """
    B, hkv, G, dh = qf.shape
    dev = qf.device
    out, m_out, l_out = _partials(qf)
    state = _initial_state(G, dh, dev)
    offs = torch.arange(block_kv, device=dev)
    for it in items.tolist():
        b, h, blk = it[D_BATCH], it[D_KVHEAD], it[D_KVBLK]
        if it[D_FIRST] == 1:
            state = _initial_state(G, dh, dev)
        kv = tile(b, h, blk) if it[D_VALID] == 1 else None
        if kv is not None:
            state = _add_tile(state, qf[b, h], kv, blk * block_kv + offs,
                              last_pos[b], scale, window)
        if it[D_LAST] == 1:
            acc, m, l = state
            out[b, h] = _normalized(acc, l)
            m_out[b, h] = m[:, 0]
            l_out[b, h] = l[:, 0]
    return out, m_out, l_out


def decode_runs(rows, legacy: bool = False) -> list[tuple[int, int]]:
    """``(first, last)`` item indices of the decode's runs that finalize,
    from the item rows ``[L, DEC_FIELDS]`` (a list of lists): a run goes
    from a start to the next end; a run that meets another start before
    its end, or none, never finalizes; items between an end and the next
    start (bucket pads) belong to no run.  The flash decode's items start
    on ``first`` and end on ``last``, valid or not; with ``legacy`` (the
    legacy budgeted decode) only valid items start or end a run."""
    runs, start = [], None
    for j, it in enumerate(rows):
        counts = not legacy or it[D_VALID] == 1
        if it[D_FIRST] == 1 and counts:
            start = j
        if start is not None and it[D_LAST] == 1 and counts:
            runs.append((start, j))
            start = None
    return runs


def merge_partials(outs, ms, ls):
    """The flash-decoding merge of per-shard partials along a leading axis:
    the reference's ``repro/kernels/flash_decode.py::merge_partials``.

    ``outs [S, ..., D]`` shard-normalized outputs, ``ms`` / ``ls [S,
    ...]``.  A shard is real where ``l > 0``; the max ``gm`` is taken over
    the real shards, each weighs ``exp(m - gm) * l`` (0 if not real, so a
    fully masked shard, ``m`` -1e30 or -inf and ``l`` 0, is the exact
    identity) and ``out = sum(out * w) / max(sum(w), 1e-30)``.  Where at
    most one shard is real, ``out`` is the sum of the real shards' outs:
    that shard's out bitwise, or zeros (never NaN).  The sums run in shard
    order, one rounding per term as the CUDA kernels' merge, so trailing
    non-real shards add exact zeros.  Returns ``(out, m, l)``: ``m`` is
    ``gm`` (-1e30 where nothing is real), ``l`` is ``sum(w)``, or the
    single real shard's ``l``.
    """
    outs32 = outs.to(torch.float32)
    real = ls > 0.0                                        # [S, ...]
    nreal = real.sum(dim=0)
    gm = torch.where(real, ms, NEG_INF).amax(dim=0)
    w = torch.where(real, torch.exp(ms - gm) * ls, 0.0)
    terms = outs32 * w[..., None]
    reals = torch.where(real[..., None], outs32, 0.0)
    real_ls = torch.where(real, ls, 0.0)
    num = torch.zeros_like(outs32[0])
    single = torch.zeros_like(outs32[0])
    den = torch.zeros_like(gm)
    one_l = torch.zeros_like(gm)
    for s in range(outs.shape[0]):          # in shard order, as the kernels
        num += terms[s]
        single += reals[s]
        den += w[s]
        one_l += real_ls[s]
    merged = num / den.clamp_min(1e-30)[..., None]
    alone = nreal <= 1
    out = torch.where(alone[..., None], single, merged)
    return out.to(outs.dtype), gm, torch.where(alone, one_l, den)


def split_decode_scan(qf, tile, items, last_pos, *, block_kv: int,
                      scale: float, window: int | None = None,
                      legacy: bool = False):
    """The decode kernels' split algebra in float32: the plain version of
    :func:`flash_decode_paged_kernel` and :func:`flash_decode_kernel`, and
    with ``legacy`` (its run rule) of the legacy budgeted decode.
    Arguments as :func:`decode_scan`.

    Each run of :func:`decode_runs` is cut into splits of ``SPLIT_TILES``
    items by position in the run; each split scans its items from the
    initial state (invalid or unmapped items leave it untouched) and is
    normalized as a run's output; each run's ``(out, m, l)`` is the
    :func:`merge_partials` of its splits in item order (a run of one split
    gets that split's own).  (row, head) pairs no run finalizes keep (0,
    -1e30, 0).  The splits are independent, so every split's step ``t``
    runs as one stacked tile step, and every run is merged at once, its
    splits padded to the longest run's count with masked partials (which
    add exact zeros).
    """
    B, hkv, G, dh = qf.shape
    dev = qf.device
    out, m_out, l_out = _partials(qf)
    rows = items.tolist()
    runs = decode_runs(rows, legacy)
    if not runs:
        return out, m_out, l_out
    # the splits as (run, position in the run, first item)
    splits = [(r, p, s0) for r, (first, last) in enumerate(runs)
              for p, s0 in enumerate(range(first, last + 1, SPLIT_TILES))]
    heads = [(rows[first][D_BATCH], rows[first][D_KVHEAD])
             for first, _ in runs]
    n = len(splits)
    acc = torch.zeros((n, G, dh), dtype=torch.float32, device=dev)
    m = torch.full((n, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((n, G, 1), dtype=torch.float32, device=dev)
    offs = torch.arange(block_kv, device=dev)
    lp = torch.tensor(last_pos, device=dev)
    for t in range(SPLIT_TILES):
        idx, kvs, where = [], [], []
        for j, (r, _, s0) in enumerate(splits):
            if s0 + t > runs[r][1] or rows[s0 + t][D_VALID] != 1:
                continue
            (b, h), blk = heads[r], rows[s0 + t][D_KVBLK]
            kv = tile(b, h, blk)
            if kv is not None:
                idx.append(j)
                kvs.append(kv)
                where.append((b, h, blk))
        if not idx:
            continue
        sel = torch.tensor(idx, device=dev)
        b, h, blk = torch.tensor(where, device=dev).unbind(1)
        kt, vt, ks, vs = (None if c[0] is None else torch.stack(c)
                          for c in zip(*kvs))
        if ks is not None:       # one scale per tile
            ks, vs = ks[:, None, None], vs[:, None, None]
        acc[sel], m[sel], l[sel] = _add_tile(
            (acc[sel], m[sel], l[sel]), qf[b, h], (kt, vt, ks, vs),
            (blk[:, None] * block_kv + offs)[:, None], lp[b][:, None, None],
            scale, window)
    # [max splits, runs, ...] partials, padded with masked ones
    R, S = len(runs), max(p for _, p, _ in splits) + 1
    pos_in_run, run_of = (torch.tensor(c, device=dev) for c in zip(
        *((p, r) for r, p, _ in splits)))
    outs = torch.zeros((S, R, G, dh), dtype=torch.float32, device=dev)
    ms = torch.full((S, R, G), NEG_INF, dtype=torch.float32, device=dev)
    ls = torch.zeros((S, R, G), dtype=torch.float32, device=dev)
    outs[pos_in_run, run_of] = _normalized(acc, l)
    ms[pos_in_run, run_of] = m[..., 0]
    ls[pos_in_run, run_of] = l[..., 0]
    merged = merge_partials(outs, ms, ls)
    # a (row, head) that several runs finalize keeps the last one's
    last_run = {bh: r for r, bh in enumerate(heads)}
    b, h = torch.tensor(list(last_run), device=dev).reshape(-1, 2).unbind(1)
    rs = torch.tensor(list(last_run.values()), device=dev)
    for dst, src in zip((out, m_out, l_out), merged):
        dst[b, h] = src[rs]
    return out, m_out, l_out


def _scale(dh: int, scale: float | None) -> float:
    return float(dh ** -0.5) if scale is None else float(scale)


def query_as_read(q, k, k_scales):
    """q as the kernels read it: float32 over codes, else in the cache's
    dtype (q.k multiplies in the cache's type)."""
    return q.to(torch.float32 if k_scales is not None else k.dtype)


def kernel_dtype(k, k_scales) -> int:
    """The kernels' element-type code of K/V ``k``."""
    return CODE_DTYPES[k.dtype] if k_scales is not None else DTYPES[k.dtype]


def scale_ptrs(k_scales, v_scales):
    """The scales' device pointers for a kernel, 0 (null) without them."""
    if k_scales is None:
        return 0, 0
    return k_scales.data_ptr(), v_scales.data_ptr()


def slot_tiles(k_cache, v_cache, block_kv: int, k_scales=None,
               v_scales=None):
    """``tile`` for :func:`decode_scan` over a slot cache ``[B, Hkv, Smax,
    D]`` of whole blocks: block ``blk`` of row b is rows ``[blk*block_kv,
    +block_kv)``, with scales ``[b, h, blk]`` of a code cache; a block
    outside the cache is unmapped."""
    smax = k_cache.shape[2]

    def tile(b, h, blk):
        lo = blk * block_kv
        if blk < 0 or lo >= smax:
            return None
        return (k_cache[b, h, lo:lo + block_kv].to(torch.float32),
                v_cache[b, h, lo:lo + block_kv].to(torch.float32),
                None if k_scales is None else k_scales[b, h, blk],
                None if v_scales is None else v_scales[b, h, blk])
    return tile


def packed_decode_attention(q, k_cache, v_cache, items, pos, *,
                            block_kv: int = 128, scale: float | None = None,
                            window: int | None = None, k_scales=None,
                            v_scales=None):
    """Plain PyTorch version of :func:`flash_decode_kernel`: the split item
    scan (:func:`split_decode_scan`) over the slot cache ``[B, Hkv, Smax,
    D]``.  q.k multiplies q cast to the cache dtype (float32 over codes)
    with the cache tile and sums in float32; p.V is float32; the scales
    ``[B, Hkv, Smax / block_kv]`` of a code cache multiply after the
    dots."""
    return split_decode_scan(query_as_read(q, k_cache, k_scales).float(),
                             slot_tiles(k_cache, v_cache, block_kv,
                                        k_scales, v_scales),
                             items, pos.tolist(), block_kv=block_kv,
                             scale=_scale(q.shape[-1], scale), window=window)


def packed_decode_attention_paged(q, k_pool, v_pool, items, table, pos, *,
                                  block_kv: int = 128,
                                  scale: float | None = None,
                                  window: int | None = None, k_scales=None,
                                  v_scales=None):
    """Plain PyTorch version of :func:`flash_decode_paged_kernel`: the
    split item scan over the block pool through ``table [B, T]``
    (logical index clamped into the table, -1 entries unmapped), with a
    code pool's scales ``[N, Hkv]`` read at the physical block.  Same
    arithmetic as :func:`packed_decode_attention`."""
    T = table.shape[1]
    tbl = table.tolist()

    def tile(b, h, blk):
        phys = tbl[b][min(max(blk, 0), T - 1)]
        if phys < 0:
            return None
        return (k_pool[phys, h].to(torch.float32),
                v_pool[phys, h].to(torch.float32),
                None if k_scales is None else k_scales[phys, h],
                None if v_scales is None else v_scales[phys, h])
    return split_decode_scan(query_as_read(q, k_pool, k_scales).float(),
                             tile, items, pos.tolist(), block_kv=block_kv,
                             scale=_scale(q.shape[-1], scale), window=window)


def flash_decode_reference(q, k_cache, v_cache, block_ids, pos, *,
                           block_kv: int = 128, scale: float | None = None,
                           window: int | None = None, k_scales=None,
                           v_scales=None):
    """Plain version of the per-slot block-id form over the slot cache
    (the reference's ``flash_decode_reference``): ``block_ids [B, Hkv, nb]``
    (-1 pad) run as the padded item table."""
    return packed_decode_attention(
        q, k_cache, v_cache, decode_items_from_ids(block_ids), pos,
        block_kv=block_kv, scale=scale, window=window, k_scales=k_scales,
        v_scales=v_scales)


def flash_decode_paged_reference(q, k_pool, v_pool, block_ids, table, pos, *,
                                 block_kv: int = 128,
                                 scale: float | None = None,
                                 window: int | None = None, k_scales=None,
                                 v_scales=None):
    """Plain version of the per-slot block-id form over the pool (the
    reference's ``flash_decode_paged_reference``)."""
    return packed_decode_attention_paged(
        q, k_pool, v_pool, decode_items_from_ids(block_ids), table, pos,
        block_kv=block_kv, scale=scale, window=window, k_scales=k_scales,
        v_scales=v_scales)


def flash_decode_paged_kernel(q, k_pool, v_pool, items, table, pos, *,
                              block_kv: int = 128,
                              scale: float | None = None,
                              window: int | None = None, k_scales=None,
                              v_scales=None):
    """Budgeted flash-decode over the block pool (see module docstring).

    CPU tensors run :func:`packed_decode_attention_paged`.  CUDA tensors
    launch the CUDA kernel (bf16 or f32 pools, or int8 / fp8 code pools
    with ``k_scales`` / ``v_scales [N, Hkv]``; head_dim 32/64/128/256,
    G <= 8)
    or raise; there is no fallback.  ``launches`` counts kernel launches,
    ``launches_by_dtype`` per pool dtype.
    """
    B, hkv, G, dh = q.shape
    check_decode_args(q, k_pool, v_pool, items, block_kv, pos, table)
    if k_pool.shape[1:] != (hkv, block_kv, dh):
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)} at block_kv={block_kv}")
    check_scales(q, k_pool, k_scales, v_scales, tuple(k_pool.shape[:2]))
    if q.device.type == "cpu":
        return packed_decode_attention_paged(
            q, k_pool, v_pool, items, table, pos, block_kv=block_kv,
            scale=scale, window=window, k_scales=k_scales,
            v_scales=v_scales)
    check_cuda_decode("flash_decode_paged", q, k_pool, k_scales)
    out, m, l = _partials(q)
    if items.shape[0] == 0:
        return out, m, l
    fn = kernel_function("flash_decode_paged", _PAGED_ARGTYPES)
    qk = query_as_read(q, k_pool, k_scales)   # held through the launch
    work, tickets = split_work(q, items.shape[0])
    with torch.cuda.device(q.device):
        err = fn(qk.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(),
                 *scale_ptrs(k_scales, v_scales), items.data_ptr(),
                 table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 m.data_ptr(), l.data_ptr(), work.data_ptr(),
                 tickets.data_ptr(), items.shape[0], hkv, G, dh, block_kv, table.shape[1],
                 _scale(dh, scale), 0 if window is None else int(window),
                 kernel_dtype(k_pool, k_scales),
                 torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_decode_paged", err)
    count_launch(flash_decode_paged_kernel, k_pool.dtype)
    return out, m, l


def flash_decode_kernel(q, k_cache, v_cache, items, pos, *,
                        block_kv: int = 128, scale: float | None = None,
                        window: int | None = None, k_scales=None,
                        v_scales=None):
    """Budgeted flash-decode over the slot cache ``[B, Hkv, Smax, D]``, in
    place (see module docstring).

    CPU tensors run :func:`packed_decode_attention`.  CUDA tensors launch
    the CUDA kernel (bf16 or f32 caches, or int8 / fp8 code caches with
    ``k_scales`` / ``v_scales [B, Hkv, Smax / block_kv]``; head_dim
    32/64/128/256, G <= 8) or raise; there is no fallback.  ``launches`` counts kernel
    launches, ``launches_by_dtype`` per cache dtype.
    """
    B, hkv, G, dh = q.shape
    check_decode_args(q, k_cache, v_cache, items, block_kv, pos)
    if (k_cache.shape[0], k_cache.shape[1], k_cache.shape[3]) != (B, hkv, dh):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    check_scales(q, k_cache, k_scales, v_scales,
                 (B, hkv, k_cache.shape[2] // block_kv))
    if q.device.type == "cpu":
        return packed_decode_attention(q, k_cache, v_cache, items, pos,
                                       block_kv=block_kv, scale=scale,
                                       window=window, k_scales=k_scales,
                                       v_scales=v_scales)
    check_cuda_decode("flash_decode_contig", q, k_cache, k_scales)
    out, m, l = _partials(q)
    if items.shape[0] == 0:
        return out, m, l
    fn = kernel_function("flash_decode_contig", _CONTIG_ARGTYPES)
    qk = query_as_read(q, k_cache, k_scales)   # held through the launch
    work, tickets = split_work(q, items.shape[0])
    with torch.cuda.device(q.device):
        err = fn(qk.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(),
                 *scale_ptrs(k_scales, v_scales), items.data_ptr(),
                 pos.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
                 work.data_ptr(), tickets.data_ptr(), items.shape[0], hkv, G, dh, block_kv, k_cache.shape[2],
                 _scale(dh, scale), 0 if window is None else int(window),
                 kernel_dtype(k_cache, k_scales),
                 torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_decode_contig", err)
    count_launch(flash_decode_kernel, k_cache.dtype)
    return out, m, l


reset_launches(flash_decode_paged_kernel, flash_decode_kernel)

# the split decode's run counters, int32, all zero between launches: one
# buffer per (device, stream), since launches on one stream run in order
# and launches on two streams may overlap
_TICKETS: dict[tuple[torch.device, int], torch.Tensor] = {}
# every buffer a CUDA graph captured, kept for its replays after the
# buffer is replaced
_CAPTURED: list[torch.Tensor] = []


def split_work(q, L: int):
    """The split decodes' workspace for ``L`` items: the partials, f32
    ``[L * G * (D + 2)]`` (out ``[L, G, D]``, then m and l ``[L, G]``),
    and the current stream's run counters, int32, at least ``L``.  The
    kernel leaves every counter at zero (the CTA that merges a run resets
    it), so the counters are filled once when their buffer is made or
    grows, not per call: a fill per call would add a launch to a
    host-bound serve.  A buffer made during CUDA graph capture is filled
    inside the graph, and one a graph used is kept when it is replaced.
    A graph's replays must not overlap launches on its capture stream,
    nor replays of another graph captured on that stream."""
    G, dh = q.shape[-2:]
    work = torch.empty(L * G * (dh + 2), dtype=torch.float32,
                       device=q.device)
    key = (q.device, torch.cuda.current_stream(q.device).cuda_stream)
    capturing = torch.cuda.is_current_stream_capturing()
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < L:
        grown = max(L, 2 * (0 if tickets is None else tickets.numel()), 4096)
        tickets = torch.zeros(grown, dtype=torch.int32, device=q.device)
        _TICKETS[key] = tickets
    if capturing and not any(t is tickets for t in _CAPTURED):
        _CAPTURED.append(tickets)
    return work, tickets


def _partials(q):
    B, hkv, G, dh = q.shape
    return (torch.zeros((B, hkv, G, dh), dtype=torch.float32,
                        device=q.device),
            torch.full((B, hkv, G), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((B, hkv, G), dtype=torch.float32, device=q.device))


def check_cuda_decode(name: str, q, k, k_scales=None):
    """Raise unless ``q`` lies on CUDA and the kernel ``name`` takes its
    arguments (:func:`check_decode_kernel_args`)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {q.device}")
    check_decode_kernel_args(name, q, k, k_scales)


def check_decode_kernel_args(name: str, q, k, k_scales=None):
    """Raise unless the decode kernel ``name`` is built for the cache's
    dtype (bf16 / f32, or int8 / fp8 codes where ``k_scales`` is given),
    q's head_dim (32, 64, 128 or 256) and its GQA group (G <= 8)."""
    dh, G = q.shape[-1], q.shape[-2]
    kinds = CODE_DTYPES if k_scales is not None else DTYPES
    if k.dtype not in kinds or dh not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"{name} kernel takes bf16/f32 caches (int8/fp8 "
                         f"codes with scales), head_dim 32/64/128/256 and G <= "
                         f"{MAX_GROUP}; got {k.dtype}, {dh}, {G}")


def check_scales(q, k, k_scales, v_scales, shape: tuple) -> None:
    """Scales come both or neither, float32 of ``shape``, contiguous on
    q's device, and only with a code cache (int8 / fp8); a code cache
    needs them."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if k_scales is None:
        if k.dtype in CODE_DTYPES:
            raise ValueError(f"a {k.dtype} cache needs k_scales/v_scales")
        return
    if k.dtype not in CODE_DTYPES:
        raise ValueError(f"scales go with int8/fp8 codes, got {k.dtype}")
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


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
