"""The S-HPLB attention islands over a process-group mesh: the counterpart
of the reference's ``serving/sharded_attention.py``.

The reference runs each island under ``shard_map``: its ``in_specs`` cut
the global arrays into per-device blocks, the body runs on a block, and
its ``out_specs`` put the blocks back together.  Here every rank is a
process that already holds its blocks, so each island is a function of
this rank's blocks (what the reference's ``in_specs`` give a shard) and
the :class:`repro_torch.launch.mesh.Mesh`, and returns this rank's block
of the output (its ``out_specs``).  The islands keep the reference's
names; an island takes the mesh only where it runs a collective, and
only the options its body reads (batch axes need none, since a rank's
blocks already hold only its rows).

- Prefill: :func:`hplb_prefill_attention` (each ``model`` rank runs its own
  work list over its heads; ``kv_group`` K/V hold its kv heads and item kv
  ids are local, ``kv_replication`` K/V hold every kv head and the ids are
  global) and :func:`hplb_prefill_attention_rows` ((head, q block) rows
  over ``model``, disjoint tiles summed).  Both run the contiguous sparse
  prefill kernel (``kernels/sparse_prefill.py::sparse_prefill_attention``),
  which reads each item's kv head from ``F_KVHEAD``.
- Decode: :func:`hplb_decode_attention_packed` (head-sharded, no merge),
  :func:`flash_decode_attention` (the slot cache sharded on its sequence),
  :func:`flash_decode_attention_paged` (the pool sharded on its block axis)
  and :func:`flash_decode_attention_2d` (heads over ``model``, pool stripes
  over ``seq``).  The sharded ones run the decode kernels with
  ``partials=True`` and merge the ``(out, m, l)`` partials with the
  reference's ``pmax`` / ``psum`` algebra in float32, summed in rank order
  (:meth:`Mesh.psum`); a rank holding none of a row's blocks has ``l = 0``
  and drops out exactly.
- Cache moves: :func:`hplb_repermute_kv_cache` (an ``all_gather`` of the
  kv-head axis over ``model`` and a take), and the shard-local, bit-exact
  :func:`hplb_swap_gather_kv_blocks` / :func:`hplb_swap_scatter_kv_blocks`.

Like the reference's, the islands take no sliding window, so an 'L'
layer's mesh prefill and seq-sharded decode attend unwindowed; the
packed decode island takes one for the step's head-sharded cell, which
the reference lowers as windowed dense decode.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.sparse_prefill import sparse_prefill_attention


def _prefill(q, k, v, items, *, block_q: int, block_kv: int):
    """The contiguous sparse prefill kernel over every row of the batch:
    q ``[B, H, S, D]``, k / v ``[B, Hkv, S, D]``, items ``[P, 7]``."""
    out = torch.empty_like(q)
    for b in range(q.shape[0]):
        out[b] = sparse_prefill_attention(
            q[b].contiguous(), k[b].contiguous(), v[b].contiguous(), items,
            block_q=block_q, block_kv=block_kv)
    return out


def hplb_prefill_attention(*, block_q: int = 128, block_kv: int = 128):
    """The prefill island: ``attend(l, q, k, v, items) -> o``, with no
    collective.

    q ``[B, H_loc, S, D]`` (this rank's heads, in plan slot order); k / v
    ``[B, Hkv_loc, S, D]``, this rank's kv heads (the ``kv_group`` mode,
    item kv ids local) or ``[B, Hkv, S, D]`` every kv head
    (``kv_replication``, item kv ids global); items ``[1, L, Lpad, 7]``
    int32, this rank's lists of every layer (``l`` picks one).  Returns o
    like q.  One body serves both modes (the reference's ``kv_sharded``
    only changes its ``in_specs``): the kernel reads each item's kv head
    from the list."""

    def attend(l, q, k, v, items):
        return _prefill(q, k, v, items[0, l], block_q=block_q,
                        block_kv=block_kv)

    return attend


def hplb_prefill_attention_rows(mesh, *, block_q: int = 128,
                                block_kv: int = 128):
    """Row-mode prefill island: q / k / v whole on every rank (``[B, H, S,
    D]``, ``[B, Hkv, S, D]``, original head order), each rank's list holds
    its (head, q block) rows with global head and kv ids, and the disjoint
    output tiles are summed over ``model`` (one rank's tile and exact
    zeros: the backend's all-reduce gives the same bits as any order).
    Returns the whole o."""

    def attend(l, q, k, v, items):
        o = _prefill(q, k, v, items[0, l], block_q=block_q,
                     block_kv=block_kv)
        return mesh.all_reduce(o, "model")

    return attend


def hplb_decode_attention_packed(*, block_kv: int = 128):
    """Head-parallel packed decode island: each rank runs its own packed
    decode list over its kv-head block of the slot cache; heads are
    disjoint, so nothing merges.

    ``attend(q, kc, vc, items, pos, k_scales=None, v_scales=None)``: q
    ``[B, H_loc, 1, D]``; kc / vc ``[B, Hkv_loc, S, D]``; items ``[1, Lpad,
    DEC_FIELDS]`` int32 with local kv-head ids
    (``pack_decode_items(..., shard_of_kvhead=..., kvhead_local=True)``);
    pos ``[B]`` int32; a code cache's scales ``[B, Hkv_loc, S / block_kv]``
    go with their kv heads; ``window`` a sliding-window layer's (the
    reference's island takes none).  Returns ``[B, H_loc, 1, D]`` in q's
    dtype."""

    def attend(q, kc, vc, items, pos, k_scales=None, v_scales=None,
               window=None):
        return ops.flash_decode_packed(q, kc, vc, items[0], pos,
                                       block_kv=block_kv, window=window,
                                       k_scales=k_scales, v_scales=v_scales)

    return attend


def merge_partials_over(mesh, axes, out, m, l, dtype):
    """The reference islands' flash-decoding merge of this rank's partials
    over ``axes``: ``gm = pmax(m)``, ``w = exp(m - gm) * l``, ``o =
    psum(out * w) / max(psum(w), 1e-30)``, in float32.  ``out [B, H, 1,
    D]`` float32, ``m`` / ``l [B, Hkv, G]``; returns ``[B, H, 1, D]`` in
    ``dtype``."""
    B, H, _, dh = out.shape
    hkv, G = m.shape[1], m.shape[2]
    gm = mesh.pmax(m, axes)
    w = torch.exp(m - gm) * l
    den = mesh.psum(w, axes)
    num = mesh.psum(out.to(torch.float32).reshape(B, hkv, G, dh)
                    * w[..., None], axes)
    o = num / torch.clamp(den, min=1e-30)[..., None]
    return o.reshape(B, H, 1, dh).to(dtype)


def local_table(table, lo: int, n_loc: int):
    """A global block table remapped to this rank's ``[lo, lo + n_loc)``
    pool stripe: ids another rank holds, and unmapped ones, become -1."""
    local = table - lo
    ok = (table >= 0) & (local >= 0) & (local < n_loc)
    return torch.where(ok, local, -1).to(torch.int32)


def hplb_repermute_kv_cache(mesh, *, axis: str = "model"):
    """Plan-epoch swap island: re-permute the kv-head axis (axis 3) of a
    head-sharded cache, the slot cache ``[L, 2, B, Hkv_loc, S, Dh]`` or the
    pool ``[L, 2, N, Hkv_loc, block, Dh]`` (or a scales tensor with kv heads
    on axis 3).  ``kv_perm [L, Hkv]`` is the global delta shuffle (new kv
    slot -> previous kv slot); a head may move between ranks, so the
    island gathers the kv-head axis over ``axis`` and each rank takes its
    new heads.  ``repermute(cache, kv_perm, scales=None)`` returns this
    rank's new block (and the scales')."""

    def run(x, kv_perm):
        full = mesh.all_gather(x, axis, dim=3)
        hl = x.shape[3]
        d = mesh.axis_index(axis)
        perm = torch.as_tensor(kv_perm, dtype=torch.long, device=x.device)
        mine = perm[:, d * hl:(d + 1) * hl]
        idx = mine.reshape(mine.shape[0], 1, 1, hl,
                           *(1,) * (x.ndim - 4)).expand(
            *full.shape[:3], hl, *full.shape[4:])
        return torch.take_along_dim(full, idx, dim=3)

    def repermute(cache, kv_perm, scales=None):
        if scales is None:
            return run(cache, kv_perm)
        return run(cache, kv_perm), run(scales, kv_perm)

    return repermute


def hplb_swap_gather_kv_blocks(pool, ids, scales=None):
    """Preemption swap-out island (shard-local, no collective, so no
    builder): a sequence's pool blocks taken off this rank's kv-head block
    of the pool ``[L, 2, N, Hkv_loc, block, Dh]``.  ``ids [nblk]``,
    pool-global, trash-padded.  Returns ``(pool, blocks)``, or with
    scales ``((pool, scales), (blocks, block_scales))``; the copy keeps
    the current epoch's kv-head arrangement."""
    idx = torch.as_tensor(ids, dtype=torch.long, device=pool.device)
    if scales is None:
        return pool, pool[:, :, idx]
    return (pool, scales), (pool[:, :, idx], scales[:, :, idx])


def hplb_swap_scatter_kv_blocks(pool, blocks, ids, scales=None,
                                block_scales=None):
    """Preemption swap-in island (shard-local, no collective): a host copy
    written back into fresh pool blocks of this rank's kv-head block, in
    place.  Returns the pool (and the scales)."""
    idx = torch.as_tensor(ids, dtype=torch.long, device=pool.device)
    pool[:, :, idx] = blocks.to(pool.dtype)
    if scales is None:
        return pool
    scales[:, :, idx] = block_scales.to(scales.dtype)
    return pool, scales


def flash_decode_attention_paged(mesh, *, block_kv: int = 128,
                                 seq_axes=("model",)):
    """Paged decode island: the pool ``[N, Hkv, block, D]`` sharded on its
    block axis over ``seq_axes`` (rank s holds ids ``[s * N_loc, (s + 1) *
    N_loc)``).  ``attend(q, k_pool, v_pool, ids, table, pos, k_scales=None,
    v_scales=None)``: q ``[B, H, 1, D]`` whole; this rank's pool stripe;
    ``ids [B, Hkv, nb]`` logical block ids; ``table [B, T]`` global pool
    ids, remapped here to this rank's stripe; pos ``[B]``; a code pool's
    scales ``[N_loc, Hkv]`` go with the stripe.  Partials merge over
    ``seq_axes``; returns ``[B, H, 1, D]`` in q's dtype."""
    axes = tuple(seq_axes)

    def attend(q, k_pool, v_pool, ids, table, pos, k_scales=None,
               v_scales=None):
        n_loc = k_pool.shape[0]
        tbl = local_table(table, mesh.axis_index(axes) * n_loc, n_loc)
        out, m, l = ops.flash_decode_paged(
            q, k_pool, v_pool, ids, tbl, pos, block_kv=block_kv,
            partials=True, k_scales=k_scales, v_scales=v_scales)
        return merge_partials_over(mesh, axes, out, m, l, q.dtype)

    return attend


def flash_decode_attention_2d(mesh, *, block_kv: int = 128,
                              seq_axis: str = "seq"):
    """2D head x sequence decode island: the pool sharded both ways, kv
    heads over ``model`` and block stripes over ``seq_axis``.
    ``attend(q, k_pool, v_pool, ids, table, pos, k_scales=None,
    v_scales=None)``: q ``[B, H_loc, 1, D]``; the pool block ``[N_loc,
    Hkv_loc, block, D]``; ``ids [B, Hkv_loc, nb]`` logical; ``table [B,
    T]`` global; scales ``[N_loc, Hkv_loc]``.  Heads are disjoint along
    ``model``, so the partials merge along ``seq_axis`` only.  Returns
    ``[B, H_loc, 1, D]``."""

    def attend(q, k_pool, v_pool, ids, table, pos, k_scales=None,
               v_scales=None):
        n_loc = k_pool.shape[0]
        tbl = local_table(table, mesh.axis_index(seq_axis) * n_loc, n_loc)
        out, m, l = ops.flash_decode_paged(
            q, k_pool, v_pool, ids, tbl, pos, block_kv=block_kv,
            partials=True, k_scales=k_scales, v_scales=v_scales)
        return merge_partials_over(mesh, seq_axis, out, m, l, q.dtype)

    return attend


def flash_decode_attention(mesh, *, block_kv: int = 128,
                           seq_axes=("model",)):
    """Budgeted decode island over a slot cache sharded on its sequence
    over ``seq_axes``.  ``attend(q, kc, vc, ids, pos, k_scales=None,
    v_scales=None)``: q ``[B, H, 1, D]`` (every head of the cache's kv
    heads); kc / vc ``[B, Hkv, S_loc, D]`` this rank's positions ``[s *
    S_loc, (s + 1) * S_loc)``; ``ids [1, Hkv, nb_loc]`` the global block
    ids this rank holds (-1 pad); pos ``[B]`` global; a code cache's
    scales ``[B, Hkv, S_loc / block_kv]``.  Block ids and positions shift
    by the rank's offset, so the kernel's causal mask is the global one;
    partials merge over ``seq_axes``.  Returns ``[B, H, 1, D]``."""
    axes = tuple(seq_axes)

    def attend(q, kc, vc, ids, pos, k_scales=None, v_scales=None):
        out, m, l = seq_shard_partials(
            q, kc, vc, ids, pos, mesh.axis_index(axes), block_kv=block_kv,
            k_scales=k_scales, v_scales=v_scales)
        return merge_partials_over(mesh, axes, out, m, l, q.dtype)

    return attend


def seq_shard_partials(q, kc, vc, ids, pos, sidx: int, *, block_kv: int,
                       k_scales=None, v_scales=None):
    """The ``(out, m, l)`` partials of shard ``sidx`` in
    :func:`flash_decode_attention`: its global block ids ``[1, Hkv,
    nb_loc]`` and the rows' positions shifted to its ``[sidx * S_loc, (sidx
    + 1) * S_loc)``, blocks it does not hold masked."""
    B, hkv = kc.shape[0], kc.shape[1]
    nblk_loc = kc.shape[2] // block_kv
    ids0 = ids[0]
    local = ids0 - sidx * nblk_loc
    ok = (ids0 >= 0) & (local >= 0) & (local < nblk_loc)
    local_ids = torch.where(ok, local, -1).to(torch.int32)
    pos_local = (pos - sidx * nblk_loc * block_kv).to(torch.int32)
    return ops.flash_decode(
        q, kc, vc, local_ids[None].expand(B, hkv, -1).contiguous(),
        pos_local, block_kv=block_kv, partials=True, k_scales=k_scales,
        v_scales=v_scales)
